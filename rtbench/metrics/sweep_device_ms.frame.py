"""Device time a frame of the work launched inside the spans around
``ops/sweep.py::sweep`` (closest and any mode), whatever its kernels' names, ms."""


def read(ctx):
    return None if ctx.trace is None else ctx.trace.device_ms("sweep")
