"""Host time a step in the span around ``ops/accel.py::resort_chunks``, over
the whole window, ms."""


def read(ctx):
    return ctx.host_ms.get("resort")
