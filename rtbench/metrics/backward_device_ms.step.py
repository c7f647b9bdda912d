"""Device time a step of the work launched inside the span around
``torch.Tensor.backward`` (the backward through the remat regions), ms."""


def read(ctx):
    return None if ctx.trace is None else ctx.trace.device_ms("backward")
