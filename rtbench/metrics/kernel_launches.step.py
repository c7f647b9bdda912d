"""Kernels the device ran in the profiled stretch, per step."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.units or not any(d[4] == "kernel" for d in tr.device):
        return None
    return tr.kernels() / tr.units
