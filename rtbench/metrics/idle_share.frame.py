"""The device's idle share of a frame: 100 times one minus the device's busy
time a frame (the union of its kernels, copies and sets over the profiled
stretch, per frame) over the same run's frame time in its window, which the
profiler does not stretch, %."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device or not tr.units or not ctx.units:
        return None
    return 100.0 * (1.0 - (tr.busy_s() / tr.units) / (ctx.seconds / ctx.units))
