"""Device time a step of the NCCL kernels on rank 0's card in the profiled
stretch (the flat gradient all-reduce and the loss's), ms. Moving ~1 MB over
NVLink takes tens of microseconds, so most of it is the kernel waiting for
the slowest rank. None where no NCCL kernel ran (one card, or gloo)."""

PREFIX = "nccl"


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.units:
        return None
    work = [d for d in tr.device if d[4] == "kernel" and d[0].lower().startswith(PREFIX)
            and tr.start <= d[1] < tr.end]
    if not work:
        return None
    return sum(d[2] - d[1] for d in work) / 1e3 / tr.units
