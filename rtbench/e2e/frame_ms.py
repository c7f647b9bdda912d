"""Frame time: the whole window over the frames it completed (closed loop), ms."""


def read(ctx):
    return ctx.seconds / ctx.units * 1e3
