"""Fit-step time: the whole window over the Adam steps it completed (closed loop), ms."""


def read(ctx):
    return ctx.seconds / ctx.units * 1e3
