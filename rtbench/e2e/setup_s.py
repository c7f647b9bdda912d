"""Set-up: from the start of the process to the first timed frame or step, s."""


def read(ctx):
    return ctx.setup_s
