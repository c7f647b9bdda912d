"""Peak device memory allocated over the window (after a reset at its start),
the scene and the pack it holds included, GiB."""


def read(ctx):
    return ctx.peak_bytes / (1 << 30)
