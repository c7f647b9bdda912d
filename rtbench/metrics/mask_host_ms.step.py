"""Host time a step in the chunk-mask spans (``ops/sweep.py``: ``sweep_inputs``,
``chunk_mask``, ``chunk_mask_exact``, ``super_tile_mask``), over the
whole window, ms."""


def read(ctx):
    return ctx.host_ms.get("mask")
