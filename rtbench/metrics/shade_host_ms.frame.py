"""Host time a frame in the hit-attribute and shading spans
(``render/shade.py``: ``hit_attributes``, ``_shade_level``), over the whole
window, ms."""


def read(ctx):
    return ctx.host_ms.get("shade")
