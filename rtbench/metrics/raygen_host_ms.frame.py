"""Host time a frame in ray generation (``render/pipeline.py::_tiled_rays``),
over the whole window, ms."""


def read(ctx):
    return ctx.host_ms.get("raygen")
