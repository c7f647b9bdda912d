"""Top-level render entry points: ray generation → wavefront trace → image.

Counterpart of ``realtrace_tpu/render/pipeline.py``; the analog of
``RenderEngine::renderLoop`` (Serial/renderengine.cpp:10-26).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch import Tensor

from realtrace_tpu_torch.core.types import PARK_DISTANCE, WAVEFRONT_TILE, RenderConfig, Scene
from realtrace_tpu_torch.ops import raygen
from realtrace_tpu_torch.render.camera import Camera, image_from_buffer
from realtrace_tpu_torch.render.shade import trace_wavefront
from realtrace_tpu_torch.utils.profiling import span

_TH = _TW = raygen.TILE_SIDE   # a wavefront tile is a 32x32 pixel block


@functools.lru_cache(maxsize=16)
def _tile_maps(width: int, height: int):
    """Tile-major pixel maps: each run of WAVEFRONT_TILE wavefront slots is a
    32x32 pixel tile, so a sweep tile's rays are spatially compact. The image
    is padded up to the tile grid; pad slots are parked zero-coefficient rays.

    Returns (ii, jj, valid) as numpy arrays: per padded slot the pixel
    column ``ii`` and row-from-bottom ``jj`` (0 on pads) and ``valid``.
    """
    assert _TH * _TW == WAVEFRONT_TILE
    hp = -(-height // _TH) * _TH
    wp = -(-width // _TW) * _TW

    def tilemajor(grid):
        return grid.reshape(hp // _TH, _TH, wp // _TW, _TW).transpose(0, 2, 1, 3).reshape(-1)

    jj_g, ii_g = np.meshgrid(np.arange(hp), np.arange(wp), indexing="ij")
    ii = tilemajor(ii_g)
    jj = tilemajor(jj_g)
    valid = (ii < width) & (jj < height)
    return np.where(valid, ii, 0), np.where(valid, jj, 0), valid


def _untile(buf: Tensor, tile_w: int, tile_h: int) -> Tensor:
    """Tile-major wavefront buffer of a ``tile_w`` x ``tile_h`` pixel tile →
    row-major (tile_h*tile_w, 3) buffer (reshape, transpose and crop only)."""
    hp = -(-tile_h // _TH) * _TH
    wp = -(-tile_w // _TW) * _TW
    img = buf.reshape(hp // _TH, wp // _TW, _TH, _TW, 3).permute(0, 2, 1, 3, 4).reshape(hp, wp, 3)
    return img[:tile_h, :tile_w].reshape(-1, 3)


def _tiled_rays(camera: Camera, i0: int = 0, j0: int = 0, tile_w: int | None = None,
                tile_h: int | None = None):
    """Tile-major padded wavefront inputs (ro, rd, coeff) of the pixel tile
    [i0, i0+tile_w) x [j0, j0+tile_h) (default: the whole frame): rays are
    generated directly at tile-major pixel coordinates, equal to the full
    frame's for the same pixels. ``coeff`` is None when the tile fills the
    32x32 grid; otherwise zero on pad slots, which are parked. Where
    ``ops/raygen.py::takes`` holds (a CUDA float32 camera, no gradient
    recorded through it) one kernel makes them; else the PyTorch code,
    ``_tiled_rays_reference``. The span counts ``rays``, the slots made."""
    tile_w = camera.width if tile_w is None else tile_w
    tile_h = camera.height if tile_h is None else tile_h
    with span("rt.p.raygen") as s:
        make = raygen.raygen_kernel if raygen.takes(camera) else _tiled_rays_reference
        ro, rd, coeff = make(camera, i0, j0, tile_w, tile_h)
        s.count(rays=rd.shape[0])
    return ro, rd, coeff


def _tiled_rays_reference(camera: Camera, i0: int, j0: int, tile_w: int, tile_h: int):
    """``_tiled_rays`` in PyTorch, from the host-built tile maps: the
    kernel's twin, and the path of the CPU, float64 and grad-recording
    cameras."""
    ii, jj, valid = _tile_maps(tile_w, tile_h)
    rd = camera.ray_directions_at(ii + i0, jj + j0)
    ro = camera.position.expand_as(rd)
    if valid.all():
        return ro, rd, None
    with span("rt.p.sync.raygen"):
        v = torch.as_tensor(valid, device=rd.device)[:, None]
    ro = torch.where(v, ro, torch.full_like(ro, PARK_DISTANCE))
    with span("rt.p.sync.raygen"):
        park = rd.new_tensor([1.0, 0.0, 0.0])
    rd = torch.where(v, rd, park)
    coeff = v.to(rd.dtype).expand(-1, 3)
    return ro, rd, coeff


def render_tile_buffer(scene: Scene, camera: Camera, cfg: RenderConfig, i0: int = 0,
                       j0: int = 0, tile_w: int | None = None, tile_h: int | None = None):
    """Render the pixel tile [i0, i0+tile_w) x [j0, j0+tile_h) (columns,
    rows from the bottom; default: the whole frame) through the tile-major
    wavefront: (row-major (tile_h*tile_w, 3) linear colour buffer, unclamped;
    traced-ray count). The unit of progressive bands and sharded tiles."""
    tile_w = camera.width if tile_w is None else tile_w
    tile_h = camera.height if tile_h is None else tile_h
    ro, rd, coeff = _tiled_rays(camera, i0, j0, tile_w, tile_h)
    accum, nrays = trace_wavefront(scene, ro, rd, cfg, coeff=coeff)
    return _untile(accum, tile_w, tile_h), nrays


def render_buffer(scene: Scene, camera: Camera, cfg: RenderConfig) -> Tensor:
    """Render to a flat (H*W, 3) linear colour buffer (unclamped)."""
    return render_tile_buffer(scene, camera, cfg)[0]


def render_image(scene: Scene, camera: Camera, cfg: RenderConfig) -> Tensor:
    """Render a top-down (H, W, 3) image clamped to [0, 1] (Color::clamp
    before drawPixel, Serial/renderengine.cpp:15-17)."""
    return torch.clamp(image_from_buffer(render_buffer(scene, camera, cfg), camera), 0.0, 1.0)


def render_with_stats(scene: Scene, camera: Camera, cfg: RenderConfig):
    """Render + traced-ray count (primary + shadow + reflection rays), the
    basis of the Mrays/s metric: (image (H, W, 3), nrays int)."""
    buf, nrays = render_tile_buffer(scene, camera, cfg)
    return torch.clamp(image_from_buffer(buf, camera), 0.0, 1.0), nrays


def to_rgba8(img: Tensor) -> Tensor:
    """[0, 1] float image → uint8 RGBA (``convert_to_rgba``,
    Parellel/kernel.cu:356-364)."""
    rgb = torch.clamp(img * 255.0, 0.0, 255.0).to(torch.uint8)
    a = torch.full(rgb.shape[:-1] + (1,), 255, dtype=torch.uint8, device=rgb.device)
    return torch.cat([rgb, a], dim=-1)
