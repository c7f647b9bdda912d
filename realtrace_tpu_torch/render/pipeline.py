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
from realtrace_tpu_torch.render.camera import Camera, image_from_buffer
from realtrace_tpu_torch.render.shade import trace_wavefront

_TH = _TW = 32   # a wavefront tile is a 32x32 pixel block


@functools.lru_cache(maxsize=16)
def _tile_maps(width: int, height: int):
    """Tile-major pixel maps: each run of WAVEFRONT_TILE wavefront slots is a
    32x32 pixel tile, so a sweep tile's rays are spatially compact. The image
    is padded up to the tile grid; pad slots are parked zero-coefficient rays.

    Returns (ii, jj, valid, inv) as numpy arrays: per padded slot the pixel
    column ``ii`` and row-from-bottom ``jj`` (0 on pads) and ``valid``; and
    ``inv`` (H*W,), the slot of each row-major pixel.
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
    padpos = np.empty(hp * wp, np.int64)
    padpos[tilemajor(np.arange(hp * wp).reshape(hp, wp))] = np.arange(hp * wp)
    inv = padpos.reshape(hp, wp)[:height, :width].reshape(-1)
    ii = np.where(valid, ii, 0)
    jj = np.where(valid, jj, 0)
    return ii, jj, valid, inv


def _untile(buf: Tensor, camera: Camera) -> Tensor:
    """Tile-major wavefront buffer → row-major (H*W, 3) buffer (reshape,
    transpose and crop only)."""
    hp = -(-camera.height // _TH) * _TH
    wp = -(-camera.width // _TW) * _TW
    img = buf.reshape(hp // _TH, wp // _TW, _TH, _TW, 3).permute(0, 2, 1, 3, 4).reshape(hp, wp, 3)
    return img[:camera.height, :camera.width].reshape(-1, 3)


def _tiled_rays(camera: Camera):
    """Tile-major padded wavefront inputs (ro, rd, coeff): rays are generated
    directly at tile-major pixel coordinates. ``coeff`` is None when the image
    fills the tile grid; otherwise zero on pad slots, which are parked."""
    ii, jj, valid, _ = _tile_maps(camera.width, camera.height)
    rd = camera.ray_directions_at(ii, jj)
    ro = camera.position.expand_as(rd)
    if valid.all():
        return ro, rd, None
    v = torch.as_tensor(valid, device=rd.device)[:, None]
    ro = torch.where(v, ro, torch.full_like(ro, PARK_DISTANCE))
    rd = torch.where(v, rd, rd.new_tensor([1.0, 0.0, 0.0]))
    coeff = v.to(rd.dtype).expand(-1, 3)
    return ro, rd, coeff


def render_buffer(scene: Scene, camera: Camera, cfg: RenderConfig) -> Tensor:
    """Render to a flat (H*W, 3) linear colour buffer (unclamped)."""
    ro, rd, coeff = _tiled_rays(camera)
    return _untile(trace_wavefront(scene, ro, rd, cfg, coeff=coeff)[0], camera)


def render_image(scene: Scene, camera: Camera, cfg: RenderConfig) -> Tensor:
    """Render a top-down (H, W, 3) image clamped to [0, 1] (Color::clamp
    before drawPixel, Serial/renderengine.cpp:15-17)."""
    return torch.clamp(image_from_buffer(render_buffer(scene, camera, cfg), camera), 0.0, 1.0)


def render_with_stats(scene: Scene, camera: Camera, cfg: RenderConfig):
    """Render + traced-ray count (primary + shadow + reflection rays), the
    basis of the Mrays/s metric: (image (H, W, 3), nrays int)."""
    ro, rd, coeff = _tiled_rays(camera)
    accum, nrays = trace_wavefront(scene, ro, rd, cfg, coeff=coeff)
    img = torch.clamp(image_from_buffer(_untile(accum, camera), camera), 0.0, 1.0)
    return img, nrays


def to_rgba8(img: Tensor) -> Tensor:
    """[0, 1] float image → uint8 RGBA (``convert_to_rgba``,
    Parellel/kernel.cu:356-364)."""
    rgb = torch.clamp(img * 255.0, 0.0, 255.0).to(torch.uint8)
    a = torch.full(rgb.shape[:-1] + (1,), 255, dtype=torch.uint8, device=rgb.device)
    return torch.cat([rgb, a], dim=-1)
