"""Ray generation in one hand-written CUDA kernel, ``rt_raygen`` in
``csrc/level.cu``.

``raygen_kernel`` computes what ``render/pipeline.py::_tiled_rays_reference``
computes: the tile-major padded wavefront inputs (ro, rd, coeff) of a pixel
tile, from each slot's index and the camera's four tensors. It reads nothing
from the host but the camera, builds no pixel map and uploads nothing. On the
card it is bit-equal to the PyTorch code, which stays as its twin and as the
path of everything ``takes`` turns away: the CPU, float64, and a camera
through which a gradient is recorded.

``_tiled_rays`` launches it, so its name, signature and span keep measuring
the layer. The launch runs in a span of its own, ``rt.p.kernel.raygen``, that
counts ``rays``, the slots launched; the kernel counts its launches,
``raygen_kernel.launches``.
"""
from __future__ import annotations

import math

import torch
from torch import Tensor

from realtrace_tpu_torch.core.types import PARK_DISTANCE
from realtrace_tpu_torch.ops import cuda_build
from realtrace_tpu_torch.ops.sweep import _check_all
from realtrace_tpu_torch.utils.profiling import span

TILE_SIDE = 32      # render/pipeline.py: a wavefront tile is a 32x32 pixel block


def _tensors(camera) -> tuple:
    return camera.position, camera.target, camera.up, camera.fovy


def takes(camera) -> bool:
    """Whether a camera's rays come from the kernel: its tensors are CUDA
    float32 and no gradient is recorded through them (grad mode is off, or
    none of them requires one)."""
    xs = _tensors(camera)
    return (all(x.device.type == "cuda" and x.dtype == torch.float32 for x in xs)
            and not (torch.is_grad_enabled() and any(x.requires_grad for x in xs)))


def raygen_kernel(camera, i0: int, j0: int, tile_w: int, tile_h: int):
    """(ro, rd, coeff) of the pixel tile [i0, i0+tile_w) x [j0, j0+tile_h),
    tile-major and padded to the 32x32 tile grid, as ``_tiled_rays``: where
    the tile fills the grid ``(position.expand_as(rd), rd, None)``, else
    pad slots parked and ``coeff`` an (R, 1) buffer expanded to (R, 3)."""
    position, target, up, fovy = _tensors(camera)
    dev, f32 = position.device, torch.float32
    _check_all("raygen_kernel", dev, [("position", position, f32, (3,)),
                                      ("target", target, f32, (3,)), ("up", up, f32, (3,)),
                                      ("fovy", fovy, f32, ())])
    wp = -(-tile_w // TILE_SIDE) * TILE_SIDE
    hp = -(-tile_h // TILE_SIDE) * TILE_SIDE
    n = wp * hp
    rd = torch.empty((n, 3), dtype=f32, device=dev)
    full = (tile_w, tile_h) == (wp, hp)
    ro = None if full else torch.empty((n, 3), dtype=f32, device=dev)
    coeff = None if full else torch.empty((n, 1), dtype=f32, device=dev)
    w, h = camera.width, camera.height
    with span("rt.p.kernel.raygen") as s:
        rc = cuda_build.load().rt_raygen(
            position.data_ptr(), target.data_ptr(), up.data_ptr(), fovy.data_ptr(), w, h,
            w / h, w / 2.0, h / 2.0, math.pi / 180.0, i0, j0, tile_w, tile_h, wp // TILE_SIDE,
            PARK_DISTANCE, None if full else ro.data_ptr(), rd.data_ptr(),
            None if full else coeff.data_ptr(), n, dev.index or 0,
            torch.cuda.current_stream(dev).cuda_stream)
        s.count(rays=n)
    if rc != 0:
        raise RuntimeError(f"raygen kernel launch failed: {cuda_build.error_string(rc)}")
    if n:
        raygen_kernel.launches += 1
    if full:
        return position.expand_as(rd), rd, None
    return ro, rd, coeff.expand(-1, 3)


raygen_kernel.launches = 0
