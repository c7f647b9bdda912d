"""The ``sampleApp/`` tutorial pair in plain PyTorch, on the card unless the
caller names another device.

Counterpart of ``realtrace_tpu/apps/samples.py``. Ref:
sampleApp/flashlight/kernel.cu:7-19 (distance-to-cursor intensity) and
sampleApp/stability/kernel.cu:4-55 (per-pixel explicit-Euler phase-plane
integration). The per-pixel CUDA thread becomes a dense (H, W) batch and the
time loop a Python loop of whole-image steps.
"""
from __future__ import annotations

import torch
from torch import Tensor

from realtrace_tpu_torch.core.types import default_device

LEN = 5.0         # sampleApp/stability/kernel.cu:4
TIME_STEP = 0.005
FINAL_TIME = 10.0


def _grid(w: int, h: int, device):
    f32 = torch.float32
    c = torch.arange(w, dtype=f32, device=device)[None, :]
    r = torch.arange(h, dtype=f32, device=device)[:, None]
    return c, r


def flashlight(w: int, h: int, pos, device=None) -> Tensor:
    """Distance-based intensity image, uint8 RGBA (H, W, 4). Ref:
    distanceKernel, sampleApp/flashlight/kernel.cu:7-19."""
    dev = default_device(device)
    c, r = _grid(w, h, dev)
    px = torch.as_tensor(pos, dtype=torch.float32, device=dev)
    d = torch.sqrt((c - px[0]) ** 2 + (r - px[1]) ** 2)
    inten = torch.clamp(255.0 - d, 0, 255).to(torch.uint8)
    return torch.stack([inten, inten, torch.zeros_like(inten), torch.full_like(inten, 255)],
                       dim=-1)


def _rhs(x: Tensor, y: Tensor, param: Tensor, sys: int) -> Tensor:
    """Oscillator right-hand side (ref kernel.cu:13-18), chosen by
    ``clip(sys, 0, 2)`` as the JAX package's code does: 0 linear damped,
    1 negative stiffness, 2 (and every sys above) van der Pol."""
    k = min(max(int(sys), 0), 2)
    if k == 0:
        return -x - 2.0 * param * y
    if k == 1:
        return x - 2.0 * param * y
    return -x + param * (1.0 - x * x) * y


def stability(w: int, h: int, param, sys, device=None) -> Tensor:
    """Phase-plane stability image, uint8 RGBA (H, W, 4): per-pixel explicit
    Euler to t=10, red for growth, blue for decay, the axes in green. Ref:
    stabImageKernel + euler, sampleApp/stability/kernel.cu:22-55."""
    dev = default_device(device)
    c, r = _grid(w, h, dev)
    x0 = (2.0 * LEN * (c / w - 0.5)).expand(h, w)    # scale() (kernel.cu:10)
    y0 = (2.0 * LEN * (r / h - 0.5)).expand(h, w)
    dist0 = torch.sqrt(x0 * x0 + y0 * y0)
    p = torch.as_tensor(param, dtype=torch.float32, device=dev)
    x, y = x0, y0
    for _ in range(int(FINAL_TIME / TIME_STEP)):
        x, y = x + TIME_STEP * y, y + TIME_STEP * _rhs(x, y, p, sys)
    dist_r = torch.sqrt(x * x + y * y) / torch.clamp(dist0, min=1e-12)
    red = torch.clamp(dist_r * 255.0, 0, 255).to(torch.uint8)
    blue = torch.clamp((1.0 / torch.clamp(dist_r, min=1e-12)) * 255.0, 0, 255).to(torch.uint8)
    cols = torch.arange(w, device=dev)[None, :] == w // 2
    rows = torch.arange(h, device=dev)[:, None] == h // 2
    green = torch.where(cols | rows, 255, 0).to(torch.uint8)
    return torch.stack([red, green, blue, torch.full_like(red, 255)], dim=-1)
