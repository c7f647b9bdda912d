"""Batched 3-vector math on ``(..., 3)`` tensors.

Counterpart of ``realtrace_tpu/core/vec.py``: every function works on
arbitrarily batched trailing-dim-3 tensors, so a whole wavefront is one dense
batch. The double-``where`` guards are kept so autograd stays NaN-free on
dead (zero-direction) lanes.
"""
from __future__ import annotations

import torch
from torch import Tensor


def dot(a: Tensor, b: Tensor) -> Tensor:
    """Batched dot product. Ref: dotProduct, Serial/vector3D.cpp."""
    return torch.sum(a * b, dim=-1)


def cross(a: Tensor, b: Tensor) -> Tensor:
    """Batched cross product, written out per component (broadcasting)."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def length(a: Tensor) -> Tensor:
    """Batched Euclidean length."""
    return torch.sqrt(dot(a, a))


def normalize(a: Tensor, eps: float = 0.0) -> Tensor:
    """Normalize; zero vectors stay zero (guarded division, NaN-free grads).
    ``eps`` > 0 floors the squared length at ``eps`` before the division."""
    n2 = dot(a, a)[..., None]
    if eps:
        n2 = torch.clamp_min(n2, eps)
    pos = n2 > 0
    return a * torch.where(pos, 1.0 / torch.sqrt(torch.where(pos, n2, torch.ones_like(n2))),
                           torch.zeros_like(n2))


def reflect(i: Tensor, n: Tensor) -> Tensor:
    """Mirror reflection of ``i`` about ``n``. Ref: Serial/world.cpp:27-30."""
    return i - 2.0 * dot(n, i)[..., None] * n


def refract(i: Tensor, n: Tensor, eta: Tensor) -> tuple[Tensor, Tensor]:
    """Snell refraction: (T, ok), ok=False on total internal reflection (T=0).

    Ref: ``refract``, Serial/world.cpp:19-25. The sqrt is guarded with a
    STRICT k>0 double-where: its backward at k==0 is infinite.
    """
    ndi = dot(n, i)
    k = 1.0 - eta * eta * (1.0 - ndi * ndi)
    ok = k >= 0.0
    pos = k > 0.0
    sq = torch.where(pos, torch.sqrt(torch.where(pos, k, torch.ones_like(k))), torch.zeros_like(k))
    t = eta[..., None] * i - (eta * ndi + sq)[..., None] * n
    return torch.where(ok[..., None], t, torch.zeros_like(t)), ok


def det3(c1: Tensor, c2: Tensor, c3: Tensor) -> Tensor:
    """Determinant of the 3x3 matrix with columns c1, c2, c3 (batched), as
    the scalar triple product. Ref: ``determinant``, Serial/utilities.cpp:17-22."""
    return dot(c1, cross(c2, c3))


def distance(a: Tensor, b: Tensor) -> Tensor:
    """Euclidean distance. Ref: ``distance``, Serial/world.cpp:120-123."""
    return length(a - b)
