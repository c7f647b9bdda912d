"""Sweep acceleration structure: the median-split chunk permutation.

Counterpart of the exact parts of ``realtrace_tpu/ops/accel.py``. Triangles
are ordered by a balanced recursive median split of their centroids on chunk
boundaries, so every run of ``chunk_size`` consecutive triangles of the
permutation is one spatially tight chunk with its own AABB. The permutation
is topology only (int64); triangle positions stay differentiable because hit
attributes are recomputed from the original tensors.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import Tensor

from realtrace_tpu_torch.core.types import RenderConfig, Scene

# Chunk-size policy carried over from the JAX package: past TARGET_CHUNKS
# chunks the size doubles (up to MAX_CHUNK_SIZE), and MAX_CHUNKS is a hard
# ceiling: a scene of up to 16,384 triangles keeps chunk_size, the duplicated
# mesh takes 128 at x4 (43,008 triangles) and 256 at x8 and x16. The constants
# are the JAX package's, not re-derived on the H100.
TARGET_CHUNKS = 512
MAX_CHUNK_SIZE = 256
MAX_CHUNKS = 1536


def effective_chunk_size(cfg: RenderConfig, n_tris: int) -> int:
    cs = cfg.chunk_size
    while n_tris > cs * TARGET_CHUNKS and cs < MAX_CHUNK_SIZE:
        cs *= 2
    while n_tris > cs * MAX_CHUNKS:
        cs *= 2
    return cs


def total_order_key(x: Tensor) -> Tensor:
    """int32 keys that sort float32 values in IEEE total order (-0.0 before
    +0.0), the order ``lax.sort`` uses for floats."""
    b = x.to(torch.float32).contiguous().view(torch.int32)
    return b ^ ((b >> 31) & 0x7FFFFFFF)


def stable_lexsort(major: Tensor, minor: Tensor, dim: int = -1) -> Tensor:
    """Indices that stably sort by (major, minor): a stable sort by the minor
    key, then a stable sort of that order by the major key."""
    o1 = torch.sort(minor, dim=dim, stable=True).indices
    o2 = torch.sort(torch.gather(major, dim, o1), dim=dim, stable=True).indices
    return torch.gather(o1, dim, o2)


def chunk_perm_split(tri_vertices: Tensor, chunk_size: int) -> Tensor:
    """Median-split chunk permutation (int64, padded to a chunk multiple by
    repeating the last triangle), equal to JAX's ``chunk_perm_split_device``.

    Level-synchronous: per bisection level, each group's centroid extent
    picks its split axis, and ONE stable sort on (group id, coordinate)
    orders every group at once; group boundaries depend only on the count.
    """
    tv = tri_vertices.detach()
    n = tv.shape[0]
    dev = tv.device
    if n == 0:
        return torch.zeros((0,), dtype=torch.int64, device=dev)
    cent_all = ((tv[:, 0] + tv[:, 1] + tv[:, 2]) / 3.0).to(torch.float32)
    ids = torch.arange(n, device=dev)
    pad = (-n) % chunk_size
    if pad:
        ids = torch.cat([ids, ids[-1:].expand(pad)])
    npad = ids.shape[0]
    groups = [(0, npad // chunk_size)]          # (start_chunk, size_chunks)
    while max(k for _, k in groups) > 1:
        g = len(groups)
        seg_np = np.empty((npad,), np.int64)    # position -> group
        for gi, (s, k) in enumerate(groups):
            seg_np[s * chunk_size:(s + k) * chunk_size] = gi
        seg = torch.as_tensor(seg_np, device=dev)
        cent = cent_all[ids]
        idx3 = seg[:, None].expand(npad, 3)
        lo = torch.full((g, 3), float("inf"), device=dev).scatter_reduce(
            0, idx3, cent, "amin", include_self=True)
        hi = torch.full((g, 3), float("-inf"), device=dev).scatter_reduce(
            0, idx3, cent, "amax", include_self=True)
        ax = torch.argmax(hi - lo, dim=1)
        coord = torch.gather(cent, 1, ax[seg][:, None])[:, 0]
        ids = ids[stable_lexsort(seg, total_order_key(coord))]
        new_groups = []
        for s, k in groups:
            if k <= 1:
                new_groups.append((s, k))
            else:
                new_groups += [(s, k // 2), (s + k // 2, k - k // 2)]
        groups = new_groups
    return ids


def with_chunks(scene: Scene, cfg: RenderConfig) -> Scene:
    """Attach the median-split chunk permutation, built from the scene's
    current (detached) vertices, to the scene."""
    perm = chunk_perm_split(scene.tri_vertices,
                            effective_chunk_size(cfg, scene.n_triangles))
    return dataclasses.replace(scene, tri_chunk_perm=perm)


# The JAX package's name for the per-step rebuild of a train loop whose
# vertices move (``diff.inverse.make_train_step``): the ordering, unlike the
# per-frame chunk boxes, goes stale as the geometry moves.
resort_chunks = with_chunks


def chunk_volume(scene: Scene, cfg: RenderConfig) -> Tensor:
    """Staleness metric: the summed volume of the chunk boxes under the
    scene's current ordering; it grows as optimisation moves vertices away
    from the ordering's locality, and falls back after a re-sort."""
    if scene.tri_chunk_perm is None:
        raise ValueError("scene has no chunk permutation; call accel.with_chunks(scene, cfg)")
    c = effective_chunk_size(cfg, scene.n_triangles)
    tvc = scene.tri_vertices.detach()[scene.tri_chunk_perm].reshape(-1, c, 3, 3)
    return torch.sum(torch.prod(tvc.amax(dim=(1, 2)) - tvc.amin(dim=(1, 2)), dim=-1))
