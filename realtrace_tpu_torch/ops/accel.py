"""Acceleration structure: the median-split chunk permutation, and the
approximate ``chunked`` shortlist query.

Counterpart of ``realtrace_tpu/ops/accel.py``. Triangles are ordered by a
balanced recursive median split of their centroids on chunk boundaries, so
every run of ``chunk_size`` consecutive triangles of the permutation is one
spatially tight chunk with its own AABB. The permutation is topology only
(int64); triangle positions stay differentiable because hit attributes are
recomputed from the original tensors. The JAX package's other orderings are
here too: the split's host form and the superseded Morton orderings; any
ordering gives the same hits.

The exact query over the chunks is the sweep (``ops/sweep.py``). The
``chunked`` accel is the JAX package's plain shortlist query, kept as it is:
per block of ``cfg.ray_block`` rays, every ray's slab test votes for the
chunk boxes it enters, and the block tests only the ``cfg.shortlist`` most
voted chunks (ties to the lower chunk), so a hit in a chunk off the shortlist
is silently dropped. It reaches no kernel.
"""
from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch
from torch import Tensor

from realtrace_tpu_torch.core.types import BIG, RenderConfig, Scene, default_device
from realtrace_tpu_torch.utils.profiling import span, spanned

# Chunk-size policy carried over from the JAX package: past TARGET_CHUNKS
# chunks the size doubles (up to MAX_CHUNK_SIZE), and MAX_CHUNKS is a hard
# ceiling: a scene of up to 16,384 triangles keeps chunk_size, the duplicated
# mesh takes 128 at x4 (43,008 triangles) and 256 at x8 and x16. The constants
# are the JAX package's, not re-derived on the H100.
TARGET_CHUNKS = 512
MAX_CHUNK_SIZE = 256
MAX_CHUNKS = 1536
# ``chunked``: (ray, candidate) pairs one batch of ray blocks may hold; each
# f32 temporary of the triangle test is this many elements (128 MB), and the
# test keeps about a dozen alive. One block of 8,192 rays against 96 chunks
# of 32 (25M pairs) runs alone; smaller blocks run several to a batch.
CHUNKED_BATCH_PAIRS = 1 << 25


def default_exact_accel(device=None) -> str:
    """The exact accel for a device (default: the card): the sweep on a CUDA
    device, brute force elsewhere (the sweep's twin is slow on the CPU)."""
    return "sweep" if default_device(device).type == "cuda" else "bruteforce"


def warn_if_approximate(cfg: RenderConfig) -> None:
    """Warn on stderr when the approximate ``chunked`` accel is selected."""
    if cfg.accel == "chunked":
        print("[WARNING] accel='chunked' is APPROXIMATE: rays test only the "
              f"top-{cfg.shortlist} most-voted chunks per block, so hits can "
              "be silently dropped. Use accel='sweep' (CUDA) or "
              "'bruteforce' for exact results.", file=sys.stderr, flush=True)


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
        with span("rt.p.sync.resort"):
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


def build_chunk_perm_split(tri_vertices, chunk_size: int) -> np.ndarray:
    """The host (numpy) form of ``chunk_perm_split``, one group at a time:
    split the padded triangles by centroid along the longest axis of the
    group's centroid extent, the left part taking floor(k/2) of its k chunks.
    Returns the int32 permutation."""
    tv = np.asarray(tri_vertices, np.float64)
    n = tv.shape[0]
    if n == 0:
        return np.zeros((0,), np.int32)
    cent = tv.mean(axis=1).astype(np.float32)
    ids = np.arange(n)
    pad = (-n) % chunk_size
    if pad:
        ids = np.concatenate([ids, np.repeat(ids[-1], pad)])
    out = []

    def rec(g):
        k = len(g) // chunk_size
        if k <= 1:
            out.append(g)
            return
        c = cent[g]
        ax = int(np.argmax(c.max(0) - c.min(0)))
        order = np.argsort(c[:, ax], kind="stable")
        nl = (k // 2) * chunk_size
        rec(g[order[:nl]])
        rec(g[order[nl:]])

    rec(ids)
    return np.concatenate(out).astype(np.int32)


def _morton3(x: np.ndarray, y: np.ndarray, z: np.ndarray) -> np.ndarray:
    """Interleave 10-bit coordinates into 30-bit Morton codes (uint64)."""
    def spread(v):
        v = v.astype(np.uint64)
        v = (v | (v << 32)) & np.uint64(0x1F00000000FFFF)
        v = (v | (v << 16)) & np.uint64(0x1F0000FF0000FF)
        v = (v | (v << 8)) & np.uint64(0x100F00F00F00F00F)
        v = (v | (v << 4)) & np.uint64(0x10C30C30C30C30C3)
        v = (v | (v << 2)) & np.uint64(0x1249249249249249)
        return v
    return spread(x) | (spread(y) << np.uint64(1)) | (spread(z) << np.uint64(2))


def build_chunk_perm(tri_vertices, chunk_size: int) -> np.ndarray:
    """The superseded Morton ordering, on the host: triangles sorted by the
    Morton code of their centroid (10 bits an axis over the centroids' box),
    padded to a chunk multiple by repeating the last. Any ordering gives the
    same hits; the median split's chunk boxes are tighter. Returns int32."""
    tv = np.asarray(tri_vertices, np.float64)
    n = tv.shape[0]
    if n == 0:
        return np.zeros((0,), np.int32)
    cent = tv.mean(axis=1)
    lo, hi = cent.min(0), cent.max(0)
    ext = np.where(hi - lo > 0, hi - lo, 1.0)
    q = np.clip(((cent - lo) / ext * 1023.0), 0, 1023).astype(np.uint32)
    order = np.argsort(_morton3(q[:, 0], q[:, 1], q[:, 2]), kind="stable")
    pad = (-n) % chunk_size
    if pad:
        order = np.concatenate([order, np.repeat(order[-1], pad)])
    return order.astype(np.int32)


def _spread10(v: Tensor) -> Tensor:
    """10-bit coordinates -> every third bit of 30 (int64)."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    return (v | (v << 2)) & 0x09249249


def chunk_perm_device(tri_vertices: Tensor, chunk_size: int) -> Tensor:
    """The Morton ordering of ``build_chunk_perm`` on the scene's device, from
    float32 centroids (the JAX package's ``chunk_perm_device``): int64,
    padded by repeating the last sorted triangle."""
    tv = tri_vertices.detach()
    n = tv.shape[0]
    if n == 0:
        return torch.zeros((0,), dtype=torch.int64, device=tv.device)
    cent = ((tv[:, 0] + tv[:, 1] + tv[:, 2]) / 3.0).to(torch.float32)
    lo, hi = cent.amin(dim=0), cent.amax(dim=0)
    ext = torch.clamp(hi - lo, min=1e-30)
    q = torch.clamp((cent - lo) / ext * 1023.0, 0.0, 1023.0).to(torch.int64)
    code = _spread10(q[:, 0]) | (_spread10(q[:, 1]) << 1) | (_spread10(q[:, 2]) << 2)
    order = torch.sort(code, stable=True).indices
    pad = (-n) % chunk_size
    if pad:
        order = torch.cat([order, order[-1:].expand(pad)])
    return order


def with_chunks(scene: Scene, cfg: RenderConfig) -> Scene:
    """Attach the median-split chunk permutation, built from the scene's
    current (detached) vertices, to the scene."""
    perm = chunk_perm_split(scene.tri_vertices,
                            effective_chunk_size(cfg, scene.n_triangles))
    return dataclasses.replace(scene, tri_chunk_perm=perm)


@spanned("rt.p.resort")
def resort_chunks(scene: Scene, cfg: RenderConfig) -> Scene:
    """``with_chunks`` as the per-step rebuild of a train loop whose vertices
    move (``diff.inverse.make_train_step``; the JAX package's name): the
    ordering, unlike the per-frame chunk boxes, goes stale as the geometry
    moves."""
    return with_chunks(scene, cfg)


def chunk_volume(scene: Scene, cfg: RenderConfig) -> Tensor:
    """Staleness metric: the summed volume of the chunk boxes under the
    scene's current ordering; it grows as optimisation moves vertices away
    from the ordering's locality, and falls back after a re-sort."""
    if scene.tri_chunk_perm is None:
        raise ValueError("scene has no chunk permutation; call accel.with_chunks(scene, cfg)")
    c = effective_chunk_size(cfg, scene.n_triangles)
    tvc = scene.tri_vertices.detach()[scene.tri_chunk_perm].reshape(-1, c, 3, 3)
    return torch.sum(torch.prod(tvc.amax(dim=(1, 2)) - tvc.amin(dim=(1, 2)), dim=-1))


def _sorted_chunks(scene: Scene, cfg: RenderConfig):
    """(M, C, 3, 3) detached triangle blocks in chunk order, the chunk boxes
    (M, 3) lo and hi, recomputed from the current vertices, and the
    permutation."""
    perm = scene.tri_chunk_perm
    if perm is None:
        raise ValueError("scene has no chunk permutation; call accel.with_chunks(scene, cfg)")
    c = effective_chunk_size(cfg, scene.n_triangles)
    tvc = scene.tri_vertices.detach()[perm].reshape(-1, c, 3, 3)
    return tvc, tvc.amin(dim=(1, 2)), tvc.amax(dim=(1, 2)), perm


def _slab(ro: Tensor, rd: Tensor, lo: Tensor, hi: Tensor) -> Tensor:
    """Ray/box slab test: rays (..., B, 3) against boxes (M, 3), the hit mask
    (..., B, M); a zero direction component takes the inverse BIG."""
    nz = rd != 0.0
    inv = torch.where(nz, 1.0 / torch.where(nz, rd, torch.ones_like(rd)),
                      torch.full_like(rd, BIG))[..., None, :]
    t1 = (lo - ro[..., None, :]) * inv
    t2 = (hi - ro[..., None, :]) * inv
    tn = torch.minimum(t1, t2).amax(dim=-1)
    tf = torch.maximum(t1, t2).amin(dim=-1)
    return tf >= torch.clamp(tn, min=0.0)


def _pad_rays(ro: Tensor, rd: Tensor, block: int):
    """Rays padded to whole blocks with copies of the last ray (which vote
    like any other ray of the last block), and the unpadded count."""
    r = ro.shape[0]
    pad = (-r) % block
    if pad:
        ro = torch.cat([ro, ro[-1:].expand(pad, 3)])
        rd = torch.cat([rd, rd[-1:].expand(pad, 3)])
    return ro, rd, r


def _candidate_t(ro: Tensor, rd: Tensor, cand: Tensor, det_eps: float, t_min: float) -> Tensor:
    """The Cramer triangle test of ``ops/intersect.py::triangle_test`` for
    batches of ray blocks, each against its own candidates: rays (G, B, 3),
    candidates (G, N, 3, 3) -> t (G, B, N), BIG where invalid. Written out
    per component, one rounding a step, so the CPU and the card compute the
    same bits."""
    ox, oy, oz = (ro[..., k, None] for k in range(3))           # (G, B, 1)
    dx, dy, dz = (rd[..., k, None] for k in range(3))
    ax, ay, az = (cand[:, None, :, 0, k] for k in range(3))      # (G, 1, N)
    e1x, e1y, e1z = (cand[:, None, :, 0, k] - cand[:, None, :, 1, k] for k in range(3))
    e2x, e2y, e2z = (cand[:, None, :, 0, k] - cand[:, None, :, 2, k] for k in range(3))
    nx = e1y * e2z - e1z * e2y
    ny = e1z * e2x - e1x * e2z
    nz = e1x * e2y - e1y * e2x
    det = dx * nx + dy * ny + dz * nz
    sx, sy, sz = ax - ox, ay - oy, az - oz                       # (G, B, N)
    t = sx * nx + sy * ny + sz * nz
    beta = dx * (sy * e2z - sz * e2y) + dy * (sz * e2x - sx * e2z) + dz * (sx * e2y - sy * e2x)
    gamma = dx * (e1y * sz - e1z * sy) + dy * (e1z * sx - e1x * sz) + dz * (e1x * sy - e1y * sx)
    del sx, sy, sz
    det_ok = torch.abs(det) >= det_eps
    inv = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    beta, gamma, t = beta * inv, gamma * inv, t * inv
    ok = det_ok & (beta > 0.0) & (gamma > 0.0) & (beta + gamma < 1.0) & (t > t_min)
    return torch.where(ok, t, torch.full_like(t, BIG))


@torch.no_grad()
def closest_triangle(scene: Scene, ro: Tensor, rd: Tensor, cfg: RenderConfig):
    """Nearest triangle by the APPROXIMATE shortlist query: (t, original
    triangle index), BIG / -1 on a miss. Per block of ``cfg.ray_block`` rays
    (the last padded with copies of its last ray): the chunk boxes' votes,
    the ``cfg.shortlist`` most voted chunks (a stable descending sort, so a
    tie goes to the lower chunk, as ``lax.top_k``), then the dense triangle
    test against their triangles. Exact whenever every chunk a block's rays
    enter makes its shortlist. Several blocks run in one batch, up to
    ``CHUNKED_BATCH_PAIRS`` (ray, candidate) pairs; a block's result does not
    depend on the batch."""
    ro, rd = ro.detach(), rd.detach()
    tvc, lo, hi, perm = _sorted_chunks(scene, cfg)
    if ro.shape[0] == 0:          # an empty wavefront (no block to vote)
        return ro.new_zeros((0,)), perm.new_zeros((0,))
    m, c = tvc.shape[0], tvc.shape[1]
    s = min(cfg.shortlist, m)
    block = cfg.ray_block
    ro_p, rd_p, r = _pad_rays(ro, rd, block)
    nb = ro_p.shape[0] // block
    ro_b, rd_b = ro_p.reshape(nb, block, 3), rd_p.reshape(nb, block, 3)
    tvf = tvc.reshape(m * c, 3, 3)
    lanes = torch.arange(c, device=ro.device)
    group = max(1, CHUNKED_BATCH_PAIRS // (block * s * c))
    ts, idxs = [], []
    for g0 in range(0, nb, group):
        o, d = ro_b[g0:g0 + group], rd_b[g0:g0 + group]
        votes = _slab(o, d, lo, hi).sum(dim=1)                            # (G, M)
        chunk_ids = torch.sort(votes, dim=1, descending=True, stable=True).indices[:, :s]
        cand_idx = (chunk_ids[..., None] * c + lanes).reshape(o.shape[0], s * c)
        t = _candidate_t(o, d, tvf[cand_idx], cfg.det_epsilon, cfg.smallest_dist)
        tbest, amin = torch.min(t, dim=2)                                 # the first minimum
        del t
        gidx = perm[torch.gather(cand_idx, 1, amin)]
        ts.append(tbest)
        idxs.append(torch.where(tbest < BIG, gidx, torch.full_like(gidx, -1)))
    return torch.cat(ts).reshape(-1)[:r], torch.cat(idxs).reshape(-1)[:r]


def any_triangle(scene: Scene, ro: Tensor, rd: Tensor, cfg: RenderConfig) -> Tensor:
    """Occlusion by the same shortlist query: True where it finds a hit."""
    return closest_triangle(scene, ro, rd, cfg)[1] >= 0
