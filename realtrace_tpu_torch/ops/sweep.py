"""Chunk sweep: closest-hit and occlusion queries over the median-split chunks.

Counterpart of ``realtrace_tpu/ops/pallas/trace.py`` (host side) plus the
sweep itself. Per 1024-ray tile, a conservative chunk mask lists the chunks
any ray of the tile can enter, compacted FRONT-TO-BACK by an entry-distance
bound; the sweep then walks each tile's list and runs the exact triangle test
against the listed chunks only.

The triangle test is written as four linear forms of the ray (the Cramer
numerators det, t, beta, gamma), with constants stored relative to each
chunk's centroid and the ray re-centred per chunk, so f32 cancellation stays
at chunk scale instead of scene scale:

    det  = n . rd                 tnum = d - n . ro'
    bnum = c1 . rd - e2 . q'      gnum = c2 . rd + e1 . q'

with ro' = ro - G, q' = rd x ro' (G the chunk centroid), e1 = A-B, e2 = A-C,
n = e1 x e2, d = n . (A-G), c1 = (A-G) x e2, c2 = e1 x (A-G).

``sweep`` launches one of two CUDA kernels on CUDA tensors: the resident form
(``csrc/sweep.cu``, every warp copies the chunks it tests) or, for scenes
past ``RESIDENT_LIMIT`` or when asked, the streaming form
(``csrc/sweep_stream.cu``, a block stages the listed chunks in a ring of
shared memory). Both compute the same function; on CPU tensors ``sweep``
runs their plain PyTorch twin ``sweep_reference``, which owns the semantics.
The card's lists come from ``chunk_mask`` the same way: one launch of
``csrc/chunk_mask.cu`` a query on CUDA tensors, its twin
``chunk_mask_reference`` on CPU tensors.

The unit of control inside a tile is the warp: 128 consecutive rays of the
tile. Given the chunk boxes, a warp tests a listed chunk only if one of its
own live rays enters the chunk's box (the per-ray slab test of the exact
mask), and leaves the list by its own vote. The results do not depend on
that gate, nor on whether a tile's list is the interval list or the exact
one; the work does, and ``tested`` counts it.

Big scenes (``EXACT_MASK_MIN_TRIS`` triangles and up) take the exact chunk
mask at every query width behind a super-chunk gate: per-ray slab tests
against the AABBs of groups of consecutive chunks prune each tile's interval
list over the full chunk range before the capped per-ray refinement.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import Tensor

from realtrace_tpu_torch.core.types import BIG, PARK_DISTANCE, WAVEFRONT_TILE, RenderConfig, Scene
from realtrace_tpu_torch.ops import cuda_build
from realtrace_tpu_torch.ops.accel import effective_chunk_size, total_order_key
from realtrace_tpu_torch.utils.profiling import span, spanned

LANES = WAVEFRONT_TILE   # rays per sweep tile
WARP_RAYS = 128          # consecutive rays of a tile that one warp owns (4 a lane)
WARPS = LANES // WARP_RAYS
NCOEF = 16               # per-triangle constants: n(3) d c1(3) e2(3) c2(3) e1(3)
# Blocked per-ray refinement of the exact mask: tiles per block, and the
# interval-shortlist candidates refined per tile (the tail past the cap is
# kept un-refined, conservatively).
EXACT_MASK_BLOCK_TILES = 32
EXACT_GATE_CAP = 96
# Super-chunk gate: SUPER_GROUP consecutive sorted-space chunks (spatially
# coherent under the median split) share one AABB; the group size doubles
# until the super count fits SUPER_STAGE_WIDTH.
SUPER_GROUP = 8
SUPER_STAGE_WIDTH = 128
# Triangle count from which the big-scene mask policy runs (the exact mask at
# any query width, with the super-chunk gate).
EXACT_MASK_MIN_TRIS = 1 << 16
# Residency rule of the JAX package, carried over for parity so that a scene
# takes the same-numbered kernel in both packages: the resident kernel while
# the constant table, counted as the JAX layout counts it (4 rows of NCOEF
# floats per triangle), fits RESIDENT_LIMIT and 4*C is a multiple of 128
# (up to 24,576 triangles at chunk sizes that are multiples of 32); the
# streaming kernel otherwise. The two kernels give bit-equal results, so where
# the boundary lies is a question of speed only, and it is not tuned for the
# H100.
RESIDENT_LIMIT = 6 * 1024 * 1024
# bytes of dynamic shared memory one thread block may be given on the H100
MAX_DYNAMIC_SMEM = 232_448
# bytes of it the streaming kernel keeps for its barriers and masks
STREAM_SMEM_RESERVE = 1024
# warps of one block of the resident kernel (kWarps of csrc/sweep.cu): each
# stages the chunk it tests in a shared-memory slice of its own
RESIDENT_BLOCK_WARPS = 4
# stages of the streaming kernel's ring (kStages of csrc/sweep_stream.cu)
STREAM_STAGES = 2
# List policy for CUDA tensors: with the chunk gate inside the kernels the
# exact mask only shortens lists that the warps prune themselves, and on the
# card it costs more than it saves (PERF.md, section 6), so CUDA queries
# take the interval list at every width. CPU queries keep the policy of the
# JAX package: the twin walks every listed position for all tiles.
INTERVAL_LISTS_ON_CUDA = True
# bytes one (tiles, C, LANES) f32 temporary of the twin may take: sets how many
# tiles the twin walks at once
REFERENCE_BLOCK_BYTES = 64 << 20
# chunks one tile's list may hold on CUDA tensors: the keys a block of the mask
# kernel sorts in shared memory (kSortSlots of csrc/chunk_mask.cu); the chunk
# policy keeps scenes at accel.MAX_CHUNKS = 1536 chunks and under
MASK_SORT_CAPACITY = 2048


def _cross_rows(ax, ay, az, bx, by, bz):
    return ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx


# ---------------------------------------------------------------------------
# scene-constant pack
# ---------------------------------------------------------------------------

def pack_tri_consts(tvc: Tensor, centroid: Tensor) -> Tensor:
    """Per-triangle linear-form constants, chunk-centroid-relative.

    tvc: (M, C, 3, 3) sorted triangle vertices; centroid: (M, 3).
    Returns (M, C, NCOEF) f32 rows [n, d, c1, e2, c2, e1] (module docstring).
    """
    a = tvc[:, :, 0] - centroid[:, None, :]
    e1 = tvc[:, :, 0] - tvc[:, :, 1]
    e2 = tvc[:, :, 0] - tvc[:, :, 2]
    n = torch.stack(_cross_rows(*e1.unbind(-1), *e2.unbind(-1)), dim=-1)
    d = n[..., 0] * a[..., 0] + n[..., 1] * a[..., 1] + n[..., 2] * a[..., 2]
    c1 = torch.stack(_cross_rows(*a.unbind(-1), *e2.unbind(-1)), dim=-1)
    c2 = torch.stack(_cross_rows(*e1.unbind(-1), *a.unbind(-1)), dim=-1)
    return torch.cat([n, d[..., None], c1, e2, c2, e1], dim=-1).contiguous()


@dataclasses.dataclass
class AccelPack:
    """Scene-constant sweep inputs, built once per frame and shared by every
    closest and occlusion query of the frame."""

    consts: Tensor   # (M, C, NCOEF) f32 linear-form constants
    meta: Tensor     # (M, 3) f32 chunk centroids
    lo: Tensor       # (M, 3) f32 chunk AABB mins
    hi: Tensor       # (M, 3) f32 chunk AABB maxs
    perm: Tensor     # (M*C,) int64 sorted -> original triangle index
    chunk_size: int

    @property
    def n_chunks(self) -> int:
        return self.consts.shape[0]

    @property
    def table_bytes(self) -> int:
        """The constant table's bytes as the JAX layout counts them (4 rows of
        NCOEF floats per triangle), the measure ``RESIDENT_LIMIT`` bounds."""
        return self.n_chunks * 4 * self.chunk_size * NCOEF * 4

    @property
    def resident(self) -> bool:
        """Whether queries take the resident kernel (``RESIDENT_LIMIT``)."""
        return self.table_bytes <= RESIDENT_LIMIT and (4 * self.chunk_size) % 128 == 0


def pack_for(perm: Tensor, tri_vertices: Tensor, c: int) -> AccelPack:
    """AccelPack at chunk size ``c`` from a sorted triangle permutation
    (padded to a multiple of ``c`` by repeating the last triangle)."""
    pad = (-perm.shape[0]) % c
    if pad:
        perm = torch.cat([perm, perm[-1:].expand(pad)])
    tv = tri_vertices.detach().to(torch.float32)[perm]
    tvc = tv.reshape(-1, c, 3, 3)
    lo = tvc.amin(dim=(1, 2))
    hi = tvc.amax(dim=(1, 2))
    centroid = 0.5 * (lo + hi)
    return AccelPack(pack_tri_consts(tvc, centroid), centroid.contiguous(), lo, hi, perm, c)


def build_pack(scene: Scene, cfg: RenderConfig) -> AccelPack:
    """The sweep's scene-constant inputs (no gradient)."""
    if scene.tri_chunk_perm is None:
        raise ValueError("scene has no chunk permutation; call accel.with_chunks(scene, cfg)")
    return pack_for(scene.tri_chunk_perm, scene.tri_vertices,
                    effective_chunk_size(cfg, scene.n_triangles))


# ---------------------------------------------------------------------------
# per-tile chunk lists
# ---------------------------------------------------------------------------

def _inv_dir(rd: Tensor) -> Tensor:
    nz = rd != 0.0
    return torch.where(nz, 1.0 / torch.where(nz, rd, torch.ones_like(rd)),
                       torch.full_like(rd, BIG))


def compact_front_to_back(mask: Tensor, entry: Tensor, ids: Tensor | None = None):
    """(chunk_list, entry, counts): each tile's visible chunks first, sorted
    front-to-back by entry bound (stable), so the sweep consumes near chunks
    first and can stop once the next entry exceeds every live lane's nearest
    hit. ``ids`` (default arange) names the chunk at each position."""
    nt, m = mask.shape
    if ids is None:
        ids = torch.arange(m, device=mask.device).expand(nt, m)
    key = torch.where(mask, entry, torch.full_like(entry, float("inf")))
    order = torch.sort(total_order_key(key), dim=1, stable=True).indices
    entry_pay = torch.where(mask, entry, torch.zeros_like(entry))
    return (torch.gather(ids, 1, order).to(torch.int32),
            torch.gather(entry_pay, 1, order),
            mask.sum(dim=1, dtype=torch.int32))


def chunk_mask_reference(ro: Tensor, rd: Tensor, lo: Tensor, hi: Tensor, nt: int):
    """Conservative per-tile chunk visibility by OCTANT-SPLIT interval
    arithmetic: per tile and direction octant, bound the rays by
    [ro_min, ro_max] x [inv_min, inv_max] and interval-evaluate the slab test
    against every chunk AABB. Parked lanes are excluded. Never drops a chunk
    any tile ray could hit. The plain PyTorch twin of ``csrc/chunk_mask.cu``,
    which computes the same function bit for bit.

    ro, rd: (nt*LANES, 3) f32. Returns (chunk_list (nt, M) i32, entry (nt, M)
    f32, counts (nt,) i32)."""
    inv = _inv_dir(rd)
    ro_t = ro.reshape(nt, LANES, 3)
    inv_t = inv.reshape(nt, LANES, 3)
    live = ro_t[..., 0] != PARK_DISTANCE
    neg = (inv_t < 0).to(torch.int8)
    oct_id = neg[..., 0] + 2 * neg[..., 1] + 4 * neg[..., 2]
    with span("rt.p.sync.mask_const"):
        big = torch.tensor(BIG, dtype=ro.dtype, device=ro.device)
    mask = entry = None
    for o in range(8):
        sel = (live & (oct_id == o))[..., None]
        any_o = torch.any(sel[..., 0], dim=1)
        ro_lo = torch.where(sel, ro_t, big).amin(1)[:, None]
        ro_hi = torch.where(sel, ro_t, -big).amax(1)[:, None]
        inv_lo = torch.where(sel, inv_t, big).amin(1)[:, None]
        inv_hi = torch.where(sel, inv_t, -big).amax(1)[:, None]

        def plane_interval(p):
            # interval of (p - ro) * inv, p: (M, 3)
            a_lo = p[None] - ro_hi
            a_hi = p[None] - ro_lo
            cands = torch.stack([a_lo * inv_lo, a_lo * inv_hi, a_hi * inv_lo, a_hi * inv_hi])
            return cands.amin(0), cands.amax(0)

        ta_lo, ta_hi = plane_interval(lo)
        tb_lo, tb_hi = plane_interval(hi)
        tn_lo = torch.minimum(ta_lo, tb_lo).amax(-1)   # (nt, M) optimistic entry
        tf_hi = torch.maximum(ta_hi, tb_hi).amin(-1)   # optimistic exit
        e = torch.clamp(tn_lo, min=0.0)
        # same relative pad as the exact mask, so the exact mask (gated by
        # this list) is never the stricter of the two on a grazing chunk
        m_o = (tf_hi * (1.0 + 1e-6) + 1e-6 >= e) & any_o[:, None]
        e = torch.where(m_o, e, big)
        mask = m_o if mask is None else (mask | m_o)
        entry = e if entry is None else torch.minimum(entry, e)
    # which zero the reductions above return on a tie of +0.0 and -0.0
    # depends on their order, and the sort puts -0.0 first: + 0.0 makes every
    # zero entry +0.0 (the kernel does the same)
    return compact_front_to_back(mask, entry + 0.0)


def chunk_mask(ro: Tensor, rd: Tensor, lo: Tensor, hi: Tensor, nt: int):
    """Each tile's chunk list, as ``chunk_mask_reference`` defines it. CUDA
    tensors launch ``csrc/chunk_mask.cu`` (``mask_kernel``: one block a
    tile, lists of at most ``MASK_SORT_CAPACITY`` chunks); CPU tensors run
    the twin. Anything else raises, before any launch.

    The launch (on CPU tensors the twin) runs in the span ``rt.p.kernel.mask``;
    while it records, the call counts ``tiles`` (nt) and ``listed`` (the
    ``counts`` tensor, summed when read), so that ``listed / (tiles * M)`` is
    the share of chunks the lists keep."""
    m = lo.shape[0]
    f32 = torch.float32
    on_cpu = ro.device.type == "cpu"
    # the twin takes any strides; the kernel reads the rows where they lie
    _check_all("chunk_mask", ro.device, [("ro", ro, f32, (nt * LANES, 3)),
                                         ("rd", rd, f32, (nt * LANES, 3)),
                                         ("lo", lo, f32, (m, 3)), ("hi", hi, f32, (m, 3))],
               contiguous=not on_cpu)
    if not on_cpu and m > MASK_SORT_CAPACITY:
        raise ValueError(f"chunk_mask: {m} chunks, the kernel sorts at most "
                         f"{MASK_SORT_CAPACITY} a tile")
    if not on_cpu and ro.device.type != "cuda":
        raise ValueError(f"chunk_mask: no kernel for device {ro.device}")
    with span("rt.p.kernel.mask") as s:
        out = (chunk_mask_reference if on_cpu else mask_kernel)(ro, rd, lo, hi, nt)
        s.count(tiles=nt, listed=out[2])
    return out


def mask_kernel(ro: Tensor, rd: Tensor, lo: Tensor, hi: Tensor, nt: int):
    """``chunk_mask``'s launch of ``csrc/chunk_mask.cu`` on the inputs it
    checked. It counts its launches, ``mask_kernel.launches``, apart from
    ``chunk_mask``, whose name the benchmark's spans wrap."""
    m = lo.shape[0]
    chunk_list = torch.empty((nt, m), dtype=torch.int32, device=ro.device)
    entry = torch.empty((nt, m), dtype=torch.float32, device=ro.device)
    counts = torch.empty(nt, dtype=torch.int32, device=ro.device)
    rc = cuda_build.load().rt_chunk_mask(
        ro.data_ptr(), rd.data_ptr(), lo.data_ptr(), hi.data_ptr(), chunk_list.data_ptr(),
        entry.data_ptr(), counts.data_ptr(), nt, m, ro.device.index or 0,
        torch.cuda.current_stream(ro.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"chunk_mask kernel launch failed: {cuda_build.error_string(rc)}")
    if nt:
        mask_kernel.launches += 1
    return chunk_list, entry, counts


mask_kernel.launches = 0


def super_bounds(lo: Tensor, hi: Tensor):
    """(lo_s, hi_s, G): AABBs of groups of G consecutive sorted-space chunks
    (the ragged tail padded with empty boxes)."""
    m = lo.shape[0]
    g = SUPER_GROUP
    while -(-m // g) > SUPER_STAGE_WIDTH:
        g *= 2
    n_super = -(-m // g)
    pad = n_super * g - m
    if pad:
        lo = torch.cat([lo, lo.new_full((pad, 3), BIG)])
        hi = torch.cat([hi, hi.new_full((pad, 3), -BIG)])
    return lo.reshape(n_super, g, 3).amin(1), hi.reshape(n_super, g, 3).amax(1), g


def _slab_hits(ro_t: Tensor, inv_t: Tensor, lo_b: Tensor, hi_b: Tensor):
    """Per-ray slab test of (bt, LANES, 3) rays against (bt or 1, K, 3) boxes:
    (hit, tn), each (bt, LANES, K); tn is the entry distance clamped at 0. A
    small relative pad keeps f32 rounding from dropping a grazing box."""
    tn, tf = _slab_interval(ro_t[:, :, None], inv_t[:, :, None], lo_b[:, None], hi_b[:, None])
    return _slab_pass(tn, tf), tn


def _slab_interval(ro, inv, lo, hi):
    """(tn, tf): entry (clamped at 0) and exit distance of rays ``ro`` with
    inverse directions ``inv`` through the boxes [lo, hi]; all (..., 3),
    broadcast against each other."""
    tn = tf = None
    for ax in range(3):
        t_a = (lo[..., ax] - ro[..., ax]) * inv[..., ax]
        t_b = (hi[..., ax] - ro[..., ax]) * inv[..., ax]
        near, far = torch.minimum(t_a, t_b), torch.maximum(t_a, t_b)
        tn = torch.clamp(near, min=0.0) if tn is None else torch.maximum(tn, near)
        tf = torch.clamp(far, max=BIG) if tf is None else torch.minimum(tf, far)
    return tn, tf


def _slab_pass(tn, tf):
    """The slab verdict with its pad (the kernels repeat it step by step)."""
    return tf * (1.0 + 1e-6) + 1e-6 >= tn


def super_tile_mask(ro: Tensor, rd: Tensor, lo_s: Tensor, hi_s: Tensor, nt: int) -> Tensor:
    """(nt, S) bool: whether any live lane of the tile enters the super-chunk
    box, by per-ray slab tests in blocks of tiles. Conservative for every
    chunk inside the box."""
    inv = _inv_dir(rd)
    out = torch.empty((nt, lo_s.shape[0]), dtype=torch.bool, device=ro.device)
    for t0 in range(0, nt, EXACT_MASK_BLOCK_TILES):
        t1 = min(t0 + EXACT_MASK_BLOCK_TILES, nt)
        ro_t = ro[t0 * LANES:t1 * LANES].reshape(-1, LANES, 3)
        inv_t = inv[t0 * LANES:t1 * LANES].reshape(-1, LANES, 3)
        hit, _ = _slab_hits(ro_t, inv_t, lo_s[None], hi_s[None])
        live = ro_t[..., 0] != PARK_DISTANCE
        out[t0:t1] = torch.any(hit & live[:, :, None], dim=1)
    return out


def chunk_mask_exact(ro: Tensor, rd: Tensor, lo: Tensor, hi: Tensor, nt: int,
                     super_gate: bool = False):
    """EXACT per-tile chunk visibility: per-ray slab tests, OR-reduced over
    each tile's live lanes, refined only over the first EXACT_GATE_CAP
    chunks of the interval list (a conservative superset); a longer interval
    list keeps its tail un-refined. Tiles go through in blocks of
    EXACT_MASK_BLOCK_TILES to bound the (rays, cap) temporaries. The per-tile
    entry bound is the min slab entry over hitting lanes. Same contract as
    ``chunk_mask``.

    ``super_gate`` (scenes of 64 chunks and more): before the refinement, the
    interval list loses every chunk whose super-chunk no live lane enters
    (``super_tile_mask``) and is re-compacted, so the survivors of the whole
    chunk range, not only the first EXACT_GATE_CAP, fill the refined window."""
    m = lo.shape[0]
    k = min(EXACT_GATE_CAP, m)
    ids_i, entry_i, counts_i = chunk_mask(ro, rd, lo, hi, nt)
    pos = torch.arange(m, device=ro.device)[None, :]
    if super_gate and m >= 64:
        lo_s, hi_s, g = super_bounds(lo, hi)
        sup = super_tile_mask(ro, rd, lo_s, hi_s, nt)
        keep = (pos < counts_i[:, None]) & torch.gather(sup, 1, ids_i.long() // g)
        ids_i, entry_i, counts_i = compact_front_to_back(keep, entry_i, ids_i)
    cand = ids_i[:, :k].long()
    cnt = torch.clamp(counts_i, max=k)
    inv = _inv_dir(rd)
    with span("rt.p.sync.mask_const"):
        inf = torch.tensor(float("inf"), dtype=ro.dtype, device=ro.device)
    # positions < k take the per-ray verdicts below; k <= pos < count keep
    # the conservative un-refined interval tail
    mask = (pos >= k) & (pos < counts_i[:, None])
    entry = entry_i.clone()
    for t0 in range(0, nt, EXACT_MASK_BLOCK_TILES):
        t1 = min(t0 + EXACT_MASK_BLOCK_TILES, nt)
        ro_t = ro[t0 * LANES:t1 * LANES].reshape(-1, LANES, 3)
        inv_t = inv[t0 * LANES:t1 * LANES].reshape(-1, LANES, 3)
        lo_b, hi_b = lo[cand[t0:t1]], hi[cand[t0:t1]]            # (bt, k, 3)
        live = ro_t[..., 0] != PARK_DISTANCE
        hit, tn = _slab_hits(ro_t, inv_t, lo_b, hi_b)
        in_list = pos[None, :, :k] < cnt[t0:t1, None, None]
        hit = hit & live[:, :, None] & in_list
        mb = torch.any(hit, dim=1)
        mask[t0:t1, :k] = mb
        entry[t0:t1, :k] = torch.where(mb, torch.where(hit, tn, inf).amin(dim=1), 0.0)
    return compact_front_to_back(mask, entry, ids_i.long())


# ---------------------------------------------------------------------------
# the sweep: CUDA kernel and its plain PyTorch twin
# ---------------------------------------------------------------------------

def sweep_reference(ro: Tensor, rd: Tensor, consts: Tensor, meta: Tensor, chunk_list: Tensor,
                    counts: Tensor, entry: Tensor, det_eps: float, t_min: float,
                    any_mode: bool = False, tested: Tensor | None = None,
                    block_tiles: int | None = None, lo: Tensor | None = None,
                    hi: Tensor | None = None):
    """Plain PyTorch sweep; defines what BOTH kernels compute (the resident
    and the streaming kernel are the same function and share this twin).

    For list position j = 0 .. max(counts)-1 it gathers chunk
    ``chunk_list[:, j]`` for every tile at once, evaluates the four linear
    forms elementwise in f32 (no matmul, so TF32 never enters), and updates:

    * closest mode: valid = |det| >= eps, beta > 0, gamma > 0, beta+gamma < 1,
      t > t_min (divided form); the first minimum within the chunk replaces
      the best hit only when strictly closer (list order across chunks);
      idx = chunk * C + triangle, sorted-space, -1 on a miss;
    * any mode: the division-free sign tests; idx = chunk * C of the FIRST
      occluding chunk in list order, t stays BIG.

    Which positions update which rays is decided per warp: warp w of a tile
    owns its rays ``[WARP_RAYS * w, WARP_RAYS * (w + 1))``. At position j, in
    list order, a warp

    1. leaves the list for good if none of its live lanes wants a chunk any
       more: closest mode wants one while the lane's best t is not below
       ``entry[:, j]`` (lists are sorted by entry), any mode while the lane
       is unoccluded;
    2. skips the position unless, given the chunk boxes ``lo`` and ``hi``
       ((M, 3) each), some live (any mode: and unoccluded) lane's ray enters
       the chunk's box: the slab test and pad of ``_slab_hits``, with the
       exit distance cut at the lane's best t in closest mode. Without boxes
       every position is entered;
    3. else updates all its lanes from the chunk.

    Parked lanes (origin x == ``PARK_DISTANCE``) vote in neither. Neither
    vote changes the result of a live lane: the chunks they pass over hold
    nothing closer. ``tested`` ((nt, WARPS) int32, optional) receives, per
    warp, the positions it reached step 3 at: the pair work the function
    requires, ``tested.sum() * WARP_RAYS * C`` (ray, triangle) pairs.

    Tiles are independent, so they go through in blocks of ``block_tiles``
    (default: as many as keep one (tiles, C, LANES) temporary within
    ``REFERENCE_BLOCK_BYTES``); the result does not depend on the block.
    """
    nt = counts.shape[0]
    c = consts.shape[1]
    if (lo is None) != (hi is None):
        raise ValueError("sweep: the chunk boxes lo and hi come together")
    if block_tiles is None:
        block_tiles = max(1, REFERENCE_BLOCK_BYTES // (4 * c * LANES))
    ro_t, rd_t = ro.reshape(nt, LANES, 3), rd.reshape(nt, LANES, 3)
    out = [_sweep_reference_tiles(ro_t[a:a + block_tiles], rd_t[a:a + block_tiles], consts, meta,
                                  chunk_list[a:a + block_tiles], counts[a:a + block_tiles],
                                  entry[a:a + block_tiles], det_eps, t_min, any_mode,
                                  None if tested is None else tested[a:a + block_tiles], lo, hi)
           for a in range(0, nt, block_tiles)]
    if not out:
        return ro.new_zeros(0), torch.zeros(0, dtype=torch.int32, device=ro.device)
    return torch.cat([t for t, _ in out]).reshape(-1), torch.cat([i for _, i in out]).reshape(-1)


def _any_of_warp(x: Tensor) -> Tensor:
    """(nt, LANES) bool -> (nt, WARPS): any over each warp's rays."""
    return x.reshape(-1, WARPS, WARP_RAYS).any(dim=2)


def _sweep_reference_tiles(ro_t, rd_t, consts, meta, chunk_list, counts, entry, det_eps, t_min,
                           any_mode, tested, lo, hi):
    """``sweep_reference`` on one block of tiles: (best_t, best_i), each
    (nt, LANES)."""
    nt = counts.shape[0]
    c = consts.shape[1]
    dev = ro_t.device
    ox, oy, oz = ro_t[:, None].unbind(-1)
    dx, dy, dz = rd_t[:, None].unbind(-1)
    qx, qy, qz = _cross_rows(dx, dy, dz, ox, oy, oz)
    best_t = torch.full((nt, LANES), BIG, dtype=torch.float32, device=dev)
    best_i = torch.full((nt, LANES), -1, dtype=torch.int32, device=dev)
    n_max = int(counts.max())
    live = ro_t[..., 0] != PARK_DISTANCE
    left = torch.zeros((nt, WARPS), dtype=torch.bool, device=dev)
    n_tested = torch.zeros((nt, WARPS), dtype=torch.int32, device=dev)
    inv_t = None if lo is None else _inv_dir(rd_t)
    for j in range(n_max):
        m = chunk_list[:, j].long()
        # the warps' votes: leave the list, then enter the chunk's box
        if any_mode:
            open_ = live & (best_i < 0)
            left |= ~_any_of_warp(open_)
        else:
            open_ = live
            left |= ~_any_of_warp(live & (best_t >= entry[:, j, None]))
        if lo is not None:
            tn, tf = _slab_interval(ro_t, inv_t, lo[m][:, None], hi[m][:, None])
            if not any_mode:
                tf = torch.minimum(tf, best_t)
            open_ = open_ & _slab_pass(tn, tf)
        run = (j < counts)[:, None] & ~left & _any_of_warp(open_)             # (nt, WARPS)
        n_tested += run
        run = run.repeat_interleave(WARP_RAYS, dim=1)                          # (nt, LANES)

        gx, gy, gz = (meta[m][:, i, None, None] for i in range(3))
        w = consts[m][..., None]                                 # (nt, C, NCOEF, 1)
        nx, ny, nz, d, c1x, c1y, c1z, e2x, e2y, e2z, c2x, c2y, c2z, e1x, e1y, e1z = \
            w.unbind(2)
        rx, ry, rz = ox - gx, oy - gy, oz - gz
        px, py, pz = (q - s for q, s in zip((qx, qy, qz), _cross_rows(dx, dy, dz, gx, gy, gz)))
        det = nx * dx + ny * dy + nz * dz
        tnum = d - (nx * rx + ny * ry + nz * rz)
        bnum = (c1x * dx + c1y * dy + c1z * dz) - (e2x * px + e2y * py + e2z * pz)
        gnum = (c2x * dx + c2y * dy + c2z * dz) + (e1x * px + e1y * py + e1z * pz)
        if any_mode:
            det2 = det * det
            m1, m2 = bnum * det, gnum * det
            valid = ((det2 >= det_eps * det_eps) & (m1 > 0.0) & (m2 > 0.0)
                     & (m1 + m2 < det2) & (tnum * det > t_min * det2))
            new = torch.any(valid, dim=1) & run & (best_i < 0)
            best_i = torch.where(new, (m * c).to(torch.int32)[:, None], best_i)
        else:
            ok = torch.abs(det) >= det_eps
            invd = 1.0 / torch.where(ok, det, torch.ones_like(det))
            t, beta, gamma = tnum * invd, bnum * invd, gnum * invd
            valid = ok & (beta > 0.0) & (gamma > 0.0) & (beta + gamma < 1.0) & (t > t_min)
            tm = torch.where(valid, t, torch.full_like(t, BIG))
            tmin = tm.amin(dim=1)
            amin = torch.argmin(tm, dim=1).to(torch.int32)
            upd = (tmin < best_t) & run
            best_t = torch.where(upd, tmin, best_t)
            best_i = torch.where(upd, (m * c).to(torch.int32)[:, None] + amin, best_i)
    if tested is not None:
        tested.copy_(n_tested)
    return best_t, best_i


def _check_all(who: str, device, checked, contiguous: bool = True) -> None:
    """Raise unless each (name, tensor, dtype, shape) of ``checked`` has that
    dtype and shape, lies on ``device`` and, where asked, is contiguous."""
    for name, x, dtype, shape in checked:
        if x.dtype != dtype:
            raise TypeError(f"{who}: {name} has dtype {x.dtype}, want {dtype}")
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{who}: {name} has shape {tuple(x.shape)}, want {tuple(shape)}")
        if contiguous and not x.is_contiguous():
            raise ValueError(f"{who}: {name} is not contiguous")
        if x.device != device:
            raise ValueError(f"{who}: {name} is on {x.device}, ro on {device}")


def sweep(ro: Tensor, rd: Tensor, consts: Tensor, meta: Tensor, chunk_list: Tensor,
          counts: Tensor, entry: Tensor, det_eps: float, t_min: float,
          any_mode: bool = False, tested: Tensor | None = None, stream: bool = False,
          lo: Tensor | None = None, hi: Tensor | None = None):
    """The chunk sweep over whole tiles: (t (R,) f32, idx (R,) i32), R =
    nt * LANES. CUDA tensors launch the resident kernel (``csrc/sweep.cu``)
    or, with ``stream``, the streaming kernel (``csrc/sweep_stream.cu``); CPU
    tensors run ``sweep_reference``. Anything else raises. ``lo``, ``hi`` (the
    chunk boxes: the warps' chunk gate) and ``tested`` as in
    ``sweep_reference``. Each kernel counts its launches: ``sweep.launches``
    and ``sweep.stream_launches``.

    The launch (on CPU tensors the twin) runs in the span
    ``rt.p.kernel.closest`` or ``rt.p.kernel.any``; while it records, the
    call counts its ``mode``, ``tested`` (a fresh buffer where the caller
    gave none: both kernels write every (tile, warp) entry), ``warp_rays``
    and ``chunk``, so that ``tested * warp_rays * chunk`` are the (ray,
    triangle) pairs the call tested."""
    nt = counts.shape[0]
    m, c = consts.shape[0], consts.shape[1]
    r = nt * LANES
    f32, i32 = torch.float32, torch.int32
    if (lo is None) != (hi is None):
        raise ValueError("sweep: the chunk boxes lo and hi come together")
    checked = [("ro", ro, f32, (r, 3)), ("rd", rd, f32, (r, 3)),
               ("consts", consts, f32, (m, c, NCOEF)), ("meta", meta, f32, (m, 3)),
               ("chunk_list", chunk_list, i32, (nt, m)), ("counts", counts, i32, (nt,)),
               ("entry", entry, f32, (nt, m))]
    if lo is not None:
        checked += [("lo", lo, f32, (m, 3)), ("hi", hi, f32, (m, 3))]
    if tested is not None:
        checked.append(("tested", tested, i32, (nt, WARPS)))
    _check_all("sweep", ro.device, checked)
    mode = "any" if any_mode else "closest"
    if ro.device.type == "cpu":
        with span(f"rt.p.kernel.{mode}") as s:
            return sweep_reference(ro, rd, consts, meta, chunk_list, counts, entry, det_eps,
                                   t_min, any_mode, _counted(s, tested, nt, c, mode, ro.device),
                                   lo=lo, hi=hi)
    if ro.device.type != "cuda":
        raise ValueError(f"sweep: no kernel for device {ro.device}")
    # both kernels read a chunk as 16-byte words: a chunk is 64*C bytes from the base
    if consts.data_ptr() % 16:
        raise ValueError("sweep: the kernels need consts aligned to 16 bytes")
    # what a block needs: the ring's stages (streaming), a slice a warp (resident)
    need = c * NCOEF * 4 * (STREAM_STAGES if stream else RESIDENT_BLOCK_WARPS)
    room = MAX_DYNAMIC_SMEM - (STREAM_SMEM_RESERVE if stream else 0)
    if need > room:
        raise ValueError(f"sweep: a block needs {need} bytes of shared memory for "
                         f"{c}-triangle chunks, the card gives it {room}")
    out_t = torch.empty(r, dtype=f32, device=ro.device)
    out_i = torch.empty(r, dtype=i32, device=ro.device)
    lib = cuda_build.load()
    fn = lib.rt_sweep_stream if stream else lib.rt_sweep
    with span(f"rt.p.kernel.{mode}") as s:
        tested = _counted(s, tested, nt, c, mode, ro.device)
        rc = fn(ro.data_ptr(), rd.data_ptr(), consts.data_ptr(), meta.data_ptr(),
                None if lo is None else lo.data_ptr(), None if hi is None else hi.data_ptr(),
                chunk_list.data_ptr(), counts.data_ptr(), entry.data_ptr(), out_t.data_ptr(),
                out_i.data_ptr(), None if tested is None else tested.data_ptr(), nt, m, c,
                float(det_eps), float(t_min), int(any_mode), ro.device.index or 0,
                torch.cuda.current_stream(ro.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sweep kernel launch failed: {cuda_build.error_string(rc)}")
    if nt:
        if stream:
            sweep.stream_launches += 1
        else:
            sweep.launches += 1
    return out_t, out_i


sweep.launches = 0          # launches of the resident kernel
sweep.stream_launches = 0   # launches of the streaming kernel


def _counted(s, tested: Tensor | None, nt: int, c: int, mode: str, device):
    """The ``tested`` buffer a launch in the span ``s`` fills: the caller's,
    or while ``s`` records a fresh one (``torch.empty``, no kernel), which
    ``s`` counts."""
    if not s.on:
        return tested
    if tested is None:
        tested = torch.empty((nt, WARPS), dtype=torch.int32, device=device)
    s.count(mode=mode, tested=tested, warp_rays=WARP_RAYS, chunk=c)
    return tested


# ---------------------------------------------------------------------------
# query entry points
# ---------------------------------------------------------------------------

@torch.no_grad()
@spanned("rt.p.mask")
def sweep_inputs(ro: Tensor, rd: Tensor, pack: AccelPack, cfg: RenderConfig,
                 exact_mask: bool | None = None):
    """The sweep's per-query inputs: rays cast to f32 (shading may run in f64)
    and padded with parked lanes to whole tiles, and each tile's chunk list.
    ``exact_mask`` forces the exact per-ray chunk mask on or off; None picks
    it for query widths up to ``cfg.exact_mask_rays`` and, in big scenes
    (``EXACT_MASK_MIN_TRIS``), at every width, except for CUDA tensors under
    ``INTERVAL_LISTS_ON_CUDA``, which take the interval list (the kernels'
    warps prune it themselves). Big scenes run the exact mask behind the
    super-chunk gate.
    Returns (ro32, rd32, chunk_list, entry, counts)."""
    big = pack.n_chunks * pack.chunk_size >= EXACT_MASK_MIN_TRIS
    f32 = torch.float32
    pad = (-ro.shape[0]) % LANES
    ro32 = torch.cat([ro.to(f32), ro.new_full((pad, 3), PARK_DISTANCE, dtype=f32)])
    rd32 = torch.cat([rd.to(f32), ro.new_full((pad, 3), 1.0, dtype=f32)])
    if exact_mask is None:
        exact_mask = ((ro32.shape[0] <= cfg.exact_mask_rays or big)
                      and not (INTERVAL_LISTS_ON_CUDA and ro.device.type == "cuda"))
    nt = ro32.shape[0] // LANES
    if exact_mask:
        chunk_list, entry, counts = chunk_mask_exact(ro32, rd32, pack.lo, pack.hi, nt,
                                                     super_gate=big)
    else:
        chunk_list, entry, counts = chunk_mask(ro32, rd32, pack.lo, pack.hi, nt)
    return ro32, rd32, chunk_list.contiguous(), entry.contiguous(), counts


@torch.no_grad()
def closest_triangle(scene: Scene, ro: Tensor, rd: Tensor, cfg: RenderConfig,
                     any_mode: bool = False, pack: AccelPack | None = None,
                     raw_idx: bool = False, exact_mask: bool | None = None):
    """Nearest triangle (t, index) via the chunk sweep; forward only.

    ``any_mode`` turns the query into occlusion (t stays BIG). ``raw_idx``
    returns SORTED-space indices (for callers that gather from the sorted
    table); default is the original triangle index. ``exact_mask`` as in
    ``sweep_inputs``.
    """
    if pack is None:
        pack = build_pack(scene, cfg)
    r = ro.shape[0]
    ro32, rd32, chunk_list, entry, counts = sweep_inputs(ro, rd, pack, cfg, exact_mask)
    t, idx = sweep(ro32, rd32, pack.consts, pack.meta, chunk_list, counts, entry,
                   float(cfg.det_epsilon), float(cfg.smallest_dist), any_mode,
                   stream=not pack.resident, lo=pack.lo, hi=pack.hi)
    idx = idx[:r].long()
    t = torch.where(idx >= 0, t[:r].to(ro.dtype), torch.full((r,), BIG, dtype=ro.dtype,
                                                             device=ro.device))
    if raw_idx:
        return t, idx
    return t, torch.where(idx >= 0, pack.perm[idx.clamp(min=0)], -1)


def any_triangle(scene: Scene, ro: Tensor, rd: Tensor, cfg: RenderConfig,
                 pack: AccelPack | None = None, exact_mask: bool | None = None) -> Tensor:
    """Occlusion: True where any triangle is hit with t > smallest_dist."""
    _, idx = closest_triangle(scene, ro, rd, cfg, any_mode=True, pack=pack, raw_idx=True,
                              exact_mask=exact_mask)
    return idx >= 0
