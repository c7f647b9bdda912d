"""Dense batched primitive intersections and closest-hit / any-hit queries.

Counterpart of ``realtrace_tpu/ops/intersect.py``. Each family is tested as
one (rays x primitives) masked reduction; the nearest hit is an argmin.

Gradient design: hit SELECTION runs under ``torch.no_grad()``; the hit
attributes (t, normal, position, colour, materials) are then recomputed from
the selected primitive's tensors, so gradients reach vertices, centres, radii
and colours while visibility stays fixed.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import Tensor

from realtrace_tpu_torch.core import vec
from realtrace_tpu_torch.core.types import BIG, MATERIAL_KEYS, RenderConfig, Scene
from realtrace_tpu_torch.ops import accel, level_kernels, sweep
from realtrace_tpu_torch.utils.profiling import spanned

# family codes
FAM_NONE, FAM_TRI, FAM_SPH, FAM_PLN, FAM_CYL = 0, 1, 2, 3, 4


@dataclasses.dataclass
class Hit:
    """Per-ray hit record (SoA), the wavefront analog of the reference Ray's
    hit state (Serial/ray.h:20-27)."""

    valid: Tensor     # (R,) bool
    t: Tensor         # (R,)
    family: Tensor    # (R,) int64, FAM_*
    index: Tensor     # (R,) int64 primitive index within its family (original order)
    position: Tensor  # (R, 3)
    normal: Tensor    # (R, 3) geometric normal, unnormalized (as in the reference)
    color: Tensor     # (R, 3) surface colour at the hit
    ka: Tensor
    kd: Tensor
    ks: Tensor
    kr: Tensor
    kt: Tensor
    eta: Tensor


def _big(x: Tensor) -> Tensor:
    return torch.full_like(x, BIG)


# ---------------------------------------------------------------------------
# per-family dense tests: candidate t over (R, N), BIG where invalid
# ---------------------------------------------------------------------------

def triangle_test(ro: Tensor, rd: Tensor, tv: Tensor, det_eps: float, t_min: float):
    """Cramer triangle test, Ref: Triangle::intersect, Serial/triangle.cpp:10-24:
    det(A-B, A-C, D) with accept ``beta>0 && gamma>0 && beta+gamma<1``.

    ro, rd: (R, 3); tv: (N, 3, 3). Returns t (BIG where invalid), beta, gamma,
    each (R, N).
    """
    a, b, c = tv[:, 0], tv[:, 1], tv[:, 2]
    e1 = a - b
    e2 = a - c
    n = vec.cross(e1, e2)
    det = rd @ n.T
    s = a[None, :, :] - ro[:, None, :]
    t_num = vec.dot(s, n[None])
    beta_num = vec.dot(rd[:, None, :], vec.cross(s, e2[None]))
    gamma_num = vec.dot(rd[:, None, :], vec.cross(e1[None], s))
    det_ok = torch.abs(det) >= det_eps
    inv = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    beta = beta_num * inv
    gamma = gamma_num * inv
    t = t_num * inv
    ok = det_ok & (beta > 0.0) & (gamma > 0.0) & (beta + gamma < 1.0) & (t > t_min)
    return torch.where(ok, t, _big(t)), beta, gamma


def sphere_test(ro: Tensor, rd: Tensor, center: Tensor, radius: Tensor, t_min: float):
    """Quadratic sphere test, nearest valid root. Ref: Serial/sphere.cpp:5-39."""
    cv = ro[:, None, :] - center[None]
    b = 2.0 * vec.dot(rd[:, None, :], cv)
    c = vec.dot(cv, cv) - (radius * radius)[None]
    disc = b * b - 4.0 * c
    ok = disc >= 0.0
    sq = torch.sqrt(torch.where(ok, disc, torch.zeros_like(disc)))
    t1 = (-b + sq) * 0.5
    t2 = (-b - sq) * 0.5
    t1 = torch.where(ok & (t1 > t_min), t1, _big(t1))
    t2 = torch.where(ok & (t2 > t_min), t2, _big(t2))
    return torch.minimum(t1, t2)


def quad_test(ro: Tensor, rd: Tensor, corners: Tensor, det_eps: float, t_min: float):
    """Quad ("Plane") = triangles (p1,p2,p3) and (p1,p3,p4), nearest valid.
    Ref: Plane::intersect, Serial/plane.cpp:24-27."""
    p1, p2, p3, p4 = corners[:, 0], corners[:, 1], corners[:, 2], corners[:, 3]
    t_a, _, _ = triangle_test(ro, rd, torch.stack([p1, p2, p3], dim=1), det_eps, t_min)
    t_b, _, _ = triangle_test(ro, rd, torch.stack([p1, p3, p4], dim=1), det_eps, t_min)
    return torch.minimum(t_a, t_b)


def cylinder_test(ro: Tensor, rd: Tensor, center: Tensor, up: Tensor, radius: Tensor,
                  t_min: float):
    """Infinite cylinder: quadratic in the plane normal to the axis; the
    smaller root if positive, else the larger. Ref: Serial/cylinder.cpp:14-32."""
    d_par = vec.dot(rd[:, None, :], up[None])[..., None] * up[None]
    tmp1 = rd[:, None, :] - d_par
    oc = ro[:, None, :] - center[None]
    oc_par = vec.dot(oc, up[None])[..., None] * up[None]
    tmp2 = oc - oc_par
    a = vec.dot(tmp1, tmp1)
    b = 2.0 * vec.dot(tmp1, tmp2)
    c = vec.dot(tmp2, tmp2) - (radius * radius)[None]
    disc = b * b - 4.0 * a * c
    nz = torch.abs(a) > 0.0
    ok = (disc >= 0.0) & nz
    a_safe = torch.where(nz, a, torch.ones_like(a))
    sq = torch.sqrt(torch.where(ok, disc, torch.zeros_like(disc)))
    r1 = (-b + sq) / (2.0 * a_safe)
    r2 = (-b - sq) / (2.0 * a_safe)
    lo = torch.minimum(r1, r2)
    hi = torch.maximum(r1, r2)
    t = torch.where(lo > 0.0, lo, hi)
    return torch.where(ok & (t > t_min), t, _big(t))


# ---------------------------------------------------------------------------
# closest hit
# ---------------------------------------------------------------------------

def _tri_closest(scene: Scene, ro: Tensor, rd: Tensor, cfg: RenderConfig, pack=None,
                 exact_mask=None):
    """Nearest triangle per ray: (t, idx), BIG / -1 on a miss. In sweep mode
    idx is SORTED-space (``hit_attributes`` maps it back); the other accels
    return original indices."""
    r = ro.shape[0]
    if scene.n_triangles == 0:
        return (torch.full((r,), BIG, dtype=ro.dtype, device=ro.device),
                torch.full((r,), -1, dtype=torch.int64, device=ro.device))
    if cfg.accel == "sweep":
        return sweep.closest_triangle(scene, ro, rd, cfg, pack=pack, raw_idx=True,
                                      exact_mask=exact_mask)
    if cfg.accel == "chunked":
        return accel.closest_triangle(scene, ro, rd, cfg)
    t, _, _ = triangle_test(ro, rd, scene.tri_vertices, cfg.det_epsilon, cfg.smallest_dist)
    tbest, idx = torch.min(t, dim=1)
    return tbest, torch.where(tbest < BIG, idx, torch.full_like(idx, -1))


def _family_min(cands):
    """Merge per-family (t, family_code, idx) candidates by nearest t."""
    t, fam, idx = cands[0]
    for t2, fam2, idx2 in cands[1:]:
        closer = t2 < t
        t = torch.where(closer, t2, t)
        fam = torch.where(closer, fam2, fam)
        idx = torch.where(closer, idx2, idx)
    return t, fam, idx


def _argmin_cand(t: Tensor, code: int):
    tb, i = torch.min(t, dim=1)          # the first minimum, as argmin
    return tb, torch.where(tb < BIG, code, FAM_NONE), i


@torch.no_grad()
def closest_query(scene: Scene, ro: Tensor, rd: Tensor, cfg: RenderConfig, pack=None,
                  exact_mask=None):
    """Forward-only nearest-hit SELECTION over all families: ``(t, fam, idx)``
    per ray (idx family-local; sorted-space for sweep-mode triangles). The
    discrete part of ``World::firstIntersection`` (Serial/world.cpp:5-17)."""
    ro, rd = ro.detach(), rd.detach()
    t_tri, idx_tri = _tri_closest(scene, ro, rd, cfg, pack=pack, exact_mask=exact_mask)
    cands = [(t_tri, torch.where(idx_tri >= 0, FAM_TRI, FAM_NONE), idx_tri)]
    if scene.n_spheres:
        cands.append(_argmin_cand(sphere_test(ro, rd, scene.sph_center, scene.sph_radius,
                                              cfg.smallest_dist), FAM_SPH))
    if scene.n_planes:
        cands.append(_argmin_cand(quad_test(ro, rd, scene.pln_corners, cfg.det_epsilon,
                                            cfg.smallest_dist), FAM_PLN))
    if scene.n_cylinders:
        cands.append(_argmin_cand(cylinder_test(ro, rd, scene.cyl_center, scene.cyl_up,
                                                scene.cyl_radius, cfg.smallest_dist),
                                  FAM_CYL))
    t_fwd, fam, idx = _family_min(cands)
    valid = fam != FAM_NONE
    return t_fwd, fam, torch.where(valid, idx, torch.zeros_like(idx))


def _sel(mask: Tensor, new: Tensor, old: Tensor) -> Tensor:
    if new.dim() == 2:
        return torch.where(mask[:, None], new, old)
    return torch.where(mask, new, old)


def _closer_root(r1: Tensor, r2: Tensor, t_fwd: Tensor) -> Tensor:
    """The root matching the (stopped) forward decision."""
    return torch.where(torch.abs(r1.detach() - t_fwd) < torch.abs(r2.detach() - t_fwd), r1, r2)


# a family of at most this many primitives gathers by select-and-sum (``_rows``)
FEW_ROWS = 8


def _rows(x: Tensor, m: Tensor, idx: Tensor) -> Tensor:
    """``x[idx]`` on the lanes a family owns (``m``); the other lanes get rows
    whose values are discarded. The gather's backward is a scatter-add, which
    PyTorch runs on CUDA as a sort followed by a serial sum over each row's
    duplicates (deterministic, and slow for a long run). So no row is repeated
    by a whole wavefront: unowned lanes take row ``lane mod n``, and a family
    of at most ``FEW_ROWS`` primitives, whose rows every lane repeats, gathers
    as a sum of masked rows, whose backward is a sum over the lanes."""
    n = x.shape[0]
    if n > FEW_ROWS:
        return x[torch.where(m, idx, torch.arange(idx.shape[0], device=idx.device) % n)]
    own = torch.where(m, idx, -1).reshape((-1,) + (1,) * (x.dim() - 1))
    out = (own == 0).to(x.dtype) * x[0]
    for k in range(1, n):
        out = out + (own == k).to(x.dtype) * x[k]
    return out


@spanned("rt.p.hits")
def hit_attributes(scene: Scene, ro: Tensor, rd: Tensor, t_fwd: Tensor, fam: Tensor,
                   idx: Tensor, cfg: RenderConfig, pack=None) -> Hit:
    """Differentiable attribute recomputation for a selected hit
    ``(t_fwd, fam, idx)`` from ``closest_query``, read from the original
    scene tensors. Each family gathers at ``idx`` on its own lanes (``_rows``;
    the lanes it does not own are discarded). Where no gradient is recorded
    through a scene of triangles alone on the card
    (``level_kernels.takes``), one kernel computes the same ``Hit``."""
    tm = scene.tri_materials
    if level_kernels.takes(scene, cfg, pack, ro, rd, scene.tri_vertices, scene.tri_colors,
                           *(getattr(tm, k) for k in MATERIAL_KEYS)):
        valid, t, index, position, normal, color, mats = level_kernels.hits_kernel(
            scene, ro, rd, fam, idx, pack.perm)
        return Hit(valid=valid, t=t, family=fam, index=index, position=position, normal=normal,
                   color=color, **mats)
    r = ro.shape[0]
    valid = fam != FAM_NONE
    zero3 = ro.new_zeros((r, 3))
    zero = ro.new_zeros((r,))
    t_d, normal, color = torch.full_like(zero, BIG), zero3, zero3
    mats = {k: zero for k in MATERIAL_KEYS}
    index_out = idx

    if scene.n_triangles:
        m = valid & (fam == FAM_TRI)
        table = torch.cat([scene.tri_vertices.reshape(-1, 9), scene.tri_colors.reshape(-1, 9),
                           torch.stack([getattr(tm, k) for k in MATERIAL_KEYS], dim=1)],
                          dim=1)                                   # (N, 24)
        if cfg.accel == "sweep":
            # sweep idx is SORTED-space: gather from the permuted table and
            # read the original triangle id back from an index column (exact
            # in f32/f64 below 2^24 triangles); no per-ray permutation gather
            perm = pack.perm if pack is not None else scene.tri_chunk_perm
            table = torch.cat([table[perm], perm.to(table.dtype)[:, None]], dim=1)
        g = _rows(table, m, idx).unbind(1)   # one backward node for the columns
        if cfg.accel == "sweep":
            index_out = torch.where(m, g[24].to(idx.dtype), index_out)
        ax, ay, az = g[0], g[1], g[2]
        bx, by, bz = g[3], g[4], g[5]
        cx, cy, cz = g[6], g[7], g[8]
        rx, ry, rz = rd[:, 0], rd[:, 1], rd[:, 2]
        ox, oy, oz = ro[:, 0], ro[:, 1], ro[:, 2]
        e1x, e1y, e1z = ax - bx, ay - by, az - bz
        e2x, e2y, e2z = ax - cx, ay - cy, az - cz
        nx = e1y * e2z - e1z * e2y
        ny = e1z * e2x - e1x * e2z
        nz = e1x * e2y - e1y * e2x
        det = rx * nx + ry * ny + rz * nz
        det_safe = torch.where(torch.abs(det) > 0, det, torch.ones_like(det))
        sx, sy, sz = ax - ox, ay - oy, az - oz
        tt = (sx * nx + sy * ny + sz * nz) / det_safe
        beta = (rx * (sy * e2z - sz * e2y) + ry * (sz * e2x - sx * e2z)
                + rz * (sx * e2y - sy * e2x)) / det_safe
        gamma = (rx * (e1y * sz - e1z * sy) + ry * (e1z * sx - e1x * sz)
                 + rz * (e1x * sy - e1y * sx)) / det_safe
        alpha = 1.0 - beta - gamma
        col = torch.stack([alpha * g[9] + beta * g[12] + gamma * g[15],
                           alpha * g[10] + beta * g[13] + gamma * g[16],
                           alpha * g[11] + beta * g[14] + gamma * g[17]], dim=1)
        t_d = _sel(m, tt, t_d)
        normal = _sel(m, torch.stack([nx, ny, nz], dim=1), normal)
        color = _sel(m, col, color)
        for j, k in enumerate(MATERIAL_KEYS):
            mats[k] = _sel(m, g[18 + j], mats[k])

    if scene.n_spheres:
        m = valid & (fam == FAM_SPH)
        ctr = _rows(scene.sph_center, m, idx)
        rad = _rows(scene.sph_radius, m, idx)
        cv = ro - ctr
        b2 = 2.0 * vec.dot(rd, cv)
        c2 = vec.dot(cv, cv) - rad * rad
        disc = b2 * b2 - 4.0 * c2
        dok = disc > 0.0
        sq = torch.where(dok, torch.sqrt(torch.where(dok, disc, torch.ones_like(disc))),
                         torch.zeros_like(disc))
        tt = _closer_root((-b2 + sq) * 0.5, (-b2 - sq) * 0.5, t_fwd)
        pos = ro + tt[:, None] * rd
        t_d = _sel(m, tt, t_d)
        normal = _sel(m, pos - ctr, normal)     # Sphere::getNormalAtPosition
        color = _sel(m, _rows(scene.sph_color, m, idx), color)
        for k in mats:
            mats[k] = _sel(m, _rows(getattr(scene.sph_materials, k), m, idx), mats[k])

    if scene.n_planes:
        m = valid & (fam == FAM_PLN)
        cr = _rows(scene.pln_corners, m, idx)
        p1, p2, p3 = cr[:, 0], cr[:, 1], cr[:, 2]
        nrm = vec.cross(p3 - p1, p2 - p1)       # Plane ctor normal, Serial/plane.h:24
        det = vec.dot(rd, nrm)
        det_safe = torch.where(torch.abs(det) > 0, det, torch.ones_like(det))
        tt = vec.dot(p1 - ro, nrm) / det_safe
        t_d = _sel(m, tt, t_d)
        normal = _sel(m, nrm, normal)
        color = _sel(m, _rows(scene.pln_color, m, idx), color)
        for k in mats:
            mats[k] = _sel(m, _rows(getattr(scene.pln_materials, k), m, idx), mats[k])

    if scene.n_cylinders:
        m = valid & (fam == FAM_CYL)
        ctr, up = _rows(scene.cyl_center, m, idx), _rows(scene.cyl_up, m, idx)
        rad = _rows(scene.cyl_radius, m, idx)
        tmp1 = rd - vec.dot(rd, up)[:, None] * up
        oc = ro - ctr
        tmp2 = oc - vec.dot(oc, up)[:, None] * up
        a2 = vec.dot(tmp1, tmp1)
        b2 = 2.0 * vec.dot(tmp1, tmp2)
        c2 = vec.dot(tmp2, tmp2) - rad * rad
        disc = b2 * b2 - 4.0 * a2 * c2
        dok = disc > 0.0
        a_safe = torch.where(torch.abs(a2) > 0, a2, torch.ones_like(a2))
        sq = torch.where(dok, torch.sqrt(torch.where(dok, disc, torch.ones_like(disc))),
                         torch.zeros_like(disc))
        tt = _closer_root((-b2 + sq) / (2 * a_safe), (-b2 - sq) / (2 * a_safe), t_fwd)
        pos = ro + tt[:, None] * rd
        # Cylinder::getNormalAtPosition: p - c - ((p-c).u/(u.u)) u
        pc = pos - ctr
        proj = vec.dot(pc, up) / torch.clamp(vec.dot(up, up), min=1e-30)
        t_d = _sel(m, tt, t_d)
        normal = _sel(m, pc - proj[:, None] * up, normal)
        color = _sel(m, _rows(scene.cyl_color, m, idx), color)
        for k in mats:
            mats[k] = _sel(m, _rows(getattr(scene.cyl_materials, k), m, idx), mats[k])

    t_final = torch.where(valid, t_d, torch.full_like(t_d, BIG))
    position = ro + t_final[:, None] * rd
    return Hit(valid=valid, t=t_final, family=fam,
               index=torch.where(valid, index_out, torch.full_like(index_out, -1)),
               position=torch.where(valid[:, None], position, torch.zeros_like(position)),
               normal=normal, color=color, **mats)


def closest_hit(scene: Scene, ro: Tensor, rd: Tensor, cfg: RenderConfig, pack=None) -> Hit:
    """Nearest hit over all families with differentiable attributes
    (``World::firstIntersection``, Serial/world.cpp:5-17)."""
    t_fwd, fam, idx = closest_query(scene, ro, rd, cfg, pack=pack)
    return hit_attributes(scene, ro, rd, t_fwd, fam, idx, cfg, pack=pack)


@torch.no_grad()
def any_hit(scene: Scene, ro: Tensor, rd: Tensor, cfg: RenderConfig, pack=None,
            exact_mask=None) -> Tensor:
    """Occlusion query: does anything intersect with t > SMALLEST_DIST? No
    cutoff at the light, as in the reference (Serial/world.cpp:44-47)."""
    ro, rd = ro.detach(), rd.detach()
    occ = torch.zeros(ro.shape[0], dtype=torch.bool, device=ro.device)
    if scene.n_triangles:
        if cfg.accel == "sweep":
            occ |= sweep.any_triangle(scene, ro, rd, cfg, pack=pack, exact_mask=exact_mask)
        elif cfg.accel == "chunked":
            occ |= accel.any_triangle(scene, ro, rd, cfg)
        else:
            t, _, _ = triangle_test(ro, rd, scene.tri_vertices, cfg.det_epsilon,
                                    cfg.smallest_dist)
            occ |= torch.any(t < BIG, dim=1)
    if scene.n_spheres:
        occ |= torch.any(sphere_test(ro, rd, scene.sph_center, scene.sph_radius,
                                     cfg.smallest_dist) < BIG, dim=1)
    if scene.n_planes:
        occ |= torch.any(quad_test(ro, rd, scene.pln_corners, cfg.det_epsilon,
                                   cfg.smallest_dist) < BIG, dim=1)
    if scene.n_cylinders:
        occ |= torch.any(cylinder_test(ro, rd, scene.cyl_center, scene.cyl_up,
                                       scene.cyl_radius, cfg.smallest_dist) < BIG, dim=1)
    return occ
