"""The plain reference: a Whitted ray tracer in plain PyTorch.

It follows the semantics of the RealTrace serial renderer
(``Serial/world.cpp:32-111``, as transliterated in NumPy by the repository's
oracle, ``tests/oracle/cpu_reference.py``): the exact closest hit over every
triangle and sphere (Cramer's rule, ``beta > 0, gamma > 0, beta + gamma <
1, t > smallest_dist``), shadow rays from ``pos + bias * to_light`` that
shadow on any hit, Phong with the reference's legacy diffuse and shadow
blend, kr-weighted reflection children and the dielectric Fresnel split;
rays past the last level take the background. Rays of one level go through
together as a batch, each carrying its pixel and its coefficient, so the
recursion is a sum over levels and autograd differentiates it as written
(hit selection and shadowing are held fixed, as in the program).

The closest-hit search is brute force over triangles and spheres, culled by
the boxes of groups of 32 from a median split (``median_split``, a frozen
copy of the program's host ordering): a ray is tested against every
primitive of every group whose box its line enters (with a generous pad),
which drops no hit. It runs in blocks of bounded size, so that no tensor of
(rays x primitives) is formed. It imports neither the program nor JAX and
takes nothing the program made: scene arrays and cameras come from
``rtbench.scene``.

``Reference(cfg, device)`` computes in float64. With ``lowp`` it is the
control: float32, with the operands of every ray/triangle product rounded to
TF32 (10 mantissa bits), as a tensor-core evaluation of the pair test would
round them.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import Tensor

GROUP = 32                 # triangles per reference group
SPH_GROUP = 32             # spheres per reference group
SLAB_ELEMS = 1 << 23       # (ray, group) slab tests per block
PAIR_TESTS = 1 << 22       # (ray, primitive) tests per block
# relative and absolute pad of the group slab test, by dtype: far above the
# test's rounding, so no grazing hit is dropped
PAD = {torch.float64: 1e-9, torch.float32: 1e-5}
# a sphere group's box grows by this share of its distance from the ray's
# origin: the sphere test's discriminant loses ~20 ulp of |origin - centre|^2,
# so it can pass a ray that misses by sqrt(20 ulp) of that distance (f32
# 1.1e-3, f64 4.7e-8); the box keeps every such ray
SPH_MARGIN = {torch.float64: 1e-6, torch.float32: 1e-2}
INF = float("inf")


def median_split(tri_vertices: np.ndarray, size: int = GROUP) -> np.ndarray:
    """Balanced median split of the triangle centroids on group boundaries
    (padded to a multiple of ``size`` by repeating the last triangle): split
    each group of k groups along the longest axis of its centroids' extent,
    the left part taking k // 2. Returns the int64 permutation."""
    tv = np.asarray(tri_vertices, np.float64)
    n = tv.shape[0]
    if n == 0:
        return np.zeros((0,), np.int64)
    cent = tv.mean(axis=1).astype(np.float32)
    ids = np.arange(n)
    pad = (-n) % size
    if pad:
        ids = np.concatenate([ids, np.repeat(ids[-1], pad)])
    out = []
    stack = [ids]
    while stack:
        g = stack.pop()
        k = len(g) // size
        if k <= 1:
            out.append(g)
            continue
        c = cent[g]
        ax = int(np.argmax(c.max(0) - c.min(0)))
        order = np.argsort(c[:, ax], kind="stable")
        nl = (k // 2) * size
        stack.append(g[order[nl:]])      # popped after the left part
        stack.append(g[order[:nl]])
    return np.concatenate(out).astype(np.int64)


def tf32(x: Tensor) -> Tensor:
    """float32 ``x`` rounded to TF32's 10 mantissa bits (to nearest, ties to
    even); the gradient passes through as if unrounded."""
    d = x.detach()
    b = d.contiguous().view(torch.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    return x + (b.view(torch.float32) - d)


def _cross(a: Tensor, b: Tensor) -> Tensor:
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def _dot(a: Tensor, b: Tensor) -> Tensor:
    return (a * b).sum(-1)


def _normalize(v: Tensor) -> Tensor:
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def _inv(d: Tensor) -> Tensor:
    big = torch.full_like(d, 1e300 if d.dtype == torch.float64 else 1e30)
    return torch.where(d != 0, 1.0 / torch.where(d != 0, d, big), big)


def slab(ro: Tensor, inv: Tensor, lo: Tensor, hi: Tensor):
    """(tn, tf): entry (clamped at 0) and exit distance of rays through
    boxes, all broadcast over a leading ray axis and a box axis."""
    t1 = (lo - ro) * inv
    t2 = (hi - ro) * inv
    tn = torch.minimum(t1, t2).amax(-1).clamp(min=0.0)
    tf = torch.maximum(t1, t2).amin(-1)
    return tn, tf


class Groups:
    """The reference grouping of a triangle set: ``perm`` (G, GROUP) original
    indices, ``count`` (G,) distinct triangles per group, and the boxes; and
    of the spheres at ``sph_center``, if any: ``sph_perm`` (G', SPH_GROUP)
    (their boxes follow the spheres' tensors at each query)."""

    def __init__(self, tri_vertices: Tensor, perm: np.ndarray | None = None,
                 sph_center: Tensor | None = None):
        tv = tri_vertices.detach()
        if perm is None:
            perm = median_split(tv.cpu().numpy())
        self.perm = torch.as_tensor(perm, device=tv.device).reshape(-1, GROUP)
        srt = self.perm.sort(dim=1).values      # the padding repeats the last triangle
        self.count = (srt[:, 1:] != srt[:, :-1]).sum(1) + 1
        self.refit(tv)
        c = np.zeros((0, 3)) if sph_center is None else sph_center.detach().cpu().numpy()
        self.n_spheres = c.shape[0]
        self.sph_perm = torch.as_tensor(median_split(c[:, None], SPH_GROUP),
                                        device=tv.device).reshape(-1, SPH_GROUP)

    def refit(self, tri_vertices: Tensor) -> None:
        """Boxes of the groups over the current vertices."""
        tvg = tri_vertices.detach()[self.perm]
        self.lo = tvg.amin(dim=(1, 2))
        self.hi = tvg.amax(dim=(1, 2))


class Reference:
    """Plain Whitted reference. ``cfg`` is a configuration's ``render`` block
    (its ``max_depth`` and ``shadows``; the program's defaults for the rest);
    ``scene`` turns ``rtbench.scene.scene_arrays`` output into the dict of
    tensors that ``trace`` reads (whose tensors may require gradients)."""

    DEFAULTS = dict(max_depth=10, phong_exp=128, shadows=True, shadow_blend=1e-4,
                    legacy_diffuse=True, smallest_dist=1e-4, det_epsilon=1e-7, ray_offset=1e-4,
                    shadow_origin_bias=0.01, beer_sigma=(0.27, 0.45, 0.55))

    def __init__(self, cfg: dict, device, lowp: bool = False):
        self.cfg = {k: cfg.get(k, v) for k, v in self.DEFAULTS.items()}
        self.device = torch.device(device)
        self.lowp = lowp
        self.dtype = torch.float32 if lowp else torch.float64
        self.q = tf32 if lowp else (lambda x: x)

    def tensor(self, x) -> Tensor:
        return torch.as_tensor(np.asarray(x), dtype=self.dtype, device=self.device)

    def scene(self, arrays: dict) -> dict:
        """The scene arrays as tensors of the reference's dtype and device."""
        return {k: ({m: self.tensor(x) for m, x in v.items()} if isinstance(v, dict)
                    else self.tensor(v)) for k, v in arrays.items()}

    # ------------------------------------------------------------------
    # hit selection (no gradient)
    # ------------------------------------------------------------------
    @torch.no_grad()
    def closest(self, s: dict, groups: Groups, ro: Tensor, rd: Tensor, any_mode: bool = False):
        """Per ray: (t, family, index), family 0 none, 1 triangle, 2 sphere;
        with ``any_mode`` only whether anything is hit (bool)."""
        t_tri, i_tri = self._tri_closest(s["tri_vertices"].detach(), groups, ro, rd, any_mode)
        if any_mode:
            occ = i_tri >= 0
            if s["sph_center"].shape[0]:
                occ |= self._sph_closest(s, groups, ro, rd, any_mode)[1] >= 0
            return occ
        fam = torch.where(i_tri >= 0, 1, 0)
        t, idx = t_tri, i_tri.clamp(min=0)
        if s["sph_center"].shape[0]:
            tsb, isb = self._sph_closest(s, groups, ro, rd, any_mode)
            closer = tsb < t
            t = torch.where(closer, tsb, t)
            fam = torch.where(closer, 2, fam)
            idx = torch.where(closer, isb, idx)
        return t, fam, idx

    def _sph_t(self, s, ro, rd):
        """(R, S) nearest valid root per sphere, inf where none: every ray
        against every sphere (the search ``_sph_closest`` blocks)."""
        c, rad = s["sph_center"].detach(), s["sph_radius"].detach()
        return self._sph_roots(ro[:, None] - c[None], rd[:, None], rad[None])

    def _sph_roots(self, cv, rd, rad):
        """The nearest root above ``smallest_dist`` of each (ray, sphere)
        pair, inf where none: ``cv`` is origin - centre, all broadcast."""
        b2 = 2.0 * _dot(cv, rd)
        c2 = _dot(cv, cv) - rad ** 2
        disc = b2 * b2 - 4.0 * c2
        ok = disc >= 0
        sq = torch.sqrt(torch.where(ok, disc, torch.zeros_like(disc)))
        eps = self.cfg["smallest_dist"]
        best = torch.full_like(b2, INF)
        for root in ((-b2 + sq) / 2, (-b2 - sq) / 2):
            best = torch.minimum(best, torch.where(ok & (root > eps), root, INF))
        return best

    def _sph_closest(self, s, groups: Groups, ro, rd, any_mode: bool):
        """Per ray the nearest sphere's (t, index), -1 where none; the
        lowest index among equal t, as ``_sph_t(...).min(1)`` picks."""
        c, rad = s["sph_center"].detach(), s["sph_radius"].detach()
        if groups.n_spheres != c.shape[0]:
            raise ValueError(f"groups of {groups.n_spheres} spheres for a scene of {c.shape[0]}")
        perm = groups.sph_perm
        lo = (c[perm] - rad[perm][..., None]).amin(1)
        hi = (c[perm] + rad[perm][..., None]).amax(1)

        def pair_t(sph, o, d):
            return self._sph_roots(o[:, None] - c[sph], d[:, None], rad[sph])

        return self._search(perm, lo, hi, ro, rd, pair_t, any_mode, SPH_MARGIN[self.dtype])

    def _tri_closest(self, tv: Tensor, groups: Groups, ro: Tensor, rd: Tensor, any_mode: bool):
        q = self.q
        a = q(tv[:, 0])
        e1 = q(tv[:, 0] - tv[:, 1])
        e2 = q(tv[:, 0] - tv[:, 2])
        n = q(_cross(e1, e2))
        eps, det_eps = self.cfg["smallest_dist"], self.cfg["det_epsilon"]

        def pair_t(tri, o, d):
            oq, dq = q(o)[:, None], q(d)[:, None]
            sv = q(a[tri] - oq)
            nt = n[tri]
            det = _dot(nt, dq)
            ok = torch.abs(det) >= det_eps
            det_s = torch.where(ok, det, torch.ones_like(det))
            t = _dot(sv, nt) / det_s
            beta = _dot(q(_cross(sv, e2[tri])), dq) / det_s
            gamma = _dot(q(_cross(e1[tri], sv)), dq) / det_s
            ok &= (beta > 0) & (gamma > 0) & (beta + gamma < 1) & (t > eps)
            return torch.where(ok, t, INF)

        return self._search(groups.perm, groups.lo, groups.hi, ro, rd, pair_t, any_mode)

    def _search(self, perm, lo, hi, ro, rd, pair_t, any_mode: bool, margin: float = 0.0):
        """Per ray (t, index) of the nearest hit among the primitives of the
        groups ``perm`` (G, size) whose boxes (lo, hi) (G, 3) its line enters,
        each box grown by ``margin`` times its distance from the ray's origin;
        index -1 where none, in ``any_mode`` 0 where any. ``pair_t(members,
        o, d)`` gives the (P, size) hit distances (inf: none) of P rays
        against their groups' members. Blocks of at most ``SLAB_ELEMS``
        (ray, group) and ``PAIR_TESTS`` (ray, primitive) tests."""
        r = ro.shape[0]
        best_t = torch.full((r,), INF, dtype=self.dtype, device=self.device)
        best_i = torch.full((r,), -1, dtype=torch.int64, device=self.device)
        if perm.shape[0] == 0 or r == 0:
            return best_t, best_i
        g = lo.shape[0]
        pad = PAD[self.dtype]
        block = max(1, SLAB_ELEMS // g)
        if margin:
            mid, half = (lo + hi) / 2, torch.linalg.vector_norm(hi - lo, dim=-1) / 2
        for r0 in range(0, r, block):
            o, d = ro[r0:r0 + block], rd[r0:r0 + block]
            blo, bhi = lo[None], hi[None]
            if margin:
                m = margin * (torch.linalg.vector_norm(o[:, None] - mid[None], dim=-1)
                              + half[None])[..., None]
                blo, bhi = blo - m, bhi + m
            tn, tf = slab(o[:, None], _inv(d)[:, None], blo, bhi)
            rr, gg = torch.nonzero(tf * (1.0 + pad) + pad >= tn, as_tuple=True)
            ts, idxs, rays = [], [], []
            step = max(1, PAIR_TESTS // perm.shape[1])
            for p0 in range(0, rr.shape[0], step):
                ri, gi = rr[p0:p0 + step], gg[p0:p0 + step]
                members = perm[gi]                                      # (P, size)
                t = pair_t(members, o[ri], d[ri])
                tmin = t.amin(1)
                # the lowest original index among a group's equal minima
                imin = torch.where(t == tmin[:, None], members,
                                   members.new_full((), 1 << 62)).amin(1)
                hit = torch.isfinite(tmin)
                ts.append(tmin[hit])
                idxs.append(imin[hit])
                rays.append(ri[hit] + r0)
            if not ts:
                continue
            tt, ii, ray = torch.cat(ts), torch.cat(idxs), torch.cat(rays)
            if any_mode:
                best_i[ray] = 0
                continue
            best_t.scatter_reduce_(0, ray, tt, "amin")
            tie = tt == best_t[ray]
            pick = torch.full((r,), 1 << 62, dtype=torch.int64, device=self.device)
            pick.scatter_reduce_(0, ray[tie], ii[tie], "amin")
            best_i = torch.where(pick < (1 << 62), pick, best_i)
        return best_t, best_i

    # ------------------------------------------------------------------
    # differentiable hit attributes and shading
    # ------------------------------------------------------------------
    def _attributes(self, s: dict, ro: Tensor, rd: Tensor, fam: Tensor, idx: Tensor):
        """(t, pos, normal, colour, materials) at the selected hits (every
        lane hits: family 1 or 2)."""
        q = self.q
        m_tri = fam == 1
        i_t = torch.where(m_tri, idx, 0)
        tv = s["tri_vertices"][i_t]
        a, b, c = tv.unbind(1)
        e1, e2 = q(a - b), q(a - c)
        n = _cross(e1, e2)
        rdq, sv = q(rd), q(a - ro)
        det = _dot(q(n), rdq)
        det = torch.where(det != 0, det, torch.ones_like(det))
        t = _dot(sv, q(n)) / det
        beta = _dot(q(_cross(sv, e2)), rdq) / det
        gamma = _dot(q(_cross(e1, sv)), rdq) / det
        alpha = 1.0 - beta - gamma
        tc = s["tri_colors"][i_t]
        col = alpha[:, None] * tc[:, 0] + beta[:, None] * tc[:, 1] + gamma[:, None] * tc[:, 2]
        mats = {k: v[i_t] for k, v in s["tri_materials"].items()}
        if s["sph_center"].shape[0]:
            m_s = fam == 2
            i_s = torch.where(m_s, idx, 0)
            ctr, rad = s["sph_center"][i_s], s["sph_radius"][i_s]
            cv = ro - ctr
            b2 = 2.0 * _dot(rd, cv)
            c2 = _dot(cv, cv) - rad * rad
            disc = b2 * b2 - 4.0 * c2
            sq = torch.sqrt(torch.where(disc > 0, disc, torch.ones_like(disc)))
            sq = torch.where(disc > 0, sq, torch.zeros_like(sq))
            r1, r2 = (-b2 + sq) * 0.5, (-b2 - sq) * 0.5
            eps = self.cfg["smallest_dist"]
            ts = torch.where(r2 > eps, r2, r1)          # the selected (nearest valid) root
            t = torch.where(m_s, ts, t)
            n = torch.where(m_s[:, None], ro + ts[:, None] * rd - ctr, n)
            col = torch.where(m_s[:, None], s["sph_color"][i_s], col)
            mats = {k: torch.where(m_s, s["sph_materials"][k][i_s], v) for k, v in mats.items()}
        pos = ro + t[:, None] * rd
        return t, pos, n, col, mats

    def _light(self, s, pos, normal, view, col, kd, ks):
        """Phong diffuse + specular over the lights (Serial/world.cpp:126-137)."""
        n = _normalize(normal)
        out = 0.0
        for lp, li in zip(s["light_position"], s["light_intensity"]):
            l_dir = _normalize(lp[None] - pos)
            r = _normalize(-l_dir - 2.0 * _dot(n, -l_dir)[:, None] * n)
            ddir = _normalize(lp)[None] if self.cfg["legacy_diffuse"] else l_dir
            diffuse = torch.clamp(_dot(n, ddir), min=0.0)
            d = _dot(_normalize(view), r)
            e = self.cfg["phong_exp"]
            spec = torch.abs(d) ** e if e % 2 == 0 else torch.clamp(d, min=0.0) ** e
            out = out + (kd[:, None] * diffuse[:, None] * li[None] * col
                         + ks[:, None] * spec[:, None] * li[None])
        return out

    def trace(self, s: dict, ro: Tensor, rd: Tensor, groups: Groups) -> Tensor:
        """Unclamped colour (P, 3) of primary rays (ro, rd), differentiable in
        the tensors of ``s``."""
        cfg = self.cfg
        p = ro.shape[0]
        color = torch.zeros((p, 3), dtype=self.dtype, device=self.device)
        bg = s["background"]
        pix = torch.arange(p, device=self.device)
        coeff = torch.ones((p, 3), dtype=self.dtype, device=self.device)
        for level in range(cfg["max_depth"] + 2):
            if ro.shape[0] == 0:
                break
            rd = _normalize(rd)
            if level > cfg["max_depth"]:          # past the last level
                color = color.index_add(0, pix, coeff * bg[None])
                break
            _, fam, idx = self.closest(s, groups, ro.detach(), rd.detach())
            hit = fam > 0
            color = color.index_add(0, pix[~hit], coeff[~hit] * bg[None])
            ro, rd, coeff, pix, fam, idx = (x[hit] for x in (ro, rd, coeff, pix, fam, idx))
            t, pos, normal, col, mats = self._attributes(s, ro, rd, fam, idx)
            shadowed = torch.zeros(pos.shape[0], dtype=torch.bool, device=self.device)
            if cfg["shadows"]:
                with torch.no_grad():
                    for lp in s["light_position"].detach():
                        to_light = lp[None] - pos.detach()
                        shadowed |= self.closest(s, groups, pos.detach()
                                                 + cfg["shadow_origin_bias"] * to_light,
                                                 _normalize(to_light), any_mode=True)
            amb = s["ambient"][None] * col * mats["ka"][:, None]
            final = self._light(s, pos, normal, rd, col, mats["kd"], mats["ks"]) + amb
            b = cfg["shadow_blend"]
            final = torch.where(shadowed[:, None], final * b + amb * (1.0 - b), final)
            n = _normalize(normal)
            r_dir = rd - 2.0 * _dot(n, rd)[:, None] * n
            kr, kt, eta = mats["kr"], mats["kt"], mats["eta"]
            diel = (kr > 0) & (kt > 0)
            refl = (kr > 0) & ~diel
            color = color.index_add(0, pix[~diel], coeff[~diel] * final[~diel])
            kids = [(pos[refl] + cfg["ray_offset"] * r_dir[refl], r_dir[refl],
                     coeff[refl] * kr[refl][:, None], pix[refl])]
            if diel.any():
                kids += self._dielectric(pos[diel], rd[diel], n[diel], t[diel], eta[diel],
                                         r_dir[diel], coeff[diel], pix[diel])
            ro, rd, coeff, pix = (torch.cat(x) for x in zip(*kids))
        return color

    def _dielectric(self, pos, i, n, t, eta, r_dir, coeff, pix):
        """The Fresnel split's children (Serial/world.cpp:77-100): reflect
        and refract with Schlick's weight, Beer attenuation on exit, the
        reflection child alone (weight k) on exit-side total internal
        reflection, the refraction child dropped on entering-side TIR."""
        off = self.cfg["ray_offset"]
        entering = _dot(i, n) < 0
        sigma = self.tensor(self.cfg["beer_sigma"])
        k = torch.where(entering[:, None], torch.ones_like(coeff),
                        torch.exp(-sigma[None] * t[:, None]))
        nn = torch.where(entering[:, None], n, -n)
        e = torch.where(entering, eta, 1.0 / eta)
        ndi = _dot(nn, i)
        kk = 1.0 - e * e * (1.0 - ndi * ndi)
        ok = kk >= 0
        tdir = e[:, None] * i - (e * ndi + torch.sqrt(torch.clamp(kk, min=0.0)))[:, None] * nn
        c = torch.where(entering, -_dot(i, n), _dot(tdir, n))
        r0 = (eta - 1.0) ** 2 / (eta + 1.0) ** 2
        fr = r0 + (1.0 - r0) * (1.0 - c) ** 5
        tir_exit = ~entering & ~ok
        w_r = torch.where(tir_exit, torch.ones_like(fr), fr)
        live_t = ok
        return [(pos + off * r_dir, r_dir, coeff * k * w_r[:, None], pix),
                (pos[live_t] + off * tdir[live_t], tdir[live_t],
                 (coeff * k * (1.0 - fr)[:, None])[live_t], pix[live_t])]

    # ------------------------------------------------------------------
    # cameras
    # ------------------------------------------------------------------
    def camera_rays(self, camera: dict, width: int, height: int, pixels: Tensor):
        """Primary rays of the row-major, top-down pixel indices ``pixels``
        of a width x height image (Serial/camera.cpp:33-52; row j counts from
        the bottom)."""
        pos = self.tensor(camera["position"])
        tgt = self.tensor(camera["target"])
        up = _normalize(self.tensor(camera["up"]))
        w = _normalize(pos - tgt)
        u = _normalize(_cross(up, w))
        v = _normalize(_cross(w, u))
        focal = 1.0 / (2.0 * math.tan(math.radians(camera["fovy"]) / 2.0))
        i = (pixels % width).to(self.dtype)
        j = (height - 1 - pixels // width).to(self.dtype)
        xw = (width / height) * (i - width / 2.0 + 0.5) / width
        yw = (j - height / 2.0 + 0.5) / height
        d = -w[None] * focal + u[None] * xw[:, None] + v[None] * yw[:, None]
        return pos.expand(pixels.shape[0], 3), _normalize(d)
