"""Wavefront Whitted shading, with the dielectric branching wavefront.

Counterpart of ``trace_wavefront`` of ``realtrace_tpu/render/shade.py``: the
reference's recursive ``World::shade_ray`` (Serial/world.cpp:32-111)
flattened into one loop over bounce levels, each level one dense batch of
rays. Between levels the wavefront shrinks, as level 0's does to its hits,
to the 1024-lane tiles that still hold a live lane (dynamic compaction with
``nonzero``; exact, since dropped lanes carry zero coefficients), and each
level's colour is ``index_add``-ed back per tile (``_live_tiles``,
``_gather_tiles``, ``_take_tiles``, ``_add_tiles``). In a scene with
dielectrics (kr > 0 and kt > 0) a hit spawns a reflection AND a refraction
child: each level's candidate children are the reflect block followed by the
refract block, and the wavefront is repacked by lane instead (``_live_lanes``,
``_gather_lanes``, ``_take``, ``_add_lanes``: the same four calls, the layout
chosen once): the children that carry energy, in that order and each block in
lane order, packed into dense tiles whose last is padded with parked lanes.
Each lane carries its pixel, and a level's colour reaches its pixels in
wavefront order. So the lanes held are the live lanes rounded up to a tile,
however often a pixel repeats. Because the compaction is dynamic, no child is
ever dropped for capacity.

Discrete decisions (hit selection, shadowing) run without gradient inside
``closest_query`` / ``any_hit``; everything else is differentiable. With
``cfg.remat`` and a scene that needs gradients, the differentiable part of
each level (hit attributes, child geometry, colour) runs under
``torch.utils.checkpoint``: the backward recomputes it from the level's rays
and its query results, the only tensors kept. The queries and the compaction
stay outside, so the backward launches no sweep and syncs no host. Where
no gradient is recorded through a scene of triangles alone on the card, a
level's hit attributes and its shading each run as one hand-written kernel
(``ops/level_kernels.py``), bit-equal to the PyTorch code here.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import Tensor
from torch.utils.checkpoint import checkpoint

from realtrace_tpu_torch.core import vec
from realtrace_tpu_torch.core.types import (BIG, MATERIAL_KEYS, PARK_DISTANCE, WAVEFRONT_TILE,
                                            RenderConfig, Scene, tensor_leaves)
from realtrace_tpu_torch.ops import level_kernels, sweep
from realtrace_tpu_torch.ops.intersect import (FAM_NONE, Hit, any_hit, closest_query,
                                               hit_attributes)
from realtrace_tpu_torch.utils.profiling import span, spanned


def phong_pow(d: Tensor, e: int) -> Tensor:
    """max(pow(d, e), 0) with C ``pow`` semantics for negative bases: even
    exponent → |d|^e, odd → clamped at 0. Ref: Serial/world.cpp:134."""
    if e % 2 == 0:
        return torch.abs(d) ** e
    return torch.clamp(d, min=0.0) ** e


def light_shade(position: Tensor, normal: Tensor, view: Tensor, color: Tensor,
                kd: Tensor, ks: Tensor, scene: Scene, cfg: RenderConfig) -> Tensor:
    """Phong diffuse + specular summed over all lights.

    Ref: World::get_light_shade, Serial/world.cpp:126-137. ``legacy_diffuse``
    keeps the reference quirk of lighting by ``normalize(lightPosition)``.
    """
    n = vec.normalize(normal)
    lp = scene.lights.position
    li = scene.lights.intensity
    l_dir = vec.normalize(lp[None, :, :] - position[:, None, :])      # (R, L, 3)
    refl = vec.normalize(vec.reflect(-l_dir, n[:, None, :]))
    diff_dir = vec.normalize(lp)[None, :, :] if cfg.legacy_diffuse else l_dir
    diffuse = torch.clamp(vec.dot(n[:, None, :], diff_dir), min=0.0)   # (R, L)
    spec = phong_pow(vec.dot(vec.normalize(view)[:, None, :], refl), cfg.phong_exp)
    out = (kd[:, None, None] * diffuse[..., None] * li[None] * color[:, None, :]
           + ks[:, None, None] * spec[..., None] * li[None])
    return torch.sum(out, dim=1)


def _park_dead(ro: Tensor, rd: Tensor, live: Tensor) -> tuple[Tensor, Tensor]:
    """Replace dead lanes' rays by a guaranteed-miss ray far outside the
    scene, pointing away, which the sweep's chunk masks give no work."""
    park_d = torch.zeros_like(rd)
    park_d[..., 0] = 1.0
    return (torch.where(live[:, None], ro, torch.full_like(ro, PARK_DISTANCE)),
            torch.where(live[:, None], rd, park_d))


def _shadow_targets(scene: Scene, hit_pos: Tensor, live: Tensor, cfg: RenderConfig):
    """Per-light shadow ray (origin, direction), parked on dead lanes.
    Ref: Serial/world.cpp:42-51 (origin offset along the unnormalized
    to-light vector)."""
    out = []
    for l in range(scene.n_lights):
        to_light = scene.lights.position[l][None, :] - hit_pos
        out.append(_park_dead(hit_pos + cfg.shadow_origin_bias * to_light,
                              vec.normalize(to_light), live))
    return out


def local_color(scene: Scene, hit: Hit, rd: Tensor, cfg: RenderConfig,
                shadowed: Tensor | None) -> Tensor:
    """Direct shade at a hit: Phong + ambient, with the reference's shadow
    blend ``final*1e-4 + shadowColor*(1-1e-4)`` where ``shadowed``.
    Ref: Serial/world.cpp:40-63."""
    lc = light_shade(hit.position, hit.normal, rd, hit.color, hit.kd, hit.ks, scene, cfg)
    amb = scene.ambient[None, :] * hit.color * hit.ka[:, None]
    lc = lc + amb
    if shadowed is not None:
        b = cfg.shadow_blend
        lc = torch.where(shadowed[:, None], lc * b + amb * (1.0 - b), lc)
    return lc


def _children_geom(scene: Scene, hit: Hit, ro: Tensor, rd: Tensor, coeff: Tensor,
                   cfg: RenderConfig, branching: bool = True):
    """Child-ray geometry of one wavefront step (no shading, no queries):
    (valid, is_diel, (ro_r, rd_r, coeff_r), (ro_t, rd_t, coeff_t)), following
    the branches of Serial/world.cpp:77-109 (``branching=False``, for scenes
    without dielectrics, skips the refraction child and returns None for it):

    * dielectric (kr > 0 and kt > 0): Fresnel-Schlick split, Beer attenuation
      on exit; exit-side total internal reflection gives the reflection child
      weight 1; on entering-side total internal reflection the refraction
      child is killed (the reference would emit a zero-direction ray there);
    * reflective (kr > 0): kr-weighted reflection child;
    * plain: no children.
    """
    valid = hit.valid & torch.any(coeff > 0.0, dim=-1)
    i = vec.normalize(rd)
    n = vec.normalize(hit.normal)
    is_diel = valid & (hit.kr > 0.0) & (hit.kt > 0.0)
    is_refl = valid & (hit.kr > 0.0) & ~is_diel

    # reflection child (shared by the dielectric and the reflective branch)
    r_dir = vec.reflect(i, n)
    ro_r = hit.position + cfg.ray_offset * r_dir
    rd_r = vec.normalize(r_dir)
    zero = torch.zeros_like(hit.kr)
    if not branching:
        coeff_r = coeff * torch.where(is_refl, hit.kr, zero)[:, None]
        ro_r, rd_r = _park_dead(ro_r, rd_r, torch.any(coeff_r.detach() > 0.0, dim=-1))
        return valid, is_diel, (ro_r, rd_r, coeff_r), None

    # dielectric physics (Serial/world.cpp:77-100)
    eta = hit.eta
    entering = vec.dot(rd, n) < 0.0
    t_in, ok_in = vec.refract(i, n, eta)
    c_in = -vec.dot(i, n)
    t_out, ok_out = vec.refract(i, -n, 1.0 / torch.where(eta != 0, eta, torch.ones_like(eta)))
    c_out = vec.dot(t_out, n)
    # Beer-style exit attenuation, k = e^{-sigma * t} (Serial/world.cpp:85), a
    # channel at a time from Python scalars: no host copy to wait for
    k_exit = torch.stack([torch.exp(-s * hit.t) for s in cfg.beer_sigma], dim=-1)
    k = torch.where(entering[:, None], torch.ones_like(coeff), k_exit)
    tir_exit = ~entering & ~ok_out
    c = torch.where(entering, c_in, c_out)
    r0 = ((eta - 1.0) ** 2) / torch.clamp((eta + 1.0) ** 2, min=1e-30)
    fres = r0 + (1.0 - r0) * (1.0 - c) ** 5
    t_dir = torch.where(entering[:, None], t_in, t_out)
    t_ok = torch.where(entering, ok_in, ok_out)
    ro_t = hit.position + cfg.ray_offset * t_dir
    rd_t = vec.normalize(t_dir)

    w_reflect = torch.where(is_diel, torch.where(tir_exit, torch.ones_like(fres), fres),
                            torch.where(is_refl, hit.kr, zero))
    coeff_r = coeff * w_reflect[:, None] * torch.where(is_diel[:, None], k, torch.ones_like(k))
    coeff_t = coeff * torch.where((is_diel & t_ok & ~tir_exit)[:, None],
                                  k * (1.0 - fres[:, None]), torch.zeros_like(k))
    # park rays whose continuation carries no energy
    ro_r, rd_r = _park_dead(ro_r, rd_r, torch.any(coeff_r.detach() > 0.0, dim=-1))
    ro_t, rd_t = _park_dead(ro_t, rd_t, torch.any(coeff_t.detach() > 0.0, dim=-1))
    return valid, is_diel, (ro_r, rd_r, coeff_r), (ro_t, rd_t, coeff_t)


def _local_contrib(scene: Scene, hit: Hit, rd: Tensor, coeff: Tensor, valid: Tensor,
                   is_diel: Tensor, cfg: RenderConfig, miss_background: bool,
                   shadowed: Tensor | None) -> Tensor:
    """This level's colour: Phong shade on valid non-dielectric lanes (a
    dielectric returns its children only, Serial/world.cpp:100), plus the
    background on active misses when ``miss_background``."""
    lc = local_color(scene, hit, rd, cfg, shadowed)
    zero = torch.zeros_like(coeff)
    contrib = torch.where((valid & ~is_diel)[:, None], coeff * lc, zero)
    if miss_background:
        active = torch.any(coeff > 0.0, dim=-1)
        contrib = contrib + torch.where((active & ~hit.valid)[:, None],
                                        coeff * scene.background[None], zero)
    return contrib


def _shadow_occlusion(scene: Scene, position: Tensor, valid: Tensor, cfg: RenderConfig,
                      pack=None, exact_mask=None, per_light: bool = False) -> Tensor | None:
    """One any-mode query covering every light's shadow rays from the hit
    positions, folded to a per-lane any-light-occluded mask; None when
    shadows are off. A shadow hit beyond the light still shadows
    (Serial/world.cpp:42-51). ``per_light``: one any-mode query per light
    instead, each with its width's mask policy (the JAX package's
    ``shadow_mask``, which ``merge_queries=False`` runs)."""
    nl = scene.n_lights if cfg.shadows else 0
    if nl == 0:
        return None
    sh = _shadow_targets(scene, position.detach(), valid, cfg)
    if per_light:
        occ = torch.zeros_like(valid)
        for o, d in sh:
            occ |= any_hit(scene, o, d, cfg, pack=pack)
        return occ
    occ_all = any_hit(scene, torch.cat([o for o, _ in sh]), torch.cat([d for _, d in sh]),
                      cfg, pack=pack, exact_mask=exact_mask)
    return occ_all.reshape(nl, -1).any(dim=0)


@spanned("rt.p.compaction")
def _live_tiles(live: Tensor) -> Tensor:
    """Indices of the tiles of a wavefront that hold a lane of ``live``."""
    live = live.reshape(-1, WAVEFRONT_TILE).any(dim=1)
    with span("rt.p.sync.live_tiles"):
        return torch.nonzero(live)[:, 0]


@spanned("rt.p.compaction")
def _take_tiles(x: Tensor, sel: Tensor, fill=None) -> Tensor:
    """The tiles ``sel`` of a wavefront array, concatenated (whole tiles:
    nothing to ``fill``)."""
    return x.reshape(-1, WAVEFRONT_TILE, *x.shape[1:])[sel].reshape(-1, *x.shape[1:])


def _gather_tiles(sel: Tensor, ro: Tensor, rd: Tensor, coeff: Tensor,
                  tiles: Tensor | None = None):
    """The tiles ``sel`` of a wavefront: (ro, rd, coeff, the pixel tile of
    each, ``tiles[sel]``, or ``sel`` where ``tiles`` is None: each tile its
    own)."""
    return (*(_take_tiles(x, sel) for x in (ro, rd, coeff)),
            sel if tiles is None else tiles[sel])


@spanned("rt.p.compaction")
def _add_tiles(accum: Tensor, tiles: Tensor, x: Tensor) -> Tensor:
    """accum[tiles] += x, a tile at a time, for the unique pixel tiles
    ``tiles`` of a wavefront that does not branch: ``accum`` (P, 3), ``x``
    (R, 3), both whole tiles."""
    t = WAVEFRONT_TILE
    return accum.reshape(-1, t, 3).index_add(0, tiles, x.reshape(-1, t, 3)).reshape(-1, 3)


def _pad_parked(ro: Tensor, rd: Tensor, coeff: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """A wavefront padded up to whole tiles with parked, zero-coefficient lanes."""
    pad = (-ro.shape[0]) % WAVEFRONT_TILE
    if not pad:
        return ro, rd, coeff
    park_d = rd.new_zeros((pad, 3))     # filled on the device: no host copy to wait for
    park_d[:, 0] = 1.0
    return (torch.cat([ro, ro.new_full((pad, 3), PARK_DISTANCE)]), torch.cat([rd, park_d]),
            torch.cat([coeff, coeff.new_zeros((pad, 3))]))


@spanned("rt.p.compaction")
def _take(x: Tensor, sel: Tensor, fill) -> Tensor:
    """``x[sel]`` padded up to whole tiles with rows of ``fill``."""
    with span("rt.p.repack"):
        pad = (-sel.numel()) % WAVEFRONT_TILE
        out = x[sel]
        return torch.cat([out, out.new_full((pad, *x.shape[1:]), fill)]) if pad else out


@spanned("rt.p.compaction")
def _live_lanes(live: Tensor) -> Tensor:
    """Indices of the lanes ``live`` of a wavefront, in lane order."""
    with span("rt.p.repack"), span("rt.p.sync.live_lanes"):
        return torch.nonzero(live)[:, 0]


def _gather_lanes(sel: Tensor, ro: Tensor, rd: Tensor, coeff: Tensor,
                  pix: Tensor | None = None):
    """The lanes ``sel`` of a wavefront, padded up to whole tiles with parked
    lanes: (ro, rd, coeff, pix or None). A pad lane's pixel is -1, no pixel."""
    with span("rt.p.compaction"), span("rt.p.repack"):
        ro, rd, coeff = _pad_parked(ro[sel], rd[sel], coeff[sel])
    return ro, rd, coeff, None if pix is None else _take(pix, sel, -1)


@spanned("rt.p.compaction")
def _add_lanes(accum: Tensor, pix: Tensor, x: Tensor) -> Tensor:
    """accum[pix] += x, deterministically, with no loop over a pixel's
    repeats: the lanes are stably sorted by pixel, each pixel's summands
    added up one after the other in wavefront order (a segment sum), and
    the sums added to ``accum`` (P, 3). A lane of pixel -1 (padding) adds
    nothing. A pixel that appears once gets ``accum + x`` exactly."""
    with span("rt.p.repack"):
        order = torch.sort(pix, stable=True)
        bounds = torch.searchsorted(order.values,
                                    torch.arange(accum.shape[0] + 1, device=pix.device))
        return accum + torch.segment_reduce(x[order.indices], "sum", offsets=bounds, axis=0,
                                            unsafe=True)


def _merged_query(scene: Scene, hit: Hit, ro: Tensor, rd: Tensor, coeff: Tensor,
                  valid: Tensor, cfg: RenderConfig, pack, branching: bool, last: bool,
                  exact_mask, live, gather):
    """The fully merged query of one level (``shadow_any_mode`` off): ONE
    closest query over every light's shadow segment followed by the next
    level's child rays, compacted by the wavefront's ``live`` and
    ``gather``; occluded where a shadow ray hits anything (``fam !=
    FAM_NONE``). The child rays come from a no-grad pass of
    ``_children_geom``, bit-equal to the shading's own; the last level's
    children are not queried. Returns (occlusion, the kept children or
    None, their (t, fam, idx) or None)."""
    nl = scene.n_lights
    sh = _shadow_targets(scene, hit.position.detach(), valid, cfg)
    ros, rds = [o for o, _ in sh], [d for _, d in sh]
    keep = None
    if not last:
        with torch.no_grad():
            _, _, child, child_t = _children_geom(scene, hit, ro, rd, coeff, cfg, branching)
            if branching:
                child = tuple(torch.cat([a, b]) for a, b in zip(child, child_t))
        keep = live(torch.any(child[2] > 0.0, dim=-1))
        ro_c, rd_c, _, _ = gather(keep, *child, None)
        ros.append(ro_c)
        rds.append(rd_c)
    t, fam, idx = closest_query(scene, torch.cat(ros), torch.cat(rds), cfg, pack=pack,
                                exact_mask=exact_mask)
    r = ro.shape[0]
    occ = (fam[:nl * r] != FAM_NONE).reshape(nl, r).any(dim=0)
    s = nl * r
    return occ, keep, (None if last else (t[s:], fam[s:], idx[s:]))


@spanned("rt.p.shade")
def _shade_level(scene: Scene, ro: Tensor, rd: Tensor, coeff: Tensor, t: Tensor, fam: Tensor,
                 idx: Tensor, occ: Tensor | None, cfg: RenderConfig, pack, branching: bool,
                 level: int, hit: Hit | None = None):
    """The differentiable part of one wavefront level, from its rays and its
    query results (``t``, ``fam``, ``idx``, the occlusion mask ``occ``):
    hit attributes (unless ``hit`` is given), child geometry and the
    level's colour. Returns (colour, children): the children as one
    (ro, rd, coeff) block, the reflect block before the refract block when
    ``branching``; on the last level (``cfg.max_depth``), in place of the
    children, the background their coefficients take. Given ``hit``, where
    no gradient is recorded through a scene of triangles alone on the card
    (``level_kernels.takes``), one kernel computes the same."""
    if hit is not None and level_kernels.takes(
            scene, cfg, pack, ro, rd, coeff, hit.t, hit.position, hit.normal, hit.color,
            *(getattr(hit, k) for k in MATERIAL_KEYS), scene.lights.position,
            scene.lights.intensity, scene.ambient, scene.background):
        return level_kernels.shade_kernel(scene, ro, rd, coeff, hit, occ, cfg, branching, level)
    if hit is None:
        hit = hit_attributes(scene, ro, rd, t, fam, idx, cfg, pack=pack)
    valid, is_diel, child, child_t = _children_geom(scene, hit, ro, rd, coeff, cfg, branching)
    contrib = _local_contrib(scene, hit, rd, coeff, valid, is_diel, cfg,
                             miss_background=level > 0, shadowed=occ)
    if branching:
        child = tuple(torch.cat([a, b]) for a, b in zip(child, child_t))
    if level == cfg.max_depth:   # depth-exceeded live children take the background
        return contrib, child[2] * scene.background[None]
    return contrib, child


def _needs_grad(scene: Scene) -> bool:
    """Whether autograd records this render: grad mode is on and a scene
    tensor requires a gradient."""
    return torch.is_grad_enabled() and any(
        isinstance(x, Tensor) and x.requires_grad
        for f in dataclasses.fields(scene) for x in tensor_leaves(getattr(scene, f.name)))


def trace_wavefront(scene: Scene, ro: Tensor, rd: Tensor, cfg: RenderConfig,
                    coeff: Tensor | None = None) -> tuple[Tensor, int]:
    """Trace a wavefront of rays to completion: (accumulated colour (R, 3),
    traced-ray count: primary, reflection, refraction and shadow rays
    actually cast).

    Level 0 queries every ray; misses take the background at full width,
    and the wavefront is compacted to its hits as a level's children are
    to those that carry energy, by the layout of the module doc. In a scene
    without dielectrics every later step runs only on the tiles that still
    hold a live lane: children spawn in their parent's lane, so tiles never
    mix pixels, and a child tile inherits its parent's pixel tile. In a scene
    with dielectrics the candidate children of a level are its reflect lanes
    followed by its refract lanes, and the next level holds those that carry
    energy, repacked into dense tiles, each lane with its pixel (see the
    module doc). The last level's children take the background unqueried.
    The queries of a level, on its wavefront, follow the JAX package's
    modes:

    * default: one any-mode query covering every light's shadow rays, then
      one closest query of the next level's children;
    * ``shadow_any_mode`` off: one closest query over the shadow rays and
      the children together (``_merged_query``);
    * ``merge_queries`` off, in a scene without dielectrics: one any-mode
      query per light, then the children's closest query, each with its
      width's mask policy.

    Every mode renders the same image, from the same rays.

    With ``cfg.remat`` (when gradients are recorded) each level's shading is
    a checkpointed region (``_shade_level``) whose inputs are the level's
    rays and query results; the shadow and merged queries read the hits from
    a no-grad pass of ``hit_attributes``, bit-equal to the region's own.
    """
    branching = scene.has_dielectrics()
    remat = cfg.remat and _needs_grad(scene)
    r = ro.shape[0]
    if coeff is None:
        coeff = torch.ones_like(ro)
    ro, rd, coeff = _pad_parked(ro, rd, coeff)
    nl = scene.n_lights if cfg.shadows else 0
    # the level's queries: unmerged (per light, JAX's ``shadow_mask`` and
    # ``closest_hit``, which pass no mask argument), fully merged, or default
    per_light = not (cfg.merge_queries or branching)
    merged = nl > 0 and not cfg.shadow_any_mode and not per_light
    em = True if cfg.exact_mask_secondary and not per_light else None
    pack = None
    if cfg.accel == "sweep" and scene.n_triangles:
        pack = sweep.build_pack(scene, cfg)
    # the wavefront's layout (module doc), chosen once: whole tiles, each
    # mapped to its pixel tile (None: to itself), or repacked lanes, each
    # mapped to its pixel
    live, gather, take, add, pmap = (
        (_live_lanes, _gather_lanes, _take, _add_lanes, torch.arange(len(ro), device=ro.device))
        if branching else (_live_tiles, _gather_tiles, _take_tiles, _add_tiles, None))

    nrays = 0
    for level in range(cfg.max_depth + 1):
        # the level's span holds its shading, its shadow query and its
        # children's query; level 0's also the primary query
        with span(f"rt.p.level.{level}") as level_span:
            if not level:
                t, fam, idx = closest_query(scene, ro, rd, cfg, pack=pack)
                active = torch.any(coeff > 0.0, dim=-1)
                valid0 = (fam != FAM_NONE) & active
                with span("rt.p.sync.ray_count"):
                    rays = int(active.sum()) + nl * int(valid0.sum())
                zero = torch.zeros_like(coeff)
                accum = torch.where((active & (fam == FAM_NONE))[:, None],
                                    coeff * scene.background[None], zero)
                # the wavefront compacted to its hits, as a level's to its children
                keep = live(valid0)
                n = keep.numel()
                ro_s, rd_s, coeff_s, pmap = gather(keep, ro, rd, coeff, pmap)
                t, fam, idx = take(t, keep, BIG), take(fam, keep, FAM_NONE), take(idx, keep, 0)
            last = level == cfg.max_depth
            act = torch.any(coeff_s.detach() > 0.0, dim=-1)
            valid = act & (fam != FAM_NONE)
            if level:
                with span("rt.p.sync.ray_count"):
                    # lanes: a repacked level's live lanes are its first ``n``
                    n_live = n if branching else int(act.sum())
                    rays = n_live + nl * int(valid.sum())
            else:   # a tile level's live lanes are counted when the log is read
                n_live = n if branching else act
            nrays += rays
            held = ro_s.shape[0]
            level_span.count(rays=rays, tiles=held // WAVEFRONT_TILE, live=n_live, lanes=held)
            args = (scene, ro_s, rd_s, coeff_s, t, fam, idx)
            hit = None
            if not remat:
                hit = hit_attributes(scene, ro_s, rd_s, t, fam, idx, cfg, pack=pack)
            keep = nxt = occ = None
            if nl:
                if remat:
                    with torch.no_grad():
                        hit_q = hit_attributes(scene, ro_s, rd_s, t, fam, idx, cfg, pack=pack)
                else:
                    hit_q = hit
                if merged:
                    occ, keep, nxt = _merged_query(scene, hit_q, ro_s, rd_s, coeff_s, valid,
                                                   cfg, pack, branching, last, em, live, gather)
                else:
                    occ = _shadow_occlusion(scene, hit_q.position, valid, cfg, pack=pack,
                                            exact_mask=em, per_light=per_light)
            if remat:
                contrib, child = checkpoint(_shade_level, *args, occ, cfg, pack, branching,
                                            level, use_reentrant=False,
                                            preserve_rng_state=False)
            else:
                contrib, child = _shade_level(*args, occ, cfg, pack, branching, level, hit=hit)
            accum = add(accum, pmap, contrib)
            if branching:   # lanes: the children's pixels, reflect block then refract block
                pmap = torch.cat([pmap, pmap])
            if last:   # ``child`` is the children's background
                accum = add(accum, pmap, child)
                break
            if keep is None:
                keep = live(torch.any(child[2].detach() > 0.0, dim=-1))
            n = keep.numel()
            if branching and not n:   # lanes: no child carries energy, nothing more to trace
                break
            ro_s, rd_s, coeff_s, pmap = gather(keep, *child, pmap)
            if nxt is None:
                nxt = closest_query(scene, ro_s, rd_s, cfg, pack=pack, exact_mask=em)
            t, fam, idx = nxt
    return accum[:r], nrays
