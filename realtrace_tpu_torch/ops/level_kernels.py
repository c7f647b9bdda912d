"""The no-grad forward of a triangle level in two hand-written CUDA kernels.

``csrc/level.cu`` holds both. ``hits_kernel`` computes what
``ops/intersect.py::hit_attributes`` computes for a scene of triangles alone:
the whole ``Hit`` of the level's closest hits. ``shade_kernel`` computes what
``render/shade.py::_shade_level`` computes from those hits: the level's
colour and its children (``_children_geom`` and ``_local_contrib``), or on
the last level the background the children's coefficients take. On the card
both are bit-equal to the PyTorch code, which stays as their twin and as the
path of everything ``takes`` turns away: the autograd path, the CPU, float64,
the other accels, and scenes with spheres, quads or cylinders.

``hit_attributes`` and ``_shade_level`` launch the kernels themselves, so
their names, signatures and spans keep measuring the layer. Each launch runs
in a span of its own, ``rt.p.kernel.hits`` or ``rt.p.kernel.shade``, that
counts ``lanes``, the rows launched; each kernel counts its launches,
``hits_kernel.launches`` and ``shade_kernel.launches``.
"""
from __future__ import annotations

import torch
from torch import Tensor

from realtrace_tpu_torch.core.types import MATERIAL_KEYS, RenderConfig, Scene
from realtrace_tpu_torch.ops import cuda_build
from realtrace_tpu_torch.ops.sweep import _check_all
from realtrace_tpu_torch.utils.profiling import span

MAX_LIGHTS = 8      # csrc/level.cu kMaxLights
HIT_FLOATS = 16     # a lane's floats of hits_kernel: t, position, normal, colour, six materials


def takes(scene: Scene, cfg: RenderConfig, pack, ro: Tensor, *inputs: Tensor) -> bool:
    """Whether a level's hit attributes or shading run through the kernels:
    ``ro`` is a CUDA float32 tensor, no gradient is recorded through ``ro``
    and ``inputs`` (grad mode is off, or none of them requires one), the
    queries are the sweep's (``pack`` given), and the scene has triangles and
    no other family. The kernels check the rest of their inputs and raise on
    what they do not take."""
    return (ro.device.type == "cuda" and ro.dtype == torch.float32
            and cfg.accel == "sweep" and pack is not None
            and scene.n_triangles > 0
            and not (scene.n_spheres or scene.n_planes or scene.n_cylinders)
            and not (torch.is_grad_enabled()
                     and (ro.requires_grad or any(x.requires_grad for x in inputs))))


def _stream(x: Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def hits_kernel(scene: Scene, ro: Tensor, rd: Tensor, fam: Tensor, idx: Tensor, perm: Tensor):
    """``hit_attributes`` of a scene of triangles: ``fam`` and ``idx`` from
    ``closest_query`` (sorted-space indices), ``perm`` the sweep pack's map
    from sorted to original triangles. Returns (valid, t, index, position,
    normal, colour, {material: values}), each a fresh tensor or a view of
    one buffer."""
    n = ro.shape[0]
    f32, i64 = torch.float32, torch.int64
    nt = scene.n_triangles
    mats = [getattr(scene.tri_materials, k) for k in MATERIAL_KEYS]
    _check_all("hits_kernel", ro.device,
               [("ro", ro, f32, (n, 3)), ("rd", rd, f32, (n, 3)), ("fam", fam, i64, (n,)),
                ("idx", idx, i64, (n,)), ("perm", perm, i64, (perm.shape[0],)),
                ("tri_vertices", scene.tri_vertices, f32, (nt, 3, 3)),
                ("tri_colors", scene.tri_colors, f32, (nt, 3, 3))]
               + [(k, x, f32, (nt,)) for k, x in zip(MATERIAL_KEYS, mats)])
    out = torch.empty(HIT_FLOATS * n, dtype=f32, device=ro.device)
    index = torch.empty(n, dtype=i64, device=ro.device)
    valid = torch.empty(n, dtype=torch.bool, device=ro.device)
    with span("rt.p.kernel.hits") as s:
        rc = cuda_build.load().rt_level_hits(
            ro.data_ptr(), rd.data_ptr(), fam.data_ptr(), idx.data_ptr(), perm.data_ptr(),
            perm.shape[0], scene.tri_vertices.data_ptr(), scene.tri_colors.data_ptr(),
            *(x.data_ptr() for x in mats), out.data_ptr(), index.data_ptr(), valid.data_ptr(),
            n, ro.device.index or 0, _stream(ro))
        s.count(lanes=n)
    if rc != 0:
        raise RuntimeError(f"level hits kernel launch failed: {cuda_build.error_string(rc)}")
    if n:
        hits_kernel.launches += 1
    t, position, normal, color, *m = out.split([n, 3 * n, 3 * n, 3 * n] + [n] * len(mats))
    return (valid, t, index, position.view(n, 3), normal.view(n, 3), color.view(n, 3),
            dict(zip(MATERIAL_KEYS, m)))


hits_kernel.launches = 0


def shade_kernel(scene: Scene, ro: Tensor, rd: Tensor, coeff: Tensor, hit, occ: Tensor | None,
                 cfg: RenderConfig, branching: bool, level: int):
    """``_shade_level`` given the level's ``hit``: (colour (R, 3), children).
    The children are (ro, rd, coeff), each (C, 3) with C = 2R where the level
    branches (the reflect block, then the refract block), else R; on the last
    level (``cfg.max_depth``) the (C, 3) background their coefficients take."""
    n = ro.shape[0]
    f32 = torch.float32
    lights = scene.lights
    nl = lights.position.shape[0]
    checked = [("ro", ro, f32, (n, 3)), ("rd", rd, f32, (n, 3)), ("coeff", coeff, f32, (n, 3)),
               ("hit.valid", hit.valid, torch.bool, (n,)), ("hit.t", hit.t, f32, (n,)),
               ("hit.position", hit.position, f32, (n, 3)),
               ("hit.normal", hit.normal, f32, (n, 3)), ("hit.color", hit.color, f32, (n, 3)),
               ("lights.position", lights.position, f32, (nl, 3)),
               ("lights.intensity", lights.intensity, f32, (nl, 3)),
               ("ambient", scene.ambient, f32, (3,)), ("background", scene.background, f32, (3,))]
    checked += [(f"hit.{k}", getattr(hit, k), f32, (n,)) for k in MATERIAL_KEYS]
    if occ is not None:
        checked.append(("occ", occ, torch.bool, (n,)))
    _check_all("shade_kernel", ro.device, checked)
    if nl > MAX_LIGHTS:
        raise ValueError(f"shade_kernel: {nl} lights, the kernel takes at most {MAX_LIGHTS}")
    if cfg.phong_exp < 0:
        raise ValueError(f"shade_kernel: phong_exp {cfg.phong_exp}, the kernel takes >= 0")
    if len(cfg.beer_sigma) != 3:
        raise ValueError(f"shade_kernel: beer_sigma has {len(cfg.beer_sigma)} channels, want 3")
    last = level == cfg.max_depth
    c = 2 * n if branching else n
    contrib = torch.empty((n, 3), dtype=f32, device=ro.device)
    child = torch.empty((c, 3) if last else (3, c, 3), dtype=f32, device=ro.device)
    b = cfg.shadow_blend
    with span("rt.p.kernel.shade") as s:
        rc = cuda_build.load().rt_level_shade(
            ro.data_ptr(), rd.data_ptr(), coeff.data_ptr(), hit.valid.data_ptr(),
            hit.t.data_ptr(), hit.position.data_ptr(), hit.normal.data_ptr(),
            hit.color.data_ptr(), *(getattr(hit, k).data_ptr() for k in MATERIAL_KEYS),
            None if occ is None else occ.data_ptr(), lights.position.data_ptr(),
            lights.intensity.data_ptr(), nl, scene.ambient.data_ptr(),
            scene.background.data_ptr(), int(cfg.phong_exp), int(cfg.legacy_diffuse), b,
            1.0 - b, cfg.ray_offset, *(-sigma for sigma in cfg.beer_sigma), int(branching),
            int(level > 0), int(last), contrib.data_ptr(), child.data_ptr(), n,
            ro.device.index or 0, _stream(ro))
        s.count(lanes=n)
    if rc != 0:
        raise RuntimeError(f"level shade kernel launch failed: {cuda_build.error_string(rc)}")
    if n:
        shade_kernel.launches += 1
    return contrib, (child if last else tuple(child.unbind(0)))


shade_kernel.launches = 0
