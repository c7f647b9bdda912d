"""The level kernels (``ops/level_kernels.py``, ``csrc/level.cu``): when they
run, and on the card their results against the PyTorch code they replace.

On the CPU: the dispatch rule, and renders that never reach the kernels. On
the card (each case skips without one): the hits kernel against the PyTorch
``hit_attributes`` and the shading kernel against ``_shade_level``'s PyTorch
body, bit for bit, and whole depth-10 frames through the kernels against the
same frames through the PyTorch code, one launch of each kernel a level. This
file imports neither the JAX package nor flax:

    python -m pytest tests/test_torch_level_kernels.py -q
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from realtrace_tpu_torch.apps import scenes
from realtrace_tpu_torch.core.types import MATERIAL_KEYS, RenderConfig, SceneBuilder
from realtrace_tpu_torch.ops import accel, level_kernels, sweep
from realtrace_tpu_torch.ops.intersect import closest_query, hit_attributes
from realtrace_tpu_torch.render import shade
from realtrace_tpu_torch.render.pipeline import render_with_stats
from test_torch_cuda import DEPTH10, cuda, fan_rays, glass_model, wide_fan_rays  # noqa: F401

SWEEP = RenderConfig(accel="sweep", max_depth=10)


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# -- when the kernels run ----------------------------------------------------

def stand_in(device="cuda", dtype=torch.float32, requires_grad=False):
    """What ``takes`` reads of a tensor: a CUDA tensor needs no card here."""
    return types.SimpleNamespace(device=torch.device(device), dtype=dtype,
                                 requires_grad=requires_grad)


FAMILIES = dict(triangles=(4, 0, 0, 0), spheres=(4, 1, 0, 0), quads=(4, 0, 1, 0),
                cylinders=(4, 0, 0, 1), none=(0, 0, 0, 0), sphere_alone=(0, 1, 0, 0))
KERNEL_CASE = dict(device="cuda", dtype=torch.float32, grad="off", families="triangles",
                   accel="sweep", pack=True)


@pytest.mark.parametrize("change", [
    {}, {"grad": "on, nothing requires it"},
    {"device": "cpu"}, {"device": "meta"}, {"dtype": torch.float64}, {"dtype": torch.float16},
    {"grad": "on, the scene requires it"}, {"grad": "on, the rays require it"},
    {"families": "spheres"}, {"families": "quads"}, {"families": "cylinders"},
    {"families": "none"}, {"families": "sphere_alone"},
    {"accel": "bruteforce"}, {"accel": "chunked"}, {"pack": False},
], ids=lambda c: ",".join(f"{k}={v}" for k, v in c.items()) or "kernel-path")
def test_the_kernels_run_on_cuda_float32_triangles_with_no_gradient_recorded(change):
    case = dict(KERNEL_CASE, **change)
    nt, ns, npl, nc = FAMILIES[case["families"]]
    scene = types.SimpleNamespace(n_triangles=nt, n_spheres=ns, n_planes=npl, n_cylinders=nc)
    ro = stand_in(case["device"], case["dtype"], case["grad"] == "on, the rays require it")
    verts = stand_in(case["device"], case["dtype"], case["grad"] == "on, the scene requires it")
    cfg = RenderConfig(accel=case["accel"])
    pack = object() if case["pack"] else None
    with torch.set_grad_enabled(case["grad"] != "off"):
        got = level_kernels.takes(scene, cfg, pack, ro, stand_in(), verts)
    assert got == (case == KERNEL_CASE or change == {"grad": "on, nothing requires it"})


def test_grad_mode_off_takes_the_kernels_even_where_inputs_require_grad():
    """The remat pass's hits for the shadow query run under no_grad."""
    scene = types.SimpleNamespace(n_triangles=4, n_spheres=0, n_planes=0, n_cylinders=0)
    with torch.no_grad():
        assert level_kernels.takes(scene, SWEEP, object(), stand_in(requires_grad=True),
                                   stand_in(requires_grad=True))


@pytest.mark.parametrize("make", ["mesh", "glass"])
def test_a_render_on_the_cpu_never_reaches_the_kernels(monkeypatch, make):
    def refuse(*a, **k):
        raise AssertionError("a level kernel was launched for CPU tensors")

    monkeypatch.setattr(level_kernels, "hits_kernel", refuse)
    monkeypatch.setattr(level_kernels, "shade_kernel", refuse)
    fn = scenes.mesh_scene if make == "mesh" else scenes.glass_mesh_scene
    scene, cam = fn(detail=0.2, device="cpu")
    cfg = dataclasses.replace(SWEEP, max_depth=3)
    scene = accel.with_chunks(scene, cfg)
    img, n = render_with_stats(scene, scenes.make_camera(cam, 32, 32, device="cpu"), cfg)
    assert n > 32 * 32 and bool(torch.isfinite(img).all())


# -- on the card ---------------------------------------------------------------

GLASS = dict(ka=0.4, kd=0.9, ks=0.4, kr=0.1, kt=0.8, eta=2.0)
MIRROR = dict(ka=0.2, kd=0.9, ks=0.4, kr=0.4, kt=0.0, eta=3.0)
PLAIN = dict(ka=0.2, kd=1.0, ks=0.4, kr=0.0, kt=0.0, eta=128.0)


def soup_scene(device, n=300, seed=3, lights=1, chunk_size=32):
    """A random triangle soup of glass, mirror and plain triangles with vertex
    colours, lit by ``lights`` lights, with its sweep pack."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder(device=device)
    for k, ctr in enumerate(rng.uniform(-10, 10, (n, 3))):
        tri = ctr + rng.uniform(-3, 3, (3, 3))
        mat = (GLASS, MIRROR, PLAIN)[k % 3]
        b.add_triangle(tri[0], tri[1], tri[2], vertex_colors=rng.uniform(0, 1, (3, 3)),
                       material=b.material(**mat))
    for pos, inten in [((0, 30, 30), (0.5, 1, 1)), ((-20, 5, 25), (0.7, 0.3, 0.2))][:lights]:
        b.add_light(pos, inten)
    cfg = dataclasses.replace(SWEEP, chunk_size=chunk_size)
    scene = accel.with_chunks(b.build(), cfg)
    return scene, sweep.build_pack(scene, cfg), cfg


def pytorch_path(monkeypatch):
    monkeypatch.setattr(level_kernels, "takes", lambda *a, **k: False)


def same_bits(a, b) -> bool:
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def gap(a, b) -> str:
    """Where two float32 arrays of one shape differ: how many elements, and
    by how many units in the last place at most."""
    ia, ib = a.view(torch.int32).long(), b.view(torch.int32).long()
    off = ia != ib
    ulps = (ia - ib).abs()[off & torch.isfinite(a) & torch.isfinite(b)]
    return (f"{int(off.sum())} of {a.numel()} differ, at most "
            f"{int(ulps.max()) if ulps.numel() else 0} ulp")


HIT_FIELDS = ("valid", "t", "family", "index", "position", "normal", "color") + MATERIAL_KEYS


def hits_both_ways(monkeypatch, scene, pack, cfg, ro, rd):
    t, fam, idx = closest_query(scene, ro, rd, cfg, pack=pack)
    before = level_kernels.hits_kernel.launches
    got = hit_attributes(scene, ro, rd, t, fam, idx, cfg, pack=pack)
    assert level_kernels.hits_kernel.launches == before + 1
    with monkeypatch.context() as m:
        pytorch_path(m)
        want = hit_attributes(scene, ro, rd, t, fam, idx, cfg, pack=pack)
    torch.cuda.synchronize()
    bad = {f: gap(getattr(got, f), getattr(want, f)) if getattr(got, f).dtype == torch.float32
           else "differ" for f in HIT_FIELDS if not same_bits(getattr(got, f), getattr(want, f))}
    assert not bad, bad
    return got, (t, fam, idx)


@pytest.mark.parametrize("rays", ["fan", "wide-fan"])
def test_hits_kernel_equals_hit_attributes_bit_for_bit(cuda, monkeypatch, rays):
    """Hits, misses and parked lanes of K1's own queries."""
    scene, pack, cfg = soup_scene(cuda)
    ro, rd = fan_rays(cuda) if rays == "fan" else wide_fan_rays(cuda, 6)
    got, _ = hits_both_ways(monkeypatch, scene, pack, cfg, ro, rd)
    hits = int(got.valid.sum())
    assert 0 < hits < ro.shape[0] - 43          # misses besides the parked lanes
    assert not bool(got.valid[7:50].any())


def test_hits_kernel_on_a_table_of_few_rows_equals_hit_attributes(cuda, monkeypatch):
    """Four triangles in one chunk of four: ``_rows`` sums masked rows."""
    scene, pack, cfg = soup_scene(cuda, n=4, seed=5, chunk_size=4)
    assert pack.perm.shape[0] <= 8
    got, _ = hits_both_ways(monkeypatch, scene, pack, cfg, *fan_rays(cuda))
    assert int(got.valid.sum()) > 0


@pytest.mark.parametrize("legacy", [True, False], ids=["legacy-diffuse", "to-light-diffuse"])
@pytest.mark.parametrize("lights", [1, 2], ids=["1-light", "2-lights"])
@pytest.mark.parametrize("shadows", [True, False], ids=["occ", "no-occ"])
@pytest.mark.parametrize("level", [0, 4, 10], ids=["level-0", "level-4", "last"])
@pytest.mark.parametrize("branching", [False, True], ids=["reflect", "branching"])
def test_shade_kernel_equals_shade_level_bit_for_bit(cuda, monkeypatch, branching, level,
                                                     shadows, lights, legacy):
    scene, pack, cfg = soup_scene(cuda, lights=lights)
    cfg = dataclasses.replace(cfg, legacy_diffuse=legacy)
    ro, rd = wide_fan_rays(cuda, 6)
    rng = np.random.default_rng(level + 10 * lights)
    coeff = rng.uniform(0.0, 1.0, (ro.shape[0], 3))
    coeff[rng.uniform(size=ro.shape[0]) < 0.2] = 0.0        # lanes with no energy
    coeff = torch.as_tensor(coeff, dtype=torch.float32, device=cuda)
    occ = (torch.as_tensor(rng.uniform(size=ro.shape[0]) < 0.5, device=cuda) if shadows
           else None)
    hit, (t, fam, idx) = hits_both_ways(monkeypatch, scene, pack, cfg, ro, rd)
    args = (scene, ro, rd, coeff, t, fam, idx, occ, cfg, pack, branching, level)
    before = level_kernels.shade_kernel.launches
    got_c, got_child = shade._shade_level(*args, hit=hit)
    assert level_kernels.shade_kernel.launches == before + 1
    with monkeypatch.context() as m:
        pytorch_path(m)
        want_c, want_child = shade._shade_level(*args, hit=hit)
    torch.cuda.synchronize()
    if level == cfg.max_depth:
        got_child, want_child = (got_child,), (want_child,)
    assert len(got_child) == len(want_child)
    bad = {name: gap(a, b) for name, a, b in zip(("ro", "rd", "coeff"), got_child, want_child)
           if not same_bits(a, b)}
    if not same_bits(got_c, want_c):
        bad["colour"] = gap(got_c, want_c)
    assert not bad, bad
    assert bool((want_c != 0).any())


def test_shade_kernel_raises_on_what_it_does_not_take(cuda):
    scene, pack, cfg = soup_scene(cuda)
    ro, rd = fan_rays(cuda)
    t, fam, idx = closest_query(scene, ro, rd, cfg, pack=pack)
    hit = hit_attributes(scene, ro, rd, t, fam, idx, cfg, pack=pack)
    coeff = torch.ones_like(ro)
    call = (scene, ro, rd, coeff, hit, None, cfg, False, 0)
    with pytest.raises(ValueError, match="not contiguous"):
        level_kernels.shade_kernel(scene, ro, rd, coeff.t().contiguous().t(), *call[4:])
    with pytest.raises(TypeError, match="dtype"):
        level_kernels.shade_kernel(*call[:5], torch.zeros(ro.shape[0], device=cuda), *call[6:])
    lights = dataclasses.replace(scene.lights,
                                 position=scene.lights.position.expand(9, 3).contiguous(),
                                 intensity=scene.lights.intensity.expand(9, 3).contiguous())
    with pytest.raises(ValueError, match="at most 8"):
        level_kernels.shade_kernel(dataclasses.replace(scene, lights=lights), *call[1:])
    with pytest.raises(ValueError, match="not contiguous"):
        level_kernels.hits_kernel(scene, ro.t().contiguous().t(), rd, fam, idx, pack.perm)


def frames_both_ways(monkeypatch, scene, camera, cfg):
    """The frame through the kernels, with each kernel's launches, and
    through the PyTorch code."""
    launches = level_kernels.hits_kernel.launches, level_kernels.shade_kernel.launches
    img, n = render_with_stats(scene, camera, cfg)
    launches = (level_kernels.hits_kernel.launches - launches[0],
                level_kernels.shade_kernel.launches - launches[1])
    with monkeypatch.context() as m:
        pytorch_path(m)
        img_t, n_t = render_with_stats(scene, camera, cfg)
    return (img, n, launches), (img_t, n_t)


def test_a_depth_10_frame_through_the_kernels_equals_the_pytorch_frame(cuda, monkeypatch):
    """The benchmark's mesh at 160x128 from the close framing, where every
    level holds rays."""
    scene, cam = scenes.mesh_scene(device=cuda)
    scene = accel.with_chunks(scene, SWEEP)
    camera = scenes.make_camera(dict(cam, position=(0.0, 6.0, 14.0)), 160, 128, device=cuda)
    (img, n, launches), (img_t, n_t) = frames_both_ways(monkeypatch, scene, camera, SWEEP)
    assert launches == (11, 11)
    assert n == n_t and torch.equal(img, img_t)


def test_a_glass_model_at_depth_10_through_the_kernels_equals_the_pytorch_frame(cuda,
                                                                                monkeypatch):
    scene, camera = glass_model(cuda)
    (img, n, launches), (img_t, n_t) = frames_both_ways(monkeypatch, scene, camera, DEPTH10)
    assert launches == (11, 11)
    assert n == n_t and torch.equal(img, img_t)
