"""The plain reference and the frozen inputs against the program at a tiny
size on the CPU (the program's brute-force accel, no kernel)."""
import dataclasses

import numpy as np
import pytest
import torch

from rtbench import manifest, reference, scene
from rtbench.reference import Groups, Reference, median_split, tf32
from rtbench.tests.conftest import tiny
from rtbench.workload import program_camera, program_scene

W, H = 48, 32


def bob(copies=1, detail=0.3):
    cfg = manifest.config(manifest.load(), {"config": "bob_1080p"})
    return dict(cfg, scene=dict(cfg["scene"], detail=detail, copies=copies))


def port_render(arrays, cam, depth, dtype=torch.float32, sphere=None):
    from realtrace_tpu_torch.core.types import Materials, RenderConfig
    from realtrace_tpu_torch.render.pipeline import render_with_stats

    s = program_scene(arrays, "cpu")
    if sphere is not None:
        s = dataclasses.replace(
            s, sph_center=torch.tensor([sphere["center"]]), sph_radius=torch.tensor([sphere["radius"]]),
            sph_color=torch.tensor([sphere["color"]]),
            sph_materials=Materials.full(1, device="cpu", **sphere["material"]))
    s = dataclasses.replace(s, **{f.name: _cast(getattr(s, f.name), dtype)
                                  for f in dataclasses.fields(s)})
    camera = program_camera(cam, W, H, "cpu")
    camera = dataclasses.replace(camera, position=camera.position.to(dtype),
                                 target=camera.target.to(dtype), up=camera.up.to(dtype),
                                 fovy=camera.fovy.to(dtype))
    img, _ = render_with_stats(s, camera, RenderConfig(max_depth=depth, accel="bruteforce"))
    return img.reshape(-1, 3).double()


def _cast(x, dtype):
    if isinstance(x, torch.Tensor):
        return x.to(dtype) if x.is_floating_point() else x
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: _cast(getattr(x, f.name), dtype)
                                         for f in dataclasses.fields(x)})
    return x


def ref_render(arrays, cam, depth, lowp=False):
    ref = Reference(dict(max_depth=depth), "cpu", lowp=lowp)
    rs = ref.scene(arrays)
    ro, rd = ref.camera_rays(cam, W, H, torch.arange(W * H))
    groups = Groups(rs["tri_vertices"], sph_center=rs["sph_center"])
    return ref.trace(rs, ro, rd, groups).clamp(0, 1).double()


@pytest.mark.parametrize("position", [[60.0, 60.0, 0.0], [0.0, 6.0, 14.0]])
def test_reference_equals_the_port_bruteforce(position):
    cfg = bob()
    arrays = scene.scene_arrays(cfg)
    cam = dict(cfg["camera"], position=position)
    gap = (port_render(arrays, cam, 3) - ref_render(arrays, cam, 3)).abs()
    assert float(gap.max()) < 1e-4


def test_reference_equals_the_port_on_a_glass_sphere_in_float64():
    cfg = bob()
    arrays = scene.scene_arrays(cfg)
    sphere = dict(center=[20.0, 15.0, 20.0], radius=10.0, color=[0.95, 0.95, 1.0],
                  material=dict(ka=0.1, kd=0.2, ks=0.3, kr=0.3, kt=0.8, eta=1.5))
    ref_arrays = dict(arrays, sph_center=np.array([sphere["center"]]),
                      sph_radius=np.array([sphere["radius"]]), sph_color=np.array([sphere["color"]]),
                      sph_materials={k: np.array([v]) for k, v in sphere["material"].items()})
    cam = cfg["camera"]
    gap = (port_render(arrays, cam, 3, torch.float64, sphere) - ref_render(ref_arrays, cam, 3)).abs()
    assert float(gap.max()) < 1e-6


def test_the_control_is_off_where_the_reference_is_not():
    cfg = bob()
    arrays = scene.scene_arrays(cfg)
    gap = (ref_render(arrays, cfg["camera"], 3, lowp=True) - ref_render(arrays, cfg["camera"], 3))
    assert float((gap.abs().amax(1) > 1e-3).double().mean()) > 0.05


def test_tf32_keeps_ten_mantissa_bits_and_passes_gradients():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11,
                      -(1.0 + 2.0 ** -12)], requires_grad=True)
    y = tf32(x)
    assert y.tolist() == [1.0, 1.0 + 2.0 ** -10, 1.0, 1.0 + 2 * 2.0 ** -10, -1.0]
    y.sum().backward()
    assert x.grad.tolist() == [1.0] * 5


def test_median_split_is_the_programs_host_ordering():
    from realtrace_tpu_torch.ops.accel import build_chunk_perm_split

    tv = scene.scene_arrays(bob(copies=2))["tri_vertices"]
    assert np.array_equal(median_split(tv), build_chunk_perm_split(tv, 32).astype(np.int64))


def test_scene_arrays_are_the_programs_duplicated_mesh():
    from realtrace_tpu_torch.apps import scenes

    arrays = scene.scene_arrays(bob(copies=8, detail=1.0))
    s, cam = scenes.duplicated_mesh_scene(8, device="cpu")
    assert np.array_equal(arrays["tri_vertices"], s.tri_vertices.double().numpy())
    assert np.array_equal(arrays["tri_colors"], s.tri_colors.double().numpy())
    assert cam["position"] == (60, 60, 0)


@pytest.mark.parametrize("mix", ["orbit", "close_orbit"])
def test_the_orbit_keeps_its_distance_and_moves_as_the_flythrough(mix):
    cfg = bob()
    traffic = manifest.traffic(mix)
    start = np.asarray(traffic.get("position") or cfg["camera"]["position"])
    assert scene.orbit_view(cfg, traffic, (0.0, 0.0), 0)["position"] == pytest.approx(start)
    phases = scene.orbit_phases(2 ** 33 + 1)
    views = [np.asarray(scene.orbit_view(cfg, traffic, phases, k)["position"])
             for k in range(-2, 48)]
    assert np.allclose([np.linalg.norm(v) for v in views], np.linalg.norm(start))
    yaw = np.unwrap([np.arctan2(v[2], v[0]) for v in views])
    assert np.allclose(np.diff(yaw), traffic["yaw_step"])
    elev = np.array([np.arcsin(v[1] / np.linalg.norm(v)) for v in views])
    base = np.arcsin(start[1] / np.linalg.norm(start))
    assert np.abs(elev - base).max() == pytest.approx(traffic["pitch_amp"], rel=0.02)
    assert len({tuple(np.round(v, 9)) for v in views}) == len(views)


@pytest.mark.parametrize("mix", ["orbit", "close_orbit"])
def test_the_orbit_keeps_the_camera_outside_the_model(mix):
    """Rays from a camera inside a closed mirror mesh all reflect to the last
    level: no viewer flies there. From every camera of a pitch period, some
    of 256 directions escape the full-size mesh."""
    cfg = bob(detail=1.0)
    traffic = manifest.traffic(mix)
    ref = Reference(cfg["render"], "cpu")
    rs = ref.scene(scene.scene_arrays(cfg))
    groups = Groups(rs["tri_vertices"])
    rd = torch.nn.functional.normalize(
        torch.randn((256, 3), generator=torch.Generator().manual_seed(0), dtype=torch.float64), dim=1)
    for phases in [(0.0, 0.0), (1.0, 3.0), scene.orbit_phases(11)]:
        for k in range(traffic["pitch_period"]):
            pos = ref.tensor(scene.orbit_view(cfg, traffic, phases, k)["position"])
            hit = ref.closest(rs, groups, pos.expand(256, 3), rd, any_mode=True)
            assert not bool(hit.all()), (phases, k)


def test_the_seed_draws_the_orbits_phases():
    a, b = scene.orbit_phases(7), scene.orbit_phases(8)
    assert a == scene.orbit_phases(7) and a != b
    assert all(0.0 <= x < 2 * np.pi for x in a + b)


def test_tiny_overrides_cut_the_mesh():
    arrays = scene.scene_arrays(dict(bob(), **tiny("bob_1080p")))
    assert arrays["tri_vertices"].shape[0] < 1000


def random_spheres(n: int, seed: int) -> tuple[dict, torch.Tensor, torch.Tensor]:
    """A scene of ``n`` seeded spheres and 40 triangles in a box of side 20,
    and 600 rays: from anywhere, at sphere centres, and grazing spheres (at
    their radius from the centre, to rounding)."""
    g = np.random.default_rng(seed)
    tv = g.uniform(-10, 10, (40, 1, 3)) + g.uniform(-2, 2, (40, 3, 3))
    c, r = g.uniform(-10, 10, (n, 3)), g.uniform(0.05, 2.0, n)
    arrays = dict(tri_vertices=tv, sph_center=c, sph_radius=r)
    ro = g.uniform(-14, 14, (600, 3))
    d = g.normal(size=(600, 3))
    if n:
        k = g.integers(0, n, 400)
        d[:200] = c[k[:200]] - ro[:200]
        u = np.cross(d[200:400], g.normal(size=(200, 3)))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        ro[200:400] = c[k[200:]] + r[k[200:], None] * u - 30 * d[200:400] / np.linalg.norm(
            d[200:400], axis=1, keepdims=True)
    return arrays, torch.as_tensor(ro), torch.as_tensor(d / np.linalg.norm(d, axis=1, keepdims=True))


@pytest.mark.parametrize("lowp", [False, True])
@pytest.mark.parametrize("n", [0, 1, 33, 300])
def test_the_blocked_sphere_search_is_the_all_pairs_search(n, lowp, monkeypatch):
    """Groups of 4 spheres, blocks of 2-64 rays and steps of 8 (ray, group)
    pairs: every group, block and step boundary is crossed."""
    monkeypatch.setattr(reference, "SPH_GROUP", 4)
    monkeypatch.setattr(reference, "SLAB_ELEMS", 160)
    monkeypatch.setattr(reference, "PAIR_TESTS", 32)
    arrays, ro, rd = random_spheres(n, seed=n)
    ref = Reference({}, "cpu", lowp=lowp)
    s = {k: ref.tensor(v) for k, v in arrays.items()}
    ro, rd = ro.to(ref.dtype), rd.to(ref.dtype)
    groups = Groups(s["tri_vertices"], sph_center=s["sph_center"])
    assert groups.sph_perm.shape == (-(-n // 4), 4)
    t, fam, idx = ref.closest(s, groups, ro, rd)
    occ = ref.closest(s, groups, ro, rd, any_mode=True)
    # the all-pairs search, as the reference searched spheres before it was blocked
    t_all, i_tri = ref._tri_closest(s["tri_vertices"], groups, ro, rd, False)
    fam_all, idx_all = torch.where(i_tri >= 0, 1, 0), i_tri.clamp(min=0)
    occ_all = i_tri >= 0
    if n:
        ts = ref._sph_t(s, ro, rd)
        tsb, isb = ts.min(1)
        closer = tsb < t_all
        t_all = torch.where(closer, tsb, t_all)
        fam_all = torch.where(closer, 2, fam_all)
        idx_all = torch.where(closer, isb, idx_all)
        occ_all = occ_all | torch.isfinite(ts).any(1)
        t_s, i_s = ref._sph_closest(s, groups, ro, rd, False)
        assert torch.equal(t_s, tsb)
        assert torch.equal(i_s, torch.where(torch.isfinite(tsb), isb, -1))
        assert int((fam == 2).sum()) > 100
    assert torch.equal(t, t_all) and torch.equal(fam, fam_all) and torch.equal(idx, idx_all)
    assert torch.equal(occ, occ_all)


def test_groups_without_the_scene_s_spheres_are_refused():
    arrays, ro, rd = random_spheres(5, seed=1)
    ref = Reference({}, "cpu")
    s = {k: ref.tensor(v) for k, v in arrays.items()}
    with pytest.raises(ValueError, match="groups of 0 spheres for a scene of 5"):
        ref.closest(s, Groups(s["tri_vertices"]), ro, rd)


@pytest.mark.parametrize("lowp", [False, True])
def test_the_sphere_boxes_keep_the_rays_the_sphere_test_passes_by_rounding(lowp, monkeypatch):
    """Rays along y, 100 from a sphere of radius 0.05, missing it by 1e-12
    to 3e-3: in float32 the sphere test passes them all (its discriminant
    loses the gap to |origin - centre|^2). The grown box keeps every ray the
    all-pairs test passes; the bare box drops them."""
    ref = Reference({}, "cpu", lowp=lowp)
    gap = np.array([1e-12, 1e-9, 1e-5, 1e-3, 3e-3])
    ro = ref.tensor(np.stack([0.05 + gap, np.full(5, -100.0), np.zeros(5)], 1))
    rd = ref.tensor(np.tile([0.0, 1.0, 0.0], (5, 1)))
    s = dict(tri_vertices=ref.tensor(np.zeros((0, 3, 3))), sph_center=ref.tensor([[0.0, 0.0, 0.0]]),
             sph_radius=ref.tensor([0.05]))
    groups = Groups(s["tri_vertices"], sph_center=s["sph_center"])
    t_all = ref._sph_t(s, ro, rd)[:, 0]
    assert torch.equal(ref._sph_closest(s, groups, ro, rd, False)[0], t_all)
    if lowp:
        assert bool(torch.isfinite(t_all).all())
        monkeypatch.setattr(reference, "SPH_MARGIN", {torch.float32: 0.0})
        assert not bool(torch.isfinite(ref._sph_closest(s, groups, ro, rd, False)[0]).any())
