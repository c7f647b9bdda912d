"""The warps' chunk gate of the port's sweep, on the CPU through the twin: it
never changes a result (gate on equals gate off bit for bit), it only removes
work (``tested``); with it the queries still equal the JAX package's (its
Pallas sweep in interpret mode) and dense bruteforce. Inputs from numpy seeds.
The CUDA kernels' own cases are in tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtrace_tpu.ops.pallas import trace as jtrace
from realtrace_tpu_torch.apps import scenes
from realtrace_tpu_torch.core.types import BIG, PARK_DISTANCE, RenderConfig
from realtrace_tpu_torch.ops import accel, sweep
from realtrace_tpu_torch.render.pipeline import render_with_stats
from test_torch_bigscene import bulk_jscene
from test_torch_core import few_torch_threads  # noqa: F401 (autouse fixture)
from test_torch_sweep import CFG, JCFG, _brute64, coherent_rays, random_jscene, random_rays, \
    with_chunks


@pytest.fixture(scope="module", params=[137, 2048], ids=["soup137", "soup2048"])
def soup(request):
    n = request.param
    js, ps = with_chunks(random_jscene(n=n) if n == 137 else bulk_jscene(n, seed=5))
    return js, ps, sweep.build_pack(ps, CFG)


def face_rays(pack, seed=21):
    """Rays that graze chunk boxes and rays along the axes: origins on the
    planes of box faces, directions inside those planes (one component 0, so
    ``_inv_dir`` gives BIG and the slab product is 0 * BIG) or along one axis
    (two components 0); origins on box corners and edges among them."""
    rng = np.random.default_rng(seed)
    lo, hi = pack.lo.numpy(), pack.hi.numpy()
    ro, rd = [], []
    for i in rng.integers(0, lo.shape[0], 160):
        ax = int(rng.integers(0, 3))
        face = (lo if rng.random() < 0.5 else hi)[i, ax]
        o = rng.uniform(-14, 14, 3)
        if rng.random() < 0.3:                      # start on the box itself
            o = np.where(rng.random(3) < 0.5, lo[i], hi[i]).astype(np.float64)
        o[ax] = face
        d = rng.standard_normal(3)
        d[ax] = 0.0                                  # in the face's plane
        if rng.random() < 0.4:                       # along one axis
            keep = (ax + 1 + int(rng.integers(0, 2))) % 3
            d = np.where(np.arange(3) == keep, np.sign(d[keep]) or 1.0, 0.0)
        ro.append(o)
        rd.append(d / np.linalg.norm(d))
    return np.float32(ro), np.float32(rd)


def query_rays(pack):
    """Tile-coherent fans with parked lanes, random rays, face and axis rays:
    3,732 rays, so the last tile is ragged and its last warps are parked."""
    parts = [coherent_rays(nt=3, seed=4), random_rays(r=500, seed=11), face_rays(pack)]
    ro = np.concatenate([p[0] for p in parts])
    rd = np.concatenate([p[1] for p in parts])
    assert ro.shape[0] % sweep.LANES and np.any(rd == 0.0)
    return torch.as_tensor(ro), torch.as_tensor(rd)


@pytest.mark.parametrize("exact", [False, True], ids=["interval", "exact"])
@pytest.mark.parametrize("any_mode", [False, True], ids=["closest", "any"])
def test_gate_on_equals_gate_off(soup, any_mode, exact):
    _, _, pack = soup
    ro, rd = query_rays(pack)
    ro32, rd32, chunk_list, entry, counts = sweep.sweep_inputs(ro, rd, pack, CFG, exact)
    nt = counts.shape[0]
    args = (ro32, rd32, pack.consts, pack.meta, chunk_list, counts, entry, 1e-7, 1e-4, any_mode)
    plain, gated = (torch.zeros((nt, sweep.WARPS), dtype=torch.int32) for _ in range(2))
    t0, i0 = sweep.sweep_reference(*args, tested=plain)
    t1, i1 = sweep.sweep(*args, tested=gated, lo=pack.lo, hi=pack.hi)   # CPU: the gated twin
    assert 0 < int((i0 >= 0).sum()) < i0.numel()
    assert torch.equal(i1, i0) and torch.equal(t1, t0)
    # the gate only removes work, never past the list's end
    assert bool((gated <= plain).all()) and bool((plain <= counts[:, None]).all())
    if pack.n_chunks >= 64:      # the 137-triangle soup's 5 boxes all overlap
        assert int(gated.sum()) < int(plain.sum())
    # warps of parked lanes test nothing, with or without the gate
    parked = (ro32[:, 0] == PARK_DISTANCE).reshape(nt, sweep.WARPS, sweep.WARP_RAYS).all(dim=2)
    assert int(parked.sum()) >= 2
    assert int(gated[parked].sum()) == 0 and int(plain[parked].sum()) == 0
    assert int(gated[~parked].sum()) > 0
    # and a walk of every listed position by every lane gives the same hits
    t2, i2 = sweep.sweep_reference(ro32, rd32, pack.consts, pack.meta, chunk_list, counts,
                                   torch.zeros_like(entry), 1e-7, 1e-4, any_mode)
    live = ro32[:, 0] != PARK_DISTANCE
    assert torch.equal(i2[live] >= 0, i0[live] >= 0)
    if not any_mode:
        assert torch.equal(i2[live], i0[live]) and torch.equal(t2[live], t0[live])


def test_slab_helpers_handle_axis_parallel_rays():
    """0 * BIG stays 0: a ray inside a box's slab along an axis it does not
    move on passes, one outside fails; of the rays along an edge, the one on
    the box's low faces passes (exit BIG), the one on its high faces does not
    (exit 0): no triangle inside the box has an interior point there."""
    ro = torch.tensor([[0.5, 0.5, -3.0], [1.5, 0.5, -3.0], [0.0, 0.0, -3.0], [1.0, 1.0, -3.0]])
    rd = torch.tensor([[0.0, 0.0, 1.0]]).expand(4, 3)
    inv = sweep._inv_dir(rd)
    assert float(inv[0, 0]) == float(np.float32(BIG))
    lo, hi = torch.zeros(1, 3), torch.ones(1, 3)
    tn, tf = sweep._slab_interval(ro, inv, lo, hi)
    assert sweep._slab_pass(tn, tf).tolist() == [True, False, True, False]
    assert tn.tolist() == [3.0, 3.0, 3.0, 3.0]


def test_gated_queries_equal_jax_pallas_and_bruteforce(soup):
    """closest_triangle / any_triangle hand the boxes to the sweep; on the
    interval list they still equal JAX's and dense f64 bruteforce."""
    js, ps, pack = soup
    ro, rd = random_rays(r=600, seed=17)
    tro, trd = torch.as_tensor(ro), torch.as_tensor(rd)
    seen = []
    real = sweep.sweep
    try:
        sweep.sweep = lambda *a, **k: seen.append(k.get("lo") is not None) or real(*a, **k)
        pt, pi = sweep.closest_triangle(ps, tro, trd, CFG, pack=pack, exact_mask=False)
        pocc = sweep.any_triangle(ps, tro, trd, CFG, pack=pack, exact_mask=False).numpy()
    finally:
        sweep.sweep = real
    assert seen == [True, True]
    jt, ji = jtrace.closest_triangle(js, jnp.asarray(ro), jnp.asarray(rd), JCFG, exact_mask=False)
    jocc = np.asarray(jtrace.any_triangle(js, jnp.asarray(ro), jnp.asarray(rd), JCFG,
                                          exact_mask=False))
    pt, pi, jt, ji = pt.numpy(), pi.numpy(), np.asarray(jt), np.asarray(ji)
    hit = ji >= 0
    assert 0.05 < hit.mean() < 0.95
    np.testing.assert_array_equal(pi, ji)
    # hits at t < 0.1 among coordinates up to 26: 4 ulps of the coordinates
    # beside rtol 1e-5 (as tests/test_torch_bigscene.py)
    np.testing.assert_allclose(pt[hit], jt[hit], rtol=1e-5, atol=8e-6)
    bt, bi = _brute64(ps, ro, rd)
    np.testing.assert_array_equal(pi, bi)
    np.testing.assert_allclose(pt[hit], bt[hit], rtol=1e-5, atol=8e-6)
    np.testing.assert_array_equal(pocc, jocc)
    np.testing.assert_array_equal(pocc, bi >= 0)


@pytest.mark.parametrize("scene_fn", ["mesh", "glass"])
def test_gated_render_equals_ungated_render(monkeypatch, scene_fn):
    cfg = RenderConfig(accel="sweep", max_depth=3)
    make = scenes.mesh_scene if scene_fn == "mesh" else scenes.glass_mesh_scene
    scene, cam = make(detail=0.2, device="cpu")
    scene = accel.with_chunks(scene, cfg)
    camera = scenes.make_camera(dict(cam, position=(0.0, 6.0, 14.0)), 64, 64, device="cpu")
    img_g, n_g = render_with_stats(scene, camera, cfg)
    real, dropped = sweep.sweep, []

    def ungated(*a, lo=None, hi=None, **k):
        dropped.append(lo is not None)
        return real(*a, **k)

    monkeypatch.setattr(sweep, "sweep", ungated)
    img_u, n_u = render_with_stats(scene, camera, cfg)
    assert dropped and all(dropped)
    assert n_g == n_u and torch.equal(img_g, img_u)
    assert float((img_g - scene.background).abs().amax(-1).gt(1e-3).float().mean()) > 0.2
