"""The port's chunk build, sweep pack, chunk masks and sweep against the JAX
package (its Pallas sweep in interpret mode) and against dense bruteforce.
The CUDA kernel's own cases are in tests/test_torch_cuda.py."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtrace_tpu.core.types import RenderConfig as JConfig
from realtrace_tpu.core.types import SceneBuilder as JBuilder
from realtrace_tpu.ops import accel as jaccel
from realtrace_tpu.ops import intersect as jint
from realtrace_tpu.ops.pallas import trace as jtrace
from realtrace_tpu_torch.apps.scenes import mesh_arrays
from realtrace_tpu_torch.core.types import PARK_DISTANCE, RenderConfig
from realtrace_tpu_torch.ops import accel, sweep
from test_torch_core import few_torch_threads, to_port  # noqa: F401 (autouse fixture)

CFG = RenderConfig(accel="sweep", chunk_size=32)
JCFG = JConfig(accel="pallas", chunk_size=32)


def random_jscene(n=137, spread=3.0, seed=3, dtype=jnp.float32):
    """The tests/test_pallas.py random triangle soup."""
    rng = np.random.default_rng(seed)
    b = JBuilder(dtype=dtype)
    for ctr in rng.uniform(-10, 10, (n, 3)):
        tri = ctr + rng.uniform(-spread, spread, (3, 3))
        b.add_triangle(tri[0], tri[1], tri[2])
    b.add_light((0, 30, 30), (1, 1, 1))
    return b.build()


def random_rays(r=500, seed=11):
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-15, 15, (r, 3)).astype(np.float32)
    rd = rng.standard_normal((r, 3))
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    return ro, rd


def coherent_rays(nt=3, seed=4):
    """Tile-coherent rays: per tile a pinhole-like fan from one origin, a
    random fan on the last tile, and a few parked lanes."""
    rng = np.random.default_rng(seed)
    ro, rd = [], []
    for i in range(nt):
        o = rng.uniform(-20, 20, 3) + np.array([0.0, 0.0, 30.0])
        aim = -o / np.linalg.norm(o)
        spread = 0.15 if i < nt - 1 else 1.0
        d = aim + spread * rng.standard_normal((sweep.LANES, 3))
        ro.append(np.broadcast_to(o, (sweep.LANES, 3)))
        rd.append(d / np.linalg.norm(d, axis=1, keepdims=True))
    ro, rd = np.concatenate(ro).astype(np.float32), np.concatenate(rd).astype(np.float32)
    ro[5:40] = PARK_DISTANCE
    rd[5:40] = (1.0, 0.0, 0.0)
    return ro, rd


def with_chunks(jscene):
    js = jaccel.with_chunks(jscene, JCFG)
    ps = to_port(jscene)
    ps = dataclasses.replace(ps, tri_chunk_perm=torch.as_tensor(np.array(js.tri_chunk_perm),
                                                                dtype=torch.int64))
    return js, ps


@pytest.mark.parametrize("which", ["random", "mesh"])
def test_chunk_perm_equals_jax(which):
    if which == "random":
        tv = np.asarray(random_jscene(n=700, seed=9).tri_vertices, np.float64)
    else:
        tv = 15.0 * mesh_arrays(seed=1, detail=0.36)[0]
    for c in (8, 32):
        want = np.asarray(jaccel.chunk_perm_split_device(jnp.asarray(tv), c))
        got = accel.chunk_perm_split(torch.as_tensor(tv), c).numpy()
        np.testing.assert_array_equal(got, want)
    for n in (100, 20_000, 70_000, 300_000):
        assert accel.effective_chunk_size(CFG, n) == jaccel.effective_chunk_size(JCFG, n)


def test_pack_consts_match_jax():
    js, ps = with_chunks(random_jscene())
    jpack = jtrace.build_pack(js, JCFG)
    pack = sweep.build_pack(ps, CFG)
    m, c = pack.n_chunks, pack.chunk_size
    assert jpack.resident
    b = np.asarray(jpack.b).reshape(jtrace.FEAT, m, 4 * c).transpose(1, 2, 0)
    bd, bt, bb, bg = (b[:, k * c:(k + 1) * c] for k in range(4))
    want = np.concatenate([bd[..., 4:7], bt[..., :1], bb[..., 4:7], -bb[..., 7:10],
                           bg[..., 4:7], bg[..., 7:10]], axis=-1)
    np.testing.assert_allclose(pack.consts.numpy(), want, rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(-bt[..., 1:4], want[..., 0:3], atol=0)   # t row = d - n.ro'
    for name in ("meta", "lo", "hi"):
        np.testing.assert_array_equal(getattr(pack, name).numpy(), np.asarray(getattr(jpack, name)))
    np.testing.assert_array_equal(pack.perm.numpy(), np.asarray(jpack.perm))


def _masks_equal(got, want):
    g_ids, g_entry, g_cnt = (x.numpy() for x in got)
    w_ids, w_entry, w_cnt = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(g_cnt, w_cnt[:, 0, 0])
    assert g_cnt.max() > 0
    np.testing.assert_array_equal(g_ids, w_ids[:, 0, :])
    np.testing.assert_array_equal(g_entry, w_entry[:, 0, :])


@pytest.mark.parametrize("exact,cap", [(False, None), (True, None), (True, 2)],
                         ids=["interval", "exact", "exact-cap2"])
def test_chunk_masks_equal_jax(exact, cap, monkeypatch):
    if cap is not None:        # a tiny gate cap exercises the un-refined tail
        monkeypatch.setattr(jtrace, "EXACT_GATE_CAP", cap)
        monkeypatch.setattr(sweep, "EXACT_GATE_CAP", cap)
    js, ps = with_chunks(random_jscene(n=512, spread=2.0))
    pack = sweep.build_pack(ps, CFG)
    ro, rd = coherent_rays()
    nt = ro.shape[0] // sweep.LANES
    jfn, pfn = ((jtrace._chunk_mask_exact, sweep.chunk_mask_exact) if exact
                else (jtrace._chunk_mask, sweep.chunk_mask))
    want = jfn(jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(pack.lo.numpy()),
               jnp.asarray(pack.hi.numpy()), nt)
    got = pfn(torch.as_tensor(ro), torch.as_tensor(rd), pack.lo, pack.hi, nt)
    _masks_equal(got, want)


def test_chunk_mask_on_cpu_runs_the_twin():
    """CPU tensors, contiguous or not, run the twin and launch nothing."""
    js, ps = with_chunks(random_jscene(n=512, spread=2.0))
    pack = sweep.build_pack(ps, CFG)
    ro, rd = (torch.as_tensor(x) for x in coherent_rays())
    assert not ro.is_contiguous()
    nt = ro.shape[0] // sweep.LANES
    launches = sweep.mask_kernel.launches
    got = sweep.chunk_mask(ro, rd, pack.lo, pack.hi, nt)
    want = sweep.chunk_mask_reference(ro.contiguous(), rd.contiguous(), pack.lo, pack.hi, nt)
    assert sweep.mask_kernel.launches == launches
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert int(want[2].max()) > 0


def _meta(*shape, **kw):
    """A tensor on the meta device: a shape without data, so that nothing
    could be launched on it."""
    return torch.empty(shape, device="meta", **kw)


def _mask_inputs(m=40, **swap):
    """chunk_mask's inputs for two tiles on the meta device, some replaced."""
    x = dict(ro=_meta(2 * sweep.LANES, 3), rd=_meta(2 * sweep.LANES, 3), lo=_meta(m, 3),
             hi=_meta(m, 3))
    x.update(swap)
    return x["ro"], x["rd"], x["lo"], x["hi"], 2


MASK_REFUSALS = [
    ("ro-f64", lambda: _mask_inputs(ro=_meta(2 * sweep.LANES, 3, dtype=torch.float64)),
     TypeError, "ro has dtype"),
    ("rd-short", lambda: _mask_inputs(rd=_meta(2 * sweep.LANES - 1, 3)), ValueError,
     "rd has shape"),
    ("hi-rows", lambda: _mask_inputs(hi=_meta(39, 3)), ValueError, "hi has shape"),
    ("lo-strided", lambda: _mask_inputs(lo=_meta(3, 40).t()), ValueError, "lo is not contiguous"),
    ("hi-on-cpu", lambda: _mask_inputs(hi=torch.empty(40, 3)), ValueError, "hi is on cpu"),
    ("ro-on-cpu", lambda: _mask_inputs(ro=torch.empty(2 * sweep.LANES, 3)), ValueError,
     "rd is on meta"),
    ("over-capacity", lambda: _mask_inputs(m=sweep.MASK_SORT_CAPACITY + 1), ValueError,
     "sorts at most"),
    ("no-kernel", lambda: _mask_inputs(m=sweep.MASK_SORT_CAPACITY), ValueError,
     "no kernel for device meta"),
]


@pytest.mark.parametrize("inputs,error,match", [c[1:] for c in MASK_REFUSALS],
                         ids=[c[0] for c in MASK_REFUSALS])
def test_chunk_mask_wrapper_refuses_before_any_launch(inputs, error, match, monkeypatch):
    """Every input the kernel cannot take raises in the wrapper; nothing is
    built or launched (the library would raise first)."""
    from realtrace_tpu_torch.ops import cuda_build

    def no_build():
        raise AssertionError("the wrapper reached the kernel library")
    monkeypatch.setattr(cuda_build, "load", no_build)
    launches = sweep.mask_kernel.launches
    with pytest.raises(error, match=match):
        sweep.chunk_mask(*inputs())
    assert sweep.mask_kernel.launches == launches


def _brute64(ps, ro, rd):
    from realtrace_tpu_torch.ops import intersect
    t, _, _ = intersect.triangle_test(torch.as_tensor(ro, dtype=torch.float64),
                                      torch.as_tensor(rd, dtype=torch.float64),
                                      ps.tri_vertices.double(), 1e-7, 1e-4)
    tb, ib = torch.min(t, dim=1)
    return tb.numpy(), np.where(tb.numpy() < 1e29, ib.numpy(), -1)


@pytest.mark.parametrize("exact", [False, True], ids=["interval", "exact"])
def test_sweep_matches_jax_pallas_and_bruteforce(exact):
    js, ps = with_chunks(random_jscene())
    ro, rd = random_rays()
    pt, pi = sweep.closest_triangle(ps, torch.as_tensor(ro), torch.as_tensor(rd), CFG,
                                    exact_mask=exact)
    jt, ji = jtrace.closest_triangle(js, jnp.asarray(ro), jnp.asarray(rd), JCFG,
                                     exact_mask=exact)
    pt, pi, jt, ji = pt.numpy(), pi.numpy(), np.asarray(jt), np.asarray(ji)
    hit = ji >= 0
    assert 0.05 < hit.mean() < 0.95
    np.testing.assert_array_equal(pi >= 0, hit)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(pt[hit], jt[hit], rtol=1e-5)
    # dense f64 reference: same hits, same triangles
    bt, bi = _brute64(ps, ro, rd)
    np.testing.assert_array_equal(pi, bi)
    np.testing.assert_allclose(pt[hit], bt[hit], rtol=1e-5)
    # occlusion
    pocc = sweep.any_triangle(ps, torch.as_tensor(ro), torch.as_tensor(rd), CFG,
                              exact_mask=exact).numpy()
    jocc = np.asarray(jtrace.any_triangle(js, jnp.asarray(ro), jnp.asarray(rd), JCFG,
                                          exact_mask=exact))
    np.testing.assert_array_equal(pocc, jocc)
    t64, _, _ = jint.triangle_test(jnp.asarray(ro, jnp.float64), jnp.asarray(rd, jnp.float64),
                                   js.tri_vertices.astype(jnp.float64), 1e-7, 1e-4)
    np.testing.assert_array_equal(pocc, np.asarray(jnp.any(t64 < 1e29, axis=1)))


def test_sweep_on_mesh_with_coherent_rays_matches_bruteforce():
    tv = 15.0 * mesh_arrays(seed=0, detail=0.36)[0]
    b = JBuilder(dtype=jnp.float32)
    for tri in tv:
        b.add_triangle(tri[0], tri[1], tri[2])
    js, ps = with_chunks(b.build())
    pack = sweep.build_pack(ps, CFG)
    assert pack.n_chunks >= 40
    ro, rd = coherent_rays(nt=2, seed=8)
    ro = ro * 0.5 + np.float32([0, 25, 0])
    pt, pi = sweep.closest_triangle(ps, torch.as_tensor(ro), torch.as_tensor(rd), CFG, pack=pack)
    bt, bi = _brute64(ps, ro, rd)
    hit = bi >= 0
    assert hit.mean() > 0.1
    np.testing.assert_array_equal(pi.numpy(), bi)
    np.testing.assert_allclose(pt.numpy()[hit], bt[hit], rtol=1e-5)


def test_sweep_wrapper_checks_and_limits():
    js, ps = with_chunks(random_jscene(n=40))
    pack = sweep.build_pack(ps, CFG)
    ro, rd = random_rays(r=777, seed=2)            # not a multiple of the tile
    launches = sweep.sweep.launches
    t, idx = sweep.closest_triangle(ps, torch.as_tensor(ro), torch.as_tensor(rd), CFG, pack=pack)
    assert t.shape == (777,) and idx.shape == (777,)
    assert sweep.sweep.launches == launches        # CPU tensors run the twin, uncounted
    ro32 = torch.zeros((sweep.LANES, 3))
    lists = (torch.zeros((1, pack.n_chunks), dtype=torch.int32),
             torch.zeros(1, dtype=torch.int32), torch.zeros((1, pack.n_chunks)))
    with pytest.raises(TypeError):
        sweep.sweep(ro32.double(), ro32, pack.consts, pack.meta, *lists, 1e-7, 1e-4)
    with pytest.raises(ValueError):
        sweep.sweep(ro32[:-1], ro32, pack.consts, pack.meta, *lists, 1e-7, 1e-4)
    with pytest.raises(ValueError, match="tested"):
        sweep.sweep(ro32, ro32, pack.consts, pack.meta, *lists, 1e-7, 1e-4,
                    tested=torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="hi"):
        sweep.sweep(ro32, ro32, pack.consts, pack.meta, *lists, 1e-7, 1e-4,
                    lo=pack.lo, hi=pack.hi[:-1])
    with pytest.raises(ValueError, match="together"):
        sweep.sweep(ro32, ro32, pack.consts, pack.meta, *lists, 1e-7, 1e-4, lo=pack.lo)
    # 65,536 triangle slots and more: the query runs, through the big-scene
    # masks (2,100 copies of the pack, all but the first moved far away)
    rep = 2100
    far = (torch.arange(rep).repeat_interleave(pack.n_chunks) * 1000.0)[:, None] * torch.tensor(
        [0.0, 1.0, 0.0])
    big = sweep.AccelPack(pack.consts.repeat(rep, 1, 1), pack.meta.repeat(rep, 1) + far,
                          pack.lo.repeat(rep, 1) + far, pack.hi.repeat(rep, 1) + far,
                          pack.perm.repeat(rep), pack.chunk_size)
    assert big.n_chunks * big.chunk_size >= sweep.EXACT_MASK_MIN_TRIS and not big.resident
    tb, ib = sweep.closest_triangle(ps, torch.as_tensor(ro), torch.as_tensor(rd), CFG, pack=big)
    assert 0 < int((idx >= 0).sum()) < 777
    assert torch.equal(ib, idx)
    torch.testing.assert_close(tb, t, rtol=1e-5, atol=0)
