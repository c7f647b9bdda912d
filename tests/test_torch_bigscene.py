"""The port's big-scene path on the CPU against the JAX package: the
super-chunk gate of the exact mask, the big-scene mask policy end to end, the
residency decision, the blocked twin with its early-exit positions, and the
duplicated mesh. Inputs from numpy seeds; the JAX sweep runs in interpret
mode. The CUDA kernels' own cases are in tests/test_torch_cuda.py."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtrace_tpu.core.types import Materials as JMaterials
from realtrace_tpu.ops import accel as jaccel
from realtrace_tpu.ops.pallas import trace as jtrace
from realtrace_tpu_torch.apps import scenes
from realtrace_tpu_torch.core.types import RenderConfig
from realtrace_tpu_torch.ops import accel, sweep
from test_torch_core import few_torch_threads  # noqa: F401 (autouse fixture)
from test_torch_sweep import (CFG, JCFG, _brute64, _masks_equal, coherent_rays, random_jscene,
                              random_rays, with_chunks)


def bulk_jscene(n, seed, spread=1.5):
    """n random triangles without a per-triangle add_triangle loop."""
    rng = np.random.default_rng(seed)
    tv = rng.uniform(-10, 10, (n, 1, 3)) + rng.uniform(-spread, spread, (n, 3, 3))
    col = np.broadcast_to(np.float32([0.8, 0.1, 0.0]), (n, 3, 3))
    return random_jscene(n=1).replace(tri_vertices=jnp.asarray(tv, jnp.float32),
                                      tri_colors=jnp.asarray(col),
                                      tri_materials=JMaterials.default(n))


@pytest.fixture(scope="module")
def soup2048():
    """2,048 triangles at chunk 32: 64 chunks, the floor of the super gate."""
    js, ps = with_chunks(bulk_jscene(2048, seed=5))
    pack = sweep.build_pack(ps, CFG)
    assert pack.n_chunks == 64
    return js, ps, pack


def test_super_bounds_equal_jax():
    rng = np.random.default_rng(0)
    for m in (64, 100, 1100):           # 1100 chunks: the group doubles to 16
        lo = rng.uniform(-10, 10, (m, 3)).astype(np.float32)
        hi = lo + rng.uniform(0, 3, (m, 3)).astype(np.float32)
        want = jtrace._super_bounds(jnp.asarray(lo), jnp.asarray(hi))
        got = sweep.super_bounds(torch.as_tensor(lo), torch.as_tensor(hi))
        assert got[2] == want[2]
        assert got[0].shape[0] <= sweep.SUPER_STAGE_WIDTH
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def two_pencil_rays(seed=6):
    """coherent_rays with a first tile of two thin pencils along +x from far
    apart origins: the tile's interval box spans both, per-ray tests do not."""
    ro, rd = (np.ascontiguousarray(x) for x in coherent_rays(nt=3, seed=seed))
    rng = np.random.default_rng(seed)
    half = sweep.LANES // 2
    ro[:half], ro[half:sweep.LANES] = (-30.0, -7.0, -7.0), (-30.0, 7.0, 7.0)
    d = np.float32([1.0, 0.0, 0.0]) + 0.02 * rng.standard_normal((sweep.LANES, 3))
    rd[:sweep.LANES] = d / np.linalg.norm(d, axis=1, keepdims=True)
    return ro, rd


def test_super_gate_lists_equal_jax_and_hits_equal_bruteforce(soup2048):
    js, ps, pack = soup2048
    ro, rd = two_pencil_rays()
    nt = ro.shape[0] // sweep.LANES
    tro, trd = torch.as_tensor(ro), torch.as_tensor(rd)
    # the gate ran and removed listed chunks
    ids_i, _, counts_i = sweep.chunk_mask(tro, trd, pack.lo, pack.hi, nt)
    lo_s, hi_s, g = sweep.super_bounds(pack.lo, pack.hi)
    sup = sweep.super_tile_mask(tro, trd, lo_s, hi_s, nt)
    listed = torch.arange(pack.n_chunks)[None] < counts_i[:, None]
    removed = listed & ~torch.gather(sup, 1, ids_i.long() // g)
    assert int(removed.sum()) > 0
    np.testing.assert_array_equal(
        sup.numpy(), np.asarray(jtrace._super_tile_mask(jnp.asarray(ro), jnp.asarray(rd),
                                                        jnp.asarray(lo_s.numpy()),
                                                        jnp.asarray(hi_s.numpy()), nt)))
    # lists, counts and entries equal JAX's exactly
    want = jtrace._chunk_mask_exact(jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(pack.lo.numpy()),
                                    jnp.asarray(pack.hi.numpy()), nt, super_gate=True)
    got = sweep.chunk_mask_exact(tro, trd, pack.lo, pack.hi, nt, super_gate=True)
    _masks_equal(got, want)
    ungated = sweep.chunk_mask_exact(tro, trd, pack.lo, pack.hi, nt)
    assert int(got[2].sum()) <= int(ungated[2].sum())
    # the swept hits equal dense f64 bruteforce
    chunk_list, entry, counts = got
    t, idx = sweep.sweep(tro, trd, pack.consts, pack.meta, chunk_list.contiguous(), counts,
                         entry.contiguous(), 1e-7, 1e-4)
    bt, bi = _brute64(ps, ro, rd)
    live = ro[:, 0] != sweep.PARK_DISTANCE
    orig = np.where(idx.numpy() >= 0, pack.perm.numpy()[np.maximum(idx.numpy(), 0)], -1)
    hit = (bi >= 0) & live
    assert 0.05 < hit[live].mean()
    np.testing.assert_array_equal(orig[live], bi[live])
    np.testing.assert_allclose(t.numpy()[hit], bt[hit], rtol=1e-5)


def test_super_gate_with_tiny_cap_keeps_far_chunks(soup2048, monkeypatch):
    """With the refinement window cut to 4 candidates the gated list still
    equals JAX's and the sweep still finds every hit (the un-refined tail is
    kept)."""
    monkeypatch.setattr(jtrace, "EXACT_GATE_CAP", 4)
    monkeypatch.setattr(sweep, "EXACT_GATE_CAP", 4)
    js, ps, pack = soup2048
    ro, rd = coherent_rays(nt=2, seed=7)
    want = jtrace._chunk_mask_exact(jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(pack.lo.numpy()),
                                    jnp.asarray(pack.hi.numpy()), 2, super_gate=True)
    got = sweep.chunk_mask_exact(torch.as_tensor(ro), torch.as_tensor(rd), pack.lo, pack.hi, 2,
                                 super_gate=True)
    _masks_equal(got, want)


@pytest.mark.parametrize("any_mode", [False, True], ids=["closest", "any"])
def test_big_scene_policy_equals_jax(soup2048, monkeypatch, any_mode):
    """EXACT_MASK_MIN_TRIS lowered to 1 in both packages: every query takes
    the exact mask behind the super gate."""
    monkeypatch.setattr(jtrace, "EXACT_MASK_MIN_TRIS", 1)
    monkeypatch.setattr(sweep, "EXACT_MASK_MIN_TRIS", 1)
    js, ps, pack = soup2048
    ro, rd = random_rays(r=1000, seed=13)
    gated = []
    real = sweep.chunk_mask_exact
    monkeypatch.setattr(sweep, "chunk_mask_exact",
                        lambda *a, super_gate=False: gated.append(super_gate) or real(
                            *a, super_gate=super_gate))
    cfg = dataclasses.replace(CFG, exact_mask_rays=0)    # only "big" can pick the exact mask
    jcfg = dataclasses.replace(JCFG, exact_mask_rays=0)
    pt, pi = sweep.closest_triangle(ps, torch.as_tensor(ro), torch.as_tensor(rd), cfg,
                                    any_mode=any_mode, pack=pack)
    assert gated == [True]
    jt, ji = jtrace.closest_triangle(js, jnp.asarray(ro), jnp.asarray(rd), jcfg,
                                     any_mode=any_mode)
    pt, pi, jt, ji = pt.numpy(), pi.numpy(), np.asarray(jt), np.asarray(ji)
    hit = ji >= 0
    assert 0.05 < hit.mean() < 0.95
    np.testing.assert_array_equal(pi >= 0, hit)
    if not any_mode:
        np.testing.assert_array_equal(pi, ji)
        bt, bi = _brute64(ps, ro, rd)
        np.testing.assert_array_equal(pi, bi)
        # the rays start inside the soup, so some hits lie at t < 0.1 while the
        # coordinates reach 26 from the origin, where one f32 ulp is 1.9e-6:
        # hence an absolute term of 4 ulps beside rtol 1e-5
        np.testing.assert_allclose(pt[hit], bt[hit], rtol=1e-5, atol=8e-6)
        np.testing.assert_allclose(pt[hit], jt[hit], rtol=1e-5, atol=8e-6)


def test_sweep_inputs_policy_by_size(soup2048, monkeypatch):
    """Below EXACT_MASK_MIN_TRIS a wide query keeps the interval mask; from it
    on, every width takes the gated exact mask."""
    js, ps, pack = soup2048
    calls = []
    for name in ("chunk_mask", "chunk_mask_exact"):
        real = getattr(sweep, name)
        monkeypatch.setattr(sweep, name, lambda *a, _n=name, _r=real, **k: calls.append(
            (_n, k.get("super_gate", False))) or _r(*a, **k))
    ro, rd = (torch.as_tensor(x) for x in random_rays(r=1024, seed=1))
    cfg = dataclasses.replace(CFG, exact_mask_rays=0)
    sweep.sweep_inputs(ro, rd, pack, cfg)
    assert calls == [("chunk_mask", False)]
    calls.clear()
    monkeypatch.setattr(sweep, "EXACT_MASK_MIN_TRIS", 2048)
    sweep.sweep_inputs(ro, rd, pack, cfg)
    assert calls[0] == ("chunk_mask_exact", True)


@pytest.mark.parametrize("n,c", [(24_576, 32), (24_577, 32), (24_576, 64), (2_048, 8),
                                 (2_048, 48), (43_008, 128)])
def test_residency_decision_equals_jax(n, c):
    rng = np.random.default_rng(n + c)
    tv = rng.uniform(-1, 1, (n, 3, 3)).astype(np.float32)
    perm = np.arange(n)
    want = jtrace._pack_for(jnp.asarray(perm), jnp.asarray(tv), c).resident
    got = sweep.pack_for(torch.as_tensor(perm), torch.as_tensor(tv), c).resident
    assert got == want
    assert got == (n <= 24_576 and c % 32 == 0)


@pytest.mark.parametrize("any_mode", [False, True], ids=["closest", "any"])
def test_blocked_twin_and_exit_positions(any_mode):
    """Walking the tiles in blocks changes nothing, bit for bit; and the
    positions a warp passes over (after its exit vote, or whose box none of
    its rays enters) leave every live lane's result unchanged. The rays are
    the close framing's primaries over the coarse mesh, so whole warps hit
    and stop early."""
    from realtrace_tpu_torch.render.pipeline import _tiled_rays
    scene, cam = scenes.mesh_scene(detail=0.25, device="cpu")
    pack = sweep.build_pack(accel.with_chunks(scene, CFG), CFG)
    ro, rd, _ = _tiled_rays(scenes.make_camera(dict(cam, position=(0.0, 6.0, 14.0)), 96, 64,
                                               device="cpu"))
    ro32, rd32, chunk_list, entry, counts = sweep.sweep_inputs(ro, rd, pack, CFG, exact_mask=False)
    assert counts.shape[0] == 6
    args = (ro32, rd32, pack.consts, pack.meta, chunk_list, counts, entry, 1e-7, 1e-4, any_mode)
    tested = torch.zeros((6, sweep.WARPS), dtype=torch.int32)
    t_all, i_all = sweep.sweep_reference(*args, tested=tested)           # exits only
    t_b = torch.zeros_like(tested)
    t_blk, i_blk = sweep.sweep_reference(*args, tested=t_b, block_tiles=4)   # blocks of 4 and 2
    assert torch.equal(t_blk, t_all) and torch.equal(i_blk, i_all) and torch.equal(t_b, tested)
    assert bool((tested <= counts[:, None]).all())
    assert int(tested.sum()) < int(counts.sum()) * sweep.WARPS      # some warp stopped early
    # without the gate a live warp tests at least the first listed position
    live_warp = (ro32[:, 0] != sweep.PARK_DISTANCE).reshape(6, sweep.WARPS, -1).any(dim=2)
    assert bool(live_warp.any(dim=1).all()) and bool((counts > 0).any())
    assert bool((tested >= (live_warp & (counts > 0)[:, None]).int()).all())
    assert bool((tested.amax(dim=1) >= counts.clamp(max=1)).all())
    gated = torch.zeros_like(tested)
    t_g, i_g = sweep.sweep_reference(*args, tested=gated, lo=pack.lo, hi=pack.hi)
    assert bool((gated <= tested).all()) and int(gated.sum()) < int(tested.sum())
    live = ro32[:, 0] != sweep.PARK_DISTANCE
    assert torch.equal(t_g[live], t_all[live]) and torch.equal(i_g[live], i_all[live])
    # a tile-wide walk of every listed position (one warp's worth of parked
    # lanes cannot stop it) gives the same live results
    full = torch.full_like(chunk_list, 0, dtype=torch.float32)
    t_f, i_f = sweep.sweep_reference(ro32, rd32, pack.consts, pack.meta, chunk_list, counts,
                                     full, 1e-7, 1e-4, any_mode)
    assert torch.equal(t_f[live], t_all[live]) and torch.equal(i_f[live], i_all[live])
    # and so does cutting every list where the tile's last warp left it
    t_cut, i_cut = sweep.sweep_reference(ro32, rd32, pack.consts, pack.meta, chunk_list,
                                         tested.amax(dim=1), entry, 1e-7, 1e-4, any_mode)
    assert torch.equal(t_cut[live], t_all[live]) and torch.equal(i_cut[live], i_all[live])


def test_copy_offsets_follow_the_reference_walk():
    """The offsets of realtrace_tpu.apps.scenes.duplicated_serial_scene for
    n = 1..10 (that function needs the bob OBJ, so its walk is repeated
    here): six frozen offsets, then ring 1 in row-major order."""
    frozen = [(0.0, 0.0), (18.0, 0.0), (0.0, 18.0), (18.0, 18.0), (-18.0, 0.0), (0.0, -18.0)]
    ring1 = [(i * 18.0, j * 18.0) for i in (-1, 0, 1) for j in (-1, 0, 1)
             if max(abs(i), abs(j)) == 1]
    walk = frozen + [c for c in ring1 if c not in frozen]
    assert walk[6:] == [(-18.0, -18.0), (-18.0, 18.0), (18.0, -18.0)]
    for n in range(1, 10):
        assert scenes.copy_offsets(n) == walk[:n]
    assert scenes.copy_offsets(10) == walk + [(-36.0, -36.0)]
    assert len(set(scenes.copy_offsets(30))) == 30


def test_duplicated_mesh_scene_copies_the_mesh():
    one, cam = scenes.mesh_scene(detail=0.2, device="cpu")
    three, cam3 = scenes.duplicated_mesh_scene(3, detail=0.2, device="cpu")
    n = one.n_triangles
    assert three.n_triangles == 3 * n and cam3 == cam
    assert torch.equal(three.tri_vertices[:n], one.tri_vertices)
    shift = three.tri_vertices[2 * n:] - one.tri_vertices
    assert torch.allclose(shift, torch.tensor([0.0, 0.0, 18.0]).expand_as(shift), atol=1e-5)
    assert torch.equal(three.tri_colors[n:2 * n], one.tri_colors)
    assert three.tri_materials.kr.shape == (3 * n,)
    assert torch.equal(scenes.duplicated_mesh_scene(1, detail=0.2, device="cpu")[0].tri_vertices,
                       one.tri_vertices)


@pytest.mark.parametrize("copies,c,m,resident,big", [
    (1, 32, 336, True, False), (2, 64, 336, True, False), (4, 128, 336, False, False),
    (8, 256, 336, False, True), (16, 256, 672, False, True)])
def test_duplicated_mesh_kernel_and_mask_by_size(copies, c, m, resident, big):
    """Which kernel and which masks each size of the duplicated mesh takes
    (10,752 triangles a copy), by the carried-over rules."""
    n = 10_752 * copies
    assert accel.effective_chunk_size(RenderConfig(accel="sweep"), n) == c
    assert jaccel.effective_chunk_size(JCFG, n) == c
    assert n == m * c
    assert (m * 4 * c * sweep.NCOEF * 4 <= sweep.RESIDENT_LIMIT and (4 * c) % 128 == 0) == resident
    assert (n >= sweep.EXACT_MASK_MIN_TRIS) == big
