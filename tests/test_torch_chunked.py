"""The approximate ``chunked`` accel of the port against the JAX package's, on
the CPU in f64: the shortlist query's indices equal JAX's exactly, under a
shortlist that drops chunks; a render whose shortlist holds every chunk
equals JAX's; the apps warn; a train step re-sorts the chunks.

Renders with a shortlist that drops chunks are compared only at the query:
past level 0 the two packages form their secondary queries differently (JAX's
static capacities with parked tiles, the port's dynamic compaction), so their
ray blocks, and with them the shortlists, differ."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtrace_tpu.apps import scenes as jscenes
from realtrace_tpu.core.types import RenderConfig as JConfig
from realtrace_tpu.ops import accel as jaccel
from realtrace_tpu.render.pipeline import render_with_stats as jrender_with_stats
from realtrace_tpu_torch.apps import cli, scenes
from realtrace_tpu_torch.core import vec
from realtrace_tpu_torch.core.convert import config_from_dict
from realtrace_tpu_torch.core.types import RenderConfig, SceneBuilder
from realtrace_tpu_torch.diff.inverse import make_train_step
from realtrace_tpu_torch.ops import accel
from realtrace_tpu_torch.ops.intersect import BIG, triangle_test
from realtrace_tpu_torch.render.camera import Camera
from realtrace_tpu_torch.render.pipeline import render_with_stats
from test_torch_bench_jax import to_jax
from test_torch_core import few_torch_threads  # noqa: F401 (autouse fixture)
from test_torch_render import assert_images_match

F64 = torch.float64
# tests/test_accel.py's truncating settings: 9 chunks, 8 on a block's shortlist
TRUNCATING = dict(accel="chunked", chunk_size=32, shortlist=8, ray_block=64)


def random_tri_scene(n=257, seed=3, spread=0.8):
    """tests/test_accel.py's random triangle soup, built by the port."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder(dtype=F64, device="cpu")
    for ctr in rng.uniform(-10, 10, (n, 3)):
        tri = ctr + rng.uniform(-spread, spread, (3, 3))
        b.add_triangle(tri[0], tri[1], tri[2], color=tuple(rng.uniform(0, 1, 3)))
    b.add_light((0, 30, 30), (1, 1, 1))
    b.background = (0.1, 0.3, 0.6)
    b.ambient = (1, 1, 1)
    return b.build()


def random_rays(r, seed=11):
    rng = np.random.default_rng(seed)
    return (torch.as_tensor(rng.uniform(-15, 15, (r, 3)), dtype=F64),
            vec.normalize(torch.as_tensor(rng.standard_normal((r, 3)), dtype=F64)))


def jax_with_perm(scene):
    """The port scene as a JAX scene with the port's chunk permutation."""
    return to_jax(scene).replace(tri_chunk_perm=jnp.asarray(scene.tri_chunk_perm.numpy(),
                                                            jnp.int32))


@pytest.mark.parametrize("rays,block,shortlist", [(300, 64, 8), (200, 128, 2)],
                         ids=["300-block64-top8", "200-block128-top2"])
def test_chunked_query_equals_jax_under_a_truncating_shortlist(rays, block, shortlist):
    """The last block is padded with copies of its last ray, which vote; a
    vote tie goes to the lower chunk. Indices equal, distances within 1e-12.
    A hit is never nearer than brute force's, and with 2 of 9 chunks on the
    shortlist some hits are dropped."""
    knobs = dict(TRUNCATING, ray_block=block, shortlist=shortlist)
    cfg, jcfg = RenderConfig(**knobs), JConfig(**knobs)
    scene = accel.with_chunks(random_tri_scene(), cfg)
    jscene = jax_with_perm(scene)
    ro, rd = random_rays(rays)
    t, idx = accel.closest_triangle(scene, ro, rd, cfg)
    jt, jidx = jaccel.closest_triangle(jscene, jnp.asarray(ro.numpy()), jnp.asarray(rd.numpy()),
                                       jcfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=0, atol=1e-12)
    occ = accel.any_triangle(scene, ro, rd, cfg)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(
        jaccel.any_triangle(jscene, jnp.asarray(ro.numpy()), jnp.asarray(rd.numpy()), jcfg)))
    tb, _, _ = triangle_test(ro, rd, scene.tri_vertices, cfg.det_epsilon, cfg.smallest_dist)
    best = tb.amin(dim=1)
    assert bool((best < BIG).any()) and bool((t >= best - 1e-9).all())
    assert (int((t > best + 1e-9).sum()) > 0) == (shortlist == 2)


def test_chunked_batches_blocks_without_changing_them(monkeypatch):
    """Several blocks run in one batch; one block a batch gives the same bits."""
    cfg = RenderConfig(**TRUNCATING)
    scene = accel.with_chunks(random_tri_scene(), cfg)
    ro, rd = random_rays(300)
    batched = accel.closest_triangle(scene, ro, rd, cfg)
    monkeypatch.setattr(accel, "CHUNKED_BATCH_PAIRS", 1)
    single = accel.closest_triangle(scene, ro, rd, cfg)
    assert torch.equal(batched[0], single[0]) and torch.equal(batched[1], single[1])


def test_chunked_render_with_every_chunk_shortlisted_equals_jax():
    """mesh_scene reduced to 440 triangles is 14 chunks of 32: a shortlist of
    96 holds them all, so the chunked render is exact and equals JAX's."""
    scene, cam = scenes.mesh_scene(detail=0.2, dtype=F64, device="cpu")
    cfg = config_from_dict(dict(max_depth=3, accel="chunked", ray_block=512))
    scene = accel.with_chunks(scene, cfg)
    assert scene.tri_chunk_perm.numel() // cfg.chunk_size <= cfg.shortlist
    got, n = render_with_stats(scene, scenes.make_camera(cam, 48, 32, dtype=F64, device="cpu"),
                               cfg)
    want, jn = jrender_with_stats(jax_with_perm(scene),
                                  jscenes.make_camera(cam, 48, 32, dtype=jnp.float64),
                                  JConfig(max_depth=3, accel="chunked", ray_block=512))
    assert_images_match(got.numpy(), np.asarray(want))
    assert n == int(jn)


@pytest.mark.parametrize("which", ["morton_host", "morton_device", "split_host"])
def test_chunk_orderings_equal_jax(which):
    """The superseded Morton orderings and the median split's host form equal
    the JAX package's (the split's host form also the port's device build)."""
    tv = random_tri_scene(100).tri_vertices
    jtv = jnp.asarray(tv.numpy())
    if which == "morton_host":
        got, want = accel.build_chunk_perm(tv.numpy(), 64), jaccel.build_chunk_perm(jtv, 64)
    elif which == "morton_device":
        got, want = accel.chunk_perm_device(tv, 64).numpy(), jaccel.chunk_perm_device(jtv, 64)
    else:
        got, want = accel.build_chunk_perm_split(tv.numpy(), 32), \
            jaccel.build_chunk_perm_split(jtv, 32)
        np.testing.assert_array_equal(got, accel.chunk_perm_split(tv, 32).numpy())
    assert got.shape == (128,)                    # 100 triangles padded to whole chunks
    np.testing.assert_array_equal(got, np.asarray(want))


def test_cli_chunked_warns(tmp_path, capsys):
    out = tmp_path / "chunked.png"
    assert cli.main(["--scene", "sphere_plane", "--width", "16", "--height", "12", "--depth",
                     "1", "--accel", "chunked", "--device", "cpu", "--out", str(out)]) == 0
    assert "accel='chunked' is APPROXIMATE" in capsys.readouterr().err
    assert out.exists()


def test_default_exact_accel():
    assert accel.default_exact_accel("cpu") == "bruteforce"
    assert accel.default_exact_accel("cuda") == "sweep"
    assert accel.default_exact_accel() == "sweep"      # the card, the default device


def test_chunked_train_step_resorts_chunks(monkeypatch):
    """tests/test_accel.py's chunked train step: vertices and colours of a
    64-triangle soup, chunk 16, shortlist 4, depth 1; the step re-sorts the
    chunks every time (any accel but brute force), the loss stays finite and
    falls over three steps."""
    cfg = RenderConfig(accel="chunked", chunk_size=16, shortlist=4, ray_block=256, max_depth=1)
    scene = accel.with_chunks(random_tri_scene(64, seed=9), cfg)
    camera = Camera.make((0, 0, 30), (0, 0, 0), (0, 1, 0), 45.0, 16, 16, dtype=F64,
                         device="cpu")
    resorts = []
    real = accel.resort_chunks
    monkeypatch.setattr(accel, "resort_chunks", lambda s, c: resorts.append(1) or real(s, c))
    step, params, _ = make_train_step(scene, camera, cfg, torch.zeros((16 * 16, 3), dtype=F64),
                                      fields=("tri_vertices", "tri_colors"))
    losses = [float(step()) for _ in range(3)]
    assert len(resorts) == 3
    assert np.isfinite(losses).all() and losses[-1] <= losses[0]
    assert make_train_step(scene, camera, dataclasses.replace(cfg, accel="bruteforce"),
                           torch.zeros((16 * 16, 3), dtype=F64),
                           fields=("tri_vertices",))[0]() is not None
    assert len(resorts) == 3                      # brute force does not re-sort
