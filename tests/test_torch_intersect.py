"""The port's dense intersections and hit queries against JAX ``bruteforce``
in f64, on the golden128 scene (all four families) and random rays."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracle.scene128 import build_scene128
from realtrace_tpu.core.types import RenderConfig as JConfig
from realtrace_tpu.ops import intersect as jint
from realtrace_tpu_torch.core.types import RenderConfig
from realtrace_tpu_torch.ops import intersect
from test_torch_core import few_torch_threads, to_port  # noqa: F401 (autouse fixture)

CFG = RenderConfig()
JCFG = JConfig()


@pytest.fixture(scope="module")
def scenes128():
    js = build_scene128(dtype=jnp.float64)
    return js, to_port(js)


def rays(r=600, seed=5):
    """Random rays: origins around the scene, directions biased toward it."""
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-8, 8, (r, 3)) + np.array([0.0, 3.0, 0.0])
    rd = rng.standard_normal((r, 3)) - 0.3 * ro / 8.0
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return ro, rd


def t64(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def test_primitive_tests_match_jax(scenes128):
    js, ps = scenes128
    ro, rd = rays()
    jro, jrd, pro, prd = jnp.asarray(ro), jnp.asarray(rd), t64(ro), t64(rd)
    got = intersect.triangle_test(pro, prd, ps.tri_vertices, 1e-7, 1e-4)
    want = jint.triangle_test(jro, jrd, js.tri_vertices, 1e-7, 1e-4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9, atol=1e-12)
    pairs = [
        (intersect.sphere_test(pro, prd, ps.sph_center, ps.sph_radius, 1e-4),
         jint.sphere_test(jro, jrd, js.sph_center, js.sph_radius, 1e-4)),
        (intersect.quad_test(pro, prd, ps.pln_corners, 1e-7, 1e-4),
         jint.quad_test(jro, jrd, js.pln_corners, 1e-7, 1e-4)),
        (intersect.cylinder_test(pro, prd, ps.cyl_center, ps.cyl_up, ps.cyl_radius, 1e-4),
         jint.cylinder_test(jro, jrd, js.cyl_center, js.cyl_up, js.cyl_radius, 1e-4)),
    ]
    for g, w in pairs:
        w = np.asarray(w)
        assert (w < 1e29).any()
        np.testing.assert_array_equal(g.numpy() < 1e29, w < 1e29)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-9)


def test_closest_query_and_hit_fields_match_jax(scenes128):
    js, ps = scenes128
    ro, rd = rays(seed=6)
    t, fam, idx = intersect.closest_query(ps, t64(ro), t64(rd), CFG)
    jt, jfam, jidx = jint.closest_query(js, jnp.asarray(ro), jnp.asarray(rd), JCFG)
    np.testing.assert_array_equal(fam.numpy(), np.asarray(jfam))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert len(set(fam.tolist())) == 5                      # every family and misses
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=1e-9)
    hit = intersect.hit_attributes(ps, t64(ro), t64(rd), t, fam, idx, CFG)
    jhit = jint.hit_attributes(js, jnp.asarray(ro), jnp.asarray(rd), jt, jfam, jidx, JCFG)
    for name in ("valid", "family", "index"):
        np.testing.assert_array_equal(getattr(hit, name).numpy(), np.asarray(getattr(jhit, name)))
    for name in ("t", "position", "normal", "color", "ka", "kd", "ks", "kr", "kt", "eta"):
        np.testing.assert_allclose(getattr(hit, name).numpy(), np.asarray(getattr(jhit, name)),
                                   rtol=1e-9, atol=1e-12, err_msg=name)


def test_any_hit_matches_jax(scenes128):
    js, ps = scenes128
    ro, rd = rays(seed=7)
    got = intersect.any_hit(ps, t64(ro), t64(rd), CFG)
    want = np.asarray(jint.any_hit(js, jnp.asarray(ro), jnp.asarray(rd), JCFG))
    assert want.any() and not want.all()
    np.testing.assert_array_equal(got.numpy(), want)


def test_hit_attributes_differentiable_wrt_vertices(scenes128):
    _, ps = scenes128
    ro, rd = rays(seed=8)
    tv = ps.tri_vertices.clone().requires_grad_(True)
    scene = dataclasses.replace(ps, tri_vertices=tv)
    hit = intersect.closest_hit(scene, t64(ro), t64(rd), CFG)
    tri = hit.family == intersect.FAM_TRI
    assert tri.any()
    (hit.position[tri].sum() + hit.color[tri].sum()).backward()
    assert torch.isfinite(tv.grad).all() and tv.grad.abs().sum() > 0
