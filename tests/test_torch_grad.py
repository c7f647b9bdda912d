"""The port's backward pass on the CPU, in f64: every ``DIFF_FIELDS``
gradient of ``image_grad`` against the JAX package's ``image_grad`` (each
leaf allclose with rtol 1e-7 and atol 1e-10 x its largest |g|) on four
scenes, against central finite differences as in tests/test_grad.py, the
rematerialised backward against the plain autograd graph (bit for bit, and
what each keeps for the backward), and the backward's queries (none)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtrace_tpu.apps import scenes as jscenes
from realtrace_tpu.core.types import RenderConfig as JConfig
from realtrace_tpu.core.types import SceneBuilder as JBuilder
from realtrace_tpu.diff.inverse import image_grad as jimage_grad
from realtrace_tpu.ops import intersect as jint
from realtrace_tpu.render import pipeline as jpipeline
from realtrace_tpu.render.shade import trace_wavefront as jtrace_wavefront
from realtrace_tpu_torch.apps import scenes
from realtrace_tpu_torch.core.convert import config_from_dict, params_to_numpy
from realtrace_tpu_torch.core.types import (RenderConfig, SceneBuilder, map_tensors,
                                            tensor_leaves)
from realtrace_tpu_torch.diff.inverse import DIFF_FIELDS, apply_params, image_grad, scene_params
from realtrace_tpu_torch.ops import accel, intersect, sweep
from realtrace_tpu_torch.render import pipeline, shade
from realtrace_tpu_torch.render.pipeline import render_buffer
from test_torch_core import few_torch_threads, to_port  # noqa: F401 (autouse fixture)

F64 = torch.float64
DEPTH = 2
MESH_DETAIL = 0.25     # the coarse mesh: 672 triangles, 21 chunks of 32
TRI_CAM = dict(position=(0, 0, 12), target=(0, 0, 0), up=(0, 1, 0), fovy=45)


def flat(tree: dict) -> dict:
    """``params_to_numpy`` output as {"field" or "field.key": array}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{k}.{kk}": vv for kk, vv in v.items()})
        else:
            out[k] = v
    return out


def assert_grads_match(got: dict, want: dict):
    """Each leaf allclose: rtol 1e-7, atol 1e-10 x the leaf's largest |g|."""
    got, want = flat(params_to_numpy(got)), flat(params_to_numpy(want))
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        if w.size:
            np.testing.assert_allclose(g, w, rtol=1e-7, atol=1e-10 * np.abs(w).max(), err_msg=k)


def triangle_jscene():
    """tests/test_grad.py's vertex-coloured triangle."""
    b = JBuilder(dtype=jnp.float64)
    b.ambient = (1, 1, 1)
    b.background = (0.1, 0.3, 0.6)
    b.add_triangle((-3, -2, 0), (3, -2, 0), (0, 3, 0),
                   vertex_colors=((1, 0, 0), (0, 1, 0), (0, 0, 1)))
    b.add_light((0, 5, 10), (1, 1, 1))
    return b.build()


def mesh_jscene():
    """The port's coarse ``mesh_scene`` built with the JAX package."""
    tv, tc = scenes.mesh_arrays(seed=0, detail=MESH_DETAIL)
    b = JBuilder(dtype=jnp.float64)
    b.ambient, b.background = (1.0, 1.0, 1.0), (0.1, 0.3, 0.6)
    b.add_light((0, 30, 30), (0.5, 1.0, 1.0))
    mat = b.material(ka=0.2, kd=0.9, ks=0.4, kr=0.4, kt=0.0, eta=3.0)
    for tri, col in zip(15.0 * tv, tc):
        b.add_triangle(tri[0], tri[1], tri[2], vertex_colors=col, material=mat)
    return b.build()


# name: (JAX scene, camera dict, width, height, the port's accel, depth, the
# fields that must take a nonzero gradient). full_primitive_scene takes the
# branching wavefront; its depth is 1 (the glass's children are queried and
# shaded) because the JAX branching gradient compiles 4x slower at depth 2.
CASES = {
    "sphere_plane": (lambda: jscenes.sphere_plane_scene(dtype=jnp.float64)[0],
                     scenes.SERIAL_CAM, 24, 18, "bruteforce", 2, ("sph_center", "pln_corners")),
    "triangle": (triangle_jscene, TRI_CAM, 24, 24, "bruteforce", 2, ("tri_vertices",)),
    "full_primitive": (lambda: jscenes.full_primitive_scene(dtype=jnp.float64)[0],
                       scenes.SERIAL_CAM, 48, 32, "bruteforce", 1, ("cyl_center", "sph_center")),
    "mesh_sweep": (mesh_jscene, scenes.SERIAL_CAM, 32, 24, "sweep", 3, ("tri_vertices",)),
}


@pytest.fixture(scope="module")
def jax_grads():
    """Per case: the JAX scene and its (loss, grads), computed once (a JAX
    f64 gradient takes 5-30 s to compile on the CPU). JAX renders bruteforce."""
    cache = {}

    def get(name):
        if name not in cache:
            make, cam, w, h, _, depth, _ = CASES[name]
            jscene = make()
            jcam = jscenes.make_camera(cam, w, h, dtype=jnp.float64)
            loss, grads = jimage_grad(jscene, jcam, JConfig(max_depth=depth))
            cache[name] = jscene, float(loss), grads
        return cache[name]
    return get


def port_case(name, jscene):
    _, cam, w, h, mode, depth, _ = CASES[name]
    cfg = RenderConfig(max_depth=depth, accel=mode)
    scene = to_port(jscene, dtype=F64)
    if mode == "sweep":
        scene = accel.with_chunks(scene, cfg)
    return scene, scenes.make_camera(cam, w, h, dtype=F64, device="cpu"), cfg


@pytest.mark.parametrize("name", list(CASES))
def test_image_grad_equals_jax(jax_grads, name):
    jscene, jloss, jgrads = jax_grads(name)
    scene, camera, cfg = port_case(name, jscene)
    if name == "full_primitive":
        # the branching wavefront, and the JAX one dropped no child at its capacity
        assert scene.has_dielectrics()
        ro, rd, coeff, _ = jpipeline._tiled_rays(
            jscenes.make_camera(CASES[name][1], camera.width, camera.height, dtype=jnp.float64))
        stats = {}
        jtrace_wavefront(jscene, ro, rd, JConfig(max_depth=cfg.max_depth), branching=True,
                         coeff=coeff, debug_stats=stats)
        assert float(stats["dropped_children_coeff"]) == 0.0
    if name == "mesh_sweep":
        # the sweep (on the CPU, the twin) and JAX bruteforce select the same primary hits
        ro, rd, _ = pipeline._tiled_rays(camera)
        hit = intersect.closest_hit(scene, ro, rd, cfg)
        jhit = jint.closest_hit(jscene, jnp.asarray(ro.numpy()), jnp.asarray(rd.numpy()),
                                JConfig())
        np.testing.assert_array_equal(hit.index.numpy(), np.asarray(jhit.index))
        assert int((hit.index >= 0).sum()) > 50
    loss, grads = image_grad(scene, camera, cfg)
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-12)
    assert_grads_match(grads, jgrads)
    for f in CASES[name][-1]:
        assert bool(grads[f].abs().max() > 0), f


def fd_check(scene, camera, cfg, field, sub, eps=1e-5, rtol=5e-3, atol=1e-8):
    """Central finite difference of the mean pixel on one scalar of one field
    (``sub``: an index, or (key, index) into Materials / Lights) against the
    port's gradient."""
    _, grads = image_grad(scene, camera, cfg)

    def loss_at(delta):
        p = scene_params(scene)
        if isinstance(sub[0], str):
            key, i = sub
            leaf = getattr(p[field], key).clone()
            leaf[i] += delta
            p[field] = dataclasses.replace(p[field], **{key: leaf})
        else:
            leaf = p[field].clone()
            leaf[sub] += delta
            p[field] = leaf
        return float(torch.mean(render_buffer(apply_params(scene, p), camera, cfg)))

    fd = (loss_at(eps) - loss_at(-eps)) / (2 * eps)
    g = grads[field]
    ad = float(getattr(g, sub[0])[sub[1]] if isinstance(sub[0], str) else g[sub])
    np.testing.assert_allclose(ad, fd, rtol=rtol, atol=atol)
    return ad


def port_triangle_scene():
    b = SceneBuilder(dtype=F64, device="cpu")
    b.ambient = (1, 1, 1)
    b.background = (0.1, 0.3, 0.6)
    b.add_triangle((-3, -2, 0), (3, -2, 0), (0, 3, 0),
                   vertex_colors=((1, 0, 0), (0, 1, 0), (0, 0, 1)))
    b.add_light((0, 5, 10), (1, 1, 1))
    return b.build(), scenes.make_camera(TRI_CAM, 24, 24, dtype=F64, device="cpu")


@pytest.mark.parametrize("field,sub", [
    ("sph_center", (0, 1)), ("sph_radius", (0,)), ("sph_color", (0, 0)),
    ("sph_materials", ("kd", 0)), ("lights", ("intensity", (0, 1))), ("background", (2,)),
], ids=["sph_center", "sph_radius", "sph_color", "sph_kd", "light_intensity", "background"])
def test_grad_equals_finite_difference_sphere_plane(field, sub):
    scene, cam = scenes.sphere_plane_scene(dtype=F64, device="cpu")
    ad = fd_check(scene, scenes.make_camera(cam, 24, 18, dtype=F64, device="cpu"),
                  RenderConfig(max_depth=DEPTH), field, sub)
    assert ad != 0.0


@pytest.mark.parametrize("field,sub", [("tri_vertices", (0, 2, 1)), ("tri_colors", (0, 1, 1))],
                         ids=["vertex", "vertex_color"])
def test_grad_equals_finite_difference_triangle(field, sub):
    scene, camera = port_triangle_scene()
    ad = fd_check(scene, camera, RenderConfig(max_depth=DEPTH), field, sub)
    assert ad != 0.0


def mesh_case(size=64, make=scenes.mesh_scene):
    cfg = RenderConfig(max_depth=3, accel="sweep")
    scene, cam = make(detail=MESH_DETAIL, dtype=F64, device="cpu")
    return (accel.with_chunks(scene, cfg), scenes.make_camera(cam, size, size, dtype=F64,
                                                              device="cpu"), cfg)


FIELDS = ("tri_vertices", "tri_colors", "tri_materials", "lights")


def saved_bytes(scene, camera, cfg, monkeypatch):
    """Bytes the backward keeps of a 64x64 frame: the distinct storages of
    every tensor autograd saves (``saved_tensors_hooks``) and, with remat,
    every tensor a checkpointed region holds as its input (inside a region
    the checkpoint's own hooks take the saves). Also the gradients."""
    seen = {}

    def pack(x):
        seen[x.untyped_storage().data_ptr()] = x.untyped_storage().nbytes()
        return x

    real = shade.checkpoint

    def counting_checkpoint(fn, *args, **kw):
        for a in args:
            if isinstance(a, torch.Tensor):
                pack(a)
        return real(fn, *args, **kw)

    monkeypatch.setattr(shade, "checkpoint", counting_checkpoint)
    p = map_tensors(lambda x: x.detach().requires_grad_(True), scene_params(scene, FIELDS))
    leaves = tensor_leaves(p)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        loss = torch.mean(render_buffer(apply_params(scene, p), camera, cfg))
    grads = torch.autograd.grad(loss, leaves)
    monkeypatch.undo()
    return sum(seen.values()), grads


@pytest.mark.parametrize("make", [scenes.mesh_scene, scenes.glass_mesh_scene],
                         ids=["mesh", "glass-branching"])
def test_remat_equals_plain_graph_and_keeps_a_quarter(monkeypatch, make):
    scene, camera, cfg = mesh_case(make=make)
    on, g_on = saved_bytes(scene, camera, cfg, monkeypatch)
    off, g_off = saved_bytes(scene, camera, dataclasses.replace(cfg, remat=False), monkeypatch)
    for a, b in zip(g_on, g_off):
        assert torch.equal(a, b)
    assert any(bool(g.abs().max() > 0) for g in g_on)
    assert on <= off / 4, (on, off)


def test_backward_runs_no_query(monkeypatch):
    """The forward queries; the backward (remat recomputation included)
    calls neither ``sweep.sweep`` nor a query."""
    scene, camera, cfg = mesh_case(size=32)
    calls = {"sweep": 0, "closest": 0, "any": 0}
    real_sweep, real_closest, real_any = sweep.sweep, shade.closest_query, shade.any_hit

    def counted(name, fn):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(sweep, "sweep", counted("sweep", real_sweep))
    monkeypatch.setattr(shade, "closest_query", counted("closest", real_closest))
    monkeypatch.setattr(shade, "any_hit", counted("any", real_any))
    params = {f: x.detach().requires_grad_(True)
              for f, x in scene_params(scene, ("tri_vertices", "tri_colors")).items()}
    loss = torch.mean(render_buffer(apply_params(scene, params), camera, cfg))
    forward = dict(calls)
    assert forward["sweep"] == forward["closest"] + forward["any"] >= 2 * cfg.max_depth
    loss.backward()
    assert calls == forward
    assert bool(params["tri_vertices"].grad.abs().max() > 0)


def test_backward_is_bit_identical_twice():
    scene, camera, cfg = mesh_case(size=32)
    a = image_grad(scene, camera, cfg, fields=FIELDS)[1]
    b = image_grad(scene, camera, cfg, fields=FIELDS)[1]
    for x, y in zip(flat(params_to_numpy(a)).values(), flat(params_to_numpy(b)).values()):
        np.testing.assert_array_equal(x, y)


def test_image_grad_fields_and_loss_fn():
    """``fields`` picks the sub-dict; ``loss_fn`` sees the flat buffer."""
    scene, cam = scenes.sphere_plane_scene(dtype=F64, device="cpu")
    camera = scenes.make_camera(cam, 16, 12, dtype=F64, device="cpu")
    cfg = RenderConfig(max_depth=1)
    loss, grads = image_grad(scene, camera, cfg, loss_fn=lambda b: b[:, 0].sum(),
                             fields=("sph_color", "lights"))
    assert set(grads) == {"sph_color", "lights"}
    assert grads["lights"].intensity.shape == (1, 3)
    buf = render_buffer(scene, camera, cfg)
    assert buf.shape == (16 * 12, 3)
    np.testing.assert_allclose(float(loss), float(buf[:, 0].sum()), rtol=1e-12)
    assert float(grads["sph_color"][0, 1]) == 0.0 and float(grads["sph_color"][0, 0]) > 0.0
    assert set(DIFF_FIELDS) >= set(grads)
    assert config_from_dict(dataclasses.asdict(JConfig(remat=False))).remat is False
