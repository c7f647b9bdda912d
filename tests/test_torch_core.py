"""The PyTorch port's core against the JAX package: vectors, scene schema and
conversion, camera rays, image and OBJ IO. CPU only; inputs from numpy."""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtrace_tpu.apps import scenes as jscenes
from realtrace_tpu.core import vec as jvec
from realtrace_tpu.core.types import Materials as JMaterials
from realtrace_tpu.core.types import RenderConfig as JConfig
from realtrace_tpu.core.types import SceneBuilder as JBuilder
from realtrace_tpu.io import image as jimage
from realtrace_tpu.io.obj import load_obj_scene as jload_obj
from realtrace_tpu_torch.apps import scenes
from realtrace_tpu_torch.core import vec
from realtrace_tpu_torch.core.convert import config_from_dict, scene_from_numpy, scene_to_numpy
from realtrace_tpu_torch.core.types import Materials, RenderConfig, SceneBuilder
from realtrace_tpu_torch.io import image
from realtrace_tpu_torch.io.image import load_png, save_png
from realtrace_tpu_torch.io.obj import load_obj_scene

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """The suite runs in several worker processes on one machine. With every
    worker's torch at the full thread count, the loops of small ops (the
    sweep's twin, the chunk masks) spend their time waiting at thread
    barriers; two threads a worker keep them near their single-process speed."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def to_port(jax_scene, dtype=None):
    """The JAX scene's leaves as numpy, loaded into the port's Scene."""
    return scene_from_numpy(scene_to_numpy(jax_scene), dtype=dtype, device="cpu")


def t64(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def test_vec_matches_jax_including_zero_vectors():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((64, 3))
    a[:4] = 0.0                                    # dead lanes stay zero
    b = rng.standard_normal((64, 3))
    eta = rng.uniform(0.3, 2.0, 64)
    cases = [
        (vec.normalize(t64(a)), jvec.normalize(jnp.asarray(a))),
        (vec.cross(t64(a), t64(b)), jnp.cross(a, b)),
        (vec.reflect(t64(a), t64(b)), jvec.reflect(jnp.asarray(a), jnp.asarray(b))),
        (vec.refract(vec.normalize(t64(a)), vec.normalize(t64(b)), t64(eta))[0],
         jvec.refract(jvec.normalize(jnp.asarray(a)), jvec.normalize(jnp.asarray(b)),
                      jnp.asarray(eta))[0]),
    ]
    for got, want in cases:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)
    assert torch.all(vec.normalize(t64(a))[:4] == 0)


VEC_FNS = {
    "length": lambda m, a, b, c: m.length(a),
    "det3": lambda m, a, b, c: m.det3(a, b, c),
    "distance": lambda m, a, b, c: m.distance(a, b),
    "normalize": lambda m, a, b, c: m.normalize(a),
    "normalize_eps": lambda m, a, b, c: m.normalize(a, eps=1e-3),
}


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-6), (np.float64, 1e-12)],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("fn", sorted(VEC_FNS))
def test_vec_functions_match_jax(fn, dtype, tol):
    """length, det3, distance and normalize (with and without the eps floor)
    on seeded inputs whose first rows are zero vectors and whose next rows are
    shorter than the floor."""
    rng = np.random.default_rng(1)
    a, b, c = (rng.standard_normal((4, 16, 3)).astype(dtype) for _ in range(3))
    a[0, :4] = 0.0
    b[0, :2] = 0.0
    a[0, 4:8] *= 1e-3
    got = VEC_FNS[fn](vec, torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c))
    want = np.asarray(VEC_FNS[fn](jvec, jnp.asarray(a), jnp.asarray(b), jnp.asarray(c)))
    assert got.numpy().dtype == want.dtype
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
    if fn.startswith("normalize"):
        assert torch.all(got[0, :4] == 0)


def test_normalize_and_refract_grads_finite_on_dead_lanes():
    x = torch.zeros((3, 3), dtype=torch.float64, requires_grad=True)
    vec.normalize(x).sum().backward()
    assert torch.isfinite(x.grad).all()
    n = torch.tensor([[0.0, 1.0, 0.0]], dtype=torch.float64)
    i = torch.tensor([[1.0, 0.0, 0.0]], dtype=torch.float64, requires_grad=True)
    t, ok = vec.refract(i, n, torch.tensor([1.0], dtype=torch.float64))   # k == 0
    t.sum().backward()
    assert torch.isfinite(i.grad).all() and bool(ok[0])


def test_scene_roundtrip_through_numpy_matches_jax_builder():
    jscene, _ = jscenes.full_primitive_scene(dtype=jnp.float64)
    d = scene_to_numpy(jscene)
    scene = scene_from_numpy(d, device="cpu")
    assert scene.dtype == torch.float64
    assert (scene.n_triangles, scene.n_spheres, scene.n_planes, scene.n_cylinders) == (1, 1, 1, 1)
    back = scene_to_numpy(scene)
    for k, v in d.items():
        if isinstance(v, dict):
            for kk in v:
                np.testing.assert_array_equal(back[k][kk], v[kk])
        elif v is not None:
            np.testing.assert_array_equal(back[k], v)


def test_builder_matches_jax_builder():
    def fill(b):
        b.ambient = (1.0, 0.5, 0.25)
        b.background = (0.1, 0.3, 0.6)
        b.add_triangle((0, 0, 0), (1, 0, 0), (0, 1, 0), vertex_colors=((1, 0, 0), (0, 1, 0),
                                                                      (0, 0, 1)))
        b.add_sphere((1, 2, 3), 0.5, material=b.material(kr=0.3))
        b.add_plane((0, 0, 0), (1, 0, 0), (1, 0, 1), (0, 0, 1))
        b.add_cylinder((0, 1, 0), (0, 0, 1), 0.25)
        b.add_light((0, 30, 30), (1, 1, 1))
        return b.build()

    want = scene_to_numpy(fill(JBuilder(dtype=jnp.float64)))
    got = scene_to_numpy(fill(SceneBuilder(dtype=torch.float64, device="cpu")))
    for k, v in want.items():
        if isinstance(v, dict):
            for kk in v:
                np.testing.assert_array_equal(got[k][kk], v[kk])
        elif v is not None:
            np.testing.assert_array_equal(got[k], v)


@pytest.mark.parametrize("dtype,jdtype", [(torch.float32, jnp.float32),
                                         (torch.float64, jnp.float64)], ids=["f32", "f64"])
def test_materials_defaults_equal_jax(dtype, jdtype):
    for port, jax_ in ((Materials.default, JMaterials.default),
                       (Materials.obj_default, JMaterials.obj_default)):
        got, want = port(5, dtype, "cpu"), jax_(5, jdtype)
        for k in ("ka", "kd", "ks", "kr", "kt", "eta"):
            assert getattr(got, k).dtype == dtype
            np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)))


def test_has_dielectrics_reads_the_tensors():
    scene, _ = scenes.sphere_plane_scene(device="cpu")
    assert not scene.has_dielectrics()
    m = scene.sph_materials
    glass = dataclasses.replace(m, kr=torch.ones_like(m.kr), kt=torch.ones_like(m.kt))
    assert dataclasses.replace(scene, sph_materials=glass).has_dielectrics()


def test_config_from_dict_maps_jax_fields():
    cfg = config_from_dict(dataclasses.asdict(JConfig(accel="pallas", max_depth=4)))
    assert cfg == RenderConfig(accel="sweep", max_depth=4)
    knobs = dict(accel="chunked", merge_queries=False, shadow_any_mode=False, shortlist=12,
                 ray_block=256)
    assert config_from_dict(dataclasses.asdict(JConfig(**knobs))) == RenderConfig(**knobs)
    with pytest.raises(ValueError):
        RenderConfig(accel="bogus")


@pytest.mark.parametrize("w,h", [(64, 48), (33, 17)])
def test_camera_rays_match_jax_f64(w, h):
    cam = dict(position=(10.0, 6.0, 10.0), target=(0.0, 0.5, 0.0), up=(0.0, 1.0, 0.0),
               fovy=45.0)
    jcam = jscenes.make_camera(cam, w, h, dtype=jnp.float64)
    pcam = scenes.make_camera(cam, w, h, dtype=torch.float64, device="cpu")
    np.testing.assert_allclose(pcam.ray_directions().numpy(),
                               np.asarray(jcam.ray_directions()), rtol=0, atol=1e-12)
    rng = np.random.default_rng(1)
    ii, jj = rng.integers(0, w, 100), rng.integers(0, h, 100)
    np.testing.assert_allclose(pcam.ray_directions_at(ii, jj).numpy(),
                               np.asarray(jcam.ray_directions_at(ii, jj)), rtol=0, atol=1e-12)
    for got, want in zip(pcam.basis(), jcam.basis()):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)


def test_png_roundtrip(tmp_path):
    img = np.random.default_rng(2).uniform(0, 1, (5, 7, 3))
    path = save_png(tmp_path / "x.png", img)
    back = load_png(path)
    assert back.shape == (5, 7, 3)
    np.testing.assert_allclose(back, np.floor(img * 255.0) / 255.0, atol=1e-12)


def test_save_timestamped_png_matches_jax(tmp_path, monkeypatch):
    """The SaveImage name format with a fixed clock: the port and the JAX
    package write the same file name and the same pixels."""
    stamp = "Mon Jan 05 14-03-09 2026"
    monkeypatch.setattr(image.time, "strftime", lambda fmt: stamp)
    monkeypatch.setattr(jimage.time, "strftime", lambda fmt: stamp)
    img = np.random.default_rng(4).uniform(0, 1, (6, 9, 3))
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got = image.save_timestamped_png(img, directory=tmp_path / "port")
    want = jimage.save_timestamped_png(img, directory=tmp_path / "jax")
    assert got.name == want.name == f"RealTraceTPU {stamp}.png"
    decoded = [np.round(load_png(p) * 255.0).astype(np.uint8) for p in (got, want)]
    np.testing.assert_array_equal(decoded[0], decoded[1])
    np.testing.assert_array_equal(decoded[0], image.to_uint8(img))
    assert image.save_timestamped_png(img, "Frame", tmp_path).name == f"Frame {stamp}.png"


def test_obj_loader_matches_jax_loader(tmp_path):
    obj = tmp_path / "quad.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nvt 0 0\nvt 1 0\nvt 1 1\n"
                   "vn 0 0 1\nf 1/1/1 2/2/1 3/3/1\nf 1/1/1 3/3/1 4//1\n")
    tex = tmp_path / "tex.png"
    save_png(tex, np.random.default_rng(3).uniform(0, 1, (4, 4, 3)))
    jb, pb = JBuilder(dtype=jnp.float64), SceneBuilder(dtype=torch.float64, device="cpu")
    jload_obj(jb, obj, texture_path=tex, scale=2.0)
    load_obj_scene(pb, obj, texture_path=tex, scale=2.0)
    want, got = scene_to_numpy(jb.build()), scene_to_numpy(pb.build())
    for k in ("tri_vertices", "tri_colors"):
        np.testing.assert_array_equal(got[k], want[k])
    for k, v in want["tri_materials"].items():
        np.testing.assert_array_equal(got["tri_materials"][k], v)


def test_import_leaves_jax_out():
    code = ("import sys, realtrace_tpu_torch, realtrace_tpu_torch.apps.cli, "
            "realtrace_tpu_torch.apps.scenes, realtrace_tpu_torch.core.convert; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'realtrace_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
