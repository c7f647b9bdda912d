"""The port's OBJ scenes against the JAX package: ``serial_obj_scene``'s
default asset, ``duplicated_serial_scene`` (the JAX bench's big scene) and
``glass_bob_scene`` (its branching scene), on an OBJ with texture
coordinates and a texture that the test writes. The JAX functions read their
asset folder from ``realtrace_tpu.apps.scenes.REFERENCE_ASSETS``, which the
tests point at that folder; the port reads ``$REALTRACE_ASSETS``. CPU only."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import realtrace_tpu.apps.scenes as jscenes
from realtrace_tpu.core.types import RenderConfig as JConfig
from realtrace_tpu.render.pipeline import render_with_stats as jrender_with_stats
from realtrace_tpu_torch.apps import scenes
from realtrace_tpu_torch.core.convert import scene_to_numpy
from realtrace_tpu_torch.core.types import RenderConfig
from realtrace_tpu_torch.io.image import save_png
from realtrace_tpu_torch.ops import accel
from realtrace_tpu_torch.render.pipeline import render_with_stats
from test_torch_core import few_torch_threads  # noqa: F401 (autouse fixture)
from test_torch_render import assert_images_match

F64 = torch.float64
SIZE, DEPTH = 32, 3


def write_textured_obj(folder):
    """``mesh_arrays(detail=0.2)`` (unscaled) as ``bob_tri.obj`` with one
    ``vt`` per vertex and ``f v/vt`` faces, and a 6x5 ``bob_diffuse.png``."""
    tv, _ = scenes.mesh_arrays(detail=0.2)
    uv = np.random.default_rng(5).uniform(0, 1, (tv.shape[0] * 3, 2))
    lines = ["v {:.17g} {:.17g} {:.17g}".format(*p) for p in tv.reshape(-1, 3)]
    lines += ["vt {:.17g} {:.17g}".format(*t) for t in uv]
    lines += [f"f {k}/{k} {k + 1}/{k + 1} {k + 2}/{k + 2}" for k in range(1, 3 * len(tv), 3)]
    (folder / "bob_tri.obj").write_text("\n".join(lines) + "\n")
    save_png(folder / "bob_diffuse.png", np.random.default_rng(6).uniform(0, 1, (5, 6, 3)))
    return len(tv)


@pytest.fixture
def assets(tmp_path, monkeypatch):
    """The folder holding the written OBJ and texture, as the asset folder of
    both packages: (folder, triangles of one copy)."""
    n = write_textured_obj(tmp_path)
    monkeypatch.setattr(jscenes, "REFERENCE_ASSETS", tmp_path)
    monkeypatch.setenv("REALTRACE_ASSETS", str(tmp_path))
    return tmp_path, n


def assert_numpy_scenes_equal(got, want):
    a, b = scene_to_numpy(got), scene_to_numpy(want)
    for k, v in b.items():
        if isinstance(v, dict):
            for kk in v:
                np.testing.assert_array_equal(a[k][kk], v[kk], err_msg=f"{k}.{kk}")
        elif v is not None:
            np.testing.assert_array_equal(a[k], v, err_msg=k)
            assert a[k].dtype == v.dtype, k


@pytest.mark.parametrize("n_copies", [1, 4, 8])
def test_duplicated_serial_scene_equals_jax(assets, n_copies):
    """n=8 walks past the six frozen offsets into the first ring."""
    folder, n = assets
    tex = folder / "bob_diffuse.png"
    got, cam = scenes.duplicated_serial_scene(n_copies, texture_path=tex, device="cpu")
    want, jcam = jscenes.duplicated_serial_scene(n_copies, texture_path=tex)
    assert cam == jcam and got.n_triangles == n_copies * n
    assert_numpy_scenes_equal(got, want)
    # the texture reached every copy: the colours are not the loader's default
    assert not np.allclose(got.tri_colors.numpy(), (0.8, 0.1, 0.0))


def test_glass_bob_scene_equals_jax(assets):
    folder, _ = assets
    tex = folder / "bob_diffuse.png"
    got, cam = scenes.glass_bob_scene(texture_path=tex, device="cpu")
    want, jcam = jscenes.glass_bob_scene(texture_path=tex)
    assert cam == jcam and got.has_dielectrics() and got.n_spheres == 1
    assert_numpy_scenes_equal(got, want)


def test_serial_obj_scene_default_path_and_texture_scale(assets):
    """``obj_path`` defaults to the asset folder's bob_tri.obj, and
    ``texture_scale`` reaches the loader, as in the JAX package; with no
    asset the call raises."""
    folder, _ = assets
    kw = dict(texture_path=folder / "bob_diffuse.png", max_faces=50, texture_scale=0.5)
    got, _ = scenes.serial_obj_scene(device="cpu", **kw)
    want, _ = jscenes.serial_obj_scene(**kw)
    assert got.n_triangles == 50
    assert_numpy_scenes_equal(got, want)
    (folder / "bob_tri.obj").unlink()
    with pytest.raises(FileNotFoundError):
        scenes.serial_obj_scene(device="cpu")


def test_glass_over_obj_render_equals_jax(assets):
    """The glass-over-OBJ frame at 32x32, depth 3: the port through the
    sweep (its twin on the CPU) against the JAX renderer's bruteforce, at
    tests/test_golden.py's tolerance, with equal traced-ray counts. f64 in
    both, but the JAX scene's sphere is float32 whatever the dtype (ROADMAP.md,
    queue 3): its constants are 0.1 and 0.3 rounded to float32, the port's
    are not."""
    folder, _ = assets
    tex = folder / "bob_diffuse.png"
    jscene, cam = jscenes.glass_bob_scene(texture_path=tex, dtype=jnp.float64)
    want, jn = jrender_with_stats(jscene, jscenes.make_camera(cam, SIZE, SIZE, dtype=jnp.float64),
                                  JConfig(max_depth=DEPTH, accel="bruteforce"), branching=True)
    cfg = RenderConfig(max_depth=DEPTH, accel="sweep")
    scene, _ = scenes.glass_bob_scene(texture_path=tex, dtype=F64, device="cpu")
    scene = accel.with_chunks(scene, cfg)
    got, n = render_with_stats(scene, scenes.make_camera(cam, SIZE, SIZE, dtype=F64,
                                                         device="cpu"), cfg)
    assert_images_match(got.numpy(), np.asarray(want))
    assert n == int(jn)
    assert 0.02 < (np.abs(got.numpy() - np.asarray([0.1, 0.3, 0.6])).max(-1) > 1e-3).mean()
