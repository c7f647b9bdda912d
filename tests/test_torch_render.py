"""Whole renders through the PyTorch port in f64 on the CPU, held against the
golden128 artifact, the NumPy oracle (tests/oracle/cpu_reference.py) and the
JAX renderer, within the golden tolerance of tests/test_golden.py."""
import dataclasses
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracle.cpu_reference import OracleRenderer
from oracle.scene128 import CAM, DEPTH, SIZE, build_scene128
from realtrace_tpu.apps import scenes as jscenes
from realtrace_tpu.core.types import RenderConfig as JConfig
from realtrace_tpu.core.types import SceneBuilder as JBuilder
from realtrace_tpu.render.pipeline import render_with_stats as jrender_with_stats
from realtrace_tpu_torch.apps import scenes
from realtrace_tpu_torch.core.convert import config_from_dict
from realtrace_tpu_torch.ops import accel
from realtrace_tpu_torch.render.pipeline import render_image, render_with_stats, to_rgba8
from test_torch_core import few_torch_threads, to_port  # noqa: F401 (autouse fixture)

REPO = pathlib.Path(__file__).resolve().parent.parent
F64 = torch.float64


def assert_images_match(got, want, tol=1e-6, max_bad_frac=0.002):
    """tests/test_golden.py's tolerance: at most 0.2% of pixels off by > 1e-6."""
    err = np.abs(np.asarray(got, np.float64) - want).max(axis=-1)
    frac = (err > tol).mean()
    assert frac <= max_bad_frac, f"{(err > tol).sum()} pixels off by >{tol} (max {err.max():.3e})"


def port_render(jscene, cam, jcfg, w, h):
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    scene = to_port(jscene, dtype=F64)
    if cfg.accel == "sweep":
        scene = accel.with_chunks(scene, cfg)
    return render_image(scene, scenes.make_camera(cam, w, h, dtype=F64, device="cpu"),
                        cfg).numpy()


def oracle_case(jscene, cam, jcfg, w, h):
    want = OracleRenderer(jscene, jcfg).render(jscenes.make_camera(cam, w, h, dtype=jnp.float64))
    assert_images_match(port_render(jscene, cam, jcfg, w, h), want)


@pytest.mark.parametrize("accel_mode,knobs", [
    ("bruteforce", {}),
    ("pallas", {}),
    ("pallas", {"exact_mask_secondary": True}),   # exact chunk masks for every secondary
], ids=["bruteforce", "sweep", "sweep-exact-secondary"])
def test_golden_128(accel_mode, knobs):
    want = np.load(REPO / "tests" / "oracle" / "golden128.npz")["image"]
    got = port_render(build_scene128(dtype=jnp.float64), CAM,
                      JConfig(max_depth=DEPTH, accel=accel_mode, chunk_size=32, **knobs),
                      SIZE, SIZE)
    assert got.shape == want.shape
    assert_images_match(got, want)


@pytest.mark.parametrize("depth,w,h", [(1, 64, 48), (3, 48, 48)])
def test_sphere_plane_against_oracle(depth, w, h):
    jscene, cam = jscenes.sphere_plane_scene(dtype=jnp.float64)
    oracle_case(jscene, cam, JConfig(max_depth=depth), w, h)


def test_two_lights_with_shadows():
    b = JBuilder(dtype=jnp.float64)
    b.ambient = (1, 1, 1)
    b.background = (0.1, 0.3, 0.6)
    b.add_sphere((0, 0, 0), 2.0, color=(0.8, 0.1, 0.0), material=b.material(kr=0.2))
    b.add_plane((12, -3, 12), (-12, -3, 12), (-12, -3, -12), (12, -3, -12),
                color=(0.5, 0.5, 0.5), material=b.material(ka=0.1, kd=0.9, ks=0.2))
    b.add_light((8, 10, 8), (0.7, 0.2, 0.2))
    b.add_light((-8, 10, -2), (0.2, 0.7, 0.7))
    cam = dict(position=(10, 8, 10), target=(0, 0, 0), up=(0, 1, 0), fovy=45)
    oracle_case(b.build(), cam, JConfig(max_depth=2), 40, 32)


def test_deep_recursion_mirror_box():
    """Rays that never die pick up the background at the depth cap."""
    b = JBuilder(dtype=jnp.float64)
    b.background = (0.1, 0.3, 0.6)
    b.ambient = (1.0, 1.0, 1.0)
    mirror = b.material(ka=0.1, kd=0.1, ks=0.1, kr=0.9)
    b.add_plane((20, -2, 20), (-20, -2, 20), (-20, -2, -20), (20, -2, -20),
                color=(0.9, 0.9, 0.9), material=mirror)
    b.add_plane((20, 8, 20), (20, 8, -20), (-20, 8, -20), (-20, 8, 20),
                color=(0.9, 0.9, 0.9), material=mirror)
    b.add_light((0, 3, 0), (1, 1, 1))
    cam = dict(position=(0, 3, 18), target=(0, 2, 0), up=(0, 1, 0), fovy=45)
    oracle_case(b.build(), cam, JConfig(max_depth=10), 24, 24)


def test_coarse_mesh_against_jax_bruteforce():
    """The procedural mesh (coarse copy, 1,406 triangles, 44 chunks) through
    the port's sweep and bruteforce against the JAX bruteforce render of the
    same arrays; ray counts agree too."""
    tv, tc = scenes.mesh_arrays(seed=0, detail=0.36)
    scene, cam = scenes.mesh_scene(seed=0, detail=0.36, dtype=F64, device="cpu")
    b = JBuilder(dtype=jnp.float64)
    b.ambient, b.background = (1.0, 1.0, 1.0), (0.1, 0.3, 0.6)
    b.add_light((0, 30, 30), (0.5, 1.0, 1.0))
    mat = b.material(ka=0.2, kd=0.9, ks=0.4, kr=0.4, kt=0.0, eta=3.0)
    for tri, col in zip(15.0 * tv, tc):
        b.add_triangle(tri[0], tri[1], tri[2], vertex_colors=col, material=mat)
    jscene = b.build()
    np.testing.assert_array_equal(scene.tri_vertices.numpy(), np.asarray(jscene.tri_vertices))
    jcfg = JConfig(max_depth=3)
    want, jn = jrender_with_stats(jscene, jscenes.make_camera(cam, 64, 48, dtype=jnp.float64),
                                  jcfg)
    camera = scenes.make_camera(cam, 64, 48, dtype=F64, device="cpu")
    for mode in ("bruteforce", "sweep"):
        cfg = dataclasses.replace(config_from_dict(dataclasses.asdict(jcfg)), accel=mode)
        s = accel.with_chunks(scene, cfg) if mode == "sweep" else scene
        if mode == "sweep":
            assert s.tri_chunk_perm.numel() // 32 >= 40
        got, n = render_with_stats(s, camera, cfg)
        assert_images_match(got.numpy(), np.asarray(want))
        assert n == int(jn)
        assert 0.1 < (got.numpy() != np.asarray([0.1, 0.3, 0.6])).any(-1).mean() < 0.9


def test_all_miss_frame_is_background():
    """No primary hit: the sweep sees empty wavefronts after level 0."""
    scene, cam = scenes.mesh_scene(detail=0.2, dtype=F64, device="cpu")
    cfg = config_from_dict({"max_depth": 2, "accel": "pallas"})
    scene = accel.with_chunks(scene, cfg)
    away = dict(cam, target=(120.0, 120.0, 0.0))
    img, n = render_with_stats(scene, scenes.make_camera(away, 40, 30, dtype=F64,
                                                        device="cpu"), cfg)
    assert n == 40 * 30
    assert torch.equal(img, torch.tensor([0.1, 0.3, 0.6], dtype=F64).expand_as(img))


def test_dielectric_scene_renders():
    """A scene with a dielectric takes the branching wavefront."""
    jscene, cam = jscenes.full_primitive_scene(dtype=jnp.float64)
    assert to_port(jscene).has_dielectrics()
    oracle_case(jscene, cam, JConfig(max_depth=2), 24, 16)


def test_rgba8_and_non_tile_sizes():
    scene, cam = scenes.sphere_plane_scene(dtype=F64, device="cpu")
    img, n = render_with_stats(scene, scenes.make_camera(cam, 37, 29, dtype=F64, device="cpu"),
                               config_from_dict({"max_depth": 2}))
    assert img.shape == (29, 37, 3) and n > 37 * 29
    rgba = to_rgba8(img)
    assert rgba.dtype == torch.uint8 and rgba.shape == (29, 37, 4)
    assert bool((rgba[..., 3] == 255).all())


def test_cli_writes_png(tmp_path):
    out = tmp_path / "cli.png"
    proc = subprocess.run([sys.executable, "-m", "realtrace_tpu_torch.apps.cli", "--scene",
                           "sphere_plane", "--width", "32", "--height", "32", "--depth", "2",
                           "--device", "cpu", "--out", str(out)],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    from realtrace_tpu_torch.io.image import load_png
    assert load_png(out).shape == (32, 32, 3)


def test_chip_smoke_scene128_recipe_matches_oracle_scene():
    """chip_smoke.py rebuilds the golden128 scene without JAX; its arrays
    must equal tests/oracle/scene128.py's."""
    sys.path.insert(0, str(REPO))
    import chip_smoke
    want = to_port(build_scene128(dtype=jnp.float32))
    got = chip_smoke.scene128(torch.float32, "cpu")
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if dataclasses.is_dataclass(a):
            for g in dataclasses.fields(a):
                torch.testing.assert_close(getattr(a, g.name), getattr(b, g.name), rtol=0, atol=0)
        elif a is not None:
            torch.testing.assert_close(a, b, rtol=0, atol=0)
