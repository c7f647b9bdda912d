"""The PyTorch port's pixel-tile sharding over ``torch.distributed`` against
the JAX package's ``parallel/mesh.py`` (on its 8 emulated CPU devices, from
``conftest.py``). One launch of the two-rank smoke (gloo, CPU) carries the
render, the train step and the flythrough; the JAX side runs here."""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtrace_tpu.apps import scenes as jscenes
from realtrace_tpu.apps.flythrough import run_flythrough as jrun_flythrough
from realtrace_tpu.core.types import RenderConfig as JConfig
from realtrace_tpu.parallel import mesh as jmesh
from realtrace_tpu.render.camera import InteractiveCamera as JInteractive
from realtrace_tpu_torch.apps import scenes
from realtrace_tpu_torch.core.convert import scene_to_npz
from realtrace_tpu_torch.core.types import RenderConfig
from realtrace_tpu_torch.parallel import mesh as pmesh
from realtrace_tpu_torch.render.pipeline import render_buffer, render_image
from test_torch_core import few_torch_threads, to_port  # noqa: F401 (autouse fixture)

REPO = Path(__file__).resolve().parent.parent
W, H, DEPTH, STEPS, FRAMES = 32, 16, 2, 2, 3
FIELDS = ("sph_color", "lights")
SERIAL_CAM = dict(position=(60, 60, 0), target=(0, 0, 0), up=(0, 1, 0), fovy=45.0)


@pytest.mark.parametrize("n", range(1, 9))
def test_make_mesh_matches_jax(n):
    got = pmesh.make_mesh(n)
    want = jmesh.make_mesh(n).shape
    assert (got.ty, got.tx) == (want["ty"], want["tx"])
    assert (got.iy, got.ix) == (0, 0) and got.size == n


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    """One run of ``python -m realtrace_tpu_torch.parallel.smoke``: two gloo
    ranks on the CPU, a (1, 2) grid, JAX's sphere_plane_scene in f64."""
    d = tmp_path_factory.mktemp("smoke")
    jscene, _ = jscenes.sphere_plane_scene(dtype=jnp.float64)
    scene_to_npz(d / "scene.npz", jscene)
    cmd = [sys.executable, "-m", "realtrace_tpu_torch.parallel.smoke", "--device", "cpu",
           "--scene-npz", str(d / "scene.npz"), "--f64", "--width", str(W), "--height", str(H),
           "--depth", str(DEPTH), "--accel", "bruteforce", "--fields", ",".join(FIELDS),
           "--steps", str(STEPS), "--flythrough", str(FRAMES), "--image-tol", "1e-12",
           "--grad-rtol", "1e-10", "--timeout", "240", "--out", str(d / "out.npz")]
    run = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    out = dict(np.load(d / "out.npz")) if (d / "out.npz").exists() else {}
    return run, out, jscene


def test_two_rank_smoke_passes(smoke):
    run, out, _ = smoke
    assert run.returncode == 0, run.stdout + run.stderr
    assert run.stdout.strip().splitlines()[-1] == "OK"
    assert "[FAIL]" not in run.stdout


def test_sharded_render_matches_jax_and_single_render(smoke):
    _, out, jscene = smoke
    camera = jscenes.make_camera(SERIAL_CAM, W, H, dtype=jnp.float64)
    render = jax.jit(lambda s, c: jmesh.sharded_render(s, c, JConfig(max_depth=DEPTH),
                                                       jmesh.make_mesh(2)))
    want = np.asarray(render(jscene, camera))
    for r in (0, 1):
        np.testing.assert_allclose(out[f"rank{r}_image"], want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(out["rank0_image"], out["single"], rtol=0, atol=1e-12)


def test_loss_and_grad_matches_jax(smoke):
    _, out, jscene = smoke
    camera = jscenes.make_camera(SERIAL_CAM, W, H, dtype=jnp.float64)
    step, p0, _ = jmesh.make_sharded_train_step(jscene, camera, JConfig(max_depth=DEPTH),
                                                jnp.zeros((H, W, 3), jnp.float64),
                                                jmesh.make_mesh(2), fields=FIELDS)
    loss, grads = step.loss_and_grad(p0)
    assert float(out["rank0_loss0"]) == pytest.approx(float(loss), rel=1e-12)
    np.testing.assert_allclose(out["rank0_grad/sph_color"], np.asarray(grads["sph_color"]),
                               rtol=0, atol=1e-10)
    for k in ("position", "intensity"):
        np.testing.assert_allclose(out[f"rank0_grad/lights/{k}"],
                                   np.asarray(getattr(grads["lights"], k)), rtol=0, atol=1e-10)


def test_ranks_stay_bit_identical_and_loss_falls(smoke):
    _, out, _ = smoke
    assert np.array_equal(out["rank0_params"], out["rank1_params"])
    assert np.array_equal(out["rank0_losses"], out["rank1_losses"])
    losses = out["rank0_losses"]
    assert len(losses) == STEPS and losses[-1] < losses[0]
    for k in [k for k in out if k.startswith("rank0_grad/")]:
        assert np.array_equal(out[k], out[k.replace("rank0", "rank1")])


def test_sharded_flythrough_matches_single_and_jax(smoke):
    _, out, jscene = smoke
    frames = out["rank0_flythrough"]
    assert frames.shape == (FRAMES, H, W, 3)
    np.testing.assert_allclose(frames, out["fly_single"], rtol=0, atol=1e-12)
    want, _ = jrun_flythrough(jscene, JInteractive(radius=85.0, pitch=0.6, resolution=(W, H)),
                              JConfig(max_depth=DEPTH), frames=FRAMES, dtype=jnp.float64)
    np.testing.assert_allclose(frames, np.stack([np.asarray(x) for x in want]), rtol=0,
                               atol=1e-12)


def test_indivisible_image_raises():
    scene, cam = scenes.sphere_plane_scene(dtype=torch.float64, device="cpu")
    camera = scenes.make_camera(cam, 31, 30, dtype=torch.float64, device="cpu")
    mesh = pmesh.make_mesh(2)
    with pytest.raises(ValueError):
        pmesh.sharded_render(scene, camera, RenderConfig(max_depth=1), mesh)
    with pytest.raises(ValueError):
        pmesh.make_sharded_train_step(scene, camera, RenderConfig(max_depth=1),
                                      torch.zeros((30, 31, 3), dtype=torch.float64), mesh)


def test_one_rank_without_a_group_equals_the_single_render():
    """A 1x1 mesh needs no process group: sharded_render is the render, the
    train step's loss_and_grad is make_train_step's mean squared error."""
    scene, cam = scenes.sphere_plane_scene(dtype=torch.float64, device="cpu")
    camera = scenes.make_camera(cam, W, H, dtype=torch.float64, device="cpu")
    cfg = RenderConfig(max_depth=DEPTH)
    mesh = pmesh.make_mesh(1)
    assert torch.equal(pmesh.sharded_render(pmesh.replicate_scene(scene, mesh), camera, cfg,
                                            mesh), render_image(scene, camera, cfg))
    target = torch.full((H, W, 3), 0.25, dtype=torch.float64)
    step, params, _ = pmesh.make_sharded_train_step(scene, camera, cfg, target, mesh,
                                                    fields=("sph_color",))
    loss, grads = step.loss_and_grad()
    buf = render_buffer(scene, camera, cfg)
    assert float(loss) == pytest.approx(float(torch.mean((buf - 0.25) ** 2)), rel=1e-12)
    assert grads["sph_color"].shape == (1, 3) and params["sph_color"].grad is None
