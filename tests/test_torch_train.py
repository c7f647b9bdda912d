"""The port's inverse rendering on the CPU, in f64: Adam train steps against
the JAX package's ``make_train_step`` (losses and parameters, rtol 1e-9), a
JAX run continued in the port through ``adam_state_from_numpy``, the chunk
re-sort against JAX's, train-state checkpoints, the albedo recovery of
tests/test_grad.py and the ``invert`` CLI."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from realtrace_tpu.apps import scenes as jscenes
from realtrace_tpu.core.types import RenderConfig as JConfig
from realtrace_tpu.diff.inverse import make_train_step as jmake_train_step
from realtrace_tpu.ops import accel as jaccel
from realtrace_tpu.render.pipeline import render_buffer as jrender_buffer
from realtrace_tpu_torch.apps import invert, scenes
from realtrace_tpu_torch.core.convert import (adam_state_from_numpy, params_from_numpy,
                                              params_to_numpy)
from realtrace_tpu_torch.core.types import RenderConfig, tensor_leaves
from realtrace_tpu_torch.diff import checkpoint as ckpt
from realtrace_tpu_torch.diff.inverse import DIFF_FIELDS, apply_params, make_train_step
from realtrace_tpu_torch.ops import accel
from realtrace_tpu_torch.parallel import mesh as pmesh
from realtrace_tpu_torch.render.pipeline import render_buffer
from test_torch_core import few_torch_threads, to_port  # noqa: F401 (autouse fixture)
from test_torch_grad import MESH_DETAIL, flat, mesh_jscene

F64 = torch.float64
W, H, DEPTH = 24, 18, 2
WRONG_ALBEDO = [[0.2, 0.6, 0.9]]


def wrong_sphere_plane():
    """tests/test_grad.py's albedo case: (the scene with the wrong albedo,
    the target render of the right one, camera dict), in the JAX package."""
    jscene, cam = jscenes.sphere_plane_scene(dtype=jnp.float64)
    target = jrender_buffer(jscene, jscenes.make_camera(cam, W, H, dtype=jnp.float64),
                            JConfig(max_depth=DEPTH))
    return jscene.replace(sph_color=jnp.asarray(WRONG_ALBEDO, jnp.float64)), target, cam


@pytest.fixture(scope="module")
def jax_run():
    """Four JAX Adam steps (lr 1e-2, every DIFF_FIELDS leaf) on the wrong
    albedo: the losses, the parameters after each step and the optimiser
    state after step 2, all as numpy."""
    jscene, target, cam = wrong_sphere_plane()
    step, params, opt_state = jmake_train_step(
        jscene, jscenes.make_camera(cam, W, H, dtype=jnp.float64), JConfig(max_depth=DEPTH),
        target, optimizer=optax.adam(1e-2))
    losses, after, state2 = [], [], None
    for i in range(4):
        params, opt_state, loss = step(params, opt_state)
        losses.append(float(loss))
        after.append(params_to_numpy(params))
        if i == 1:
            adam = opt_state[0]
            state2 = (params_to_numpy(adam.mu), params_to_numpy(adam.nu), np.asarray(adam.count))
    return jscene, np.asarray(target), cam, losses, after, state2


def assert_params_close(got: dict, want: dict, rtol=1e-9):
    got, want = flat(params_to_numpy(got)), flat(want)
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=rtol, atol=1e-12, err_msg=k)


def port_train(jscene, target, cam):
    scene = to_port(jscene, dtype=F64)
    camera = scenes.make_camera(cam, W, H, dtype=F64, device="cpu")
    return scene, camera, torch.tensor(target)


def test_three_steps_equal_jax(jax_run):
    jscene, target, cam, losses, after, _ = jax_run
    scene, camera, tgt = port_train(jscene, target, cam)
    step, params, opt = make_train_step(scene, camera, RenderConfig(max_depth=DEPTH), tgt,
                                        lr=1e-2)
    assert set(params) == set(DIFF_FIELDS)
    assert all(p.is_leaf and p.requires_grad for p in tensor_leaves(params))
    got = [float(step()) for _ in range(3)]
    np.testing.assert_allclose(got, losses[:3], rtol=1e-9)
    assert_params_close(params, after[2])


def test_jax_run_continues_in_the_port(jax_run):
    """Two JAX steps carried over (parameters and optax's moments and count)
    and two more in the port equal four JAX steps."""
    jscene, target, cam, losses, after, (mu, nu, count) = jax_run
    scene, camera, tgt = port_train(jscene, target, cam)
    scene = apply_params(scene, params_from_numpy(after[1], device="cpu"))
    step, params, opt = make_train_step(scene, camera, RenderConfig(max_depth=DEPTH), tgt,
                                        lr=1e-2)
    opt.load_state_dict({"state": adam_state_from_numpy(mu, nu, count),
                         "param_groups": opt.state_dict()["param_groups"]})
    got = [float(step()) for _ in range(2)]
    np.testing.assert_allclose(got, losses[2:], rtol=1e-9)
    assert_params_close(params, after[3])


def test_default_optimizer_is_optax_adam(jax_run):
    """Neither ``lr`` nor ``optimizer``: Adam at 1e-2, the JAX package's
    default ``optax.adam(1e-2)``."""
    jscene, target, cam, losses, after, _ = jax_run
    scene, camera, tgt = port_train(jscene, target, cam)
    step, params, opt = make_train_step(scene, camera, RenderConfig(max_depth=DEPTH), tgt)
    assert type(opt) is torch.optim.Adam
    got = [float(step()) for _ in range(3)]
    np.testing.assert_allclose(got, losses[:3], rtol=1e-9)
    assert_params_close(params, after[2])


SGD_LR = 5e-2


def sgd(leaves):
    return torch.optim.SGD(leaves, lr=SGD_LR)


@pytest.fixture(scope="module")
def jax_sgd_run():
    """Three JAX steps with ``optax.sgd(5e-2)`` on the wrong albedo: the
    losses and the parameters after the third, as numpy."""
    jscene, target, cam = wrong_sphere_plane()
    step, params, opt_state = jmake_train_step(
        jscene, jscenes.make_camera(cam, W, H, dtype=jnp.float64), JConfig(max_depth=DEPTH),
        target, optimizer=optax.sgd(SGD_LR))
    losses = []
    for _ in range(3):
        params, opt_state, loss = step(params, opt_state)
        losses.append(float(loss))
    return jscene, np.asarray(target), cam, losses, params_to_numpy(params)


@pytest.mark.parametrize("sharded", [False, True], ids=["make_train_step", "sharded-world-1"])
def test_optimizer_factory_matches_optax_sgd(jax_sgd_run, sharded):
    """The optimizer factory, the counterpart of the JAX optax argument, in
    the single and the sharded train step (a 1x1 mesh, no process group)."""
    jscene, target, cam, losses, after = jax_sgd_run
    scene, camera, tgt = port_train(jscene, target, cam)
    cfg = RenderConfig(max_depth=DEPTH)
    if sharded:
        top_down = torch.flip(tgt.reshape(H, W, 3), dims=(0,))
        step, params, opt = pmesh.make_sharded_train_step(scene, camera, cfg, top_down,
                                                          pmesh.make_mesh(1), optimizer=sgd)
    else:
        step, params, opt = make_train_step(scene, camera, cfg, tgt, optimizer=sgd)
    assert type(opt) is torch.optim.SGD
    got = [float(step()) for _ in range(3)]
    np.testing.assert_allclose(got, losses, rtol=1e-5)
    assert_params_close(params, after, rtol=1e-5)


def test_resort_chunks_equals_jax_after_vertices_move():
    cfg = RenderConfig(accel="sweep")
    jscene = mesh_jscene()
    rng = np.random.default_rng(7)   # half the triangles move away: stale chunks straddle
    tv = np.asarray(jscene.tri_vertices) + rng.normal(0.0, 0.05, jscene.tri_vertices.shape)
    tv[rng.uniform(size=tv.shape[0]) < 0.5] += [30.0, 0.0, 0.0]
    jmoved = jaccel.resort_chunks(jscene.replace(tri_vertices=jnp.asarray(tv)),
                                  JConfig(accel="pallas"))
    scene = accel.with_chunks(to_port(jscene, dtype=F64), cfg)
    moved = dataclasses.replace(scene, tri_vertices=torch.as_tensor(tv))
    stale = accel.chunk_volume(moved, cfg)
    resorted = accel.resort_chunks(moved, cfg)
    np.testing.assert_array_equal(resorted.tri_chunk_perm.numpy(),
                                  np.asarray(jmoved.tri_chunk_perm))
    np.testing.assert_allclose(float(accel.chunk_volume(resorted, cfg)),
                               float(jaccel.chunk_volume(jmoved, JConfig(accel="pallas"))),
                               rtol=1e-12)
    assert float(accel.chunk_volume(resorted, cfg)) < float(stale)


def mesh_train(cfg, size=(32, 24)):
    """A train step on the coarse mesh through the sweep (with the chunk
    re-sort every step) from perturbed vertex colours and vertices."""
    scene, cam = scenes.mesh_scene(detail=MESH_DETAIL, dtype=F64, device="cpu")
    scene = accel.with_chunks(scene, cfg)
    camera = scenes.make_camera(cam, *size, dtype=F64, device="cpu")
    with torch.no_grad():
        target = render_buffer(scene, camera, cfg)
    gen = torch.Generator().manual_seed(3)
    wrong = dataclasses.replace(
        scene, tri_colors=scene.tri_colors + 0.2 * torch.randn(scene.tri_colors.shape,
                                                               generator=gen, dtype=F64),
        tri_vertices=scene.tri_vertices + 0.05 * torch.randn(scene.tri_vertices.shape,
                                                             generator=gen, dtype=F64))
    return make_train_step(wrong, camera, cfg, target, lr=1e-2,
                           fields=("tri_vertices", "tri_colors", "tri_materials", "lights"))


def test_checkpoint_resume_equals_uninterrupted_run(tmp_path, monkeypatch):
    cfg = RenderConfig(max_depth=3, accel="sweep")
    resorts = []
    real = accel.resort_chunks
    monkeypatch.setattr(accel, "resort_chunks", lambda s, c: resorts.append(1) or real(s, c))
    step, params, opt = mesh_train(cfg)
    straight = [float(step()) for _ in range(4)]
    assert len(resorts) == 4 and straight[-1] < straight[0]

    step, params2, opt2 = mesh_train(cfg)
    resumed = [float(step()) for _ in range(2)]
    path = ckpt.save_train_state(tmp_path / "ckpt", 2, params2, opt2)
    assert path.name == "step_00000002.pt" and ckpt.latest_checkpoint(tmp_path / "ckpt") == path
    step, params3, opt3 = mesh_train(cfg)           # a fresh run, restored
    assert ckpt.restore_train_state(path, params3, opt3) == 2
    resumed += [float(step()) for _ in range(2)]
    assert resumed == straight
    for a, b in zip(tensor_leaves(params3), tensor_leaves(params)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        ckpt.restore_train_state(path, {"tri_colors": params3["tri_colors"]}, opt3)
    assert ckpt.latest_checkpoint(tmp_path / "none") is None


def test_inverse_rendering_recovers_color():
    """tests/test_grad.py::test_inverse_rendering_recovers_color in the port."""
    scene, cam = scenes.sphere_plane_scene(dtype=F64, device="cpu")
    camera = scenes.make_camera(cam, W, H, dtype=F64, device="cpu")
    cfg = RenderConfig(max_depth=DEPTH)
    target = render_buffer(scene, camera, cfg)
    wrong = dataclasses.replace(scene, sph_color=torch.tensor(WRONG_ALBEDO, dtype=F64))
    step, params, _ = make_train_step(wrong, camera, cfg, target, lr=5e-2, fields=("sph_color",))
    losses = [float(step()) for _ in range(60)]
    assert losses[-1] < losses[0] * 1e-2, losses[::10]
    np.testing.assert_allclose(params["sph_color"][0].detach().numpy(), [0.8, 0.1, 0.0],
                               atol=0.05)


def test_invert_cli_writes_recovered_png(tmp_path):
    out = tmp_path / "invert"
    assert invert.main(["--device", "cpu", "--steps", "4", "--width", "16", "--height", "12",
                        "--ckpt-every", "2", "--out-dir", str(out)]) == 0
    assert (out / "recovered.png").stat().st_size > 0 and (out / "target.png").exists()
    assert ckpt.latest_checkpoint(out / "ckpt").name == "step_00000004.pt"
