"""The JAX package's three per-level query modes through the port, on the CPU
in f64: the default (shadow rays in one any-mode query beside the children's
closest query), the fully merged query (``shadow_any_mode=False``: shadow and
child rays in one closest query) and the unmerged queries
(``merge_queries=False``: one any-mode query per light; scenes without
dielectrics only). Each mode's render of a reduced mesh_scene and of the glass
scene, through the sweep's twin and through brute force, equals the JAX
package's render in the same mode (through its plain reference,
``accel="bruteforce``; the modes do not depend on the accel) within the golden
tolerance of tests/test_golden.py, with the same traced-ray count; the sweep
runs once a query; the gradients do not depend on the mode."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtrace_tpu.apps import scenes as jscenes
from realtrace_tpu.core.types import RenderConfig as JConfig
from realtrace_tpu.render.pipeline import render_with_stats as jrender_with_stats
from realtrace_tpu_torch.apps import scenes
from realtrace_tpu_torch.core.convert import config_from_dict
from realtrace_tpu_torch.core.types import tensor_leaves
from realtrace_tpu_torch.diff.inverse import image_grad
from realtrace_tpu_torch.ops import accel, sweep
from realtrace_tpu_torch.render.pipeline import render_with_stats
from test_torch_bench_jax import to_jax
from test_torch_core import few_torch_threads  # noqa: F401 (autouse fixture)
from test_torch_render import assert_images_match

F64 = torch.float64
W, H, DEPTH = 48, 32, 3
DETAIL = 0.2          # 440 triangles, 14 chunks of 32
MODES = {"default": {}, "merged": {"shadow_any_mode": False},
         "unmerged": {"merge_queries": False}}
SCENES = {"mesh": scenes.mesh_scene, "glass": scenes.glass_mesh_scene}


@pytest.fixture(scope="module")
def built():
    """Each scene once: the port scene in f64, its JAX twin and its camera."""
    out = {}
    for name, make in SCENES.items():
        scene, cam = make(detail=DETAIL, dtype=F64, device="cpu")
        out[name] = scene, to_jax(scene), cam
    return out


def port_cfg(mode: str, accel_mode: str):
    return config_from_dict(dict(max_depth=DEPTH, accel=accel_mode, **MODES[mode]))


def count_sweeps(monkeypatch) -> list:
    """Count the sweep's calls (one a query; on the CPU they run the twin)."""
    calls = [0]
    real = sweep.sweep

    def counted(*a, **k):
        calls[0] += 1
        return real(*a, **k)

    monkeypatch.setattr(sweep, "sweep", counted)
    return calls


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("scene_name", list(SCENES))
def test_mode_render_equals_jax(built, scene_name, mode, monkeypatch):
    scene, jscene, cam = built[scene_name]
    assert scene.has_dielectrics() == (scene_name == "glass")
    jcfg = JConfig(max_depth=DEPTH, accel="bruteforce", **MODES[mode])
    want, jn = jrender_with_stats(jscene, jscenes.make_camera(cam, W, H, dtype=jnp.float64),
                                  jcfg)
    want = np.asarray(want)
    # the frame holds the model and its shadows: not every pixel is background
    assert (np.abs(want - np.asarray([0.1, 0.3, 0.6])).max(-1) > 1e-3).mean() > 0.1
    camera = scenes.make_camera(cam, W, H, dtype=F64, device="cpu")
    calls = count_sweeps(monkeypatch)
    for accel_mode in ("sweep", "bruteforce"):
        cfg = port_cfg(mode, accel_mode)
        got, n = render_with_stats(accel.with_chunks(scene, cfg), camera, cfg)
        assert_images_match(got.numpy(), want)
        assert n == int(jn), (accel_mode, n, int(jn))
    assert calls[0] > 0


# one light, depth 3: the primary query, then per level (4) the shadow query
# and (3) the children's; the fully merged mode asks one query a level
SWEEPS_A_FRAME = {"default": 1 + 4 + 3, "merged": 1 + 4, "unmerged": 1 + 4 + 3}


@pytest.mark.parametrize("mode", list(MODES))
def test_sweeps_a_frame(built, mode, monkeypatch):
    scene, _, cam = built["mesh"]
    assert scene.n_lights == 1
    cfg = port_cfg(mode, "sweep")
    scene = accel.with_chunks(scene, cfg)
    calls = count_sweeps(monkeypatch)
    render_with_stats(scene, scenes.make_camera(cam, W, H, dtype=F64, device="cpu"), cfg)
    assert calls[0] == SWEEPS_A_FRAME[mode]


def test_unmerged_queries_each_light_alone(built, monkeypatch):
    """With two lights the unmerged mode asks one shadow query per light (two
    a level), the default one for both; the images are equal."""
    scene, _, cam = built["mesh"]
    lights = dataclasses.replace(
        scene.lights, position=torch.cat([scene.lights.position,
                                          scene.lights.position * torch.tensor([-1.0, 1, 1],
                                                                               dtype=F64)]),
        intensity=torch.cat([scene.lights.intensity, 0.5 * scene.lights.intensity]))
    scene = dataclasses.replace(scene, lights=lights)
    camera = scenes.make_camera(cam, W, H, dtype=F64, device="cpu")
    out = {}
    for mode in MODES:
        cfg = port_cfg(mode, "sweep")
        calls = count_sweeps(monkeypatch)
        out[mode] = render_with_stats(accel.with_chunks(scene, cfg), camera, cfg), calls[0]
    assert out["unmerged"][1] == 1 + 2 * 4 + 3
    assert out["default"][1] == 1 + 4 + 3 and out["merged"][1] == 1 + 4
    for mode in ("merged", "unmerged"):
        assert_images_match(out[mode][0][0].numpy(), out["default"][0][0].numpy())
        assert out[mode][0][1] == out["default"][0][1]


def test_merged_mode_gradients_equal_default(built):
    """The fully merged mode queries before it shades, from a no-grad pass of
    the child geometry; the shading, and so the gradients, are the default
    mode's, with remat on and off."""
    scene, _, cam = built["mesh"]
    camera = scenes.make_camera(cam, 32, 24, dtype=F64, device="cpu")
    fields = ("tri_vertices", "tri_colors", "lights")
    grads = []
    for mode, remat in (("default", True), ("merged", True), ("merged", False)):
        cfg = dataclasses.replace(port_cfg(mode, "sweep"), remat=remat)
        loss, g = image_grad(accel.with_chunks(scene, cfg), camera, cfg, fields=fields)
        grads.append([loss] + tensor_leaves(g))
    assert any(bool(g.abs().max() > 0) for g in grads[0][1:])
    for other in grads[1:]:
        assert all(torch.equal(a, b) for a, b in zip(grads[0], other))
