"""The bench's forward legs against the JAX package on the CPU: legs 1, 2, 5
and 9 (the headline, the close framing, the glass scene, depth 10) render
their scene with their config (``apps/bench.py``) at 32x24 in f64, and the
image and traced-ray count equal the JAX package's ``render_with_stats`` of
the same arrays, through its plain reference (``accel="bruteforce"``),
within the golden tolerance of tests/test_golden.py. Split from
tests/test_torch_bench.py so that the two files run in parallel."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtrace_tpu.apps import scenes as jscenes
from realtrace_tpu.core.types import Lights as JLights
from realtrace_tpu.core.types import Materials as JMaterials
from realtrace_tpu.core.types import RenderConfig as JConfig
from realtrace_tpu.core.types import Scene as JScene
from realtrace_tpu.render.pipeline import render_with_stats as jrender_with_stats
from realtrace_tpu_torch.apps import bench, scenes
from realtrace_tpu_torch.core.convert import scene_to_numpy
from realtrace_tpu_torch.render.pipeline import render_with_stats
from test_torch_core import few_torch_threads  # noqa: F401 (autouse fixture)
from test_torch_render import assert_images_match

W, H = 32, 24


def to_jax(scene) -> JScene:
    """The port scene's arrays as a JAX Scene (no chunk permutation)."""
    kw = {}
    for k, v in scene_to_numpy(scene).items():
        if k.endswith("_materials"):
            kw[k] = JMaterials(**{kk: jnp.asarray(vv) for kk, vv in v.items()})
        elif k == "lights":
            kw[k] = JLights(**{kk: jnp.asarray(vv) for kk, vv in v.items()})
        elif k != "tri_chunk_perm":
            kw[k] = jnp.asarray(v)
    return JScene(**kw)


@pytest.mark.parametrize("leg", ["headline", "hit-heavy", "branching", "depth10"])
def test_leg_render_equals_jax(leg):
    w = bench.leg_workloads(leg, depth=3)[0]
    scene, cam, _ = bench.build_scene(w, dtype=torch.float64, device="cpu")
    got, n = render_with_stats(scene, scenes.make_camera(cam, W, H, dtype=torch.float64,
                                                         device="cpu"), w.cfg)
    jcfg = dataclasses.replace(JConfig(**bench.jax_config_fields(leg, 3)), accel="bruteforce")
    want, jn = jrender_with_stats(to_jax(scene), jscenes.make_camera(cam, W, H, dtype=jnp.float64),
                                  jcfg)
    assert_images_match(got.numpy(), np.asarray(want))
    assert n == int(jn)
    assert w.cfg.max_depth == (10 if leg == "depth10" else 3)
    # the model is in the frame: not every pixel is the background
    assert (np.abs(got.numpy() - np.asarray([0.1, 0.3, 0.6])).max(-1) > 1e-3).any()
