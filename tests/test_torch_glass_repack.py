"""The branching wavefront's lane repack on the CPU: a glass mesh (the
dielectric of the serial app's scene block, kt .8, eta 2) at depth 10,
against the NumPy oracle in f64 at tests/test_golden.py's tolerance; the
lanes each level holds; level 0 compacted through the lanes' calls, and
each level's host syncs; that renders repeat bit for bit; and gradients
through the repacked levels against central finite differences."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracle.cpu_reference import OracleRenderer
from realtrace_tpu.apps import scenes as jscenes
from realtrace_tpu.core.types import RenderConfig as JConfig
from realtrace_tpu.core.types import SceneBuilder as JBuilder
from realtrace_tpu_torch.apps import scenes
from realtrace_tpu_torch.core.convert import config_from_dict
from realtrace_tpu_torch.core.types import WAVEFRONT_TILE, RenderConfig
from realtrace_tpu_torch.ops import accel
from realtrace_tpu_torch.render.pipeline import render_with_stats
from realtrace_tpu_torch.utils import profiling
from test_torch_core import few_torch_threads, to_port  # noqa: F401 (autouse fixture)
from test_torch_grad import fd_check
from test_torch_render import assert_images_match
from test_torch_trace import traced_frame

F64 = torch.float64
DETAIL = 0.25          # the coarse mesh: 672 triangles, 21 chunks of 32
W, H = 48, 32
DEPTH = 10
GLASS = dict(ka=0.4, kd=0.9, ks=0.4, kr=0.1, kt=0.8, eta=2.0)
# the serial framing at 0.6 of its distance: the glass fills 40% of the frame
CAM = dict(position=(36.0, 36.0, 0.0), target=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0), fovy=45.0)
# each level's ``rt.p.sync`` spans, by site, in the float32 frame; level 0's
# hold its primary query's and its hits' repack
LEVEL_SYNCS = ([dict(ray_count=1, mask_const=6, live_lanes=2)]
               + [dict(ray_count=1, mask_const=4, live_lanes=1)] * (DEPTH - 1)
               + [dict(ray_count=1, mask_const=2)])


def glass_jscene():
    """mesh_scene's mesh, lights and background with every triangle glass."""
    tv, tc = scenes.mesh_arrays(seed=0, detail=DETAIL)
    b = JBuilder(dtype=jnp.float64)
    b.ambient, b.background = (1.0, 1.0, 1.0), (0.1, 0.3, 0.6)
    b.add_light((0, 30, 30), (0.5, 1.0, 1.0))
    mat = b.material(**GLASS)
    for tri, col in zip(15.0 * tv, tc):
        b.add_triangle(tri[0], tri[1], tri[2], vertex_colors=col, material=mat)
    return b.build()


def port_case(mode="sweep", dtype=F64):
    cfg = RenderConfig(max_depth=DEPTH, accel=mode)
    scene = to_port(glass_jscene(), dtype=dtype)
    if mode == "sweep":
        scene = accel.with_chunks(scene, cfg)
    return scene, scenes.make_camera(CAM, W, H, dtype=dtype, device="cpu"), cfg


@pytest.fixture(scope="module")
def oracle_image():
    jcam = jscenes.make_camera(CAM, W, H, dtype=jnp.float64)
    return OracleRenderer(glass_jscene(), JConfig(max_depth=DEPTH)).render(jcam)


@pytest.mark.parametrize("mode", ["bruteforce", "sweep"])
def test_glass_mesh_at_depth_10_equals_oracle(oracle_image, mode):
    scene, camera, cfg = port_case(mode)
    assert scene.has_dielectrics()
    got, n = render_with_stats(scene, camera, cfg)
    assert_images_match(got.numpy(), oracle_image)
    # the glass is in the frame: a third of it is not the background
    assert 0.3 < (np.abs(oracle_image - np.asarray([0.1, 0.3, 0.6])).max(-1) > 1e-3).mean()
    assert n > 10 * W * H


def test_each_level_holds_its_live_lanes_rounded_up_to_a_tile():
    scene, camera, cfg = port_case(dtype=torch.float32)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        _, nrays = render_with_stats(scene, camera, cfg)
    counted = [profiling.RECORDER.read(f"rt.p.level.{k}", 1)[0] for k in range(DEPTH + 1)]
    assert sum(c["rays"] for c in counted) == nrays
    for c in counted:
        assert c["lanes"] % WAVEFRONT_TILE == 0 and c["tiles"] * WAVEFRONT_TILE == c["lanes"]
        assert c["live"] <= c["lanes"] <= -(-c["live"] // WAVEFRONT_TILE) * WAVEFRONT_TILE
    # every level branches on: the deepest still holds live lanes
    assert counted[-1]["live"] > 0


@pytest.fixture(scope="module")
def glass_traced():
    return traced_frame(*port_case(dtype=torch.float32))


def test_level_0_repacks_through_the_calls_of_every_level(glass_traced):
    """``_live_lanes`` once at level 0, for its hits, and once at each level
    that queries children (every level runs, as above); the tiles' never."""
    calls, syncs = glass_traced
    assert len(syncs) == DEPTH + 1 and calls == {"_live_lanes": 1 + DEPTH}


def test_each_repacked_level_makes_its_host_syncs(glass_traced):
    assert glass_traced[1] == LEVEL_SYNCS


def test_glass_mesh_render_is_bit_identical_twice():
    scene, camera, cfg = port_case(dtype=torch.float32)
    a, na = render_with_stats(scene, camera, cfg)
    b, nb = render_with_stats(scene, camera, cfg)
    assert na == nb and torch.equal(a, b)


@pytest.mark.parametrize("field,sub", [
    ("background", (2,)), ("tri_materials", ("eta", 300)), ("tri_vertices", (300, 0, 1)),
], ids=["background", "eta", "vertex"])
def test_grad_through_the_repacked_levels_equals_finite_difference(field, sub):
    """A glass hit adds no colour of its own (Serial/world.cpp:100): the
    frame is the background carried through every level's Fresnel weights,
    so each gradient flows back through all the repacked levels."""
    scene, camera, cfg = port_case()
    cfg = dataclasses.replace(cfg, remat=True)
    ad = fd_check(scene, camera, cfg, field, sub)
    assert ad != 0.0
