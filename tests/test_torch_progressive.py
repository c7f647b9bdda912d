"""The PyTorch port's camera tiles, orbit camera, progressive renderer and
profiling utilities against the JAX package. CPU only; inputs from numpy."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtrace_tpu.apps import scenes as jscenes
from realtrace_tpu.core.types import RenderConfig as JConfig
from realtrace_tpu.render.camera import Camera as JCamera
from realtrace_tpu.render.camera import InteractiveCamera as JInteractive
from realtrace_tpu.render.camera import mouse_drag as jmouse_drag
from realtrace_tpu.render.progressive import ProgressiveRenderer as JProgressive
from realtrace_tpu_torch import InteractiveCamera
from realtrace_tpu_torch.apps import scenes
from realtrace_tpu_torch.core.types import RenderConfig
from realtrace_tpu_torch.ops import accel
from realtrace_tpu_torch.render.camera import Camera, mouse_drag
from realtrace_tpu_torch.render.pipeline import render_image
from realtrace_tpu_torch.render.progressive import ProgressiveRenderer
from realtrace_tpu_torch.utils import profiling
from test_torch_core import few_torch_threads, to_port  # noqa: F401 (autouse fixture)

CAM = dict(position=(3.0, 4.5, 17.0), target=(0.5, 0.2, -1.0), up=(0.1, 1.0, 0.0), fovy=41.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ray_directions_tile_matches_jax_and_full_frame(dtype):
    w, h, i0, j0, tw, th = 48, 40, 8, 16, 24, 20
    cam = Camera.make(**CAM, width=w, height=h, dtype=dtype, device="cpu")
    tile = cam.ray_directions_tile(i0, j0, tw, th)
    assert tile.shape == (th * tw, 3) and tile.dtype == dtype
    full = cam.ray_directions().reshape(h, w, 3)[j0:j0 + th, i0:i0 + tw].reshape(-1, 3)
    assert torch.equal(tile, full)
    jj, ii = np.meshgrid(np.arange(j0, j0 + th), np.arange(i0, i0 + tw), indexing="ij")
    assert torch.equal(tile, cam.ray_directions_at(ii.reshape(-1), jj.reshape(-1)))
    if dtype == torch.float64:
        jcam = JCamera.make(**CAM, width=w, height=h, dtype=jnp.float64)
        want = np.asarray(jcam.ray_directions_tile(float(i0), float(j0), tw, th))
        np.testing.assert_allclose(tile.numpy(), want, rtol=0, atol=1e-12)


def test_interactive_camera_and_mouse_drag_match_jax():
    a = InteractiveCamera(radius=30.0, pitch=0.4, resolution=(64, 48))
    b = JInteractive(radius=30.0, pitch=0.4, resolution=(64, 48))
    script = [("yaw", 0.7), ("drag", "left", 40.0, -25.0), ("drag", "middle", 3.0, 12.0),
              ("drag", "right", 0.0, -60.0), ("pitch", 3.0), ("radius", 0.25),
              ("altitude", -1.5), ("aperture", 2.0), ("yaw", 6.0), ("drag", "left", -500.0, 900.0)]
    for cam, drag in ((a, mouse_drag), (b, jmouse_drag)):
        for op, *v in script:
            if op == "drag":
                drag(cam, *v)
            else:
                getattr(cam, {"aperture": "change_aperture_diameter"}.get(op, f"change_{op}"))(*v)
    for f in ("yaw", "pitch", "radius", "aperture_radius", "fov_y"):
        assert getattr(a, f) == pytest.approx(getattr(b, f), rel=1e-15, abs=1e-15), f
    np.testing.assert_allclose(a.center, b.center, atol=1e-15)
    got = a.build_render_camera(dtype=torch.float64, device="cpu")
    want = b.build_render_camera(dtype=jnp.float64)
    for f in ("position", "target", "up", "fovy"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=1e-14, atol=1e-14)
    assert (got.width, got.height) == (want.width, want.height) == (64, 48)


def sphere_case(size=32):
    jscene, cam = jscenes.sphere_plane_scene(dtype=jnp.float64)
    return (jscene, jscenes.make_camera(cam, size, size, dtype=jnp.float64),
            to_port(jscene), scenes.make_camera(cam, size, size, dtype=torch.float64,
                                                device="cpu"))


def test_progressive_matches_jax_and_full_render():
    jscene, jcam, scene, cam = sphere_case()
    want = JProgressive(jscene, jcam, JConfig(max_depth=2), band=8).render_all()
    pr = ProgressiveRenderer(scene, cam, RenderConfig(max_depth=2), band=8)
    steps = 1
    while not pr.step():
        steps += 1
    assert steps == 4 and pr.done and pr.buffer.dtype == torch.float32
    np.testing.assert_allclose(pr.image().numpy(), want, rtol=0, atol=1e-6)
    full = render_image(scene, cam, RenderConfig(max_depth=2)).float()
    assert torch.equal(pr.image(), full)


def test_progressive_padded_bands_of_the_mesh_equal_full_render():
    """Bands of 24 rows leave pad slots in every 32x32 wavefront tile; the
    coarse mesh goes through the sweep twin."""
    cfg = RenderConfig(max_depth=2, accel="sweep")
    scene, cam = scenes.mesh_scene(detail=0.2, device="cpu")
    scene = accel.with_chunks(scene, cfg)
    camera = scenes.make_camera(dict(cam, position=(0.0, 6.0, 14.0)), 64, 48, device="cpu")
    img = ProgressiveRenderer(scene, camera, cfg, band=24).render_all()
    assert torch.equal(img, render_image(scene, camera, cfg))


def test_progressive_save_resume_bit_equal(tmp_path):
    _, _, scene, cam = sphere_case(16)
    cfg = RenderConfig(max_depth=2)
    a = ProgressiveRenderer(scene, cam, cfg, band=4)
    a.step()
    a.step()
    a.save(tmp_path / "state.npz")
    b = ProgressiveRenderer(scene, cam, cfg, band=4)
    b.load(tmp_path / "state.npz")
    assert b.cursor == 8 and b.buffer.dtype == torch.float32
    whole = ProgressiveRenderer(scene, cam, cfg, band=4).render_all()
    assert torch.equal(b.render_all(), whole)


def test_progressive_state_crosses_between_packages(tmp_path):
    """A state the JAX renderer saved resumes in the port, and the reverse;
    both finish on JAX's image."""
    jscene, jcam, scene, cam = sphere_case(16)
    want = JProgressive(jscene, jcam, JConfig(max_depth=2), band=4).render_all()
    j = JProgressive(jscene, jcam, JConfig(max_depth=2), band=4)
    j.step()
    j.save(tmp_path / "jax.npz")
    p = ProgressiveRenderer(scene, cam, RenderConfig(max_depth=2), band=4)
    p.load(tmp_path / "jax.npz")
    assert p.cursor == 4
    np.testing.assert_allclose(p.render_all().numpy(), want, rtol=0, atol=1e-6)
    p = ProgressiveRenderer(scene, cam, RenderConfig(max_depth=2), band=4)
    p.step()
    p.step()
    p.save(tmp_path / "port.npz")
    j = JProgressive(jscene, jcam, JConfig(max_depth=2), band=4)
    j.load(tmp_path / "port.npz")
    assert j.cursor == 8 and j.buffer.dtype == np.float32
    np.testing.assert_allclose(j.render_all(), want, rtol=0, atol=1e-6)


def test_progressive_rejects_indivisible_band():
    _, _, scene, cam = sphere_case(16)
    with pytest.raises(ValueError):
        ProgressiveRenderer(scene, cam, RenderConfig(max_depth=1), band=5)


def test_frame_timer_and_timed():
    t = profiling.FrameTimer(window=1e9)
    assert not t.frame(100) and not t.frame(100)
    t.window = 0.0
    assert t.frame(1e6)                       # the window rolls: 3 frames, 1.0002e6 rays
    assert t.fps > 0 and t.mrays_per_s > 0 and t._frames == 0
    assert "fps" in t.title() and "Mrays/s" in t.title()
    calls = []
    mean_s, out = profiling.timed(lambda x: calls.append(x) or torch.ones(2) * x, 3.0,
                                  repeats=4, warmup=2)
    assert len(calls) == 6 and mean_s >= 0 and torch.equal(out, torch.full((2,), 3.0))
    x = torch.zeros(3)
    assert profiling.block(x) is x


def test_frame_bracket_is_seen_by_the_profiler(tmp_path):
    with profiling.trace_capture(tmp_path) as prof:
        with profiling.frame_bracket("flythrough_frame_7"):
            torch.ones(64).sum()
    assert "flythrough_frame_7" in {e.name for e in prof.events()}
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert any(e.get("name") == "flythrough_frame_7" for e in trace["traceEvents"])
