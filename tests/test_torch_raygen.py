"""Ray generation (``render/pipeline.py::_tiled_rays``): the kernel
(``ops/raygen.py``, ``rt_raygen`` in ``csrc/level.cu``) and its PyTorch twin,
``_tiled_rays_reference``, and the camera's one copy (``Camera.make``).

On the CPU: the slot-to-pixel arithmetic the kernel does against the twin's
tile maps, the camera's one copy against four ``as_tensor`` calls, and when
the kernel runs. On the card (each case skips without one): the kernel
against the twin, bit for bit, on 1080p frames, orbit views, odd sizes,
offset tiles and a degenerate ``up``, with the twin's output contract, and
the launch and ray counters. This file imports neither the JAX package nor
flax:

    python -m pytest tests/test_torch_raygen.py -q
"""
import json
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from realtrace_tpu_torch.ops import raygen
from realtrace_tpu_torch.render import pipeline
from realtrace_tpu_torch.render.camera import Camera
from realtrace_tpu_torch.render.pipeline import _tile_maps, _tiled_rays, _tiled_rays_reference
from realtrace_tpu_torch.utils.profiling import RECORDER
from rtbench import scene as bench_scene
from test_torch_cuda import cuda  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
BOB = json.loads((ROOT / "rtbench" / "configs" / "bob_1080p.json").read_text())
ORBIT = json.loads((ROOT / "rtbench" / "traffic" / "orbit.json").read_text())


def recording():
    """A profiler session, so that the program's spans count."""
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                  acc_events=True)


def camera_of(cam: dict, width: int, height: int, device, dtype=torch.float32) -> Camera:
    return Camera.make(cam["position"], cam["target"], cam["up"], cam["fovy"], width, height,
                       dtype=dtype, device=device)


# -- on the CPU ------------------------------------------------------------------

def slot_pixels(tile_w: int, tile_h: int):
    """The kernel's arithmetic, one slot at a time: the slot's 32x32 tile,
    its row and column in the tile, the tile's row and column in the padded
    grid; (column, row from the bottom, valid) of each slot."""
    wp = -(-tile_w // 32) * 32
    hp = -(-tile_h // 32) * 32
    ii, jj, valid = [], [], []
    for s in range(wp * hp):
        tile, inside = divmod(s, 1024)
        row, col = divmod(tile, wp // 32)
        ty, tx = divmod(inside, 32)
        i, j = col * 32 + tx, row * 32 + ty
        ok = i < tile_w and j < tile_h
        ii.append(i if ok else 0)
        jj.append(j if ok else 0)
        valid.append(ok)
    return np.array(ii), np.array(jj), np.array(valid)


@pytest.mark.parametrize("size", [(1, 1), (32, 32), (97, 61), (64, 16), (33, 100), (200, 72)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_slot_to_pixel_arithmetic_equals_the_tile_maps(size):
    ii, jj, valid = _tile_maps(*size)
    got = slot_pixels(*size)
    for name, a, b in zip(("ii", "jj", "valid"), (ii, jj, valid), got):
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["tuples", "numpy", "ints"])
def test_camera_make_one_copy_equals_four_as_tensor_calls(dtype, kind):
    pos, tgt, up, fovy = (60.1, 60.3, 0.7), (0.1, -0.2, 0.3), (0.0, 1.0, 0.1), 45.3
    if kind == "numpy":
        pos, tgt, up = (np.asarray(x, np.float64) for x in (pos, tgt, up))
        fovy = np.float64(fovy)
    elif kind == "ints":
        pos, tgt, up, fovy = (60, 60, 0), (0, 0, 0), (0, 1, 0), 45
    cam = Camera.make(pos, tgt, up, fovy, 97, 61, dtype=dtype, device="cpu")
    for got, x in zip((cam.position, cam.target, cam.up, cam.fovy), (pos, tgt, up, fovy)):
        want = torch.as_tensor(x, dtype=dtype)
        assert got.dtype == dtype and got.shape == want.shape and torch.equal(got, want)
    storages = {x.untyped_storage().data_ptr() for x in (cam.position, cam.target, cam.up,
                                                         cam.fovy)}
    assert len(storages) == 1      # views of the one buffer that was copied


def test_camera_make_refuses_a_wrong_count_of_numbers():
    with pytest.raises(ValueError, match="numbers"):
        Camera.make((0, 0, 1), (0, 0, 0), (0, 1), 45.0, 8, 8, device="cpu")


def stand_in(device="cuda", dtype=torch.float32, requires_grad=False):
    """What ``takes`` reads of a camera: CUDA tensors need no card here."""
    x = types.SimpleNamespace(device=torch.device(device), dtype=dtype,
                              requires_grad=requires_grad)
    return types.SimpleNamespace(position=x, target=x, up=x, fovy=x)


@pytest.mark.parametrize("case, grad, want", [
    (dict(), True, True), (dict(), False, True),
    (dict(device="cpu"), True, False), (dict(device="meta"), False, False),
    (dict(dtype=torch.float64), True, False), (dict(dtype=torch.float16), True, False),
    (dict(requires_grad=True), True, False), (dict(requires_grad=True), False, True),
], ids=["kernel", "no-grad", "cpu", "meta", "float64", "float16", "grad-recorded",
        "requires-grad-under-no-grad"])
def test_the_kernel_runs_on_a_cuda_float32_camera_with_no_gradient_recorded(case, grad, want):
    with torch.set_grad_enabled(grad):
        assert raygen.takes(stand_in(**case)) is want


def test_a_cpu_camera_takes_the_twin_and_counts_its_rays(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the raygen kernel was launched for a CPU camera")

    monkeypatch.setattr(raygen, "raygen_kernel", refuse)
    cam = camera_of(BOB["camera"], 97, 61, "cpu")
    with recording():
        before = len(RECORDER.log)
        ro, rd, coeff = _tiled_rays(cam)
        logged = list(RECORDER.log)[before:]
    assert logged == [("rt.p.raygen", {"rays": 128 * 64})]
    want = _tiled_rays_reference(cam, 0, 0, 97, 61)
    for a, b in zip((ro, rd, coeff), want):
        assert torch.equal(a, b)


def test_a_camera_that_requires_grad_takes_the_twin_and_keeps_the_graph():
    cam = camera_of(BOB["camera"], 40, 24, "cpu")
    pos = cam.position.clone().requires_grad_(True)
    cam = Camera(position=pos, target=cam.target, up=cam.up, fovy=cam.fovy, width=40, height=24)
    assert not raygen.takes(cam)
    ro, rd, _ = _tiled_rays(cam)
    assert rd.requires_grad and ro.requires_grad


# -- on the card ---------------------------------------------------------------


def views():
    """The ``bob_1080p`` camera and three views of the orbit traffic."""
    out = {"bob_1080p": BOB["camera"]}
    for seed, k in ((7, 0), (2718281611, 5), (1618033924, 17)):
        out[f"orbit-{seed}-{k}"] = bench_scene.orbit_view(BOB, ORBIT,
                                                          bench_scene.orbit_phases(seed), k)
    return out


VIEWS = views()
DEGENERATE = dict(position=(0.0, 10.0, 0.0), target=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0),
                  fovy=45.0)


def same_bits(a, b) -> bool:
    return (a.shape == b.shape and a.stride() == b.stride()
            and torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)))


def both_ways(camera, i0=0, j0=0, tile_w=None, tile_h=None):
    """The kernel's (ro, rd, coeff) and the twin's, after checking that the
    kernel ran once and matches the twin bit for bit, strides included."""
    tile_w = camera.width if tile_w is None else tile_w
    tile_h = camera.height if tile_h is None else tile_h
    before = raygen.raygen_kernel.launches
    got = _tiled_rays(camera, i0, j0, tile_w, tile_h)
    assert raygen.raygen_kernel.launches == before + 1
    want = _tiled_rays_reference(camera, i0, j0, tile_w, tile_h)
    torch.cuda.synchronize()
    for name, a, b in zip(("ro", "rd", "coeff"), got, want):
        assert (a is None) == (b is None), name
        if a is not None:
            assert same_bits(a, b), (name, int((a != b).any(dim=-1).sum()), a.shape[0])
    return got


@pytest.mark.parametrize("view", list(VIEWS))
def test_kernel_equals_twin_at_1080p(cuda, view):
    cam = camera_of(VIEWS[view], 1920, 1080, cuda)
    ro, rd, coeff = both_ways(cam)
    assert rd.shape == (1920 * 1088, 3)
    # the contract: coeff an (R, 1) buffer seen as (R, 3); ro a buffer of its own
    assert coeff.shape == (rd.shape[0], 3) and coeff.stride() == (1, 0)
    assert ro.is_contiguous() and int(coeff[:, 0].sum()) == 1920 * 1080


def test_kernel_equals_twin_on_a_frame_of_whole_tiles(cuda):
    cam = camera_of(BOB["camera"], 256, 128, cuda)
    ro, rd, coeff = both_ways(cam)
    assert coeff is None
    assert ro.stride() == (0, 1) and ro.data_ptr() == cam.position.data_ptr()


@pytest.mark.parametrize("size", [(97, 61), (1, 1), (33, 7)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_kernel_equals_twin_at_odd_sizes(cuda, size):
    both_ways(camera_of(VIEWS["orbit-7-0"], *size, cuda))


@pytest.mark.parametrize("tile", [
    (0, 0, 1920, 40), (0, 520, 1920, 40), (0, 1040, 1920, 40),   # progressive bands of 40 rows
    (960, 540, 960, 540), (0, 540, 960, 540),                    # shards: quarter frames
    (100, 37, 97, 61),
], ids=lambda t: "i0={},j0={},{}x{}".format(*t))
def test_kernel_equals_twin_on_offset_tiles(cuda, tile):
    both_ways(camera_of(BOB["camera"], 1920, 1080, cuda), *tile)


def test_kernel_equals_twin_where_up_is_parallel_to_the_view(cuda):
    ro, rd, coeff = both_ways(camera_of(DEGENERATE, 97, 61, cuda))
    # u and v normalize to zero: every valid ray looks straight down
    down = rd[coeff[:, 0] > 0]
    assert bool((down[:, [0, 2]] == 0).all()) and bool((down == down[0]).all())
    assert float(down[0, 1]) == pytest.approx(-1.0)


def test_the_kernel_span_counts_the_rays_it_made(cuda):
    cam = camera_of(BOB["camera"], 97, 61, cuda)
    with recording():
        before = len(RECORDER.log)
        _tiled_rays(cam)
        logged = list(RECORDER.log)[before:]
    assert logged == [("rt.p.kernel.raygen", {"rays": 128 * 64}),
                      ("rt.p.raygen", {"rays": 128 * 64})]


def test_a_cuda_camera_that_records_a_gradient_takes_the_twin(cuda):
    cam = camera_of(BOB["camera"], 97, 61, cuda)
    cam = Camera(position=cam.position.clone().requires_grad_(True), target=cam.target,
                 up=cam.up, fovy=cam.fovy, width=97, height=61)
    before = raygen.raygen_kernel.launches
    ro, rd, _ = _tiled_rays(cam)
    assert raygen.raygen_kernel.launches == before and rd.requires_grad
    with torch.no_grad():
        _tiled_rays(cam)
    assert raygen.raygen_kernel.launches == before + 1


def frame_inputs(device):
    from realtrace_tpu_torch.apps import scenes
    from realtrace_tpu_torch.core.types import RenderConfig
    from realtrace_tpu_torch.ops import accel

    cfg = RenderConfig(accel="sweep", max_depth=2)
    scene, cam = scenes.mesh_scene(detail=0.2, device=device)
    return accel.with_chunks(scene, cfg), scenes.make_camera(cam, 64, 48, device=device), cfg


def test_a_frame_through_the_pipeline_launches_the_kernel_once(cuda):
    before = raygen.raygen_kernel.launches
    pipeline.render_buffer(*frame_inputs(cuda))
    assert raygen.raygen_kernel.launches == before + 1
