"""The sweep's two CUDA kernels (resident and streaming) on the card: against
their twin and against each other, and renders on the card against the same
renders on the CPU. The kernels have no CPU mode, so every case here skips
without a CUDA card; this file imports neither the JAX
package nor flax, so it runs where only the port is installed:

    python -m pytest tests/test_torch_cuda.py -q
"""
import dataclasses

import numpy as np
import pytest
import torch

from realtrace_tpu_torch.apps import scenes
from realtrace_tpu_torch.core.types import PARK_DISTANCE, RenderConfig, SceneBuilder
from realtrace_tpu_torch.ops import accel, sweep
from realtrace_tpu_torch.render.pipeline import render_with_stats

CFG = RenderConfig(accel="sweep", max_depth=3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sweep kernels have no CPU mode")
    return torch.device("cuda")


def soup_pack(device, n=300, seed=3, cfg=CFG):
    rng = np.random.default_rng(seed)
    b = SceneBuilder(device=device)
    for ctr in rng.uniform(-10, 10, (n, 3)):
        tri = ctr + rng.uniform(-3, 3, (3, 3))
        b.add_triangle(tri[0], tri[1], tri[2])
    return sweep.build_pack(accel.with_chunks(b.build(), cfg), cfg)


def fan_rays(device, nt=4, seed=4):
    """Per tile a fan of rays from one origin, a few parked lanes."""
    rng = np.random.default_rng(seed)
    o = np.repeat(rng.uniform(-20, 20, (nt, 3)) + [0, 0, 30], sweep.LANES, axis=0)
    d = -o / np.linalg.norm(o, axis=1, keepdims=True) + 0.3 * rng.standard_normal(o.shape)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o[7:50], d[7:50] = PARK_DISTANCE, (1.0, 0.0, 0.0)
    return (torch.as_tensor(o, dtype=torch.float32, device=device),
            torch.as_tensor(d, dtype=torch.float32, device=device))


@pytest.mark.parametrize("exact", [False, True], ids=["interval", "exact"])
@pytest.mark.parametrize("any_mode", [False, True], ids=["closest", "any"])
def test_kernel_equals_twin(cuda, any_mode, exact):
    """The kernel rounds every step as the twin does: results are equal."""
    pack = soup_pack(cuda)
    ro, rd = fan_rays(cuda)
    ro32, rd32, chunk_list, entry, counts = sweep.sweep_inputs(ro, rd, pack, CFG, exact)
    args = (ro32, rd32, pack.consts, pack.meta, chunk_list, counts, entry, 1e-7, 1e-4, any_mode)
    launches = sweep.sweep.launches
    kt, ki = sweep.sweep(*args)
    torch.cuda.synchronize()
    assert sweep.sweep.launches == launches + 1
    rt, ri = sweep.sweep_reference(*args)
    assert 0 < int((ri >= 0).sum()) < ri.numel()
    assert torch.equal(ki, ri)
    assert torch.equal(kt, rt)


@pytest.mark.parametrize("chunk_size", [32, 256, 512], ids=["c32", "c256", "c512"])
@pytest.mark.parametrize("any_mode", [False, True], ids=["closest", "any"])
def test_stream_kernel_equals_twin_and_resident_kernel(cuda, any_mode, chunk_size):
    """The streaming kernel against the twin and the resident kernel, results
    and exit positions, bit for bit; c512 needs more than 48 KB of dynamic
    shared memory for its two stages."""
    cfg = dataclasses.replace(CFG, chunk_size=chunk_size)
    pack = soup_pack(cuda, n=2000, cfg=cfg)
    ro, rd = fan_rays(cuda)
    ro32, rd32, chunk_list, entry, counts = sweep.sweep_inputs(ro, rd, pack, cfg, False)
    args = (ro32, rd32, pack.consts, pack.meta, chunk_list, counts, entry, 1e-7, 1e-4, any_mode)
    before = sweep.sweep.launches, sweep.sweep.stream_launches
    v_s, v_r, v_t = (torch.zeros_like(counts) for _ in range(3))
    st, si = sweep.sweep(*args, visits=v_s, stream=True)
    kt, ki = sweep.sweep(*args, visits=v_r)
    torch.cuda.synchronize()
    assert (sweep.sweep.launches, sweep.sweep.stream_launches) == (before[0] + 1, before[1] + 1)
    rt, ri = sweep.sweep_reference(*args, visits=v_t)
    assert 0 < int((ri >= 0).sum()) < ri.numel()
    assert torch.equal(si, ri) and torch.equal(st, rt)
    assert torch.equal(si, ki) and torch.equal(st, kt)
    assert torch.equal(v_s, v_t) and torch.equal(v_r, v_t)


def test_stream_kernel_rejects_misaligned_and_non_contiguous(cuda):
    pack = soup_pack(cuda)
    ro, rd = fan_rays(cuda, nt=2)
    ro32, rd32, chunk_list, entry, counts = sweep.sweep_inputs(ro, rd, pack, CFG)
    flat = torch.empty(pack.consts.numel() + 1, device=cuda)
    off = flat[1:].view_as(pack.consts).copy_(pack.consts)      # 4 bytes off a 16-byte line
    assert off.is_contiguous() and off.data_ptr() % 16 == 4
    with pytest.raises(ValueError, match="aligned"):
        sweep.sweep(ro32, rd32, off, pack.meta, chunk_list, counts, entry, 1e-7, 1e-4,
                    stream=True)
    with pytest.raises(ValueError, match="contiguous"):
        sweep.sweep(ro32, rd32, pack.consts, pack.meta, chunk_list, counts,
                    entry.t().contiguous().t(), 1e-7, 1e-4, stream=True)
    huge = torch.zeros((1, 2048, sweep.NCOEF), device=cuda)     # two stages: 256 KB
    one = torch.zeros((2, 1), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        sweep.sweep(ro32, rd32, huge, pack.meta[:1], one, counts, one.float(), 1e-7, 1e-4,
                    stream=True)


@pytest.mark.parametrize("scene_fn", ["mesh", "glass"])
def test_forced_stream_render_on_card_equals_render_on_cpu(cuda, monkeypatch, scene_fn):
    """With no table resident, every query of the frame goes through the
    streaming kernel; the frame equals the CPU twin's. The CPU and the card
    round exp, sqrt and the divisions of f32 shading differently, which moves
    a few grazing children of the glass across a hit/miss edge: its ray
    counts may differ by 0.2%, the mesh's not at all."""
    make = scenes.mesh_scene if scene_fn == "mesh" else scenes.glass_mesh_scene
    monkeypatch.setattr(sweep, "RESIDENT_LIMIT", 0)
    out = []
    for dev in (torch.device("cpu"), cuda):
        scene, cam = make(detail=0.36, device=dev)
        scene = accel.with_chunks(scene, CFG)
        assert not sweep.build_pack(scene, CFG).resident
        before = sweep.sweep.launches, sweep.sweep.stream_launches
        img, n = render_with_stats(scene, scenes.make_camera(cam, 96, 64, device=dev), CFG)
        out.append((img.cpu(), n))
    assert sweep.sweep.launches == before[0] and sweep.sweep.stream_launches > before[1]
    (a, na), (b, nb) = out
    assert abs(na - nb) <= (0.002 * na if scene_fn == "glass" else 0)
    err = (a - b).abs().amax(-1)
    assert float((err > 1e-4).float().mean()) <= 0.002, float(err.max())


def test_glass_render_on_card_is_bit_identical_twice(cuda):
    scene, cam = scenes.glass_mesh_scene(detail=0.36, device=cuda)
    scene = accel.with_chunks(scene, CFG)
    camera = scenes.make_camera(cam, 160, 128, device=cuda)
    a, na = render_with_stats(scene, camera, CFG)
    b, nb = render_with_stats(scene, camera, CFG)
    assert na == nb and torch.equal(a, b)


def test_default_device_is_the_card(cuda):
    scene, cam = scenes.mesh_scene(detail=0.2)
    assert scene.tri_vertices.device.type == "cuda"
    assert scenes.make_camera(cam, 8, 8).position.device.type == "cuda"
    assert SceneBuilder().build().ambient.device.type == "cuda"


def test_wrapper_rejects_bad_inputs(cuda):
    pack = soup_pack(cuda)
    ro, rd = fan_rays(cuda, nt=2)
    ro32, rd32, chunk_list, entry, counts = sweep.sweep_inputs(ro, rd, pack, CFG)
    assert not chunk_list.t().contiguous().t().is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        sweep.sweep(ro32, rd32, pack.consts, pack.meta, chunk_list.t().contiguous().t(),
                    counts, entry, 1e-7, 1e-4)
    with pytest.raises(ValueError, match="is on"):
        sweep.sweep(ro32, rd32, pack.consts.cpu(), pack.meta, chunk_list, counts, entry,
                    1e-7, 1e-4)


def test_render_on_card_equals_render_on_cpu(cuda):
    """A small mesh_scene frame: CUDA kernel path against the CPU twin path."""
    out = []
    for dev in (torch.device("cpu"), cuda):
        scene, cam = scenes.mesh_scene(detail=0.36, device=dev)
        scene = accel.with_chunks(scene, CFG)
        img, n = render_with_stats(scene, scenes.make_camera(cam, 96, 64, device=dev), CFG)
        out.append((img.cpu(), n))
    (a, na), (b, nb) = out
    assert na == nb
    err = (a - b).abs().amax(-1)
    assert float((err > 1e-4).float().mean()) <= 0.002, float(err.max())


def test_pack_moves_with_scene(cuda):
    scene, _ = scenes.mesh_scene(detail=0.36, device="cpu")
    scene = accel.with_chunks(scene, CFG)
    on_card = sweep.build_pack(scene.to(cuda), CFG)
    on_cpu = sweep.build_pack(scene, CFG)
    for f in dataclasses.fields(on_cpu):
        a = getattr(on_card, f.name)
        if isinstance(a, torch.Tensor):
            assert a.device.type == "cuda"
            assert torch.equal(a.cpu(), getattr(on_cpu, f.name))
