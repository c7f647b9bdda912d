"""The sweep's CUDA kernel on the card: against its twin, and a render on the
card against the same render on the CPU. The kernel has no CPU mode, so
every case here skips without a CUDA card; this file imports neither the JAX
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
        pytest.skip("needs a CUDA card: the sweep kernel has no CPU mode")
    return torch.device("cuda")


def soup_pack(device, n=300, seed=3):
    rng = np.random.default_rng(seed)
    b = SceneBuilder(device=device)
    for ctr in rng.uniform(-10, 10, (n, 3)):
        tri = ctr + rng.uniform(-3, 3, (3, 3))
        b.add_triangle(tri[0], tri[1], tri[2])
    return sweep.build_pack(accel.with_chunks(b.build(), CFG), CFG)


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
    scene, _ = scenes.mesh_scene(detail=0.36)
    scene = accel.with_chunks(scene, CFG)
    on_card = sweep.build_pack(scene.to(cuda), CFG)
    on_cpu = sweep.build_pack(scene, CFG)
    for f in dataclasses.fields(on_cpu):
        a = getattr(on_card, f.name)
        if isinstance(a, torch.Tensor):
            assert a.device.type == "cuda"
            assert torch.equal(a.cpu(), getattr(on_cpu, f.name))
