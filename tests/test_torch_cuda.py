"""The sweep's two CUDA kernels (resident and streaming) on the card: against
their twin and against each other, and renders on the card against the same
renders on the CPU, and gradients through the kernel (equal to the twin's,
no launch in the backward, bit-identical twice). The chunk-mask kernel
against its twin, bit for bit, and a depth-10 frame through either. A glass
model at depth 10 through the lane-repacked wavefront: bit-identical twice,
equal to the CPU render, and the lanes each level holds. The kernels have no CPU
mode, so every case here skips without a CUDA card; this file imports
neither the JAX package nor flax, so it runs where only the port is
installed:

    python -m pytest tests/test_torch_cuda.py -q
"""
import dataclasses

import numpy as np
import pytest
import torch

from realtrace_tpu_torch.apps import scenes
from realtrace_tpu_torch.core.types import PARK_DISTANCE, Materials, RenderConfig, SceneBuilder
from realtrace_tpu_torch.ops import accel, sweep
from realtrace_tpu_torch.render.pipeline import _tiled_rays, render_with_stats

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


def wide_fan_rays(device, nt, seed=6):
    """nt tiles of rays from origins around the soup towards it, wide enough
    that the warps of a tile enter different chunks; a few parked lanes and a
    whole parked warp."""
    rng = np.random.default_rng(seed)
    o = np.repeat(rng.uniform(-25, 25, (nt * 8, 3)), sweep.WARP_RAYS, axis=0)
    d = -o / np.linalg.norm(o, axis=1, keepdims=True) + 0.25 * rng.standard_normal(o.shape)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o[7:50], d[7:50] = PARK_DISTANCE, (1.0, 0.0, 0.0)
    o[256:384], d[256:384] = PARK_DISTANCE, (1.0, 0.0, 0.0)
    return (torch.as_tensor(o, dtype=torch.float32, device=device),
            torch.as_tensor(d, dtype=torch.float32, device=device))


def both_kernels_against_twin(pack, cfg, ro, rd, exact, any_mode):
    """Each kernel against the gated twin, results and ``tested``; the two
    kernels against each other; gate on against gate off."""
    ro32, rd32, chunk_list, entry, counts = sweep.sweep_inputs(ro, rd, pack, cfg, exact)
    args = (ro32, rd32, pack.consts, pack.meta, chunk_list, counts, entry, 1e-7, 1e-4, any_mode)
    nt = counts.shape[0]
    n_s, n_r, n_t, n_off = (torch.zeros((nt, sweep.WARPS), dtype=torch.int32, device=ro.device)
                            for _ in range(4))
    before = sweep.sweep.launches, sweep.sweep.stream_launches
    st, si = sweep.sweep(*args, tested=n_s, stream=True, lo=pack.lo, hi=pack.hi)
    kt, ki = sweep.sweep(*args, tested=n_r, lo=pack.lo, hi=pack.hi)
    torch.cuda.synchronize()
    assert (sweep.sweep.launches, sweep.sweep.stream_launches) == (before[0] + 1, before[1] + 1)
    rt, ri = sweep.sweep_reference(*args, tested=n_t, lo=pack.lo, hi=pack.hi)
    assert 0 < int((ri >= 0).sum()) < ri.numel()
    assert torch.equal(ki, ri) and torch.equal(kt, rt)
    assert torch.equal(si, ri) and torch.equal(st, rt)
    assert torch.equal(n_r, n_t) and torch.equal(n_s, n_t)
    assert 0 < int(n_t.sum()) < int(counts.sum()) * sweep.WARPS
    for stream in (False, True):                      # gate off: same results, more work
        ot, oi = sweep.sweep(*args, tested=n_off, stream=stream)
        ref_off = torch.zeros_like(n_off)
        sweep.sweep_reference(*args, tested=ref_off)
        assert torch.equal(oi, ri) and torch.equal(ot, rt)
        assert torch.equal(n_off, ref_off) and bool((n_off >= n_t).all())


@pytest.mark.parametrize("exact", [False, True], ids=["interval", "exact"])
@pytest.mark.parametrize("any_mode", [False, True], ids=["closest", "any"])
def test_kernel_equals_twin(cuda, any_mode, exact):
    """The kernels round every step as the twin does: results are equal."""
    both_kernels_against_twin(soup_pack(cuda), CFG, *fan_rays(cuda), exact, any_mode)


@pytest.mark.parametrize("chunk_size", [32, 256, 512], ids=["c32", "c256", "c512"])
@pytest.mark.parametrize("any_mode", [False, True], ids=["closest", "any"])
def test_stream_kernel_equals_twin_and_resident_kernel(cuda, any_mode, chunk_size):
    """The streaming kernel against the twin and the resident kernel, results
    and tested positions, bit for bit; c512 needs more than 48 KB of dynamic
    shared memory for its ring."""
    cfg = dataclasses.replace(CFG, chunk_size=chunk_size)
    both_kernels_against_twin(soup_pack(cuda, n=2000, cfg=cfg), cfg, *fan_rays(cuda), False,
                              any_mode)


@pytest.mark.parametrize("nt", [1, 30], ids=["one-tile", "30-tiles"])
@pytest.mark.parametrize("any_mode", [False, True], ids=["closest", "any"])
def test_narrow_wavefronts_equal_twin(cuda, any_mode, nt):
    """A one-tile and a 30-tile wavefront (a deep level's width) over 63
    chunks of 32 (two list windows) and over chunks of 256: warps of one
    tile enter different chunks, one warp is parked."""
    for chunk_size in (32, 256):
        cfg = dataclasses.replace(CFG, chunk_size=chunk_size)
        pack = soup_pack(cuda, n=2000, cfg=cfg)
        ro, rd = wide_fan_rays(cuda, nt)
        both_kernels_against_twin(pack, cfg, ro, rd, False, any_mode)
    tested = torch.zeros((nt, sweep.WARPS), dtype=torch.int32, device=cuda)
    ro32, rd32, chunk_list, entry, counts = sweep.sweep_inputs(ro, rd, pack, cfg, False)
    sweep.sweep(ro32, rd32, pack.consts, pack.meta, chunk_list, counts, entry, 1e-7, 1e-4,
                any_mode, tested=tested, stream=True, lo=pack.lo, hi=pack.hi)
    assert int(tested[0, 2]) == 0 and int(tested[0].sum()) > 0      # the parked warp


@pytest.mark.parametrize("stream", [False, True], ids=["resident", "stream"])
@pytest.mark.parametrize("any_mode", [False, True], ids=["closest", "any"])
def test_kernels_write_every_tested_entry(cuda, any_mode, stream):
    """The program's counter hands each launch an unwritten ``torch.empty``
    buffer: both kernels write every (tile, warp) entry, a parked warp's 0
    included, equal to the twin's."""
    pack = soup_pack(cuda)
    ro, rd = wide_fan_rays(cuda, 30)
    ro32, rd32, chunk_list, entry, counts = sweep.sweep_inputs(ro, rd, pack, CFG)
    args = (ro32, rd32, pack.consts, pack.meta, chunk_list, counts, entry, 1e-7, 1e-4, any_mode)
    tested = torch.full((30, sweep.WARPS), -1, dtype=torch.int32, device=cuda)
    sweep.sweep(*args, tested=tested, stream=stream, lo=pack.lo, hi=pack.hi)
    want = torch.zeros_like(tested)
    sweep.sweep_reference(*args, tested=want, lo=pack.lo, hi=pack.hi)
    assert torch.equal(tested, want) and int(want[0, 2]) == 0 and int(want.sum()) > 0


def test_stream_kernel_rejects_misaligned_and_non_contiguous(cuda):
    pack = soup_pack(cuda)
    ro, rd = fan_rays(cuda, nt=2)
    ro32, rd32, chunk_list, entry, counts = sweep.sweep_inputs(ro, rd, pack, CFG)
    flat = torch.empty(pack.consts.numel() + 1, device=cuda)
    off = flat[1:].view_as(pack.consts).copy_(pack.consts)      # 4 bytes off a 16-byte line
    assert off.is_contiguous() and off.data_ptr() % 16 == 4
    for stream in (False, True):
        with pytest.raises(ValueError, match="aligned"):
            sweep.sweep(ro32, rd32, off, pack.meta, chunk_list, counts, entry, 1e-7, 1e-4,
                        stream=stream)
    with pytest.raises(ValueError, match="contiguous"):
        sweep.sweep(ro32, rd32, pack.consts, pack.meta, chunk_list, counts,
                    entry.t().contiguous().t(), 1e-7, 1e-4, stream=True)
    with pytest.raises(ValueError, match="contiguous"):
        sweep.sweep(ro32, rd32, pack.consts, pack.meta, chunk_list, counts, entry, 1e-7, 1e-4,
                    lo=pack.lo.t().contiguous().t(), hi=pack.hi)


def test_refused_launch_raises(cuda, monkeypatch):
    """Past the wrapper's own check, a ring the card cannot give is refused by
    the CUDA runtime, and the refusal is raised, not swallowed."""
    pack = soup_pack(cuda)
    ro, rd = fan_rays(cuda, nt=2)
    ro32, rd32, chunk_list, entry, counts = sweep.sweep_inputs(ro, rd, pack, CFG)
    huge = torch.zeros((1, 4096, sweep.NCOEF), device=cuda)
    one = torch.zeros((2, 1), dtype=torch.int32, device=cuda)
    for stream in (False, True):
        with pytest.raises(ValueError, match="shared memory"):
            sweep.sweep(ro32, rd32, huge, pack.meta[:1], one, counts, one.float(), 1e-7, 1e-4,
                        stream=stream)
    monkeypatch.setattr(sweep, "MAX_DYNAMIC_SMEM", 1 << 30)
    for stream in (False, True):
        with pytest.raises(RuntimeError, match="launch failed"):
            sweep.sweep(ro32, rd32, huge, pack.meta[:1], one, counts, one.float(), 1e-7, 1e-4,
                        stream=stream)
    torch.cuda.synchronize()
    args = (ro32, rd32, pack.consts, pack.meta, chunk_list, counts, entry, 1e-7, 1e-4)
    kt, ki = sweep.sweep(*args)                       # the card still takes launches
    rt, ri = sweep.sweep_reference(*args)
    assert torch.equal(ki, ri) and torch.equal(kt, rt)


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


# the glass-orbit configuration's material on mesh_scene's mesh, at depth 10
GLASS = dict(ka=0.4, kd=0.9, ks=0.4, kr=0.1, kt=0.8, eta=2.0)
DEPTH10 = dataclasses.replace(CFG, max_depth=10)


def glass_model(device, width=160, height=128):
    """mesh_scene with every triangle glass, from 0.6 of the serial framing's
    distance: every hit splits into a reflect and a refract child, down all
    ten levels of the lane-repacked wavefront."""
    scene, cam = scenes.mesh_scene(detail=0.36, device=device)
    n = scene.tri_vertices.shape[0]
    scene = dataclasses.replace(scene, tri_materials=Materials(
        **{k: torch.full((n,), v, device=device) for k, v in GLASS.items()}))
    cam = dict(cam, position=(36.0, 36.0, 0.0))
    return (accel.with_chunks(scene, DEPTH10),
            scenes.make_camera(cam, width, height, device=device))


def test_glass_model_at_depth_10_on_card_is_bit_identical_twice(cuda):
    scene, camera = glass_model(cuda)
    a, na = render_with_stats(scene, camera, DEPTH10)
    b, nb = render_with_stats(scene, camera, DEPTH10)
    assert na == nb and torch.equal(a, b)
    assert na > 10 * 160 * 128


def test_glass_model_at_depth_10_on_card_equals_render_on_cpu(cuda):
    """Within the glass tolerance of the forced-stream test above: the CPU
    and the card round f32 shading differently, which moves a few grazing
    children across a hit/miss edge."""
    (a, na), (b, nb) = (render_with_stats(*glass_model(dev), DEPTH10)
                        for dev in (torch.device("cpu"), cuda))
    assert abs(na - nb) <= 0.002 * na
    err = (a - b.cpu()).abs().amax(-1)
    assert float((err > 1e-4).float().mean()) <= 0.002, float(err.max())


def test_glass_model_levels_hold_their_live_lanes_on_card(cuda):
    from realtrace_tpu_torch.utils import profiling

    scene, camera = glass_model(cuda)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        _, nrays = render_with_stats(scene, camera, DEPTH10)
    counted = [profiling.RECORDER.read(f"rt.p.level.{k}", 1)[0] for k in range(11)]
    assert sum(c["rays"] for c in counted) == nrays
    for c in counted:
        assert c["live"] <= c["lanes"] <= -(-c["live"] // 1024) * 1024
    assert counted[-1]["live"] > 0


@pytest.mark.parametrize("any_mode", [False, True], ids=["closest", "any"])
def test_duplicated_serial_scene_hits_equal_twin(cuda, tmp_path, any_mode):
    """duplicated_serial_scene(4) of mesh_scene's mesh written as an OBJ
    (43,008 triangles, the streaming kernel's size): its vertices equal
    duplicated_mesh_scene(4)'s, and both kernels' hits on its primary rays
    equal the twin's."""
    tv, _ = scenes.mesh_arrays()
    path = tmp_path / "mesh.obj"
    path.write_text("".join("v {:.17g} {:.17g} {:.17g}\n".format(*p) for p in tv.reshape(-1, 3))
                    + "".join(f"f {k} {k + 1} {k + 2}\n" for k in range(1, 3 * len(tv), 3)))
    scene, cam = scenes.duplicated_serial_scene(4, path, device=cuda)
    assert torch.equal(scene.tri_vertices, scenes.duplicated_mesh_scene(4, device=cuda)[0]
                       .tri_vertices)
    scene = accel.with_chunks(scene, CFG)
    pack = sweep.build_pack(scene, CFG)
    assert not pack.resident
    ro, rd, _ = _tiled_rays(scenes.make_camera(cam, 256, 128, device=cuda))
    both_kernels_against_twin(pack, CFG, ro, rd, True, any_mode)


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


GRAD_FIELDS = ("tri_vertices", "tri_colors", "lights")


def card_grads(scene, camera, cfg=CFG):
    from realtrace_tpu_torch.core.types import tensor_leaves
    from realtrace_tpu_torch.diff.inverse import image_grad

    return tensor_leaves(image_grad(scene, camera, cfg, fields=GRAD_FIELDS)[1])


@pytest.fixture
def mesh_on_card(cuda):
    scene, cam = scenes.mesh_scene(detail=0.36, device=cuda)
    return accel.with_chunks(scene, CFG), scenes.make_camera(cam, 192, 128, device=cuda)


def test_grads_through_kernel_equal_grads_through_twin(mesh_on_card, monkeypatch):
    """The hits are bit-equal, so everything after them is the same arithmetic
    on the card: the gradients are too."""
    scene, camera = mesh_on_card
    kernel = card_grads(scene, camera)
    monkeypatch.setattr(sweep, "sweep",
                        lambda *a, stream=False, **k: sweep.sweep_reference(*a, **k))
    twin = card_grads(scene, camera)
    assert all(torch.equal(a, b) for a, b in zip(kernel, twin))
    assert all(bool(g.abs().max() > 0) for g in kernel)


def test_backward_launches_no_kernel(mesh_on_card):
    from realtrace_tpu_torch.diff.inverse import apply_params, scene_params
    from realtrace_tpu_torch.render.pipeline import render_buffer

    scene, camera = mesh_on_card
    params = {f: x.detach().requires_grad_(True)
              for f, x in scene_params(scene, ("tri_vertices", "tri_colors")).items()}
    before = sweep.sweep.launches
    loss = torch.mean(render_buffer(apply_params(scene, params), camera, CFG))
    forward = sweep.sweep.launches
    loss.backward()
    torch.cuda.synchronize()
    assert forward > before and sweep.sweep.launches == forward
    assert bool(params["tri_vertices"].grad.abs().max() > 0)


def test_backward_is_bit_identical_twice_and_with_or_without_remat(mesh_on_card):
    scene, camera = mesh_on_card
    a = card_grads(scene, camera)
    b = card_grads(scene, camera)
    c = card_grads(scene, camera, dataclasses.replace(CFG, remat=False))
    assert all(torch.equal(x, y) and torch.equal(x, z) for x, y, z in zip(a, b, c))


def test_progressive_band_on_card_equals_full_render(mesh_on_card):
    """Bands of 16 rows (half of each 32x32 wavefront tile parked) through
    the kernel equal the whole frame bit for bit; a band launches K1."""
    from realtrace_tpu_torch.render.pipeline import render_image
    from realtrace_tpu_torch.render.progressive import ProgressiveRenderer

    scene, camera = mesh_on_card
    pr = ProgressiveRenderer(scene, camera, CFG, band=16)
    before = sweep.sweep.launches
    pr.step()
    assert sweep.sweep.launches > before
    img = pr.render_all()
    assert torch.equal(img, render_image(scene, camera, CFG))


def test_sharded_render_world_size_one_over_nccl(mesh_on_card):
    import socket

    import torch.distributed as dist

    from realtrace_tpu_torch.parallel import mesh as pmesh
    from realtrace_tpu_torch.render.pipeline import render_image

    scene, camera = mesh_on_card
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    pmesh.init_distributed(f"127.0.0.1:{port}", 1, 0, backend="nccl")
    try:
        mesh = pmesh.make_mesh()
        img = pmesh.sharded_render(pmesh.replicate_scene(scene, mesh), camera, CFG, mesh)
        x = torch.arange(4.0, device=camera.position.device)
        dist.all_reduce(x)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    assert torch.equal(img, render_image(scene, camera, CFG))
    assert torch.equal(x.cpu(), torch.arange(4.0))


def test_samples_on_card_equal_cpu(cuda):
    from realtrace_tpu_torch.apps import samples

    assert torch.equal(samples.flashlight(64, 48, (30.5, 11.25), device=cuda).cpu(),
                       samples.flashlight(64, 48, (30.5, 11.25), device="cpu"))
    for sys_ in (0, 1, 2):
        assert torch.equal(samples.stability(64, 48, 0.1, sys_, device=cuda).cpu(),
                           samples.stability(64, 48, 0.1, sys_, device="cpu"))


@pytest.mark.parametrize("mode,knobs,launches", [
    ("merged", {"shadow_any_mode": False}, 5),
    ("unmerged", {"merge_queries": False}, 8),
], ids=["fully-merged", "unmerged"])
def test_query_mode_render_on_card_equals_default(mesh_on_card, mode, knobs, launches):
    """The fully merged mode (one closest query a level) and the unmerged mode
    (one shadow query per light) launch K1 5 and 8 times a depth-3 frame
    (the default 8) and render the default mode's image and rays."""
    scene, camera = mesh_on_card
    out = []
    for cfg in (CFG, dataclasses.replace(CFG, **knobs)):
        sweep.sweep.launches = sweep.sweep.stream_launches = 0
        img, n = render_with_stats(scene, camera, cfg)
        out.append((img, n, sweep.sweep.launches, sweep.sweep.stream_launches))
    (a, na, ka, sa), (b, nb, kb, sb) = out
    assert (ka, sa, kb, sb) == (8, 0, launches, 0)
    assert na == nb
    err = (a - b).abs().amax(-1)
    assert float((err > 1e-4).float().mean()) <= 0.002, float(err.max())


def test_chunked_hits_on_card_equal_cpu(cuda):
    """The chunked shortlist query is plain PyTorch, written one rounding a
    step: on the card it finds the CPU's triangles at the CPU's distances."""
    cfg = RenderConfig(accel="chunked", ray_block=2048, shortlist=24)
    scene, cam = scenes.mesh_scene(detail=0.36, device="cpu")
    scene = accel.with_chunks(scene, cfg)
    ro, rd, _ = _tiled_rays(scenes.make_camera(cam, 96, 64, device="cpu"))
    t_cpu, i_cpu = accel.closest_triangle(scene, ro, rd, cfg)
    t_card, i_card = accel.closest_triangle(scene.to(cuda), ro.to(cuda), rd.to(cuda), cfg)
    assert int((i_cpu >= 0).sum()) > 0
    assert torch.equal(i_card.cpu(), i_cpu) and torch.equal(t_card.cpu(), t_cpu)


def mask_case(device, nt, m, seed):
    """Chunk boxes and nt tiles of rays for the mask kernel against its twin:
    per tile a fan from one origin around the boxes, coherent enough that
    lists keep some chunks and drop others, wide enough that a tile's lanes
    span several octants; a few parked lanes and, from two tiles on, a wholly
    parked tile 1; direction components of exactly 0.0 and -0.0; origins and
    box faces at exactly +-0.0, and boxes that are the point 0; from three
    tiles on, one lane of tile 2 with a NaN direction."""
    rng = np.random.default_rng(seed)
    ctr = rng.uniform(-10, 10, (m, 3))
    half = rng.uniform(0.1, 2.0, (m, 3))
    lo, hi = (ctr - half).astype(np.float32), (ctr + half).astype(np.float32)
    lo[:5, 2], hi[5:10, 2], lo[10:15, 0] = 0.0, -0.0, -0.0
    lo[20:24], hi[20:24] = -0.0, 0.0
    o = np.repeat(rng.uniform(-20, 20, (nt, 3)), sweep.LANES, axis=0)
    o += rng.normal(0.0, 0.5, o.shape)
    d = -o + rng.normal(0.0, rng.choice([0.05, 0.5, 3.0], (nt, 1)).repeat(sweep.LANES, 0),
                        o.shape)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = o.astype(np.float32), d.astype(np.float32)
    o[::7, 2], o[3::7, 2], o[1::11, 0], o[::13] = 0.0, -0.0, -0.0, 0.0
    d[::5, 1], d[2::5, 1] = 0.0, -0.0
    o[7:50], d[7:50] = PARK_DISTANCE, (1.0, 0.0, 0.0)
    if nt >= 2:
        o[sweep.LANES:2 * sweep.LANES], d[sweep.LANES:2 * sweep.LANES] = PARK_DISTANCE, 1.0
    if nt >= 3:
        d[2 * sweep.LANES + 5] = np.nan
    return tuple(torch.as_tensor(x, device=device) for x in (o, d, lo, hi))


@pytest.mark.parametrize("nt,m", [(1, 336), (2040, 336), (5, 97), (1, 1536), (2000, 1536)],
                         ids=["nt1-m336", "nt2040-m336", "nt5-m97", "nt1-m1536", "nt2000-m1536"])
def test_mask_kernel_equals_twin(cuda, nt, m):
    """Lists, entries (as bits) and counts equal the twin's on the card.

    Which zero torch's amin/amax/minimum return on a tie of +0.0 and -0.0
    depends on the order of their reduction (on an H100 with torch 2.11,
    amin of [+0.0, -0.0] is -0.0 and of [-0.0, +0.0] is +0.0), so the twin's
    entry could be either where a box face and the octant's origins meet at
    zero (the boxes and origins at +-0.0 here); the twin and the kernel both
    turn a -0.0 entry into +0.0, and no other output depends on the sign of
    a zero."""
    ro, rd, lo, hi = mask_case(cuda, nt, m, seed=nt + m)
    before = sweep.mask_kernel.launches
    got = sweep.chunk_mask(ro, rd, lo, hi, nt)
    assert sweep.mask_kernel.launches == before + 1
    want = sweep.chunk_mask_reference(ro, rd, lo, hi, nt)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))
    counts = want[2]
    assert 0 < int(counts.max()) and int(counts.min()) < m
    if nt >= 2:
        assert int(counts[1]) == 0
        assert torch.equal(got[0][1].cpu(), torch.arange(m, dtype=torch.int32))
        assert not bool(got[1][1].any())


def test_depth10_frame_through_the_mask_kernel_equals_the_twins(cuda, monkeypatch):
    """A depth-10 frame of the serial framing's mesh (the benchmark's scene,
    at reduced resolution): every query's lists come from the kernel, one
    launch a sweep launch, and the frame is bit-identical with the lists of
    the twin."""
    cfg = RenderConfig(accel="sweep", max_depth=10)
    scene, cam = scenes.mesh_scene(device=cuda)
    scene = accel.with_chunks(scene, cfg)
    camera = scenes.make_camera(cam, 240, 136, device=cuda)
    masks, sweeps = sweep.mask_kernel.launches, sweep.sweep.launches
    img, n = render_with_stats(scene, camera, cfg)
    masks, sweeps = sweep.mask_kernel.launches - masks, sweep.sweep.launches - sweeps
    assert masks == sweeps > 2
    monkeypatch.setattr(sweep, "chunk_mask", sweep.chunk_mask_reference)
    img_twin, n_twin = render_with_stats(scene, camera, cfg)
    assert n == n_twin and torch.equal(img, img_twin)
