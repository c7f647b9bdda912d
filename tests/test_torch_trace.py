"""The port's own spans and counters (``utils/profiling.py``): off without a
profiler, named ``rt.p.*`` under one, a span for every wavefront level whose
rays add up to the frame's, the sweep's tested counter against the twin's,
results bit-equal with and without the profiler, a log that keeps
profiling sessions apart, and the wavefront's layout called the same way at
every level, with the host syncs each level makes. CPU only, small shapes."""
import collections
import dataclasses

import pytest
import torch

from realtrace_tpu_torch.apps import scenes
from realtrace_tpu_torch.core.types import RenderConfig, tensor_leaves
from realtrace_tpu_torch.diff.inverse import make_train_step
from realtrace_tpu_torch.ops import accel, sweep
from realtrace_tpu_torch.render import shade
from realtrace_tpu_torch.render.pipeline import render_with_stats
from realtrace_tpu_torch.utils import profiling

CFG = RenderConfig(max_depth=3, accel="sweep")
W, H = 40, 32
# names the benchmark's own spans and its readers' selections use
BENCH_NAMES = ("rt.frame", "rt.step")
# each level's ``rt.p.sync`` spans, by site, in the mesh's frame at depth 3;
# level 0's hold its primary query's and its hits' compaction
LEVEL_SYNCS = {
    "default": [dict(ray_count=1, mask_const=6, live_tiles=2)]
    + [dict(ray_count=1, mask_const=4, live_tiles=1)] * 2 + [dict(ray_count=1, mask_const=2)],
    "merged": [dict(ray_count=1, mask_const=4, live_tiles=2)]
    + [dict(ray_count=1, mask_const=2, live_tiles=1)] * 2 + [dict(ray_count=1, mask_const=2)],
}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh():
    scene, cam = scenes.mesh_scene(detail=0.2, device="cpu")
    return accel.with_chunks(scene, CFG), scenes.make_camera(cam, W, H, device="cpu")


def profiler():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


class Ranges:
    """Stands in for ``torch.profiler.record_function``: the names of every
    range the program opens, which it still opens."""

    def __init__(self, monkeypatch):
        self.names = []
        real = torch.profiler.record_function
        ranges = self

        class Recorded(real):
            def __init__(self, name, *a, **k):
                ranges.names.append(name)
                super().__init__(name, *a, **k)
        monkeypatch.setattr(torch.profiler, "record_function", Recorded)


def annotations(prof) -> list:
    return [e.name for e in prof.events() if e.name.startswith("rt.")]


def traced_frame(scene, camera, cfg):
    """A frame under the profiler: (the calls of each layout's ``live``,
    ``_live_tiles`` and ``_live_lanes``; each level's ``rt.p.sync`` spans by
    site, a Counter a level in order)."""
    calls = collections.Counter()

    def counted(name, real):
        def spy(*a, **k):
            calls[name] += 1
            return real(*a, **k)
        return spy

    with pytest.MonkeyPatch.context() as mp, profiler() as prof:
        for name in ("_live_tiles", "_live_lanes"):
            mp.setattr(shade, name, counted(name, getattr(shade, name)))
        render_with_stats(scene, camera, cfg)
    spans = [e for e in prof.events() if e.name.startswith("rt.p.")]
    levels = sorted((e for e in spans if e.name.startswith("rt.p.level.")),
                    key=lambda e: int(e.name.rsplit(".", 1)[1]))
    syncs = [collections.Counter() for _ in levels]
    for e in spans:
        if e.name.startswith("rt.p.sync."):
            for lv, c in zip(levels, syncs):     # the one level that holds it
                if lv.time_range.start <= e.time_range.start <= lv.time_range.end:
                    c[e.name[len("rt.p.sync."):]] += 1
                    break
    return calls, syncs


def fit_step(scene, camera):
    target = torch.zeros((W * H, 3))
    step, params, _ = make_train_step(scene, camera, CFG, target, lr=1e-2)
    return step, tensor_leaves(params)


def test_recording_follows_the_profiler():
    assert not profiling.recording()
    with profiler():
        assert profiling.recording()
        with profiling.span("rt.p.test") as s:
            assert s.on
    assert not profiling.recording()
    with profiling.span("rt.p.test") as s:
        assert not s.on


def test_without_a_profiler_a_frame_opens_no_range_and_logs_nothing(mesh, monkeypatch):
    ranges = Ranges(monkeypatch)
    log = list(profiling.RECORDER.log)
    render_with_stats(*mesh, CFG)
    assert ranges.names == []
    assert list(profiling.RECORDER.log) == log


def test_a_traced_frame_has_every_level_and_its_rays_add_up(mesh):
    with profiler() as prof:
        _, nrays = render_with_stats(*mesh, CFG)
    names = annotations(prof)
    levels = [f"rt.p.level.{k}" for k in range(CFG.max_depth + 1)]
    assert [n for n in names if n.startswith("rt.p.level.")] == levels
    counted = [profiling.RECORDER.read(name, 1)[0] for name in levels]
    assert sum(c["rays"] for c in counted) == nrays
    assert counted[0]["tiles"] >= counted[-1]["tiles"] >= 0
    for layer in ("raygen", "mask", "kernel.mask", "kernel.closest", "kernel.any", "hits", "shade",
                  "compaction", "sync.ray_count", "sync.live_tiles", "sync.mask_const"):
        assert f"rt.p.{layer}" in names


@pytest.mark.parametrize("unit", ["frame", "fit step"])
def test_every_program_span_is_named_rt_p(mesh, monkeypatch, unit):
    scene, camera = mesh
    step = fit_step(scene, camera)[0] if unit == "fit step" else None
    ranges = Ranges(monkeypatch)
    with profiler() as prof:
        if step is None:
            render_with_stats(scene, camera, CFG)
        else:
            step()
    assert ranges.names and all(n.startswith("rt.p.") for n in ranges.names)
    assert not [n for n in ranges.names if n in BENCH_NAMES or n.startswith("rt.sweep")]
    assert set(ranges.names) <= set(annotations(prof))
    if step is not None:
        assert {"rt.p.backward", "rt.p.adam", "rt.p.resort", "rt.p.sync.resort"} <= set(
            ranges.names)


def test_a_frame_is_bit_equal_with_and_without_the_profiler(mesh):
    img0, n0 = render_with_stats(*mesh, CFG)
    with profiler():
        img1, n1 = render_with_stats(*mesh, CFG)
    assert n0 == n1 and torch.equal(img0, img1)


def test_a_fit_step_is_bit_equal_with_and_without_the_profiler(mesh):
    results = []
    for traced in (False, True):
        step, leaves = fit_step(*mesh)
        if traced:
            with profiler():
                loss = step()
        else:
            loss = step()
        results.append((loss, [p.grad.clone() for p in leaves], [p.detach().clone()
                                                                  for p in leaves]))
    (l0, g0, p0), (l1, g1, p1) = results
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


@pytest.mark.parametrize("any_mode", [False, True])
def test_the_tested_counter_is_the_twins(mesh, any_mode):
    scene, camera = mesh
    pack = sweep.build_pack(scene, CFG)
    ro = camera.position.expand(W * H, 3)
    rd = camera.ray_directions()
    ro32, rd32, chunk_list, entry, counts = sweep.sweep_inputs(ro, rd, pack, CFG)
    args = (ro32, rd32, pack.consts, pack.meta, chunk_list, counts, entry,
            float(CFG.det_epsilon), float(CFG.smallest_dist), any_mode)
    want = torch.zeros((counts.shape[0], sweep.WARPS), dtype=torch.int32)
    sweep.sweep_reference(*args, tested=want, lo=pack.lo, hi=pack.hi)
    with profiler():
        sweep.sweep(*args, lo=pack.lo, hi=pack.hi)
    name = "rt.p.kernel.any" if any_mode else "rt.p.kernel.closest"
    (c,) = profiling.RECORDER.read(name, 1)
    assert c["mode"] == ("any" if any_mode else "closest")
    assert c["tested"] * c["warp_rays"] * c["chunk"] == \
        int(want.sum()) * sweep.WARP_RAYS * pack.chunk_size > 0


def test_the_mask_span_counts_tiles_and_listed(mesh):
    """Each query's mask call runs in ``rt.p.kernel.mask`` inside ``rt.p.mask``
    and, recording, counts its tiles and listed chunks; off, it counts
    nothing."""
    scene, camera = mesh
    pack = sweep.build_pack(scene, CFG)
    ro = camera.position.expand(W * H, 3)
    rd = camera.ray_directions()
    log = list(profiling.RECORDER.log)
    *_, counts = sweep.sweep_inputs(ro, rd, pack, CFG, exact_mask=False)
    assert list(profiling.RECORDER.log) == log
    with profiler() as prof:
        sweep.sweep_inputs(ro, rd, pack, CFG, exact_mask=False)
    (c,) = profiling.RECORDER.read("rt.p.kernel.mask", 1)
    assert c == dict(tiles=counts.shape[0], listed=int(counts.sum()))
    assert 0 < c["listed"] < c["tiles"] * pack.n_chunks
    names = annotations(prof)
    assert names.index("rt.p.mask") < names.index("rt.p.kernel.mask")


@pytest.fixture(scope="module", params=["default", "merged"])
def mesh_traced(mesh, request):
    cfg = dataclasses.replace(CFG, shadow_any_mode=request.param == "default")
    return request.param, traced_frame(*mesh, cfg)


def test_level_0_compacts_through_the_layout_of_every_level(mesh_traced):
    """A wavefront without dielectrics keeps whole tiles: ``_live_tiles``
    once at level 0, for its hits, and once at each level that queries
    children; the lanes' never."""
    _, (calls, _) = mesh_traced
    assert calls == {"_live_tiles": 1 + CFG.max_depth}


def test_each_level_makes_its_host_syncs(mesh_traced):
    mode, (_, syncs) = mesh_traced
    assert syncs == LEVEL_SYNCS[mode]


def test_two_sessions_read_only_the_second(mesh):
    scene, camera = mesh
    with profiler():
        for _ in range(2):
            render_with_stats(scene, camera, CFG)
    shallow = RenderConfig(max_depth=1, accel="sweep")
    with profiler() as prof:
        _, nrays = render_with_stats(scene, camera, shallow)
    names = annotations(prof)
    counted = [c for k in range(3)
               for c in profiling.RECORDER.read(f"rt.p.level.{k}",
                                                names.count(f"rt.p.level.{k}"))]
    assert len(counted) == 2 and sum(c["rays"] for c in counted) == nrays


def test_profile_frame_lists_the_program_spans(mesh):
    from realtrace_tpu_torch.apps import profile_frame

    with profiler() as prof:
        render_with_stats(*mesh, CFG)
    table = profile_frame.span_table(prof)
    assert [table[f"rt.p.level.{k}"]["calls"] for k in range(CFG.max_depth + 1)] == [1] * 4
    assert table["rt.p.kernel.closest"]["calls"] == table["rt.p.kernel.any"]["calls"] == 4
    assert table["rt.p.level.0"]["host_ms"] > 0
    assert all(row["host_ms"] >= 0 and row["device_ms"] == 0 for row in table.values())


def test_profile_frame_ties_device_work_to_the_span_that_launched_it():
    """A kernel launched inside a span from another thread counts in its device
    ms; the profiler's device-side copy of a range is not another call."""
    import json

    from realtrace_tpu_torch.apps import profile_frame

    events = [
        {"cat": "user_annotation", "name": "rt.p.backward", "ts": 100, "dur": 50, "tid": 1},
        {"cat": "gpu_user_annotation", "name": "rt.p.backward", "ts": 120, "dur": 40},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 110, "dur": 2, "tid": 2,
         "args": {"correlation": 7}},
        {"cat": "kernel", "name": "k", "ts": 130, "dur": 25, "args": {"correlation": 7}},
        {"cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 300, "dur": 2, "tid": 1,
         "args": {"correlation": 8}},
        {"cat": "gpu_memcpy", "name": "copy", "ts": 310, "dur": 9, "args": {"correlation": 8}},
    ]

    class Profile:
        def export_chrome_trace(self, path):
            with open(path, "w") as f:
                json.dump({"traceEvents": events}, f)

    assert profile_frame.span_table(Profile()) == {
        "rt.p.backward": dict(calls=1, host_ms=0.05, device_ms=0.025)}
