"""The readers of the program's own spans and counters and of the runtime's
synchronising calls (``rtbench/program.py``), on a synthetic Chrome trace."""
import json
import sys
import types

import pytest

from rtbench import manifest, program, trace


def chrome(path, events):
    path.write_text(json.dumps({"traceEvents": events}))
    return path


def frames_events(program_spans=True):
    """Two frames of 1000 us. Each: level 0 (a closest kernel span and a
    sync span), level 2 (a kernel launched inside, one sync inside a sync
    span, one outside it); the loop's own synchronize at the end of the
    frame, outside every program span. Kernels run 100 us after their
    launch."""
    ev = []
    corr = iter(range(1, 1000))

    def span(name, ts, dur, tid=1):
        if program_spans or not name.startswith("rt.p."):
            ev.append({"cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": tid})

    def runtime(name, ts, dur, c=None):
        e = {"cat": "cuda_runtime", "name": name, "ts": ts, "dur": dur, "tid": 1}
        if c is not None:
            e["args"] = {"correlation": c}
        ev.append(e)

    def kernel(launch, dur):
        c = next(corr)
        runtime("cudaLaunchKernel", launch, 1, c)
        ev.append({"cat": "kernel", "name": "k", "ts": launch + 100, "dur": dur,
                   "args": {"correlation": c}})

    for f0 in (10_000, 11_000):
        span("rt.frame", f0, 1000)
        span("rt.p.level.0", f0 + 10, 300)
        span("rt.p.kernel.closest", f0 + 20, 10)
        kernel(f0 + 25, 50)                         # level 0: 50 us
        span("rt.p.sync.ray_count", f0 + 200, 100)
        runtime("cudaStreamSynchronize", f0 + 210, 80)
        span("rt.p.level.2", f0 + 400, 400)
        kernel(f0 + 410, 30)                        # level 2: 30 us
        span("rt.p.sync.live_tiles", f0 + 600, 50)
        runtime("cudaStreamSynchronize", f0 + 605, 40)
        runtime("cudaEventSynchronize", f0 + 700, 5)       # unwrapped
        runtime("cudaDeviceSynchronize", f0 + 900, 90)     # the loop's own
    return ev


def stretch_of(tmp_path, monkeypatch, events):
    path = chrome(tmp_path / "trace.json", events)
    monkeypatch.setattr(program, "TRACE", path)
    ctx = types.SimpleNamespace(trace=trace.reduce_trace(path, "rt.frame"), notes={},
                                sweeps=[], arrays=None, device="cpu")
    return ctx, program.stretch(ctx)


def test_syncs_levels_and_idle_are_read_per_frame(tmp_path, monkeypatch):
    ctx, st = stretch_of(tmp_path, monkeypatch, frames_events())
    assert manifest.reader("metrics", "host_syncs.frame")(ctx) == 4.0
    assert manifest.reader("metrics", "deep_levels_device_ms.frame")(ctx) == \
        pytest.approx(0.030)
    spans = ctx.notes["program_spans"]
    assert spans["rt.p.level.0"]["device_ms"] == pytest.approx(0.050)
    assert spans["rt.p.level.0"]["syncs"] == 1.0
    assert spans["rt.p.level.0"]["sync_ms"] == pytest.approx(0.080)
    assert spans["rt.p.level.0"]["self_ms"] == pytest.approx(0.190)   # 300 - 10 - 100
    assert spans["rt.p.level.2"]["launches"] == 1.0
    assert ctx.notes["syncs_outside"] == {"rt.frame": 1.0, "rt.p.level.2": 1.0}
    assert ctx.notes["runtime_calls"]["cudaStreamSynchronize"] == 2.0
    # busy 125-175 and 510-540 of each frame; the gaps that begin inside a
    # sync span: none (the kernels end before them)
    idle = ctx.notes["idle_after_sync_ms"]
    assert idle["sync"] + idle["other"] == pytest.approx(0.920)
    assert program.stretch(ctx) is st          # read once a run


def test_an_idle_gap_that_begins_in_a_sync_span_is_told_apart(tmp_path, monkeypatch):
    ev = frames_events()
    # a long kernel launched by level 0 that ends inside the first sync span
    ev.append({"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 10_030, "dur": 1,
               "tid": 1, "args": {"correlation": 999}})
    ev.append({"cat": "kernel", "name": "long", "ts": 10_040, "dur": 200,
               "args": {"correlation": 999}})
    ctx, st = stretch_of(tmp_path, monkeypatch, ev)
    # frame 1: busy 40-240 and 510-540, its gap 240-510 began in rt.p.sync.ray_count
    assert st.idle_after_sync()["sync"] == pytest.approx(0.270 / 2)


def test_without_the_program_s_spans_only_the_syncs_are_read(tmp_path, monkeypatch):
    ctx, _ = stretch_of(tmp_path, monkeypatch, frames_events(program_spans=False))
    assert manifest.reader("metrics", "host_syncs.frame")(ctx) == 4.0
    assert manifest.reader("metrics", "deep_levels_device_ms.frame")(ctx) is None
    assert manifest.reader("metrics", "sweep_useful_share.frame")(ctx) is None
    assert ctx.notes["syncs_outside"] == {"rt.frame": 4.0}


def test_without_runtime_calls_there_are_no_syncs_to_count(tmp_path, monkeypatch):
    ev = [e for e in frames_events() if e["cat"] == "user_annotation"]
    ctx, _ = stretch_of(tmp_path, monkeypatch, ev)
    assert manifest.reader("metrics", "host_syncs.frame")(ctx) is None
    assert manifest.reader("metrics", "deep_levels_device_ms.frame")(ctx) is None
    ctx.trace = None
    assert manifest.reader("metrics", "host_syncs.step")(ctx) is None


def test_the_useful_share_matches_counters_to_calls(tmp_path, monkeypatch):
    from realtrace_tpu_torch.utils import profiling

    recorder = profiling.Recorder()
    for tested in (7, 1000, 3, 5):          # an earlier session's call, then the stretch's
        recorder.log.append(("rt.p.kernel.closest", dict(mode="closest", tested=tested,
                                                         warp_rays=128, chunk=32)))
    monkeypatch.setattr(profiling, "RECORDER", recorder)
    ctx, _ = stretch_of(tmp_path, monkeypatch, frames_events())
    assert ctx.notes["levels"]["0"]["rays"] is None      # no level counters logged
    read = manifest.reader("metrics", "sweep_useful_share.frame")
    mod = sys.modules["rtbench.metrics.sweep_useful_share_frame"]
    monkeypatch.setattr(mod, "Groups", lambda tv: None)
    monkeypatch.setattr(mod.roofline, "pairs", lambda ro, rd, t, g: (ro * 128 * 32, 1))
    ctx.arrays = {"tri_vertices": [[[0.0] * 3] * 3]}
    ctx.sweeps = [(2, None, None), (1, None, None)]       # required: 2 and 1 positions
    assert read(ctx) == pytest.approx(100.0 * 3 / 8)
    assert ctx.notes["sweep_useful_share"] == {0: [1.5 * 4096, 4.0 * 4096]}
    ctx.sweeps = ctx.sweeps[:1]                           # a call without its counter
    assert read(ctx) is None
