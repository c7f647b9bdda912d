"""The window's statistics, the reduction of a profiled stretch, the JAX
check and the refusals of the command."""
import json
import shutil
import subprocess
import sys
import types

import pytest
import torch

from rtbench import manifest, run, trace

ROOT = manifest.ROOT


def ctx(**kw):
    return types.SimpleNamespace(**kw)


def test_frame_time_is_the_window_over_its_frames():
    c = ctx(seconds=12.5, units=250, latencies=[0.05] * 250)
    assert manifest.reader("e2e", "frame_ms")(c) == pytest.approx(50.0)
    assert manifest.reader("e2e", "step_ms")(c) == pytest.approx(50.0)


def test_p95_is_the_nearest_rank_over_every_frame():
    read = manifest.reader("e2e", "frame_p95_ms")
    assert read(ctx(latencies=[i / 1e3 for i in range(1, 101)])) == pytest.approx(95.0)
    assert read(ctx(latencies=[i / 1e3 for i in range(200, 0, -1)])) == pytest.approx(190.0)
    assert read(ctx(latencies=[0.007])) == pytest.approx(7.0)


def test_merge_is_the_union_of_intervals():
    assert trace.merge([(5, 7), (0, 2), (1, 3), (3, 4), (8, 8)]) == [(0, 4), (5, 7)]


def chrome(path, events):
    path.write_text(json.dumps({"traceEvents": events}))
    return path


def stretch_events():
    """Two frames of 100 us; a mask span and a sweep span in each; kernels
    launched from inside and outside the spans; a copy; an event outside."""
    ev = []
    corr = iter(range(1, 100))

    def span(name, ts, dur, tid=1):
        ev.append({"cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": tid})

    def kernel(name, launch, ts, dur, cat="kernel"):
        c = next(corr)
        ev.append({"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": launch, "dur": 1,
                   "tid": 1, "args": {"correlation": c}})
        ev.append({"cat": cat, "name": name, "ts": ts, "dur": dur, "args": {"correlation": c}})

    for f0 in (1000, 1100):
        span("rt.frame", f0, 100)
        span("rt.mask", f0 + 10, 20)
        span("rt.sweep.closest", f0 + 40, 10)
        kernel("mask_op", f0 + 15, f0 + 20, 10)          # launched in the mask span
        kernel("sweep_kernel", f0 + 42, f0 + 45, 20)     # launched in the sweep span
        kernel("copy", f0 + 70, f0 + 60, 10, "gpu_memcpy")  # overlaps the sweep kernel by 5
    kernel("late", 1300, 1300, 50)                       # after the stretch
    return ev


def test_reduce_trace_host_device_and_idle(tmp_path):
    tr = trace.reduce_trace(chrome(tmp_path / "t.json", stretch_events()), "rt.frame")
    assert tr.units == 2 and tr.window_s() == pytest.approx(200e-6)
    assert tr.device_ms("sweep") == pytest.approx(0.020)
    assert tr.device_ms("mask") == pytest.approx(0.010)
    # busy: per frame [20,30] and [45,70] -> 35 us of 100
    assert tr.busy_s() == pytest.approx(70e-6)
    assert tr.kernels() == 4
    # 35 us busy a frame against frames of 140 us in the untraced window
    idle = manifest.reader("metrics", "idle_share.frame")(ctx(trace=tr, seconds=0.0014, units=10))
    assert idle == pytest.approx(75.0)
    assert manifest.reader("metrics", "kernel_launches.frame")(ctx(trace=tr)) == 2.0


def test_breakdown_labels_idle_gaps_by_the_innermost_span(tmp_path):
    tr = trace.reduce_trace(chrome(tmp_path / "t.json", stretch_events()), "rt.frame")
    b = tr.breakdown()
    assert len(b["device_ops"]) <= trace.TOP and len(b["idle_gaps"]) <= trace.TOP
    ops = dict(b["device_ops"])
    assert ops["sweep_kernel"] == pytest.approx(40e-6) and "late" not in ops
    gaps = dict(b["idle_gaps"])
    # each frame's gaps [0,20), [30,45) (the mask span ends at 30) and [70,100)
    # start outside every layer's span
    assert gaps["rt.frame"] == pytest.approx(130e-6)
    assert sum(gaps.values()) == pytest.approx(130e-6)


def test_metric_readers_find_nothing_without_a_trace():
    for m in manifest.load()["per_layer"]:
        c = ctx(trace=None, sweeps=[], host_ms={}, seconds=1.0, units=10)
        assert manifest.reader("metrics", m["name"])(c) is None


def test_the_clock_sums_a_layers_outermost_calls(monkeypatch):
    now = iter([0.0, 1.0, 5.0, 10.0, 12.0, 13.0, 20.0, 21.0])
    monkeypatch.setattr(trace.time, "perf_counter", lambda: next(now))
    c = trace.Clock()
    c.enter("mask")          # 0
    c.enter("mask")          # nested: not timed again
    c.leave("mask")
    c.enter("shade")         # 1
    c.leave("shade")         # 5
    c.leave("mask")          # 10
    assert c.seconds == {"mask": 10.0, "shade": 4.0}
    c.reset()
    c.enter("mask")          # 12
    c.leave("mask")          # 13
    assert c.seconds == {"mask": 1.0}


def test_host_time_readers_give_the_window_per_unit():
    c = ctx(host_ms={"mask": 31.5, "shade": 12.0, "resort": 4.0})
    assert manifest.reader("metrics", "mask_host_ms.frame")(c) == 31.5
    assert manifest.reader("metrics", "mask_host_ms.step")(c) == 31.5
    assert manifest.reader("metrics", "shade_host_ms.frame")(c) == 12.0
    assert manifest.reader("metrics", "resort_host_ms.step")(c) == 4.0


@pytest.mark.parametrize("name,banned", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True), ("flax.linen", True),
    ("realtrace_tpu", True), ("realtrace_tpu.core", True), ("realtrace_tpu.core.types", True),
    ("realtrace_tpu_torch", False), ("realtrace_tpu_torch.ops.sweep", False),
    ("jaxtyping", False), ("rtbench", False), ("torch", False)])
def test_jax_check_compares_whole_top_level_names(name, banned):
    assert (run.jax_modules({name: None}) == [name]) is banned


def test_a_run_loads_no_jax():
    assert run.jax_modules() == []


def test_emit_refuses_a_result_when_jax_was_loaded(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "realtrace_tpu", types.ModuleType("realtrace_tpu"))
    assert run.emit({"_extra": {}, "checks": {}}) == 3
    assert capsys.readouterr().out == ""


def test_without_a_card_the_command_exits_with_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "-m", "rtbench.run", "--workload", "bob-orbit",
                        "--seed", "3", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 2 and p.stdout == ""


def test_alone_in_a_directory_the_command_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "rtbench", tmp_path / "rtbench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    p = subprocess.run([sys.executable, "-m", "rtbench.run", "--workload", "bob-orbit",
                        "--seed", "3", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""
