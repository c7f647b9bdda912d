"""The port's bench (``realtrace_tpu_torch/apps/bench.py``) on the CPU: each
leg's config, scenes and framing against the JAX bench's (``bench.py``,
``benchmarks/bench_bigcurve.py``), the big scenes' residency, a real run of
the legs that fit at 32x24, every leg's lines through fast stand-ins for the
renders, and the failure rules (a failed leg or check prints ``leg_failed``
and makes the exit code non-zero, no retry, ``RESIDENT_LIMIT`` restored, no
fallback without a card). The images of the legs against the JAX package
are in tests/test_torch_bench_jax.py."""
import dataclasses
import io
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from realtrace_tpu.core.types import RenderConfig as JConfig
from realtrace_tpu_torch.apps import bench, scenes
from realtrace_tpu_torch.core.convert import config_from_dict
from realtrace_tpu_torch.diff import inverse
from realtrace_tpu_torch.ops import sweep
from realtrace_tpu_torch.render.pipeline import render_with_stats
from test_torch_core import few_torch_threads  # noqa: F401 (autouse fixture)

REPO = Path(__file__).resolve().parent.parent
SERIAL = (60.0, 60.0, 0.0)                          # realtrace_tpu/apps/scenes.py:82
CLOSE = (0.0, 6.0, 14.0)                                                  # bench.py:418
# bench.py's configs with its environment at defaults (RT_BENCH_DEPTH=3)
HEAD = JConfig(max_depth=3, accel="pallas", chunk_size=32, ray_block=8192,
               exact_mask_rays=1 << 19, exact_mask_secondary=False)       # bench.py:386-390
BIG = JConfig(max_depth=2, accel="pallas", chunk_size=64)                 # bench.py:295, :317
# leg -> (the JAX config, [(scene kind, copies, camera position)] as the JAX leg renders them)
JAX_LEGS = {
    "headline": (HEAD, [("mesh", 1, SERIAL)]),                            # bench.py:408-413
    "hit-heavy": (HEAD, [("mesh", 1, CLOSE)]),                            # bench.py:415-426
    "grad": (HEAD, [("mesh", 1, SERIAL), ("mesh", 1, CLOSE)]),            # bench.py:431-440
    "train": (HEAD, [("mesh", 1, SERIAL)]),                               # bench.py:442-444
    "branching": (JConfig(max_depth=3, accel="pallas", chunk_size=32),    # bench.py:345-346
                  [("glass", 1, SERIAL)]),
    "stream": (BIG, [("mesh", 2, SERIAL)]),                               # bench.py:317-319
    "bigscene": (BIG, [("mesh", 4, SERIAL)]),                             # bench.py:295-297
    "bigcurve": (JConfig(max_depth=2, accel="pallas", chunk_size=64),     # bench_bigcurve.py:41
                 [("mesh", n, SERIAL) for n in (4, 8, 16)]),
    "depth10": (dataclasses.replace(HEAD, max_depth=10), [("mesh", 1, SERIAL)]),  # bench.py:461
}
UNITS = {"headline": "Mrays/s", "hit-heavy": "Mrays/s", "grad": "x", "train": "ms/step",
         "branching": "Mrays/s", "stream": "x", "bigscene": "Mrays/s", "bigcurve": "Mrays/s",
         "depth10": "Mrays/s"}
LINES = {"grad": 2, "bigcurve": 3}          # metrics a leg prints; 1 for the others


def run_bench(*argv):
    """(exit code, parsed stdout lines) of the bench on the CPU at 32x24."""
    out = io.StringIO()
    rc = bench.main(["--device", "cpu", "--width", "32", "--height", "24", *argv], out=out)
    return rc, [json.loads(line) for line in out.getvalue().splitlines()]


def check_metric_lines(recs, legs):
    """Lines of a successful run: each leg's count, units, names unique,
    headline last, on the CPU and named so."""
    assert [r.get("leg") for r in recs].count(None) == 0, recs
    for leg in legs:
        assert [r["leg"] for r in recs].count(leg) == LINES.get(leg, 1), leg
    assert len({r["metric"] for r in recs}) == len(recs)
    if "headline" in legs:
        assert recs[-1]["leg"] == "headline"
    for r in recs:
        assert r["unit"] == UNITS[r["leg"]] and r["vs_baseline"] is None
        assert r["device"] == "cpu" and r["metric"].startswith("[cpu] ")
        assert r["busy_ms"] is None and r["idle_share"] is None and r["peak_device_bytes"] is None
        assert math.isfinite(r["value"]) and r["value"] >= 0
        assert r["q1_ms"] <= r["median_ms"] <= r["q3_ms"] and r["n"] == len(r["samples_ms"])


@pytest.mark.parametrize("leg", bench.LEGS)
def test_leg_config_equals_jax_bench(leg):
    jcfg, want = JAX_LEGS[leg]
    got = bench.leg_workloads(leg, depth=3)
    assert [w.cfg for w in got] == [config_from_dict(dataclasses.asdict(jcfg))] * len(want)
    assert [(w.kind, w.copies, bench.position(w)) for w in got] == want
    assert all(w.cfg.accel == "sweep" for w in got)
    # the camera the scene comes with is the JAX leg's
    scene, cam, _ = bench.build_scene(got[-1], device="cpu")
    assert tuple(float(x) for x in cam["position"]) == want[-1][2]
    assert scene.tri_chunk_perm is not None and scene.has_dielectrics() == (leg == "branching")


@pytest.mark.parametrize("leg,i,chunks,chunk,mb,resident", [
    ("stream", 0, 336, 64, 5.505024, True),
    ("bigscene", 0, 336, 128, 11.010048, False),
    ("bigcurve", 1, 336, 256, 22.020096, False),
    ("bigcurve", 2, 672, 256, 44.040192, False),
], ids=["x2", "x4", "x8", "x16"])
def test_big_scene_residency(leg, i, chunks, chunk, mb, resident):
    """x2 at chunk 64 fits RESIDENT_LIMIT (6 MiB as the JAX layout counts the
    table), x4, x8 and x16 stream."""
    w = bench.leg_workloads(leg, depth=3)[i]
    scene, _, _ = bench.build_scene(w, device="cpu")
    pack = sweep.build_pack(scene, w.cfg)
    assert (pack.n_chunks, pack.chunk_size, pack.table_bytes / 1e6) == (chunks, chunk, mb)
    assert pack.resident == resident
    assert scene.n_triangles == 10752 * w.copies


def test_bench_runs_on_cpu():
    """Legs 1 and 9 for real (a frame costs 1-2 s on the CPU): their lines,
    and each line's rays equal to render_with_stats of its scene."""
    rc, recs = run_bench("--reps", "1", "--legs", "1,9")
    assert rc == 0
    check_metric_lines(recs, ["headline", "depth10"])
    assert "depth-10" in recs[0]["metric"] and "depth-3" in recs[1]["metric"]
    for rec in recs:
        w = bench.leg_workloads(rec["leg"], depth=3)[0]
        scene, cam, label = bench.build_scene(w, device="cpu")
        assert f" {label} {scene.n_triangles} tris " in rec["metric"]
        _, n = render_with_stats(scene, scenes.make_camera(cam, 32, 24, device="cpu"), w.cfg)
        assert rec["rays_per_frame"] == n
        assert rec["frame_ms"] == rec["median_ms"] and rec["k1_per_frame"] == 0


@pytest.fixture
def quick_renders(monkeypatch):
    """Stand-ins for the render, the gradient and the train step (the real
    scenes are built, nothing is rendered): every leg runs in seconds. A
    stand-in frame counts one sweep launch a level."""
    def render(scene, camera, cfg):
        sweep.sweep.launches += cfg.max_depth
        return torch.full((camera.height, camera.width, 3), 0.5), 100 * cfg.max_depth

    def image_grad(scene, camera, cfg, loss_fn=None, fields=()):
        return torch.tensor(1.0), {f: torch.ones(2) for f in fields}

    def make_train_step(scene, camera, cfg, target, lr, fields):
        losses = iter(range(100, 0, -1))
        return (lambda: torch.tensor(float(next(losses)))), None, None

    monkeypatch.setattr(bench, "render_with_stats", render)
    monkeypatch.setattr(inverse, "image_grad", image_grad)
    monkeypatch.setattr(inverse, "make_train_step", make_train_step)


def test_every_leg_emits_its_lines(quick_renders):
    limit = sweep.RESIDENT_LIMIT
    rc, recs = run_bench("--reps", "3")
    assert rc == 0 and sweep.RESIDENT_LIMIT == limit
    check_metric_lines(recs, bench.LEGS)
    assert [r["leg"] for r in recs] == [leg for leg in bench.LEGS[1:]
                                        for _ in range(LINES.get(leg, 1))] + ["headline"]
    assert all(r["n"] == 3 for r in recs)
    by_leg = {r["leg"]: r for r in recs}
    assert by_leg["stream"]["resident_frames"]["resident"] and not by_leg["stream"]["resident"]
    assert by_leg["stream"]["residency_mb"] == 5.505024
    assert by_leg["train"]["steps"] == 2 + 3 and by_leg["train"]["last_loss"] < 100
    depth = {"stream": 2, "bigscene": 2, "bigcurve": 2, "depth10": 10}
    assert all(r["rays_per_frame"] == 100 * depth.get(r["leg"], 3) for r in recs)
    curve = [r for r in recs if r["leg"] == "bigcurve"]
    assert [r["copies"] for r in curve] == [4, 8, 16]
    # the x4 point is leg 7's samples, timed once
    assert curve[0]["same_samples_as"] == by_leg["bigscene"]["metric"]
    assert curve[0]["samples_ms"] == by_leg["bigscene"]["samples_ms"]
    assert "same_samples_as" not in curve[1]
    # the run's launches count every timed series once: x4 once, leg 6's resident and forced
    # series both, the forward frames that leg 3 reuses once
    series_depths = [3, 3, 3, 2, 2, 2, 2, 2, 10]    # 1, 2, 5, 6 (two), 7, 8 (x8, x16), 9
    assert by_leg["headline"]["run_k1_launches"] == 3 * sum(series_depths)
    assert by_leg["headline"]["run_k2_launches"] == 0
    assert {r["leg"] for r in recs if " framing (" in r["metric"]} == {
        "headline", "hit-heavy", "grad", "depth10"}


def test_a_failing_leg_fails_the_run_and_is_not_retried(quick_renders, monkeypatch):
    calls = []

    def broken(self):
        calls.append(1)
        raise RuntimeError("hit-heavy broke")

    monkeypatch.setattr(bench.Bench, "leg_hit_heavy", broken)
    rc, recs = run_bench("--reps", "2", "--legs", "1,2,5")
    assert rc == 1 and calls == [1]
    assert recs[0] == {"leg_failed": "hit-heavy", "error": "RuntimeError: hit-heavy broke"}
    check_metric_lines(recs[1:], ["branching", "headline"])


def test_stream_leg_restores_resident_limit_when_it_raises(quick_renders, monkeypatch):
    limit, forced = sweep.RESIDENT_LIMIT, []
    real = bench.Bench.frame_series

    def frame_series(self, w, reps, tag):
        if sweep.RESIDENT_LIMIT == 0:
            forced.append(tag)
            raise RuntimeError("the forced run broke")
        return real(self, w, reps, tag)

    monkeypatch.setattr(bench.Bench, "frame_series", frame_series)
    rc, recs = run_bench("--reps", "2", "--legs", "6,9")
    assert rc == 1 and forced == ["stream forced"]
    assert sweep.RESIDENT_LIMIT == limit
    assert recs[0]["leg_failed"] == "stream" and recs[1]["leg"] == "depth10"


def test_a_failed_check_fails_its_leg(quick_renders, monkeypatch):
    """A timed frame that differs from the first, and a train loss that does
    not fall, each fail their leg."""
    frames = iter(range(1000))

    def drifting(scene, camera, cfg):
        return torch.full((camera.height, camera.width, 3), float(next(frames))), 100

    def rising(scene, camera, cfg, target, lr, fields):
        losses = iter(range(100))
        return (lambda: torch.tensor(float(next(losses)))), None, None

    monkeypatch.setattr(bench, "render_with_stats", drifting)
    monkeypatch.setattr(inverse, "make_train_step", rising)
    rc, recs = run_bench("--reps", "2", "--legs", "2,4")
    assert rc == 1
    assert [r["leg_failed"] for r in recs] == ["hit-heavy", "train"]
    assert recs[0]["error"].startswith("LegFailed: hit-heavy x1: a timed frame differs")
    assert recs[1]["error"].startswith("LegFailed: train: the loss did not fall")


def test_without_a_card_it_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        bench.main(["--legs", "1"], out=io.StringIO())
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-m", "realtrace_tpu_torch.apps.bench", "--legs", "1"],
                       cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == "" and "no CUDA card" in p.stderr


def test_accel_option_sets_legs_1_and_2(quick_renders):
    """``--accel`` (RT_BENCH_ACCEL of the JAX bench) sets the accel of the
    headline and the close framing only; their lines name it."""
    for leg in bench.LEGS:
        want = "chunked" if leg in ("headline", "hit-heavy") else "sweep"
        assert all(w.cfg.accel == want
                   for w in bench.leg_workloads(leg, depth=3, accel_mode="chunked"))
    rc, recs = run_bench("--reps", "1", "--legs", "1,2", "--accel", "chunked")
    assert rc == 0 and len(recs) == 2
    assert all(r["metric"].endswith("depth-3 (chunked)") for r in recs)


def test_parse_legs():
    assert bench.parse_legs("9,1,hit-heavy") == ["headline", "hit-heavy", "depth10"]
    assert bench.parse_legs(",".join(bench.LEGS)) == list(bench.LEGS)
    with pytest.raises(ValueError, match="unknown leg"):
        bench.parse_legs("10")


def test_bench_imports_neither_jax_nor_the_jax_bench():
    code = ("import sys, realtrace_tpu_torch.apps.bench; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'optax', 'flax', 'realtrace_tpu', 'bench')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_device_busy_sums_the_device_events():
    """utils/profiling.py::device_busy on stand-in profiler events (the card's
    profiles are read only on the card): busy ms, idle share and top names."""
    from types import SimpleNamespace

    from realtrace_tpu_torch.utils import profiling

    def event(name, us, on_card=True):
        kind = torch.autograd.DeviceType.CUDA if on_card else torch.autograd.DeviceType.CPU
        return SimpleNamespace(name=name, device_time=us, device_type=kind)

    prof = SimpleNamespace(events=lambda: [event("rt_sweep", 3000.0), event("rt_sweep", 1000.0),
                                           event("memcpy", 500.0), event("host", 9e6, False)])
    got = profiling.device_busy(prof, total_ms=10.0)
    assert got == dict(device_events=3, busy_ms=4.5, idle_share=0.55,
                       top_ms={"rt_sweep": 4.0, "memcpy": 0.5})
    assert list(got["top_ms"]) == ["rt_sweep", "memcpy"]
    many = SimpleNamespace(events=lambda: [event(f"k{i}", 100.0 * i) for i in range(1, 11)])
    assert list(profiling.device_busy(many, 10.0)["top_ms"]) == [f"k{i}" for i in range(10, 2, -1)]
    none = profiling.device_busy(SimpleNamespace(events=lambda: [event("host", 1.0, False)]), 10.0)
    assert none["busy_ms"] is None and none["idle_share"] is None and none["device_events"] == 0
