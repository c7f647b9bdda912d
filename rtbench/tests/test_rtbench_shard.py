"""The four-card fit (``bob-fit-close-4card``: one rank a card, 2x2 pixel
tiles, ``rtbench/shard.py``) at the tiny size on the CPU: four gloo ranks,
rank 0 in this process and ranks 1-3 started by it. A sound run is correct
and its first steps are the one-process fit's up to the order of float32
sums; ranks that step on their own tile's gradient are not correct; a rank
that dies or stalls ends the run within two minutes. And the readers of the collectives and of the
tiles' balance, ``allreduce_device_ms.step`` and ``tile_ray_skew.step``, on
a synthetic trace."""
import json
import os
import subprocess
import sys
import time
import types

import pytest

from rtbench import check, manifest, program, run, shard, trace, workload
from rtbench.tests.conftest import ROOT, TINY_TRAFFIC, tiny
from rtbench.tests.test_rtbench_program import chrome

SEED = 2 ** 33 + 5
CELL = "bob-fit-close-4card"
# float32 sums in another order: the tiles' partial losses and gradients add
# up in four parts (measured: 6e-08 loss, 4e-07 gradient, 6e-08 change)
SUM_ORDER = 1e-5
FAIL_FAST_S = 120


def sharded_run(seconds=0.5, traced=False) -> dict:
    return run.run_cell(CELL, SEED, seconds, traced, device="cpu",
                        config_overrides=tiny("bob_1080p_4card"), traffic_overrides=TINY_TRAFFIC)


def in_workers(name: str):
    """A ``worker_argv`` that starts each worker through this module's
    function ``name``, which plants a fault and runs the worker."""
    def argv(job):
        code = f"from rtbench.tests.test_rtbench_shard import {name}; {name}()"
        return [sys.executable, "-c", code, json.dumps(job)]
    return argv


def no_all_reduce():
    from realtrace_tpu_torch.parallel import mesh

    mesh._all_reduce = lambda x: x
    shard.main()


def rank_3_dies():
    if json.loads(sys.argv[1])["rank"] == 3:
        workload.Fit.run = lambda self, k: os._exit(9)
    shard.main()


def rank_3_stalls():
    if json.loads(sys.argv[1])["rank"] == 3:
        workload.Fit.run = lambda self, k: time.sleep(3600)
    shard.main()


def rank_0_with(fault: str):
    """Rank 0 of a run whose workers run ``fault``: rank 3 dies or stalls at
    its first step of the window."""
    shard.worker_argv = in_workers(fault)
    sharded_run(seconds=30.0)


@pytest.fixture(scope="module")
def sound():
    """One sound run, and the records of its first steps and of the
    one-process fit's at the same seed."""
    kept = []

    class Kept(workload.Fit):
        def check(self, record):
            kept.append(record)
            return super().check(record)

    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(workload.KINDS, "fit", Kept)
        result = sharded_run()
    man = manifest.load()
    config = dict(manifest.config(man, manifest.cell(man, "bob-fit-close")), **tiny("bob_1080p"))
    mix = dict(manifest.traffic("fit_close"), **TINY_TRAFFIC)
    one = workload.Fit(config, mix, SEED, "cpu")
    one.setup()
    one.release()
    return result, kept[0], one.record


def test_a_sharded_fit_run_is_correct(sound):
    r, _, _ = sound
    assert r["correct"], r["checks"]
    assert r["device"]["count"] == 4 and r["attempted"] >= 1
    assert len(r["_extra"]["rank_peak_gib"]) == 4


def test_its_first_steps_are_the_one_process_fit_s(sound):
    _, sharded, one = sound
    gaps = check.fit_numbers(sharded["first"], one["first"])
    assert all(v <= SUM_ORDER for v in gaps.values()), gaps


def test_a_traced_run_reads_each_rank_s_rays(tmp_path, monkeypatch):
    monkeypatch.setattr(run, "OUT", tmp_path)
    monkeypatch.setattr(program, "TRACE", tmp_path / "trace.json")
    r = sharded_run(traced=True)
    assert r["correct"], r["checks"]
    rays = r["_extra"]["rank_rays"]
    assert len(rays) == 4 and min(rays) > 0
    assert r["metrics"]["tile_ray_skew.step"]["value"] >= 1.0
    assert "allreduce_device_ms.step" not in r["metrics"]      # gloo: no NCCL kernel


def test_ranks_that_skip_the_all_reduce_are_not_correct(monkeypatch):
    from realtrace_tpu_torch.parallel import mesh

    monkeypatch.setattr(mesh, "_all_reduce", lambda x: x)
    monkeypatch.setattr(shard, "worker_argv", in_workers("no_all_reduce"))
    r = sharded_run()
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("fault,said", [("rank_3_dies", "rank 3 exited with code 9"),
                                         ("rank_3_stalls", "Timed out")])
def test_a_rank_that_dies_or_stalls_ends_the_run_in_time(fault, said):
    code = f"from rtbench.tests.test_rtbench_shard import rank_0_with; rank_0_with({fault!r})"
    t0 = time.time()
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=FAIL_FAST_S + 60)
    took = time.time() - t0
    assert p.returncode != 0 and took < FAIL_FAST_S, (p.returncode, took, p.stderr[-2000:])
    assert said in p.stderr, p.stderr[-2000:]
    assert not p.stdout.strip()


def test_ranks_that_are_not_the_cell_s_chips_are_refused():
    with pytest.raises(ValueError, match="not the cell's 4 chips"):
        shard.ranks({"parallel": {"ranks": 2}}, {"chips": 4}, dict(device="cpu"))


def test_one_device_is_one_rank_that_follows_its_own_clock():
    one = shard.ranks({}, {"chips": 1}, dict(device="cpu"))
    assert (one.rank, one.world, one.mesh, one.device) == (0, 1, None, "cpu")
    assert one.more(True) and not one.more(False)
    assert one.gather({"peak": 1}) == [{"peak": 1}]
    one.close()


# -- the readers ---------------------------------------------------------------

def steps_events(nccl=True):
    """Two steps of 1000 us, each with a compute kernel (200 us) and, where
    ``nccl``, the gradients' all-reduce (60 us) and the loss's (5 us)."""
    ev, corr = [], iter(range(1, 100))

    def kernel(name, launch, dur):
        c = next(corr)
        ev.append({"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": launch, "dur": 1,
                   "tid": 1, "args": {"correlation": c}})
        ev.append({"cat": "kernel", "name": name, "ts": launch + 10, "dur": dur,
                   "args": {"correlation": c}})

    for s0 in (10_000, 11_000):
        ev.append({"cat": "user_annotation", "name": "rt.step", "ts": s0, "dur": 1000, "tid": 1})
        kernel("rt_sweep_k1", s0 + 10, 200)
        if nccl:
            kernel("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
                   s0 + 300, 60)
            kernel("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
                   s0 + 400, 5)
    return ev


def test_the_all_reduce_reads_the_nccl_kernels_a_step(tmp_path):
    read = manifest.reader("metrics", "allreduce_device_ms.step")
    ctx = types.SimpleNamespace(trace=trace.reduce_trace(chrome(tmp_path / "t.json", steps_events()),
                                                         "rt.step"))
    assert read(ctx) == pytest.approx(0.065)
    ctx.trace = trace.reduce_trace(chrome(tmp_path / "u.json", steps_events(nccl=False)), "rt.step")
    assert read(ctx) is None
    ctx.trace = None
    assert read(ctx) is None


def test_the_skew_is_the_largest_rank_over_the_mean():
    read = manifest.reader("metrics", "tile_ray_skew.step")
    assert read(types.SimpleNamespace(rank_rays=[100.0, 100.0, 100.0, 100.0])) == 1.0
    assert read(types.SimpleNamespace(rank_rays=[50.0, 100.0, 150.0, 100.0])) == \
        pytest.approx(1.5)
    for rays in (None, [100.0], [100.0, None, 90.0, 80.0], [0.0] * 4):
        assert read(types.SimpleNamespace(rank_rays=rays)) is None


def test_each_rank_s_rays_are_its_levels_logged_since_the_mark(monkeypatch):
    from realtrace_tpu_torch.utils import profiling

    recorder = profiling.Recorder()
    recorder.log.append(("rt.p.level.0", dict(rays=999)))           # before the mark
    mark = len(recorder.log)
    for name, c in [("rt.p.level.0", dict(rays=40, tiles=1)), ("rt.p.kernel.closest",
                    dict(tested=7)), ("rt.p.level.1", dict(rays=2, tiles=1))]:
        recorder.log.append((name, c))
    monkeypatch.setattr(profiling, "RECORDER", recorder)
    assert shard.log_rays(mark) == 42.0
