"""Run one cell of the benchmark of ``realtrace_tpu_torch`` once.

    python3 -m rtbench.run --workload bob-orbit --seed 7 --seconds 25 --trace 0

Loads the cell's configuration and traffic mix (``BENCHMARK.json``), builds
the scene from the seed, warms up every shape the mix uses, then runs its
closed loop (``rtbench/workload.py``) for ``--seconds``; the set-up time is
from the start of the process to the first timed frame or step. Then it
releases the program's state, compares what the window produced with the
plain reference (``rtbench/reference.py``) and prints, as the last line of
standard output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (``--trace 0``: the cell's end-to-end metrics; ``--trace 1``:
its per-layer metrics, from the spans' host clock over the window and from
a profiled stretch of ``traced_units`` frames or steps after it, each
``traced_stride`` on from the last), ``device``,
with ``--trace 1`` a ``breakdown``, and last ``checks``: each number
compared beside its limit, which also end standard error. An earlier line
gives the rays and sweep launches a frame and the card.

It needs as many CUDA cards as the cell asks for and exits 2 without them.
It exits 3, printing no result, when a module of JAX or of the JAX package
(``realtrace_tpu``) was loaded.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

T0 = time.time()

import torch  # noqa: E402

from rtbench import check, manifest, trace, workload  # noqa: E402

OUT = manifest.HERE / "out"          # what a traced run writes: the profiler's Chrome trace
THREADS = 2                          # torch's host threads
BANNED = ("jax", "jaxlib", "flax", "realtrace_tpu")
GIB = 1 << 30


def process_start() -> float:
    """Wall time at which this process started (Linux), else at import."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.time() - (up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return T0


def jax_modules(modules=None) -> list:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or the
    JAX package's, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".")[0] in BANNED)


class Context:
    """What the metric readers read: the window (``seconds``, ``units``,
    ``latencies``), ``setup_s``, ``peak_bytes``; in a traced run
    ``host_ms`` (each layer's host time a unit over the window, from the
    spans' clock), ``trace`` (``rtbench.trace.Trace``, the profiled stretch
    after the window) and ``sweeps`` (its closest queries); the cell's
    ``arrays``, ``config`` and ``device``. A reader may leave details in
    ``notes``, which the earlier line prints."""

    def __init__(self, **kw):
        self.trace = None
        self.sweeps = []
        self.host_ms = {}
        self.notes = {}          # what readers add to the earlier line
        self.__dict__.update(kw)


def run_cell(name: str, seed: int, seconds: float, traced: bool, device="cuda",
             config_overrides: dict | None = None, traffic_overrides: dict | None = None) -> dict:
    """One run of a cell: its result object, and in ``_extra`` the earlier
    line's content. ``device`` and the overrides (keys merged into the
    configuration and the traffic mix) are for tests at a small size on the
    CPU."""
    start = process_start()
    seed %= 1 << 63
    man = manifest.load()
    cell = manifest.cell(man, name)
    config = dict(manifest.config(man, cell), **(config_overrides or {}))
    mix = dict(manifest.traffic(cell["traffic"]), **(traffic_overrides or {}))
    limits = manifest.limits(name)
    e2e, layers = manifest.cell_metrics(man, name)
    torch.set_num_threads(THREADS)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = torch.device(device).type == "cuda"

    spans = trace.Spans() if traced else None
    if spans:
        spans.install()
    try:
        loop = workload.KINDS[mix["kind"]](config, mix, seed, device)
        loop.setup()
        from realtrace_tpu_torch.ops import sweep
        launches0 = (sweep.sweep.launches, sweep.sweep.stream_launches)
        setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        if spans:
            spans.clock.reset()
        lat = []
        t_start = time.time()
        setup_s = t_start - start
        t_end, deadline, k = t_start, t_start + seconds, 0
        while t_end < deadline:
            t0 = time.time()
            loop.run(k)
            t_end = time.time()
            lat.append(t_end - t0)
            k += 1
        window_units = k
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        launches = (sweep.sweep.launches - launches0[0], sweep.sweep.stream_launches - launches0[1])
        host_s = dict(spans.clock.seconds) if spans else {}
        prof = None
        if traced:                      # the profiled stretch, after the window
            prof = trace.profiler()
            prof.start()
            spans.capturing = True
            # frames ``traced_stride`` apart, so that the stretch spans the orbit's views
            stride = mix.get("traced_stride", 1)
            for j in range(mix["traced_units"]):
                with torch.profiler.record_function(loop.unit):
                    loop.run(k + j * stride)
            k += mix["traced_units"]
            spans.capturing = False
            prof.stop()
    finally:
        if spans:
            spans.remove()
    ctx = Context(seconds=t_end - t_start, units=window_units, latencies=lat, setup_s=setup_s,
                  peak_bytes=peak, arrays=loop.arrays, config=config, device=device,
                  host_ms={n: v * 1e3 / window_units for n, v in host_s.items()})
    if prof is not None:
        OUT.mkdir(exist_ok=True)
        path = OUT / "trace.json"
        prof.export_chrome_trace(str(path))
        del prof
        ctx.trace = trace.reduce_trace(path, loop.unit)
        ctx.sweeps = spans.sweeps
        ctx.notes["trace_bytes"] = path.stat().st_size

    loop.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = loop.check(loop.record)
    correct, checks = check.judge(numbers, limits)

    metrics = {}
    for m in (layers if traced else e2e):
        value = manifest.reader("metrics" if traced else "e2e", m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else torch.device(device).type,
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": max(peak, setup_peak)}
    result = {"correct": correct, "attempted": k, "failed": 0, "metrics": metrics,
              "device": dev}
    if ctx.trace is not None:
        dev["busy_s"] = ctx.trace.busy_s()
        dev["window_s"] = ctx.trace.window_s()
        result["breakdown"] = ctx.trace.breakdown()
    result["checks"] = checks
    rays = getattr(loop, "rays", [])
    result["_extra"] = {"cell": name, "seed": seed, "units": window_units, "window_s": ctx.seconds,
                        "rays_per_frame": sum(rays) / len(rays) if rays else None,
                        "k1_launches_per_unit": launches[0] / window_units,
                        "k2_launches_per_unit": launches[1] / window_units,
                        "peak_mem_gib": peak / GIB, **ctx.notes}
    return result


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    return out.splitlines()[0] if out else "nvidia-smi: no output"


def emit(result: dict) -> int:
    """Print a run's lines; the exit code (3 where JAX was loaded)."""
    found = jax_modules()
    if found:
        print(f"rtbench: modules of JAX or the JAX package were loaded: {found[:20]}",
              file=sys.stderr)
        return 3
    extra = result.pop("_extra")
    print(json.dumps(extra), flush=True)
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    chips = manifest.cell(manifest.load(), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"rtbench: the cell needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    result["_extra"]["card"] = card()
    return emit(result)


if __name__ == "__main__":
    sys.exit(main())
