"""The traced run: spans around the program's layers, set from outside, and
the reduction of one profiled stretch to per-layer numbers.

``Spans.install`` replaces the program's layer functions in their modules by
wrappers that open a ``torch.profiler.record_function`` span named
``rt.<layer>`` around the call and time it on the host's clock (``Clock``:
a layer's host time is the union of its calls, nested ones counted once);
``remove`` puts the originals back. The program's source is not edited.
While ``capturing`` is set, the wrapper of the sweep keeps each closest-mode
call's rays and hit distances (the tensors themselves, no copy) for the
roofline's pair count.

``reduce_trace`` reads the profiler's Chrome trace: the benchmark's spans on
the host, and the device's kernels, copies and sets, each tied to the host
time of its launch by the profiler's correlation id. A layer's device time
is the time of the device work launched inside its spans, from whatever
thread.
"""
from __future__ import annotations

import bisect
import importlib
import json
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

# (module, attribute, layer): the callers look each up in these modules at
# call time
SPANS = (
    ("realtrace_tpu_torch.ops.sweep", "sweep_inputs", "mask"),
    ("realtrace_tpu_torch.ops.sweep", "chunk_mask", "mask"),
    ("realtrace_tpu_torch.ops.sweep", "chunk_mask_exact", "mask"),
    ("realtrace_tpu_torch.ops.sweep", "super_tile_mask", "mask"),
    ("realtrace_tpu_torch.render.shade", "hit_attributes", "shade"),
    ("realtrace_tpu_torch.render.shade", "_shade_level", "shade"),
    ("realtrace_tpu_torch.render.shade", "closest_query", "query"),
    ("realtrace_tpu_torch.render.shade", "any_hit", "query"),
    ("realtrace_tpu_torch.render.shade", "_live_tiles", "compaction"),
    ("realtrace_tpu_torch.render.shade", "_gather_tiles", "compaction"),
    ("realtrace_tpu_torch.render.shade", "_add_tiles", "compaction"),
    ("realtrace_tpu_torch.render.pipeline", "_tiled_rays", "raygen"),
    ("realtrace_tpu_torch.ops.accel", "resort_chunks", "resort"),
    ("torch", "Tensor.backward", "backward"),
    ("torch.optim", "Adam.step", "adam"),
)
SWEEP = ("realtrace_tpu_torch.ops.sweep", "sweep")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
TOP = 10          # entries of each breakdown list


def _owner(path: str, attr: str):
    obj = importlib.import_module(path)
    *outer, name = attr.split(".")
    for a in outer:
        obj = getattr(obj, a)
    return obj, name


class Clock:
    """Host time of each layer's calls, summed over the outermost call of
    the layer in progress: ``seconds[layer]``; ``reset`` starts anew."""

    def __init__(self):
        self.seconds: dict = {}
        self._depth: dict = {}
        self._since: dict = {}

    def reset(self) -> None:
        self.seconds = {}

    def enter(self, layer: str) -> None:
        d = self._depth.get(layer, 0)
        if d == 0:
            self._since[layer] = time.perf_counter()
        self._depth[layer] = d + 1

    def leave(self, layer: str) -> None:
        d = self._depth[layer] - 1
        self._depth[layer] = d
        if d == 0:
            self.seconds[layer] = (self.seconds.get(layer, 0.0)
                                   + time.perf_counter() - self._since[layer])


def _span(fn, layer: str, clock: Clock):
    name = f"rt.{layer}"

    def wrapper(*a, **k):
        clock.enter(layer)
        try:
            with torch.profiler.record_function(name):
                return fn(*a, **k)
        finally:
            clock.leave(layer)
    wrapper.__wrapped__ = fn
    return wrapper


class Spans:
    """The benchmark's spans around the program's layers (see module doc)."""

    def __init__(self):
        self.clock = Clock()
        self.capturing = False
        self.sweeps: list = []      # (ro32, rd32, t) of closest-mode calls while capturing
        self._saved: list = []

    def install(self) -> None:
        for path, attr, layer in SPANS:
            owner, name = _owner(path, attr)
            fn = getattr(owner, name)
            self._saved.append((owner, name, fn))
            setattr(owner, name, _span(fn, layer, self.clock))
        owner, name = _owner(*SWEEP)
        fn = getattr(owner, name)
        self._saved.append((owner, name, fn))
        setattr(owner, name, self._sweep_wrapper(fn))

    def _sweep_wrapper(self, fn):
        spans = self

        def sweep(*a, **k):
            any_mode = a[9] if len(a) > 9 else k.get("any_mode", False)
            with torch.profiler.record_function("rt.sweep.any" if any_mode else "rt.sweep.closest"):
                t, i = fn(*a, **k)
            if spans.capturing and not any_mode:
                spans.sweeps.append((a[0], a[1], t))
            return t, i

        # the kernel wrapper counts its launches on the module's ``sweep``
        sweep.launches, sweep.stream_launches = fn.launches, fn.stream_launches
        sweep.__wrapped__ = fn
        return sweep

    def remove(self) -> None:
        for owner, name, fn in reversed(self._saved):
            now = getattr(owner, name)
            for a in ("launches", "stream_launches"):
                if hasattr(fn, a):
                    setattr(fn, a, getattr(now, a))
            setattr(owner, name, fn)
        self._saved.clear()


def profiler():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


@dataclass
class Trace:
    """One profiled stretch: ``spans`` (name, start, end, tid) of the
    benchmark's ``rt.*`` spans and ``device`` (name, start, end, launch,
    category) of the device's work, in microseconds; the stretch runs from
    the first unit span's start to the last one's end."""

    spans: list
    device: list
    unit: str
    start: float = 0.0
    end: float = 0.0
    units: int = 0
    main_tid: object = None
    _merged: dict = field(default_factory=dict)

    def __post_init__(self):
        us = [s for s in self.spans if s[0] == self.unit]
        self.units = len(us)
        if us:
            self.start = min(s[1] for s in us)
            self.end = max(s[2] for s in us)
            self.main_tid = us[0][3]

    def layer_intervals(self, layer: str) -> list:
        """Merged host intervals of the spans ``rt.<layer>`` and
        ``rt.<layer>.*`` inside the stretch."""
        if layer not in self._merged:
            name = f"rt.{layer}"
            iv = [(max(s[1], self.start), min(s[2], self.end)) for s in self.spans
                  if (s[0] == name or s[0].startswith(name + ".")) and s[2] > self.start
                  and s[1] < self.end]
            self._merged[layer] = merge(iv)
        return self._merged[layer]

    def launched_in(self, layer: str) -> list:
        """The device work launched inside the layer's spans."""
        iv = self.layer_intervals(layer)
        starts = [a for a, _ in iv]
        out = []
        for d in self.device:
            if d[3] is None:
                continue
            k = bisect.bisect_right(starts, d[3]) - 1
            if k >= 0 and d[3] <= iv[k][1]:
                out.append(d)
        return out

    def device_ms(self, layer: str) -> float | None:
        """Device time per unit, ms, of the work launched inside the layer's
        spans; None where there is none."""
        work = self.launched_in(layer)
        if not work or not self.units:
            return None
        return sum(d[2] - d[1] for d in work) / 1e3 / self.units

    def busy_intervals(self) -> list:
        return merge([(max(d[1], self.start), min(d[2], self.end)) for d in self.device
                      if d[2] > self.start and d[1] < self.end])

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def kernels(self) -> int:
        return sum(1 for d in self.device
                   if d[4] == "kernel" and self.start <= d[1] < self.end)

    def breakdown(self) -> dict:
        """The ``TOP`` device operations by time, and the idle time of the
        device summed by the innermost benchmark span the main thread was in
        when each gap began (``rt.<unit>``: outside every layer's span)."""
        by_op: dict = {}
        for d in self.device:
            if self.start <= d[1] < self.end:
                by_op[d[0][:120]] = by_op.get(d[0][:120], 0.0) + (d[2] - d[1]) / 1e6
        gaps, t = [], self.start
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.end > t:
            gaps.append((t, self.end))
        by_span: dict = {}
        for (g0, g1), label in zip(gaps, self._innermost([g[0] for g in gaps])):
            by_span[label] = by_span.get(label, 0.0) + (g1 - g0) / 1e6
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(by_op), "idle_gaps": top(by_span)}

    def _innermost(self, times: list) -> list:
        """For sorted host times: the innermost ``rt.*`` span of the main
        thread containing each (spans nest), or the unit's name."""
        spans = sorted((s for s in self.spans if s[3] == self.main_tid and s[0] != self.unit),
                       key=lambda s: (s[1], -s[2]))
        out, stack, k = [], [], 0
        for t in times:
            while k < len(spans) and spans[k][1] <= t:
                while stack and stack[-1][2] <= spans[k][1]:
                    stack.pop()
                stack.append(spans[k])
                k += 1
            while stack and stack[-1][2] <= t:
                stack.pop()
            out.append(stack[-1][0] if stack else self.unit)
        return out


def merge(intervals: list) -> list:
    """Union of (start, end) intervals, as sorted disjoint intervals."""
    out: list = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce_trace(path: Path, unit: str) -> Trace:
    """The benchmark's spans and the device's work from a Chrome trace
    written by ``torch.profiler``."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    launch = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launch[e["args"]["correlation"]] = float(e["ts"])
    spans, device = [], []
    for e in events:
        cat = e.get("cat")
        if cat == "user_annotation" and e.get("name", "").startswith("rt."):
            ts = float(e["ts"])
            spans.append((e["name"], ts, ts + float(e.get("dur", 0)), e.get("tid")))
        elif cat in DEVICE_CATS:
            ts = float(e["ts"])
            corr = e.get("args", {}).get("correlation")
            device.append((e["name"], ts, ts + float(e.get("dur", 0)), launch.get(corr),
                           "kernel" if cat == "kernel" else cat))
    return Trace(spans, device, unit)
