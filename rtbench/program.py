"""The program's own spans and counters, and the CUDA runtime's synchronising
calls, in a traced run's profiled stretch.

The program (``realtrace_tpu_torch/utils/profiling.py``) opens a span
``rt.p.<layer>`` at each of its layer boundaries, ``rt.p.level.<k>`` around
each wavefront level and ``rt.p.sync.<site>`` around each call with which it
waits for the device; while the profiler records, it logs counters
(``profiling.RECORDER``): each level's rays and live tiles, each sweep
call's tested positions. ``stretch(ctx)`` reads the Chrome trace that
``rtbench/run.py`` wrote (``rtbench/out/trace.json``) once a run, within
the stretch ``[trace.start, trace.end]``, and leaves in ``ctx.notes`` (the
earlier line):

* ``program_spans``: for each ``rt.p`` span name, per unit: calls, host ms
  (which the profiler stretches), self ms (without its ``rt.p`` children),
  device ms and kernels launched inside it, syncs inside it and the ms the
  host spent blocked in them;
* ``levels``: for each level, per unit: rays, live tiles, device ms,
  launches and syncs;
* ``syncs_outside``: the syncs per unit outside every ``rt.p.sync`` span,
  by the innermost span of the main thread at the time;
* ``idle_after_sync_ms``: the device's idle time per unit whose gap began
  while the main thread was inside a ``rt.p.sync`` span (``sync``) or
  elsewhere (``other``);
* ``runtime_calls``: the runtime's and driver's calls per unit, by name.

A sync is one of ``SYNC_CALLS``, which the profiler records whatever the
program; where the program has no spans or counters (an older program), the
readers that need them find nothing.
"""
from __future__ import annotations

import bisect
import json
from collections import Counter

from rtbench import manifest
from rtbench.trace import LAUNCH_CATS, merge

TRACE = manifest.HERE / "out" / "trace.json"
PREFIX = "rt.p."
SYNC_PREFIX = "rt.p.sync."
LEVEL_PREFIX = "rt.p.level."
DEEP_LEVEL = 2      # deep_levels_device_ms counts the levels from this one on
# the runtime's calls that block the host until the device has done its work
SYNC_CALLS = frozenset(("cudaStreamSynchronize", "cudaDeviceSynchronize",
                        "cudaEventSynchronize", "cudaMemcpy"))
TOP_CALLS = 16      # runtime_calls: the names called most


def stretch(ctx):
    """The ``Stretch`` of a traced run, read once (None without a trace)."""
    if getattr(ctx, "trace", None) is None or not ctx.trace.units:
        return None
    if getattr(ctx, "_program", None) is None:
        with open(TRACE) as f:
            events = json.load(f)["traceEvents"]
        ctx._program = Stretch(ctx.trace, events)
        ctx._program.note(ctx.notes)
    return ctx._program


def _inside(intervals: list, t: float) -> bool:
    """Whether ``t`` lies in one of the sorted disjoint ``intervals``."""
    k = bisect.bisect_right(intervals, (t, float("inf"))) - 1
    return k >= 0 and t <= intervals[k][1]


class Stretch:
    """The program's spans (name, start, end, tid) and the runtime's calls
    (name, start, end) of one profiled stretch, in microseconds."""

    def __init__(self, trace, events: list):
        self.trace = trace
        a, b = trace.start, trace.end
        self.spans = sorted((s for s in trace.spans if s[0].startswith(PREFIX)
                             and s[2] > a and s[1] < b), key=lambda s: (s[1], -s[2]))
        self.calls = sorted(((e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                             for e in events if e.get("cat") in LAUNCH_CATS
                             and a <= float(e["ts"]) < b), key=lambda c: c[1])
        self.syncs = [c for c in self.calls if c[0] in SYNC_CALLS]

    # -- per unit -----------------------------------------------------------

    def per_unit(self, x: float) -> float:
        return x / self.trace.units

    def syncs_per_unit(self) -> float | None:
        """Synchronising calls a unit; None where the trace has no runtime
        calls at all (no card)."""
        return self.per_unit(len(self.syncs)) if self.calls else None

    def intervals(self, names) -> list:
        """Merged host intervals of the spans whose names are in ``names``."""
        return merge([(s[1], s[2]) for s in self.spans if s[0] in names])

    def launched(self, iv: list) -> tuple[float, int]:
        """(device ms, kernels) a unit of the work launched inside ``iv``."""
        work = [d for d in self.trace.device if d[3] is not None and _inside(iv, d[3])]
        return (self.per_unit(sum(d[2] - d[1] for d in work) / 1e3),
                self.per_unit(sum(1 for d in work if d[4] == "kernel")))

    def blocked(self, iv: list) -> tuple[float, float]:
        """(syncs, ms blocked in them) a unit inside ``iv``."""
        inside = [c for c in self.syncs if _inside(iv, c[1])]
        return (self.per_unit(len(inside)),
                self.per_unit(sum(c[2] - c[1] for c in inside) / 1e3))

    def deep_levels_device_ms(self) -> float | None:
        """Device ms a unit launched inside the levels from ``DEEP_LEVEL`` on."""
        iv = self.intervals({s[0] for s in self.spans if s[0].startswith(LEVEL_PREFIX)
                             and int(s[0][len(LEVEL_PREFIX):]) >= DEEP_LEVEL})
        if not iv or not self.trace.device:
            return None
        return self.launched(iv)[0]

    # -- counters -------------------------------------------------------------

    def counters(self, name: str) -> list | None:
        """The program's counters of the stretch's spans ``name``, in order:
        the last entries of its log, one for each span of that name in the
        trace. None where the log lacks them."""
        try:
            from realtrace_tpu_torch.utils.profiling import RECORDER
        except ImportError:
            return None
        spans = sorted((s for s in self.trace.spans if s[0] == name), key=lambda s: s[1])
        entries = RECORDER.read(name, len(spans))
        if not spans or len(entries) != len(spans):
            return None
        a, b = self.trace.start, self.trace.end
        return [c for s, c in zip(spans, entries) if s[2] > a and s[1] < b]

    def unit_starts(self) -> list:
        """Sorted start times of the stretch's units."""
        return sorted(s[1] for s in self.trace.spans if s[0] == self.trace.unit)

    # -- the earlier line -------------------------------------------------------

    def note(self, notes: dict) -> None:
        """Leave the stretch's tables in ``notes`` (see the module doc)."""
        if not self.spans and not self.calls:
            return
        table = {}
        self_us = self.self_us()
        for name in sorted({s[0] for s in self.spans}):
            mine = [s for s in self.spans if s[0] == name]
            iv = self.intervals({name})
            dev_ms, launches = self.launched(iv)
            syncs, sync_ms = self.blocked(iv)
            table[name] = dict(calls=self.per_unit(len(mine)),
                               host_ms=self.per_unit(sum(s[2] - s[1] for s in mine) / 1e3),
                               self_ms=self.per_unit(self_us[name] / 1e3),
                               device_ms=dev_ms, launches=launches, syncs=syncs, sync_ms=sync_ms)
        if table:
            notes["program_spans"] = table
        levels = {}
        for name in sorted((n for n in table if n.startswith(LEVEL_PREFIX)),
                           key=lambda n: int(n[len(LEVEL_PREFIX):])):
            row = table[name]
            counted = self.counters(name) or []
            levels[name[len(LEVEL_PREFIX):]] = dict(
                rays=self.per_unit(sum(c["rays"] for c in counted)) if counted else None,
                tiles=self.per_unit(sum(c["tiles"] for c in counted)) if counted else None,
                device_ms=row["device_ms"], launches=row["launches"], syncs=row["syncs"])
        if levels:
            notes["levels"] = levels
        if self.calls:
            iv = self.intervals({s[0] for s in self.spans if s[0].startswith(SYNC_PREFIX)})
            outside = [c for c in self.syncs if not _inside(iv, c[1])]
            labels = self.trace._innermost([c[1] for c in outside])
            notes["syncs_outside"] = {k: self.per_unit(v) for k, v in Counter(labels).items()}
            notes["runtime_calls"] = {k: self.per_unit(v) for k, v in
                                      Counter(c[0] for c in self.calls).most_common(TOP_CALLS)}
        if self.trace.device:
            notes["idle_after_sync_ms"] = self.idle_after_sync()

    def self_us(self) -> Counter:
        """Host us of each span name without its direct ``rt.p`` children
        on the same thread."""
        out: Counter = Counter()
        stacks: dict = {}
        for s in self.spans:               # sorted: a parent before its children
            st = stacks.setdefault(s[3], [])
            while st and st[-1][2] <= s[1]:
                st.pop()
            out[s[0]] += s[2] - s[1]
            if st:
                out[st[-1][0]] -= s[2] - s[1]
            st.append(s)
        return out

    def idle_after_sync(self) -> dict:
        """The device's idle ms a unit, split by whether each gap began
        inside a ``rt.p.sync`` span of the main thread."""
        tr = self.trace
        gaps, t = [], tr.start
        for a, b in tr.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if tr.end > t:
            gaps.append((t, tr.end))
        out = {"sync": 0.0, "other": 0.0}
        for (g0, g1), label in zip(gaps, tr._innermost([g[0] for g in gaps])):
            out["sync" if label.startswith(SYNC_PREFIX) else "other"] += (g1 - g0) / 1e3
        return {k: self.per_unit(v) for k, v in out.items()}
