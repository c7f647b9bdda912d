"""Profiling and observability utilities.

Counterpart of ``realtrace_tpu/utils/profiling.py``. Replaces the reference's
instrumentation: the GLUT FPS title-bar counter (Parellel/main.cu:79-85) and
the per-frame cudaProfilerStart/Stop bracket (Parellel/kernel.cu:569,603).

The program's spans and counters. Each layer of a frame or a train step runs
inside a ``span`` named ``rt.p.<layer>`` (``rt.p.level.<k>`` for the wavefront
levels, ``rt.p.sync.<site>`` around each call that waits for the device). A
span records only while a ``torch.profiler`` session records (``recording``):
it then opens ``torch.profiler.record_function(name)``, so its range lands in
the profiler's trace on the kernels' clock, and ``count`` appends the span's
counters to ``RECORDER``'s log. Otherwise a span is one flag read and does
nothing. Counters never wait for the device: a tensor in a counter (the
sweep's ``tested`` buffer) is kept as it is and summed when the log is read.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import subprocess
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

TOP_NAMES = 8      # device_busy's top_ms: the names that took the most device time
LOG_ENTRIES = 1 << 16   # counter entries the log keeps; the oldest go first

_profiler = torch.autograd.profiler
if hasattr(_profiler, "_is_profiler_enabled"):
    def recording() -> bool:
        """Whether a ``torch.profiler`` session records: the gate of every
        span and counter of the program (the profiler's own Python flag)."""
        return _profiler._is_profiler_enabled
else:     # torch without the Python flag: ask the profiler itself
    recording = torch.autograd._profiler_enabled


class Recorder:
    """The counter log: ``(span name, counters)`` entries, one for each span
    that counted while recording, oldest first. A reader matches the last
    entries of a name to the last spans of that name in its trace, by count
    and order, so an earlier profiling session never mixes in."""

    def __init__(self, size: int = LOG_ENTRIES):
        self.log = collections.deque(maxlen=size)

    def read(self, name: str, n: int) -> list:
        """The counters of the last ``n`` entries of span ``name``, oldest
        first; each tensor is summed into a Python int (which waits for the
        device: read after the profiled stretch)."""
        found = [c for s, c in self.log if s == name]
        return [{k: int(v.sum()) if isinstance(v, torch.Tensor) else v for k, v in c.items()}
                for c in found[max(0, len(found) - n):]]


RECORDER = Recorder()


class _Span:
    """A span while recording: a ``record_function`` range and its counters."""

    on = True
    __slots__ = ("name", "_range")

    def __init__(self, name: str):
        self.name = name
        self._range = torch.profiler.record_function(name)

    def __enter__(self):
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        return self._range.__exit__(*exc)

    def count(self, **counters) -> None:
        RECORDER.log.append((self.name, counters))


class _Off:
    """A span while nothing records: enters, counts and leaves doing nothing."""

    on = False
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def count(self, **counters) -> None:
        pass


_OFF = _Off()


def span(name: str):
    """A span of the program named ``name``: a context whose ``count(**kw)``
    logs the span's counters and whose ``on`` says whether it records."""
    return _Span(name) if recording() else _OFF


def spanned(name: str):
    """Decorator: every call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*a, **k):
            with span(name):
                return fn(*a, **k)
        return inner
    return wrap


def block(x):
    """Synchronise the CUDA device that holds ``x`` (the cudaDeviceSynchronize
    analog for timing); nothing on the CPU. Returns ``x``."""
    dev = x.device if isinstance(x, torch.Tensor) else None
    if dev is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return x


@dataclass
class FrameTimer:
    """Rolling FPS / rays-per-second counter (a sampling window of ``window``
    seconds, like the reference's glutTimerFunc counter)."""

    window: float = 1.0
    _frames: int = 0
    _rays: float = 0.0
    _t0: float = field(default_factory=time.perf_counter)
    fps: float = 0.0
    mrays_per_s: float = 0.0

    def frame(self, n_rays: float = 0.0) -> bool:
        """Record one finished frame; returns True when the window rolled."""
        self._frames += 1
        self._rays += float(n_rays)
        dt = time.perf_counter() - self._t0
        if dt >= self.window:
            self.fps = self._frames / dt
            self.mrays_per_s = self._rays / dt / 1e6
            self._frames = 0
            self._rays = 0.0
            self._t0 = time.perf_counter()
            return True
        return False

    def title(self) -> str:
        """Window-title string, the TITLE_STRING analog (Parellel/interactions.h:6)."""
        return f"RealTrace-TPU | {self.fps:6.2f} fps | {self.mrays_per_s:8.2f} Mrays/s"


def frame_bracket(label: str = "frame"):
    """Named profiler bracket (the cudaProfilerStart/Stop analog): the span
    ``label``, so the label is an event of a captured profile."""
    return span(label)


@contextlib.contextmanager
def trace_capture(logdir: str | Path):
    """Profile one scope on the CPU and, where there is a card, on CUDA; the
    Chrome trace goes to ``logdir/trace.json``. Yields the profiler (its
    ``events()`` / ``key_averages()`` stay readable after the scope)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    Path(logdir).mkdir(parents=True, exist_ok=True)
    prof = torch.profiler.profile(activities=acts, acc_events=True)
    with prof:
        yield prof
    prof.export_chrome_trace(str(Path(logdir) / "trace.json"))


def card_name() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them (its first
    line: card 0)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip()
    except FileNotFoundError:
        return "nvidia-smi: not found"
    return out.splitlines()[0] if out else "nvidia-smi: no output"


def device_busy(prof, total_ms: float) -> dict:
    """What the card did during one profiled run of ``total_ms`` host ms, from
    a finished ``torch.profiler.profile``: ``device_events`` (its kernels and
    copies), ``busy_ms`` (the sum of their device times), ``idle_share`` (1 -
    busy / total) and ``top_ms`` (the ``TOP_NAMES`` names by device ms). Without
    device events (a CPU run) ``busy_ms`` and ``idle_share`` are None."""
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time for e in events) / 1e3
    by_name: dict = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / 1e3
    top_ms = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP_NAMES]
    return dict(device_events=len(events), busy_ms=busy if events else None,
                idle_share=1.0 - busy / total_ms if events else None,
                top_ms={k[:60]: v for k, v in top_ms})


def timed(fn, *args, repeats: int = 5, warmup: int = 1):
    """Wall time of ``fn(*args)`` with a device sync before each clock read:
    (mean seconds over ``repeats``, last result)."""
    result = None
    for _ in range(warmup):
        result = _sync(fn(*args))
    t0 = time.perf_counter()
    for _ in range(repeats):
        result = fn(*args)
    _sync(result)
    return (time.perf_counter() - t0) / repeats, result


def _sync(result):
    """``block`` on the first tensor of a result (a tensor or a tuple)."""
    first = result[0] if isinstance(result, (tuple, list)) and result else result
    return block(first)
