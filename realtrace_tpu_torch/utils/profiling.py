"""Profiling and observability utilities.

Counterpart of ``realtrace_tpu/utils/profiling.py``. Replaces the reference's
instrumentation: the GLUT FPS title-bar counter (Parellel/main.cu:79-85), the
per-frame cudaProfilerStart/Stop bracket (Parellel/kernel.cu:569,603) and the
[INFO] transfer-size logs (Parellel/main.cu:239-241).
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import subprocess
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from realtrace_tpu_torch.core.types import tensor_leaves

log = logging.getLogger("realtrace_tpu_torch")
TOP_NAMES = 8      # device_busy's top_ms: the names that took the most device time


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


@contextlib.contextmanager
def frame_bracket(label: str = "frame"):
    """Named profiler bracket (the cudaProfilerStart/Stop analog): a
    ``torch.profiler.record_function`` range, so the label is an event of a
    captured profile."""
    with torch.profiler.record_function(label):
        yield


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


def _tensors(tree) -> list:
    """Every tensor of a tree of dicts and dataclasses (a ``Scene``, a
    parameter dict), through ``tensor_leaves`` level by level."""
    out = []
    for leaf in tensor_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            out.append(leaf)
        elif isinstance(leaf, dict) or dataclasses.is_dataclass(leaf):
            out.extend(_tensors(leaf))
    return out


def log_transfer(name: str, tree) -> None:
    """Byte-count log before a scene upload ([INFO] analog,
    Parellel/main.cu:239), to the logger ``realtrace_tpu_torch``."""
    n = sum(x.numel() * x.element_size() for x in _tensors(tree))
    log.info("[INFO] %s: %.2f KB to be transferred to device", name, n / 1024)
