"""The readers of ray generation, ``raygen_host_ms.frame`` and
``raygen_kernel_share.frame``, on a synthetic trace."""
import types

import pytest

from rtbench import manifest
from rtbench.tests.test_rtbench_glass import level_counters
from rtbench.tests.test_rtbench_program import frames_events, stretch_of

RAYS = 2_088_960


def raygen_spans(events, kernel=True):
    """Each frame's ray generation, and inside it, where ``kernel``, the
    kernel's launch span, both before level 0."""
    for f0 in (10_000, 11_000):
        events.append({"cat": "user_annotation", "name": "rt.p.raygen", "ts": f0 + 1, "dur": 8,
                       "tid": 1})
        if kernel:
            events.append({"cat": "user_annotation", "name": "rt.p.kernel.raygen", "ts": f0 + 2,
                           "dur": 5, "tid": 1})
    return events


def test_every_frame_s_rays_from_the_kernel_reads_100(tmp_path, monkeypatch):
    level_counters(monkeypatch, [("rt.p.kernel.raygen", dict(rays=RAYS)),
                                 ("rt.p.raygen", dict(rays=RAYS))] * 2)
    ctx, _ = stretch_of(tmp_path, monkeypatch, raygen_spans(frames_events()))
    assert manifest.reader("metrics", "raygen_kernel_share.frame")(ctx) == pytest.approx(100.0)


def test_a_frame_made_by_the_pytorch_code_lowers_the_share(tmp_path, monkeypatch):
    ev = raygen_spans(frames_events(), kernel=False)
    ev.append({"cat": "user_annotation", "name": "rt.p.kernel.raygen", "ts": 11_002, "dur": 5,
               "tid": 1})
    level_counters(monkeypatch, [("rt.p.raygen", dict(rays=RAYS)),
                                 ("rt.p.kernel.raygen", dict(rays=RAYS)),
                                 ("rt.p.raygen", dict(rays=RAYS))])
    ctx, _ = stretch_of(tmp_path, monkeypatch, ev)
    assert manifest.reader("metrics", "raygen_kernel_share.frame")(ctx) == pytest.approx(50.0)


def test_a_program_that_counts_no_rays_reads_none(tmp_path, monkeypatch):
    """The program before the kernel: ``rt.p.raygen`` spans, no counters."""
    level_counters(monkeypatch, [])
    ctx, _ = stretch_of(tmp_path, monkeypatch, raygen_spans(frames_events(), kernel=False))
    assert manifest.reader("metrics", "raygen_kernel_share.frame")(ctx) is None


def test_the_host_time_is_the_raygen_layer_s_clock():
    read = manifest.reader("metrics", "raygen_host_ms.frame")
    assert read(types.SimpleNamespace(host_ms={"raygen": 0.42, "shade": 3.0})) == 0.42
    assert read(types.SimpleNamespace(host_ms={})) is None
