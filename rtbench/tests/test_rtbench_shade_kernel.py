"""The reader of the level kernels' share of the wavefront's lanes,
``shade_kernel_share.frame``, on a synthetic trace."""
import pytest

from rtbench import manifest
from rtbench.tests.test_rtbench_glass import level_counters
from rtbench.tests.test_rtbench_program import frames_events, stretch_of

LEVELS = [("rt.p.level.0", dict(rays=9, tiles=4, live=100, lanes=4096)),
          ("rt.p.level.2", dict(rays=9, tiles=2, live=1800, lanes=2048))]


def shade_spans(events):
    """A shading kernel span inside level 0 and level 2 of each frame."""
    for f0 in (10_000, 11_000):
        for at in (f0 + 100, f0 + 450):
            events.append({"cat": "user_annotation", "name": "rt.p.kernel.shade", "ts": at,
                           "dur": 5, "tid": 1})
    return events


def test_every_lane_shaded_by_the_kernel_reads_100(tmp_path, monkeypatch):
    entries = []
    for _ in range(2):
        entries += [LEVELS[0], ("rt.p.kernel.shade", dict(lanes=4096)),
                    LEVELS[1], ("rt.p.kernel.shade", dict(lanes=2048))]
    level_counters(monkeypatch, entries)
    ctx, _ = stretch_of(tmp_path, monkeypatch, shade_spans(frames_events()))
    assert manifest.reader("metrics", "shade_kernel_share.frame")(ctx) == pytest.approx(100.0)


def test_a_level_shaded_without_the_kernel_lowers_the_share(tmp_path, monkeypatch):
    ev = frames_events()
    for f0 in (10_000, 11_000):     # level 2 only: level 0 took the PyTorch code
        ev.append({"cat": "user_annotation", "name": "rt.p.kernel.shade", "ts": f0 + 450,
                   "dur": 5, "tid": 1})
    level_counters(monkeypatch, [LEVELS[0], LEVELS[1], ("rt.p.kernel.shade", dict(lanes=2048))]
                   * 2)
    ctx, _ = stretch_of(tmp_path, monkeypatch, ev)
    assert manifest.reader("metrics", "shade_kernel_share.frame")(ctx) == \
        pytest.approx(100.0 * 4096 / 12288)


def test_a_program_without_the_kernel_s_span_reads_none(tmp_path, monkeypatch):
    level_counters(monkeypatch, LEVELS * 2)
    ctx, _ = stretch_of(tmp_path, monkeypatch, frames_events())
    assert manifest.reader("metrics", "shade_kernel_share.frame")(ctx) is None
