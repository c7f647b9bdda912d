"""The glass-orbit cell (``glass_bob_1080p``: the mesh made glass, every hit
a reflect and a refract child to depth 10) at the tiny size on the CPU, its
check's teeth, and the readers of the wavefront's lane counters and of the
repack's span on a synthetic trace."""
import pytest

from rtbench import manifest, program, run
from rtbench.tests.test_rtbench_faults import half_frames, tiny_run
from rtbench.tests.test_rtbench_program import frames_events, stretch_of

CELL = ("glass-orbit", "glass_bob_1080p")


def test_the_glass_cell_is_correct_and_reads_its_lanes(tmp_path, monkeypatch):
    # its own trace file: another test's traced run may write the shared one meanwhile
    monkeypatch.setattr(run, "OUT", tmp_path)
    monkeypatch.setattr(program, "TRACE", tmp_path / "trace.json")
    r = tiny_run(*CELL, traced=True)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1
    # the repacked levels hold their live lanes rounded up to a tile
    assert r["metrics"]["lane_share.frame"]["value"] >= 50.0
    levels = r["_extra"]["levels"]
    assert len(levels) == 11 and levels["10"]["rays"] > 0


def test_a_glass_frame_with_half_its_pixels_black_is_not_correct(monkeypatch):
    half_frames(monkeypatch)
    r = tiny_run(*CELL)
    assert not r["correct"], r["checks"]


def level_counters(monkeypatch, entries):
    """A recorder holding ``entries`` for the levels of frames_events: level
    0 and level 2 of each of its two frames."""
    from realtrace_tpu_torch.utils import profiling

    recorder = profiling.Recorder()
    for name, c in entries:
        recorder.log.append((name, c))
    monkeypatch.setattr(profiling, "RECORDER", recorder)


def test_the_lane_share_reads_levels_1_and_up(tmp_path, monkeypatch):
    level_counters(monkeypatch, [
        ("rt.p.level.0", dict(rays=9, tiles=4, live=100, lanes=4096)),
        ("rt.p.level.2", dict(rays=9, tiles=2, live=1800, lanes=2048)),
        ("rt.p.level.0", dict(rays=9, tiles=4, live=100, lanes=4096)),
        ("rt.p.level.2", dict(rays=9, tiles=1, live=700, lanes=1024))])
    ctx, _ = stretch_of(tmp_path, monkeypatch, frames_events())
    read = manifest.reader("metrics", "lane_share.frame")
    assert read(ctx) == pytest.approx(100.0 * 2500 / 3072)


def test_without_lane_counters_the_lane_share_is_none(tmp_path, monkeypatch):
    """A program that counts only rays and tiles a level reads nothing."""
    level_counters(monkeypatch, [("rt.p.level.0", dict(rays=9, tiles=4)),
                                 ("rt.p.level.2", dict(rays=9, tiles=2))] * 2)
    ctx, _ = stretch_of(tmp_path, monkeypatch, frames_events())
    assert manifest.reader("metrics", "lane_share.frame")(ctx) is None


def test_the_repack_s_device_time_is_read_inside_its_spans(tmp_path, monkeypatch):
    read = manifest.reader("metrics", "repack_device_ms.frame")
    ctx, _ = stretch_of(tmp_path, monkeypatch, frames_events())
    assert read(ctx) is None                      # no rt.p.repack span
    ev = frames_events()
    for f0 in (10_000, 11_000):                   # level 2's kernel, launched at f0 + 410
        ev.append({"cat": "user_annotation", "name": "rt.p.repack", "ts": f0 + 405, "dur": 20,
                   "tid": 1})
    ctx, _ = stretch_of(tmp_path, monkeypatch, ev)
    assert read(ctx) == pytest.approx(0.030)
