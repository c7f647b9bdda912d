"""The check's teeth: whole runs of each cell at a tiny size on the CPU (the
harness's look for a card skipped), sound and with the timed path broken
underneath, and the control. A sound run is correct; every fault the cell
can have, and the control, come out not correct. (No cell spans chips, so
there is no exchange to leave out.)"""
import pytest
import torch

from rtbench import control, run, workload
from rtbench.tests.conftest import TINY_TRAFFIC, tiny

SEED = 2 ** 33 + 5
ORBITS = [("bob-orbit", "bob_1080p"), ("bob-close", "bob_1080p")]
FIT = ("bob-fit-close", "bob_1080p")


def tiny_run(cell, config, seconds=0.3, traced=False):
    return run.run_cell(cell, SEED, seconds, traced, device="cpu", config_overrides=tiny(config),
                        traffic_overrides=TINY_TRAFFIC)


@pytest.mark.parametrize("cell,config", ORBITS + [FIT])
def test_a_sound_run_is_correct(cell, config):
    r = tiny_run(cell, config)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and list(r)[-2:] == ["checks", "_extra"]


def test_a_traced_run_is_correct_and_reads_its_spans():
    r = tiny_run("bob-orbit", "bob_1080p", traced=True)
    assert r["correct"], r["checks"]
    assert r["metrics"]["mask_host_ms.frame"]["value"] > 0
    assert r["metrics"]["shade_host_ms.frame"]["value"] > 0
    assert r["device"]["window_s"] > 0


@pytest.mark.parametrize("cell,config", [ORBITS[0], FIT])
def test_the_control_is_not_correct(cell, config):
    c = control.control(cell, SEED, 3, device="cpu", config_overrides=tiny(config),
                        traffic_overrides=TINY_TRAFFIC)
    assert not c["correct"], c["checks"]


# -- faults of a frame ---------------------------------------------------------

def stale_frames(monkeypatch):
    """Every frame returns the first frame's image: a step that returns its
    state unchanged."""
    from realtrace_tpu_torch.render import pipeline

    orig, first = pipeline.render_with_stats, []

    def render(*a, **k):
        if not first:
            first.append(orig(*a, **k))
        return first[0]
    monkeypatch.setattr(pipeline, "render_with_stats", render)


def half_frames(monkeypatch):
    """Half of each frame's pixels left out (black)."""
    from realtrace_tpu_torch.render import pipeline

    orig = pipeline.render_with_stats

    def render(*a, **k):
        img, n = orig(*a, **k)
        img = img.clone()
        img[: img.shape[0] // 2] = 0.0
        return img, n
    monkeypatch.setattr(pipeline, "render_with_stats", render)


def altered_hits(monkeypatch):
    """One hit in three moved to the next triangle, where the sweep produces it."""
    from realtrace_tpu_torch.ops import sweep

    orig = sweep.sweep

    def altered(*a, **k):
        t, i = orig(*a, **k)
        i = i.clone()
        sel = (i >= 0) & (torch.arange(i.shape[0]) % 3 == 0)
        i[sel] = (i[sel] + 1) % (a[2].shape[0] * a[2].shape[1])
        return t, i
    altered.launches, altered.stream_launches = 0, 0
    monkeypatch.setattr(sweep, "sweep", altered)


@pytest.mark.parametrize("fault", [stale_frames, half_frames, altered_hits])
def test_a_broken_frame_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    r = tiny_run("bob-orbit", "bob_1080p", seconds=2.5)
    assert r["attempted"] >= 2 and not r["correct"], r["checks"]


# -- faults of a fit step --------------------------------------------------------

def unchanged_state(monkeypatch):
    """The step computes its loss and gradients but leaves the parameters as
    they were."""
    from realtrace_tpu_torch.diff import inverse

    orig = inverse.make_train_step

    def make(*a, **k):
        step, params, opt = orig(*a, **k)
        leaves = [p for p in opt.param_groups[0]["params"]]

        def frozen():
            keep = [p.detach().clone() for p in leaves]
            loss = step()
            with torch.no_grad():
                for p, v in zip(leaves, keep):
                    p.copy_(v)
            return loss
        return frozen, params, opt
    monkeypatch.setattr(inverse, "make_train_step", make)


def half_batch(monkeypatch):
    """The loss is the mean over half of the pixels, the rest left out."""
    from realtrace_tpu_torch.diff import inverse
    from realtrace_tpu_torch.ops import accel

    def loss(params, scene, camera, cfg, target, resort=False):
        s = inverse.apply_params(scene, params)
        if resort:
            s = accel.resort_chunks(s, cfg)
        buf = inverse.render_buffer(s, camera, cfg)
        n = buf.shape[0] // 2
        return torch.mean((buf[:n] - target.reshape(-1, 3)[:n]) ** 2)
    monkeypatch.setattr(inverse, "render_loss", loss)


def unchanged_after_warm_up(monkeypatch):
    """The step is sound for the first steps, which set-up runs, and leaves
    the parameters as they were from then on."""
    from realtrace_tpu_torch.diff import inverse

    orig = inverse.make_train_step

    def make(*a, **k):
        step, params, opt = orig(*a, **k)
        leaves = [p for p in opt.param_groups[0]["params"]]
        calls = []

        def later_frozen():
            calls.append(1)
            if len(calls) <= workload.CHECK_STEPS:
                return step()
            keep = [p.detach().clone() for p in leaves]
            loss = step()
            with torch.no_grad():
                for p, v in zip(leaves, keep):
                    p.copy_(v)
            return loss
        return later_frozen, params, opt
    monkeypatch.setattr(inverse, "make_train_step", make)


@pytest.mark.parametrize("fault", [unchanged_state, half_batch, altered_hits,
                                   unchanged_after_warm_up])
def test_a_broken_fit_step_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    r = tiny_run(*FIT)
    assert not r["correct"], r["checks"]


def test_a_tiny_run_on_the_card_launches_the_kernel_and_is_correct(cuda):
    r = run.run_cell("bob-orbit", SEED, 1.0, True, device=cuda, config_overrides=tiny("bob_1080p"),
                     traffic_overrides=TINY_TRAFFIC)
    assert r["correct"], r["checks"]
    assert r["_extra"]["k1_launches_per_unit"] > 0 and r["device"]["busy_s"] > 0
    assert r["metrics"]["sweep_device_ms.frame"]["value"] > 0
