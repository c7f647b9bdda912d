"""The port's bench: the legs of the JAX package's ``bench.py`` and of its
single-leg scripts ``benchmarks/bench_{hitheavy,grad,branching,bigscene,
bigcurve}.py``, timed on the CUDA card.

    python -m realtrace_tpu_torch.apps.bench
    python -m realtrace_tpu_torch.apps.bench --legs 1,2,depth10 --reps 5
    python -m realtrace_tpu_torch.apps.bench --device cpu --width 32 --height 24 --reps 1
    python -m realtrace_tpu_torch.apps.bench --legs 1,2 --accel chunked

The legs, in ``bench.py``'s order (``--legs`` takes their numbers or names).
Every scene is ``apps/scenes.py``'s, at ``--width`` x ``--height``, one light
with shadows, ``accel="sweep"``; ``--obj`` (and ``--texture``) swaps the
procedural mesh for that OBJ, as the JAX bench renders bob_tri.obj:

1. ``headline``: mesh_scene (``serial_obj_scene``) at the serial framing
   (60, 60, 0), depth ``--depth``, chunk 32: forward Mrays/s;
2. ``hit-heavy``: the same at the close framing (0, 6, 14): Mrays/s;
3. ``grad``: at both framings, value and gradient of the mean squared pixel
   against a black target with respect to vertices, vertex colours and
   lights, over the forward frame of leg 1 or 2: backward/forward ratio;
4. ``train``: ``diff.inverse.make_train_step`` on leg 1's scene: vertices,
   colours, materials and lights, Adam at lr 1e-3, the chunk re-sort every
   step: ms/step;
5. ``branching``: glass_mesh_scene (``glass_bob_scene``), chunk 32: Mrays/s;
6. ``stream``: duplicated_mesh_scene(2) at depth 2, chunk 64, resident, then
   with the streaming kernel forced by ``ops/sweep.py::RESIDENT_LIMIT = 0``:
   the streaming/resident frame-time ratio;
7. ``bigscene``: duplicated_mesh_scene(4) at depth 2, chunk 64, which
   streams: Mrays/s;
8. ``bigcurve``: duplicated_mesh_scene(n), n = 4, 8, 16, as leg 7: Mrays/s
   for each n (the x4 point reuses leg 7's samples where leg 7 ran);
9. ``depth10``: leg 1 at depth 10: Mrays/s (skipped when ``--depth`` is 10).

Each leg's ``RenderConfig`` is the one the JAX bench builds for it
(``jax_config_fields``), carried over by ``core/convert.py::config_from_dict``.
``--accel`` (``sweep``, the default, ``chunked`` or ``bruteforce``) sets the
accel of legs 1-2, as ``RT_BENCH_ACCEL`` does in the JAX bench; a frame of
another accel than the sweep launches no sweep kernel.

Protocol, for every timed series: 2 untimed frames (or steps) first, then
``--reps`` samples (default 20 on legs 1 and 2, 10 on the others), each one
frame or step timed by the host clock around work that ends in
``torch.cuda.synchronize()``; then one more under ``torch.profiler``,
outside the timed window, for the card's busy ms and idle share
(``utils/profiling.py::device_busy``). Ratios are of medians. Checks: every
timed frame equals the first bit for bit with the same ray count, every
sample launches the same sweep kernels, and on the card only the kernel its
residency says (the forced run of leg 6 only the streaming one, and its
image equals the resident one's); the gradients repeat bit for bit; the
train step's loss stays finite and falls. A check that fails fails its leg.

Output: one JSON line per metric on stdout, ``{"metric", "value", "unit",
"vs_baseline"}`` as ``bench.py``'s ``emit`` prints them (``vs_baseline`` is
null: the JAX bench's baseline is a TPU target), plus the series' median,
quartiles, n and samples (ms), rays and kernel launches per frame, the
peak device memory of the line's series (``peak_device_bytes``: the peak
above what was allocated when the series began, so that what earlier legs
keep is not counted), the profiled frame's busy ms and idle share, and
``device``: the card's name and power limit as ``nvidia-smi`` gives them, or
``cpu`` (and then the metric's name starts with ``[cpu]``). The headline's
line is printed last, with ``run_k1_launches`` and ``run_k2_launches``: the
sweep launches of every timed sample of the run, each series counted once.
A leg that raises prints ``{"leg_failed": name, "error": ...}`` (its
traceback on stderr) and the other legs still run; no leg is retried, and
the exit code is 1 when any leg failed. Progress goes to stderr. Without a
card and without ``--device cpu`` it raises: nothing falls back.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from realtrace_tpu_torch.apps import scenes
from realtrace_tpu_torch.core.convert import config_from_dict
from realtrace_tpu_torch.core.types import RenderConfig, tensor_leaves
from realtrace_tpu_torch.diff import inverse
from realtrace_tpu_torch.ops import accel, sweep
from realtrace_tpu_torch.render.pipeline import render_with_stats
from realtrace_tpu_torch.utils import profiling

LEGS = ("headline", "hit-heavy", "grad", "train", "branching", "stream", "bigscene", "bigcurve",
        "depth10")
WARMUP = 2
CLOSE_POSITION = (0.0, 6.0, 14.0)                              # bench.py:418
GRAD_FIELDS = ("tri_vertices", "tri_colors", "lights")         # bench.py:199
TRAIN_FIELDS = ("tri_vertices", "tri_colors", "tri_materials", "lights")   # bench.py:248
CURVE_COPIES = (4, 8, 16)                                      # bench_bigcurve.py:32


def jax_config_fields(leg: str, depth: int) -> dict:
    """The fields of the JAX ``RenderConfig`` that ``bench.py`` (for leg 8
    ``bench_bigcurve.py``) builds for a leg, its environment at defaults."""
    if leg in ("stream", "bigscene", "bigcurve"):     # bench.py:295, :317; bench_bigcurve.py:41
        return dict(max_depth=2, accel="pallas", chunk_size=64)
    if leg == "branching":                            # bench.py:345
        return dict(max_depth=depth, accel="pallas", chunk_size=32)
    head = dict(max_depth=depth, accel="pallas", chunk_size=32, ray_block=8192,
                exact_mask_rays=1 << 19, exact_mask_secondary=False)      # bench.py:386-390
    return dict(head, max_depth=10) if leg == "depth10" else head     # bench.py:461


@dataclasses.dataclass(frozen=True)
class Workload:
    """One scene, framing and config that a leg times."""

    kind: str          # "mesh" (the model alone) or "glass" (behind the dielectric sphere)
    copies: int
    close: bool        # the close framing CLOSE_POSITION, else the serial one
    cfg: RenderConfig


def leg_workloads(leg: str, depth: int, accel_mode: str = "sweep") -> list[Workload]:
    """The workloads of a leg, in the order it times them; ``accel_mode`` is
    the accel of legs 1-2 (``--accel``)."""
    cfg = config_from_dict(jax_config_fields(leg, depth))
    if leg in ("headline", "hit-heavy"):
        cfg = dataclasses.replace(cfg, accel=accel_mode)
    return {"hit-heavy": [Workload("mesh", 1, True, cfg)],
            "grad": [Workload("mesh", 1, False, cfg), Workload("mesh", 1, True, cfg)],
            "branching": [Workload("glass", 1, False, cfg)],
            "stream": [Workload("mesh", 2, False, cfg)],
            "bigscene": [Workload("mesh", 4, False, cfg)],
            "bigcurve": [Workload("mesh", n, False, cfg) for n in CURVE_COPIES],
            }.get(leg, [Workload("mesh", 1, False, cfg)])


def build_scene(w: Workload, obj=None, texture=None, dtype=torch.float32, device=None):
    """A workload's scene with its chunk permutation, its camera dict and its
    name: the procedural forms, or with ``obj`` the JAX bench's OBJ forms."""
    if obj is None:
        if w.kind == "glass":
            (scene, cam), label = scenes.glass_mesh_scene(dtype=dtype, device=device), \
                "glass_mesh_scene"
        elif w.copies == 1:
            (scene, cam), label = scenes.mesh_scene(dtype=dtype, device=device), "mesh_scene"
        else:
            scene, cam = scenes.duplicated_mesh_scene(w.copies, dtype=dtype, device=device)
            label = f"duplicated_mesh_scene({w.copies})"
    else:
        kw = dict(texture_path=texture, dtype=dtype, device=device)
        name = Path(obj).name
        if w.kind == "glass":
            (scene, cam), label = scenes.glass_bob_scene(obj, **kw), f"glass_bob_scene({name})"
        elif w.copies == 1:
            (scene, cam), label = scenes.serial_obj_scene(obj, **kw), f"serial_obj_scene({name})"
        else:
            scene, cam = scenes.duplicated_serial_scene(w.copies, obj, **kw)
            label = f"duplicated_serial_scene({w.copies}, {name})"
    return accel.with_chunks(scene, w.cfg), dict(cam, position=position(w)), label


def position(w: Workload) -> tuple:
    """The camera position of a workload's framing."""
    return CLOSE_POSITION if w.close else tuple(scenes.SERIAL_CAM["position"])


def _quartiles(ms: list[float]) -> dict:
    q1, med, q3 = np.percentile(ms, [25, 50, 75])
    return dict(median_ms=float(med), q1_ms=float(q1), q3_ms=float(q3), n=len(ms),
                samples_ms=[round(x, 3) for x in ms])


class LegFailed(RuntimeError):
    """A leg's correctness check failed."""


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise LegFailed(what)


class Bench:
    """Runs the legs; holds the scenes and forward series that legs share."""

    def __init__(self, args, out=sys.stdout):
        self.args, self.out = args, out
        self.dev = torch.device(args.device)
        self.cuda = self.dev.type == "cuda"
        self.card = profiling.card_name() if self.cuda else "cpu"
        self.prefix = "" if self.cuda else "[cpu] "
        self.size = f"{args.width}x{args.height}"
        self.scenes: dict = {}     # (kind, copies, chunk_size) -> build_scene's result
        self.frames: dict = {}     # Workload -> its forward frames' series (no image)
        self.named: dict = {}      # Workload -> the first metric that printed its frames
        self.held: dict | None = None
        self.failed: list[str] = []
        self.run_launches = [0, 0]   # K1, K2 over every timed sample of the run

    # -- measurement -------------------------------------------------------

    def log(self, msg: str) -> None:
        print(f"[bench] {msg}", file=sys.stderr, flush=True)

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.dev)

    def reps(self, leg: str) -> int:
        if self.args.reps is not None:
            return self.args.reps
        return 20 if leg in ("headline", "hit-heavy") else 10

    def series(self, run, reps: int, check, tag: str) -> dict:
        """``WARMUP`` untimed calls of ``run``, ``reps`` timed ones (each
        result handed to ``check`` after its clock stops) and, on the card,
        one under ``torch.profiler``; the peak device memory of all of them above
        what was allocated before them. Every timed call must launch the same
        sweep kernels."""
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.dev)
            held = torch.cuda.memory_allocated(self.dev)
        for _ in range(WARMUP):
            run()
        ms, launches = [], set()
        for _ in range(reps):
            sweep.sweep.launches = sweep.sweep.stream_launches = 0
            self.sync()
            t0 = time.perf_counter()
            result = run()
            self.sync()
            ms.append((time.perf_counter() - t0) * 1e3)
            launches.add((sweep.sweep.launches, sweep.sweep.stream_launches))
            self.run_launches[0] += sweep.sweep.launches
            self.run_launches[1] += sweep.sweep.stream_launches
            check(result)
        _require(len(launches) == 1, f"{tag}: launches differ between samples: {launches}")
        k1, k2 = launches.pop()
        s = dict(_quartiles(ms), k1_per_frame=k1, k2_per_frame=k2, profiled_ms=None,
                 busy_ms=None, idle_share=None, device_events=None, peak_device_bytes=None)
        if self.cuda:
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                         acc_events=True) as prof:
                t0 = time.perf_counter()
                run()
                self.sync()
                total = (time.perf_counter() - t0) * 1e3
            busy = profiling.device_busy(prof, total)
            s.update(profiled_ms=total, busy_ms=busy["busy_ms"], idle_share=busy["idle_share"],
                     device_events=busy["device_events"],
                     peak_device_bytes=torch.cuda.max_memory_allocated(self.dev) - held)
        self.log(f"{tag}: median {s['median_ms']:.2f} ms (q1 {s['q1_ms']:.2f}, q3 "
                 f"{s['q3_ms']:.2f}, n {reps}), K1 {k1} K2 {k2} a sample, busy "
                 f"{s['busy_ms']} ms of {s['profiled_ms']}")
        return s

    def scene(self, w: Workload):
        """(scene, camera, name) of a workload; the scene is built once a run."""
        key = (w.kind, w.copies, w.cfg.chunk_size)
        if key not in self.scenes:
            self.scenes[key] = build_scene(w, self.args.obj, self.args.texture, device=self.dev)
        scene, cam, label = self.scenes[key]
        camera = scenes.make_camera(dict(cam, position=position(w)), self.args.width,
                                    self.args.height, device=self.dev)
        return scene, camera, label

    def frame_series(self, w: Workload, reps: int, tag: str) -> dict:
        """Timed forward frames of a workload, with the frame checks; the
        resident or streaming kernel as ``sweep.RESIDENT_LIMIT`` says now."""
        scene, camera, _ = self.scene(w)
        pack = sweep.build_pack(scene, w.cfg)
        first: list = []

        def check(result):
            img, n = result
            if not first:
                first.extend(result)
            _require(n == first[1] and torch.equal(img, first[0]),
                     f"{tag}: a timed frame differs from the first ({n} rays against "
                     f"{first[1]})")

        s = self.series(lambda: render_with_stats(scene, camera, w.cfg), reps, check, tag)
        if self.cuda:
            k1, k2 = s["k1_per_frame"], s["k2_per_frame"]
            if w.cfg.accel != "sweep":
                _require(k1 == k2 == 0, f"{tag}: K1 {k1} and K2 {k2} a frame with accel "
                                        f"{w.cfg.accel}")
            else:
                _require((k1 > 0 and k2 == 0) if pack.resident else (k2 > 0 and k1 == 0),
                         f"{tag}: K1 {k1} and K2 {k2} a frame, but the pack is "
                         f"{'resident' if pack.resident else 'streaming'}")
        return dict(s, rays_per_frame=int(first[1]), image=first[0],
                    checksum=float(first[0].double().sum()), triangles=scene.n_triangles,
                    chunks=pack.n_chunks, chunk_size=pack.chunk_size, resident=pack.resident,
                    constants_mb=pack.consts.numel() * 4 / 1e6,
                    residency_mb=pack.table_bytes / 1e6)

    def forward(self, w: Workload, leg: str) -> dict:
        """A workload's frame series, timed once per run: a later leg reuses it
        (its statistics; the image is not kept)."""
        if w not in self.frames:
            s = self.frame_series(w, self.reps(leg), f"{leg} x{w.copies}")
            self.frames[w] = {k: v for k, v in s.items() if k != "image"}
        return self.frames[w]

    # -- output --------------------------------------------------------------

    def name(self, w: Workload, what: str, framing: bool = True) -> str:
        scene, _, label = self.scene(w)
        where = (f" {'close' if w.close else 'serial'} framing "
                 f"({','.join(f'{x:g}' for x in position(w))})" if framing else "")
        return (f"{self.prefix}{what} {self.size} {label} {scene.n_triangles} tris{where} "
                f"depth-{w.cfg.max_depth} ({w.cfg.accel})")

    def emit(self, leg: str, metric: str, value: float, unit: str, stats: dict, **extra):
        """One metric's line (the headline's is held until the run ends)."""
        rec = {"metric": metric, "value": round(value, 3), "unit": unit, "vs_baseline": None,
               "device": self.card, "leg": leg}
        rec.update({k: v for k, v in stats.items() if k != "image"})
        rec.update(extra)
        if leg == "headline":
            self.held = rec
        else:
            print(json.dumps(rec), file=self.out, flush=True)

    def forward_line(self, leg: str, w: Workload, what="forward Mrays/s", framing=True, **extra):
        """Emit a workload's Mrays/s line; where an earlier leg timed the same
        workload, its samples, and the line names that leg's metric."""
        metric = self.name(w, what, framing)
        s = self.forward(w, leg)
        first = self.named.setdefault(w, metric)
        if first != metric:
            extra["same_samples_as"] = first
        self.emit(leg, metric, s["rays_per_frame"] / s["median_ms"] / 1e3, "Mrays/s", s,
                  frame_ms=s["median_ms"], **extra)

    # -- legs ----------------------------------------------------------------

    def leg_headline(self):
        self.forward_line("headline",
                          leg_workloads("headline", self.args.depth, self.args.accel)[0])

    def leg_hit_heavy(self):
        self.forward_line("hit-heavy",
                          leg_workloads("hit-heavy", self.args.depth, self.args.accel)[0])

    def leg_grad(self):
        for w in leg_workloads("grad", self.args.depth):
            fwd = self.forward(w, "grad")
            scene, camera, _ = self.scene(w)
            first: list = []

            def check(result):
                leaves = [result[0]] + tensor_leaves(result[1])
                if not first:
                    first.extend(leaves)
                _require(all(torch.equal(a, b) for a, b in zip(leaves, first)),
                         "grad: a gradient differs from the first sample's")
                _require(all(bool(torch.isfinite(x).all()) for x in leaves),
                         "grad: a gradient is not finite")

            bwd = self.series(lambda: inverse.image_grad(
                scene, camera, w.cfg, loss_fn=lambda buf: torch.mean(buf ** 2),
                fields=GRAD_FIELDS), self.reps("grad"), check, f"grad close={w.close}")
            self.emit("grad", self.name(w, "backward/forward time ratio"),
                      bwd["median_ms"] / fwd["median_ms"], "x", bwd,
                      forward_ms=fwd["median_ms"], backward_ms=bwd["median_ms"],
                      rays_per_frame=fwd["rays_per_frame"],
                      forward=fwd)

    def leg_train(self):
        w = leg_workloads("train", self.args.depth)[0]
        scene, camera, label = self.scene(w)
        target = torch.zeros((camera.height * camera.width, 3), device=self.dev)
        step, _, _ = inverse.make_train_step(scene, camera, w.cfg, target, lr=1e-3,
                                             fields=TRAIN_FIELDS)
        losses: list = []

        def run():
            losses.append(step())
            return losses[-1]

        s = self.series(run, self.reps("train"), lambda loss: None, "train")
        rays = (self.frames[w]["rays_per_frame"] if w in self.frames
                else render_with_stats(scene, camera, w.cfg)[1])
        values = [float(x) for x in losses]
        _require(bool(np.isfinite(values).all()), f"train: a loss is not finite: {values}")
        _require(values[-1] < values[0], f"train: the loss did not fall: {values}")
        name = (f"{self.prefix}train step (grad wrt verts+colors+materials+lights, adam, "
                f"chunk re-sort) {self.size} {label} {scene.n_triangles} tris "
                f"depth-{w.cfg.max_depth} (sweep)")
        self.emit("train", name, s["median_ms"], "ms/step", s, rays_per_frame=rays,
                  first_loss=values[0], last_loss=values[-1], steps=len(values))

    def leg_branching(self):
        w = leg_workloads("branching", self.args.depth)[0]
        _require(self.scene(w)[0].has_dielectrics(), "branching: the scene has no dielectric")
        self.forward_line("branching", w, framing=False)

    def leg_stream(self):
        w = leg_workloads("stream", self.args.depth)[0]
        _require(sweep.build_pack(self.scene(w)[0], w.cfg).resident,
                 "stream: the x2 scene is not resident")
        res = self.frame_series(w, self.reps("stream"), "stream resident")
        saved = sweep.RESIDENT_LIMIT
        sweep.RESIDENT_LIMIT = 0              # force the streaming kernel
        try:
            forced = self.frame_series(w, self.reps("stream"), "stream forced")
        finally:
            sweep.RESIDENT_LIMIT = saved
        _require(forced["rays_per_frame"] == res["rays_per_frame"]
                 and torch.equal(forced["image"], res["image"]),
                 "stream: the forced streaming frame differs from the resident one")
        mrays = res["rays_per_frame"] / 1e3
        self.emit("stream", self.name(w, "streaming/resident frame-time ratio", framing=False),
                  forced["median_ms"] / res["median_ms"], "x", forced,
                  resident_mrays=mrays / res["median_ms"],
                  streaming_mrays=mrays / forced["median_ms"],
                  resident_frames={k: v for k, v in res.items() if k != "image"})

    def leg_bigscene(self):
        w = leg_workloads("bigscene", self.args.depth)[0]
        _require(not sweep.build_pack(self.scene(w)[0], w.cfg).resident,
                 "bigscene: the x4 scene is resident")
        self.forward_line("bigscene", w, framing=False)

    def leg_bigcurve(self):
        for w in leg_workloads("bigcurve", self.args.depth):
            self.forward_line("bigcurve", w, what="big-scene curve: forward Mrays/s",
                              framing=False, copies=w.copies)

    def leg_depth10(self):
        if self.args.depth == 10:
            self.log("depth10: --depth is 10, so the headline is this leg")
            return
        self.forward_line("depth10", leg_workloads("depth10", self.args.depth)[0])

    def run(self, legs) -> int:
        """Each leg once, isolated: a leg that raises prints its
        ``leg_failed`` line and the next leg runs. Returns the exit code."""
        for leg in legs:
            self.log(f"leg {leg}")
            try:
                getattr(self, "leg_" + leg.replace("-", "_"))()
            except Exception as e:                      # noqa: BLE001 (a leg's boundary)
                traceback.print_exc(file=sys.stderr)
                self.failed.append(leg)
                print(json.dumps({"leg_failed": leg, "error": f"{type(e).__name__}: {e}"[:300]}),
                      file=self.out, flush=True)
        if self.held is not None:
            self.held.update(run_k1_launches=self.run_launches[0],
                             run_k2_launches=self.run_launches[1])
            print(json.dumps(self.held), file=self.out, flush=True)
        return 1 if self.failed else 0


def parse_legs(spec: str) -> list[str]:
    """``--legs``: numbers (1-9) or names, comma-separated, run in bench.py's order."""
    want = set()
    for part in spec.split(","):
        part = part.strip()
        leg = LEGS[int(part) - 1] if part.isdigit() and 1 <= int(part) <= len(LEGS) else part
        if leg not in LEGS:
            raise ValueError(f"--legs: unknown leg {part!r}; legs are 1-9 or {', '.join(LEGS)}")
        want.add(leg)
    return [leg for leg in LEGS if leg in want]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--legs", default=",".join(LEGS), help="comma list of leg numbers or names")
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--depth", type=int, default=3, help="depth of legs 1-5")
    p.add_argument("--accel", choices=("sweep", "chunked", "bruteforce"), default="sweep",
                   help="accel of legs 1-2 (RT_BENCH_ACCEL of the JAX bench); 'chunked' is "
                        "approximate")
    p.add_argument("--reps", type=int, default=None,
                   help="timed samples a series (default: 20 on legs 1 and 2, 10 elsewhere)")
    p.add_argument("--obj", default=None, help="OBJ mesh in place of the procedural mesh")
    p.add_argument("--texture", default=None, help="texture PNG for --obj")
    p.add_argument("--device", default="cuda", help="cuda (the default; raises without a "
                                                    "card) or cpu")
    return p


def main(argv=None, out=sys.stdout) -> int:
    args = build_parser().parse_args(argv)
    legs = parse_legs(args.legs)
    if args.reps is not None and args.reps < 1:
        raise ValueError("--reps must be at least 1")
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench: no CUDA card (--device cpu runs on the CPU; nothing falls "
                           "back)")
    return Bench(args, out).run(legs)


if __name__ == "__main__":
    raise SystemExit(main())
