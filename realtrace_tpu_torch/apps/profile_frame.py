"""Where one frame's, or one train step's, time goes, on the CUDA card.

    python -m realtrace_tpu_torch.apps.profile_frame --scene mesh --copies 8
    python -m realtrace_tpu_torch.apps.profile_frame --scene glass
    python -m realtrace_tpu_torch.apps.profile_frame --backward

For the chosen scene at 1920x1080, depth 3, shadows, accel="sweep" it prints
one JSON object per line:

* ``frames`` (``steps`` with ``--backward``): host-clock ms of a few
  synchronised frames or train steps after a warm-up, traced rays, launches
  of each sweep kernel, peak device memory;
* ``layers``: one frame or step with every layer wrapped in synchronised
  timers (the synchronisation stretches it; the shares are what it shows).
  Nested layers are listed under their own names and also count in their
  caller's time: the exact mask contains its interval pass and its super
  gate, a train step's ``level shading`` its hit attributes, phong and
  child geometry. Layers that run inside the backward are listed as
  ``backward: <layer>`` (with remat: the recomputed shading);
* ``profile``: one frame or step under ``torch.profiler``: kernel launches,
  the time the card was busy, its idle share, the kernels that took the most
  device time and, for a step, the backward's autograd nodes by device time
  (``IndexBackward0`` is the dual of the shade-table gathers, a scatter-add;
  the node that first reads a checkpointed level's saved tensors also runs
  that level's recomputation).

``--backward`` profiles one train step of ``diff.inverse.make_train_step``
instead of a frame: the mean squared error against a black target (the JAX
package's train-step leg, bench.py:236-282), the gradient of vertices,
vertex colours, materials and lights, the chunk re-sort, Adam.

``--lists`` picks the chunk-list policy for the card: ``interval`` (interval
lists at every query width; the kernels' warps prune them), ``exact`` (the
CPU's policy: exact masks for narrow queries and big scenes) or ``default``
(what ``ops/sweep.py::INTERVAL_LISTS_ON_CUDA`` says).

Every line carries the card's name and power limit. It needs a card.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time

import torch

from realtrace_tpu_torch.apps import scenes
from realtrace_tpu_torch.core.types import RenderConfig
from realtrace_tpu_torch.diff import inverse
from realtrace_tpu_torch.ops import accel, sweep
from realtrace_tpu_torch.render import pipeline, shade
from realtrace_tpu_torch.utils import profiling

# (module, function, layer name); hit_attributes and closest_query are looked
# up by shade under its own names
LAYERS = ((sweep, "chunk_mask", "interval mask"), (sweep, "chunk_mask_exact", "exact mask"),
          (sweep, "super_tile_mask", "super gate"), (sweep, "sweep", "sweep kernel"),
          (sweep, "build_pack", "pack"), (shade, "hit_attributes", "hit attributes"),
          (shade, "light_shade", "phong"), (shade, "_children_geom", "child geometry"),
          (shade, "_add_tiles", "tile adds"), (pipeline, "_tiled_rays", "ray generation"))
# a train step's own layers
STEP_LAYERS = ((accel, "resort_chunks", "re-sort"), (shade, "_shade_level", "level shading"))
TRAIN_FIELDS = ("tri_vertices", "tri_colors", "tri_materials", "lights")   # bench.py:248


@contextlib.contextmanager
def timed_layers(times: dict, calls: dict, layers=LAYERS, where=None):
    """Wrap every layer in a synchronised host timer for the block. A layer
    called while ``where["phase"]`` is set is listed as ``<phase>: <layer>``."""
    saved = []
    for mod, fn_name, layer in layers:
        fn = getattr(mod, fn_name)

        def wrapper(*a, _fn=fn, _layer=layer, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:    # a checkpoint's recomputation leaves its function by an exception
                return _fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                phase = (where or {}).get("phase")
                key = f"{phase}: {_layer}" if phase else _layer
                times[key] = times.get(key, 0.0) + (time.perf_counter() - t0) * 1e3
                calls[key] = calls.get(key, 0) + 1

        for attr in ("launches", "stream_launches"):     # the sweep's counters
            if hasattr(fn, attr):
                setattr(wrapper, attr, getattr(fn, attr))
        saved.append((mod, fn_name, fn, wrapper))
        setattr(mod, fn_name, wrapper)
    try:
        yield
    finally:
        for mod, fn_name, fn, wrapper in saved:
            for attr in ("launches", "stream_launches"):
                if hasattr(fn, attr):
                    setattr(fn, attr, getattr(wrapper, attr))
            setattr(mod, fn_name, fn)


class _Phases:
    """Times a train step's backward and optimiser step as layers, and marks
    the layers called inside them (``where["phase"]``)."""

    def __init__(self, optimizer, times: dict, where: dict):
        self.optimizer, self.times, self.where = optimizer, times, where

    def _timed(self, name, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            self.where["phase"] = name
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                self.where["phase"] = None
                self.times[name] = self.times.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
        return run

    @contextlib.contextmanager
    def on(self):
        backward, opt_step = torch.Tensor.backward, self.optimizer.step
        torch.Tensor.backward = self._timed("backward", backward)
        self.optimizer.step = self._timed("optimizer", opt_step)
        try:
            yield
        finally:
            torch.Tensor.backward = backward
            self.optimizer.step = opt_step


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--scene", choices=["mesh", "glass"], default="mesh")
    p.add_argument("--copies", type=int, default=1)
    p.add_argument("--position", type=float, nargs=3, default=None,
                   help="camera position (default: the serial framing)")
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--depth", type=int, default=3)
    p.add_argument("--frames", type=int, default=5, help="timed frames (or train steps)")
    p.add_argument("--lists", choices=["default", "interval", "exact"], default="default")
    p.add_argument("--backward", action="store_true",
                   help="profile a train step (forward, backward, re-sort, Adam)")
    args = p.parse_args(argv)
    if args.lists != "default":
        sweep.INTERVAL_LISTS_ON_CUDA = args.lists == "interval"

    dev = torch.device("cuda", 0)
    card = profiling.card_name()
    cfg = RenderConfig(max_depth=args.depth, accel="sweep")
    if args.scene == "glass":
        scene, cam = scenes.glass_mesh_scene(device=dev)
    else:
        scene, cam = scenes.duplicated_mesh_scene(args.copies, device=dev)
    if args.position is not None:
        cam = dict(cam, position=tuple(args.position))
    scene = accel.with_chunks(scene, cfg)
    camera = scenes.make_camera(cam, args.width, args.height, device=dev)
    tag = dict(scene=args.scene, copies=args.copies, triangles=scene.n_triangles,
               position=list(cam["position"]), size=[args.width, args.height],
               depth=args.depth, card=card,
               lists="interval" if sweep.INTERVAL_LISTS_ON_CUDA else "exact")
    rays = []
    layers, where, phases = LAYERS, {}, contextlib.nullcontext

    if args.backward:
        target = torch.zeros((args.width * args.height, 3), device=dev)
        step, _, optimizer = inverse.make_train_step(scene, camera, cfg, target,
                                                     fields=TRAIN_FIELDS)
        layers = LAYERS + STEP_LAYERS
        tag.update(kind_of="train step", fields=list(TRAIN_FIELDS), remat=cfg.remat)

        def run():
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3
    else:
        def run():
            t0 = time.perf_counter()
            _, n = pipeline.render_with_stats(scene, camera, cfg)
            torch.cuda.synchronize()
            rays[:] = [n]
            return (time.perf_counter() - t0) * 1e3

    run()
    torch.cuda.reset_peak_memory_stats()
    sweep.sweep.launches = sweep.sweep.stream_launches = 0
    ms = [run() for _ in range(args.frames)]
    print(json.dumps(dict(tag, kind="steps" if args.backward else "frames", ms=ms,
                          rays=rays[0] if rays else None,
                          resident_launches=sweep.sweep.launches // args.frames,
                          stream_launches=sweep.sweep.stream_launches // args.frames,
                          peak_device_bytes=torch.cuda.max_memory_allocated())), flush=True)

    times, calls = {}, {}
    if args.backward:
        phases = _Phases(optimizer, times, where).on
    with timed_layers(times, calls, layers, where), phases():
        total = run()
    print(json.dumps(dict(tag, kind="layers", total_ms=total, ms=times, calls=calls)), flush=True)

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        total = run()
    out = dict(tag, kind="profile", total_ms=total, **profiling.device_busy(prof, total))
    if args.backward:
        prefix = "autograd::engine::evaluate_function: "
        nodes = [(e.key[len(prefix):], getattr(e, "device_time_total", None)
                  or getattr(e, "cuda_time_total", 0.0))
                 for e in prof.key_averages() if e.key.startswith(prefix)]
        top = sorted(nodes, key=lambda kv: -kv[1])[:10]
        out["backward_nodes_ms"] = {k: v / 1e3 for k, v in top}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
