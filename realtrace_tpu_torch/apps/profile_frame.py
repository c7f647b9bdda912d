"""Where one frame's, or one train step's, time goes, on the CUDA card.

    python -m realtrace_tpu_torch.apps.profile_frame --scene mesh --copies 8
    python -m realtrace_tpu_torch.apps.profile_frame --scene glass
    python -m realtrace_tpu_torch.apps.profile_frame --backward

For the chosen scene at 1920x1080, depth 3, shadows, accel="sweep" it prints
one JSON object per line:

* ``frames`` (``steps`` with ``--backward``): host-clock ms of a few
  synchronised frames or train steps after a warm-up, traced rays, launches
  of each sweep kernel, peak device memory;
* ``layers``: the program's own spans (``rt.p.*``, ``utils/profiling.py``)
  in one frame or step under ``torch.profiler``: for each span name its
  calls, host ms (the profiler stretches them) and the device ms of the work
  launched inside it, from any thread. Spans nest and count in their
  caller's time too: ``rt.p.level.<k>`` holds a wavefront level's masks,
  kernels, hit attributes, shading, compaction and host syncs
  (``rt.p.sync.<site>``); ``rt.p.backward`` the recomputed shading;
* ``profile``: the same frame or step: kernel launches,
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
import bisect
import json
import tempfile
import time

import torch

from realtrace_tpu_torch.apps import scenes
from realtrace_tpu_torch.core.types import RenderConfig
from realtrace_tpu_torch.diff import inverse
from realtrace_tpu_torch.ops import accel, sweep
from realtrace_tpu_torch.render import pipeline
from realtrace_tpu_torch.utils import profiling

TRAIN_FIELDS = ("tri_vertices", "tri_colors", "tri_materials", "lights")   # bench.py:248
# Chrome-trace categories: the host's launching calls, and the device's work
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def span_table(prof) -> dict:
    """The program's spans (``rt.p.*``) of a finished ``torch.profiler``
    profile, from its Chrome trace: for each name its calls, host ms (the
    sum of its ranges) and device ms (the kernels, copies and sets launched
    inside its ranges, from any thread, each tied to its launch by the
    profiler's correlation id)."""
    with tempfile.TemporaryDirectory() as d:
        prof.export_chrome_trace(f"{d}/trace.json")
        with open(f"{d}/trace.json") as f:
            events = json.load(f)["traceEvents"]
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    launched = sorted((launch[e["args"]["correlation"]], e.get("dur", 0)) for e in events
                      if e.get("cat") in DEVICE_CATS
                      and e.get("args", {}).get("correlation") in launch)
    starts = [t for t, _ in launched]
    cum = [0.0]
    for _, us in launched:
        cum.append(cum[-1] + us)
    spans = [e for e in events
             if e.get("cat") == "user_annotation" and e["name"].startswith("rt.p.")]
    out = {}
    for name in sorted({e["name"] for e in spans}):
        mine = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in spans if e["name"] == name]
        merged: list = []
        for a, b in sorted(mine):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        device_us = sum(cum[bisect.bisect_right(starts, b)] - cum[bisect.bisect_left(starts, a)]
                        for a, b in merged)
        out[name] = dict(calls=len(mine), host_ms=sum(b - a for a, b in mine) / 1e3,
                         device_ms=device_us / 1e3)
    return out


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
    if args.backward:
        target = torch.zeros((args.width * args.height, 3), device=dev)
        step, _, _ = inverse.make_train_step(scene, camera, cfg, target, fields=TRAIN_FIELDS)
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

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        total = run()
    print(json.dumps(dict(tag, kind="layers", total_ms=total, spans=span_table(prof))),
          flush=True)
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
