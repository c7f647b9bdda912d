"""Where one frame's time goes, on the CUDA card.

    python -m realtrace_tpu_torch.apps.profile_frame --scene mesh --copies 8
    python -m realtrace_tpu_torch.apps.profile_frame --scene glass

For the chosen scene at 1920x1080, depth 3, shadows, accel="sweep" it prints
one JSON object per line:

* ``frames``: host-clock ms of a few synchronised frames after a warm-up,
  traced rays, launches of each sweep kernel, peak device memory;
* ``layers``: one frame with every layer wrapped in synchronised timers (the
  synchronisation stretches the frame; the shares are what it shows). Nested
  layers are listed under their own names and also count in their caller's
  time: the exact mask contains its interval pass and its super gate;
* ``profile``: one frame under ``torch.profiler``: kernel launches, the time
  the card was busy, and its idle share of the frame.

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
import subprocess
import time

import torch

from realtrace_tpu_torch.apps import scenes
from realtrace_tpu_torch.core.types import RenderConfig
from realtrace_tpu_torch.ops import accel, intersect, sweep
from realtrace_tpu_torch.render import pipeline, shade

# (module, function, layer name); hit_attributes and closest_query are looked
# up by shade under its own names
LAYERS = ((sweep, "chunk_mask", "interval mask"), (sweep, "chunk_mask_exact", "exact mask"),
          (sweep, "super_tile_mask", "super gate"), (sweep, "sweep", "sweep kernel"),
          (sweep, "build_pack", "pack"), (shade, "hit_attributes", "hit attributes"),
          (shade, "light_shade", "phong"), (shade, "_children_geom", "child geometry"),
          (shade, "_add_tiles", "tile adds"), (pipeline, "_tiled_rays", "ray generation"))


@contextlib.contextmanager
def timed_layers(times: dict, calls: dict):
    """Wrap every layer in a synchronised host timer for the block."""
    saved = []
    for mod, fn_name, layer in LAYERS:
        fn = getattr(mod, fn_name)

        def wrapper(*a, _fn=fn, _layer=layer, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*a, **k)
            torch.cuda.synchronize()
            times[_layer] = times.get(_layer, 0.0) + (time.perf_counter() - t0) * 1e3
            calls[_layer] = calls.get(_layer, 0) + 1
            return out

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
    p.add_argument("--frames", type=int, default=5)
    p.add_argument("--lists", choices=["default", "interval", "exact"], default="default")
    args = p.parse_args(argv)
    if args.lists != "default":
        sweep.INTERVAL_LISTS_ON_CUDA = args.lists == "interval"

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
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

    def frame():
        t0 = time.perf_counter()
        _, n = pipeline.render_with_stats(scene, camera, cfg)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, n

    frame()
    torch.cuda.reset_peak_memory_stats()
    sweep.sweep.launches = sweep.sweep.stream_launches = 0
    ms = [frame() for _ in range(args.frames)]
    print(json.dumps(dict(tag, kind="frames", ms=[m for m, _ in ms], rays=ms[0][1],
                          resident_launches=sweep.sweep.launches // args.frames,
                          stream_launches=sweep.sweep.stream_launches // args.frames,
                          peak_device_bytes=torch.cuda.max_memory_allocated())), flush=True)

    times, calls = {}, {}
    with timed_layers(times, calls):
        total, _ = frame()
    print(json.dumps(dict(tag, kind="layers", frame_ms=total, ms=times, calls=calls)), flush=True)

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        total, _ = frame()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time for e in events) / 1e3
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(json.dumps(dict(tag, kind="profile", frame_ms=total, device_events=len(events),
                          busy_ms=busy, idle_share=1.0 - busy / total if events else None,
                          top_ms={k[:60]: v for k, v in top})), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
