"""Animated orbit-camera flythrough.

Counterpart of ``realtrace_tpu/apps/flythrough.py``: the headless equivalent
of the reference's GLUT interactive loop (Parellel/main.cu:101-113 and the
interactive_camera orbit model). The orbit camera sweeps yaw and pitch while
each frame is rendered on the card (``--device cpu`` asks for the CPU).

    python -m realtrace_tpu_torch.apps.flythrough --frames 24 --out-dir frames
    torchrun --nproc_per_node N -m realtrace_tpu_torch.apps.flythrough --mesh N

With ``--mesh N`` (under torchrun, one rank a card) every frame is a
pixel-tile-sharded render over the N ranks.
"""
from __future__ import annotations

import argparse
import math
import sys
import time
from pathlib import Path

import torch

from realtrace_tpu_torch.io.image import save_png
from realtrace_tpu_torch.render.pipeline import render_with_stats
from realtrace_tpu_torch.utils.profiling import FrameTimer, block, frame_bracket


def run_flythrough(scene, interactive_cam, cfg, frames: int = 24, yaw_step: float = 0.26,
                   pitch_amp: float = 0.2, out_dir: str | None = None, dtype=None, mesh=None):
    """Render an orbit sweep: (images, mean fps). Each frame is bracketed by
    ``frame_bracket(f"flythrough_frame_{i}")``; the first frame (kernel
    build, warm-up) is left out of the fps.

    ``mesh`` (``parallel.mesh.make_mesh``): every frame is a
    ``sharded_render`` over the ranks, the scene broadcast from rank 0 once.
    Sharded frames report no ray count. ``out_dir`` gets one PNG a frame (on
    rank 0 of a mesh)."""
    dtype = dtype or scene.dtype
    device = scene.tri_vertices.device
    save = out_dir is not None
    if mesh is not None:
        import torch.distributed as dist

        from realtrace_tpu_torch.parallel import mesh as pmesh
        scene = pmesh.replicate_scene(scene, mesh)
        save = save and (not dist.is_initialized() or dist.get_rank() == 0)

        def frame_fn(s, c):
            return pmesh.sharded_render(s, c, cfg, mesh), 0
    else:
        def frame_fn(s, c):
            return render_with_stats(s, c, cfg)

    images = []
    timer = FrameTimer(window=1e9)
    base_pitch = interactive_cam.pitch
    t_start = None
    for i in range(frames):
        interactive_cam.change_yaw(yaw_step)
        interactive_cam.pitch = base_pitch
        interactive_cam.change_pitch(pitch_amp * math.sin(2 * math.pi * i / frames))
        camera = interactive_cam.build_render_camera(dtype=dtype, device=device)
        with frame_bracket(f"flythrough_frame_{i}"), torch.no_grad():
            img, nrays = frame_fn(scene, camera)
            block(img)
        if i == 0:
            t_start = time.perf_counter()
        else:
            timer.frame(float(nrays))
        images.append(img)
        if save:
            save_png(Path(out_dir) / f"frame_{i:04d}.png", img.cpu().numpy())
    dt = time.perf_counter() - t_start if frames > 1 else 0.0
    fps = (frames - 1) / dt if dt > 0 else 0.0
    return images, fps


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--obj", default=None,
                   help="OBJ mesh in the serial app's setup (default: the procedural mesh_scene)")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--frames", type=int, default=24)
    p.add_argument("--radius", type=float, default=120.0)
    p.add_argument("--depth", type=int, default=2)
    p.add_argument("--accel", choices=["bruteforce", "chunked", "sweep"], default="sweep",
                   help="'chunked' is approximate")
    p.add_argument("--mesh", type=int, default=0,
                   help="shard pixel tiles over N ranks (run under torchrun with N ranks; "
                        "0 = one process)")
    p.add_argument("--out-dir", default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; fails without a card) or cpu")
    args = p.parse_args(argv)

    from realtrace_tpu_torch.apps import scenes
    from realtrace_tpu_torch.core.types import RenderConfig
    from realtrace_tpu_torch.ops import accel
    from realtrace_tpu_torch.render.camera import InteractiveCamera

    dev = torch.device(args.device)
    mesh = None
    rank = 0
    if args.mesh:
        import torch.distributed as dist

        from realtrace_tpu_torch.parallel import mesh as pmesh
        dev = pmesh.init_distributed(device=None if dev.type == "cuda" else dev)
        mesh = pmesh.make_mesh(args.mesh)
        rank = dist.get_rank()
    cfg = RenderConfig(max_depth=args.depth, accel=args.accel)
    accel.warn_if_approximate(cfg)
    if args.obj:
        scene, _ = scenes.serial_obj_scene(args.obj, device=dev)
    else:
        scene, _ = scenes.mesh_scene(device=dev)
    if cfg.accel != "bruteforce" and scene.n_triangles:
        scene = accel.with_chunks(scene, cfg)
    cam = InteractiveCamera(radius=args.radius, resolution=(args.width, args.height))
    if args.out_dir:
        Path(args.out_dir).mkdir(parents=True, exist_ok=True)
    try:
        _, fps = run_flythrough(scene, cam, cfg, frames=args.frames, out_dir=args.out_dir,
                                mesh=mesh)
    finally:
        if mesh is not None:
            dist.destroy_process_group()
    if rank == 0:
        tag = f" (sharded over {args.mesh} ranks)" if mesh is not None else ""
        print(f"[INFO] flythrough: {args.frames} frames @ {fps:.2f} fps{tag}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
