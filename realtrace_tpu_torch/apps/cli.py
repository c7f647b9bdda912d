"""Headless render CLI.

    python -m realtrace_tpu_torch.apps.cli --scene mesh --width 1920 --height 1080 \\
        --depth 3 --accel sweep --out mesh.png

renders with ``render_with_stats`` on the CUDA card (``--device cpu`` asks for
the CPU; there is no fallback), writes a PNG (without ``--out``, a
timestamped one in the working directory) and reports frame time and traced
rays on stderr. ``--copies 8`` renders the duplicated big scene, ``--scene
glass`` the dielectric one, ``--scene serial --obj bob_tri.obj`` the serial
app's setup (``--copies N`` duplicates it, ``--scene glass --obj ...`` puts
the dielectric sphere in front of it), ``--scene parallel --obj ...`` the
CUDA app's setup and ``--scene primitives`` every primitive family with a
dielectric cylinder. Without ``--obj`` the serial and parallel scenes load
``bob_tri.obj`` from the asset folder (``scenes.asset``).
"""
from __future__ import annotations

import argparse
import sys
import time

import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="realtrace-tpu-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--scene", choices=["mesh", "glass", "serial", "parallel", "sphere_plane",
                                       "primitives"],
                   default="mesh",
                   help="mesh: the procedural bob-sized mesh; glass: the mesh (or --obj) "
                        "behind a dielectric sphere; serial / parallel: --obj in the serial / "
                        "CUDA app's setup; sphere_plane: sphere over a reflective floor; "
                        "primitives: every primitive family, a dielectric cylinder")
    p.add_argument("--copies", type=int, default=1,
                   help="copies of the model on an x/z grid (the big-scene workload; mesh and "
                        "serial scenes only)")
    p.add_argument("--obj", default=None,
                   help="OBJ mesh path (serial, parallel and glass scenes)")
    p.add_argument("--texture", default=None, help="texture PNG sampled per vertex")
    p.add_argument("--scale", type=float, default=None,
                   help="OBJ scaling factor (default: 15 serial, 2 parallel)")
    p.add_argument("--max-faces", type=int, default=None,
                   help="triangle cap (the serial app used 2000)")
    p.add_argument("--depth", type=int, default=3, help="max bounce depth")
    p.add_argument("--accel", choices=["bruteforce", "chunked", "sweep"], default="sweep",
                   help="'sweep' (CUDA kernels; exact), 'bruteforce' (exact) or 'chunked' "
                        "(approximate)")
    p.add_argument("--no-shadows", action="store_true")
    p.add_argument("--fixed-diffuse", action="store_true",
                   help="use the surface->light diffuse direction instead of the reference quirk")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; fails without a card) or cpu")
    p.add_argument("--out", default=None,
                   help="output PNG (default: 'RealTraceTPU <date>.png' in the working directory)")
    p.add_argument("--repeats", type=int, default=1, help="frames to render")
    p.add_argument("--f64", action="store_true", help="double precision")
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.copies != 1 and args.scene not in ("mesh", "serial"):
        parser.error(f"--copies {args.copies}: --scene {args.scene} has no duplicated form")

    from realtrace_tpu_torch.apps import scenes
    from realtrace_tpu_torch.core.types import RenderConfig
    from realtrace_tpu_torch.io.image import save_png, save_timestamped_png
    from realtrace_tpu_torch.ops import accel
    from realtrace_tpu_torch.render.pipeline import render_with_stats

    dtype = torch.float64 if args.f64 else torch.float32
    dev = torch.device(args.device)
    cfg = RenderConfig(max_depth=args.depth, accel=args.accel, shadows=not args.no_shadows,
                       legacy_diffuse=not args.fixed_diffuse)
    accel.warn_if_approximate(cfg)
    serial_kw = dict(texture_path=args.texture, dtype=dtype, device=dev,
                     scale=args.scale or 15.0, max_faces=args.max_faces)
    if args.scene == "sphere_plane":
        scene, cam = scenes.sphere_plane_scene(dtype=dtype, device=dev)
    elif args.scene == "primitives":
        scene, cam = scenes.full_primitive_scene(dtype=dtype, device=dev)
    elif args.scene == "parallel":
        scene, cam = scenes.parallel_obj_scene(args.obj, dtype=dtype, device=dev,
                                               scale=args.scale or 2.0, max_faces=args.max_faces)
    elif args.scene == "serial" and args.copies == 1:
        scene, cam = scenes.serial_obj_scene(args.obj, **serial_kw)
    elif args.scene == "serial":
        scene, cam = scenes.duplicated_serial_scene(args.copies, args.obj, **serial_kw)
    elif args.scene == "glass" and args.obj is not None:
        scene, cam = scenes.glass_bob_scene(args.obj, **serial_kw)
    elif args.scene == "glass":
        scene, cam = scenes.glass_mesh_scene(dtype=dtype, device=dev)
    else:
        scene, cam = scenes.duplicated_mesh_scene(args.copies, dtype=dtype, device=dev)
    if cfg.accel != "bruteforce" and scene.n_triangles:
        scene = accel.with_chunks(scene, cfg)
    camera = scenes.make_camera(cam, args.width, args.height, dtype=dtype, device=dev)
    print(f"[INFO] scene: {scene.n_triangles} tris, {scene.n_spheres} spheres, "
          f"{scene.n_planes} quads, {scene.n_cylinders} cylinders, {scene.n_lights} lights; "
          f"device {dev}", file=sys.stderr)

    for k in range(max(args.repeats, 1)):
        t0 = time.perf_counter()
        img, nrays = render_with_stats(scene, camera, cfg)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        print(f"[INFO] frame {k}: {dt * 1e3:.1f} ms, {nrays} rays, "
              f"{nrays / dt / 1e6:.2f} Mrays/s", file=sys.stderr)
    img = img.cpu().numpy()
    path = save_png(args.out, img) if args.out else save_timestamped_png(img)
    print(f"Image saved as: {path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
