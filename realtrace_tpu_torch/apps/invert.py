"""Inverse-rendering CLI: optimise scene parameters to match a target image,
the renderer's training entry point.

    python -m realtrace_tpu_torch.apps.invert --scene sphere_plane \\
        --fields sph_color --steps 100 --lr 0.05 --out-dir invert_out

Counterpart of ``realtrace_tpu/apps/invert.py`` with the same flags, except
that ``--device cpu`` replaces ``--cpu`` (the CUDA card is the default and
nothing falls back) and ``--scene mesh`` adds the procedural bob-sized mesh.
Without ``--target`` the target is the unperturbed scene's render and the
chosen fields are perturbed first: lights get their intensity scaled by
1 + perturb, materials their kd by 1 - perturb, other fields Gaussian noise
of scale perturb. The noise comes from a ``torch.Generator`` seeded with 0;
its draws differ from the JAX package's ``jax.random`` ones, so the two CLIs
start from different perturbed scenes.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

import torch


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--scene", choices=["sphere_plane", "primitives", "serial", "mesh"],
                   default="sphere_plane")
    p.add_argument("--obj", default=None)
    p.add_argument("--target", default=None,
                   help="target PNG; default: render the unperturbed scene")
    p.add_argument("--fields", nargs="+", default=["sph_color"],
                   help="scene fields to optimise (e.g. sph_color tri_vertices lights)")
    p.add_argument("--perturb", type=float, default=0.3,
                   help="synthetic-perturbation magnitude when no --target given")
    p.add_argument("--width", type=int, default=64)
    p.add_argument("--height", type=int, default=48)
    p.add_argument("--depth", type=int, default=2)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=3e-2)
    p.add_argument("--accel", choices=["bruteforce", "chunked", "sweep"], default="bruteforce",
                   help="'chunked' is approximate")
    p.add_argument("--ckpt-every", type=int, default=0,
                   help="save train state every N steps (0 = off)")
    p.add_argument("--out-dir", default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; fails without a card) or cpu")
    args = p.parse_args(argv)

    import numpy as np

    from realtrace_tpu_torch.apps import scenes
    from realtrace_tpu_torch.core.types import RenderConfig
    from realtrace_tpu_torch.diff import checkpoint as ckpt
    from realtrace_tpu_torch.diff.inverse import apply_params, make_train_step
    from realtrace_tpu_torch.io.image import load_png, save_png
    from realtrace_tpu_torch.ops import accel
    from realtrace_tpu_torch.render.pipeline import render_buffer, render_image

    dev = torch.device(args.device)
    cfg = RenderConfig(max_depth=args.depth, accel=args.accel)
    if args.scene == "primitives":
        scene, cam = scenes.full_primitive_scene(device=dev)
    elif args.scene == "serial":
        if args.obj is None:
            raise SystemExit("--scene serial needs --obj")
        scene, cam = scenes.serial_obj_scene(args.obj, device=dev)
    elif args.scene == "mesh":
        scene, cam = scenes.mesh_scene(device=dev)
    else:
        scene, cam = scenes.sphere_plane_scene(device=dev)
    if cfg.accel != "bruteforce" and scene.n_triangles:
        scene = accel.with_chunks(scene, cfg)
    camera = scenes.make_camera(cam, args.width, args.height, device=dev)

    if args.target:
        # PNG is top-down; the loss works in bottom-up buffer order
        target = torch.as_tensor(load_png(args.target)[::-1].copy(), dtype=torch.float32,
                                 device=dev).reshape(-1, 3)
    else:
        with torch.no_grad():
            target = render_buffer(scene, camera, cfg)
        gen = torch.Generator().manual_seed(0)
        upd = {}
        for f in args.fields:
            leaf = getattr(scene, f)
            if hasattr(leaf, "intensity"):   # Lights
                leaf = dataclasses.replace(leaf, intensity=leaf.intensity * (1.0 + args.perturb))
            elif hasattr(leaf, "kd"):        # Materials
                leaf = dataclasses.replace(leaf, kd=leaf.kd * (1.0 - args.perturb))
            else:
                noise = torch.randn(leaf.shape, generator=gen, dtype=leaf.dtype)
                leaf = leaf + args.perturb * noise.to(dev)
            upd[f] = leaf
        scene = dataclasses.replace(scene, **upd)

    step, params, optimizer = make_train_step(scene, camera, cfg, target, lr=args.lr,
                                              fields=tuple(args.fields))
    out_dir = Path(args.out_dir) if args.out_dir else None
    if out_dir:
        out_dir.mkdir(parents=True, exist_ok=True)
    loss0 = loss = None
    for i in range(args.steps):
        loss = float(step())
        if loss0 is None:
            loss0 = loss
        if i % max(args.steps // 10, 1) == 0:
            print(f"[invert] step {i:5d} loss {loss:.3e}", file=sys.stderr)
        if args.ckpt_every and out_dir and (i + 1) % args.ckpt_every == 0:
            ckpt.save_train_state(out_dir / "ckpt", i + 1, params, optimizer)
    if loss0 is not None:
        print(f"[invert] loss {loss0:.3e} -> {loss:.3e} ({loss / max(loss0, 1e-30):.2e}x)",
              file=sys.stderr)
    if out_dir:
        with torch.no_grad():
            final = render_image(apply_params(scene, params), camera, cfg)
        save_png(out_dir / "recovered.png", final.cpu().numpy())
        tgt = target.reshape(args.height, args.width, 3).flip(0).clamp(0.0, 1.0)
        save_png(out_dir / "target.png", np.asarray(tgt.cpu()))
        print(f"[invert] wrote {out_dir}/recovered.png", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
