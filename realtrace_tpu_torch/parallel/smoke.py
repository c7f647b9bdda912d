"""Two-rank smoke run of pixel-tile sharding over ``torch.distributed``.

Counterpart of ``scripts/distributed_smoke.py``. The launcher picks a free
TCP port, spawns two workers (fresh interpreters: gloo ranks, which may share
one card; NCCL refuses that), renders the frame and runs the train step
itself, and holds the workers' results to its own and to each other:

- the gathered sharded image against the single-process render (no pixel
  over ``--image-tol``; pixels that are not bit-equal are counted) and equal
  on every rank;
- the reduced loss and gradients of ``loss_and_grad`` bit-identical on every
  rank and within ``--grad-rtol`` of ``make_train_step``'s (at each field's
  largest magnitude);
- after ``--steps`` sharded Adam steps, parameters bit-identical on every
  rank and a loss that fell;
- with ``--flythrough N``, the sharded flythrough's frames against the
  single-process ones.

The scene is ``mesh_scene`` from ``--seed``, or an npz of
``core.convert.scene_to_npz`` (``--scene-npz``), in the serial app's framing;
the training target is a black image. The launcher prints a JSON summary line, then ``OK``; it exits
non-zero when a check, a worker or the time limit fails.

    python -m realtrace_tpu_torch.parallel.smoke          # the card, 1080p, depth 3
    python -m realtrace_tpu_torch.parallel.smoke --device cpu --width 64 --height 32 --depth 2
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

PACKAGE_PARENT = Path(__file__).resolve().parent.parent.parent
RANKS = 2     # a (1, 2) grid: make_mesh(2)
THREADS = 2   # torch threads a process: three processes share the host


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    p.add_argument("--seed", type=int, default=0, help="mesh_scene's seed")
    p.add_argument("--scene-npz", default=None,
                   help="a scene written by core.convert.scene_to_npz, in place of mesh_scene")
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--depth", type=int, default=3)
    p.add_argument("--accel", choices=["bruteforce", "chunked", "sweep"], default="sweep")
    p.add_argument("--f64", action="store_true")
    p.add_argument("--fields", default="tri_vertices,tri_colors,lights",
                   help="comma-separated DIFF_FIELDS the train step optimises")
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--flythrough", type=int, default=0, help="sharded flythrough frames")
    p.add_argument("--image-tol", type=float, default=1e-4)
    p.add_argument("--grad-rtol", type=float, default=1e-4)
    p.add_argument("--timeout", type=float, default=600.0, help="seconds for the workers")
    p.add_argument("--out", default=None, help="npz of the results (rank 0 and single)")
    p.add_argument("--worker", nargs=3, metavar=("RANK", "PORT", "DIR"), default=None,
                   help=argparse.SUPPRESS)
    return p


def _problem(args, device):
    """(scene, camera, cfg, target, fields), identical in every process."""
    from realtrace_tpu_torch.apps import scenes
    from realtrace_tpu_torch.core.convert import scene_from_npz
    from realtrace_tpu_torch.core.types import RenderConfig
    from realtrace_tpu_torch.ops import accel

    dtype = torch.float64 if args.f64 else torch.float32
    if args.scene_npz:
        scene, cam = scene_from_npz(args.scene_npz, dtype, device), dict(scenes.SERIAL_CAM)
    else:
        scene, cam = scenes.mesh_scene(args.seed, dtype=dtype, device=device)
    cfg = RenderConfig(max_depth=args.depth, accel=args.accel)
    if cfg.accel != "bruteforce" and scene.n_triangles:
        scene = accel.with_chunks(scene, cfg)
    camera = scenes.make_camera(cam, args.width, args.height, dtype=dtype, device=device)
    target = torch.zeros((args.height, args.width, 3), dtype=dtype, device=device)
    return scene, camera, cfg, target, tuple(args.fields.split(","))


def _orbit(args):
    from realtrace_tpu_torch.render.camera import InteractiveCamera

    return InteractiveCamera(radius=85.0, pitch=0.6, resolution=(args.width, args.height))


def _flat(prefix: str, tree) -> dict:
    """A parameter tree as flat npz keys ``prefix/field[/leaf]``."""
    from realtrace_tpu_torch.core.convert import params_to_numpy

    out = {}
    for k, v in params_to_numpy(tree).items():
        if isinstance(v, dict):
            out.update({f"{prefix}/{k}/{kk}": vv for kk, vv in v.items()})
        else:
            out[f"{prefix}/{k}"] = v
    return out


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def worker(args) -> None:
    import torch.distributed as dist

    from realtrace_tpu_torch.apps.flythrough import run_flythrough
    from realtrace_tpu_torch.core.types import tensor_leaves
    from realtrace_tpu_torch.ops import cuda_build, sweep
    from realtrace_tpu_torch.parallel import mesh as pmesh

    rank, port, out_dir = int(args.worker[0]), int(args.worker[1]), Path(args.worker[2])
    torch.set_num_threads(THREADS)
    t0 = time.perf_counter()
    dev = pmesh.init_distributed(f"127.0.0.1:{port}", RANKS, rank, backend="gloo",
                                 device=None if args.device == "cuda" else args.device)
    res = {"init_s": time.perf_counter() - t0}
    try:
        t0 = time.perf_counter()
        mesh = pmesh.make_mesh(RANKS)
        scene, camera, cfg, target, fields = _problem(args, dev)
        if dev.type == "cuda":
            cuda_build.load()
            res["rebuilt"] = bool(cuda_build.build_info["log"])
        scene = pmesh.replicate_scene(scene, mesh)
        res["setup_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        while not (out_dir / "reference.done").exists():   # the launcher's card work is over
            if time.perf_counter() - t0 > args.timeout:
                raise TimeoutError("the launcher's reference did not finish")
            time.sleep(0.01)
        res["wait_s"] = time.perf_counter() - t0
        pmesh.sharded_render(scene, camera, cfg, mesh)              # warm-up
        sweep.sweep.launches = sweep.sweep.stream_launches = 0
        _sync(dev)
        t0 = time.perf_counter()
        img = pmesh.sharded_render(scene, camera, cfg, mesh)
        _sync(dev)
        res.update(render_s=time.perf_counter() - t0, k1=sweep.sweep.launches,
                   k2=sweep.sweep.stream_launches, image=img.cpu().numpy())
        step, params, _ = pmesh.make_sharded_train_step(scene, camera, cfg, target, mesh,
                                                        fields=fields)
        loss, grads = step.loss_and_grad()
        res.update(loss0=float(loss), **_flat("grad", grads))
        losses, times = [], []
        for _ in range(args.steps):
            _sync(dev)
            t0 = time.perf_counter()
            losses.append(float(step()))
            times.append(time.perf_counter() - t0)
        res.update(losses=np.asarray(losses), step_s=np.asarray(times),
                   params=torch.cat([p.detach().reshape(-1) for p in tensor_leaves(params)])
                   .cpu().numpy())
        if args.flythrough:
            frames, _ = run_flythrough(scene, _orbit(args), cfg, frames=args.flythrough,
                                       mesh=mesh)
            res["flythrough"] = torch.stack(frames).cpu().numpy()
        np.savez(out_dir / f"rank{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(args, argv, out_dir: Path) -> list:
    """Start the workers (fresh interpreters) on a free port."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(PACKAGE_PARENT)] + [x for x in [os.environ.get("PYTHONPATH")] if x]))
    return [subprocess.Popen([sys.executable, "-m", "realtrace_tpu_torch.parallel.smoke",
                              *argv, "--worker", str(r), str(port), str(out_dir)], env=env)
            for r in range(RANKS)]


def _wait(procs, deadline: float) -> str | None:
    """Run the workers to their end (all of them killed on the first
    failure or at ``deadline``); an error message, or None."""
    try:
        while True:
            rcs = [p.poll() for p in procs]
            if any(rc not in (None, 0) for rc in rcs):
                return f"a worker failed: exit codes {rcs}"
            if all(rc == 0 for rc in rcs):
                return None
            if time.perf_counter() > deadline:
                return "the workers did not finish in time"
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()


def launcher(args, argv) -> int:
    from realtrace_tpu_torch.core.types import map_tensors
    from realtrace_tpu_torch.diff.inverse import make_train_step
    from realtrace_tpu_torch.render.pipeline import render_image

    torch.set_num_threads(THREADS)
    dev = torch.device(args.device)
    with tempfile.TemporaryDirectory() as tmp:
        # the workers start (import, join the group, build the scene) while
        # this process computes the reference; they wait for its end before
        # their own card work
        t_spawn = time.perf_counter()
        procs = _spawn(args, argv, Path(tmp))
        try:
            scene, camera, cfg, target, fields = _problem(args, dev)
            with torch.no_grad():
                render_image(scene, camera, cfg)                 # warm-up
                _sync(dev)
                t0 = time.perf_counter()
                single = render_image(scene, camera, cfg)
            _sync(dev)
            single_s = time.perf_counter() - t0
            step, params, _ = make_train_step(scene, camera, cfg, torch.flip(target, dims=(0,)),
                                              fields=fields)
            loss_single = float(step())             # the gradients stay in the leaves' grad
            grads_single = _flat("grad", map_tensors(lambda p: p.grad, params))
            fly_single = None
            if args.flythrough:
                from realtrace_tpu_torch.apps.flythrough import run_flythrough
                fly_single = torch.stack(run_flythrough(scene, _orbit(args), cfg,
                                                        frames=args.flythrough)[0]).cpu().numpy()
            single = single.cpu().numpy()
            reference_s = time.perf_counter() - t_spawn
        except BaseException:
            _wait(procs, 0.0)        # the workers go with the launcher
            raise
        (Path(tmp) / "reference.done").touch()
        err = _wait(procs, t_spawn + args.timeout)
        wall_s = time.perf_counter() - t_spawn
        if err:
            print(f"FAILED: {err}", flush=True)
            return 1
        ranks = [dict(np.load(Path(tmp) / f"rank{r}.npz")) for r in range(RANKS)]

    failures = []

    def check(ok, what):
        print(f"  [{'ok' if ok else 'FAIL'}] {what}", flush=True)
        if not ok:
            failures.append(what)

    r0 = ranks[0]
    over = int((np.abs(r0["image"] - single).max(-1) > args.image_tol).sum())
    unequal = int((r0["image"] != single).any(-1).sum())
    check(all(np.array_equal(r["image"], r0["image"]) for r in ranks),
          "every rank holds the same gathered image")
    check(over == 0, f"sharded image against the single render: {over} pixels over "
          f"{args.image_tol}, {unequal} not bit-equal")
    gkeys = [k for k in r0 if k.startswith("grad/")]
    check(all(r["loss0"] == r0["loss0"] and all(np.array_equal(r[k], r0[k]) for k in gkeys)
              for r in ranks), "reduced loss and gradients bit-identical on every rank")
    grad_err = {k: float(np.abs(r0[k] - grads_single[k]).max(initial=0.0)
                         / max(np.abs(grads_single[k]).max(initial=0.0), 1e-300))
                for k in gkeys}
    check(abs(float(r0["loss0"]) - loss_single) <= args.grad_rtol * abs(loss_single)
          and all(e <= args.grad_rtol for e in grad_err.values()),
          f"loss {float(r0['loss0']):.9e} against {loss_single:.9e}; gradients within "
          f"{args.grad_rtol} of make_train_step's (largest {max(grad_err.values()):.2e})")
    if args.steps:
        check(all(np.array_equal(r["params"], r0["params"]) for r in ranks),
              f"parameters bit-identical on every rank after {args.steps} steps")
        check(bool(r0["losses"][-1] < r0["losses"][0]) or args.steps == 1,
              f"the loss falls: {', '.join(f'{x:.6e}' for x in r0['losses'])}")
    if args.flythrough:
        fo = int((np.abs(r0["flythrough"] - fly_single).max(-1) > args.image_tol).sum())
        check(all(np.array_equal(r["flythrough"], r0["flythrough"]) for r in ranks) and fo == 0,
              f"sharded flythrough of {args.flythrough} frames against the single one: "
              f"{fo} pixels over {args.image_tol}")
    summary = dict(ranks=RANKS, backend="gloo", device=args.device,
                   size=[args.width, args.height], single_render_s=single_s,
                   reference_s=reference_s,
                   worker_init_s=[float(r["init_s"]) for r in ranks],
                   worker_setup_s=[float(r["setup_s"]) for r in ranks],
                   worker_wait_s=[float(r["wait_s"]) for r in ranks],
                   sharded_render_s=[float(r["render_s"]) for r in ranks],
                   step_s=[r["step_s"].tolist() for r in ranks],
                   k1=[int(r["k1"]) for r in ranks], k2=[int(r["k2"]) for r in ranks],
                   rebuilt=[bool(r.get("rebuilt", False)) for r in ranks],
                   pixels_over=over, pixels_unequal=unequal, grad_rel_err=grad_err,
                   losses=r0["losses"].tolist(), wall_s=wall_s)
    if args.out:
        extra = {} if fly_single is None else {"fly_single": fly_single}
        np.savez(args.out, single=single, loss_single=loss_single, summary=json.dumps(summary),
                 **extra,
                 **{f"single_{k}": v for k, v in grads_single.items()},
                 **{f"rank{i}_{k}": v for i, r in enumerate(ranks) for k, v in r.items()})
    print(json.dumps(summary), flush=True)
    if failures:
        print(f"FAILED: {failures}", flush=True)
        return 1
    print("OK", flush=True)
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    if args.worker:
        worker(args)
        return 0
    return launcher(args, argv)


if __name__ == "__main__":
    raise SystemExit(main())
