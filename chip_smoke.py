#!/usr/bin/env python3
"""Smoke run of the PyTorch port (realtrace_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one or more lines each; every check that fails is listed at the end
and the script exits 1 without printing a result:

1. environment: torch / CUDA versions and the card's name and power limit;
2. build: the CUDA kernels from realtrace_tpu_torch/csrc, with build seconds;
3. kernel against twin on the card, closest and any mode: the sweep kernel
   and sweep_reference on the same inputs for a 137-triangle random scene
   (500 rays), the 10,752-triangle mesh_scene's 1920x1080 primary wavefront,
   and its compacted secondary wavefronts (reflection and shadow rays, exact
   chunk mask). Hit/miss and triangle must agree on all but 1e-5 of the
   rays; where both hit the same triangle, t agrees to rtol 1e-5;
4. the main path: render_with_stats on mesh_scene at 1920x1080, depth 3,
   shadows, accel="sweep", with the kernel's launch count read around it;
   the same render through the twin (image error > 1e-4 on at most 0.2% of
   pixels); and the golden128 scene rendered in f32 against
   tests/oracle/golden128.npz (error > 1e-4 on at most 0.5% of pixels);
5. timing with CUDA events after one warm-up frame: the serial framing and
   the close framing, and the kernel beside the twin on the 1080p primary
   query. Information, not a benchmark.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits 2 without a CUDA card.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "oracle" / "golden128.npz"
MISMATCH_FRAC = 1e-5               # kernel vs twin: rays whose hit/miss or triangle differ
T_RTOL = 1e-5                      # kernel vs twin: t where both hit the same triangle
IMAGE_TOL, IMAGE_FRAC = 1e-4, 0.002
GOLDEN_TOL, GOLDEN_FRAC = 1e-4, 0.005
W, H, DEPTH = 1920, 1080, 3
CLOSE_POSITION = (0.0, 6.0, 14.0)  # the close (hit-heavy) framing

failures: list[str] = []


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    log(f"  [{'ok' if ok else 'FAIL'}] {what}")
    if not ok:
        failures.append(what)


def scene128(dtype, device):
    """tests/oracle/scene128.py's golden scene, built with the port's
    SceneBuilder (that module builds it with the JAX package)."""
    import numpy as np

    from realtrace_tpu_torch.core.types import SceneBuilder

    b = SceneBuilder(dtype=dtype, device=device)
    m_refl = b.material(kr=0.6)
    b.add_plane((-20, -2, -20), (20, -2, -20), (20, -2, 20), (-20, -2, 20),
                color=(0.4, 0.4, 0.45), material=m_refl)
    b.add_sphere((0, 0.5, 0), 1.5, color=(0.8, 0.2, 0.1), material=m_refl)
    b.add_sphere((3, 0, 2), 1.0, color=(0.1, 0.6, 0.2), material=b.material())
    b.add_cylinder((-3.0, 0.0, 1.0), (0.0, 1.0, 0.0), 0.6,
                   color=(0.7, 0.6, 0.1), material=b.material(ks=0.6))
    rng = np.random.default_rng(128)
    for ctr in rng.uniform(-6, 6, (48, 3)):
        tri = ctr + np.array([0, 2.5, 0]) + rng.uniform(-1, 1, (3, 3))
        b.add_triangle(tri[0], tri[1], tri[2], material=m_refl,
                       color=tuple(rng.uniform(0.2, 0.9, 3)))
    b.add_light((0, 30, 30), (1, 1, 1))
    b.add_light((-20, 15, -5), (0.3, 0.3, 0.5))
    b.ambient = (1, 1, 1)
    b.background = (0.1, 0.3, 0.6)
    return b.build()


@contextlib.contextmanager
def twin_sweep():
    """Route every sweep of the port through the plain PyTorch twin."""
    from realtrace_tpu_torch.ops import sweep

    kernel = sweep.sweep
    sweep.sweep = sweep.sweep_reference
    try:
        yield
    finally:
        sweep.sweep = kernel


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_vs_twin(name, ro, rd, pack, cfg, exact_mask, errs):
    """Compare the kernel with the twin on one query's inputs, both modes."""
    import torch

    from realtrace_tpu_torch.ops import sweep

    n = ro.shape[0]
    ro32, rd32, chunk_list, entry, counts = sweep.sweep_inputs(ro, rd, pack, cfg, exact_mask)
    allowed = int(MISMATCH_FRAC * n)
    for any_mode in (False, True):
        args = (ro32, rd32, pack.consts, pack.meta, chunk_list, counts, entry,
                float(cfg.det_epsilon), float(cfg.smallest_dist), any_mode)
        kt, ki = sweep.sweep(*args)
        rt, ri = sweep.sweep_reference(*args)
        torch.cuda.synchronize()
        kt, ki, rt, ri = kt[:n], ki[:n], rt[:n], ri[:n]
        hit_mis = int(((ki >= 0) != (ri >= 0)).sum())
        mode = "any" if any_mode else "closest"
        if any_mode:
            log(f"  {name} [{mode}]: {n} rays, {int((ri >= 0).sum())} occluded, "
                f"{hit_mis} hit/miss mismatches (allowed {allowed})")
            check(hit_mis <= allowed, f"{name} any-mode agreement")
            continue
        idx_mis = int(((ki != ri) & (ki >= 0) & (ri >= 0)).sum())
        same = (ki == ri) & (ki >= 0)
        dt = (kt - rt).abs()[same]
        max_err = float(dt.max()) if dt.numel() else 0.0
        t_bad = int((dt > T_RTOL * rt.abs()[same]).sum())
        errs.append(max_err)
        log(f"  {name} [{mode}]: {n} rays, {int((ri >= 0).sum())} hits, {hit_mis} hit/miss "
            f"and {idx_mis} triangle mismatches (allowed {allowed}), {t_bad} t beyond rtol "
            f"{T_RTOL}, max |dt| {max_err:.3e}, mean chunks/tile "
            f"{float(counts.float().mean()):.1f}")
        check(hit_mis + idx_mis <= allowed and t_bad <= allowed,
              f"{name} closest-mode agreement")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from realtrace_tpu_torch.apps import scenes
    from realtrace_tpu_torch.core.types import RenderConfig, SceneBuilder
    from realtrace_tpu_torch.ops import accel, cuda_build, sweep
    from realtrace_tpu_torch.ops.intersect import FAM_NONE, closest_query, hit_attributes
    from realtrace_tpu_torch.render import shade
    from realtrace_tpu_torch.render.pipeline import _tiled_rays, render_with_stats

    sys.path.insert(0, str(ROOT / "tests"))
    from oracle.scene128 import CAM as CAM128, DEPTH as DEPTH128, SIZE as SIZE128

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    log("== 1 environment")
    log(f"  python {sys.version.split()[0]}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, device {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} visible")
    log(smi[0] if smi else "nvidia-smi: no output")

    log("== 2 build")
    cuda_build.load()
    log(f"  built {cuda_build.build_info['library']} in {cuda_build.build_info['seconds']:.2f} s")
    for line in cuda_build.build_info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")

    log("== 3 kernel against twin")
    errs: list[float] = []
    rng = np.random.default_rng(3)
    b = SceneBuilder(dtype=torch.float32, device=dev)
    for ctr in rng.uniform(-10, 10, (137, 3)):
        tri = ctr + rng.uniform(-3.0, 3.0, (3, 3))
        b.add_triangle(tri[0], tri[1], tri[2])
    b.add_light((0, 30, 30), (1, 1, 1))
    cfg = RenderConfig(max_depth=DEPTH, accel="sweep")
    small = accel.with_chunks(b.build(), cfg)
    rng = np.random.default_rng(11)
    ro = torch.as_tensor(rng.uniform(-15, 15, (500, 3)), dtype=torch.float32, device=dev)
    rd = torch.nn.functional.normalize(
        torch.as_tensor(rng.standard_normal((500, 3)), dtype=torch.float32, device=dev), dim=1)
    kernel_vs_twin("random-137", ro, rd, sweep.build_pack(small, cfg), cfg, None, errs)

    mesh, cam = scenes.mesh_scene(device=dev)
    mesh = accel.with_chunks(mesh, cfg)
    pack = sweep.build_pack(mesh, cfg)
    log(f"  mesh_scene: {mesh.n_triangles} triangles, {pack.n_chunks} chunks of "
        f"{pack.chunk_size}")
    camera = scenes.make_camera(cam, W, H, device=dev)
    ro, rd, _ = _tiled_rays(camera)
    kernel_vs_twin("mesh 1080p primary", ro, rd, pack, cfg, None, errs)
    # the compacted level-1 wavefronts of that frame: hit tiles only
    t, fam, idx = closest_query(mesh, ro, rd, cfg, pack=pack)
    tiles = torch.nonzero((fam != FAM_NONE).reshape(-1, 1024).any(dim=1))[:, 0]

    def g(x):
        return x.reshape(-1, 1024, *x.shape[1:])[tiles].reshape(-1, *x.shape[1:])

    ro_c, rd_c = g(ro), g(rd)
    hit = hit_attributes(mesh, ro_c, rd_c, g(t), g(fam), g(idx), cfg, pack=pack)
    valid, (ro_r, rd_r, _) = shade._children_geom(mesh, hit, ro_c, rd_c,
                                                  torch.ones_like(ro_c), cfg)
    kernel_vs_twin("mesh reflection (exact mask)", ro_r, rd_r, pack, cfg, True, errs)
    (ro_s, rd_s), = shade._shadow_targets(mesh, hit.position, valid, cfg)
    kernel_vs_twin("mesh shadow (exact mask)", ro_s, rd_s, pack, cfg, True, errs)

    log("== 4 main path")
    sweep.sweep.launches = 0
    t0 = time.perf_counter()
    img, nrays = render_with_stats(mesh, camera, cfg)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = sweep.sweep.launches
    log(f"  mesh_scene {W}x{H} depth {DEPTH}: {nrays} rays, sweep.launches {launches}, "
        f"first frame {first_s:.3f} s")
    check(launches > 0, "the main path launched the sweep kernel")
    check(tuple(img.shape) == (H, W, 3) and bool(torch.isfinite(img).all()),
          f"image is finite, ({H}, {W}, 3)")
    bg = torch.tensor([0.1, 0.3, 0.6], device=dev)
    covered = float((img - bg).abs().amax(-1).gt(1e-3).float().mean())
    check(0.05 < covered < 0.95, f"the mesh covers {covered:.3f} of the frame")
    with twin_sweep():
        img_ref, nrays_ref = render_with_stats(mesh, camera, cfg)
    err = (img - img_ref).abs().amax(-1)
    frac = float((err > IMAGE_TOL).float().mean())
    log(f"  kernel vs twin image: {int((err > IMAGE_TOL).sum())} pixels > {IMAGE_TOL} "
        f"({frac:.2e}), max {float(err.max()):.3e}; rays {nrays} vs {nrays_ref}")
    check(frac <= IMAGE_FRAC, f"kernel render matches twin render (<= {IMAGE_FRAC})")

    want = np.load(GOLDEN)["image"]
    cfg128 = RenderConfig(max_depth=DEPTH128, accel="sweep", chunk_size=32)
    s128 = accel.with_chunks(scene128(torch.float32, dev), cfg128)
    img128, _ = render_with_stats(s128, scenes.make_camera(CAM128, SIZE128, SIZE128, device=dev),
                                  cfg128)
    err = np.abs(img128.double().cpu().numpy() - want).max(axis=-1)
    frac = float((err > GOLDEN_TOL).mean())
    log(f"  golden128 (f32, sweep): {int((err > GOLDEN_TOL).sum())} pixels > {GOLDEN_TOL} "
        f"({frac:.2e}), max {err.max():.3e}")
    check(frac <= GOLDEN_FRAC, f"golden128 within {GOLDEN_FRAC} of pixels")

    log("== 5 timing (CUDA events; information, not a benchmark)")
    for name, position in (("serial", cam["position"]), ("close", CLOSE_POSITION)):
        cam_f = scenes.make_camera(dict(cam, position=position), W, H, device=dev)
        out = {}
        ms = cuda_ms(lambda: out.update(r=render_with_stats(mesh, cam_f, cfg)), reps=3)
        n = out["r"][1]
        log(f"  {name} framing {position}: {ms:.2f} ms/frame, {n} rays/frame, "
            f"{n / ms / 1e3:.2f} Mrays/s")
    ro32, rd32, chunk_list, entry, counts = sweep.sweep_inputs(ro, rd, pack, cfg)
    args = (ro32, rd32, pack.consts, pack.meta, chunk_list, counts, entry,
            float(cfg.det_epsilon), float(cfg.smallest_dist), False)
    k_ms = cuda_ms(lambda: sweep.sweep(*args), reps=10)
    p_ms = cuda_ms(lambda: sweep.sweep_reference(*args), reps=3)
    log(f"  1080p primary closest query: kernel {k_ms:.3f} ms, twin {p_ms:.3f} ms")

    if failures:
        log(f"FAILED: {failures}")
        return 1
    log(json.dumps({"kernels": [{
        "name": "sweep", "route": "cuda", "source": "realtrace_tpu_torch/csrc/sweep.cu",
        "replaces": "realtrace_tpu/ops/pallas/trace.py:164", "launches": launches,
        "max_abs_err": max(errs), "ms": k_ms, "plain_ms": p_ms}]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
