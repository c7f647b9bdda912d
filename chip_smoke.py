#!/usr/bin/env python3
"""Smoke run of the PyTorch port (realtrace_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one or more lines each; every check that fails is listed at the end
and the script exits 1 without printing a result:

1. environment: torch / CUDA versions and the card's name and power limit;
2. build: the CUDA kernels from realtrace_tpu_torch/csrc, with build seconds;
3. kernels against their twin on the card, closest and any mode, on the same
   inputs: the resident kernel (sweep) for a 137-triangle random scene (500
   rays), the 10,752-triangle mesh_scene's 1920x1080 primary wavefront and
   its compacted secondary wavefronts (reflection and shadow rays, exact
   chunk mask); the streaming kernel (sweep_stream) forced on the random
   scene, and on the 86,016-triangle duplicated_mesh_scene(8)'s 1080p primary
   (exact mask behind the super-chunk gate), reflection and shadow
   wavefronts, each also against the resident kernel, bit for bit. Hit/miss
   and triangle must agree with the twin on all but 1e-5 of the rays; where
   both hit the same triangle, t agrees to rtol 1e-5. Kernels and twin run
   with the warps' chunk gate; each comparison also holds the kernel's
   ``tested`` counts to the twin's, the kernel with the gate off to the
   kernel with it on, and the kernel on the other list (interval for exact,
   exact for interval) to the kernel on this one, all bit for bit;
4. the main paths, each with both launch counts set to 0 just before and read
   just after: render_with_stats at 1920x1080, depth 3, shadows,
   accel="sweep" on mesh_scene (resident kernel), on duplicated_mesh_scene(8)
   (streaming kernel, big-scene masks) and on glass_mesh_scene (the branching
   wavefront, rendered twice: bit-equal); the JAX bench's OBJ workloads on
   mesh_scene's mesh written as an OBJ: duplicated_serial_scene(8) (its
   vertices equal duplicated_mesh_scene(8)'s; streaming kernel only) and
   glass_bob_scene (resident kernel only; rendered twice: bit-equal);
   mesh_scene at depth 10 (resident kernel only, more rays than depth 3); each
   against the same render through the twin (image error > 1e-4 on at most
   0.2% of pixels; the twin renders from the exact lists, the kernels from
   the card's list policy); the first three frames under the other list
   policy (0 pixels over 1e-4, equal ray counts); the golden128 scene in f32
   against tests/oracle/golden128.npz (error > 1e-4 on at most 0.5% of
   pixels); full_primitive_scene (a dielectric cylinder) against the NumPy
   oracle in f64 (error > 1e-6 on at most 0.2%) and in f32 (error > 1e-4 on
   at most 2%);
5. timing with CUDA events after one warm-up frame, of the frames the bench
   (phase 8) does not time: x4, x8 and x16 at depth 3 and the two OBJ frames
   of phase 4; each kernel beside the
   twin on its 1080p primary query, with the least time the card could take
   for the (ray, triangle) pairs its warps tested; the chunk-mask kernel
   beside its twin on that query's lists (bit-equal), with the least time
   of its bytes, and its launches on a depth-10 frame (one a sweep launch);
   the level kernels (hit attributes, shading) beside the PyTorch code they
   replace on the close framing's level 0 and on the widest level of the
   mesh made glass, bit-equal, with the least time of their bytes, and their
   launches on the depth-10 frame (one of each a level); the ray generation
   kernel beside its PyTorch twin on the 1080p frame, bit-equal, with the
   least time of its writes, and its launch a frame;
   the sweep kernels on the reflection
   and shadow wavefronts; each of these queries runs under the card's list
   policy, as the main path gives it to the kernel, and holds the kernel's
   results and ``tested`` to the twin's bit for bit, so the bound rests on
   a verified count; the two kernels side by side on the
   x2 and x8 scenes' primary queries. Information, not a benchmark;
6. backward and train step, with both launch counts set to 0 just before the
   training path and read just after: ``image_grad`` of mesh_scene at
   1920x1080, depth 3 (vertices, vertex colours, lights) launches exactly
   the forward render's sweeps (the backward none); the same gradients
   through the twin, a second backward and the backward without remat, each
   equal to the first bit for bit, with the peak memory of both backward
   designs; central finite differences in f64 through the kernel on
   mesh_scene at 128x96 (one vertex coordinate, one vertex colour, one light
   intensity, rtol 5e-3, visibility checked unchanged); five Adam steps at
   1080p with the chunk re-sort every step (vertices, colours, materials,
   lights; perturbed colours): the loss falls, every parameter stays finite;
   the peak memory of both backward designs at the close framing too (the
   bench, phase 8, times the backward and the train step);
7. progressive, sharded and apps, each path with both launch counts set to 0
   just before and read just after: ProgressiveRenderer on mesh_scene and on
   duplicated_mesh_scene(8) at 1920x1080, depth 3, band 120 (9 bands), each
   against render_with_stats (0 pixels over 1e-4; pixels not bit-equal are
   counted), each band launching the frame's kernel at most as often as the
   frame, a run saved after band 4 and resumed in a fresh renderer equal to
   the uninterrupted one bit for bit; the two-rank smoke
   (``python -m realtrace_tpu_torch.parallel.smoke``: gloo on the card, a
   (1, 2) grid, mesh_scene at 1080p: the gathered image against the single
   render, gradients bit-identical on both ranks and within 1e-4 of
   make_train_step's, 3 Adam steps, K1 on each rank, no rebuild of the
   kernels); a world-size-1 NCCL group (sharded_render, one all_reduce);
   run_flythrough (mesh_scene, 512x512, 24 frames; its frame_bracket labels
   in one trace_capture); the viewer's batched script against its per-frame
   script (256x128, equal last frame); flashlight and stability on the card
   against the CPU; mesh_scene's triangles through an OBJ file, native parser
   against Python parser, and parallel_obj_scene rendered at 1080p;
8. the bench: ``python -m realtrace_tpu_torch.apps.bench`` at 1920x1080 with
   3 samples a series, every leg (headline, hit-heavy, grad at both framings,
   train, branching, stream, bigscene, the big-scene curve, depth 10): it
   exits 0, each metric is printed once, the headline last, every value is
   finite and positive and every line carries its statistics and the card;
   its lines are echoed;
9. the JAX package's other query modes and the chunked accel, each path with
   both launch counts set to 0 just before and read just after: mesh_scene
   at 1920x1080, depth 3, in the default mode, the fully merged mode
   (``shadow_any_mode=False``: 5 K1 a frame, one closest query a level) and
   the unmerged mode (``merge_queries=False``: 8 K1, one shadow query per
   light), each against its twin render (as phase 4) and against the
   default mode's image (error > 1e-4 on at most 0.2% of pixels, pixels not
   bit-equal counted, equal rays); duplicated_mesh_scene(8) in the fully
   merged mode (K2 only, 5 a frame) against its twin and the default image;
   the three mesh modes and the x8 default and fully merged frames timed in
   turns, 10 host-timed synchronised frames each (median, quartiles), and
   one profiled frame each (busy ms, idle share, the sweep kernels' ms); the chunked
   accel (the JAX bench's headline config: ray blocks of 8192, shortlist 96)
   on mesh_scene's 256x192 primary, reflection and shadow rays, its indices
   on the card equal to those on the CPU and its distances bit-equal, and
   the 1080p chunked frame (no sweep launched) with its host-timed median of
   5 frames and its share of pixels over 1e-4 off the sweep's image.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits 2 without a CUDA card.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "oracle" / "golden128.npz"
MISMATCH_FRAC = 1e-5               # kernel vs twin: rays whose hit/miss or triangle differ
T_RTOL = 1e-5                      # kernel vs twin: t where both hit the same triangle
IMAGE_TOL, IMAGE_FRAC = 1e-4, 0.002
GOLDEN_TOL, GOLDEN_FRAC = 1e-4, 0.005
GLASS_F32_FRAC = 0.02              # full_primitive_scene in f32 (see phase 4)
W, H, DEPTH = 1920, 1080, 3
CLOSE_POSITION = (0.0, 6.0, 14.0)  # the close (hit-heavy) framing
# the glass-orbit configuration's material (rtbench/configs/glass_bob_1080p.json)
GLASS_MODEL = dict(ka=0.4, kd=0.9, ks=0.4, kr=0.1, kt=0.8, eta=2.0)
# H100 SXM data-sheet peaks: 67 TFLOP/s FP32 counts a fused multiply-add as two
# operations, so unfused multiplies and adds run at half that; 3.35 TB/s HBM3
FP32_INSTR_PER_S = 67e12 / 2
HBM_BYTES_PER_S = 3.35e12
PAIR_INSTRUCTIONS = 38             # per (ray, triangle) pair, closest mode (query_times)
PAIR_INSTRUCTIONS_ANY = 39         # any mode: the forms, then 6 multiplies and 1 add

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


def write_mesh_obj(path: Path):
    """mesh_arrays() at full detail (10,752 triangles, unscaled) as an OBJ of
    ``v`` and ``f`` lines, floats at 17 significant digits. Returns the
    triangles written."""
    from realtrace_tpu_torch.apps import scenes

    tv, _ = scenes.mesh_arrays()
    path.write_text("".join(f"v {x:.17g} {y:.17g} {z:.17g}\n" for x, y, z in tv.reshape(-1, 3))
                    + "".join(f"f {3 * k + 1} {3 * k + 2} {3 * k + 3}\n"
                              for k in range(len(tv))))
    return tv


@contextlib.contextmanager
def twin_sweep():
    """Route every sweep of the port through the plain PyTorch twin, on the
    CPU's list policy (the twin walks every listed position for all tiles of
    a block, so it wants the short exact lists; results do not depend on the
    list)."""
    from realtrace_tpu_torch.ops import sweep

    kernel = sweep.sweep
    sweep.sweep = lambda *a, stream=False, **k: sweep.sweep_reference(*a, **k)
    try:
        with list_policy(False):
            yield
    finally:
        sweep.sweep = kernel


@contextlib.contextmanager
def list_policy(interval_on_cuda: bool):
    """Run the block under one of the two list policies for CUDA tensors."""
    from realtrace_tpu_torch.ops import sweep

    saved = sweep.INTERVAL_LISTS_ON_CUDA
    sweep.INTERVAL_LISTS_ON_CUDA = interval_on_cuda
    try:
        yield
    finally:
        sweep.INTERVAL_LISTS_ON_CUDA = saved


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


def kernel_vs_twin(name, ro, rd, pack, cfg, exact_mask, errs, stream=False):
    """Compare a kernel with the twin on one query's inputs, both modes, with
    the chunk gate: results and ``tested``; the kernel with the gate off and
    the kernel on the other list against itself; the streaming kernel also
    with the resident kernel; all bit for bit."""
    import torch

    from realtrace_tpu_torch.ops import sweep

    n = ro.shape[0]
    ro32, rd32, chunk_list, entry, counts = sweep.sweep_inputs(ro, rd, pack, cfg, exact_mask)
    _, _, *other = sweep.sweep_inputs(ro, rd, pack, cfg, not exact_mask)
    allowed = int(MISMATCH_FRAC * n)
    kind = "stream" if stream else "resident"
    boxes = dict(lo=pack.lo, hi=pack.hi)
    for any_mode in (False, True):
        tail = (float(cfg.det_epsilon), float(cfg.smallest_dist), any_mode)
        args = (ro32, rd32, pack.consts, pack.meta, chunk_list, counts, entry, *tail)
        k_n, r_n = (torch.zeros((counts.shape[0], sweep.WARPS), dtype=torch.int32,
                                device=ro.device) for _ in range(2))
        kt, ki = sweep.sweep(*args, stream=stream, tested=k_n, **boxes)
        rt, ri = sweep.sweep_reference(*args, tested=r_n, **boxes)
        torch.cuda.synchronize()
        mode = "any" if any_mode else "closest"
        check(torch.equal(k_n, r_n), f"{name} [{kind}, {mode}]: tested equals the twin's")
        gt, gi = sweep.sweep(*args, stream=stream)
        check(torch.equal(gi, ki) and torch.equal(gt, kt),
              f"{name} [{kind}, {mode}]: gate off equals gate on bit for bit")
        ot, oi = sweep.sweep(ro32, rd32, pack.consts, pack.meta, other[0], other[2], other[1],
                             *tail, stream=stream, **boxes)
        live = ro32[:, 0] != sweep.PARK_DISTANCE
        check(torch.equal(oi[live] >= 0, ki[live] >= 0) and (
            any_mode or (torch.equal(oi[live], ki[live]) and torch.equal(ot[live], kt[live]))),
              f"{name} [{kind}, {mode}]: interval list and exact list give equal results")
        if stream:
            k1t, k1i = sweep.sweep(*args, **boxes)
            check(torch.equal(ki, k1i) and torch.equal(kt, k1t),
                  f"{name} [{mode}]: streaming kernel equals resident kernel bit for bit")
        kt, ki, rt, ri = kt[:n], ki[:n], rt[:n], ri[:n]
        hit_mis = int(((ki >= 0) != (ri >= 0)).sum())
        work = (f"mean positions listed per tile {float(counts.float().mean()):.1f} "
                f"(other list {float(other[2].float().mean()):.1f}), tested per warp "
                f"{float(r_n.float().mean()):.2f}")
        if any_mode:
            log(f"  {name} [{kind}, {mode}]: {n} rays, {int((ri >= 0).sum())} occluded, "
                f"{hit_mis} hit/miss mismatches (allowed {allowed}), {work}")
            check(hit_mis <= allowed, f"{name} [{kind}] any-mode agreement")
            continue
        idx_mis = int(((ki != ri) & (ki >= 0) & (ri >= 0)).sum())
        same = (ki == ri) & (ki >= 0)
        dt = (kt - rt).abs()[same]
        max_err = float(dt.max()) if dt.numel() else 0.0
        t_bad = int((dt > T_RTOL * rt.abs()[same]).sum())
        errs.append(max_err)
        log(f"  {name} [{kind}, {mode}]: {n} rays, {int((ri >= 0).sum())} hits, {hit_mis} "
            f"hit/miss and {idx_mis} triangle mismatches (allowed {allowed}), {t_bad} t beyond "
            f"rtol {T_RTOL}, max |dt| {max_err:.3e}, {work}")
        check(hit_mis + idx_mis <= allowed and t_bad <= allowed,
              f"{name} [{kind}] closest-mode agreement")


def secondary_rays(scene, pack, cfg, ro, rd):
    """The compacted level-1 wavefronts of a frame (hit tiles only):
    reflection rays and the one light's shadow rays."""
    import torch

    from realtrace_tpu_torch.ops.intersect import FAM_NONE, closest_query, hit_attributes
    from realtrace_tpu_torch.render import shade

    t, fam, idx = closest_query(scene, ro, rd, cfg, pack=pack)
    tiles = torch.nonzero((fam != FAM_NONE).reshape(-1, 1024).any(dim=1))[:, 0]

    def g(x):
        return x.reshape(-1, 1024, *x.shape[1:])[tiles].reshape(-1, *x.shape[1:])

    ro_c, rd_c = g(ro), g(rd)
    hit = hit_attributes(scene, ro_c, rd_c, g(t), g(fam), g(idx), cfg, pack=pack)
    valid, _, (ro_r, rd_r, _), _ = shade._children_geom(scene, hit, ro_c, rd_c,
                                                        torch.ones_like(ro_c), cfg,
                                                        branching=False)
    (ro_s, rd_s), = shade._shadow_targets(scene, hit.position, valid, cfg)
    return (ro_r, rd_r), (ro_s, rd_s)


def main_path(name, scene, camera, cfg):
    """Drive one main path with both launch counts zeroed just before and
    read just after; check the image; hold it against the twin's render.
    Returns (image, rays, resident launches, streaming launches)."""
    import torch

    from realtrace_tpu_torch.ops import sweep
    from realtrace_tpu_torch.render.pipeline import render_with_stats

    sweep.sweep.launches = sweep.sweep.stream_launches = sweep.mask_kernel.launches = 0
    t0 = time.perf_counter()
    img, nrays = render_with_stats(scene, camera, cfg)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    k1, k2 = sweep.sweep.launches, sweep.sweep.stream_launches
    masks = sweep.mask_kernel.launches
    log(f"  {name} {camera.width}x{camera.height} depth {cfg.max_depth}: {nrays} rays, "
        f"sweep.launches {k1}, sweep.stream_launches {k2}, mask_kernel.launches {masks}, "
        f"first frame {first_s:.3f} s")
    check(masks == k1 + k2, f"{name}: every query's lists come from one mask launch")
    check(tuple(img.shape) == (camera.height, camera.width, 3)
          and bool(torch.isfinite(img).all()),
          f"{name}: image is finite, ({camera.height}, {camera.width}, 3)")
    bg = scene.background.to(img.dtype)
    covered = float((img - bg).abs().amax(-1).gt(1e-3).float().mean())
    check(0.05 < covered < 0.95, f"{name}: the scene covers {covered:.3f} of the frame")
    t0 = time.perf_counter()
    with twin_sweep():
        img_ref, nrays_ref = render_with_stats(scene, camera, cfg)
    torch.cuda.synchronize()
    err = (img - img_ref).abs().amax(-1)
    frac = float((err > IMAGE_TOL).float().mean())
    log(f"  {name} kernel vs twin image: {int((err > IMAGE_TOL).sum())} pixels > {IMAGE_TOL} "
        f"({frac:.2e}), max {float(err.max()):.3e}; twin frame {time.perf_counter() - t0:.1f} s, "
        f"rays {nrays} vs {nrays_ref}")
    check(frac <= IMAGE_FRAC and nrays == nrays_ref,
          f"{name}: kernel render matches twin render (<= {IMAGE_FRAC})")
    return img, nrays, k1, k2


def query_times(name, ro, rd, pack, cfg, stream, twin_reps, any_mode=False):
    """One kernel on one 1080p query under the card's list policy, the main
    path's own inputs: its time, the twin's (``twin_reps`` 0: run once, not
    timed), and the least time the card could take. The kernel's results and
    ``tested`` counts are held to the twin's on these inputs, bit for bit,
    so the bound rests on a verified count. The bound counts the
    (ray, triangle) pairs the function requires at warp granularity: the
    list positions each warp tested times its 128 rays times the chunk size, each
    pair as PAIR_INSTRUCTIONS unfused FP32 instructions (18 multiplies, 15
    adds and subtractions for the four forms, 3 multiplies, 1 add and 1
    division for the divided tests; compares and selects not counted; any
    mode PAIR_INSTRUCTIONS_ANY) at FP32_INSTR_PER_S, against each input byte
    read once (rays, the whole constant table, boxes, lists, entries, counts)
    and each output byte written once at HBM_BYTES_PER_S. Beside it the pair
    count at tile granularity, as the kernels worked before the gate: the
    positions a tile walks until its last warp leaves, for all 1024 lanes."""
    import torch

    from realtrace_tpu_torch.ops import sweep

    ro32, rd32, chunk_list, entry, counts = sweep.sweep_inputs(ro, rd, pack, cfg)
    args = (ro32, rd32, pack.consts, pack.meta, chunk_list, counts, entry,
            float(cfg.det_epsilon), float(cfg.smallest_dist), any_mode)
    boxes = dict(lo=pack.lo, hi=pack.hi)
    tested, ungated, twin_tested = (torch.zeros((counts.shape[0], sweep.WARPS),
                                                dtype=torch.int32, device=ro.device)
                                    for _ in range(3))
    kt, ki = sweep.sweep(*args, tested=tested, stream=stream, **boxes)
    sweep.sweep(*args, tested=ungated, stream=stream)
    k_ms = cuda_ms(lambda: sweep.sweep(*args, stream=stream, **boxes), reps=10)
    off_ms = cuda_ms(lambda: sweep.sweep(*args, stream=stream), reps=10)
    twin_out = []

    def twin():
        twin_out[:] = sweep.sweep_reference(*args, tested=twin_tested, **boxes)

    p_ms = cuda_ms(twin, reps=twin_reps) if twin_reps else twin()
    check(torch.equal(ki, twin_out[1]) and torch.equal(kt, twin_out[0])
          and torch.equal(tested, twin_tested),
          f"{name}: results and tested equal the twin's on the main path's lists, bit for bit")
    del twin_out, kt, ki
    listed = int(counts.sum())
    pairs = int(tested.sum()) * sweep.WARP_RAYS * pack.chunk_size
    tile_pairs = int(ungated.amax(dim=1).sum()) * sweep.LANES * pack.chunk_size
    per_pair = PAIR_INSTRUCTIONS_ANY if any_mode else PAIR_INSTRUCTIONS
    op_ms = pairs * per_pair / FP32_INSTR_PER_S * 1e3
    nbytes = (sum(x.numel() * x.element_size() for x in (*args[:7], pack.lo, pack.hi))
              + ro32.shape[0] * 8)
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms, bound_by = max((op_ms, "operations"), (byte_ms, "bytes"))
    twin = "not timed" if p_ms is None else f"{p_ms:.3f} ms"
    log(f"  {name} {'any' if any_mode else 'closest'} query, {ro.shape[0]} rays: kernel "
        f"{k_ms:.3f} ms (gate off {off_ms:.3f} ms), twin {twin}; {listed} positions listed, "
        f"{int(tested.sum())} warp positions tested ({pairs:.3e} pairs; at tile granularity "
        f"{tile_pairs:.3e}); bound {bound_ms:.3f} ms by {bound_by} (operations {op_ms:.3f} ms, "
        f"bytes {byte_ms:.3f} ms for {nbytes} bytes): the kernel runs at "
        f"{bound_ms / k_ms:.3f} of the bound")
    return dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def mask_times(name, ro, rd, pack, cfg, reps=20, twin_reps=3):
    """The chunk-mask kernel on one query as the main path gives it to the
    kernel (rays padded to whole tiles): its lists, entries and counts against
    the twin's on the card, bit for bit; its time and the twin's (CUDA
    events); and the least time the card could take: the rays and the boxes
    read once, the lists, entries and counts written once, at
    HBM_BYTES_PER_S (the arithmetic is far below the FP32 rate)."""
    import torch

    from realtrace_tpu_torch.ops import sweep

    ro32, rd32, *lists = sweep.sweep_inputs(ro, rd, pack, cfg, exact_mask=False)
    nt = ro32.shape[0] // sweep.LANES
    args = (ro32, rd32, pack.lo, pack.hi, nt)
    got = sweep.chunk_mask(*args)
    want = sweep.chunk_mask_reference(*args)
    same = (torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
            and torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))
            and torch.equal(lists[0], got[0]) and torch.equal(lists[2], got[2]))
    check(same, f"{name}: mask kernel lists, entries and counts equal the twin's bit for bit")
    k_ms = cuda_ms(lambda: sweep.chunk_mask(*args), reps=reps)
    t_ms = cuda_ms(lambda: sweep.chunk_mask_reference(*args), reps=twin_reps)
    nbytes = sum(x.numel() * x.element_size() for x in (ro32, rd32, pack.lo, pack.hi, *got))
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    listed = int(got[2].sum())
    log(f"  {name} chunk masks, {nt} tiles x {pack.n_chunks} chunks: kernel {k_ms:.4f} ms, twin "
        f"{t_ms:.3f} ms; bound {bound_ms:.4f} ms by bytes ({nbytes} bytes): the kernel runs at "
        f"{bound_ms / k_ms:.3f} of the bound; {listed} chunks listed "
        f"({listed / (nt * pack.n_chunks):.4f} of tiles x chunks)")
    return dict(ms=k_ms, plain_ms=t_ms, bound_ms=bound_ms, bound_by="bytes", library_ms=None)


def queued_ms(fn, reps: int) -> float:
    """Device ms a call of ``fn``: its launches queued behind a sleeping
    kernel, so they run back to back whatever the host's time to launch them
    (CUDA events around ``reps`` calls)."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@contextlib.contextmanager
def level_twins():
    """The PyTorch code in place of the level kernels (``level_kernels.takes``
    turned off)."""
    from realtrace_tpu_torch.ops import level_kernels

    takes = level_kernels.takes
    level_kernels.takes = lambda *a, **k: False
    try:
        yield
    finally:
        level_kernels.takes = takes


def level_inputs(scene, camera, cfg, widest: bool):
    """One level's ``_shade_level`` arguments as a frame's wavefront gives
    them: level 0, or (``widest``) the level that holds the most lanes."""
    from realtrace_tpu_torch.render import shade
    from realtrace_tpu_torch.render.pipeline import render_with_stats

    seen = []
    real = shade._shade_level

    def spy(*args, **kw):
        seen.append((args, kw))
        return real(*args, **kw)

    shade._shade_level = spy
    try:
        render_with_stats(scene, camera, cfg)
    finally:
        shade._shade_level = real
    return max(seen, key=lambda s: s[0][1].shape[0]) if widest else seen[0]


def level_times(name, scene, camera, cfg, widest, reps=20, twin_reps=5):
    """The level kernels on one level of a frame: the hits kernel against
    ``hit_attributes``' PyTorch code and the shading kernel against
    ``_shade_level``'s, on the same inputs, bit for bit; each one's device
    time and its twin's (``queued_ms``), the host ms a call of either path
    (synchronised at the end of ``reps`` calls), and the least time the card
    could take: each input byte read once (the triangle tables whole) and
    each output byte written once, at HBM_BYTES_PER_S (the arithmetic, about
    100 FP32 operations a lane, is far below the FP32 rate). Returns the two
    kernels' rows."""
    import torch

    from realtrace_tpu_torch.core.types import MATERIAL_KEYS
    from realtrace_tpu_torch.ops.intersect import hit_attributes
    from realtrace_tpu_torch.render import shade

    def nbytes(*xs):
        return sum(x.numel() * x.element_size() for x in xs)

    def same(a, b):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        return torch.equal(a, b)

    def host_ms(fn, reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    (sc, ro, rd, coeff, t, fam, idx, occ, lcfg, pack, branching, level), _ = level_inputs(
        scene, camera, cfg, widest)
    n = ro.shape[0]
    fields = ("valid", "t", "index", "position", "normal", "color") + MATERIAL_KEYS

    def hits():
        return hit_attributes(sc, ro, rd, t, fam, idx, lcfg, pack=pack)

    hit = hits()

    def shades():
        return shade._shade_level(sc, ro, rd, coeff, t, fam, idx, occ, lcfg, pack, branching,
                                  level, hit=hit)

    got = shades()
    with level_twins():
        hit_t = hits()
        got_t = shades()
    flat = [got[0], *(got[1] if isinstance(got[1], tuple) else (got[1],))]
    flat_t = [got_t[0], *(got_t[1] if isinstance(got_t[1], tuple) else (got_t[1],))]
    check(all(same(getattr(hit, f), getattr(hit_t, f)) for f in fields),
          f"{name}: the hits kernel equals hit_attributes bit for bit")
    check(len(flat) == len(flat_t) and all(same(a, b) for a, b in zip(flat, flat_t)),
          f"{name}: the shading kernel's colour and children equal _shade_level's bit for bit")
    mats = [getattr(sc.tri_materials, k) for k in MATERIAL_KEYS]
    hit_in = nbytes(ro, rd, fam, idx, pack.perm, sc.tri_vertices, sc.tri_colors, *mats)
    hit_out = nbytes(*(getattr(hit, f) for f in fields))
    shade_in = nbytes(ro, rd, coeff, *(getattr(hit, f) for f in fields if f != "index"),
                      *(() if occ is None else (occ,)), sc.lights.position, sc.lights.intensity,
                      sc.ambient, sc.background)
    shade_out = nbytes(*flat)
    rows = []
    for kname, fn, b in (("level_hits", hits, hit_in + hit_out),
                         ("level_shade", shades, shade_in + shade_out)):
        k_ms = queued_ms(fn, reps)
        k_host = host_ms(fn, reps)
        with level_twins():
            t_ms = queued_ms(fn, twin_reps)
            t_host = host_ms(fn, twin_reps)
        bound_ms = b / HBM_BYTES_PER_S * 1e3
        log(f"  {name} level {level} ({n} lanes, {n // 1024} tiles, branching {branching}): "
            f"{kname} {k_ms:.4f} device ms, {k_host:.3f} host ms a call; twin {t_ms:.4f} device "
            f"ms, {t_host:.3f} host ms; bound {bound_ms:.4f} ms by bytes ({b} bytes): the kernel "
            f"runs at {bound_ms / k_ms:.3f} of the bound")
        rows.append(dict(ms=k_ms, plain_ms=t_ms, host_ms=k_host, plain_host_ms=t_host,
                         bound_ms=bound_ms, bound_by="bytes", library_ms=None, lanes=n,
                         level=level))
    return rows


def raygen_times(name, camera, reps=20, twin_reps=5):
    """The ray generation kernel against its PyTorch twin
    (``_tiled_rays_reference``) on ``camera``'s frame, bit for bit; each
    one's device time (``queued_ms``) and host ms a call, and the least time
    the card could take: the outputs written once (the kernel reads only the
    camera's ten numbers) at HBM_BYTES_PER_S. Returns the kernel's row."""
    import torch

    from realtrace_tpu_torch.render.pipeline import _tiled_rays, _tiled_rays_reference

    def kernel():
        return _tiled_rays(camera)

    def twin():
        return _tiled_rays_reference(camera, 0, 0, camera.width, camera.height)

    def host_ms(fn, reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    got, want = kernel(), twin()
    check(all((a is None and b is None) or torch.equal(a.view(torch.int32), b.view(torch.int32))
              for a, b in zip(got, want)),
          f"{name}: the ray generation kernel equals the PyTorch code bit for bit")
    ro, rd, coeff = got
    n = rd.shape[0]
    written = rd.numel() * 4 + (0 if coeff is None else (ro.numel() + n) * 4)
    k_ms, k_host = queued_ms(kernel, reps), host_ms(kernel, reps)
    t_ms, t_host = queued_ms(twin, twin_reps), host_ms(twin, twin_reps)
    bound_ms = written / HBM_BYTES_PER_S * 1e3
    log(f"  {name} ({n} slots): raygen {k_ms:.4f} device ms, {k_host:.3f} host ms a call; twin "
        f"{t_ms:.4f} device ms, {t_host:.3f} host ms; bound {bound_ms:.4f} ms by bytes "
        f"({written} bytes written): the kernel runs at {bound_ms / k_ms:.3f} of the bound")
    return dict(ms=k_ms, plain_ms=t_ms, host_ms=k_host, plain_host_ms=t_host, bound_ms=bound_ms,
                bound_by="bytes", library_ms=None, slots=n)


def progressive_run(name, scene, camera, cfg, band, frame, card):
    """Phase 7: the progressive renderer over the whole frame, band by band,
    with both launch counts zeroed before and read after each band; the image
    against ``frame`` (the render_with_stats image and its (K1, K2) launches);
    save after band 4 and resume in a fresh renderer. Returns (K1, K2)
    launches of the run."""
    import torch

    from realtrace_tpu_torch.ops import sweep
    from realtrace_tpu_torch.render.progressive import ProgressiveRenderer

    img_full, full_k = frame
    pr = ProgressiveRenderer(scene, camera, cfg, band=band)
    bands, times = [], []
    while not pr.done:
        torch.cuda.synchronize()
        sweep.sweep.launches = sweep.sweep.stream_launches = 0
        t0 = time.perf_counter()
        pr.step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        bands.append((sweep.sweep.launches, sweep.sweep.stream_launches))
    img = pr.image()
    k1, k2 = (sum(b[i] for b in bands) for i in (0, 1))
    err = (img - img_full).abs().amax(-1)
    over = int((err > IMAGE_TOL).sum())
    unequal = int((img != img_full).any(-1).sum())
    total_s = sum(times) / 1e3
    log(f"  progressive {name} {camera.width}x{camera.height} depth {cfg.max_depth}, "
        f"{len(bands)} bands of {band}: {over} pixels > {IMAGE_TOL}, {unequal} not bit-equal, "
        f"max {float(err.max()):.3e}; launches per band (K1, K2) {bands} (frame {full_k}); "
        f"ms per band mean {sum(times) / len(times):.2f} (min {min(times):.2f}, max "
        f"{max(times):.2f}; the first band includes warm-up), {pr.rays} rays, "
        f"{pr.rays / total_s / 1e6:.2f} Mrays/s ({card})")
    check(over == 0, f"progressive {name}: the bands equal the full render within {IMAGE_TOL}")
    frame_kernel = 0 if full_k[0] else 1     # the kernel the frame launches
    check(all(b[frame_kernel] <= full_k[frame_kernel] and b[1 - frame_kernel] == 0
              for b in bands) and (k1, k2)[frame_kernel] > 0,
          f"progressive {name}: every band launches only the frame's kernel, at most as often "
          f"as the frame, and the run launches it")
    with tempfile.TemporaryDirectory() as tmp:
        a = ProgressiveRenderer(scene, camera, cfg, band=band)
        for _ in range(4):
            a.step()
        a.save(Path(tmp) / "state.npz")
        b = ProgressiveRenderer(scene, camera, cfg, band=band)
        b.load(Path(tmp) / "state.npz")
        resumed = b.render_all()
    check(b.cursor == camera.height and torch.equal(resumed, img),
          f"progressive {name}: saved after band 4 and resumed equals the uninterrupted run "
          f"bit for bit")
    return k1, k2


def sharded_runs(mesh, camera, cfg, img_full, card):
    """Phase 7: the two-rank smoke (gloo on the card) and a world-size-1 NCCL
    group. Returns the K1 launches of rank 0's sharded frame."""
    import socket

    import torch
    import torch.distributed as dist

    from realtrace_tpu_torch.parallel import mesh as pmesh

    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, "-m", "realtrace_tpu_torch.parallel.smoke", "--device", "cuda",
               "--width", str(W), "--height", str(H), "--depth", str(DEPTH), "--steps", "3",
               "--timeout", "300", "--out", str(Path(tmp) / "out.npz")]
        t0 = time.perf_counter()
        try:
            run = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=420)
            rc, out, err = run.returncode, run.stdout, run.stderr
        except subprocess.TimeoutExpired as e:
            rc, out, err = "timeout", str(e.stdout or ""), str(e.stderr or "")
        wall = time.perf_counter() - t0
    for line in out.splitlines():
        log(f"  | {line}")
    lines = out.strip().splitlines()
    ok = rc == 0 and bool(lines) and lines[-1] == "OK"
    if not ok:
        log(f"  smoke stderr (tail): {err[-3000:]}")
    check(ok, f"two-rank smoke (gloo on the card, 1x2 grid, {W}x{H}) passed all its checks, "
          f"exit {rc}, {wall:.1f} s")
    summary = {}
    if ok:
        summary = json.loads(lines[-2])
        log(f"  two-rank smoke: launcher's reference (single frame and train step, while the "
            f"workers start) {summary['reference_s']:.2f} s, workers' group init "
            f"{summary['worker_init_s']} s, set-up {summary['worker_setup_s']} s, wait "
            f"{summary['worker_wait_s']} s; single frame {summary['single_render_s']:.3f} s, "
            f"sharded frame {summary['sharded_render_s']} s, train steps {summary['step_s']} s, K1 "
            f"{summary['k1']}, K2 {summary['k2']}, losses {summary['losses']}, gradient "
            f"errors {summary['grad_rel_err']} ({card})")
        check(all(k > 0 for k in summary["k1"]) and not any(summary["k2"]),
              "each rank launched K1 and not K2 for its tile")
        check(not any(summary["rebuilt"]), "both ranks loaded the kernel library phase 2 built")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    pmesh.init_distributed(f"127.0.0.1:{port}", 1, 0, backend="nccl")
    try:
        m1 = pmesh.make_mesh()
        img = pmesh.sharded_render(pmesh.replicate_scene(mesh, m1), camera, cfg, m1)
        x = torch.arange(8.0, device=camera.position.device)
        dist.all_reduce(x)
        torch.cuda.synchronize()
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    log(f"  world-size-1 {backend} group: sharded_render and one all_reduce in "
        f"{time.perf_counter() - t0:.2f} s")
    check(backend == "nccl" and torch.equal(img, img_full)
          and torch.equal(x.cpu(), torch.arange(8.0)),
          "a world-size-1 NCCL group renders the frame and all-reduces")
    return summary.get("k1", [0])[0]


def apps_runs(mesh, cam, cfg, dev, card):
    """Phase 7: flythrough, viewer, samples, OBJ parsers and the CUDA app's
    scene. Returns the K1 launches of the flythrough and the OBJ frame."""
    import io

    import numpy as np
    import torch

    from realtrace_tpu_torch.apps import samples, scenes, viewer
    from realtrace_tpu_torch.apps.flythrough import run_flythrough
    from realtrace_tpu_torch.io import native_obj, obj
    from realtrace_tpu_torch.ops import accel, sweep
    from realtrace_tpu_torch.render.camera import InteractiveCamera
    from realtrace_tpu_torch.render.pipeline import render_with_stats
    from realtrace_tpu_torch.utils.profiling import trace_capture

    def orbit(w, h):
        return InteractiveCamera(radius=85.0, pitch=0.6, resolution=(w, h))

    frames = 24
    sweep.sweep.launches = sweep.sweep.stream_launches = 0
    imgs, fps = run_flythrough(mesh, orbit(512, 512), cfg, frames=frames)
    fly_k = (sweep.sweep.launches, sweep.sweep.stream_launches)
    log(f"  flythrough mesh_scene 512x512 depth {cfg.max_depth}, {frames} frames: {fps:.2f} fps "
        f"(first frame left out), launches per frame K1 {fly_k[0] / frames:.2f}, K2 "
        f"{fly_k[1] / frames:.2f} ({card})")
    check(len(imgs) == frames and all(bool(torch.isfinite(x).all()) for x in imgs)
          and fly_k[0] > 0 and fly_k[1] == 0, "the flythrough renders its frames through K1")
    with tempfile.TemporaryDirectory() as tmp:
        with trace_capture(tmp) as prof:
            run_flythrough(mesh, orbit(512, 512), cfg, frames=3)
        names = {e.name for e in prof.events()}
        busy_ms = sum(getattr(e, "self_device_time_total", 0.0)
                      for e in prof.key_averages()) / 1e3
        trace_ok = (Path(tmp) / "trace.json").exists()
    check(trace_ok and all(f"flythrough_frame_{i}" in names for i in range(3)),
          "trace_capture holds every frame_bracket label of a 3-frame flythrough")
    log(f"  trace_capture of 3 flythrough frames: {len(names)} event names, device busy "
        f"{busy_ms:.1f} ms (the sum of the kernels' own device time)")

    keys = "\x1b[C" * 6 + "\x1b[A\x1b[A" + "zz" + "\x1b[D" * 6
    views = []
    for batched in (False, True):
        scene, orbit0 = viewer._build("mesh", cfg, 256, 128, dev)
        v = viewer.Viewer(scene, orbit0, cfg, out=io.StringIO())
        if batched:
            v.run_script_batched(keys, batch=8)
        else:
            v.run_script(keys)
        views.append(v)
    log(f"  viewer script of {len(keys.replace(chr(27) + '[', ''))} keys at 256x128: per frame "
        f"{views[0].fps:.1f} FPS (moving average), {views[0].mrays:.2f} Mrays/s; batched 8 "
        f"{views[1].fps:.1f} FPS, {views[1].mrays:.2f} Mrays/s over {views[1].frames} frames "
        f"({card})")
    check(np.array_equal(views[0].last_img, views[1].last_img) and views[1].frames == 16,
          "the viewer's batched script ends on the per-frame script's last frame")

    flash = [samples.flashlight(1920, 1080, (960.5, 540.25), device=d) for d in (dev, "cpu")]
    stab = [[samples.stability(128, 128, 0.1, k, device=d) for d in (dev, "cpu")]
            for k in (0, 1, 2)]
    check(torch.equal(flash[0].cpu(), flash[1]) and all(torch.equal(a.cpu(), b)
                                                        for a, b in stab),
          "flashlight (1920x1080) and stability (128x128, three systems) on the card equal "
          "the CPU's")

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "mesh.obj"
        tv = write_mesh_obj(path)
        native = obj.parse_obj(path)
        check(native_obj._lib is not None, "the native OBJ parser built and loaded")
        saved = obj._try_native
        obj._try_native = lambda p: None
        try:
            python = obj.parse_obj(path)
        finally:
            obj._try_native = saved
        check(all(np.array_equal(getattr(native, f), getattr(python, f))
                  for f in ("vertices", "tri_vertex_idx", "tri_uv_idx", "uvs"))
              and np.array_equal(native.triangles, tv),
              f"native and Python OBJ parsers agree on mesh_scene's {len(tv)} triangles")
        par, pcam = scenes.parallel_obj_scene(path, device=dev)
    par = accel.with_chunks(par, cfg)
    sweep.sweep.launches = sweep.sweep.stream_launches = 0
    img, nrays = render_with_stats(par, scenes.make_camera(pcam, W, H, device=dev), cfg)
    torch.cuda.synchronize()
    obj_k = (sweep.sweep.launches, sweep.sweep.stream_launches)
    bg = par.background.to(img.dtype)
    covered = float((img - bg).abs().amax(-1).gt(1e-3).float().mean())
    log(f"  parallel_obj_scene ({par.n_triangles} triangles) {W}x{H}: {nrays} rays, launches "
        f"K1 {obj_k[0]}, K2 {obj_k[1]}, covers {covered:.3f} of the frame")
    check(bool(torch.isfinite(img).all()) and obj_k[0] > 0 and 0.01 < covered < 0.99,
          "parallel_obj_scene renders at 1080p through K1")
    return fly_k[0] + obj_k[0]


GRAD_FIELDS = ("tri_vertices", "tri_colors", "lights")                     # bench.py:199
TRAIN_FIELDS = ("tri_vertices", "tri_colors", "tri_materials", "lights")   # bench.py:248
FD_RTOL = 5e-3                                                             # tests/test_grad.py


BENCH_LINES = {"headline": 1, "hit-heavy": 1, "grad": 2, "train": 1, "branching": 1,
               "stream": 1, "bigscene": 1, "bigcurve": 3, "depth10": 1}
BENCH_KEYS = ("median_ms", "q1_ms", "q3_ms", "n", "k1_per_frame", "k2_per_frame",
              "peak_device_bytes", "busy_ms", "idle_share")


def bench_run(card, reps=3, timeout=600):
    """Phase 8: ``python -m realtrace_tpu_torch.apps.bench`` at 1920x1080 with
    ``--reps`` samples a series: it exits 0, every leg prints its metrics once
    each, the headline last, every value finite and positive, every line with
    its median, quartiles, n, rays and launches a frame, peak memory, busy ms,
    idle share and the card. Returns the K1 and K2 launches of its timed
    samples, as the bench counts them (each series once)."""
    import math

    cmd = [sys.executable, "-m", "realtrace_tpu_torch.apps.bench", "--width", str(W),
           "--height", str(H), "--reps", str(reps)]
    t0 = time.perf_counter()
    try:
        run = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=timeout)
        rc, out, err = run.returncode, run.stdout, run.stderr
    except subprocess.TimeoutExpired as e:
        rc, out, err = "timeout", str(e.stdout or ""), str(e.stderr or "")
    wall = time.perf_counter() - t0
    recs = []
    for line in out.splitlines():
        log(f"  | {line}")
        try:
            recs.append(json.loads(line))
        except ValueError:
            recs.append({"not_json": line})
    if rc != 0:
        log(f"  bench stderr (tail): {err[-3000:]}")
    check(rc == 0 and not any("leg_failed" in r for r in recs),
          f"the bench ran every leg, exit {rc}, {wall:.1f} s ({len(recs)} lines)")
    legs = [r.get("leg") for r in recs]
    check(all(legs.count(leg) == n for leg, n in BENCH_LINES.items())
          and len(recs) == sum(BENCH_LINES.values())
          and len({r.get("metric") for r in recs}) == len(recs)
          and bool(recs) and recs[-1].get("leg") == "headline",
          "each bench metric appears exactly once, the headline last")
    bad = [r.get("metric") for r in recs
           if not (math.isfinite(r.get("value", math.nan)) and r["value"] > 0
                   and all(r.get(k) is not None for k in BENCH_KEYS)
                   and r.get("rays_per_frame", 0) > 0 and r.get("device") == card)]
    check(not bad, f"every bench value is finite and positive, with its statistics and the "
                   f"card ({bad})")
    head = recs[-1] if recs else {}
    run = head.get("run_k1_launches", 0), head.get("run_k2_launches", 0)
    check(run[0] > 0 and run[1] > 0, f"the bench counted K1 and K2 over its timed samples {run}")
    return run


MODES = {"default": {}, "fully merged": {"shadow_any_mode": False},
         "unmerged": {"merge_queries": False}}
MODE_K_A_FRAME = {"default": 8, "fully merged": 5, "unmerged": 8}   # depth 3, one light


def host_median(fn, reps: int):
    """Median and samples (ms) of ``reps`` host-timed calls of ``fn``, each
    ending in ``torch.cuda.synchronize()``, after one untimed call."""
    import statistics

    import torch

    fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ms), ms


def in_turns(runs: dict, reps: int) -> dict:
    """Host-timed synchronised calls of several paths in turns, one call of
    each a round, ``reps`` rounds after an untimed one, so that a drift of
    the host falls on every path alike. Each path also runs once under
    ``torch.profiler``: the card's busy ms and idle share
    (``utils/profiling.py::device_busy``) and the device ms of the sweep
    kernels. Returns name -> dict of those and the median, quartiles and
    samples (ms)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from realtrace_tpu_torch.utils import profiling

    for fn in runs.values():
        fn()
    torch.cuda.synchronize()
    ms: dict = {k: [] for k in runs}
    for _ in range(reps):
        for k, fn in runs.items():
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms[k].append((time.perf_counter() - t0) * 1e3)
    out = {}
    for k, fn in runs.items():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            total = (time.perf_counter() - t0) * 1e3
        busy = profiling.device_busy(prof, total)
        sweep_us = sum(e.device_time for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA and "sweep" in e.name)
        q1, med, q3 = np.percentile(ms[k], [25, 50, 75])
        out[k] = dict(median=float(med), q1=float(q1), q3=float(q3), samples=ms[k],
                      busy_ms=busy["busy_ms"], idle=busy["idle_share"], sweep_ms=sweep_us / 1e3)
    return out


def against(name, img, n, ref, n_ref, what):
    """Hold an image and its rays to another render's (``what`` names it):
    error > IMAGE_TOL on at most IMAGE_FRAC of pixels, equal rays; the
    pixels that are not bit-equal are counted."""
    err = (img - ref).abs().amax(-1)
    over = int((err > IMAGE_TOL).sum())
    unequal = int((img != ref).any(-1).sum())
    log(f"  {name} against {what}: {over} pixels > {IMAGE_TOL}, {unequal} not bit-equal, max "
        f"{float(err.max()):.3e}, rays {n} vs {n_ref}")
    check(over <= IMAGE_FRAC * err.numel() and n == n_ref,
          f"{name}: its image equals {what} (<= {IMAGE_FRAC}), equal rays")


def query_modes(mesh, camera, cfg, dev, card):
    """Phase 9. Returns the K1 launches of the fully merged and unmerged
    mesh frames and the K2 launches of the fully merged x8 frame."""
    import torch

    from realtrace_tpu_torch.apps import scenes
    from realtrace_tpu_torch.ops import accel, sweep
    from realtrace_tpu_torch.render.pipeline import _tiled_rays, render_with_stats

    frames, launches, cfgs = {}, {}, {}
    for mode, knobs in MODES.items():
        cfgs[mode] = dataclasses.replace(cfg, **knobs)
        img, n, k1, k2 = main_path(f"mesh_scene, {mode} mode", mesh, camera, cfgs[mode])
        check(k1 == MODE_K_A_FRAME[mode] and k2 == 0,
              f"mesh_scene, {mode} mode: {k1} K1 a frame (want {MODE_K_A_FRAME[mode]}), {k2} K2")
        if mode != "default":
            against(f"mesh_scene, {mode} mode", img, n, *frames["default"], "the default mode")
        frames[mode], launches[mode] = (img, n), k1

    x8, _ = scenes.duplicated_mesh_scene(8, device=dev)
    x8 = accel.with_chunks(x8, cfg)
    cfg_f = cfgs["fully merged"]
    img, n, k1, k2_merged = main_path("duplicated_mesh_scene(8), fully merged mode", x8, camera,
                                      cfg_f)
    check(k1 == 0 and k2_merged == MODE_K_A_FRAME["fully merged"],
          f"x8, fully merged mode: K2 only, {k2_merged} a frame")
    against("duplicated_mesh_scene(8), fully merged mode", img, n,
            *render_with_stats(x8, camera, cfg), "the default mode")
    del img

    runs = {f"mesh_scene, {mode} mode": (lambda c=c: render_with_stats(mesh, camera, c))
            for mode, c in cfgs.items()}
    runs.update({f"duplicated_mesh_scene(8), {mode} mode":
                 (lambda c=cfgs[mode]: render_with_stats(x8, camera, c))
                 for mode in ("default", "fully merged")})
    for name, r in in_turns(runs, reps=10).items():
        log(f"  {name} {W}x{H} depth {cfg.max_depth}: median {r['median']:.2f} ms (q1 "
            f"{r['q1']:.2f}, q3 {r['q3']:.2f}) of {len(r['samples'])} host-timed frames in turns "
            f"with the other modes; profiled frame: busy {r['busy_ms']:.2f} ms, idle {r['idle']:.3f}, sweep "
            f"kernels {r['sweep_ms']:.3f} ms ({card})")
    del x8

    # the chunked accel: the JAX bench's headline config (bench.py:386-390)
    cfg_c = dataclasses.replace(cfg, accel="chunked", ray_block=8192)
    small = scenes.make_camera(scenes.SERIAL_CAM, 256, 192, device="cpu")
    mesh_cpu = accel.with_chunks(mesh.to("cpu"), cfg_c)
    check(torch.equal(mesh_cpu.tri_chunk_perm, mesh.tri_chunk_perm.cpu()),
          "the chunk permutation built on the CPU equals the card's")
    ro, rd, _ = _tiled_rays(small)
    refl, shad = secondary_rays(mesh_cpu, None, cfg_c, ro, rd)
    for name, o, d in (("primary", ro, rd), ("reflection", *refl), ("shadow", *shad)):
        t_cpu, i_cpu = accel.closest_triangle(mesh_cpu, o, d, cfg_c)
        t_card, i_card = accel.closest_triangle(mesh, o.to(dev), d.to(dev), cfg_c)
        same_i = torch.equal(i_card.cpu(), i_cpu)
        same_t = torch.equal(t_card.cpu(), t_cpu)
        log(f"  chunked 256x192 {name} query, {o.shape[0]} rays: {int((i_cpu >= 0).sum())} hits, "
            f"indices {'equal' if same_i else 'NOT equal'} on the card and the CPU "
            f"({int((i_card.cpu() != i_cpu).sum())} differ), distances "
            f"{'bit-equal' if same_t else 'not bit-equal'}")
        check(same_i and same_t, f"chunked {name} query: the card's hits equal the CPU's")
    sweep.sweep.launches = sweep.sweep.stream_launches = 0
    img_c, n_c = render_with_stats(mesh, camera, cfg_c)
    torch.cuda.synchronize()
    kc = (sweep.sweep.launches, sweep.sweep.stream_launches)
    check(kc == (0, 0) and tuple(img_c.shape) == (H, W, 3) and bool(torch.isfinite(img_c).all()),
          f"the chunked 1080p frame is finite and launches no sweep kernel {kc}")
    med, ms = host_median(lambda: render_with_stats(mesh, camera, cfg_c), reps=5)
    img_d, n_d = frames["default"]
    err = (img_c - img_d).abs().amax(-1)
    share = float((err > IMAGE_TOL).float().mean())
    log(f"  chunked mesh_scene {W}x{H} depth {cfg.max_depth} (ray blocks of 8192, shortlist "
        f"{cfg_c.shortlist}): median {med:.2f} ms of 5 host-timed frames (min {min(ms):.2f}, "
        f"max {max(ms):.2f}), {n_c} rays (sweep {n_d}); {share:.4%} of pixels over {IMAGE_TOL} "
        f"off the sweep's image, max {float(err.max()):.3e} ({card})")
    return launches["fully merged"], launches["unmerged"], k2_merged


def grad_leaves(scene, camera, cfg, fields=GRAD_FIELDS):
    """``image_grad`` (the mean pixel) as (loss, flat gradient tensors, peak
    device bytes of the call)."""
    import torch

    from realtrace_tpu_torch.core.types import tensor_leaves
    from realtrace_tpu_torch.diff.inverse import image_grad

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loss, grads = image_grad(scene, camera, cfg, fields=fields)
    torch.cuda.synchronize()
    return loss, tensor_leaves(grads), torch.cuda.max_memory_allocated()


def bit_equal(a, b) -> bool:
    import torch

    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def finite_differences(dev, cfg):
    """Central differences of the mean pixel in f64 through the kernel on
    mesh_scene at 128x96 against ``image_grad``: the vertex coordinate with
    the largest gradient whose steps leave every query's result unchanged
    (hits are decided in f32, so a step that moved one would measure a
    visibility jump), a vertex colour and a light intensity."""
    import torch

    from realtrace_tpu_torch.apps import scenes
    from realtrace_tpu_torch.diff.inverse import apply_params, image_grad, scene_params
    from realtrace_tpu_torch.ops import accel, sweep
    from realtrace_tpu_torch.render.pipeline import render_buffer

    f64 = torch.float64
    scene, cam = scenes.mesh_scene(dtype=f64, device=dev)
    scene = accel.with_chunks(scene, cfg)
    camera = scenes.make_camera(cam, 128, 96, dtype=f64, device=dev)
    _, grads = image_grad(scene, camera, cfg, fields=GRAD_FIELDS)
    kernel = sweep.sweep

    def loss_at(field, key, index, delta):
        """The mean pixel with one scalar moved, and every query's indices."""
        p = scene_params(scene, GRAD_FIELDS)
        if key is None:
            leaf = p[field].clone()
            leaf[index] += delta
            p[field] = leaf
        else:
            leaf = getattr(p[field], key).clone()
            leaf[index] += delta
            p[field] = dataclasses.replace(p[field], **{key: leaf})
        hits = []

        def recording(*a, **k):
            out = kernel(*a, **k)
            hits.append(out[1].clone())
            return out

        recording.launches = recording.stream_launches = 0   # the kernels count on it
        sweep.sweep = recording
        try:
            with torch.no_grad():
                value = float(torch.mean(render_buffer(apply_params(scene, p), camera, cfg)))
        finally:
            sweep.sweep = kernel
        return value, hits

    gv = grads["tri_vertices"]
    order = torch.argsort(gv.abs().flatten(), descending=True)[:6].tolist()
    vertex = [tuple(int(i) for i in torch.unravel_index(torch.tensor(o), gv.shape))
              for o in order]
    trials = ([("tri_vertices", None, v, 1e-6) for v in vertex]
              + [("tri_colors", None, tuple(int(i) for i in torch.unravel_index(
                  torch.argmax(grads["tri_colors"].abs()).cpu(), gv.shape)), 1e-5),
                 ("lights", "intensity", (0, 1), 1e-5)])
    _, base_hits = loss_at("lights", "intensity", (0, 1), 0.0)
    done = set()
    for field, key, index, eps in trials:
        if field in done:
            continue
        (up, hits_up), (down, hits_down) = (loss_at(field, key, index, d) for d in (eps, -eps))
        same = bit_equal(hits_up, base_hits) and bit_equal(hits_down, base_hits)
        g = grads[field] if key is None else getattr(grads[field], key)
        ad, fd = float(g[index]), (up - down) / (2 * eps)
        name = f"{field}{'.' + key if key else ''}{list(index)}"
        log(f"  finite difference 128x96 f64, {name}, step {eps:g}: autodiff {ad:.9e}, central "
            f"difference {fd:.9e}, relative error {abs(ad - fd) / max(abs(fd), 1e-300):.2e}, "
            f"visibility {'unchanged' if same else 'CHANGED (next candidate)'}")
        if not same and field == "tri_vertices" and index != vertex[-1]:
            continue
        check(same and ad != 0.0 and abs(ad - fd) <= FD_RTOL * abs(fd) + 1e-12,
              f"f64 finite difference through the kernel: {name} within rtol {FD_RTOL}")
        done.add(field)


def backward_and_train(mesh, cam, camera, cfg, forward_launches, card, dev):
    """Phase 6. Returns the launches of each kernel on the training path
    (``image_grad`` of the 1080p frame and five train steps)."""
    import torch

    from realtrace_tpu_torch.apps import scenes
    from realtrace_tpu_torch.core.types import tensor_leaves
    from realtrace_tpu_torch.diff.inverse import make_train_step
    from realtrace_tpu_torch.ops import accel, sweep
    from realtrace_tpu_torch.render.pipeline import render_buffer

    gib = 1 << 30
    sweep.sweep.launches = sweep.sweep.stream_launches = 0
    loss, g_kernel, peak_remat = grad_leaves(mesh, camera, cfg)
    path = [sweep.sweep.launches, sweep.sweep.stream_launches]
    log(f"  image_grad {camera.width}x{camera.height} depth {cfg.max_depth} "
        f"({', '.join(GRAD_FIELDS)}): loss "
        f"{float(loss):.6e}, sweep.launches {path[0]}, sweep.stream_launches {path[1]} (the "
        f"forward render: {forward_launches}), largest |g| "
        f"{max(float(g.abs().max()) for g in g_kernel):.3e}")
    check(path == [forward_launches, 0],
          "forward and backward launch the forward render's sweeps (the backward none)")
    check(all(bool(torch.isfinite(g).all()) for g in g_kernel)
          and all(bool(g.abs().max() > 0) for g in g_kernel),
          "every 1080p gradient is finite and each field takes one")

    t0 = time.perf_counter()
    with twin_sweep():
        _, g_twin, _ = grad_leaves(mesh, camera, cfg)
    log(f"  the same gradients through the twin: {time.perf_counter() - t0:.1f} s")
    check(bit_equal(g_kernel, g_twin),
          "kernel-path gradients equal twin-path gradients bit for bit")
    del g_twin
    _, g_again, _ = grad_leaves(mesh, camera, cfg)
    check(bit_equal(g_kernel, g_again), "two backward passes give bit-identical gradients")
    _, g_plain, peak_plain = grad_leaves(mesh, camera, dataclasses.replace(cfg, remat=False))
    log(f"  peak device memory of image_grad {camera.width}x{camera.height}: remat "
        f"{peak_remat / gib:.3f} GiB, without remat {peak_plain / gib:.3f} GiB ({card})")
    check(bit_equal(g_kernel, g_plain), "remat and no remat give bit-identical gradients")
    del g_again, g_plain

    finite_differences(dev, cfg)

    with torch.no_grad():
        target = render_buffer(mesh, camera, cfg)
    gen = torch.Generator().manual_seed(6)
    noise = torch.randn(mesh.tri_colors.shape, generator=gen).to(dev, mesh.tri_colors.dtype)
    # colours off by 0.3: at 0.1 the first steps' moves of the vertices and
    # materials change more pixels than the colours recover (the loss rose)
    wrong = dataclasses.replace(mesh, tri_colors=mesh.tri_colors + 0.3 * noise)
    step, params, _ = make_train_step(wrong, camera, cfg, target, lr=1e-2, fields=TRAIN_FIELDS)
    resorts = []
    resort = accel.resort_chunks
    accel.resort_chunks = lambda s, c: resorts.append(1) or resort(s, c)
    sweep.sweep.launches = sweep.sweep.stream_launches = 0
    try:
        losses = [float(step()) for _ in range(5)]
    finally:
        accel.resort_chunks = resort
    path[0] += sweep.sweep.launches
    path[1] += sweep.sweep.stream_launches
    log(f"  5 Adam steps {camera.width}x{camera.height} ({', '.join(TRAIN_FIELDS)}; perturbed "
        f"colours): losses "
        f"{', '.join(f'{x:.6e}' for x in losses)}; {len(resorts)} re-sorts, "
        f"sweep.launches {sweep.sweep.launches}")
    check(len(resorts) == 5 and losses[-1] < losses[0]
          and all(bool(torch.isfinite(p).all()) for p in tensor_leaves(params)),
          "the 1080p train step re-sorts every step, the loss falls, the parameters stay finite")
    check(path[0] > 0, "the training path launched the resident kernel")

    close = scenes.make_camera(dict(cam, position=CLOSE_POSITION), W, H, device=dev)
    peaks = [grad_leaves(mesh, close, dataclasses.replace(cfg, remat=r))[2] / gib
             for r in (True, False)]
    log(f"  the same at the close framing {CLOSE_POSITION}: remat {peaks[0]:.3f} GiB, without "
        f"remat {peaks[1]:.3f} GiB")
    return path


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from realtrace_tpu_torch.apps import scenes
    from realtrace_tpu_torch.core.types import Materials, RenderConfig, SceneBuilder
    from realtrace_tpu_torch.ops import accel, cuda_build, level_kernels, raygen, sweep
    from realtrace_tpu_torch.render.pipeline import _tiled_rays, render_with_stats
    from realtrace_tpu_torch.utils import profiling

    sys.path.insert(0, str(ROOT / "tests"))
    from oracle.cpu_reference import OracleRenderer
    from oracle.scene128 import CAM as CAM128, DEPTH as DEPTH128, SIZE as SIZE128

    dev = torch.device("cuda", 0)
    card = profiling.card_name()
    t_start = time.perf_counter()

    def phase(title):
        log(f"== {title}  [{time.perf_counter() - t_start:.0f} s]")

    phase("1 environment")
    log(f"  python {sys.version.split()[0]}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, device {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} visible")
    log(card)

    phase("2 build")
    cuda_build.load()
    log(f"  built {cuda_build.build_info['library']} in {cuda_build.build_info['seconds']:.2f} s")
    for line in cuda_build.build_info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")

    phase("3 kernels against twin")
    errs: list[float] = []          # resident kernel
    errs_stream: list[float] = []   # streaming kernel
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
    kernel_vs_twin("random-137", ro, rd, sweep.build_pack(small, cfg), cfg, False, errs)
    kernel_vs_twin("random-137", ro, rd, sweep.build_pack(small, cfg), cfg, False, errs_stream,
                   stream=True)

    mesh, cam = scenes.mesh_scene(device=dev)
    mesh = accel.with_chunks(mesh, cfg)
    pack = sweep.build_pack(mesh, cfg)
    log(f"  mesh_scene: {mesh.n_triangles} triangles, {pack.n_chunks} chunks of "
        f"{pack.chunk_size}, resident {pack.resident}")
    check(pack.resident, "mesh_scene takes the resident kernel")
    camera = scenes.make_camera(cam, W, H, device=dev)
    ro, rd, _ = _tiled_rays(camera)
    kernel_vs_twin("mesh 1080p primary (interval mask)", ro, rd, pack, cfg, False, errs)
    mesh_refl, mesh_shad = secondary_rays(mesh, pack, cfg, ro, rd)
    kernel_vs_twin("mesh reflection (exact mask)", *mesh_refl, pack, cfg, True, errs)
    kernel_vs_twin("mesh shadow (exact mask)", *mesh_shad, pack, cfg, True, errs)

    x8, _ = scenes.duplicated_mesh_scene(8, device=dev)
    x8 = accel.with_chunks(x8, cfg)
    pack8 = sweep.build_pack(x8, cfg)
    log(f"  duplicated_mesh_scene(8): {x8.n_triangles} triangles, {pack8.n_chunks} chunks of "
        f"{pack8.chunk_size}, resident {pack8.resident}, "
        f"{sweep.super_bounds(pack8.lo, pack8.hi)[0].shape[0]} super-chunks")
    check(not pack8.resident and x8.n_triangles >= sweep.EXACT_MASK_MIN_TRIS,
          "the x8 scene takes the streaming kernel and the big-scene masks")
    kernel_vs_twin("x8 1080p primary (exact mask + super gate)", ro, rd, pack8, cfg, True,
                   errs_stream, stream=True)
    x8_refl, x8_shad = secondary_rays(x8, pack8, cfg, ro, rd)
    kernel_vs_twin("x8 reflection (exact mask)", *x8_refl, pack8, cfg, True, errs_stream,
                   stream=True)
    kernel_vs_twin("x8 shadow (exact mask)", *x8_shad, pack8, cfg, True, errs_stream, stream=True)

    phase("4 main paths")
    log(f"  list policy for CUDA tensors: "
        f"{'interval lists at every width' if sweep.INTERVAL_LISTS_ON_CUDA else 'as on the CPU'}")
    img_m, n_m, launches, k2 = main_path("mesh_scene", mesh, camera, cfg)
    check(launches > 0 and k2 == 0, "mesh_scene launched the resident kernel only")
    img_8, n_8, k1, stream_launches = main_path("duplicated_mesh_scene(8)", x8, camera, cfg)
    check(stream_launches > 0 and k1 == 0, "the x8 scene launched the streaming kernel only")

    glass, _ = scenes.glass_mesh_scene(device=dev)
    glass = accel.with_chunks(glass, cfg)
    check(glass.has_dielectrics(), "glass_mesh_scene has a dielectric")
    img_g, n_g, k1, k2 = main_path("glass_mesh_scene", glass, camera, cfg)
    check(k1 > 0 and k2 == 0, "glass_mesh_scene launched the resident kernel only")
    img_g2, n_g2 = render_with_stats(glass, camera, cfg)
    check(n_g == n_g2 and torch.equal(img_g, img_g2),
          "glass_mesh_scene renders twice bit-identically")
    del img_g2

    # the JAX bench's OBJ workloads, on mesh_scene's mesh written as an OBJ
    with tempfile.TemporaryDirectory() as tmp:
        obj_path = Path(tmp) / "mesh.obj"
        write_mesh_obj(obj_path)
        x8_obj, _ = scenes.duplicated_serial_scene(8, obj_path, device=dev)
        glass_obj, _ = scenes.glass_bob_scene(obj_path, device=dev)
    same = torch.equal(x8_obj.tri_vertices, x8.tri_vertices)
    dv = float((x8_obj.tri_vertices - x8.tri_vertices).abs().max())
    log(f"  duplicated_serial_scene(8) from the OBJ: {x8_obj.n_triangles} triangles, vertices "
        f"{'bit-equal to' if same else 'not bit-equal to'} duplicated_mesh_scene(8)'s, max "
        f"|difference| {dv:.3e}")
    check(x8_obj.n_triangles == x8.n_triangles and (same or dv < 1e-5),
          "the OBJ x8 scene's vertices equal the procedural x8's (bit for bit, else within 1e-5)")
    x8_obj = accel.with_chunks(x8_obj, cfg)
    _, n_8o, k1, k2_obj = main_path("duplicated_serial_scene(8)", x8_obj, camera, cfg)
    check(k2_obj > 0 and k1 == 0, "the OBJ x8 scene launched the streaming kernel only")
    log(f"  rays: duplicated_serial_scene(8) {n_8o}, duplicated_mesh_scene(8) {n_8}")
    glass_obj = accel.with_chunks(glass_obj, cfg)
    check(glass_obj.has_dielectrics(), "glass_bob_scene has a dielectric")
    img_go, n_go, k1_obj, k2 = main_path("glass_bob_scene", glass_obj, camera, cfg)
    check(k1_obj > 0 and k2 == 0, "glass_bob_scene launched the resident kernel only")
    img_go2, n_go2 = render_with_stats(glass_obj, camera, cfg)
    check(n_go == n_go2 and torch.equal(img_go, img_go2),
          "glass_bob_scene renders twice bit-identically")
    del img_go, img_go2

    cfg10 = dataclasses.replace(cfg, max_depth=10)
    _, n_10, k1_10, k2 = main_path("mesh_scene depth 10", mesh, camera, cfg10)
    check(k1_10 > 0 and k2 == 0 and n_10 > n_m,
          f"mesh_scene at depth 10 launched the resident kernel only ({k1_10}), {n_10} rays "
          f"against {n_m} at depth {DEPTH}")

    for name, scene, img_b, n_b in (("mesh_scene", mesh, img_m, n_m),
                                    ("duplicated_mesh_scene(8)", x8, img_8, n_8),
                                    ("glass_mesh_scene", glass, img_g, n_g)):
        with list_policy(not sweep.INTERVAL_LISTS_ON_CUDA):
            img_a, n_a = render_with_stats(scene, camera, cfg)
        over = int(((img_a - img_b).abs().amax(-1) > IMAGE_TOL).sum())
        log(f"  {name}: the other list policy gives {over} pixels > {IMAGE_TOL}, rays {n_a} vs "
            f"{n_b}")
        check(over == 0 and n_a == n_b, f"{name}: both list policies render the same image")
    del img_a, img_b, img_m, img_8, img_g

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

    # full_primitive_scene's glass cylinder is a band a few pixels high whose
    # inner bounces sit at f32's resolution, so its f32 image is held to a
    # looser share of pixels and the f64 render on the card carries the check
    cfg_f = RenderConfig(max_depth=DEPTH)
    for dtype, tol, max_frac in ((torch.float64, 1e-6, 0.002), (torch.float32, GOLDEN_TOL,
                                                                GLASS_F32_FRAC)):
        full, cam_f = scenes.full_primitive_scene(dtype=dtype, device=dev)
        img_f, _ = render_with_stats(
            full, scenes.make_camera(cam_f, SIZE128, SIZE128, dtype=dtype, device=dev), cfg_f)
        want = OracleRenderer(full.to("cpu"), cfg_f).render(
            scenes.make_camera(cam_f, SIZE128, SIZE128, dtype=torch.float64, device="cpu"))
        err = np.abs(img_f.double().cpu().numpy() - want).max(axis=-1)
        frac = float((err > tol).mean())
        name = f"full_primitive_scene ({str(dtype).split('.')[-1]}, dielectric)"
        log(f"  {name} against the NumPy oracle: {int((err > tol).sum())} pixels > {tol} "
            f"({frac:.2e}), max {err.max():.3e}")
        check(frac <= max_frac, f"{name} within {max_frac} of pixels")

    phase("5 timing (CUDA events; information, not a benchmark)")

    def frame_time(name, scene, cam_f, reps):
        out = {}
        sweep.sweep.launches = sweep.sweep.stream_launches = 0
        ms = cuda_ms(lambda: out.update(r=render_with_stats(scene, cam_f, cfg)), reps=reps)
        n = out["r"][1]
        log(f"  {name}: {ms:.2f} ms/frame, {n} rays/frame, {n / ms / 1e3:.2f} Mrays/s; per frame "
            f"{sweep.sweep.launches // (reps + 1)} resident and "
            f"{sweep.sweep.stream_launches // (reps + 1)} streaming launches")

    frame_time("glass_bob_scene (mesh_scene's mesh from an OBJ)", glass_obj, camera, reps=3)
    frame_time("duplicated_serial_scene(8) (the same OBJ)", x8_obj, camera, reps=3)
    del glass, glass_obj, x8_obj
    k1_row = query_times("mesh_scene, resident kernel, 1080p primary", ro, rd, pack, cfg, False,
                         twin_reps=2)
    mask_row = mask_times("mesh_scene 1080p primary", ro, rd, pack, cfg)
    sweep.sweep.launches = sweep.sweep.stream_launches = sweep.mask_kernel.launches = 0
    level_kernels.hits_kernel.launches = level_kernels.shade_kernel.launches = 0
    raygen.raygen_kernel.launches = 0
    render_with_stats(mesh, camera, cfg10)
    raygen_launches = raygen.raygen_kernel.launches
    check(raygen_launches == 1, f"mesh_scene depth 10: {raygen_launches} raygen launches, one")
    mask_launches = sweep.mask_kernel.launches
    check(mask_launches == sweep.sweep.launches > 0,
          f"mesh_scene depth 10: {mask_launches} mask launches, one a sweep launch")
    level_launches = level_kernels.hits_kernel.launches, level_kernels.shade_kernel.launches
    check(level_launches == (11, 11),
          f"mesh_scene depth 10: {level_launches} level kernel launches, one of each a level")
    close = scenes.make_camera(dict(cam, position=CLOSE_POSITION), W, H, device=dev)
    level_rows = level_times("bob-close 1080p", mesh, close, cfg10, widest=False)
    glass_model = dataclasses.replace(mesh, tri_materials=Materials.full(
        mesh.n_triangles, device=dev, **GLASS_MODEL))
    glass_rows = level_times("glass model 1080p", glass_model, camera, cfg10, widest=True)
    raygen_row = raygen_times("1080p frame", camera)
    del close, glass_model
    k2_row = query_times("x8, streaming kernel, 1080p primary", ro, rd, pack8, cfg, True,
                         twin_reps=1)
    for label, pk, stream, refl, shad in (("mesh_scene, resident kernel,", pack, False,
                                           mesh_refl, mesh_shad),
                                          ("x8, streaming kernel,", pack8, True, x8_refl,
                                           x8_shad)):
        query_times(f"{label} reflection wavefront", *refl, pk, cfg, stream, twin_reps=0)
        query_times(f"{label} shadow wavefront", *shad, pk, cfg, stream, twin_reps=0,
                    any_mode=True)
    del mesh_refl, mesh_shad, x8_refl, x8_shad
    frame_time("duplicated_mesh_scene(8)", x8, camera, reps=3)
    del x8
    for copies in (4, 16):
        big, _ = scenes.duplicated_mesh_scene(copies, device=dev)
        big = accel.with_chunks(big, cfg)
        frame_time(f"duplicated_mesh_scene({copies})", big, camera, reps=3)
        del big

    def side_by_side(name, pk):
        ro32, rd32, chunk_list, entry, counts = sweep.sweep_inputs(ro, rd, pk, cfg)
        args = (ro32, rd32, pk.consts, pk.meta, chunk_list, counts, entry,
                float(cfg.det_epsilon), float(cfg.smallest_dist), False)
        ms = [cuda_ms(lambda s=s: sweep.sweep(*args, stream=s, lo=pk.lo, hi=pk.hi), reps=10)
              for s in (False, True, True, False)]
        log(f"  {name} ({pk.n_chunks} chunks of {pk.chunk_size}) 1080p primary closest query: "
            f"resident {ms[0]:.3f} and {ms[3]:.3f} ms, streaming {ms[1]:.3f} and {ms[2]:.3f} ms")

    x2, _ = scenes.duplicated_mesh_scene(2, device=dev)
    side_by_side("x2 scene", sweep.build_pack(accel.with_chunks(x2, cfg), cfg))
    side_by_side("x8 scene", pack8)

    phase("6 backward and train step")
    train_launches = backward_and_train(mesh, cam, camera, cfg, launches, card, dev)

    phase("7 progressive, sharded and apps")
    t7 = time.perf_counter()
    sweep.sweep.launches = sweep.sweep.stream_launches = 0
    img_m, _ = render_with_stats(mesh, camera, cfg)
    frame_m = (img_m, (sweep.sweep.launches, sweep.sweep.stream_launches))
    p7 = list(progressive_run("mesh_scene", mesh, camera, cfg, 120, frame_m, card))
    x8, _ = scenes.duplicated_mesh_scene(8, device=dev)
    x8 = accel.with_chunks(x8, cfg)
    sweep.sweep.launches = sweep.sweep.stream_launches = 0
    img_8, _ = render_with_stats(x8, camera, cfg)
    k = progressive_run("duplicated_mesh_scene(8)", x8, camera, cfg, 120,
                        (img_8, (sweep.sweep.launches, sweep.sweep.stream_launches)), card)
    p7 = [p7[0] + k[0], p7[1] + k[1]]
    del x8, img_8
    p7[0] += sharded_runs(mesh, camera, cfg, img_m, card)
    p7[0] += apps_runs(mesh, cam, cfg, dev, card)
    log(f"  phase 7: {time.perf_counter() - t7:.1f} s")

    phase("8 the bench (python -m realtrace_tpu_torch.apps.bench)")
    bench_launches = bench_run(card)

    phase("9 query modes and the chunked accel")
    k1_merged, k1_unmerged, k2_merged = query_modes(mesh, camera, cfg, dev, card)

    if failures:
        log(f"FAILED: {failures}")
        return 1
    log(f"  total {time.perf_counter() - t_start:.0f} s")
    log(card)
    log(json.dumps({"kernels": [
        {"name": "sweep", "route": "cuda", "source": "realtrace_tpu_torch/csrc/sweep.cu",
         "replaces": "realtrace_tpu/ops/pallas/trace.py:164", "launches": launches,
         "obj_scene_launches": k1_obj, "train_launches": train_launches[0],
         "phase7_launches": p7[0], "depth10_launches": k1_10,
         "bench_launches": bench_launches[0], "merged_launches": k1_merged,
         "unmerged_launches": k1_unmerged, "max_abs_err": max(errs), **k1_row},
        {"name": "sweep_stream", "route": "cuda",
         "source": "realtrace_tpu_torch/csrc/sweep_stream.cu",
         "replaces": "realtrace_tpu/ops/pallas/trace.py:228", "launches": stream_launches,
         "obj_scene_launches": k2_obj, "train_launches": train_launches[1],
         "phase7_launches": p7[1], "depth10_launches": 0, "bench_launches": bench_launches[1],
         "merged_launches": k2_merged, "unmerged_launches": 0, "max_abs_err": max(errs_stream),
         **k2_row},
        {"name": "chunk_mask", "route": "cuda", "source": "realtrace_tpu_torch/csrc/chunk_mask.cu",
         "replaces": "realtrace_tpu/ops/pallas/trace.py:_chunk_mask, _compact_front_to_back "
                     "(XLA code, no Pallas kernel)",
         "depth10_launches": mask_launches, "max_abs_err": 0.0, **mask_row},
        *({"name": row_name, "route": "cuda", "source": "realtrace_tpu_torch/csrc/level.cu",
           "replaces": f"no TPU kernel: XLA code of {what}", "depth10_launches": launched,
           "max_abs_err": 0.0, **row, "glass": glass_row}
          for row_name, what, launched, row, glass_row in zip(
              ("level_hits", "level_shade"),
              ("realtrace_tpu/ops/intersect.py::hit_attributes",
               "realtrace_tpu/render/shade.py (child geometry and colour of a level)"),
              level_launches, level_rows, glass_rows)),
        {"name": "raygen", "route": "cuda", "source": "realtrace_tpu_torch/csrc/level.cu",
         "replaces": "no TPU kernel: XLA code of realtrace_tpu/render/pipeline.py::_tiled_rays",
         "depth10_launches": raygen_launches, "max_abs_err": 0.0, **raygen_row}]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
