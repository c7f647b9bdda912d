"""Build and load the package's CUDA kernels (``realtrace_tpu_torch/csrc/*.cu``,
with their shared headers ``*.cuh``).

The sources are compiled with ``nvcc`` (one process per source, all started
together) and linked into one shared library with a plain C interface,
loaded with ``ctypes``. The build runs on first use, goes to ``csrc/build/``
(keyed by a hash of the sources, headers and flags, so an edit rebuilds) and
is cached for the process. A missing ``nvcc`` or a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib: ctypes.CDLL | None = None
build_info: dict = {}   # {"library", "seconds", "log"} of this process's load


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_double
    # ro rd consts meta lo hi chunk_list counts entry out_t out_i tested |
    # nt m c det_eps t_min any_mode device | stream
    for fn in (lib.rt_sweep, lib.rt_sweep_stream):
        fn.argtypes = [p] * 12 + [i, i, i, f64, f64, i, i, p]
        fn.restype = i
    # ro rd lo hi chunk_list entry counts | nt m device | stream
    lib.rt_chunk_mask.argtypes = [p] * 7 + [i, i, i, p]
    lib.rt_chunk_mask.restype = i
    # ro rd fam idx perm | n_perm | tv tc ka kd ks kr kt eta out index valid | n device | stream
    lib.rt_level_hits.argtypes = [p] * 5 + [i] + [p] * 11 + [i, i, p]
    lib.rt_level_hits.restype = i
    # ro rd coeff valid t pos nrm col ka kd ks kr kt eta occ lp li | n_lights | ambient
    # background | phong_exp legacy_diffuse | blend keep ray_offset neg_sigma x3 | branching
    # miss_background last | contrib child | n device | stream
    lib.rt_level_shade.argtypes = ([p] * 17 + [i] + [p] * 2 + [i] * 2 + [f32] * 6 + [i] * 3
                                   + [p] * 2 + [i, i, p])
    lib.rt_level_shade.restype = i
    # position target up fovy | width height | aspect half_w half_h deg | i0 j0 tile_w tile_h
    # tiles_x | park | ro rd coeff | n device | stream
    lib.rt_raygen.argtypes = [p] * 4 + [i] * 2 + [f32] * 4 + [i] * 5 + [f32] + [p] * 3 + [i, i, p]
    lib.rt_raygen.restype = i
    lib.rt_error_string.argtypes = [i]
    lib.rt_error_string.restype = ctypes.c_char_p


def load() -> ctypes.CDLL:
    """The kernel library, built from the sources if this version is not
    built yet."""
    global _lib
    if _lib is not None:
        return _lib
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sorted([*sources, *CSRC.glob("*.cuh")]):   # headers rebuild too
        h.update(s.name.encode())
        h.update(s.read_bytes())
    out = BUILD_DIR / f"librt_kernels_{h.hexdigest()[:16]}.so"
    t0 = time.perf_counter()
    log = ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        objs = [tmp.with_name(f"{tmp.name}.{s.stem}.o") for s in sources]
        cmds = [[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(s)] for s, o in zip(sources, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        cmds.append([_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)])
        try:
            outs = [p.communicate()[0] for p in procs]
            link = subprocess.run(cmds[-1], capture_output=True, text=True)
            log = "".join(outs) + link.stdout + link.stderr
            rcs = [p.returncode for p in procs] + [link.returncode]
            if any(rcs):
                bad = [" ".join(c) for c, rc in zip(cmds, rcs) if rc]
                raise RuntimeError(f"nvcc failed {rcs}:\n" + "\n".join(bad) + f"\n{log}")
            os.replace(tmp, out)
        finally:
            for o in objs:
                o.unlink(missing_ok=True)
    lib = ctypes.CDLL(str(out))
    _declare(lib)
    build_info.update(library=str(out), seconds=time.perf_counter() - t0, log=log)
    _lib = lib
    return lib


def error_string(code: int) -> str:
    return load().rt_error_string(code).decode()
