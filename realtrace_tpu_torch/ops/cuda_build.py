"""Build and load the package's CUDA kernels (``realtrace_tpu_torch/csrc/*.cu``).

The sources are compiled with ``nvcc`` into one shared library with a plain
C interface and loaded with ``ctypes``. The build runs on first use, goes to
``csrc/build/`` (keyed by a hash of the sources and flags, so an edit
rebuilds) and is cached for the process. A missing ``nvcc`` or a failed
build raises.
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
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None
build_info: dict = {}   # {"library", "seconds", "log"} of this process's load


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    # ro rd consts meta chunk_list counts entry out_t out_i | nt m c det_eps
    # t_min any_mode device | stream
    lib.rt_sweep.argtypes = [p] * 9 + [i, i, i, f64, f64, i, i, p]
    lib.rt_sweep.restype = i
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
    for s in sources:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    out = BUILD_DIR / f"librt_kernels_{h.hexdigest()[:16]}.so"
    t0 = time.perf_counter()
    log = ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    _declare(lib)
    build_info.update(library=str(out), seconds=time.perf_counter() - t0, log=log)
    _lib = lib
    return lib


def error_string(code: int) -> str:
    return load().rt_error_string(code).decode()
