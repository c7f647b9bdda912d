"""ctypes binding for the native OBJ parser (``realtrace_tpu_torch/csrc/objloader.cpp``).

Counterpart of ``realtrace_tpu/io/native_obj.py``. The shared library is
built with ``g++`` on first use into ``csrc/build/``, named by a hash of the
source and flags, through a temporary file and ``os.replace``, so processes
that build at once (test workers, ranks) never load a half-written library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCE = CSRC / "objloader.cpp"
BUILD_DIR = CSRC / "build"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lib: ctypes.CDLL | None = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode() + SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"librtobj_{h}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *FLAGS, str(SOURCE), "-o", str(tmp)], check=True,
                       capture_output=True)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)


def load() -> ctypes.CDLL:
    """The parser library, built first if this version is not built yet."""
    global _lib
    if _lib is not None:
        return _lib
    out = library_path()
    if not out.exists():
        _build(out)
    lib = ctypes.CDLL(str(out))
    lib.rt_obj_parse.restype = ctypes.c_void_p
    lib.rt_obj_parse.argtypes = [ctypes.c_char_p]
    lib.rt_obj_counts.restype = None
    lib.rt_obj_counts.argtypes = [ctypes.c_void_p] + [ctypes.POINTER(ctypes.c_int64)] * 4
    lib.rt_obj_copy.restype = None
    lib.rt_obj_copy.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 5
    lib.rt_obj_free.restype = None
    lib.rt_obj_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def parse(path):
    """Parse an OBJ file natively: (vertices (V,3) f64, normals (VN,3) f64,
    uvs (T,2) f64, faces_v (F,3) i32, faces_t (F,3) i32). Raises on a
    missing file or a failed build."""
    lib = load()
    h = lib.rt_obj_parse(str(path).encode())
    if not h:
        raise FileNotFoundError(path)
    try:
        nv, nvn, nvt, nf = (ctypes.c_int64() for _ in range(4))
        lib.rt_obj_counts(h, ctypes.byref(nv), ctypes.byref(nvn), ctypes.byref(nvt),
                          ctypes.byref(nf))
        v = np.empty((nv.value, 3), np.float64)
        vn = np.empty((nvn.value, 3), np.float64)
        vt = np.empty((nvt.value, 2), np.float64)
        fv = np.empty((nf.value, 3), np.int32)
        ft = np.empty((nf.value, 3), np.int32)
        lib.rt_obj_copy(h, *(a.ctypes.data_as(ctypes.c_void_p) for a in (v, vn, vt, fv, ft)))
        return v, vn, vt, fv, ft
    finally:
        lib.rt_obj_free(h)
