"""Image IO: PNG save / load (numpy only; replaces DevIL,
Serial/lumina.cpp:424-456).

PIL when it is installed, otherwise a dependency-free PNG writer (zlib is in
the standard library).
"""
from __future__ import annotations

import struct
import time
import zlib
from pathlib import Path

import numpy as np

try:
    from PIL import Image as _PILImage
except ImportError:  # pragma: no cover
    _PILImage = None


def to_uint8(img) -> np.ndarray:
    """[0,1] float (H,W,3) → uint8, the reference's 255*c quantization
    (Serial/camera.cpp:46-52)."""
    return np.clip(np.asarray(img, np.float64) * 255.0, 0, 255).astype(np.uint8)


def save_png(path: str | Path, img) -> Path:
    """Save a float [0,1] or uint8 (H,W,3) array (or CPU tensor) as PNG."""
    path = Path(path)
    a = np.asarray(img)
    if a.dtype != np.uint8:
        a = to_uint8(a)
    if _PILImage is not None:
        _PILImage.fromarray(a, "RGB").save(path)
    else:
        _write_png_pure(path, a)
    return path


def save_timestamped_png(img, prefix: str = "RealTraceTPU", directory: str | Path = ".") -> Path:
    """Save under a timestamped name, ``"<prefix> Mon Jan 05 14-03-09 2026.png"``
    in ``directory``: the ``SaveImage`` analog (Serial/lumina.cpp:424-439)."""
    name = f"{prefix} {time.strftime('%a %b %d %H-%M-%S %Y')}.png"
    return save_png(Path(directory) / name, img)


def load_png(path: str | Path) -> np.ndarray:
    """Load an image file to float64 RGB in [0,1]."""
    if _PILImage is None:  # pragma: no cover
        raise RuntimeError("PNG loading requires PIL")
    return np.asarray(_PILImage.open(path).convert("RGB"), np.float64) / 255.0


def _write_png_pure(path: Path, rgb: np.ndarray) -> None:
    """Minimal valid PNG writer (8-bit RGB, no interlace)."""
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                     + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
