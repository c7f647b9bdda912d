"""Progressive, resumable rendering: the serial engine's column-cursor loop
(``RenderEngine::renderLoop`` renders one column per idle tick and keeps a
static cursor, Serial/renderengine.cpp:10-26).

Counterpart of ``realtrace_tpu/render/progressive.py``. The unit is a band of
pixel rows, rendered through the tile-major wavefront (32x32 pixel tiles, pad
slots parked) so the sweep kernels' warps see compact rays. The cursor and the
partial framebuffer can be saved and loaded in the JAX package's npz format
(``cursor``, ``buffer`` float32), so a render started by either package
resumes in the other.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
from torch import Tensor

from realtrace_tpu_torch.core.types import RenderConfig, Scene
from realtrace_tpu_torch.render.camera import Camera
from realtrace_tpu_torch.render.pipeline import render_tile_buffer


class ProgressiveRenderer:
    """Renders ``band`` pixel rows per ``step()``; ``done`` once the cursor
    reaches the top (renderLoop's True return). The buffer is a float32
    (H, W, 3) tensor on the scene's device, rows from the bottom, each band
    clamped to [0, 1]. ``rays`` counts the rays this renderer traced (not
    saved: a resumed render counts its own)."""

    def __init__(self, scene: Scene, camera: Camera, cfg: RenderConfig, band: int = 64):
        if camera.height % band:
            raise ValueError(f"height {camera.height} not divisible by band {band}")
        self.scene = scene
        self.camera = camera
        self.cfg = cfg
        self.band = band
        self.cursor = 0
        self.rays = 0
        self.device = scene.tri_vertices.device
        self.buffer = torch.zeros((camera.height, camera.width, 3), dtype=torch.float32,
                                  device=self.device)

    @property
    def done(self) -> bool:
        return self.cursor >= self.camera.height

    def step(self) -> bool:
        """Render the next band; returns True when the image is complete."""
        if self.done:
            return True
        w, j0 = self.camera.width, self.cursor
        with torch.no_grad():
            buf, nrays = render_tile_buffer(self.scene, self.camera, self.cfg, 0, j0, w,
                                            self.band)
        self.rays += nrays
        self.buffer[j0:j0 + self.band] = torch.clamp(buf.reshape(self.band, w, 3), 0.0, 1.0)
        self.cursor += self.band
        return self.done

    def render_all(self) -> Tensor:
        while not self.step():
            pass
        return self.image()

    def image(self) -> Tensor:
        """Top-down image of everything rendered so far."""
        return torch.flip(self.buffer, dims=(0,))

    def save(self, path: str | Path) -> None:
        np.savez(path, cursor=self.cursor, buffer=self.buffer.cpu().numpy())

    def load(self, path: str | Path) -> None:
        d = np.load(path)
        self.cursor = int(d["cursor"])
        self.buffer = torch.as_tensor(d["buffer"], dtype=torch.float32, device=self.device).clone()
