"""Pinhole camera as a small dataclass of tensors, and the interactive orbit
camera.

Counterpart of ``realtrace_tpu/render/camera.py`` (Ref: Serial/camera.cpp,
Parellel/interactive_camera.cu). The whole image's ray directions come out as
one dense ``(R, 3)`` batch.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import Tensor

from realtrace_tpu_torch.core import vec
from realtrace_tpu_torch.core.types import default_device
from realtrace_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole camera. Basis math mirrors Serial/camera.cpp:4-25."""

    position: Tensor  # (3,)
    target: Tensor    # (3,)
    up: Tensor        # (3,)
    fovy: Tensor      # () degrees, angular extent of the image height
    width: int = 512
    height: int = 512

    @staticmethod
    def make(position, target, up, fovy, width, height, dtype=torch.float32,
             device=None) -> "Camera":
        """The camera's ten numbers, each rounded to ``dtype`` as
        ``torch.as_tensor`` rounds it, go to ``device`` in one copy;
        ``position``, ``target``, ``up`` and ``fovy`` are views of it."""
        device = default_device(device)
        host = torch.cat([torch.as_tensor(x, dtype=dtype, device="cpu").reshape(-1)
                          for x in (position, target, up, fovy)])
        if host.shape != (10,):
            raise ValueError(f"Camera.make: {host.shape[0]} numbers, want position, target "
                             "and up of 3 and one fovy")
        with span("rt.p.sync.camera"):
            buf = host.to(device)
        return Camera(position=buf[0:3], target=buf[3:6], up=buf[6:9], fovy=buf[9],
                      width=int(width), height=int(height))

    def to(self, device) -> "Camera":
        return dataclasses.replace(self, position=self.position.to(device),
                                   target=self.target.to(device), up=self.up.to(device),
                                   fovy=self.fovy.to(device))

    def basis(self):
        """(u, v, w): the camera looks down -w. Ref: Serial/camera.cpp:10-18."""
        up = vec.normalize(self.up)
        w = vec.normalize(self.position - self.target)
        u = vec.normalize(vec.cross(up, w))
        v = vec.normalize(vec.cross(w, u))
        return u, v, w

    def _focal(self):
        return 1.0 / (2.0 * torch.tan(self.fovy * (math.pi / 180.0) / 2.0))

    def ray_directions(self) -> Tensor:
        """All pixel ray directions as (H*W, 3); pixel index = i + j*W with
        i = column, j = row from the bottom. Ref: Serial/camera.cpp:33-52."""
        dt, dev = self.position.dtype, self.position.device
        u, v, w = self.basis()
        aspect = self.width / self.height
        focal = self._focal()
        i = torch.arange(self.width, dtype=dt, device=dev)
        j = torch.arange(self.height, dtype=dt, device=dev)
        xw = aspect * (i - self.width / 2.0 + 0.5) / self.width
        yw = (j - self.height / 2.0 + 0.5) / self.height
        d = ((-w)[None, None, :] * focal
             + u[None, None, :] * xw[None, :, None]
             + v[None, None, :] * yw[:, None, None])
        return vec.normalize(d).reshape(-1, 3)

    def ray_directions_at(self, i_idx, j_idx) -> Tensor:
        """Ray directions for explicit pixel coordinates (``i_idx`` columns,
        ``j_idx`` rows from the bottom, each (R,)). Same formula as
        ``ray_directions``."""
        dt, dev = self.position.dtype, self.position.device
        u, v, w = self.basis()
        aspect = self.width / self.height
        focal = self._focal()
        with span("rt.p.sync.raygen"):
            i_idx, j_idx = torch.as_tensor(i_idx, device=dev), torch.as_tensor(j_idx, device=dev)
        xw = aspect * (i_idx.to(dt) - self.width / 2.0 + 0.5) / self.width
        yw = (j_idx.to(dt) - self.height / 2.0 + 0.5) / self.height
        d = (-w)[None, :] * focal + u[None, :] * xw[:, None] + v[None, :] * yw[:, None]
        return vec.normalize(d)

    def ray_directions_tile(self, i0: int, j0: int, tile_w: int, tile_h: int) -> Tensor:
        """Ray directions of the pixel tile [i0, i0+tile_w) x [j0, j0+tile_h)
        as (tile_h*tile_w, 3), row-major: ``ray_directions_at`` on the offset
        indices, so a tile's rays equal the full frame's for the same pixels,
        bit for bit."""
        jj, ii = torch.meshgrid(torch.arange(j0, j0 + tile_h), torch.arange(i0, i0 + tile_w),
                                indexing="ij")
        return self.ray_directions_at(ii.reshape(-1), jj.reshape(-1))


def image_from_buffer(buf: Tensor, camera: Camera) -> Tensor:
    """Flat (H*W, 3) buffer → top-down (H, W, 3) image (the reference bitmap
    stores row j from the bottom, Serial/camera.cpp:46-52)."""
    return torch.flip(buf.reshape(camera.height, camera.width, 3), dims=(0,))


@dataclasses.dataclass
class InteractiveCamera:
    """Orbit camera: yaw/pitch/radius around a center point, a plain-Python
    state machine (Parellel/interactive_camera.cu). ``build_render_camera``
    turns the spherical coordinates into a pinhole ``Camera`` each frame
    (ref :64-81); it drives the flythrough and the viewer."""

    center: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    yaw: float = 0.0
    pitch: float = 0.3
    radius: float = 10.0
    aperture_radius: float = 0.04
    resolution: tuple = (512, 512)
    fov_x: float = 45.0

    # controls (ref Parellel/interactive_camera.cu:21-46)
    def change_yaw(self, m: float):
        self.yaw = (self.yaw + m) % (2.0 * math.pi)

    def change_pitch(self, m: float):
        pad = 0.05
        self.pitch = float(np.clip(self.pitch + m, -(math.pi / 2) + pad, (math.pi / 2) - pad))

    def change_radius(self, m: float):
        self.radius = float(np.clip(self.radius * (1.0 + m), 0.2, 100.0))

    def change_altitude(self, m: float):
        self.center = self.center + np.array([0.0, m, 0.0])

    def change_aperture_diameter(self, m: float):
        self.aperture_radius = float(np.clip(
            self.aperture_radius + (self.aperture_radius + 0.01) * m, 0.0, 25.0))

    @property
    def fov_y(self) -> float:
        """Vertical FOV from the horizontal one (ref setFOVX, :58-61)."""
        rx, ry = self.resolution
        return math.degrees(2.0 * math.atan(math.tan(math.radians(self.fov_x) * 0.5) * (ry / rx)))

    def build_render_camera(self, dtype=torch.float32, device=None) -> Camera:
        """Spherical coordinates to the eye position (ref buildRenderCamera,
        :64-81); the look-at point is eye + view direction. On the card
        unless ``device`` names another."""
        d = np.array([math.sin(self.yaw) * math.cos(self.pitch),
                      math.sin(self.pitch),
                      math.cos(self.yaw) * math.cos(self.pitch)])
        eye = self.center + d * self.radius
        return Camera.make(eye, eye - d, (0.0, 1.0, 0.0), self.fov_y,
                           self.resolution[0], self.resolution[1], dtype=dtype, device=device)


def mouse_drag(cam: InteractiveCamera, button: str, dx: float, dy: float) -> None:
    """GLUT mouse-motion semantics (ref Parellel/interactions.cu:27-57): left
    drag = yaw/pitch, middle = altitude, right = radius."""
    scale = 0.005
    if button == "left":
        cam.change_yaw(-dx * scale)
        cam.change_pitch(-dy * scale)
    elif button == "middle":
        cam.change_altitude(-dy * scale * 10.0)
    elif button == "right":
        cam.change_radius(-dy * scale)
