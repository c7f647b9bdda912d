"""Pinhole camera as a small dataclass of tensors.

Counterpart of ``realtrace_tpu/render/camera.py`` (Ref: Serial/camera.cpp).
The whole image's ray directions come out as one dense ``(R, 3)`` batch.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import Tensor

from realtrace_tpu_torch.core import vec
from realtrace_tpu_torch.core.types import default_device


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
        device = default_device(device)

        def t(x):
            return torch.as_tensor(x, dtype=dtype, device=device)
        return Camera(position=t(position), target=t(target), up=t(up), fovy=t(fovy),
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
        xw = aspect * (torch.as_tensor(i_idx, device=dev).to(dt) - self.width / 2.0 + 0.5) / self.width
        yw = (torch.as_tensor(j_idx, device=dev).to(dt) - self.height / 2.0 + 0.5) / self.height
        d = (-w)[None, :] * focal + u[None, :] * xw[:, None] + v[None, :] * yw[:, None]
        return vec.normalize(d)


def image_from_buffer(buf: Tensor, camera: Camera) -> Tensor:
    """Flat (H*W, 3) buffer → top-down (H, W, 3) image (the reference bitmap
    stores row j from the bottom, Serial/camera.cpp:46-52)."""
    return torch.flip(buf.reshape(camera.height, camera.width, 3), dims=(0,))
