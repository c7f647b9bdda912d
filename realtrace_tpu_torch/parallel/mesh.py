"""Multi-GPU parallelism: pixel-tile sharding over ``torch.distributed``.

Counterpart of ``realtrace_tpu/parallel/mesh.py``: the image plane is split
into a (ty, tx) grid of pixel tiles, one per rank (one process per rank, each
with the whole scene); the forward render needs no collective until the tiles
are gathered, and the inverse-rendering step all-reduces the scene-parameter
gradients (one flattened buffer) and the loss.

Every collective runs on the tensors' own device: NCCL for ranks on distinct
cards, gloo for ranks on the CPU or for several ranks that share one card
(NCCL refuses two ranks on the same GPU). The backend is the caller's choice.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import os

import numpy as np
import torch
import torch.distributed as dist
from torch import Tensor

from realtrace_tpu_torch.core.types import (DIFF_FIELDS, RenderConfig, Scene, default_device,
                                            map_tensors)
from realtrace_tpu_torch.diff.inverse import (OptimizerFactory, _fill_zero_grads, apply_params,
                                              trainable)
from realtrace_tpu_torch.ops import accel
from realtrace_tpu_torch.render.camera import Camera
from realtrace_tpu_torch.render.pipeline import render_tile_buffer

DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (ty, tx) grid of ranks over the image plane, and this rank's cell
    (iy, ix) = divmod(rank, tx)."""

    ty: int
    tx: int
    iy: int = 0
    ix: int = 0

    @property
    def size(self) -> int:
        return self.ty * self.tx


def make_mesh(n_devices: int | None = None, shape: tuple[int, int] | None = None) -> Mesh:
    """A (ty, tx) mesh over ``n_devices`` ranks (default: the world size),
    ty the largest factor of n at or below sqrt(n), as the JAX package picks
    it. Inside a process group, n must be the world size; without one this
    process is rank 0."""
    world, rank = (dist.get_world_size(), dist.get_rank()) if dist.is_initialized() else (1, 0)
    n = n_devices or (shape[0] * shape[1] if shape else world)
    if dist.is_initialized() and n != world:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}")
    if shape is None:
        ty = next(f for f in range(math.isqrt(n), 0, -1) if n % f == 0)
        shape = (ty, n // ty)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} does not hold {n} ranks")
    iy, ix = divmod(rank, shape[1])
    return Mesh(shape[0], shape[1], iy, ix)


def _tile_dims(camera: Camera, mesh: Mesh) -> tuple[int, int]:
    if camera.height % mesh.ty or camera.width % mesh.tx:
        raise ValueError(f"image {camera.height}x{camera.width} not divisible by mesh "
                         f"{mesh.ty}x{mesh.tx}")
    return camera.height // mesh.ty, camera.width // mesh.tx


def _check_group(mesh: Mesh) -> None:
    if mesh.size > 1 and not dist.is_initialized():
        raise RuntimeError(f"a {mesh.ty}x{mesh.tx} mesh needs a process group "
                           "(init_distributed)")


def _local_buffer(scene: Scene, camera: Camera, cfg: RenderConfig, mesh: Mesh) -> Tensor:
    """This rank's pixel tile as (tile_h, tile_w, 3), rows from the bottom,
    unclamped, through the tile-major wavefront."""
    th, tw = _tile_dims(camera, mesh)
    buf, _ = render_tile_buffer(scene, camera, cfg, mesh.ix * tw, mesh.iy * th, tw, th)
    return buf.reshape(th, tw, 3)


def sharded_render(scene: Scene, camera: Camera, cfg: RenderConfig, mesh: Mesh) -> Tensor:
    """Full-frame render with pixel tiles sharded over the ranks: each rank
    renders its tile, the tiles are all-gathered, and every rank returns the
    top-down (H, W, 3) image clamped to [0, 1]."""
    _tile_dims(camera, mesh)
    _check_group(mesh)
    with torch.no_grad():
        local = _local_buffer(scene, camera, cfg, mesh).contiguous()
    if dist.is_initialized():
        tiles = [torch.empty_like(local) for _ in range(mesh.size)]
        dist.all_gather(tiles, local)
    else:
        tiles = [local]
    rows = [torch.cat(tiles[r * mesh.tx:(r + 1) * mesh.tx], dim=1) for r in range(mesh.ty)]
    buf = torch.cat(rows, dim=0)
    return torch.clamp(torch.flip(buf, dims=(0,)), 0.0, 1.0)


def _all_reduce(x: Tensor) -> Tensor:
    """The sum of ``x`` over the ranks, in place; ``x`` without a group."""
    if dist.is_initialized():
        dist.all_reduce(x, op=dist.ReduceOp.SUM)
    return x


def make_sharded_train_step(scene: Scene, camera: Camera, cfg: RenderConfig,
                            target_image: Tensor, mesh: Mesh, lr: float = 1e-2,
                            fields=DIFF_FIELDS, resort_chunks: bool | None = None,
                            optimizer: OptimizerFactory | None = None):
    """Sharded inverse rendering: ``(step, params, optimizer)`` as
    ``diff.inverse.make_train_step`` returns them.

    Each step renders this rank's tile, takes the local loss
    sum((tile - target_tile)^2) / (H*W*3) and its gradients, all-reduces the
    gradients (flattened into one buffer) and the loss, then steps the
    optimizer (``make_train_step``'s ``optimizer`` and ``lr``) on every rank
    alike; ``step()`` returns the reduced loss. ``target_image`` is the top-down (H, W, 3)
    goal. ``resort_chunks`` (default: on when ``tri_vertices`` trains with an
    accel other than brute force) rebuilds the chunk ordering every step; the rebuild is
    deterministic on identical parameters, so the ranks stay bit-identical
    without another collective. ``step.loss_and_grad()`` returns the reduced
    (loss, gradients) at the current parameters without stepping.
    """
    th, tw = _tile_dims(camera, mesh)
    _check_group(mesh)
    denom = float(camera.height * camera.width * 3)
    if not isinstance(target_image, Tensor):
        target_image = torch.from_numpy(np.ascontiguousarray(target_image))
    target = torch.flip(target_image, dims=(0,))   # rows from the bottom
    tgt = target[mesh.iy * th:(mesh.iy + 1) * th, mesh.ix * tw:(mesh.ix + 1) * tw]
    tgt = tgt.to(device=scene.tri_vertices.device, dtype=scene.dtype)
    if resort_chunks is None:
        resort_chunks = "tri_vertices" in fields and cfg.accel != "bruteforce"
    params, leaves, optimizer = trainable(scene, fields, optimizer, lr)

    def local_loss() -> Tensor:
        s = apply_params(scene, params)
        if resort_chunks and s.n_triangles:
            s = accel.resort_chunks(s, cfg)
        return torch.sum((_local_buffer(s, camera, cfg, mesh) - tgt) ** 2) / denom

    def backward() -> Tensor:
        """The local loss's gradients in the leaves' ``grad``, all-reduced as
        one flat buffer; returns the reduced loss."""
        optimizer.zero_grad(set_to_none=True)
        loss = local_loss()
        loss.backward()
        _fill_zero_grads(leaves)
        flat = _all_reduce(torch.cat([p.grad.reshape(-1) for p in leaves]))
        for p, g in zip(leaves, torch.split(flat, [p.numel() for p in leaves])):
            p.grad = g.reshape(p.shape)
        return _all_reduce(loss.detach().reshape(1))[0]

    def step() -> Tensor:
        loss = backward()
        optimizer.step()
        return loss

    def loss_and_grad():
        loss = backward()
        grads = map_tensors(lambda p: p.grad, params)
        optimizer.zero_grad(set_to_none=True)
        return loss, grads

    step.loss_and_grad = loss_and_grad
    return step, params, optimizer


def replicate_scene(scene: Scene, mesh: Mesh) -> Scene:
    """Every scene tensor broadcast from rank 0 (the analog of the one-time
    cudaMemcpy scene upload, Parellel/main.cu:228-241); the scene itself
    without a process group."""
    _check_group(mesh)
    if not dist.is_initialized():
        return scene

    def bcast(x):
        if not isinstance(x, Tensor):
            return x
        x = x.detach().clone().contiguous()
        dist.broadcast(x, src=0)
        return x

    kw = {}
    for f in dataclasses.fields(scene):
        v = getattr(scene, f.name)
        kw[f.name] = map_tensors(bcast, v) if dataclasses.is_dataclass(v) else bcast(v)
    return dataclasses.replace(scene, **kw)


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, backend: str | None = None,
                     device=None, timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> torch.device:
    """Join the process group; returns this rank's device.

    ``coordinator`` ("host:port") gives ``tcp://coordinator`` with
    ``num_processes`` and ``process_id``; without it the rendezvous is
    ``env://`` (torchrun's variables). The device is the card (``cuda:k``,
    k = LOCAL_RANK modulo the cards visible) unless ``device`` names another;
    the backend defaults to NCCL on a card and gloo on the CPU. ``timeout``
    bounds every collective, so a lost peer fails the run instead of hanging
    it."""
    dev = default_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", process_id or 0))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if coordinator is not None:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id, timeout=timeout)
    else:
        dist.init_process_group(backend, init_method="env://", timeout=timeout)
    return dev
