"""Differentiable and inverse rendering: gradients of a pixel loss with
respect to scene parameters, and the optimisation step that is this
renderer's training.

Counterpart of ``realtrace_tpu/diff/inverse.py``. Gradients flow to vertex
positions, per-vertex colours, materials and lights; discrete visibility (hit
selection, shadowing) is held fixed inside the queries. Parameters are a dict
of the scene's differentiable fields: tensors, and ``Materials`` / ``Lights``
dataclasses of tensors, which ``apply_params`` puts back into the scene as
they are, so gradients reach the very leaf tensors an optimiser updates.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch import Tensor

from realtrace_tpu_torch.core.types import (DIFF_FIELDS, RenderConfig, Scene, map_tensors,
                                            tensor_leaves)
from realtrace_tpu_torch.ops import accel
from realtrace_tpu_torch.render.camera import Camera
from realtrace_tpu_torch.render.pipeline import render_buffer
from realtrace_tpu_torch.utils.profiling import span

__all__ = ["DIFF_FIELDS", "OptimizerFactory", "apply_params", "image_grad", "make_train_step",
           "render_loss", "scene_params"]


def scene_params(scene: Scene, fields=DIFF_FIELDS) -> dict:
    """The differentiable fields of a scene, as a dict of the scene's own
    tensors in ``DIFF_FIELDS`` order (whatever the order of ``fields``), the
    leaf order of the optimiser and of checkpoints."""
    unknown = set(fields) - set(DIFF_FIELDS)
    if unknown:
        raise ValueError(f"not differentiable scene fields: {sorted(unknown)}")
    return {f: getattr(scene, f) for f in DIFF_FIELDS if f in fields}


def apply_params(scene: Scene, params: dict) -> Scene:
    """The scene with ``params`` written back into its fields."""
    return dataclasses.replace(scene, **params)


def render_loss(params: dict, scene: Scene, camera: Camera, cfg: RenderConfig, target: Tensor,
                resort: bool = False) -> Tensor:
    """Mean squared error of the *unclamped* linear render against
    ``target`` (the clamp is a display transform, Serial/renderengine.cpp:15-17,
    and would kill the gradients of saturated pixels). ``resort`` rebuilds
    the chunk ordering from the current vertices first (any accel but brute
    force), so a train loop that moves vertices keeps its chunks tight."""
    s = apply_params(scene, params)
    if resort and cfg.accel != "bruteforce" and s.n_triangles:
        s = accel.resort_chunks(s, cfg)
    buf = render_buffer(s, camera, cfg)
    return torch.mean((buf - target.reshape(-1, 3)) ** 2)


def _fill_zero_grads(leaves: list[Tensor]) -> None:
    """Give every leaf the autograd left without a gradient a zero one, as
    JAX's gradients are (optax then steps every leaf, and so does Adam)."""
    for p in leaves:
        p.grad = _or_zeros(p.grad, p)


OptimizerFactory = Callable[[list[Tensor]], torch.optim.Optimizer]


def trainable(scene: Scene, fields, optimizer: OptimizerFactory | None, lr: float):
    """``(params, leaves, optimizer)`` of a train step: fresh leaf tensors
    (copies of the scene's fields, with ``requires_grad``), their flat list,
    and ``optimizer(leaves)``; by default ``torch.optim.Adam`` at
    optax.adam's defaults (b1 0.9, b2 0.999, eps 1e-8 added outside the
    square root) with rate ``lr``."""
    params = map_tensors(lambda x: x.detach().clone().requires_grad_(True),
                         scene_params(scene, fields))
    leaves = tensor_leaves(params)
    if optimizer is None:
        return params, leaves, torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    return params, leaves, optimizer(leaves)


def make_train_step(scene: Scene, camera: Camera, cfg: RenderConfig, target: Tensor,
                    lr: float = 1e-2, fields=DIFF_FIELDS, resort_chunks: bool | None = None,
                    optimizer: OptimizerFactory | None = None):
    """Inverse rendering: ``(step, params, optimizer)``.

    ``params`` holds fresh leaf tensors (copies of the scene's fields, with
    ``requires_grad``) and ``optimizer`` is what the factory ``optimizer``
    makes of their list (the counterpart of the JAX package's optax
    argument), by default a ``torch.optim.Adam`` at rate ``lr`` with
    optax.adam's defaults. ``step()`` runs one forward, ``loss.backward()``
    and ``optimizer.step()``, updates ``params`` in place and returns the
    loss (a tensor; reading it syncs the host). ``target`` is the flat or
    (H, W, 3) goal buffer in linear colour, bottom-up as ``render_buffer``.

    ``resort_chunks`` (default: on exactly when ``tri_vertices`` is trained
    with an accel other than brute force) rebuilds the chunk ordering every
    step, as the JAX package does.
    """
    params, leaves, optimizer = trainable(scene, fields, optimizer, lr)
    tgt = target.reshape(-1, 3)
    if resort_chunks is None:
        resort_chunks = "tri_vertices" in fields and cfg.accel != "bruteforce"

    def step() -> Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = render_loss(params, scene, camera, cfg, tgt, resort=resort_chunks)
        with span("rt.p.backward"):
            loss.backward()
        _fill_zero_grads(leaves)
        with span("rt.p.adam"):
            optimizer.step()
        return loss.detach()

    return step, params, optimizer


def image_grad(scene: Scene, camera: Camera, cfg: RenderConfig,
               loss_fn: Callable[[Tensor], Tensor] | None = None,
               fields=DIFF_FIELDS) -> tuple[Tensor, dict]:
    """``(loss, grads)`` of an image functional of the flat unclamped buffer,
    ``grads`` shaped like ``scene_params(scene, fields)`` (zeros where a
    field takes no gradient). Default functional: the mean pixel value."""
    loss_fn = loss_fn or torch.mean
    params = map_tensors(lambda x: x.detach().requires_grad_(True), scene_params(scene, fields))
    leaves = tensor_leaves(params)
    loss = loss_fn(render_buffer(apply_params(scene, params), camera, cfg))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(grads)
    return loss.detach(), map_tensors(lambda p: _or_zeros(next(it), p), params)


def _or_zeros(g: Tensor | None, p: Tensor) -> Tensor:
    return torch.zeros_like(p) if g is None else g
