"""Scene and config interchange through plain numpy / Python values.

A scene crosses between the JAX package and this one as a dict of numpy
arrays keyed by the JAX ``Scene``'s field names (nested ``*_materials`` and
``lights`` as dicts), so both packages render identical inputs.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from realtrace_tpu_torch.core.types import (DIFF_FIELDS, MATERIAL_KEYS, Lights, Materials,
                                            RenderConfig, Scene, default_device, tensor_leaves)

_MATERIAL_FIELDS = ("tri_materials", "sph_materials", "pln_materials", "cyl_materials")
# JAX RenderConfig fields with no counterpart here: knobs that only steer TPU
# layouts, precisions or static shapes; none changes an image. The capacity
# ladders among them exist for XLA's static shapes; the port compacts the
# wavefront dynamically at every level, so nothing overflows, and
# ``compact_levels`` (JAX's switch between a compacted and a full-width
# wavefront) renders the same image and ray count either way.
_DROPPED = ("matmul_precision", "occlusion_precision", "compact_buckets", "deep_buckets",
            "branch_buckets", "compact_levels")


def _dtype_of(a) -> torch.dtype:
    return torch.from_numpy(np.empty(0, np.asarray(a).dtype)).dtype


def _fields_from_numpy(d: dict, names, dtype, device) -> dict:
    """Scene fields from their numpy form: ``Materials`` and ``Lights`` from
    dicts of arrays, every other field a tensor."""
    def t(a):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    kw = {}
    for name in names:
        v = d.get(name)
        if name in _MATERIAL_FIELDS:
            kw[name] = Materials(**{k: t(v[k]) for k in MATERIAL_KEYS})
        elif name == "lights":
            kw[name] = Lights(position=t(v["position"]), intensity=t(v["intensity"]))
        elif name == "tri_chunk_perm":
            kw[name] = None if v is None else torch.as_tensor(
                np.array(v), dtype=torch.int64, device=device)
        else:
            kw[name] = t(v)
    return kw


def _fields_to_numpy(obj, names) -> dict:
    """Inverse of ``_fields_from_numpy`` for any object or dict with those
    field names whose leaves ``np.asarray`` accepts (JAX values too)."""
    def a(x):
        if x is None:
            return None
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    out = {}
    for name in names:
        v = obj[name] if isinstance(obj, dict) else getattr(obj, name)
        if name in _MATERIAL_FIELDS:
            out[name] = {k: a(getattr(v, k)) for k in MATERIAL_KEYS}
        elif name == "lights":
            out[name] = {"position": a(v.position), "intensity": a(v.intensity)}
        else:
            out[name] = a(v)
    return out


def scene_from_numpy(d: dict, dtype=None, device=None) -> Scene:
    """Scene from a dict of arrays; ``dtype`` defaults to the vertices' dtype,
    ``device`` to the card (``default_device``)."""
    dtype = _dtype_of(d["tri_vertices"]) if dtype is None else dtype
    return Scene(**_fields_from_numpy(d, [f.name for f in dataclasses.fields(Scene)], dtype,
                                      default_device(device)))


def scene_to_numpy(scene) -> dict:
    """Inverse of ``scene_from_numpy``. Takes any object with the ``Scene``
    field names whose leaves ``np.asarray`` accepts (a JAX ``Scene`` too)."""
    return _fields_to_numpy(scene, [f.name for f in dataclasses.fields(Scene)])


def scene_to_npz(path, scene) -> None:
    """Write ``scene_to_numpy(scene)`` (a JAX ``Scene`` too) as one npz:
    nested dicts flattened to ``field/key`` names, None fields left out."""
    flat = {}
    for k, v in scene_to_numpy(scene).items():
        if isinstance(v, dict):
            flat.update({f"{k}/{kk}": vv for kk, vv in v.items()})
        elif v is not None:
            flat[k] = v
    np.savez(path, **flat)


def scene_from_npz(path, dtype=None, device=None) -> Scene:
    """Inverse of ``scene_to_npz``, through ``scene_from_numpy``."""
    d: dict = {}
    with np.load(path) as z:
        for name in z.files:
            k, _, kk = name.partition("/")
            if kk:
                d.setdefault(k, {})[kk] = z[name]
            else:
                d[k] = z[name]
    return scene_from_numpy(d, dtype=dtype, device=device)


def params_from_numpy(d: dict, dtype=None, device=None) -> dict:
    """A parameter dict (the ``diff.inverse.DIFF_FIELDS`` sub-dict of a scene:
    tensors, ``Materials``, ``Lights``) from its numpy form, the layout of
    ``scene_to_numpy``; ``dtype`` defaults to the first array's."""
    if dtype is None:
        first = next(iter(d.values()))
        dtype = _dtype_of(next(iter(first.values())) if isinstance(first, dict) else first)
    return _fields_from_numpy(d, list(d), dtype, default_device(device))


def params_to_numpy(params) -> dict:
    """Inverse of ``params_from_numpy``; takes the JAX package's parameter
    dicts (and its optax moments, which share their layout) too."""
    return _fields_to_numpy(params, list(params))


def adam_state_from_numpy(mu: dict, nu: dict, count) -> dict:
    """``torch.optim.Adam`` state from optax's ``ScaleByAdamState`` (``mu``
    and ``nu`` as ``params_to_numpy`` gives them, ``count`` the step count):
    the ``"state"`` entry of ``Adam.state_dict()``, keyed by leaf position in
    the order of the port's parameter dicts (``DIFF_FIELDS`` order; JAX
    sorts its dict keys). Load it with ``opt.load_state_dict({"state": ...,
    "param_groups": opt.state_dict()["param_groups"]})`` to continue a JAX
    run in the port."""
    def leaves(d):
        return tensor_leaves(params_from_numpy({f: d[f] for f in DIFF_FIELDS if f in d},
                                               device="cpu"))

    step = torch.tensor(float(np.asarray(count)), dtype=torch.float32)
    return {i: {"step": step.clone(), "exp_avg": a, "exp_avg_sq": b}
            for i, (a, b) in enumerate(zip(leaves(mu), leaves(nu)))}


def config_from_dict(d: dict) -> RenderConfig:
    """RenderConfig from the JAX config's fields: accel ``"pallas"`` maps to
    ``"sweep"`` and fields without a counterpart are dropped."""
    d = dict(d)
    for k in _DROPPED:
        d.pop(k, None)
    if d.get("accel") == "pallas":
        d["accel"] = "sweep"
    if "beer_sigma" in d:
        d["beer_sigma"] = tuple(float(x) for x in d["beer_sigma"])
    return RenderConfig(**d)
