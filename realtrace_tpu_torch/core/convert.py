"""Scene and config interchange through plain numpy / Python values.

A scene crosses between the JAX package and this one as a dict of numpy
arrays keyed by the JAX ``Scene``'s field names (nested ``*_materials`` and
``lights`` as dicts), so both packages render identical inputs.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from realtrace_tpu_torch.core.types import (MATERIAL_KEYS, Lights, Materials, RenderConfig, Scene,
                                            default_device)

_MATERIAL_FIELDS = ("tri_materials", "sph_materials", "pln_materials", "cyl_materials")
# JAX RenderConfig fields with no counterpart here: knobs that only steer TPU
# layouts, precisions or static shapes (the capacity ladders among them: the
# port compacts dynamically, so nothing overflows); none changes an image
_DROPPED = ("shortlist", "ray_block", "matmul_precision", "occlusion_precision",
            "compact_buckets", "deep_buckets", "branch_buckets", "remat",
            "compact_levels")
# JAX RenderConfig fields whose non-default values select paths not ported
_FIXED = {"merge_queries": True, "shadow_any_mode": True}


def scene_from_numpy(d: dict, dtype=None, device=None) -> Scene:
    """Scene from a dict of arrays; ``dtype`` defaults to the vertices' dtype,
    ``device`` to the card (``default_device``)."""
    device = default_device(device)
    if dtype is None:
        dtype = torch.from_numpy(np.empty(0, np.asarray(d["tri_vertices"]).dtype)).dtype

    def t(a):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    kw = {}
    for f in dataclasses.fields(Scene):
        v = d.get(f.name)
        if f.name in _MATERIAL_FIELDS:
            kw[f.name] = Materials(**{k: t(v[k]) for k in MATERIAL_KEYS})
        elif f.name == "lights":
            kw[f.name] = Lights(position=t(v["position"]), intensity=t(v["intensity"]))
        elif f.name == "tri_chunk_perm":
            kw[f.name] = None if v is None else torch.as_tensor(
                np.array(v), dtype=torch.int64, device=device)
        else:
            kw[f.name] = t(v)
    return Scene(**kw)


def scene_to_numpy(scene) -> dict:
    """Inverse of ``scene_from_numpy``. Takes any object with the ``Scene``
    field names whose leaves ``np.asarray`` accepts (a JAX ``Scene`` too)."""
    def a(x):
        if x is None:
            return None
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    out = {}
    for f in dataclasses.fields(Scene):
        v = getattr(scene, f.name)
        if f.name in _MATERIAL_FIELDS:
            out[f.name] = {k: a(getattr(v, k)) for k in MATERIAL_KEYS}
        elif f.name == "lights":
            out[f.name] = {"position": a(v.position), "intensity": a(v.intensity)}
        else:
            out[f.name] = a(v)
    return out


def config_from_dict(d: dict) -> RenderConfig:
    """RenderConfig from the JAX config's fields: accel ``"pallas"`` maps to
    ``"sweep"``, fields without a counterpart are dropped, and values that
    select an unported path raise ``NotImplementedError``."""
    d = dict(d)
    for k, want in _FIXED.items():
        if d.pop(k, want) != want:
            raise NotImplementedError(f"{k}={not want} is not ported")
    for k in _DROPPED:
        d.pop(k, None)
    if d.get("accel") == "pallas":
        d["accel"] = "sweep"
    if "beer_sigma" in d:
        d["beer_sigma"] = tuple(float(x) for x in d["beer_sigma"])
    return RenderConfig(**d)
