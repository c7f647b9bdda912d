"""Scene schema: struct-of-arrays dataclasses of tensors.

Counterpart of ``realtrace_tpu/core/types.py``. Every primitive family lives
in one dense tensor batch, so intersection and shading are single batched ops
over the wavefront. The dataclasses hold plain tensors and move between
devices with an explicit ``.to(device)``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
from torch import Tensor

from realtrace_tpu_torch.utils.profiling import span

# Epsilons, faithful to the reference.
SMALLEST_DIST = 1e-4  # min-t cutoff; Serial/ray.h:10
DET_EPSILON = 1e-7    # degenerate-triangle determinant cutoff; Serial/triangle.h:12
RECURSION_DEPTH = 10  # Serial/world.h:11
BIG = 1e30            # "no hit" distance sentinel (FLT_MAX analog, Serial/ray.h:25)
# Dead wavefront lanes are "parked" at this origin (far outside any scene);
# the sweep's chunk masks recognise the sentinel and give such lanes no work.
PARK_DISTANCE = 1e8
# Rays per wavefront tile: the unit of sweep-kernel work (one thread block
# per tile) and of inter-level compaction.
WAVEFRONT_TILE = 1024

MATERIAL_KEYS = ("ka", "kd", "ks", "kr", "kt", "eta")


def default_device(device=None) -> torch.device:
    """The device constructors build on: the CUDA card unless the caller names
    another (``device="cpu"`` asks for the CPU). There is no fallback: with no
    card and no explicit device, the first tensor made on it raises."""
    return torch.device("cuda" if device is None else device)


def _to(obj, device):
    """dataclasses.replace with every tensor field (recursively) moved."""
    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, Tensor):
            v = v.to(device)
        elif dataclasses.is_dataclass(v):
            v = v.to(device)
        kw[f.name] = v
    return dataclasses.replace(obj, **kw)


@dataclasses.dataclass(frozen=True)
class Materials:
    """Phong material parameters, one entry per primitive.

    Ref: ``Material`` fields, Serial/material.h:18-25.
    """

    ka: Tensor   # (N,) ambient coefficient
    kd: Tensor   # (N,) diffuse coefficient
    ks: Tensor   # (N,) specular coefficient
    kr: Tensor   # (N,) reflection contribution
    kt: Tensor   # (N,) refraction contribution
    eta: Tensor  # (N,) index of refraction

    @staticmethod
    def full(n: int, dtype=torch.float32, device=None, **vals: float) -> "Materials":
        """``n`` entries of one material, given by its six values."""
        device = default_device(device)
        return Materials(**{k: torch.full((n,), vals[k], dtype=dtype, device=device)
                            for k in MATERIAL_KEYS})

    @staticmethod
    def default(n: int, dtype=torch.float32, device=None) -> "Materials":
        """Reference defaults: Serial/material.h:27-29 (ka .2, kd 1, ks .4)."""
        return Materials.full(n, dtype, device, ka=0.2, kd=1.0, ks=0.4, kr=0.0, kt=0.0,
                              eta=128.0)

    @staticmethod
    def obj_default(n: int, dtype=torch.float32, device=None) -> "Materials":
        """Materials the OBJ loader assigns: Serial/lumina.cpp init_material_from_obj."""
        return Materials.full(n, dtype, device, ka=0.2, kd=0.9, ks=0.4, kr=0.4, kt=0.0,
                              eta=3.0)

    def to(self, device) -> "Materials":
        return _to(self, device)


@dataclasses.dataclass(frozen=True)
class Lights:
    """Point lights. Ref: Serial/pointlightsource.h:6-14."""

    position: Tensor   # (L, 3)
    intensity: Tensor  # (L, 3) RGB intensity

    def to(self, device) -> "Lights":
        return _to(self, device)


@dataclasses.dataclass(frozen=True)
class Scene:
    """Full scene as dense SoA tensors (field names as in the JAX ``Scene``).

    A family may be empty (shape (0, ...)); trace paths skip empty families.
    """

    tri_vertices: Tensor       # (Nt, 3, 3) rows = vertices A, B, C
    tri_colors: Tensor         # (Nt, 3, 3) per-vertex RGB
    tri_materials: Materials
    sph_center: Tensor         # (Ns, 3)
    sph_radius: Tensor         # (Ns,)
    sph_color: Tensor          # (Ns, 3)
    sph_materials: Materials
    pln_corners: Tensor        # (Np, 4, 3); normal = cross(p3-p1, p2-p1)
    pln_color: Tensor          # (Np, 3)
    pln_materials: Materials
    cyl_center: Tensor         # (Nc, 3)
    cyl_up: Tensor             # (Nc, 3)
    cyl_radius: Tensor         # (Nc,)
    cyl_color: Tensor          # (Nc, 3)
    cyl_materials: Materials
    lights: Lights
    ambient: Tensor            # (3,)
    background: Tensor         # (3,)
    # sweep chunk permutation (ops.accel.with_chunks); None until built
    tri_chunk_perm: Tensor | None = None

    @property
    def n_triangles(self) -> int:
        return self.tri_vertices.shape[0]

    @property
    def n_spheres(self) -> int:
        return self.sph_center.shape[0]

    @property
    def n_planes(self) -> int:
        return self.pln_corners.shape[0]

    @property
    def n_cylinders(self) -> int:
        return self.cyl_center.shape[0]

    @property
    def n_lights(self) -> int:
        return self.lights.position.shape[0]

    @property
    def dtype(self):
        return self.tri_vertices.dtype

    def has_dielectrics(self) -> bool:
        """Whether any primitive has kr > 0 and kt > 0, read from the tensors
        themselves (no cached flag that could go stale)."""
        for m in (self.tri_materials, self.sph_materials, self.pln_materials,
                  self.cyl_materials):
            if m.kr.numel():
                with span("rt.p.sync.dielectrics"):
                    if bool(torch.any((m.kr > 0) & (m.kt > 0))):
                        return True
        return False

    def to(self, device) -> "Scene":
        return _to(self, device)


class SceneBuilder:
    """Imperative scene assembly (``World::addObject``/``addLight``,
    Serial/world.h:30-38) that freezes into the dense ``Scene``."""

    def __init__(self, dtype=torch.float32, device=None):
        self.dtype = dtype
        self.device = default_device(device)
        self._tris: list[tuple[Any, Any, dict]] = []
        self._sphs: list[tuple[Any, float, Any, dict]] = []
        self._plns: list[tuple[Any, Any, dict]] = []
        self._cyls: list[tuple[Any, Any, float, Any, dict]] = []
        self._lights: list[tuple[Any, Any]] = []
        self.ambient = (0.0, 0.0, 0.0)
        self.background = (0.0, 0.0, 0.0)

    @staticmethod
    def material(ka=0.2, kd=1.0, ks=0.4, kr=0.0, kt=0.0, eta=128.0, n=128.0) -> dict:
        """Material parameter dict (reference defaults, Serial/material.h:27-29).
        ``n`` is accepted for API parity; the Phong exponent comes from
        ``RenderConfig.phong_exp``."""
        return dict(ka=ka, kd=kd, ks=ks, kr=kr, kt=kt, eta=eta)

    def add_triangle(self, a, b, c, color=(0.8, 0.1, 0.0), vertex_colors=None, material=None):
        if vertex_colors is None:
            vertex_colors = (color, color, color)
        self._tris.append((np.array([a, b, c], np.float64),
                           np.array(vertex_colors, np.float64), material or self.material()))

    def add_sphere(self, center, radius, color=(0.8, 0.1, 0.0), material=None):
        self._sphs.append((np.array(center, np.float64), float(radius),
                           np.array(color, np.float64), material or self.material()))

    def add_plane(self, p1, p2, p3, p4, color=(0.5, 0.5, 0.5), material=None):
        self._plns.append((np.array([p1, p2, p3, p4], np.float64),
                           np.array(color, np.float64), material or self.material()))

    def add_cylinder(self, center, up, radius, color=(0.8, 0.1, 0.0), material=None):
        self._cyls.append((np.array(center, np.float64), np.array(up, np.float64),
                           float(radius), np.array(color, np.float64),
                           material or self.material()))

    def add_light(self, position, intensity):
        self._lights.append((np.array(position, np.float64), np.array(intensity, np.float64)))

    def _t(self, rows, shape) -> Tensor:
        a = np.array(rows, np.float64).reshape(shape)
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)

    def _mats(self, mats: list[dict]) -> Materials:
        return Materials(**{k: self._t([m[k] for m in mats], (-1,)) for k in MATERIAL_KEYS})

    def build(self) -> Scene:
        t, s, p, c = self._tris, self._sphs, self._plns, self._cyls
        return Scene(
            tri_vertices=self._t([x[0] for x in t], (-1, 3, 3)),
            tri_colors=self._t([x[1] for x in t], (-1, 3, 3)),
            tri_materials=self._mats([x[2] for x in t]),
            sph_center=self._t([x[0] for x in s], (-1, 3)),
            sph_radius=self._t([x[1] for x in s], (-1,)),
            sph_color=self._t([x[2] for x in s], (-1, 3)),
            sph_materials=self._mats([x[3] for x in s]),
            pln_corners=self._t([x[0] for x in p], (-1, 4, 3)),
            pln_color=self._t([x[1] for x in p], (-1, 3)),
            pln_materials=self._mats([x[2] for x in p]),
            cyl_center=self._t([x[0] for x in c], (-1, 3)),
            cyl_up=self._t([x[1] for x in c], (-1, 3)),
            cyl_radius=self._t([x[2] for x in c], (-1,)),
            cyl_color=self._t([x[3] for x in c], (-1, 3)),
            cyl_materials=self._mats([x[4] for x in c]),
            lights=Lights(position=self._t([x[0] for x in self._lights], (-1, 3)),
                          intensity=self._t([x[1] for x in self._lights], (-1, 3))),
            ambient=self._t(self.ambient, (3,)),
            background=self._t(self.background, (3,)),
        )


# the scene fields that take gradients (every float field; the chunk
# permutation is topology), in the order parameter dicts keep them
DIFF_FIELDS = (
    "tri_vertices", "tri_colors", "tri_materials",
    "sph_center", "sph_radius", "sph_color", "sph_materials",
    "pln_corners", "pln_color", "pln_materials",
    "cyl_center", "cyl_up", "cyl_radius", "cyl_color", "cyl_materials",
    "lights", "ambient", "background",
)


def tensor_leaves(x) -> list[Tensor]:
    """The tensors of a parameter tree, in a fixed order: a tensor, a
    ``Materials`` or ``Lights`` (fields in declaration order), or a dict of
    those (in the dict's order)."""
    if isinstance(x, dict):
        return [t for v in x.values() for t in tensor_leaves(v)]
    if dataclasses.is_dataclass(x):
        return [getattr(x, f.name) for f in dataclasses.fields(x)]
    return [x]


def map_tensors(fn, x):
    """The parameter tree ``x`` with every tensor replaced by ``fn(tensor)``
    (the same structure: dicts, ``Materials``, ``Lights``)."""
    if isinstance(x, dict):
        return {k: map_tensors(fn, v) for k, v in x.items()}
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: fn(getattr(x, f.name))
                                         for f in dataclasses.fields(x)})
    return fn(x)


ACCELS = ("bruteforce", "chunked", "sweep")


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Render hyperparameters (the reference's compile-time macros as a
    config object). The TPU-only layout and precision knobs of the JAX
    ``RenderConfig`` have no counterpart here."""

    max_depth: int = RECURSION_DEPTH       # Serial/world.h:11
    phong_exp: int = 128                   # hard-coded exponent, Serial/world.cpp:134
    shadows: bool = True
    shadow_blend: float = 1e-4             # Serial/world.cpp:63
    legacy_diffuse: bool = True            # diffuse uses normalize(lightPosition), Serial/world.cpp:133
    smallest_dist: float = SMALLEST_DIST
    det_epsilon: float = DET_EPSILON
    ray_offset: float = 1e-4               # secondary-ray origin offset, Serial/world.cpp:97-103
    shadow_origin_bias: float = 0.01       # shadow-ray origin lerp factor, Serial/world.cpp:44
    beer_sigma: tuple = (0.27, 0.45, 0.55)  # exit-attenuation constants, Serial/world.cpp:85
    # "bruteforce" (dense reference semantics), "sweep" (chunk sweep through
    # the hand-written CUDA kernels; exact) or "chunked" (APPROXIMATE: each
    # block of ``ray_block`` rays tests only the ``shortlist`` chunks most of
    # its rays' boxes enter, so a hit in a chunk off the shortlist is dropped)
    accel: str = "bruteforce"
    chunk_size: int = 32                   # triangles per sweep chunk
    shortlist: int = 96                    # chunks tested per ray block ("chunked")
    ray_block: int = 2048                  # rays per block ("chunked")
    # query widths (rays, after padding to whole tiles) at or below which
    # the exact per-ray chunk mask replaces the per-tile interval mask
    exact_mask_rays: int = 1 << 19
    # force the exact mask for every secondary (shadow + child) query
    exact_mask_secondary: bool = False
    # False: per level the closest query of the level's rays, then one
    # any-mode query per light (scenes without dielectrics only)
    merge_queries: bool = True
    # False: the fully merged query, one closest query a level over every
    # light's shadow segment and the next level's child rays (occluded where
    # a shadow ray hits anything); True: the shadow segments in one any-mode
    # query beside the children's closest query
    shadow_any_mode: bool = True
    # rematerialised backward: each level's differentiable shading runs
    # under ``torch.utils.checkpoint`` and is recomputed in the backward,
    # which keeps only the level's inputs and its query results (never re-runs
    # a query); no effect on renders that need no gradient
    remat: bool = True

    def __post_init__(self):
        if self.accel not in ACCELS:
            raise ValueError(f"accel={self.accel!r} not in {ACCELS}")
