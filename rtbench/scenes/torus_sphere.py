"""The stand-in for bob: a frozen copy of the procedural mesh of
``realtrace_tpu_torch/apps/scenes.py`` (``mesh_arrays``), so that a change to
the program's scenes cannot move the yardstick.

Reads ``mesh_seed`` and ``detail`` from the configuration's scene; returns
triangles alone, which take the configuration's ``material``.
"""
from __future__ import annotations

import numpy as np


def _grid_triangles(p: np.ndarray, wrap_v: bool) -> np.ndarray:
    """Two triangles per quad of a (nu, nv, 3) vertex grid, periodic in u
    (and in v when ``wrap_v``): (nu * nv' * 2, 3, 3)."""
    nu, nv = p.shape[:2]
    i = np.arange(nu)[:, None]
    j = np.arange(nv if wrap_v else nv - 1)[None, :]
    i1, j1 = (i + 1) % nu, (j + 1) % nv
    a, b, c, d = p[i, j], p[i1, j], p[i1, j1], p[i, j1]
    quads = np.stack([np.stack([a, b, c], -2), np.stack([a, c, d], -2)], axis=2)
    return quads.reshape(-1, 3, 3)


def torus_sphere(seed: int = 0, detail: float = 1.0):
    """The stand-in for bob (unscaled): a torus (major radius 1, minor 0.35,
    ring in the xz plane) around a UV sphere (radius 0.6 at (0, 0.5, 0)); at
    ``detail=1`` 96x48 torus quads and 32x24 sphere quads, 10,752 triangles.
    Vertices get a jitter from ``numpy.random.default_rng(seed)`` shared by
    coincident vertices. Returns (tri_vertices, tri_colors), each (N, 3, 3)
    float64; colours are a fixed function of position."""
    rng = np.random.default_rng(seed)

    def n(k):
        return max(3, int(round(k * detail)))

    nu, nv = n(96), n(48)
    u = 2 * np.pi * np.arange(nu)[:, None] / nu
    v = 2 * np.pi * np.arange(nv)[None, :] / nv
    torus = np.stack([(1.0 + 0.35 * np.cos(v)) * np.cos(u),
                      0.35 * np.sin(v) + 0 * u,
                      (1.0 + 0.35 * np.cos(v)) * np.sin(u)], axis=-1)
    torus += rng.uniform(-0.002, 0.002, torus.shape)

    su, sv = n(32), n(24)
    phi = 2 * np.pi * np.arange(su)[:, None] / su
    theta = np.pi * np.arange(sv + 1)[None, :] / sv
    sphere = np.stack([0.6 * np.sin(theta) * np.cos(phi),
                       0.5 + 0.6 * np.cos(theta) + 0 * phi,
                       0.6 * np.sin(theta) * np.sin(phi)], axis=-1)
    jit = rng.uniform(-0.002, 0.002, sphere.shape)
    jit[:, 0] = jit[0, 0]       # each pole is one vertex
    jit[:, -1] = jit[0, -1]
    sphere += jit

    tv = np.concatenate([_grid_triangles(torus, wrap_v=True),
                         _grid_triangles(sphere, wrap_v=False)])
    tc = np.stack([0.55 + 0.35 * np.sin(3.0 * tv[..., 0] + 1.0),
                   0.55 + 0.35 * np.sin(3.0 * tv[..., 1] + 2.0),
                   0.35 + 0.25 * np.sin(3.0 * tv[..., 2] + 3.0)], axis=-1)
    return tv, tc


def build(scene: dict) -> dict:
    tv, tc = torus_sphere(scene["mesh_seed"], scene["detail"])
    return dict(tri_vertices=tv, tri_colors=tc)
