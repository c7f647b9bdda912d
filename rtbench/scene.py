"""The benchmark's inputs: scene arrays from a configuration, and the cameras
of a traffic mix.

Frozen copies of the procedural mesh and the copy walk of
``realtrace_tpu_torch/apps/scenes.py`` (``mesh_arrays``, ``copy_offsets``)
and of the serial app's lighting (RealTrace ``Serial/lumina.cpp:292-386``),
so that a change to the program's scenes cannot move the yardstick. Nothing
here imports the program: the arrays are plain NumPy, handed to the program
and to the reference alike.
"""
from __future__ import annotations

import math

import numpy as np

MATERIAL_KEYS = ("ka", "kd", "ks", "kr", "kt", "eta")


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


def copy_offsets(n_copies: int) -> list[tuple[float, float]]:
    """(x, z) offsets of the copies: six fixed offsets, then an expanding x/z
    grid walked ring by ring at spacing 18."""
    offs = [(0.0, 0.0), (18.0, 0.0), (0.0, 18.0), (18.0, 18.0), (-18.0, 0.0), (0.0, -18.0)]
    ring = 1
    while len(offs) < n_copies:
        cand = [(i * 18.0, j * 18.0)
                for i in range(-ring, ring + 1)
                for j in range(-ring, ring + 1)
                if max(abs(i), abs(j)) == ring]
        offs.extend(c for c in cand if c not in offs)
        ring += 1
    return offs[:n_copies]


def scene_arrays(config: dict) -> dict:
    """The configuration's scene as float64 NumPy arrays: ``tri_vertices``,
    ``tri_colors`` (N, 3, 3), ``tri_materials`` (a dict of (N,) arrays),
    ``light_position``, ``light_intensity`` (L, 3), ``ambient``,
    ``background`` (3,). The mesh is scaled, then copied onto
    ``copy_offsets`` (each copy's offset added in float32, as the scene is
    served in float32)."""
    s = config["scene"]
    if s["mesh"] != "torus_sphere":
        raise ValueError(f"unknown mesh {s['mesh']!r}")
    tv, tc = torus_sphere(s["mesh_seed"], s["detail"])
    tv = (s["scale"] * tv).astype(np.float32)
    n = s["copies"]
    off = np.zeros((n, 3), np.float32)
    off[:, [0, 2]] = np.asarray(copy_offsets(n), np.float32)
    tv = (tv[None] + off[:, None, None, :]).reshape(-1, 3, 3).astype(np.float64)
    tc = np.tile(tc.astype(np.float32), (n, 1, 1)).astype(np.float64)
    mats = {k: np.full(tv.shape[0], s["material"][k], np.float64) for k in MATERIAL_KEYS}
    lights = s["lights"]
    return dict(tri_vertices=tv, tri_colors=tc, tri_materials=mats,
                light_position=np.array([l["position"] for l in lights], np.float64),
                light_intensity=np.array([l["intensity"] for l in lights], np.float64),
                ambient=np.array(s["ambient"], np.float64),
                background=np.array(s["background"], np.float64))


def orbit_camera(camera: dict, position, yaw: float, pitch: float = 0.0) -> dict:
    """The camera ``camera`` moved onto the orbit through ``position`` around
    its target: same distance, at ``yaw`` (radians, measured from +x towards
    +z) and at the elevation of ``position`` raised by ``pitch`` (radians)."""
    tgt = np.asarray(camera["target"], np.float64)
    p = np.asarray(position, np.float64) - tgt
    dist = float(np.linalg.norm(p))
    elev = math.asin(p[1] / dist) + pitch
    ring = dist * math.cos(elev)
    pos = tgt + np.array([ring * math.cos(yaw), dist * math.sin(elev), ring * math.sin(yaw)])
    return dict(camera, position=[float(x) for x in pos])


def orbit_phases(seed: int) -> tuple[float, float]:
    """(yaw, pitch phase) of the orbit's frame 0, radians, drawn from the seed."""
    return tuple(float(x) for x in np.random.default_rng(seed).uniform(0.0, 2.0 * math.pi, 2))


def orbit_view(config: dict, traffic: dict, phases: tuple[float, float], k: int) -> dict:
    """Frame ``k``'s camera on the traffic's orbit, as the flythrough moves
    it: around the configuration's target through ``traffic["position"]``
    (default: the configuration's own camera position), the yaw advancing
    ``yaw_step`` a frame from ``phases[0]`` onward from that position's yaw,
    the elevation swinging by ``pitch_amp`` over ``pitch_period`` frames from
    the pitch phase ``phases[1]``. ``k`` may be negative (the warm-up)."""
    cam = config["camera"]
    through = traffic.get("position") or cam["position"]
    p = np.asarray(through, np.float64) - np.asarray(cam["target"], np.float64)
    yaw = math.atan2(p[2], p[0]) + phases[0] + traffic["yaw_step"] * k
    pitch = traffic["pitch_amp"] * math.sin(2.0 * math.pi * k / traffic["pitch_period"]
                                            + phases[1])
    return orbit_camera(cam, through, yaw, pitch)
