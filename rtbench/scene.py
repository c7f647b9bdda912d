"""The benchmark's inputs: scene arrays from a configuration, and the cameras
of a traffic mix.

A configuration's ``scene["mesh"]`` names a scene kind: a builder file
``rtbench/scenes/<kind>.py`` whose ``build(scene)`` returns the primitives
(see ``scene_arrays``). The copy walk (``copy_offsets``) is a frozen copy of
``realtrace_tpu_torch/apps/scenes.py``'s, and the lighting that of the serial
app (RealTrace ``Serial/lumina.cpp:292-386``), so that a change to the
program's scenes cannot move the yardstick. Nothing here imports the program:
the arrays are plain NumPy, handed to the program and to the reference alike.
"""
from __future__ import annotations

import importlib.util
import math
from pathlib import Path

import numpy as np

MATERIAL_KEYS = ("ka", "kd", "ks", "kr", "kt", "eta")
SCENES = Path(__file__).resolve().parent / "scenes"
# what a scene kind's ``build`` may return, with the shape of one primitive's entry
BUILT = {"tri_vertices": (3, 3), "tri_colors": (3, 3), "tri_materials": None,
         "sph_center": (3,), "sph_radius": (), "sph_color": (3,), "sph_materials": None}


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


def kinds(directory: Path = SCENES) -> list[str]:
    """The scene kinds a directory holds: one builder file each."""
    return sorted(p.stem for p in Path(directory).glob("*.py") if not p.stem.startswith("_"))


def builder(kind: str, directory: Path = SCENES):
    """The ``build`` function of ``<directory>/<kind>.py``."""
    known = kinds(directory)
    if kind not in known:
        raise ValueError(f"unknown scene kind {kind!r}; {directory} holds {', '.join(known)}")
    spec = importlib.util.spec_from_file_location(f"rtbench.scenes.{kind}",
                                                  Path(directory) / f"{kind}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.build


def scene_arrays(config: dict, directory: Path = SCENES) -> dict:
    """The configuration's scene as float64 NumPy arrays.

    The scene kind's ``build(scene)`` returns, unscaled, any of
    ``tri_vertices``, ``tri_colors`` (N, 3, 3) and ``tri_materials``;
    ``sph_center`` (S, 3), ``sph_radius`` (S,), ``sph_color`` (S, 3) and
    ``sph_materials``; a family's materials a dict of (N,) or (S,) arrays
    under ``MATERIAL_KEYS``. A family it leaves out is empty, a material key
    it leaves out the configuration's ``material``. Every primitive is scaled
    by ``scale``, then copied onto ``copy_offsets`` (each copy's offset added
    in float32, as the scene is served in float32). Added: ``light_position``,
    ``light_intensity`` (L, 3), ``ambient``, ``background`` (3,)."""
    s = config["scene"]
    b = builder(s["mesh"], directory)(s)
    if set(b) - set(BUILT):
        raise ValueError(f"scene kind {s['mesh']!r} returns {sorted(set(b) - set(BUILT))}; "
                         f"it may return {list(BUILT)}")

    def get(key):
        return np.asarray(b[key], np.float64) if key in b else np.zeros((0,) + BUILT[key])

    n, scale = s["copies"], s["scale"]
    off = np.zeros((n, 3), np.float32)
    off[:, [0, 2]] = np.asarray(copy_offsets(n), np.float32)
    tv, sc = get("tri_vertices"), get("sph_center")
    nt, ns = tv.shape[0], sc.shape[0]
    tv = (scale * tv).astype(np.float32)
    tv = (tv[None] + off[:, None, None, :]).reshape(-1, 3, 3).astype(np.float64)
    sc = (scale * sc).astype(np.float32)
    sc = (sc[None] + off[:, None, :]).reshape(-1, 3).astype(np.float64)

    def copies(key, x, rows):
        """Per-primitive ``x`` of ``rows`` rows, repeated for each copy."""
        if x.shape[0] != rows:
            raise ValueError(f"{key} of scene kind {s['mesh']!r} has {x.shape[0]} rows "
                             f"for {rows} primitives")
        return np.tile(x, (n,) + (1,) * (x.ndim - 1))

    def served(key, x, rows):
        return copies(key, x.astype(np.float32), rows).astype(np.float64)

    def materials(fam, rows):
        given = b.get(f"{fam}_materials", {})
        return {k: (copies(f"{fam}_materials.{k}", np.asarray(given[k], np.float64), rows)
                    if k in given else np.full(n * rows, s["material"][k], np.float64))
                for k in MATERIAL_KEYS}

    lights = s["lights"]
    return dict(tri_vertices=tv, tri_colors=served("tri_colors", get("tri_colors"), nt),
                tri_materials=materials("tri", nt),
                sph_center=sc, sph_radius=served("sph_radius", scale * get("sph_radius"), ns),
                sph_color=served("sph_color", get("sph_color"), ns),
                sph_materials=materials("sph", ns),
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
