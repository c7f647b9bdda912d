"""Preset scenes: the reference's bundled setups and the procedural mesh.

Counterpart of ``realtrace_tpu/apps/scenes.py``. Ref: Serial/lumina.cpp:292-386
(serial app scene), Parellel/main.cu:140-244 (CUDA app scene) and the
commented-out sphere/plane scene (Serial/lumina.cpp:312-360).
"""
from __future__ import annotations

import dataclasses
import os
from pathlib import Path

import numpy as np
import torch

from realtrace_tpu_torch.core.types import (MATERIAL_KEYS, Materials, Scene, SceneBuilder,
                                            default_device)
from realtrace_tpu_torch.io.obj import load_obj_scene
from realtrace_tpu_torch.render.camera import Camera

# the serial app's framing (Serial/lumina.cpp:292-386)
SERIAL_CAM = dict(position=(60, 60, 0), target=(0, 0, 0), up=(0, 1, 0), fovy=45.0)
# the CUDA app's framing (Parellel/main.cu:140-244)
PARALLEL_CAM = dict(position=(60, 0, 60), target=(0, 0, 0), up=(0, -1, 0), fovy=45.0)


def asset(name: str) -> Path:
    """A file of the reference apps' asset folder (bob_tri.obj,
    bob_diffuse.png, tetrahedron.obj): ``$REALTRACE_ASSETS/name``, by default
    ``assets/name`` beside the package. The repository ships no assets."""
    root = os.environ.get("REALTRACE_ASSETS", Path(__file__).resolve().parents[2] / "assets")
    return Path(root) / name


def sphere_plane_scene(dtype=torch.float32, device=None) -> tuple[Scene, dict]:
    """Sphere + reflective floor quad + point light (Serial/lumina.cpp:323-357):
    red sphere at (4,0,4) r=3, grey floor at y=-3."""
    b = SceneBuilder(dtype=dtype, device=device)
    b.ambient = (1.0, 1.0, 1.0)
    b.background = (0.1, 0.3, 0.6)
    b.add_sphere((4.0, 0.0, 4.0), 3.0, color=(0.8, 0.1, 0.0),
                 material=b.material(ka=0.2, kd=0.9, ks=0.4, kr=0.0, kt=0.0, eta=1.0))
    b.add_plane((10, -3, 10), (-10, -3, 10), (-10, -3, -10), (10, -3, -10),
                color=(0.5, 0.5, 0.5),
                material=b.material(ka=0.1, kd=0.9, ks=0.2, kr=0.5, kt=0.0, eta=1.0))
    b.add_light((0, 30, 30), (0.5, 1.0, 1.0))
    return b.build(), dict(SERIAL_CAM)


def full_primitive_scene(dtype=torch.float32, device=None) -> tuple[Scene, dict]:
    """All four primitive families with a dielectric cylinder: the complete
    commented-out serial scene (Serial/lumina.cpp:312-357)."""
    b = SceneBuilder(dtype=dtype, device=device)
    b.ambient = (1.0, 1.0, 1.0)
    b.background = (0.1, 0.3, 0.6)
    b.add_sphere((4, 0, 4), 3.0, color=(0.8, 0.1, 0.0),
                 material=b.material(ka=0.2, kd=0.9, ks=0.4, kr=0.0, kt=0.0, eta=1.0))
    b.add_cylinder((-7, 0, -3), (0, 0, 1), 1.0, color=(1.0, 1.0, 1.0),
                   material=b.material(ka=0.4, kd=0.9, ks=0.4, kr=0.1, kt=0.8, eta=2.0))
    b.add_plane((10, -3, 10), (-10, -3, 10), (-10, -3, -10), (10, -3, -10),
                color=(0.5, 0.5, 0.5),
                material=b.material(ka=0.1, kd=0.9, ks=0.2, kr=0.5, kt=0.0, eta=1.0))
    b.add_triangle((3, 3, 0), (3, -3, 0), (0, 0, 0),
                   vertex_colors=((1, 0, 0), (1, 1, 0), (0, 0, 1)), material=b.material())
    b.add_light((0, 30, 30), (0.5, 1.0, 1.0))
    return b.build(), dict(SERIAL_CAM)


def _serial_builder(dtype, device) -> SceneBuilder:
    """The serial app's lighting: ambient 1, background (0.1,0.3,0.6), light
    at (0,30,30) with intensity (0.5,1,1)."""
    b = SceneBuilder(dtype=dtype, device=device)
    b.ambient = (1.0, 1.0, 1.0)
    b.background = (0.1, 0.3, 0.6)
    b.add_light((0, 30, 30), (0.5, 1.0, 1.0))
    return b


def serial_obj_scene(obj_path=None, texture_path=None, dtype=torch.float32, device=None,
                     scale: float = 15.0, max_faces: int | None = None,
                     texture_scale: float = 1.0) -> tuple[Scene, dict]:
    """The serial app's shipped scene: an OBJ scaled x15 with the reflective
    OBJ material, camera (60,60,0) fovy 45. ``obj_path`` defaults to
    ``asset("bob_tri.obj")`` (FileNotFoundError where it is absent); the
    texture's samples are multiplied by ``texture_scale``. The serial app
    capped the mesh at 2000 triangles (``max_faces=2000`` for strict parity)."""
    b = _serial_builder(dtype, device)
    load_obj_scene(b, obj_path or asset("bob_tri.obj"), texture_path=texture_path, scale=scale,
                   max_faces=max_faces, texture_scale=texture_scale)
    return b.build(), dict(SERIAL_CAM)


def parallel_obj_scene(obj_path=None, dtype=torch.float32, device=None, scale: float = 2.0,
                       max_faces: int | None = None) -> tuple[Scene, dict]:
    """The CUDA app's scene (Parellel/main.cu:140-244): the model duplicated
    at x+-5 in grey (the CUDA path ignores textures, :24,171), two floor
    triangles at y=-7, a white light at (-10,-10,0), camera (60,0,60) with up
    (0,-1,0). ``obj_path`` defaults to ``asset("bob_tri.obj")``."""
    b = SceneBuilder(dtype=dtype, device=device)
    b.ambient = (1.0, 1.0, 1.0)       # the CUDA AMBIENT_COLOR is the miss colour (kernel.cu:13)
    b.background = (0.235294, 0.67451, 0.843137)
    load_obj_scene(b, obj_path or asset("bob_tri.obj"), scale=scale, max_faces=max_faces,
                   default_color=(0.5, 0.5, 0.5),
                   material=b.material(ka=0.4, kd=0.8, ks=0.1, kr=0.0, kt=0.0),
                   duplicate_offset=(5.0, 0.0, 0.0))
    floor = b.material(ka=0.4, kd=0.8, ks=0.1, kr=0.001, kt=0.0)   # main.cu:200-213
    b.add_triangle((-30, -7, -30), (30, -7, -30), (30, -7, 30), color=(0.3, 0.3, 0.3),
                   material=floor)
    b.add_triangle((-30, -7, -30), (30, -7, 30), (-30, -7, 30), color=(0.3, 0.3, 0.3),
                   material=floor)
    b.add_light((-10, -10, 0), (1.0, 1.0, 1.0))
    return b.build(), dict(PARALLEL_CAM)


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


def mesh_arrays(seed: int = 0, detail: float = 1.0):
    """The procedural stand-in for bob (unscaled): a torus (major radius 1,
    minor 0.35, ring in the xz plane) around a UV sphere (radius 0.6 at
    (0, 0.5, 0)). At ``detail=1`` the torus has 96x48 quads and the sphere
    32x24 (its pole rows hold degenerate triangles), 10,752 triangles in all;
    ``detail`` scales both tessellations. Vertices get a small jitter from
    ``numpy.random.default_rng(seed)``, shared by coincident vertices so the
    mesh stays closed. Returns (tri_vertices, tri_colors), each (N, 3, 3)
    float64; colours are a fixed function of position (standing in for the
    texture)."""
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
    """(x, z) offsets of the duplicated mesh's copies: six frozen offsets,
    then an expanding x/z grid walked ring by ring at spacing 18."""
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


def _duplicated(scene: Scene, n_copies: int) -> Scene:
    """The scene's triangles duplicated on ``copy_offsets(n_copies)``: each
    copy's vertices get +ox on x and +oz on z in the scene's dtype; colours
    and materials repeat n times."""
    tv = scene.tri_vertices
    copies = tv.unsqueeze(0).repeat(n_copies, 1, 1, 1)
    off = torch.tensor(copy_offsets(n_copies), dtype=tv.dtype, device=tv.device)
    copies[..., 0] += off[:, 0, None, None]
    copies[..., 2] += off[:, 1, None, None]
    m = scene.tri_materials
    return dataclasses.replace(
        scene, tri_vertices=copies.reshape(-1, 3, 3),
        tri_colors=scene.tri_colors.repeat(n_copies, 1, 1),
        tri_materials=dataclasses.replace(
            m, **{k: getattr(m, k).repeat(n_copies) for k in MATERIAL_KEYS}))


def _with_glass_sphere(scene: Scene) -> Scene:
    """The scene with one dielectric sphere between camera and mesh, the
    branching-wavefront scene: every hit on the sphere takes the Fresnel split
    into a reflection and a refraction child (Serial/world.cpp:77-100)."""
    dtype, device = scene.dtype, scene.tri_vertices.device

    def t(x):
        return torch.tensor(x, dtype=dtype, device=device)

    return dataclasses.replace(
        scene, sph_center=t([[20.0, 15.0, 20.0]]), sph_radius=t([10.0]),
        sph_color=t([[0.95, 0.95, 1.0]]),
        sph_materials=Materials.full(1, dtype, device, ka=0.1, kd=0.2, ks=0.3, kr=0.3,
                                     kt=0.8, eta=1.5))


def mesh_scene(seed: int = 0, detail: float = 1.0, dtype=torch.float32,
               device=None) -> tuple[Scene, dict]:
    """``serial_obj_scene``'s camera, light, ambient, background and OBJ
    material (``Materials.obj_default``) around the procedural mesh of
    ``mesh_arrays``, scaled x15."""
    tv, tc = mesh_arrays(seed, detail)
    device = default_device(device)
    scene = dataclasses.replace(
        _serial_builder(dtype, device).build(),
        tri_vertices=torch.as_tensor(15.0 * tv, dtype=dtype, device=device),
        tri_colors=torch.as_tensor(tc, dtype=dtype, device=device),
        tri_materials=Materials.obj_default(tv.shape[0], dtype, device))
    return scene, dict(SERIAL_CAM)


def duplicated_mesh_scene(n_copies: int, seed: int = 0, detail: float = 1.0,
                          dtype=torch.float32, device=None) -> tuple[Scene, dict]:
    """The big-scene workload: ``mesh_scene``'s mesh duplicated on the x/z
    offsets of ``copy_offsets`` (the CUDA app's duplication at x+-5,
    Parellel/main.cu:167-181, generalized to n copies). At ``detail=1`` a
    copy is 10,752 triangles: x2 stays with the resident kernel, x4 (43,008)
    streams, x8 (86,016) and x16 (172,032) also take the big-scene masks."""
    scene, cam = mesh_scene(seed, detail, dtype, device)
    return _duplicated(scene, n_copies), cam


def duplicated_serial_scene(n_copies: int, obj_path=None, texture_path=None,
                            dtype=torch.float32, device=None, **kw) -> tuple[Scene, dict]:
    """The JAX bench's big scene: ``serial_obj_scene`` (bob by default; ``kw``
    are its further keywords) duplicated on ``copy_offsets``, as
    ``duplicated_mesh_scene`` duplicates the procedural mesh."""
    scene, cam = serial_obj_scene(obj_path, texture_path, dtype, device, **kw)
    return _duplicated(scene, n_copies), cam


def glass_mesh_scene(seed: int = 0, detail: float = 1.0, dtype=torch.float32,
                     device=None) -> tuple[Scene, dict]:
    """``mesh_scene`` plus the dielectric sphere: the branching-wavefront scene."""
    scene, cam = mesh_scene(seed, detail, dtype, device)
    return _with_glass_sphere(scene), cam


def glass_bob_scene(obj_path=None, texture_path=None, dtype=torch.float32, device=None,
                    **kw) -> tuple[Scene, dict]:
    """The JAX bench's branching scene: ``serial_obj_scene`` (bob by default;
    ``kw`` are its further keywords) plus the dielectric sphere."""
    scene, cam = serial_obj_scene(obj_path, texture_path, dtype, device, **kw)
    return _with_glass_sphere(scene), cam


def make_camera(cam: dict, width: int, height: int, dtype=torch.float32,
                device=None) -> Camera:
    return Camera.make(cam["position"], cam["target"], cam["up"], cam["fovy"],
                       width, height, dtype=dtype, device=device)
