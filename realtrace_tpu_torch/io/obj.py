"""Wavefront OBJ loader (the ``v/vn/vt/f`` subset) with per-vertex texel
sampling; numpy only.

Ref: ``load_image_from_obj``, Serial/lumina.cpp:195-290. Textures become
per-vertex colours sampled at load time (the ``BarycentricMaterial``
mechanism, Serial/lumina.cpp:248-253).

The native C++ parser (``io/native_obj.py``) parses the file when its
library builds and loads; the Python parser is the fallback and the
semantics reference, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from realtrace_tpu_torch.io.image import load_png


@dataclasses.dataclass
class ObjMesh:
    """Parsed mesh as flat arrays."""

    vertices: np.ndarray          # (V, 3) vertex positions (already scaled)
    tri_vertex_idx: np.ndarray    # (F, 3) vertex indices per face
    tri_uv_idx: np.ndarray        # (F, 3) texture-vertex indices (-1 = none)
    uvs: np.ndarray               # (T, 2) texture coordinates

    @property
    def triangles(self) -> np.ndarray:
        """(F, 3, 3) vertex positions per face."""
        return self.vertices[self.tri_vertex_idx]

    @property
    def n_faces(self) -> int:
        return self.tri_vertex_idx.shape[0]


def parse_obj(path: str | Path, scale: float = 1.0, max_faces: int | None = None) -> ObjMesh:
    """Parse the v/vt/f subset (``/``-separated, 1-based face indices; vertex
    normals are not read: shading uses the geometric normal).

    ``scale`` is the reference's SCALING_FACTOR (Serial/lumina.cpp:43) and
    ``max_faces`` its 2000-triangle cap (Serial/lumina.cpp:266). UV indices
    use the OBJ convention (the reference's off-by-one is not reproduced).
    """
    native = _try_native(path)
    if native is not None:
        verts_a, _, uvs_a, faces_v, faces_t = native
        return ObjMesh(vertices=verts_a * scale,
                       tri_vertex_idx=faces_v.astype(np.int64)[:max_faces],
                       tri_uv_idx=faces_t.astype(np.int64)[:max_faces], uvs=uvs_a)
    verts, uvs, faces_v, faces_t = [], [], [], []
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif tag == "vt":
                uvs.append([float(x) for x in parts[1:3]])
            elif tag == "f":
                vi, ti = [], []
                for corner in parts[1:4]:
                    toks = corner.split("/")
                    vi.append(int(toks[0]) - 1)
                    ti.append(int(toks[1]) - 1 if len(toks) > 1 and toks[1] else -1)
                faces_v.append(vi)
                faces_t.append(ti)
    faces_v_a = np.asarray(faces_v, np.int64).reshape(-1, 3)[:max_faces]
    faces_t_a = np.asarray(faces_t, np.int64).reshape(-1, 3)[:max_faces]
    return ObjMesh(vertices=np.asarray(verts, np.float64).reshape(-1, 3) * scale,
                   tri_vertex_idx=faces_v_a, tri_uv_idx=faces_t_a,
                   uvs=np.asarray(uvs, np.float64).reshape(-1, 2))


def _try_native(path):
    """The native parser's arrays, or None when its library cannot be built
    or loaded (then the Python parser runs)."""
    import subprocess

    from realtrace_tpu_torch.io import native_obj
    try:
        native_obj.load()
    except (OSError, subprocess.SubprocessError):
        return None
    return native_obj.parse(path)


def sample_vertex_colors(mesh: ObjMesh, texture_path: str | Path | None,
                         default_color=(0.8, 0.1, 0.0),
                         texture_scale: float = 1.0) -> np.ndarray:
    """Per-face-vertex colours (F, 3, 3): nearest-texel samples where UVs
    exist, else the OBJ default colour (Serial/lumina.cpp:163-193; sampled as
    normalized RGB with the OBJ v-up convention). ``texture_scale=255``
    reproduces the reference's raw-byte texels."""
    colors = np.broadcast_to(np.asarray(default_color, np.float64), (mesh.n_faces, 3, 3)).copy()
    if texture_path is None:
        return colors
    tex = load_png(texture_path)
    th, tw, _ = tex.shape
    has_uv = (mesh.tri_uv_idx >= 0).all(axis=1)
    uv = mesh.uvs[np.clip(mesh.tri_uv_idx, 0, max(len(mesh.uvs) - 1, 0))]
    x = np.clip((uv[..., 0] * tw).astype(np.int64), 0, tw - 1)
    y = np.clip(((1.0 - uv[..., 1]) * th).astype(np.int64), 0, th - 1)
    colors[has_uv] = (tex[y, x] * texture_scale)[has_uv]
    return colors


def load_obj_scene(builder, path: str | Path, texture_path=None, scale: float = 1.0,
                   max_faces: int | None = None, material: dict | None = None,
                   default_color=(0.8, 0.1, 0.0), texture_scale: float = 1.0,
                   duplicate_offset=None) -> ObjMesh:
    """Load an OBJ into a ``SceneBuilder``, by default with the reference OBJ
    material (Serial/lumina.cpp init_material_from_obj). ``duplicate_offset``
    places the model twice, at +offset and -offset (the CUDA app's
    duplication, Parellel/main.cu:167-181); None places it once."""
    mesh = parse_obj(path, scale=scale, max_faces=max_faces)
    colors = sample_vertex_colors(mesh, texture_path, default_color, texture_scale)
    mat = material or builder.material(ka=0.2, kd=0.9, ks=0.4, kr=0.4, kt=0.0, eta=3.0)
    offsets = [np.zeros(3)]
    if duplicate_offset is not None:
        off = np.asarray(duplicate_offset, np.float64)
        offsets = [off, -off]
    for off in offsets:
        for tri, col in zip(mesh.triangles + off, colors):
            builder.add_triangle(tri[0], tri[1], tri[2], vertex_colors=col, material=dict(mat))
    return mesh
