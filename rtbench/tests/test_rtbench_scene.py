"""Scene kinds: the builder files ``rtbench/scenes/<kind>.py`` that
``scene.scene_arrays`` finds by a configuration's ``scene["mesh"]``. The
configurations' arrays are pinned to the bytes they had before scene kinds
were files; a kind from another directory brings triangles and spheres with
materials of their own, and the program renders it as the reference does."""
import hashlib

import numpy as np
import pytest
import torch

from rtbench import manifest, scene
from rtbench.reference import Groups, Reference
from rtbench.tests.test_rtbench_reference import _cast
from rtbench.workload import program_camera, program_scene

# SHA-256 of each array's bytes (float64, C order), as scene_arrays built them
# when the torus was the only mesh it knew
PINNED = {
    "bob_1080p": {
        "tri_vertices": "3730fc3b4e8fd8dff9900a73a1473cf70a2f1b7da93c70759c0f132c5885b1d1",
        "tri_colors": "02e0293199c0e6093737b393bd8bff25f5abbda1dafbde23fa67e71dbc8cdb4d",
        "tri_materials.ka": "29e896b1ddbf7b633c05897c1e42b1b31fa6a95c5bdab2b3489cd66b54c35de0",
        "tri_materials.kd": "70d29b57fc6b8b4aade33f5a09551428559fb1834181a7ac8daa9b49be341cb6",
        "tri_materials.ks": "39342d3192380cf0b9499faaa76d65e485391a22195cb774d21666cf57908e0d",
        "tri_materials.kr": "39342d3192380cf0b9499faaa76d65e485391a22195cb774d21666cf57908e0d",
        "tri_materials.kt": "793dd18194116ab34ab06e753faefa8d882fb962beba46dbf4256264c74c5006",
        "tri_materials.eta": "67f6aa35451ea83e9c3f7e4bd07026d2189321ae8d9b96224823e4cdf784a750",
        "light_position": "652b108e62ff977180dba2474037e4a401e596c551f1caee0dbdf43b2794288b",
        "light_intensity": "74bcfda8698f0f558b70f711872f55a13241f3f523a347cc3340792fff1723b6",
        "ambient": "cc143326a2646c605ea66139d7b440df7cbde18c050f1f8cf4dd30f42cfe7123",
        "background": "8a59f5eff9620df1b697f235888fdc4c40a9d61741127af923c34962d2de8281",
    },
    "glass_bob_1080p": {
        "tri_vertices": "3730fc3b4e8fd8dff9900a73a1473cf70a2f1b7da93c70759c0f132c5885b1d1",
        "tri_colors": "02e0293199c0e6093737b393bd8bff25f5abbda1dafbde23fa67e71dbc8cdb4d",
        "tri_materials.ka": "39342d3192380cf0b9499faaa76d65e485391a22195cb774d21666cf57908e0d",
        "tri_materials.kd": "70d29b57fc6b8b4aade33f5a09551428559fb1834181a7ac8daa9b49be341cb6",
        "tri_materials.ks": "39342d3192380cf0b9499faaa76d65e485391a22195cb774d21666cf57908e0d",
        "tri_materials.kr": "dcbe0a5ef12ada6c5d66205d11a9b614722d09d396d334eadcb35ec8ce509cd1",
        "tri_materials.kt": "9f098d20a4f1e1286ba4b0ad9b62fc7cb0180119dd48bd7eca9dfe4ef81a741f",
        "tri_materials.eta": "1d40f104f89cc09076cbe6ed0cbe1a20d0fa49ed7583cff5477b4d34c11ca985",
        "light_position": "652b108e62ff977180dba2474037e4a401e596c551f1caee0dbdf43b2794288b",
        "light_intensity": "74bcfda8698f0f558b70f711872f55a13241f3f523a347cc3340792fff1723b6",
        "ambient": "cc143326a2646c605ea66139d7b440df7cbde18c050f1f8cf4dd30f42cfe7123",
        "background": "8a59f5eff9620df1b697f235888fdc4c40a9d61741127af923c34962d2de8281",
    },
    "bob_1080p_4card": {
        "tri_vertices": "3730fc3b4e8fd8dff9900a73a1473cf70a2f1b7da93c70759c0f132c5885b1d1",
        "tri_colors": "02e0293199c0e6093737b393bd8bff25f5abbda1dafbde23fa67e71dbc8cdb4d",
        "tri_materials.ka": "29e896b1ddbf7b633c05897c1e42b1b31fa6a95c5bdab2b3489cd66b54c35de0",
        "tri_materials.kd": "70d29b57fc6b8b4aade33f5a09551428559fb1834181a7ac8daa9b49be341cb6",
        "tri_materials.ks": "39342d3192380cf0b9499faaa76d65e485391a22195cb774d21666cf57908e0d",
        "tri_materials.kr": "39342d3192380cf0b9499faaa76d65e485391a22195cb774d21666cf57908e0d",
        "tri_materials.kt": "793dd18194116ab34ab06e753faefa8d882fb962beba46dbf4256264c74c5006",
        "tri_materials.eta": "67f6aa35451ea83e9c3f7e4bd07026d2189321ae8d9b96224823e4cdf784a750",
        "light_position": "652b108e62ff977180dba2474037e4a401e596c551f1caee0dbdf43b2794288b",
        "light_intensity": "74bcfda8698f0f558b70f711872f55a13241f3f523a347cc3340792fff1723b6",
        "ambient": "cc143326a2646c605ea66139d7b440df7cbde18c050f1f8cf4dd30f42cfe7123",
        "background": "8a59f5eff9620df1b697f235888fdc4c40a9d61741127af923c34962d2de8281",
    },
}

FLOOR_AND_SPHERES = """
import numpy as np

def build(scene):
    floor = np.array([[[-8.0, 0.0, -8.0], [8.0, 0.0, 8.0], [8.0, 0.0, -8.0]],
                      [[-8.0, 0.0, -8.0], [-8.0, 0.0, 8.0], [8.0, 0.0, 8.0]]])
    return dict(
        tri_vertices=floor, tri_colors=np.full((2, 3, 3), 0.7),
        tri_materials=dict(ka=[0.1, 0.1], kd=[0.8, 0.6], ks=[0.1, 0.2], kr=[0.0, 0.3],
                           kt=[0.0, 0.0], eta=[1.0, 1.0]),
        sph_center=np.array([[-2.0, 1.6, 2.0], [2.5, 1.2, -1.0], [0.0, 1.0, -4.5]]),
        sph_radius=np.array([1.5, 1.2, 1.0]),
        sph_color=np.array([[0.95, 0.95, 1.0], [0.9, 0.3, 0.2], [0.2, 0.8, 0.3]]),
        # no ka: the configuration's
        sph_materials=dict(kd=[0.2, 0.7, 0.9], ks=[0.3, 0.4, 0.1], kr=[0.2, 0.6, 0.0],
                           kt=[0.8, 0.0, 0.0], eta=[1.5, 1.0, 1.0]))
"""


def pinned_config(name: str) -> dict:
    return manifest.config(manifest.load(), {"config": name})


def floor_and_spheres(tmp_path, scale: float = 1.0, copies: int = 1) -> dict:
    """A configuration of the scene kind ``floor_and_spheres``, written into
    ``tmp_path``."""
    (tmp_path / "floor_and_spheres.py").write_text(FLOOR_AND_SPHERES)
    return dict(
        width=32, height=24,
        camera=dict(position=[0.0, 7.0, 15.0], target=[0.0, 1.0, 0.0], up=[0.0, 1.0, 0.0], fovy=45.0),
        scene=dict(mesh="floor_and_spheres", scale=scale, copies=copies,
                   material=dict(ka=0.25, kd=0.9, ks=0.4, kr=0.4, kt=0.0, eta=3.0),
                   ambient=[0.3, 0.3, 0.3], background=[0.1, 0.3, 0.6],
                   lights=[dict(position=[-6.0, 20.0, 10.0], intensity=[1.0, 1.0, 1.0])]),
        render=dict(max_depth=4))


@pytest.mark.parametrize("name", sorted(PINNED))
def test_the_configurations_arrays_are_pinned(name):
    arrays = scene.scene_arrays(pinned_config(name))
    flat = {k: v for k, v in arrays.items() if not isinstance(v, dict)}
    for fam in ("tri_materials", "sph_materials"):
        flat.update({f"{fam}.{k}": v for k, v in arrays[fam].items()})
    got = {k: hashlib.sha256(np.ascontiguousarray(v).tobytes()).hexdigest()
           for k, v in flat.items() if not k.startswith("sph_")}
    assert got == PINNED[name]
    assert all(v.dtype == np.float64 for v in flat.values())
    assert arrays["tri_vertices"].shape == (10752, 3, 3)
    assert all(v.shape[0] == 0 for k, v in flat.items() if k.startswith("sph_"))


def test_an_unknown_scene_kind_names_the_kinds_there_are(tmp_path):
    cfg = pinned_config("bob_1080p")
    with pytest.raises(ValueError, match=r"unknown scene kind 'sphereflake'.*torus_sphere"):
        scene.scene_arrays(dict(cfg, scene=dict(cfg["scene"], mesh="sphereflake")))
    floor_and_spheres(tmp_path)
    assert scene.kinds(tmp_path) == ["floor_and_spheres"]
    with pytest.raises(ValueError, match=r"unknown scene kind 'torus_sphere'.*floor_and_spheres"):
        scene.scene_arrays(cfg, tmp_path)


def test_a_kind_that_returns_an_unknown_key_or_short_rows_is_refused(tmp_path):
    cfg = floor_and_spheres(tmp_path)
    (tmp_path / "typo.py").write_text("def build(scene):\n    return dict(sph_centre=[[0, 0, 0]])\n")
    with pytest.raises(ValueError, match="returns \\['sph_centre'\\]"):
        scene.scene_arrays(dict(cfg, scene=dict(cfg["scene"], mesh="typo")), tmp_path)
    (tmp_path / "short.py").write_text(
        "def build(scene):\n    return dict(sph_center=[[0, 0, 0]], sph_radius=[1], "
        "sph_color=[[1, 1, 1], [1, 1, 1]])\n")
    with pytest.raises(ValueError, match="sph_color .* has 2 rows for 1 primitives"):
        scene.scene_arrays(dict(cfg, scene=dict(cfg["scene"], mesh="short")), tmp_path)


def test_scale_and_copies_move_the_spheres_as_the_triangles(tmp_path):
    cfg = floor_and_spheres(tmp_path, scale=2.5, copies=3)
    built = {}
    exec(FLOOR_AND_SPHERES, built)
    b = built["build"](cfg["scene"])
    a = scene.scene_arrays(cfg, tmp_path)
    assert {k: v.shape for k, v in a.items() if not isinstance(v, dict)} == dict(
        tri_vertices=(6, 3, 3), tri_colors=(6, 3, 3), sph_center=(9, 3), sph_radius=(9,),
        sph_color=(9, 3), light_position=(1, 3), light_intensity=(1, 3), ambient=(3,),
        background=(3,))
    f32 = np.float32
    for k, (x, z) in enumerate(scene.copy_offsets(3)):
        off = np.array([x, 0.0, z], f32)
        assert np.array_equal(a["tri_vertices"][2 * k:2 * k + 2],
                              (2.5 * b["tri_vertices"]).astype(f32) + off)
        assert np.array_equal(a["sph_center"][3 * k:3 * k + 3],
                              (2.5 * b["sph_center"]).astype(f32) + off)
    assert np.array_equal(a["sph_radius"], np.tile((2.5 * b["sph_radius"]).astype(f32), 3))
    assert np.array_equal(a["sph_color"], np.tile(b["sph_color"].astype(f32), (3, 1)))
    for fam, n in (("tri", 2), ("sph", 3)):
        for k in scene.MATERIAL_KEYS:
            given = b[f"{fam}_materials"].get(k, [cfg["scene"]["material"][k]] * n)
            assert np.array_equal(a[f"{fam}_materials"][k], np.tile(given, 3)), (fam, k)
    glass = (a["sph_materials"]["kr"] > 0) & (a["sph_materials"]["kt"] > 0)
    assert glass.tolist() == [True, False, False] * 3


def test_the_program_renders_a_kind_of_triangles_and_spheres_as_the_reference(tmp_path):
    """At 32x24, depth 4, in float64: the program's scene from
    ``program_scene`` against the reference, every pixel (the tolerance of
    the reference's glass-sphere test)."""
    from realtrace_tpu_torch.core.types import RenderConfig
    from realtrace_tpu_torch.render.pipeline import render_with_stats

    cfg = floor_and_spheres(tmp_path)
    arrays = scene.scene_arrays(cfg, tmp_path)
    s = program_scene(arrays, "cpu")
    assert (s.n_triangles, s.n_spheres) == (2, 3)
    assert torch.equal(s.sph_materials.kt, torch.tensor([0.8, 0.0, 0.0]))
    s = _cast(s, torch.float64)
    w, h = cfg["width"], cfg["height"]
    camera = _cast(program_camera(cfg["camera"], w, h, "cpu"), torch.float64)
    img, _ = render_with_stats(s, camera, RenderConfig(max_depth=4, accel="bruteforce"))
    ref = Reference(cfg["render"], "cpu")
    rs = ref.scene(arrays)
    ro, rd = ref.camera_rays(cfg["camera"], w, h, torch.arange(w * h))
    want = ref.trace(rs, ro, rd, Groups(rs["tri_vertices"], sph_center=rs["sph_center"]))
    gap = (img.reshape(-1, 3).double() - want.clamp(0, 1)).abs()
    assert float(gap.max()) < 1e-6
    # the frame shows the floor, each sphere and the background
    _, fam, idx = ref.closest(rs, Groups(rs["tri_vertices"], sph_center=rs["sph_center"]), ro, rd)
    seen = {(int(f), int(i)) for f, i in zip(fam, idx)}
    assert {(1, 0), (1, 1), (2, 0), (2, 1), (2, 2), (0, 0)} <= seen
