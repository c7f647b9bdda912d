"""The PyTorch port's apps against the JAX package: the viewer's event
parsing, orbit and painting, the scripted viewer, the flythrough, the sample
apps, the native OBJ parser, the CUDA app's scene and the CLI scenes. CPU
only; inputs from numpy."""
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtrace_tpu.apps import samples as jsamples
from realtrace_tpu.apps import scenes as jscenes
from realtrace_tpu.apps import viewer as jviewer
from realtrace_tpu.apps.flythrough import run_flythrough as jrun_flythrough
from realtrace_tpu.core.types import RenderConfig as JConfig
from realtrace_tpu.io import native_obj as jnative_obj
from realtrace_tpu.render.camera import InteractiveCamera as JInteractive
from realtrace_tpu_torch.apps import cli, samples, scenes, viewer
from realtrace_tpu_torch.apps.flythrough import run_flythrough
from realtrace_tpu_torch.core.convert import scene_to_numpy
from realtrace_tpu_torch.core.types import RenderConfig
from realtrace_tpu_torch.io import native_obj
from realtrace_tpu_torch.io import obj as objmod
from realtrace_tpu_torch.io.image import load_png
from realtrace_tpu_torch.render.camera import InteractiveCamera
from test_torch_core import few_torch_threads, to_port  # noqa: F401 (autouse fixture)

INPUTS = ["abc", "\x1b[A\x1b[B\x1b[C\x1b[D", "\x1b[<0;10;5M\x1b[<32;12;7M\x1b[<0;12;7m",
          "\x1b[<2;3;4M\x1b[<33;1;2M", "\x1b[<1;5", "x\x1b[", "\x1b", "q\x1bz",
          "\x1b[<a;b;cM s", "\x1b[Z\x1b[<64;1;1M"]


@pytest.mark.parametrize("buf", INPUTS)
def test_parse_events_matches_jax(buf):
    assert viewer.parse_events(buf) == jviewer.parse_events(buf)


def test_apply_event_matches_jax():
    events = [e for buf in INPUTS[:4] + ["zxadxs", "\x1b[<1;4;4M\x1b[<33;9;1M", "q"]
              for e in jviewer.parse_events(buf)[0]]
    a, b = InteractiveCamera(radius=40.0), JInteractive(radius=40.0)
    da, db = {}, {}
    for ev in events:
        assert viewer.apply_event(a, ev, da) == jviewer.apply_event(b, ev, db)
        assert (a.yaw, a.pitch, a.radius) == (b.yaw, b.pitch, b.radius) and da == db
        np.testing.assert_array_equal(a.center, b.center)


def test_ansi_frame_matches_jax():
    img = np.random.default_rng(5).integers(0, 256, (7, 6, 3), dtype=np.uint8)
    img[2:4] = 17                                  # runs of one colour: escapes only on change
    assert viewer.ansi_frame(img, "status") == jviewer.ansi_frame(img, "status")


def tiny_viewer(tmp_path):
    scene, _ = scenes.sphere_plane_scene(device="cpu")
    orbit = InteractiveCamera(radius=85.0, pitch=0.78, resolution=(32, 16))
    return viewer.Viewer(scene, orbit, RenderConfig(max_depth=1), out=io.StringIO(),
                         save_dir=str(tmp_path))


def test_viewer_batched_script_matches_per_frame(tmp_path):
    script = "\x1b[C\x1b[C\x1b[A" + "z"
    a = tiny_viewer(tmp_path)
    a.run_script(script)
    b = tiny_viewer(tmp_path)
    b.run_script_batched(script, batch=3)
    assert (a.orbit.yaw, a.orbit.pitch, a.orbit.radius) == (b.orbit.yaw, b.orbit.pitch,
                                                            b.orbit.radius)
    assert b.frames == 4 and a.frames == 5
    np.testing.assert_array_equal(a.last_img, b.last_img)
    c = tiny_viewer(tmp_path)
    c.run_script_batched(script[:6] + "q" + "\x1b[Azz", batch=2)   # nothing after the quit
    assert c.frames == 2 and c.orbit.radius == 85.0


def test_viewer_save_paint_and_status(tmp_path):
    v = tiny_viewer(tmp_path / "shots")
    v.render()
    assert v.handle_input("\x1b[<0;10;5M\x1b[<32;20;9M\x1b[<0;20;9m")   # a mouse drag orbits
    assert v.orbit.yaw != 0.0
    assert v.handle_input("s")
    pngs = list((tmp_path / "shots").glob("*.png"))
    assert len(pngs) == 1 and load_png(pngs[0]).shape == (16, 32, 3)
    assert "FPS" in v.status() and "Mrays" in v.status()
    v.paint()
    assert v.out.getvalue().count("▀") == 32 * 8              # 32 columns, 8 cell rows
    assert v.handle_input("\x1b") and not v.handle_input("", flush=True)   # lone ESC quits


def test_viewer_main_scripted(tmp_path, capsys):
    viewer.main(["--scene", "sphere", "--width", "32", "--height", "16", "--depth", "1",
                 "--device", "cpu", "--accel", "bruteforce", "--script", "\x1b[Czsq",
                 "--save-dir", str(tmp_path)])
    assert list(tmp_path.glob("*.png")) and "FPS" in capsys.readouterr().out
    viewer.main(["--scene", "mesh", "--width", "32", "--height", "16", "--depth", "1",
                 "--device", "cpu", "--script", "\x1b[C\x1b[C", "--batch", "2"])
    assert "Mrays/s" in capsys.readouterr().out


def test_flythrough_matches_jax():
    jscene, _ = jscenes.sphere_plane_scene(dtype=jnp.float64)

    def orbit(cls):
        return cls(radius=85.0, pitch=0.6, resolution=(32, 16))

    want, _ = jrun_flythrough(jscene, orbit(JInteractive), JConfig(max_depth=2), frames=3,
                              dtype=jnp.float64)
    got, fps = run_flythrough(to_port(jscene), orbit(InteractiveCamera), RenderConfig(max_depth=2),
                              frames=3)
    assert len(got) == 3 and fps > 0
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-12)


def test_samples_match_jax():
    for w, h, pos in ((16, 16, (8, 8)), (48, 32, (30.5, 11.25))):
        np.testing.assert_array_equal(samples.flashlight(w, h, pos, device="cpu").numpy(),
                                      np.asarray(jsamples.flashlight(w, h, pos)))
    for sys_ in (0, 1, 2, 3):          # 3 takes van der Pol, as the JAX code does
        for param in (0.1, -0.3):
            np.testing.assert_array_equal(
                samples.stability(16, 16, param, sys_, device="cpu").numpy(),
                np.asarray(jsamples.stability(16, 16, param, sys_)))


def write_obj(path):
    """A small OBJ of the coarse procedural mesh: shared vertices, UVs and
    normals, every face form (v, v/vt, v//vn, v/vt/vn), a quad, a tab."""
    tv, _ = scenes.mesh_arrays(seed=2, detail=0.12)
    rng = np.random.default_rng(2)
    lines = ["# generated", "o mesh"]
    for tri in tv:
        for p in tri:
            lines.append("v {:.9f} {:.9f} {:.9f}".format(*p))
    for _ in range(3 * len(tv)):
        lines.append("vt {:.6f} {:.6f}".format(*rng.uniform(0, 1, 2)))
        lines.append("vn 0 1 0")
    for k in range(len(tv)):
        a, b, c = 3 * k + 1, 3 * k + 2, 3 * k + 3
        form = k % 5
        if form == 0:
            lines.append(f"f {a} {b} {c}")
        elif form == 1:
            lines.append(f"f {a}/{a} {b}/{b} {c}/{c}")
        elif form == 2:
            lines.append(f"f {a}//{a} {b}//{b} {c}//{c}")
        elif form == 3:
            lines.append(f"f {a}/{a}/{a} {b}/{b}/{b} {c}/{c}/{c}")
        else:
            lines.append(f"\tf {a}/{a}/{a} {b}/{b}/{b} {c}/{c}/{c} 1/1/1")   # a quad's first three
    path.write_text("\n".join(lines) + "\n")
    return len(tv)


@pytest.fixture(scope="module")
def obj_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("obj") / "mesh.obj"
    return path, write_obj(path)


def test_native_parser_is_used_and_matches(obj_file, monkeypatch):
    path, n = obj_file
    mesh = objmod.parse_obj(path, scale=2.0, max_faces=n - 3)
    assert native_obj._lib is not None and native_obj.library_path().exists()
    v, vn, vt, fv, ft = native_obj.parse(path)
    for got, want in zip((v, vn, vt, fv, ft), jnative_obj.parse(path)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    monkeypatch.setattr(objmod, "_try_native", lambda p: None)
    py = objmod.parse_obj(path, scale=2.0, max_faces=n - 3)
    assert mesh.n_faces == py.n_faces == n - 3
    for f in ("vertices", "tri_vertex_idx", "tri_uv_idx", "uvs"):
        np.testing.assert_array_equal(getattr(mesh, f), getattr(py, f))
    np.testing.assert_array_equal(mesh.triangles, 2.0 * v[fv[:n - 3]])


def test_parallel_obj_scene_matches_jax(obj_file):
    path, _ = obj_file
    got, cam = scenes.parallel_obj_scene(path, dtype=torch.float64, device="cpu", max_faces=40)
    want, jcam = jscenes.parallel_obj_scene(path, dtype=jnp.float64, max_faces=40)
    assert cam == jcam and got.n_triangles == 2 * 40 + 2
    a, b = scene_to_numpy(got), scene_to_numpy(want)
    for k, v in a.items():
        if isinstance(v, dict):
            for kk in v:
                np.testing.assert_array_equal(v[kk], b[k][kk], err_msg=f"{k}.{kk}")
        elif v is not None:
            np.testing.assert_array_equal(v, b[k], err_msg=k)


@pytest.mark.parametrize("scene", ["parallel", "primitives"])
def test_cli_scenes(scene, obj_file, tmp_path, capsys):
    path, _ = obj_file
    out = tmp_path / f"{scene}.png"
    extra = ["--obj", str(path), "--max-faces", "60"] if scene == "parallel" else []
    assert cli.main(["--scene", scene, *extra, "--width", "32", "--height", "24", "--depth", "2",
                     "--device", "cpu", "--out", str(out)]) == 0
    img = load_png(out)
    assert img.shape == (24, 32, 3) and img.std() > 0.01
    assert "Image saved as" in capsys.readouterr().err


def test_cli_default_output_is_timestamped(tmp_path, monkeypatch):
    """Without --out the CLI writes one 'RealTraceTPU <date>.png' into the
    working directory, as the JAX CLI does."""
    monkeypatch.chdir(tmp_path)
    assert cli.main(["--scene", "sphere_plane", "--width", "16", "--height", "12", "--depth", "1",
                     "--device", "cpu"]) == 0
    written = list(tmp_path.iterdir())
    assert len(written) == 1 and written[0].name.startswith("RealTraceTPU ")
    assert written[0].suffix == ".png" and load_png(written[0]).shape == (12, 16, 3)


@pytest.mark.parametrize("scene", ["primitives", "parallel", "sphere_plane", "glass"])
def test_cli_refuses_copies_without_a_duplicated_form(scene, obj_file, tmp_path):
    with pytest.raises(SystemExit) as e:
        cli.main(["--scene", scene, "--obj", str(obj_file[0]), "--copies", "2", "--device", "cpu",
                  "--out", str(tmp_path / "x.png")])
    assert e.value.code != 0 and not (tmp_path / "x.png").exists()


@pytest.mark.parametrize("args,tris,spheres", [
    (["--scene", "serial", "--copies", "3"], 3 * 60, 0),
    (["--scene", "glass"], 60, 1)], ids=["serial-copies", "glass-obj"])
def test_cli_obj_scenes(args, tris, spheres, obj_file, tmp_path, capsys):
    """--scene serial --obj --copies N is duplicated_serial_scene, --scene
    glass --obj is glass_bob_scene."""
    out = tmp_path / "obj.png"
    assert cli.main([*args, "--obj", str(obj_file[0]), "--max-faces", "60", "--width", "24",
                     "--height", "16", "--depth", "2", "--device", "cpu", "--out", str(out)]) == 0
    err = capsys.readouterr().err
    assert f"scene: {tris} tris, {spheres} spheres" in err
    assert load_png(out).shape == (16, 24, 3)
