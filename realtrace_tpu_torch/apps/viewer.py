"""Live interactive viewer: the reference's real-time event loop, in a
terminal.

Counterpart of ``realtrace_tpu/apps/viewer.py``. The reference is a real-time
renderer: a GLUT window with mouse orbit (Parellel/interactions.cu:12-57), a
live FPS title (Parellel/main.cu:79-85) and keyboard save
(Serial/lumina.cpp:424-456). This is the headless equivalent: an event loop
that consumes mouse drags and keys, re-renders each frame on the card, paints
it as ANSI truecolor half-blocks, shows live FPS and Mrays/s in the status
line and the terminal title, and saves a timestamped PNG on 's'.

Controls:
  mouse drag          orbit: left = yaw/pitch, middle = altitude,
                      right = radius (Parellel/interactions.cu:27-57)
  arrow keys          yaw/pitch (keyboard stand-in for the left drag)
  z / x               radius in / out        a / d   altitude down / up
  s                   save a timestamped PNG (Serial/lumina.cpp:424-439)
  q / ESC             quit (Parellel/interactions.cu:59-62)

Run: python -m realtrace_tpu_torch.apps.viewer [--scene mesh|glass|sphere|primitives|obj]
     [--device cpu] [--script KEYS [--batch K]]
"""
from __future__ import annotations

import argparse
import os
import select
import sys
import time

import numpy as np
import torch

from realtrace_tpu_torch.core.types import RenderConfig
from realtrace_tpu_torch.render.camera import InteractiveCamera, mouse_drag
from realtrace_tpu_torch.render.pipeline import render_with_stats, to_rgba8
from realtrace_tpu_torch.utils.profiling import block

# keyboard orbit step: one arrow press = a 12-pixel mouse drag
KEY_DRAG = 12.0

CSI = "\x1b["


# ---------------------------------------------------------------------------
# input parsing (pure, testable)
# ---------------------------------------------------------------------------

def parse_events(buf: str) -> tuple[list, str]:
    """Parse raw terminal input into events; returns (events, unconsumed).

    Events: ("key", ch) with ch in {"up","down","left","right"} or a literal
    character; ("mouse", button, x, y, kind) from SGR mouse reports
    (kind in {"press","drag","release"}, button in {"left","middle","right"}).
    """
    events: list = []
    i = 0
    n = len(buf)
    while i < n:
        c = buf[i]
        if c != "\x1b":
            events.append(("key", c))
            i += 1
            continue
        if buf.startswith(CSI + "<", i):            # SGR mouse: ESC [ < b;x;y (M|m)
            j = i + 3
            k = j
            while k < n and buf[k] not in "Mm":
                k += 1
            if k >= n:                               # incomplete: wait for more
                return events, buf[i:]
            try:
                b, x, y = (int(v) for v in buf[j:k].split(";"))
            except ValueError:
                i = k + 1
                continue
            kind = "release" if buf[k] == "m" else ("drag" if b & 32 else "press")
            button = {0: "left", 1: "middle", 2: "right"}.get(b & 3, "left")
            events.append(("mouse", button, x, y, kind))
            i = k + 1
        elif buf.startswith(CSI, i):
            if i + 2 >= n:
                return events, buf[i:]
            code = buf[i + 2]
            arrows = {"A": "up", "B": "down", "C": "right", "D": "left"}
            if code in arrows:
                events.append(("key", arrows[code]))
            i += 3
        else:
            if i + 1 >= n:
                return events, buf[i:]
            events.append(("key", "\x1b"))           # bare ESC
            i += 1
    return events, ""


def apply_event(cam: InteractiveCamera, event, drag_state: dict) -> str | None:
    """Apply one input event to the orbit camera (mutates ``cam``).

    Returns an action string ("save", "quit") for app-level events, else None.
    ``drag_state`` carries the last mouse position between drag events.
    """
    if event[0] == "mouse":
        _, button, x, y, kind = event
        if kind == "press":
            drag_state["pos"] = (x, y)
        elif kind == "drag" and "pos" in drag_state:
            lx, ly = drag_state["pos"]
            # terminal cells are ~half as wide as tall: scale dx to pixels
            mouse_drag(cam, button, (x - lx) * 4.0, (y - ly) * 8.0)
            drag_state["pos"] = (x, y)
        elif kind == "release":
            drag_state.pop("pos", None)
        return None
    _, ch = event
    if ch in ("q", "\x1b", "\x03"):
        return "quit"
    if ch == "s":
        return "save"
    if ch == "up":
        mouse_drag(cam, "left", 0.0, -KEY_DRAG)
    elif ch == "down":
        mouse_drag(cam, "left", 0.0, KEY_DRAG)
    elif ch == "left":
        mouse_drag(cam, "left", -KEY_DRAG, 0.0)
    elif ch == "right":
        mouse_drag(cam, "left", KEY_DRAG, 0.0)
    elif ch == "z":
        cam.change_radius(-0.1)
    elif ch == "x":
        cam.change_radius(0.1)
    elif ch == "a":
        cam.change_altitude(-0.5)
    elif ch == "d":
        cam.change_altitude(0.5)
    return None


# ---------------------------------------------------------------------------
# ANSI frame painting
# ---------------------------------------------------------------------------

def ansi_frame(img: np.ndarray, status: str = "") -> str:
    """Render a (H, W, 3) uint8 image as truecolor half-blocks (2 pixels per
    terminal cell: fg = upper, bg = lower) with a status line on top.
    Emits color escapes only on change; H is truncated to even."""
    h = img.shape[0] - (img.shape[0] % 2)
    out = [CSI + "H", CSI + "2K", status, "\r\n"]
    last = None
    for y in range(0, h, 2):
        top, bot = img[y], img[y + 1]
        for x in range(img.shape[1]):
            key = (int(top[x, 0]), int(top[x, 1]), int(top[x, 2]),
                   int(bot[x, 0]), int(bot[x, 1]), int(bot[x, 2]))
            if key != last:
                out.append(f"{CSI}38;2;{key[0]};{key[1]};{key[2]}m"
                           f"{CSI}48;2;{key[3]};{key[4]};{key[5]}m")
                last = key
            out.append("▀")
        out.append(CSI + "0m\r\n")
        last = None
    return "".join(out)


# ---------------------------------------------------------------------------
# the viewer app
# ---------------------------------------------------------------------------

class Viewer:
    """Interactive render loop around ``render_with_stats`` on the scene's
    device; a frame becomes uint8 RGBA on the device (``to_rgba8``) before
    it is copied to the host."""

    def __init__(self, scene, orbit: InteractiveCamera, cfg: RenderConfig,
                 out=None, save_dir: str = "."):
        self.scene = scene
        self.orbit = orbit
        self.cfg = cfg
        self.device = scene.tri_vertices.device
        self.out = out if out is not None else sys.stdout
        self.save_dir = save_dir
        self.drag_state: dict = {}
        self._inbuf = ""   # carry-over for escape sequences split across reads
        self.fps = 0.0
        self.mrays = 0.0
        self.frames = 0
        self.last_img: np.ndarray | None = None

    def _camera(self):
        return self.orbit.build_render_camera(dtype=self.scene.dtype, device=self.device)

    def _frame(self, camera):
        """(uint8 RGBA (H, W, 4) on the device, traced rays) of one frame."""
        with torch.no_grad():
            img, nrays = render_with_stats(self.scene, camera, self.cfg)
        return to_rgba8(img), nrays

    def render(self) -> np.ndarray:
        t0 = time.perf_counter()
        rgba, nrays = self._frame(self._camera())
        img = block(rgba).cpu().numpy()
        dt = time.perf_counter() - t0
        inst = 1.0 / max(dt, 1e-9)
        # EMA like a 1s-window FPS counter (Parellel/main.cu:79-85)
        self.fps = inst if self.frames == 0 else 0.8 * self.fps + 0.2 * inst
        self.mrays = float(nrays) / max(dt, 1e-9) / 1e6
        self.frames += 1
        self.last_img = img[..., :3]
        return self.last_img

    def status(self) -> str:
        # the live FPS title analog (TITLE_STRING, Parellel/interactions.h:6)
        return (f"realtrace_tpu_torch | FPS: {self.fps:5.1f} | {self.mrays:6.1f} Mrays/s | "
                f"arrows/drag orbit  z/x radius  a/d altitude  s save  q quit")

    def paint(self) -> None:
        img = self.last_img if self.last_img is not None else self.render()
        self.out.write(ansi_frame(img, self.status()))
        self.out.write(f"\x1b]0;realtrace_tpu_torch FPS: {self.fps:.1f}\x07")  # window title
        self.out.flush()

    def save(self) -> str:
        """Timestamped PNG save, ref SaveImage (Serial/lumina.cpp:424-439)."""
        from realtrace_tpu_torch.io.image import save_png
        if self.last_img is None:
            self.render()
        os.makedirs(self.save_dir, exist_ok=True)
        path = os.path.join(self.save_dir, time.strftime("%Y%m%d%H%M%S") + ".png")
        save_png(path, self.last_img)
        return path

    def handle_input(self, data: str, flush: bool = False) -> bool:
        """Apply a chunk of raw input; returns False when the app should quit.

        Unconsumed bytes (an escape sequence split across reads, or the
        one-char-at-a-time scripted feed) carry over to the next call via
        ``self._inbuf``. ``flush=True`` (input went idle) consumes a pending
        lone ESC as the quit key instead of waiting for a continuation."""
        buf = self._inbuf + data
        events, rest = parse_events(buf)
        if flush and rest:
            events.append(("key", rest[0]))
            rest = rest[1:]
        self._inbuf = rest
        dirty = False
        for ev in events:
            action = apply_event(self.orbit, ev, self.drag_state)
            if action == "quit":
                return False
            if action == "save":
                path = self.save()
                self.out.write(f"\r\nsaved {path}\r\n")
                self.out.flush()
                continue
            dirty = True
        if dirty:
            self.render()
        return True

    # -- interactive loop --------------------------------------------------
    def run(self, max_frames: int | None = None) -> None:
        import termios
        import tty

        fd = sys.stdin.fileno()
        old = termios.tcgetattr(fd)
        tty.setcbreak(fd)
        # hide cursor, clear, enable SGR mouse drag reporting
        self.out.write(CSI + "?25l" + CSI + "2J" + CSI + "?1002h" + CSI + "?1006h")
        try:
            self.render()
            self.paint()
            while max_frames is None or self.frames < max_frames:
                r, _, _ = select.select([fd], [], [], 0.05)
                if not r:
                    if self._inbuf and not self.handle_input("", flush=True):
                        break             # lone ESC resolved by the idle gap
                    continue
                data = os.read(fd, 4096).decode(errors="ignore")
                if not self.handle_input(data):
                    break
                self.paint()
        finally:
            termios.tcsetattr(fd, termios.TCSADRAIN, old)
            self.out.write(CSI + "?1002l" + CSI + "?1006l" + CSI + "?25h" + CSI + "0m\n")
            self.out.flush()

    # -- scripted (headless) loops: test and demo drivers -------------------
    def run_script(self, keys: str) -> None:
        """Drive the viewer with a synthetic key string (no tty needed), one
        render and one host copy per orbit-moving key."""
        self.render()
        for ch in keys:
            if not self.handle_input(ch):
                return
        if self._inbuf:
            self.handle_input("", flush=True)   # trailing lone ESC = quit

    def run_script_batched(self, keys: str, batch: int = 8) -> None:
        """Scripted orbit motion, ``batch`` frames per host copy.

        Applies the whole key script first (collecting the camera after every
        orbit-moving key, stopping at a quit), then renders the cameras back
        to back, each frame turned into uint8 RGBA on the device, and copies
        each batch's stack to the host once. One untimed warm-up frame comes
        first; the FPS and Mrays/s stats cover the whole timed run."""
        cams = []
        quit_seen = False
        for ch in keys:
            events, rest = parse_events(self._inbuf + ch)
            self._inbuf = rest
            for ev in events:
                action = apply_event(self.orbit, ev, self.drag_state)
                if action == "quit":
                    quit_seen = True
                    break
                if action == "save":
                    continue
                cams.append(self._camera())
            if quit_seen:
                break
        if not cams:
            return
        block(self._frame(cams[0])[0])                  # warm-up (kernel build, caches)
        t0 = time.perf_counter()
        total_rays = 0.0
        for s in range(0, len(cams), batch):
            frames = [self._frame(c) for c in cams[s:s + batch]]
            imgs = torch.stack([f[0] for f in frames]).cpu().numpy()   # one host copy
            total_rays += float(sum(f[1] for f in frames))
        dt = max(time.perf_counter() - t0, 1e-9)
        self.frames += len(cams)
        self.fps = len(cams) / dt
        self.mrays = total_rays / dt / 1e6
        self.last_img = imgs[-1][..., :3]


def _build(scene_name: str, cfg: RenderConfig, width: int, height: int, device, obj=None):
    from realtrace_tpu_torch.apps import scenes as S
    from realtrace_tpu_torch.ops import accel

    if scene_name == "sphere":
        scene, cam = S.sphere_plane_scene(device=device)
    elif scene_name == "primitives":
        scene, cam = S.full_primitive_scene(device=device)
    elif scene_name == "glass":
        scene, cam = S.glass_mesh_scene(device=device)
    elif scene_name == "obj":
        if obj is None:
            raise SystemExit("--scene obj needs --obj")
        scene, cam = S.serial_obj_scene(obj, device=device)
    else:
        scene, cam = S.mesh_scene(device=device)
    if cfg.accel != "bruteforce" and scene.n_triangles:
        scene = accel.with_chunks(scene, cfg)
    pos = np.asarray(cam["position"], np.float64)
    orbit = InteractiveCamera(center=np.zeros(3), radius=float(np.linalg.norm(pos)),
                              resolution=(width, height))
    # start at the preset camera's spherical coordinates
    d = pos / np.linalg.norm(pos)
    orbit.pitch = float(np.arcsin(np.clip(d[1], -1, 1)))
    orbit.yaw = float(np.arctan2(d[0], d[2]))
    return scene, orbit


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="realtrace_tpu_torch live terminal viewer")
    p.add_argument("--scene", default="mesh",
                   choices=("mesh", "glass", "sphere", "primitives", "obj"))
    p.add_argument("--obj", default=None, help="OBJ mesh for --scene obj (serial app setup)")
    p.add_argument("--width", type=int, default=0, help="render width (0 = fit terminal)")
    p.add_argument("--height", type=int, default=0)
    p.add_argument("--depth", type=int, default=2)
    p.add_argument("--accel", choices=("bruteforce", "chunked", "sweep"), default="sweep",
                   help="'chunked' is approximate")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; fails without a card) or cpu")
    p.add_argument("--script", default=None,
                   help="synthetic key string (headless demo/test mode)")
    p.add_argument("--batch", type=int, default=0,
                   help="with --script: frames per host copy (0 = a copy per frame)")
    p.add_argument("--save-dir", default=".")
    args = p.parse_args(argv)

    w, h = args.width, args.height
    if not w or not h:
        ts = os.get_terminal_size() if sys.stdout.isatty() else os.terminal_size((96, 28))
        w = w or ts.columns
        h = h or max(2 * (ts.lines - 3), 32)
    cfg = RenderConfig(max_depth=args.depth, accel=args.accel)
    scene, orbit = _build(args.scene, cfg, w, h, torch.device(args.device), args.obj)
    viewer = Viewer(scene, orbit, cfg, save_dir=args.save_dir)
    if args.script is not None:
        if args.batch > 1:
            viewer.run_script_batched(args.script, batch=args.batch)
        else:
            viewer.run_script(args.script)
        sys.stdout.write(viewer.status() + "\n")
    else:
        viewer.run()


if __name__ == "__main__":
    main()
