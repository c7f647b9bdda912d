"""The traffic generator: one closed loop of frames or of fit steps, from a
configuration and a traffic mix, driven through the program's entry points.

Two kinds of mix, each a data file (``rtbench/traffic/<mix>.json``):

* ``orbit``: frames of ``render/pipeline.py::render_with_stats``. The camera
  orbits the configuration's target as the flythrough moves it
  (``rtbench/scene.py::orbit_view``), from a yaw and a pitch phase drawn from
  the seed, so that no two frames of a run, nor two seeds, share a view.
  Set-up renders ``warm_units`` frames of the orbit before frame 0. Each
  frame keeps ``check_pixels`` of its pixels, at indices drawn from the seed;
  the check compares those of every frame, or of ``CHECK_FRAMES`` frames
  drawn from the seed in a longer run.
* ``fit``: steps of ``diff/inverse.py::make_train_step`` at the camera
  ``position``: Adam at ``lr`` over ``fields``, the mean squared error
  against a frame the program renders in set-up from the configuration's
  scene with vertex colours and light intensities drawn from the seed in
  ``target``'s ranges. Set-up runs the first ``CHECK_STEPS`` steps and keeps
  their losses, the first gradient as Adam holds it and the parameters'
  change, which the reference follows from the configuration's scene. Every
  step of the loop first copies the parameters and Adam's moments aside, so
  that after the run the reference also follows its last ``WINDOW_STEPS``
  steps, from the program's own state before them. Given a ``mesh`` (a
  configuration with a ``parallel`` block: one rank a card,
  ``rtbench/shard.py``), each rank steps ``parallel/mesh.py``'s sharded
  train step on its pixel tile of the same target, with the scene broadcast
  from rank 0.

Each loop's ``check`` runs the reference (``rtbench/reference.py``) once
the program's state is released, and returns the numbers of
``rtbench/check.py``. ``record`` names what is compared, so that the
control can put the reference's own low-precision record in its place.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rtbench import check, scene
from rtbench.reference import Groups, Reference

PIXEL_ROWS = 97        # pixel sets drawn per run; frame k checks set k % PIXEL_ROWS
CHECK_FRAMES = 64      # frames of a run the check compares, at most (drawn from the seed)
CHECK_STEPS = 3        # the fit's first steps, which the reference follows from the scene
WINDOW_STEPS = 2       # the fit's last steps, which it follows from the program's state
RAY_BLOCK = 1 << 18    # rays the reference traces at once (with gradients: the whole frame)
ADAM = dict(betas=(0.9, 0.999), eps=1e-8)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def program_scene(arrays: dict, device):
    """The program's ``Scene`` (float32) from the benchmark's arrays."""
    from realtrace_tpu_torch.core.types import Materials, SceneBuilder

    b = SceneBuilder(device=device)
    b.ambient = tuple(arrays["ambient"])
    b.background = tuple(arrays["background"])
    for p, i in zip(arrays["light_position"], arrays["light_intensity"]):
        b.add_light(tuple(p), tuple(i))

    def t(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    def mats(m):
        return Materials(**{k: t(v) for k, v in m.items()})

    return dataclasses.replace(
        b.build(), tri_vertices=t(arrays["tri_vertices"]), tri_colors=t(arrays["tri_colors"]),
        tri_materials=mats(arrays["tri_materials"]), sph_center=t(arrays["sph_center"]),
        sph_radius=t(arrays["sph_radius"]), sph_color=t(arrays["sph_color"]),
        sph_materials=mats(arrays["sph_materials"]))


def program_camera(cam: dict, width: int, height: int, device):
    from realtrace_tpu_torch.render.camera import Camera

    return Camera.make(cam["position"], cam["target"], cam["up"], cam["fovy"], width, height,
                       device=device)


class Loop:
    """What the two kinds share: the configuration's arrays and render
    settings, the seed, the device and the ranks' ``mesh`` (None on one
    device)."""

    unit = "rt.unit"

    def __init__(self, config: dict, traffic: dict, seed: int, device, mesh=None):
        self.config, self.traffic, self.seed, self.mesh = config, traffic, seed, mesh
        self.device = torch.device(device)
        self.width, self.height = config["width"], config["height"]
        self.arrays = scene.scene_arrays(config)

    def reference(self, lowp: bool = False) -> Reference:
        return Reference(self.config["render"], self.device, lowp=lowp)


class Orbit(Loop):
    """Closed-loop frames around the orbit (see module doc)."""

    unit = "rt.frame"

    def plan(self) -> None:
        """What the seed draws: the orbit's phases and the pixel sets."""
        self.phases = scene.orbit_phases(self.seed)
        g = torch.Generator(device=self.device).manual_seed(self.seed)
        self.pixels = torch.randint(0, self.width * self.height,
                                    (PIXEL_ROWS, self.traffic["check_pixels"]), generator=g,
                                    device=self.device)

    def view(self, k: int) -> dict:
        return scene.orbit_view(self.config, self.traffic, self.phases, k)

    def setup(self) -> None:
        from realtrace_tpu_torch.core.types import RenderConfig
        from realtrace_tpu_torch.ops import accel

        if self.mesh is not None:
            raise ValueError("the orbit runs on one device")
        self.plan()
        self.cfg = RenderConfig(**self.config["render"])
        self.scene = accel.with_chunks(program_scene(self.arrays, self.device), self.cfg)
        self.samples, self.kept, self.rays = [], [], []
        for k in range(-self.traffic["warm_units"], 0):
            self.frame(k, keep=False)

    def frame(self, k: int, keep: bool = True) -> None:
        from realtrace_tpu_torch.render import pipeline

        camera = program_camera(self.view(k), self.width, self.height, self.device)
        img, nrays = pipeline.render_with_stats(self.scene, camera, self.cfg)
        if keep:
            self.samples.append(img.reshape(-1, 3)[self.pixels[k % PIXEL_ROWS]])
            self.kept.append(k)
            self.rays.append(nrays)
        sync(self.device)

    run = frame

    def release(self) -> None:
        self.record = (torch.stack(self.samples), np.array(self.kept))
        del self.scene, self.samples

    def checked(self, n: int) -> np.ndarray:
        """Which of a run's ``n`` kept frames the check compares: all, or
        ``CHECK_FRAMES`` of them drawn from the seed."""
        if n <= CHECK_FRAMES:
            return np.arange(n)
        return np.sort(np.random.default_rng(self.seed).choice(n, CHECK_FRAMES, replace=False))

    def reference_pixels(self, frames: np.ndarray, lowp: bool = False) -> torch.Tensor:
        """The reference's colours (len(frames), check_pixels, 3) of the
        pixels the orbit's frames ``frames`` keep."""
        ref = self.reference(lowp)
        rs = ref.scene(self.arrays)
        groups = Groups(rs["tri_vertices"], sph_center=rs["sph_center"])
        rays = [ref.camera_rays(self.view(int(f)), self.width, self.height,
                                self.pixels[int(f) % PIXEL_ROWS]) for f in frames]
        ro, rd = torch.cat([r[0] for r in rays]), torch.cat([r[1] for r in rays])
        col = torch.cat([ref.trace(rs, ro[a:a + RAY_BLOCK], rd[a:a + RAY_BLOCK], groups)
                         for a in range(0, ro.shape[0], RAY_BLOCK)])
        return col.clamp(0.0, 1.0).reshape(len(frames), -1, 3)

    def check(self, record) -> dict:
        samples, kept = record
        rows = self.checked(len(kept))
        idx = torch.as_tensor(rows, device=samples.device)
        return check.frame_numbers(samples[idx].reshape(-1, 3),
                                   self.reference_pixels(kept[rows]).reshape(-1, 3))


class Fit(Loop):
    """Closed-loop Adam steps of the inverse renderer (see module doc)."""

    unit = "rt.step"

    def camera(self) -> dict:
        return dict(self.config["camera"], position=self.traffic["position"])

    def plan(self) -> None:
        """What the seed draws: the target frame's vertex colours (N, 3, 3)
        and light intensities (L, 3), on the device; and the names of the
        trained leaves."""
        g = torch.Generator(device=self.device).manual_seed(self.seed)
        n, nl = self.arrays["tri_vertices"].shape[0], self.arrays["light_position"].shape[0]
        (c0, c1), (i0, i1) = self.traffic["target"]["tri_colors"], \
            self.traffic["target"]["light_intensity"]
        self.target_colors = c0 + (c1 - c0) * torch.rand((n, 3, 3), generator=g,
                                                          device=self.device)
        self.target_intensity = i0 + (i1 - i0) * torch.rand((nl, 3), generator=g,
                                                             device=self.device)
        self.leaves = [n for f in self.traffic["fields"] for n in FIELD_LEAVES[f]]

    def setup(self) -> None:
        from realtrace_tpu_torch.core.types import Lights, RenderConfig
        from realtrace_tpu_torch.ops import accel
        from realtrace_tpu_torch.render import pipeline

        self.plan()
        self.cfg = RenderConfig(**self.config["render"])
        base = accel.with_chunks(self.program_scene(), self.cfg)
        camera = program_camera(self.camera(), self.width, self.height, self.device)
        tgt_scene = dataclasses.replace(
            base, tri_colors=self.target_colors,
            lights=Lights(position=base.lights.position, intensity=self.target_intensity))
        with torch.no_grad():
            target = pipeline.render_buffer(tgt_scene, camera, self.cfg)
        self.step, params, self.opt = self.train_step(base, camera, target)
        names, self.params = leaf_names(params)
        if names != self.leaves:
            raise RuntimeError(f"the program trains {names}, the reference {self.leaves}")
        theta0 = [p.detach().clone() for p in self.params]
        beta1 = self.opt.param_groups[0]["betas"][0]
        losses = []
        for k in range(CHECK_STEPS):
            losses.append(self.step())
            if k == 0:
                grad1 = {n: self.opt.state[p]["exp_avg"] / (1.0 - beta1)
                         for n, p in zip(names, self.params)}
        change = {n: p.detach() - p0 for n, p, p0 in zip(names, self.params, theta0)}
        self.first_steps = dict(losses=[float(x) for x in losses], grad1=grad1, change=change)
        self.ring = [[t.detach().clone() for t in self.tensors()] for _ in range(WINDOW_STEPS)]
        self.ring_t, self.ring_loss = [0] * WINDOW_STEPS, [None] * WINDOW_STEPS
        self.units = 0
        sync(self.device)

    def program_scene(self):
        """The program's scene; over ranks, rank 0's on every rank."""
        s = program_scene(self.arrays, self.device)
        if self.mesh is None:
            return s
        from realtrace_tpu_torch.parallel import mesh

        return mesh.replicate_scene(s, self.mesh)

    def train_step(self, scene, camera, target):
        """``(step, params, optimizer)`` of the program's train step against
        ``target``, the flat bottom-up buffer ``render_buffer`` gives; over
        ranks the sharded step, which takes the (H, W, 3) top-down image."""
        kw = dict(lr=self.traffic["lr"], fields=tuple(self.traffic["fields"]))
        if self.mesh is None:
            from realtrace_tpu_torch.diff import inverse

            return inverse.make_train_step(scene, camera, self.cfg, target, **kw)
        from realtrace_tpu_torch.parallel import mesh

        image = torch.flip(target.reshape(self.height, self.width, 3), dims=(0,))
        return mesh.make_sharded_train_step(scene, camera, self.cfg, image, self.mesh, **kw)

    def tensors(self) -> list:
        """The program's state that a step changes: the leaves, then Adam's
        first and second moments of each."""
        st = self.opt.state
        return (list(self.params) + [st[p]["exp_avg"] for p in self.params]
                + [st[p]["exp_avg_sq"] for p in self.params])

    def run(self, k: int) -> None:
        slot = k % WINDOW_STEPS
        with torch.no_grad():
            torch._foreach_copy_(self.ring[slot], self.tensors())
        self.ring_t[slot] = int(self.opt.state[self.params[0]]["step"])
        self.ring_loss[slot] = self.step()
        self.units = k + 1
        sync(self.device)

    def last_steps(self) -> dict:
        """The run's last steps (``WINDOW_STEPS``, or fewer in a shorter
        run): their losses, the first one's gradient (from Adam's first
        moment before and after it), the leaves' change over them, and the
        state before them (``start``: leaves, moments, step count) from which
        the reference follows them."""
        n = min(self.units, WINDOW_STEPS)
        order = [(self.units - n + j) % WINDOW_STEPS for j in range(n)]
        names, np_ = self.leaves, len(self.params)
        before = self.ring[order[0]]
        after = self.ring[order[1]] if n > 1 else [t.detach() for t in self.tensors()]
        b1 = self.opt.param_groups[0]["betas"][0]
        m0, m1 = before[np_:2 * np_], after[np_:2 * np_]
        return dict(
            losses=[float(self.ring_loss[s]) for s in order],
            grad1={k: (b - b1 * a) / (1.0 - b1) for k, a, b in zip(names, m0, m1)},
            change={k: p.detach() - p0 for k, p, p0 in zip(names, self.params, before[:np_])},
            start=dict(leaves=dict(zip(names, before[:np_])), m=dict(zip(names, m0)),
                       v=dict(zip(names, before[2 * np_:])), t=self.ring_t[order[0]]),
            steps=n)

    def release(self) -> None:
        self.record = dict(first=self.first_steps, window=self.last_steps() if self.units else None)
        del self.step, self.opt, self.params, self.ring

    def reference_fit(self, lowp: bool = False, start: dict | None = None,
                      steps: int = WINDOW_STEPS) -> dict:
        """The reference's fit: its own target frame; its first
        ``CHECK_STEPS`` steps from the configuration's scene (``first``);
        then ``steps`` steps from the state ``start`` (the program's, or
        without one the reference's own after its first steps) (``window``).
        Adam is optax's update (bias-corrected moments, eps outside the
        root), as the program's ``torch.optim.Adam``."""
        ref = self.reference(lowp)
        rs = ref.scene(self.arrays)
        groups = Groups(rs["tri_vertices"], sph_center=rs["sph_center"])
        pix = torch.arange(self.width * self.height, device=self.device)
        ro, rd = ref.camera_rays(self.camera(), self.width, self.height, pix)
        tgt = dict(rs, tri_colors=self.target_colors.to(ref.dtype),
                   light_intensity=self.target_intensity.to(ref.dtype))
        with torch.no_grad():
            target = torch.cat([ref.trace(tgt, ro[a:a + RAY_BLOCK], rd[a:a + RAY_BLOCK], groups)
                                for a in range(0, pix.shape[0], RAY_BLOCK)])

        def adam(state: dict, n: int) -> dict:
            leaves = {k: p.to(ref.dtype).clone().requires_grad_(True)
                      for k, p in state["leaves"].items()}
            theta0 = {k: p.detach().clone() for k, p in leaves.items()}
            m = {k: x.to(ref.dtype).clone() for k, x in state["m"].items()}
            v = {k: x.to(ref.dtype).clone() for k, x in state["v"].items()}
            lr, (b1, b2), eps = self.traffic["lr"], ADAM["betas"], ADAM["eps"]
            losses, grad1 = [], None
            for j in range(1, n + 1):
                t = state["t"] + j
                s = with_leaves(rs, leaves)
                groups.refit(s["tri_vertices"])
                loss = torch.mean((ref.trace(s, ro, rd, groups) - target) ** 2)
                grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
                g = {k: torch.zeros_like(p) if gr is None else gr
                     for (k, p), gr in zip(leaves.items(), grads)}
                losses.append(float(loss.detach()))
                if grad1 is None:
                    grad1 = g
                with torch.no_grad():
                    for k, p in leaves.items():
                        m[k] = b1 * m[k] + (1 - b1) * g[k]
                        v[k] = b2 * v[k] + (1 - b2) * g[k] ** 2
                        p -= lr * (m[k] / (1 - b1 ** t)) / (torch.sqrt(v[k] / (1 - b2 ** t)) + eps)
            return dict(losses=losses, grad1=grad1,
                        change={k: leaves[k].detach() - theta0[k] for k in leaves},
                        end=dict(leaves={k: p.detach() for k, p in leaves.items()}, m=m, v=v,
                                 t=state["t"] + n))

        zero = {k: torch.zeros_like(ref_leaf(rs, k)) for k in self.leaves}
        first = adam(dict(leaves={k: ref_leaf(rs, k) for k in self.leaves}, m=zero, v=zero, t=0),
                     CHECK_STEPS)
        window = adam(start or first["end"], steps) if steps else None
        return dict(first=first, window=window)

    def check(self, record) -> dict:
        w = record["window"]
        ref = self.reference_fit(start=w and w["start"], steps=w["steps"] if w else 0)
        return fit_check(record, ref)


def fit_check(program: dict, reference: dict) -> dict:
    """The fit's numbers: those of its first steps, and with the suffix
    ``.window`` the loss and change gaps of the run's last steps. Their
    gradient gap is not compared: late in a fit the vertex gradient is a
    tenth of the first step's, and its gap swings from seed to seed with
    the step count."""
    out = check.fit_numbers(program["first"], reference["first"])
    if program["window"] is not None:
        late = check.fit_numbers(program["window"], reference["window"])
        out.update({f"{k}.window": late[k] for k in ("loss_gap", "change_gap")})
    return out


# the trained fields' leaves, in the program's order (``DIFF_FIELDS``, then
# the dataclasses' fields), and the reference's arrays they stand for
FIELD_LEAVES = {"tri_vertices": ["tri_vertices"], "tri_colors": ["tri_colors"],
                "tri_materials": [f"tri_materials.{k}" for k in scene.MATERIAL_KEYS],
                "lights": ["lights.position", "lights.intensity"]}
REF_LEAVES = {"tri_vertices": "tri_vertices", "tri_colors": "tri_colors",
              "lights.position": "light_position", "lights.intensity": "light_intensity"}


def leaf_names(params: dict) -> tuple[list, list]:
    """The program's parameter leaves in its optimiser's order, with names:
    a field, or ``field.member`` of a dataclass field."""
    names, leaves = [], []
    for k, v in params.items():
        if dataclasses.is_dataclass(v):
            for f in dataclasses.fields(v):
                names.append(f"{k}.{f.name}")
                leaves.append(getattr(v, f.name))
        else:
            names.append(k)
            leaves.append(v)
    return names, leaves


def ref_leaf(rs: dict, name: str) -> torch.Tensor:
    if name.startswith("tri_materials."):
        return rs["tri_materials"][name.split(".", 1)[1]]
    return rs[REF_LEAVES[name]]


def with_leaves(rs: dict, leaves: dict) -> dict:
    """The reference scene with the named leaves in place of its arrays."""
    s = dict(rs, tri_materials=dict(rs["tri_materials"]))
    for n, p in leaves.items():
        if n.startswith("tri_materials."):
            s["tri_materials"][n.split(".", 1)[1]] = p
        else:
            s[REF_LEAVES[n]] = p
    return s


KINDS = {"orbit": Orbit, "fit": Fit}
