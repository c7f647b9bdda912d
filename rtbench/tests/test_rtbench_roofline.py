"""The roofline's pair count against a brute-force slab count, and its
arithmetic."""
import numpy as np
import pytest
import torch

from rtbench import roofline, scene
from rtbench.reference import GROUP, Groups, Reference, median_split
from rtbench.tests.conftest import tiny


def slab_loop(o, d, lo, hi):
    """Entry and exit distance of one ray through one box, axis by axis."""
    tn, tf = 0.0, float("inf")
    for ax in range(3):
        if d[ax] == 0.0:
            if not lo[ax] <= o[ax] <= hi[ax]:
                return 1.0, 0.0
            continue
        a, b = (lo[ax] - o[ax]) / d[ax], (hi[ax] - o[ax]) / d[ax]
        tn, tf = max(tn, min(a, b)), min(tf, max(a, b))
    return tn, tf


def test_pairs_equal_a_brute_force_slab_count():
    cfg = dict(tiny("bob_1080p"), scene=dict(tiny("bob_1080p")["scene"], copies=2))
    cfg = dict(cfg, camera={"position": [60.0, 60.0, 0.0], "target": [0.0, 0.0, 0.0],
                            "up": [0.0, 1.0, 0.0], "fovy": 45.0})
    tv = scene.scene_arrays(cfg)["tri_vertices"]
    ref = Reference(dict(max_depth=0), "cpu")
    rs = ref.scene(scene.scene_arrays(cfg))
    g = torch.Generator().manual_seed(5)
    ro, rd = ref.camera_rays(cfg["camera"], 40, 30, torch.randint(0, 1200, (300,), generator=g))
    t, fam, _ = ref.closest(rs, Groups(rs["tri_vertices"]), ro, rd)
    t = torch.where(fam > 0, t, torch.full_like(t, 1e30)).float()
    ro32, rd32 = ro.float().clone(), rd.float().clone()
    ro32[:7] = 1e8                                   # parked lanes are no rays
    n_pairs, n_rays = roofline.pairs(ro32, rd32, t, Groups(torch.as_tensor(tv)))

    perm = median_split(tv).reshape(-1, GROUP)
    want = 0
    for o, d, th in zip(ro32[7:].double().numpy(), rd32[7:].double().numpy(),
                        t[7:].double().numpy()):
        th = np.inf if th >= 1e29 else th
        for grp in perm:
            box = tv[grp].reshape(-1, 3)
            tn, tf = slab_loop(o, d, box.min(0), box.max(0))
            if tf >= tn and tn <= th:
                want += len(set(grp.tolist()))
    assert n_rays == 293 and n_pairs == want
    assert 0 < want < 293 * tv.shape[0]


def test_bound_is_the_larger_of_operations_and_bytes():
    s, by = roofline.bound_s(10 ** 9, 2 * 10 ** 6, 10 ** 4)
    assert by == "operations" and s == pytest.approx(1e9 * 38 / 33.5e12)
    s, by = roofline.bound_s(0, 2 * 10 ** 6, 10 ** 4)
    assert by == "bytes" and s == pytest.approx((2e6 * 32 + 1e4 * 36) / 3.35e12)
