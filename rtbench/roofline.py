"""The closest-hit query's roofline, reckoned from the query's inputs.

The work a closest query requires does not depend on what implements it:
for each ray, the triangles of every reference group (``reference.Groups``:
a median split into groups of 32, built from the scene arrays) whose box the
ray's segment enters before the ray's closest hit, or anywhere along the ray
where it misses. Each (ray, triangle) pair costs ``PAIR_INSTRUCTIONS``
unfused FP32 instructions (18 multiplies and 15 adds and subtractions for
the four Cramer forms, then 3 multiplies, 1 add and 1 division for the
divided tests); each ray is read once (origin and direction, 24 bytes) and
its hit written once (8 bytes), and each triangle read once (9 floats). The
bound is the larger of the two times at the H100 SXM's data-sheet peaks: 67
TFLOP/s FP32 counts a fused multiply-add as two operations, so unfused
instructions run at half that; HBM3 at 3.35 TB/s.
"""
from __future__ import annotations

import torch
from torch import Tensor

from rtbench.reference import PAD, Groups, _inv, slab

FP32_INSTR_PER_S = 67e12 / 2
HBM_BYTES_PER_S = 3.35e12
PAIR_INSTRUCTIONS = 38
RAY_BYTES = 24
HIT_BYTES = 8
TRI_BYTES = 36
PARK = 1e8            # the program's parked-lane origin (x), which is no ray
MISS = 1e29           # distances from here up are misses (the program's BIG is 1e30)
SLAB_ELEMS = 1 << 23


@torch.no_grad()
def pairs(ro: Tensor, rd: Tensor, t_hit: Tensor, groups: Groups) -> tuple[int, int]:
    """(pairs, rays): the (ray, triangle) pairs the closest query of the live
    rays (ro, rd) (R, 3) with closest-hit distances ``t_hit`` (R,) requires,
    and the number of live rays."""
    lo, hi = groups.lo.double(), groups.hi.double()
    count = groups.count.to(torch.int64)
    live = ro[:, 0] != PARK
    ro, rd, t = ro[live].double(), rd[live].double(), t_hit[live].double()
    t = torch.where(t >= MISS, torch.full_like(t, float("inf")), t)
    total = 0
    block = max(1, SLAB_ELEMS // lo.shape[0])
    for a in range(0, ro.shape[0], block):
        tn, tf = slab(ro[a:a + block, None], _inv(rd[a:a + block])[:, None], lo[None], hi[None])
        enter = (tf * (1.0 + PAD[torch.float64]) + PAD[torch.float64] >= tn) \
            & (tn <= t[a:a + block, None])
        total += int((enter.to(torch.int64) * count[None]).sum())
    return total, int(ro.shape[0])


def bound_s(n_pairs: int, n_rays: int, n_tris: int) -> tuple[float, str]:
    """(seconds, "operations" or "bytes"): the least time the card could
    take for the query."""
    ops = n_pairs * PAIR_INSTRUCTIONS / FP32_INSTR_PER_S
    nbytes = (n_rays * (RAY_BYTES + HIT_BYTES) + n_tris * TRI_BYTES) / HBM_BYTES_PER_S
    return max((ops, "operations"), (nbytes, "bytes"))

