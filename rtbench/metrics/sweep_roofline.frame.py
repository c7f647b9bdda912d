"""The closest-hit sweep's share of its roofline, over every closest-mode
``sweep`` call of the profiled stretch: the least time the card could take
for the work the queries' inputs require (``rtbench/roofline.py``), over
the device time of the work launched inside those calls' spans, %.
Any-mode (shadow) calls are left out of both."""
import torch

from rtbench import roofline
from rtbench.reference import Groups


def read(ctx):
    tr = ctx.trace
    if tr is None or not ctx.sweeps:
        return None
    calls = sorted((s for s in tr.spans if s[0] == "rt.sweep.closest"
                    and tr.start <= s[1] < tr.end), key=lambda s: s[1])
    if len(calls) != len(ctx.sweeps):
        return None
    tv = torch.as_tensor(ctx.arrays["tri_vertices"], dtype=torch.float64, device=ctx.device)
    groups = Groups(tv)
    bound = busy = 0.0
    notes = ctx.notes.setdefault("sweep_roofline", [])
    for (_, a, b, _), (ro, rd, t) in zip(calls, ctx.sweeps):
        n_pairs, n_rays = roofline.pairs(ro, rd, t, groups)
        if not n_rays:
            continue
        work = [d for d in tr.device if d[3] is not None and a <= d[3] <= b]
        if not work:
            return None
        call_s = sum(d[2] - d[1] for d in work) / 1e6
        call_bound, by = roofline.bound_s(n_pairs, n_rays, tv.shape[0])
        notes.append({"rays": n_rays, "pairs": n_pairs, "bound_ms": call_bound * 1e3, "by": by,
                      "device_ms": call_s * 1e3})
        busy += call_s
        bound += call_bound
    return 100.0 * bound / busy if busy else None
