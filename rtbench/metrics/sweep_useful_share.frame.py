"""The share of the (ray, triangle) pairs the closest-hit sweep tested that
its queries required, over every closest-mode ``sweep`` call of the profiled
stretch, %: 100 times the pairs the queries' inputs require
(``rtbench/roofline.py::pairs``, ray by ray, as ``sweep_roofline`` reckons
them) over the pairs the kernels tested in the same calls (the program's
``tested`` counter of each call: positions a warp tested, times its rays,
times the chunk size). The earlier line gets the same by the call's place in
its frame (``sweep_useful_share``: required and tested pairs a frame)."""
import bisect

import torch

from rtbench import program, roofline
from rtbench.reference import Groups


def read(ctx):
    st = program.stretch(ctx)
    if st is None or not ctx.sweeps:
        return None
    counted = st.counters("rt.p.kernel.closest")
    if counted is None or len(counted) != len(ctx.sweeps):
        return None
    calls = [s for s in st.spans if s[0] == "rt.p.kernel.closest"]
    tv = torch.as_tensor(ctx.arrays["tri_vertices"], dtype=torch.float64, device=ctx.device)
    groups = Groups(tv)
    units = st.unit_starts()
    by_place: dict = {}
    seen: dict = {}
    required = tested = 0
    for span, (ro, rd, t), c in zip(calls, ctx.sweeps, counted):
        need = roofline.pairs(ro, rd, t, groups)[0]
        done = c["tested"] * c["warp_rays"] * c["chunk"]
        required += need
        tested += done
        unit = bisect.bisect_right(units, span[1]) - 1
        place = seen[unit] = seen.get(unit, -1) + 1
        row = by_place.setdefault(place, [0, 0])
        row[0] += need
        row[1] += done
    ctx.notes["sweep_useful_share"] = {k: [st.per_unit(a), st.per_unit(b)]
                                       for k, (a, b) in sorted(by_place.items())}
    return 100.0 * required / tested if tested else None
