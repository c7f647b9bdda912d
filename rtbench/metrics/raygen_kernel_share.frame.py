"""The share of the profiled stretch's primary rays that the program's ray
generation kernel made, %: 100 times the sum of the ``rays`` counter of the
program's ``rt.p.kernel.raygen`` spans (the slots each launch made) over the
sum of the ``rays`` counter of its ``rt.p.raygen`` spans (the slots each
frame's ray generation made). None where the program counts no rays in
``rt.p.raygen``."""
from rtbench import program


def read(ctx):
    st = program.stretch(ctx)
    if st is None:
        return None
    made = st.counters("rt.p.raygen")
    if not made or any("rays" not in c for c in made):
        return None
    rays = sum(c["rays"] for c in made)
    kernel = sum(c.get("rays", 0) for c in st.counters("rt.p.kernel.raygen") or [])
    return 100.0 * kernel / rays if rays else None
