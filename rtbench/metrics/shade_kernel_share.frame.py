"""The share of the wavefront's lanes whose hit attributes and shading ran
through the program's level kernels, over the profiled stretch, %: 100 times
the sum of the ``lanes`` counter of the program's ``rt.p.kernel.shade``
spans (the rows each launch of the shading kernel took) over the sum of the
``lanes`` counter of every ``rt.p.level.<k>`` (the lanes each level held).
None where the program counts no such span."""
from rtbench import program


def read(ctx):
    st = program.stretch(ctx)
    if st is None:
        return None
    shaded = st.counters("rt.p.kernel.shade")
    if not shaded:
        return None
    lanes = 0
    for name in {s[0] for s in st.spans if s[0].startswith(program.LEVEL_PREFIX)}:
        for c in st.counters(name) or []:
            if "lanes" not in c:
                return None
            lanes += c["lanes"]
    return 100.0 * sum(c["lanes"] for c in shaded) / lanes if lanes else None
