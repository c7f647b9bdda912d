"""The share of the lanes the wavefront held on its levels 1 and up that
carried energy, over the profiled stretch, %: 100 times the sum of the
program's ``live`` counter over the sum of its ``lanes`` counter on each
``rt.p.level.<k>``, k >= 1 (lanes with a coefficient above zero, and lanes
held: live tiles times 1024, or the repacked lanes of a branching
wavefront). None where the program counts no ``live`` or ``lanes``."""
from rtbench import program


def read(ctx):
    st = program.stretch(ctx)
    if st is None:
        return None
    live = lanes = 0
    for name in {s[0] for s in st.spans if s[0].startswith(program.LEVEL_PREFIX)}:
        if int(name[len(program.LEVEL_PREFIX):]) < 1:
            continue
        for c in st.counters(name) or []:
            if "live" not in c or "lanes" not in c:
                return None
            live += c["live"]
            lanes += c["lanes"]
    return 100.0 * live / lanes if lanes else None
