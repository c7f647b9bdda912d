"""Device time a frame of the work launched inside the program's spans
``rt.p.repack`` (the branching wavefront's lane compaction and its
per-pixel accumulation) in the profiled stretch, ms. None where the
program has no such span."""
from rtbench import program


def read(ctx):
    st = program.stretch(ctx)
    if st is None or not st.trace.device:
        return None
    iv = st.intervals({"rt.p.repack"})
    return st.launched(iv)[0] if iv else None
