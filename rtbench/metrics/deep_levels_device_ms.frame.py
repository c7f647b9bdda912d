"""Device time a frame of the work launched inside the program's spans of
the wavefront's levels 2 and up (``rt.p.level.<k>``, k >= 2: each holds its
level's shading, its shadow query and its children's query) in the profiled
stretch, ms."""
from rtbench import program


def read(ctx):
    st = program.stretch(ctx)
    return None if st is None else st.deep_levels_device_ms()
