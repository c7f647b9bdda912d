"""Calls a frame with which the host waited for the device
(``rtbench/program.py::SYNC_CALLS``: the CUDA runtime's synchronising calls)
in the profiled stretch, whatever made them: the loop's own synchronize
included."""
from rtbench import program


def read(ctx):
    st = program.stretch(ctx)
    return None if st is None else st.syncs_per_unit()
