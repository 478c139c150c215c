"""The share of the wavefront DP launches' direction buffers that held
useful cells: the sum of `useful_cells` over the sum of `launched_cells` of
the program's `wave_launch` spans in the window
(kernels/hopper_wavefront.py::wavefront_align; a launch computes lq + lt
steps of `width` cells a pair, one block a pair, in a buffer of
pairs x S_pad x width, S_pad the step ladder's rung)."""

from benchmark.progspans import program_spans


def read(tr):
    spans = program_spans()
    if spans is None:
        return None
    launches = [s.attrs for s in spans if s.name == "wave_launch"
                and s.t1 > tr.w0 and s.t0 < tr.w1]
    launched = sum(a.get("launched_cells", 0) for a in launches)
    if not launched:
        return None
    return sum(a.get("useful_cells", 0) for a in launches) / launched
