"""The share of the window the tail stages spent in the native host
engine's DP: the union of the program's `dp.host` spans (kernels/dp.py, one
a native batch) whose ancestor is a tail-stage span (`annotate`,
`annotate.families`, `af`, `liftover`)."""

from benchmark.progspans import TAIL_STAGES, program_spans, under
from benchmark.devtrace import clip, union


def read(tr):
    spans = program_spans()
    if spans is None or not any(s.name in TAIL_STAGES and s.t1 > tr.w0
                                and s.t0 < tr.w1 for s in spans):
        return None
    ivs = [(s.t0, s.t1) for s in under(spans, TAIL_STAGES)
           if s.name == "dp.host"]
    return sum(b - a for a, b in union(clip(ivs, tr.w0, tr.w1))) / \
        (tr.w1 - tr.w0)
