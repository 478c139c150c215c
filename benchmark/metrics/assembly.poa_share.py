"""The share of the window in which a POA consensus call (the native
poa_consensus, wrapped by the benchmark) ran on some thread."""

from benchmark.devtrace import span_share


def read(tr):
    return span_share(tr.spans, {"assembly.poa"}, tr.w0, tr.w1)
