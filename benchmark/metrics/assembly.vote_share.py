"""The share of the window the assembly vote (device_vote.vote_many,
wrapped by the benchmark) took."""

from benchmark.devtrace import span_share


def read(tr):
    return span_share(tr.spans, {"assembly.vote"}, tr.w0, tr.w1)
