"""The share of the window the assembly vote spent on the host: the union
of the program's `vote.pack`, `vote.stack` and `vote.finalize` spans
(assembly/device_vote.py::vote_many; `vote.finalize` holds the host
realignment of insertion events, `vote.ins_realign`)."""

from benchmark.progspans import program_spans, union_share


def read(tr):
    spans = program_spans()
    return None if spans is None else union_share(
        spans, {"vote.pack", "vote.stack", "vote.finalize"}, tr.w0, tr.w1)
