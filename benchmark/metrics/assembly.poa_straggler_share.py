"""The share of the window in which exactly one POA consensus runs over all
threads: a POA round waiting on its slowest locus.  Read from the program's
`assembly.poa` spans (assembly/local.py, one a locus and round)."""

from benchmark.progspans import alone_share, program_spans


def read(tr):
    spans = program_spans()
    return None if spans is None else alone_share(
        spans, "assembly.poa", tr.w0, tr.w1)
