"""The share of the window the assembly's realignment rounds took: the
union of the program's `assembly.realign` spans (assembly/local.py: each
round's per-locus indexes and its map_batch_grouped, the vote's rounds and
the POA's)."""

from benchmark.progspans import program_spans, union_share


def read(tr):
    spans = program_spans()
    return None if spans is None else union_share(
        spans, {"assembly.realign"}, tr.w0, tr.w1)
