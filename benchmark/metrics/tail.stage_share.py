"""The share of the window the tail stages took: the benchmark's spans
around annotate_contigs + reannotate_families, estimate_af and liftover."""

from benchmark.devtrace import span_share


def read(tr):
    return span_share(tr.spans, {"tail.annotate", "tail.af",
                                 "tail.liftover"}, tr.w0, tr.w1)
