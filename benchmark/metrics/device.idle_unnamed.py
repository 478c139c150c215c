"""The share of the window in which the card runs nothing and no program
span below the stage level is open: idle time the program cannot name yet.
The stage-level spans (`assembly`, `annotate`, `annotate.families`, `af`,
`liftover`, the pipeline's `telr_stage:` spans) say only which stage runs,
so time inside them alone counts as unnamed."""

from benchmark.progspans import idle_unnamed_s, program_spans


def read(tr):
    spans = program_spans()
    if spans is None or not tr.device:
        return None
    return idle_unnamed_s(tr.device, spans, tr.w0, tr.w1) / tr.window_s
