"""The program's own spans over the traced window.

telr_tpu_torch/utils/hoststats.py keeps every span the program opens while a
torch profiler records (the traced window does): its name, thread, start and
end on time.perf_counter's clock (the window's clock, and by the window's
mark the device events' too), the id of the span that caused it and its
attributes.  The readers here run in the run's process after the window and
clip those spans to [tr.w0, tr.w1).  A program that keeps no spans (no
`hoststats.spans`) gives None, so each metric that reads them is left out.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

from benchmark.devtrace import clip, idle_gaps, union

# spans that only say which stage runs: time inside one of them and no other
# program span is time the program does not name
STAGE_LEVEL = frozenset({"assembly", "annotate", "annotate.families", "af",
                         "liftover"})
STAGE_PREFIX = "telr_stage:"
TAIL_STAGES = frozenset({"annotate", "annotate.families", "af", "liftover"})


def program_spans() -> Optional[list]:
    """Every span the program has recorded, or None when it keeps none."""
    try:
        from telr_tpu_torch.utils import hoststats
    except ImportError:
        return None
    read = getattr(hoststats, "spans", None)
    return None if read is None else read()


def _covered(ivs, w0: float, w1: float) -> float:
    return sum(b - a for a, b in union(clip(ivs, w0, w1)))


def union_share(spans, names: Iterable[str], w0: float, w1: float
                ) -> Optional[float]:
    """The share of [w0, w1) inside a span named in `names` on some thread;
    None when no such span overlaps the window."""
    names = set(names)
    ivs = [(s.t0, s.t1) for s in spans if s.name in names]
    if not clip(ivs, w0, w1):
        return None
    return _covered(ivs, w0, w1) / (w1 - w0)


def alone_share(spans, name: str, w0: float, w1: float) -> Optional[float]:
    """The share of [w0, w1) in which exactly one span named `name` is open
    over all threads; None when none overlaps the window."""
    edges = sorted(e for s in spans if s.name == name
                   for e in ((max(s.t0, w0), 1), (min(s.t1, w1), -1))
                   if s.t1 > w0 and s.t0 < w1)
    if not edges:
        return None
    alone, depth, t = 0.0, 0, w0
    for at, step in edges:
        if depth == 1:
            alone += at - t
        depth += step
        t = at
    return alone / (w1 - w0)


def under(spans, roots: Iterable[str]) -> List:
    """The spans with an ancestor (by their parent ids) named in `roots`."""
    roots = set(roots)
    by_id: Dict[int, object] = {s.id: s for s in spans}
    memo: Dict[int, bool] = {}

    def covered(s) -> bool:
        """s or one of its ancestors is named in `roots`."""
        path, found = [], False
        while s is not None:
            if s.id in memo:
                found = memo[s.id]
                break
            path.append(s.id)
            if s.name in roots:
                found = True
                break
            s = by_id.get(s.parent)
        for i in path:
            memo[i] = found
        return found

    return [s for s in spans if covered(by_id.get(s.parent))]


def naming(spans) -> List:
    """The spans below the stage level: those that name what runs."""
    return [s for s in spans if s.name not in STAGE_LEVEL
            and not s.name.startswith(STAGE_PREFIX)]


def idle_unnamed_s(device, spans, w0: float, w1: float) -> float:
    """Seconds of [w0, w1) in which the card runs nothing and no program
    span below the stage level is open."""
    ivs = [(e["t0"], e["t1"]) for e in device] + \
        [(s.t0, s.t1) for s in naming(spans)]
    return (w1 - w0) - _covered(ivs, w0, w1)


def named_gaps(device, spans, w0: float, w1: float, top: int = 10
               ) -> List[list]:
    """The `top` longest idle stretches of the window, longest first, as
    [name, seconds, unnamed seconds]: the name is the innermost program
    span over the stretch (the shortest that covers half of it or more,
    else the one that overlaps it most, with a "+"; "unnamed" when none
    does), the unnamed seconds the part inside no span below the stage
    level."""
    named = union(clip([(s.t0, s.t1) for s in naming(spans)], w0, w1))
    out = []
    for g0, g1 in idle_gaps(device, w0, w1)[:top]:
        over = [(min(g1, s.t1) - max(g0, s.t0), s.t1 - s.t0, s.name)
                for s in spans if min(g1, s.t1) > max(g0, s.t0)]
        half = [o for o in over if o[0] >= 0.5 * (g1 - g0)]
        name = (min(half, key=lambda o: o[1])[2] if half
                else max(over)[2] + "+" if over else "unnamed")
        covered = sum(max(0.0, min(g1, b) - max(g0, a)) for a, b in named)
        out.append([name, g1 - g0, (g1 - g0) - covered])
    return out
