"""What a torch.profiler trace of the window says about the card.

The busy-interval arithmetic copied from telr_tpu_torch/tools/profile_report.py
(device events are kernels, copies and sets; a kernel is named by its
function name alone), turned from per-stage sums into the union of the
intervals, so that overlapping events on several streams count once.
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence, Tuple

Interval = Tuple[float, float]


def kernel_name(name: str) -> str:
    """"void (anonymous namespace)::wavefront_dp_kernel<true, 4>(...)" ->
    "wavefront_dp_kernel"."""
    name = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::",
                                                  "")
    return re.split(r"[<(]", name, maxsplit=1)[0].strip()


def union(intervals: Sequence[Interval]) -> List[Interval]:
    """The intervals merged where they overlap or touch, in order."""
    out: List[Interval] = []
    for t0, t1 in sorted(intervals):
        if out and t0 <= out[-1][1]:
            if t1 > out[-1][1]:
                out[-1] = (out[-1][0], t1)
        else:
            out.append((t0, t1))
    return out


def clip(intervals: Sequence[Interval], w0: float, w1: float
         ) -> List[Interval]:
    return [(max(a, w0), min(b, w1)) for a, b in intervals
            if b > w0 and a < w1]


def clip_events(events: Sequence[dict], w0: float, w1: float) -> List[dict]:
    """The events that overlap [w0, w1), cut to it."""
    return [dict(e, t0=max(e["t0"], w0), t1=min(e["t1"], w1))
            for e in events if e["t1"] > w0 and e["t0"] < w1]


def busy_s(events: Sequence[dict], w0: float, w1: float) -> float:
    """Seconds of the window [w0, w1) in which a kernel, copy or set ran."""
    return sum(b - a for a, b in
               union(clip([(e["t0"], e["t1"]) for e in events], w0, w1)))


def idle_gaps(events: Sequence[dict], w0: float, w1: float
              ) -> List[Interval]:
    """The window's stretches with no device event, longest first."""
    gaps, t = [], w0
    for a, b in union(clip([(e["t0"], e["t1"]) for e in events], w0, w1)):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < w1:
        gaps.append((t, w1))
    return sorted(gaps, key=lambda g: g[0] - g[1])


def op_seconds(events: Sequence[dict]) -> Dict[str, float]:
    """Device seconds by kernel name (copies and sets by their own name)."""
    out: Dict[str, float] = {}
    for e in events:
        out[e["name"]] = out.get(e["name"], 0.0) + e["t1"] - e["t0"]
    return out


def span_share(spans, names, w0: float, w1: float):
    """The share of the window [w0, w1) that the union, over threads, of the
    spans named in `names` covers; None when no such span ran."""
    ivs = [(s[2], s[3]) for s in spans if s[0] in names]
    if not ivs:
        return None
    return sum(b - a for a, b in union(clip(ivs, w0, w1))) / (w1 - w0)
