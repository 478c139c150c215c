"""The port's one span and counter recorder for the host-side hot path.

The mapper/wavefront dispatch spends its time in four places that are
invisible to stage-level timers: host planning, piece/schedule prep,
device wait (kernels and copies), and result decode (unpack + RLE).
These counters let the pipeline log a per-stage breakdown so perf work
targets the real bottleneck instead of a guess.

Usage: with timer("wave_prep"): ...;  snapshot() -> dict, reset() zeroes.
Counters are per-thread (threading.local): the async kernel-prewarm
threads also run wavefront_align, and global counters double-counted
their compile waits into the main dispatch thread's numbers.

Spans.  While a torch profiler session records (the module flag
torch.autograd.profiler._is_profiler_enabled, which every thread reads
alike), each timer also appends a Span to one process-wide list: its name,
thread, start and end on time.perf_counter's clock, the span that caused it
(the innermost open span on its thread, or `parent=` for work handed to a
pool thread) and its attributes (counts, the locus name).  On a thread the
profiler instruments the span also enters a RecordFunction of its name, so
it lands in the profiler's own trace; the pool threads' spans it never sees
reach the trace through drain_spans() (pipeline.py's _stop_profiler).  With
no profiler recording a timer costs one flag read more than its counter.
spans() reads the list, drain_spans() empties it; reset() leaves it alone.
"""

from __future__ import annotations

import functools
import itertools
import sys
import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import List, Optional

_TL = threading.local()
_SPANS: List["Span"] = []
_LOCK = threading.Lock()
_IDS = itertools.count(1)
_PROF = None    # torch.autograd.profiler, once this process has loaded it


class Span:
    """One recorded interval: `parent` is the id of the span that caused
    it (None at the top)."""

    __slots__ = ("id", "name", "tid", "t0", "t1", "parent", "attrs", "_rf")

    def __init__(self, name: str, parent: Optional[int], attrs: dict,
                 t0: float = 0.0, t1: float = 0.0) -> None:
        self.id = next(_IDS)
        self.name = name
        self.tid = threading.get_ident()
        self.t0 = t0
        self.t1 = t1
        self.parent = parent
        self.attrs = attrs
        self._rf = None


def _c():
    if not hasattr(_TL, "c"):
        _TL.c = defaultdict(float)
        _TL.n = defaultdict(int)
    return _TL.c, _TL.n


def _stack() -> list:
    st = getattr(_TL, "stack", None)
    if st is None:
        st = _TL.stack = []
    return st


def recording() -> bool:
    """True while a torch profiler session records: spans are kept.  The
    profiler's module is looked up in sys.modules, not imported, so that a
    process without torch (the planning pool's workers) never loads it."""
    global _PROF
    if _PROF is None:
        _PROF = sys.modules.get("torch.autograd.profiler")
        if _PROF is None:
            return False
    return _PROF._is_profiler_enabled


def current() -> Optional[int]:
    """The id of this thread's innermost open span (None when no span is
    open or none is recorded): the `parent=` of work handed to a pool."""
    st = getattr(_TL, "stack", None)
    return st[-1].id if st else None


def annotate(**attrs) -> None:
    """Set attributes on this thread's innermost open span, if recorded."""
    st = getattr(_TL, "stack", None)
    if st:
        st[-1].attrs.update(attrs)


def _open(name: str, parent: Optional[int], attrs: dict) -> Span:
    st = _stack()
    sp = Span(name, parent if parent is not None
              else (st[-1].id if st else None), attrs)
    torch = sys.modules["torch"]
    if torch._C._autograd._profiler_enabled():
        sp._rf = torch._C._profiler._RecordFunctionFast(name)
        sp._rf.__enter__()
    st.append(sp)
    return sp


def _close(sp: Span, t0: float, t1: float) -> None:
    st = _stack()
    if st and st[-1] is sp:
        st.pop()
    elif sp in st:
        st.remove(sp)
    if sp._rf is not None:
        sp._rf.__exit__(None, None, None)
        sp._rf = None
    sp.t0, sp.t1 = t0, t1
    with _LOCK:
        _SPANS.append(sp)


@contextmanager
def timer(name: str, parent: Optional[int] = None, **attrs):
    """Count the block's seconds under `name` on this thread; while a
    profiler records, also keep it as a span with `attrs`."""
    sp = _open(name, parent, attrs) if recording() else None
    t0 = time.perf_counter()
    try:
        yield
    finally:
        t1 = time.perf_counter()
        c, n = _c()
        c[name] += t1 - t0
        n[name] += 1
        if sp is not None:
            _close(sp, t0, t1)


def timed(name: str):
    """A decorator: each call of the function runs under timer(name)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with timer(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def record(name: str, t0: float, t1: float, **attrs) -> None:
    """Keep [t0, t1) (perf_counter seconds, measured by the caller) as a
    span under this thread's innermost open span, while a profiler
    records.  Counts nothing."""
    if recording():
        sp = Span(name, current(), attrs, t0, t1)
        with _LOCK:
            _SPANS.append(sp)


def add(name: str, seconds: float, n: int = 1,
        start: Optional[float] = None) -> None:
    """Count `seconds` under `name`; with `start`, the interval
    [start, start + seconds) is also kept as a span (record)."""
    c, cn = _c()
    c[name] += seconds
    cn[name] += n
    if start is not None:
        record(name, start, start + seconds)


def snapshot() -> dict:
    c, n = _c()
    return {k: {"s": round(v, 2), "n": n[k]} for k, v in sorted(c.items())}


def reset() -> None:
    c, n = _c()
    c.clear()
    n.clear()


def spans() -> List[Span]:
    """The spans recorded so far, over all threads, in the order they
    ended."""
    with _LOCK:
        return list(_SPANS)


def drain_spans() -> List[Span]:
    """The spans recorded so far, removed from the list."""
    with _LOCK:
        out = list(_SPANS)
        _SPANS.clear()
    return out
