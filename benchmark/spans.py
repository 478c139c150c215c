"""The benchmark's own spans around calls into the program's layers, and the
spy that counts each wavefront DP launch's work from its inputs.

Spans are (name, thread id, start, end) on time.perf_counter's clock, kept in
memory.  `Patches` swaps a function of the program for a wrapper that
records a span around each call (and can hand its arguments to a callback)
and puts every original back on close; the traced run alone installs them.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Callable, List, Optional, Tuple

Span = Tuple[str, int, float, float]


class Recorder:
    def __init__(self) -> None:
        self.spans: List[Span] = []
        self._lock = threading.Lock()

    def add(self, name: str, t0: float, t1: float) -> None:
        with self._lock:
            self.spans.append((name, threading.get_ident(), t0, t1))

    @contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, t0, time.perf_counter())


class Patches:
    """Wrappers installed over attributes of the program's modules."""

    def __init__(self) -> None:
        self._undo: List[Tuple[object, str, object]] = []

    def wrap(self, owner, attr: str, rec: Recorder, name: str,
             before: Optional[Callable] = None) -> None:
        """Record a span `name` around each call of owner.attr, after
        handing its arguments to `before` when given."""
        orig = getattr(owner, attr)

        def wrapper(*args, **kwargs):
            if before is not None:
                before(*args, **kwargs)
            t0 = time.perf_counter()
            try:
                return orig(*args, **kwargs)
            finally:
                rec.add(name, t0, time.perf_counter())

        wrapper.__wrapped__ = orig
        # the program keeps counters on some functions (vote_many's
        # device_calls): the wrapper shares them
        wrapper.__dict__ = orig.__dict__
        setattr(owner, attr, wrapper)
        self._undo.append((owner, attr, orig))

    def close(self) -> None:
        while self._undo:
            owner, attr, orig = self._undo.pop()
            setattr(owner, attr, orig)


class LaunchSpy:
    """Each wavefront DP launch's pairs, as (query length, target length),
    and band width, read from the host-side batch the launch is made from
    (prepare_wavefront_batch: one call a launch)."""

    def __init__(self) -> None:
        self.launches: List[dict] = []

    def __call__(self, pairs, width, guides=None) -> None:
        self.launches.append({"pairs": [(len(q), len(t)) for q, t in pairs],
                              "width": int(width)})
