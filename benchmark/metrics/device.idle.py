"""The share of the window in which the card ran no kernel, copy or set
(1 - the union of the profiled device intervals over the window)."""

from benchmark.devtrace import busy_s


def read(tr):
    if not tr.device:
        return None
    return 1.0 - busy_s(tr.device, tr.w0, tr.w1) / tr.window_s
