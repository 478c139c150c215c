"""The share of the window the wavefront route's host prep took: hoststats'
wave_prep seconds (the dispatching thread's) over the window."""

def read(tr):
    c = tr.counters.get("wave_prep")
    return None if c is None else c["s"] / tr.window_s
