"""The share of the window the mapper's planning pool took: hoststats'
plan_pool seconds (the dispatching thread's) over the window."""

def read(tr):
    c = tr.counters.get("plan_pool")
    return None if c is None else c["s"] / tr.window_s
