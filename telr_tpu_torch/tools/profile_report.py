"""Per-stage device time from the port's torch.profiler trace.

Run the pipeline with --profile_dir DIR (python -m telr_tpu_torch.cli ...),
then:

    python -m telr_tpu_torch.tools.profile_report DIR [--out JSON] [--top N]

Finds the `telr_stage:<name>` spans the pipeline emits (pipeline.py timed())
and attributes every CUDA kernel, memcpy and memset the trace holds to the
stage whose span holds the host call that issued it (matched by the
profiler's correlation id; an event without one goes by its own start).
Writes a JSON table: per stage its wall seconds, device seconds, the card's
busy share, and its top kernels by time with their counts; then the run's
longest stretches in which the card ran nothing, each named by the innermost
program span over it (the stage spans and the "telr_span" events the
pipeline adds from utils/hoststats.py).  A trace taken with --device cpu has
no device events: every stage then reads 0 s, and the whole run is one idle
stretch.
"""

from __future__ import annotations

import argparse
import bisect
import glob
import gzip
import json
import os
import re
from collections import defaultdict

STAGE_PREFIX = "telr_stage:"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# device-side events, and the profiler's device-side copies of host spans
HOST_SKIP = DEVICE_CATS + ("gpu_user_annotation",)
# the program's own spans (pipeline.py SPAN_CAT), with their attributes
SPAN_CAT = "telr_span"
# spans that only say which stage runs: a stretch inside one of them and
# no other is still unnamed
STAGE_LEVEL_SPANS = ("assembly", "annotate", "annotate.families", "af",
                     "liftover")


def find_trace(path: str) -> str:
    """The trace file itself, or the newest chrome trace under a directory."""
    if os.path.isfile(path):
        return path
    found = [p for pat in ("*.json.gz", "*.json")
             for p in glob.glob(os.path.join(path, "**", pat),
                                recursive=True)
             if not p.endswith("profile_report.json")]
    if not found:
        raise FileNotFoundError(f"no chrome trace (*.json[.gz]) under {path}")
    return max(found, key=os.path.getmtime)


def load_trace(path: str) -> dict:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def kernel_name(name: str) -> str:
    """A kernel's function name without its return type, anonymous
    namespace, template arguments and parameters:
    "void (anonymous namespace)::wavefront_dp_kernel<true, 4>(...)" ->
    "wavefront_dp_kernel"."""
    name = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::",
                                                  "")
    return re.split(r"[<(]", name, maxsplit=1)[0].strip()


def build_report(trace: dict, top: int = 5) -> dict:
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    stages = sorted(
        ((e["name"][len(STAGE_PREFIX):], float(e["ts"]),
          float(e["ts"]) + float(e.get("dur", 0)))
         for e in events if e.get("cat") not in HOST_SKIP + (SPAN_CAT,)
         and str(e.get("name", "")).startswith(STAGE_PREFIX)),
        key=lambda s: s[1])
    starts = [s[1] for s in stages]
    launch_ts = {e["args"]["correlation"]: float(e["ts"]) for e in events
                 if e.get("cat") in LAUNCH_CATS
                 and "correlation" in e.get("args", {})}

    dev_s = defaultdict(float)
    kernels = defaultdict(lambda: defaultdict(lambda: [0.0, 0]))
    total = unattributed = 0.0
    for e in events:
        cat = e.get("cat")
        if cat not in DEVICE_CATS:
            continue
        dur = float(e.get("dur", 0)) / 1e6
        total += dur
        t = launch_ts.get(e.get("args", {}).get("correlation"),
                          float(e["ts"]))
        k = bisect.bisect_right(starts, t) - 1
        if k < 0 or t >= stages[k][2]:
            unattributed += dur
            continue
        stage = stages[k][0]
        dev_s[stage] += dur
        name = kernel_name(e["name"]) if cat == "kernel" else e["name"]
        entry = kernels[stage][name]
        entry[0] += dur
        entry[1] += 1

    table = []
    for name, s0, s1 in stages:
        wall = (s1 - s0) / 1e6
        busy = sorted(kernels[name].items(), key=lambda kv: -kv[1][0])
        table.append({
            "stage": name, "wall_s": wall, "device_s": dev_s[name],
            "busy_share": dev_s[name] / wall if wall else 0.0,
            "top": [{"name": n, "s": s, "count": c}
                    for n, (s, c) in busy[:top]],
        })
    run = (stages[0][1], max(s[2] for s in stages)) if stages else None
    return {"stages": table, "device_total_s": total,
            "unattributed_device_s": unattributed,
            "idle_gaps": idle_gaps(events, run) if run else [],
            "devices": [d.get("name") for d in
                        trace.get("deviceProperties", [])]}


def _union(ivs):
    out = []
    for a, b in sorted(ivs):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle_gaps(events, run, top: int = 10) -> list:
    """The `top` longest stretches of `run` (start, end in trace
    microseconds) with no kernel, copy or set, longest first, each named by
    the innermost program span over it: the shortest span that covers half
    of it or more, else the one that overlaps it most with a "+", else
    "unnamed".  `unnamed_s` is the part of the stretch inside no program
    span below the stage level (the pipeline's stage spans, assemble_all's,
    the tail stages')."""
    r0, r1 = run
    busy = _union([(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                   for e in events if e.get("cat") in DEVICE_CATS])
    gaps, t = [], r0
    for a, b in busy:
        if a > t:
            gaps.append((t, min(a, r1)))
        t = max(t, b)
    if t < r1:
        gaps.append((t, r1))
    gaps = sorted((g for g in gaps if g[1] > g[0]),
                  key=lambda g: g[0] - g[1])[:top]
    # the program's spans before the stage spans: a tie goes to the former
    spans = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
              e["name"]) for e in sorted(
                  (e for e in events if e.get("cat") == SPAN_CAT
                   or (e.get("cat") not in HOST_SKIP
                       and str(e.get("name", "")).startswith(STAGE_PREFIX))),
                  key=lambda e: e.get("cat") != SPAN_CAT)]
    named = _union([(a, b) for a, b, n in spans
                    if n not in STAGE_LEVEL_SPANS
                    and not n.startswith(STAGE_PREFIX)])
    out = []
    for g0, g1 in gaps:
        over = [(min(g1, b) - max(g0, a), b - a, n) for a, b, n in spans
                if min(g1, b) > max(g0, a)]
        half = [o for o in over if o[0] >= 0.5 * (g1 - g0)]
        name = (min(half, key=lambda o: o[1])[2] if half
                else max(over)[2] + "+" if over else "unnamed")
        covered = sum(max(0.0, min(g1, b) - max(g0, a)) for a, b in named)
        out.append({"start_us": g0, "seconds": (g1 - g0) / 1e6,
                    "name": name,
                    "unnamed_s": (g1 - g0 - covered) / 1e6})
    return out



def card_windows(trace: dict) -> dict:
    """Each card's device work in the trace, by its index: the first start
    and the last end (microseconds on the trace's clock, which all cards
    share), the busy seconds and the count of kernels, copies and sets."""
    out: dict = {}
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        card = int(e.get("args", {}).get("device", -1))
        t0 = float(e["ts"])
        t1 = t0 + float(e.get("dur", 0))
        w = out.setdefault(card, {"start_us": t0, "end_us": t1,
                                  "busy_s": 0.0, "events": 0})
        w["start_us"] = min(w["start_us"], t0)
        w["end_us"] = max(w["end_us"], t1)
        w["busy_s"] += (t1 - t0) / 1e6
        w["events"] += 1
    return dict(sorted(out.items()))


def report(path: str, top: int = 5) -> dict:
    """build_report on the trace at `path` (a file or a --profile_dir)."""
    trace_path = find_trace(path)
    out = build_report(load_trace(trace_path), top)
    out["trace"] = trace_path
    out["trace_bytes"] = os.path.getsize(trace_path)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("profile_dir", help="a --profile_dir, or a trace file")
    ap.add_argument("--out", default=None,
                    help="the JSON table (default: "
                         "PROFILE_DIR/profile_report.json)")
    ap.add_argument("--top", type=int, default=5,
                    help="kernels listed per stage")
    a = ap.parse_args(argv)
    rep = report(a.profile_dir, a.top)
    out = a.out or os.path.join(
        a.profile_dir if os.path.isdir(a.profile_dir)
        else os.path.dirname(os.path.abspath(a.profile_dir)),
        "profile_report.json")
    with open(out, "w") as f:
        json.dump(rep, f, indent=2)
    for row in rep["stages"]:
        tops = ", ".join(f"{k['name']} {k['s']:.4f} s x{k['count']}"
                         for k in row["top"])
        print(f"{row['stage']:20s} wall {row['wall_s']:9.3f} s   device "
              f"{row['device_s']:9.4f} s ({row['busy_share'] * 100:5.2f}%)"
              + (f"   {tops}" if tops else ""))
    for g in rep["idle_gaps"]:
        print(f"idle {g['seconds']:9.3f} s   {g['name']}   (inside no "
              f"span below the stages: {g['unnamed_s']:.3f} s)")
    print(f"devices: {rep['devices']}; trace {rep['trace']} "
          f"({rep['trace_bytes']} bytes); device total "
          f"{rep['device_total_s']:.4f} s, outside every stage "
          f"{rep['unattributed_device_s']:.4f} s")


if __name__ == "__main__":
    main()
