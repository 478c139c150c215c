#!/usr/bin/env python3
"""The benchmark of telr_tpu_torch on one H100.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  A run makes or loads the cell's sample from
the seed, builds what the cell's traffic driver needs on the first CUDA
card, warms up, runs whole passes of the traffic until the window is spent
(at least one pass, and no pass that would end past --seconds by the passes'
mean), judges what the window produced against the plain reference, and
prints one JSON line last.  With --trace 0 the line holds the cell's
end-to-end metrics; with --trace 1 a torch.profiler trace and the
benchmark's own spans cover the window and the line holds the per-layer
metrics, the card's busy seconds and a breakdown.

Without a card, or with fewer than the cell asks for, it exits 2 and prints
no result.  `--device cpu` rehearses a run on the kernels' plain versions:
it prints its line with the platform "cpu" and exits 3, never 0.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import tempfile
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# modules a run may never load, compared by their whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "telr_tpu")
MARK = "bench:mark"


def process_start() -> float:
    """This process's start on time.time()'s clock (to /proc's 10 ms)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rpartition(")")[2].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.time() - (up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = process_start()


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu: a rehearsal on the plain kernels (exit 3)")
    ap.add_argument("--root", default=ROOT,
                    help="the checkout whose BENCHMARK.json is read")
    return ap.parse_args(argv)


def fixed_caches(root: str) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = os.path.join(root, "benchmark", ".cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ["USE_FLAX"] = "0"


def card(dev) -> dict:
    import torch
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
           "count": 1}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             "-i", str(dev.index or 0)], capture_output=True, text=True,
            timeout=30)
        out["power_limit"] = smi.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out["power_limit"] = "not read"
    return out


class Window:
    """The traced window: a torch.profiler trace of the card (kernels,
    copies, sets) and the host, read back through its chrome trace as
    telr_tpu_torch/tools/profile_report.py reads it, on perf_counter's
    clock by a mark set at its start."""

    DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
    HOST_SKIP = DEVICE_CATS + ("gpu_user_annotation",)

    def __init__(self, dev):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA],
                            record_shapes=False, with_stack=False,
                            profile_memory=False)
        self.prof.start()
        with torch._C._profiler._RecordFunctionFast(MARK):
            self.mark = time.perf_counter()

    def stop(self):
        from benchmark.devtrace import kernel_name
        self.prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
        finally:
            os.remove(path)
        events = [e for e in trace.get("traceEvents", [])
                  if e.get("ph") == "X"]
        marks = [float(e["ts"]) for e in events if e.get("name") == MARK
                 and e.get("cat") not in self.HOST_SKIP]
        if not marks:
            raise RuntimeError("the profiler's trace lost the window's mark")

        def clock(ts):
            return self.mark + (float(ts) - marks[0]) / 1e6

        out = []
        for e in events:
            if e.get("cat") not in self.DEVICE_CATS:
                continue
            t0 = clock(e["ts"])
            name = (kernel_name(e["name"]) if e["cat"] == "kernel"
                    else e["name"])
            out.append({"name": name, "t0": t0,
                        "t1": t0 + float(e.get("dur", 0)) / 1e6})
        return out


def forbidden_modules(names=None):
    """The FORBIDDEN top-level names among `names` (default: the modules
    this process has loaded), each module's name cut at its first dot."""
    names = list(sys.modules) if names is None else names
    return sorted({m.partition(".")[0] for m in names} & set(FORBIDDEN))


def main(argv=None) -> int:
    a = parse(argv)
    import torch
    if a.device == "cuda":
        if not torch.cuda.is_available():
            print("no CUDA card: torch.cuda.is_available() is false",
                  file=sys.stderr)
            return 2
    from benchmark.registry import Registry
    reg = Registry(a.root, os.path.join(a.root, "benchmark"))
    cell = reg.cell(a.workload)
    if a.device == "cuda" and torch.cuda.device_count() < int(cell["chips"]):
        print(f"{cell['name']} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    fixed_caches(a.root)
    # the program's planning pool forks from a server started before CUDA
    from telr_tpu_torch.utils.procpool import ensure_forkserver
    ensure_forkserver()
    from benchmark import inputs
    from benchmark.spans import LaunchSpy, Patches, Recorder
    from telr_tpu_torch.utils import hoststats

    dev = torch.device("cuda", 0) if a.device == "cuda" else \
        torch.device("cpu")
    info = card(dev)
    print(f"card: {info['kind']}, power limit "
          f"{info.get('power_limit', 'n/a')}", file=sys.stderr, flush=True)
    cfg = reg.config(cell["config"])
    traffic = reg.traffic(cell["traffic"])
    inputs.CACHE = os.path.join(a.root, "benchmark", ".cache")
    run = types.SimpleNamespace(
        cell=cell, config=cfg, seed=a.seed, device=dev, ref_device=dev,
        spans=Recorder(), launch_spy=LaunchSpy(),
        sample_seed=inputs.sample_seed(cell, a.seed))
    run.sample = inputs.load_or_make(cfg, run.sample_seed)
    st = traffic.setup(run)
    traffic.warm(run, st)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.time() - T_START
    print(f"setup_s {setup_s:.3f}", file=sys.stderr, flush=True)

    run.spans = Recorder()
    run.launch_spy.launches.clear()
    patches = Patches()
    window = None
    if a.trace:
        traffic.trace_hooks(run, st, patches)
        if dev.type == "cuda":
            window = Window(dev)
    hoststats.reset()
    outs, work, items, pass_s = [], 0.0, 0, []
    w0 = time.perf_counter()
    try:
        while True:
            t0 = time.perf_counter()
            with run.spans.span("pass"):
                w, n, out = traffic.one_pass(run, st)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            pass_s.append(time.perf_counter() - t0)
            work += w
            items += n
            outs[1:] = [out]          # the first and the last pass
            elapsed = time.perf_counter() - w0
            if elapsed + sum(pass_s) / len(pass_s) > a.seconds:
                break
    except BaseException:
        if window is not None:
            window.prof.stop()
        raise
    finally:
        patches.close()
    w1 = time.perf_counter()
    window_s = w1 - w0
    counters = hoststats.snapshot()
    device_events = window.stop() if window is not None else []
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    print(f"window: {len(pass_s)} passes, {window_s:.3f} s "
          f"({', '.join(f'{s:.2f}' for s in pass_s)})", file=sys.stderr)

    failed = traffic.missing(run, outs[-1])
    traffic.close(run, st)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    readings = traffic.judge(run, st, outs)
    limits = cell["limits"]
    checks = {k: {"value": readings[k], "limit": limits[k]}
              for k in limits}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    if a.trace:
        from benchmark import devtrace
        tr = types.SimpleNamespace(
            w0=w0, w1=w1, window_s=window_s, spans=run.spans.spans,
            counters=counters, launches=run.launch_spy.launches,
            device=device_events)
        metrics = {}
        for m in reg.metrics(cell["name"], trace=True):
            v = reg.reader(m["name"]).read(tr)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        info["busy_s"] = devtrace.busy_s(device_events, w0, w1)
        info["window_s"] = window_s
        breakdown = breakdown_of(tr)
    else:
        rates = {traffic.RATE: work / window_s, "setup_s": setup_s}
        metrics = {m["name"]: {"value": rates[m["name"]], "unit": m["unit"]}
                   for m in reg.metrics(cell["name"], trace=False)}
        breakdown = None
    if dev.type == "cuda":
        info["memory_peak_bytes"] = peak

    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 4
    stop_helpers()      # before the result: every process has ended
    line = {"correct": correct, "attempted": items, "failed": failed,
            "metrics": metrics, "device": info}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    for k, c in checks.items():
        ok = "ok" if c["value"] <= c["limit"] else "OVER"
        print(f"check {k}: {c['value']!r} limit {c['limit']!r} {ok}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0 if dev.type == "cuda" else 3


def breakdown_of(tr) -> dict:
    """The device operations that took most time in the window, and its
    longest idle stretches, each named by the shortest benchmark span that
    covers half of it or more; else by the span that overlaps it most, with
    a "+" (the rest is host work no span names); a stretch inside no span
    but the pass is "pass"."""
    from benchmark import devtrace
    ops = sorted(devtrace.op_seconds(
        devtrace.clip_events(tr.device, tr.w0, tr.w1)).items(),
        key=lambda kv: -kv[1])[:10]
    spans = [s for s in tr.spans if s[0] != "pass"]
    gaps = []
    for g0, g1 in devtrace.idle_gaps(tr.device, tr.w0, tr.w1)[:10]:
        over = [(min(g1, s[3]) - max(g0, s[2]), s[3] - s[2], s[0])
                for s in spans]
        over = [o for o in over if o[0] > 0]
        half = [o for o in over if o[0] >= 0.5 * (g1 - g0)]
        name = (min(half, key=lambda o: o[1])[2] if half
                else max(over)[2] + "+" if over else "pass")
        gaps.append([name, g1 - g0])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": gaps}


def stop_helpers() -> None:
    """End the forkserver the program's pool started and the resource
    tracker that multiprocessing started beside it, and wait for each (a
    no-op for one that does not run): left to end with this process, they
    would outlive it unreaped."""
    from multiprocessing import forkserver, resource_tracker
    for helper in (forkserver._forkserver, resource_tracker._resource_tracker):
        stop = getattr(helper, "_stop", None)
        if stop is not None:
            stop()


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        stop_helpers()
    sys.exit(rc)
