#!/usr/bin/env python3
"""The readings the limits of a cell's correctness check are set from.

    python3 benchmark/calibrate.py --workload <cell> --seeds 11,12,... \
        [--controls 3] [--out FILE]

For each seed, in one process: the cell's set-up and one pass of its
traffic on the first CUDA card, then the judge's numbers on that pass (the
lower readings), the judge's numbers on the pass's answers broken as the
timed path could break them (half of the batch left out, an answer altered
where it is produced), and on the first --controls seeds the control's
numbers (the upper readings).  One JSON line a seed, on standard output and
in --out; with --dump, each seed's judged answers too.  `--device cpu` runs
it on the CPU at whatever size the cell has.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--out", default=None)
    ap.add_argument("--dump", default=None,
                    help="a directory for each seed's judged answers "
                         "(<seed>.pkl), to judge them again elsewhere")
    ap.add_argument("--own-samples", action="store_true",
                    help="make each seed's own sample, also where the cell "
                         "fixes one (traffic_params.sample_seed)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--root", default=ROOT)
    a = ap.parse_args(argv)
    import torch
    if a.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    from benchmark import inputs, run as bench_run
    from benchmark.registry import Registry
    from benchmark.spans import LaunchSpy, Recorder
    from telr_tpu_torch.utils.procpool import ensure_forkserver
    ensure_forkserver()
    bench_run.fixed_caches(a.root)
    reg = Registry(a.root, os.path.join(a.root, "benchmark"))
    cell = reg.cell(a.workload)
    cfg = reg.config(cell["config"])
    traffic = reg.traffic(cell["traffic"])
    inputs.CACHE = os.path.join(a.root, "benchmark", ".cache")
    dev = torch.device("cuda", 0) if a.device == "cuda" else \
        torch.device("cpu")
    info = bench_run.card(dev)
    print(f"card: {info['kind']}, power limit "
          f"{info.get('power_limit', 'n/a')}", file=sys.stderr, flush=True)
    out_f = open(a.out, "a") if a.out else None
    try:
        for i, seed in enumerate(int(s) for s in a.seeds.split(",")):
            t0 = time.perf_counter()
            run = types.SimpleNamespace(
                cell=cell, config=cfg, seed=seed, device=dev, ref_device=dev,
                spans=Recorder(), launch_spy=LaunchSpy(),
                sample_seed=(seed if a.own_samples
                             else inputs.sample_seed(cell, seed)))
            run.sample = inputs.load_or_make(cfg, run.sample_seed)
            st = traffic.setup(run)
            if i == 0:
                traffic.warm(run, st)
            t1 = time.perf_counter()
            work, n, out = traffic.one_pass(run, st)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t2 = time.perf_counter()
            rec = {"cell": cell["name"], "seed": seed,
                   "sample_seed": run.sample_seed, "items": n,
                   "setup_s": t1 - t0, "pass_s": t2 - t1,
                   "rate": work / (t2 - t1),
                   "readings": traffic.judge(run, st, [out, out]),
                   "faults": traffic.faults(run, st, [out])}
            if i < a.controls:
                rec["control"] = traffic.control(run, st, [out])
            traffic.close(run, st)
            rec["judge_s"] = time.perf_counter() - t2
            if a.dump:
                os.makedirs(a.dump, exist_ok=True)
                with open(os.path.join(a.dump, f"{seed}.pkl"), "wb") as f:
                    pickle.dump({"out": traffic.kept(run, out),
                                 "control_out": getattr(run, "control_out",
                                                        None)}, f)
            rec["card"] = info
            line = json.dumps(rec)
            print(line, flush=True)
            if out_f:
                out_f.write(line + "\n")
                out_f.flush()
    finally:
        if out_f:
            out_f.close()
        bench_run.stop_helpers()
    return 0


if __name__ == "__main__":
    sys.exit(main())
