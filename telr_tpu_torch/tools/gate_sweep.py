"""Where the mapper's size gate belongs: one grouped dispatch timed on the
native host engine and on the card's wavefront route, over a sweep of sizes.

The mapper sends a grouped dispatch whose estimated wavefront work
(mapper._wave_cells) is below mapper._WAVE_MIN_CELLS to the native host
engine, and the rest to the wavefront kernels.  This tool plans the pieces
of stage-1 reads once (tools/genome_eval.py's repeat-dense genome and reads,
through stage1_bench.load_or_sim; MAP_PB with chain_prune_frac 0.5, as the
pipeline's stage 1 plans them), then for each size takes the fewest reads
whose pieces reach it and times mapper._dispatch_pieces on them both ways:
the gate forced shut (the host engine, TELR_DP_THREADS = --threads) and
open (the card: prep, copies, both kernels, decode, the chunked extension
rounds).  Runs go host, wavefront, wavefront, host, ... --reps times each,
after one warm-up of each route.  It does so at each score set the stages
give the DPs: the reads' (MAP_PB: 2, 4, 4, 2) and the library's (LIB_TO_SEQ:
2, 3, 5, 2, which te_filter, ref_repeatmask and the family re-annotation
use) on the same pieces.

Per size it prints the cells, jobs and both routes' median, min and max
seconds; per score set the crossover, the least size from which the
wavefront route's median is below the host's at every larger size, and
whether it is clear of the spread (the route's slowest run below the host's
fastest there).  Under --device cpu the wavefront route runs the kernels'
plain versions, which says nothing of the card: that mode is for tests.  The
last line is one JSON object with all of it, the device and the card's
nvidia-smi name and power limit.

Usage:
    python -m telr_tpu_torch.tools.gate_sweep [--threads 8] [--reps 3]
        [--size 1000000] [--coverage 30] [--seed 11] [--max-cells 4e9]
        [--device cuda|cpu] [--workdir DIR] [--out JSON]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import tempfile
import time

import numpy as np


class _Route:
    """What _dispatch_pieces reads of an Aligner: the wavefront route on
    `device`, no mesh, and the score set."""

    use_wavefront = True
    mesh = None

    def __init__(self, params, device):
        self.params = params
        self.device = str(device)

    def _params(self):
        return self.params


def plan_jobs(size, coverage, seed, workdir):
    """The pieces of every read's chains, as map_batch_grouped plans them for
    stage 1: [(0, pieces)] in read order."""
    import dataclasses

    from telr_tpu_torch.config import MAP_PB
    from telr_tpu_torch.io.seqs import SeqDict, Sequence
    from telr_tpu_torch.kernels.mapper import Aligner
    from telr_tpu_torch.tools.stage1_bench import load_or_sim
    genome, reads = load_or_sim(size, coverage, seed, workdir)
    al = Aligner(SeqDict([Sequence("chr", np.asarray(genome))]),
                 dataclasses.replace(MAP_PB, chain_prune_frac=0.5))
    jobs = []
    for _name, codes in reads:
        for chain, s_id, st, _primary in al._plan(codes):
            pieces, _geom = al._chain_pieces(codes, chain, s_id, st)
            jobs.append((0, pieces))
    return jobs


def job_cells(jobs):
    """Each job's share of mapper._wave_cells, with the widths
    _dispatch_pieces gives its pieces."""
    from telr_tpu_torch.kernels import dp, mapper
    out = []
    for _gi, pieces in jobs:
        buckets, ext = {}, []
        for q, t, mode, width, _guide in pieces.values():
            if mode == dp.EXTEND and len(q) > mapper._EXT_DIRECT_MAX:
                ext.append((q, t, None))
            elif len(q) and len(t):
                buckets.setdefault((None, mode, mapper._wave_width(width)),
                                   []).append((0, None, q, t, None, None))
        out.append(mapper._wave_cells(buckets, ext))
    return np.asarray(out, dtype=np.int64)


def sweep_sizes(cum, max_cells):
    """Target sizes 1M, 2M, 4M, ... up to max_cells (and what the jobs
    hold), each as the fewest jobs whose cells reach it: [(cells, n)]."""
    out, target = [], 1 << 20
    while target <= max_cells:
        n = int(np.searchsorted(cum, target)) + 1
        if n > len(cum):
            break
        out.append((int(cum[n - 1]), n))
        target *= 2
    return out


def time_dispatch(groups, jobs, gate, device):
    """Seconds of one _dispatch_pieces over `jobs` with the size gate at
    `gate` (0: the card; above the work: the host engine)."""
    import torch

    from telr_tpu_torch.kernels import mapper
    results = [dict() for _ in jobs]
    saved = mapper._WAVE_MIN_CELLS
    mapper._WAVE_MIN_CELLS = gate
    try:
        t0 = time.perf_counter()
        mapper._dispatch_pieces(groups, jobs, results)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter() - t0
    finally:
        mapper._WAVE_MIN_CELLS = saved


def crossover(rows):
    """The least size from which the wavefront route's median is below the
    host's at every larger size, and whether its slowest run there is below
    the host's fastest (None when the route never wins at the top)."""
    at = None
    for row in reversed(rows):
        if row["wavefront_s"]["median"] < row["host_s"]["median"]:
            at = row
        else:
            break
    if at is None:
        return {"cells": None, "clear_of_spread": None}
    return {"cells": at["cells"],
            "clear_of_spread": at["wavefront_s"]["max"] < at["host_s"]["min"]}


def run(threads=8, reps=3, size=1_000_000, coverage=30, seed=11,
        max_cells=4e9, device=None, workdir=None):
    import torch

    from telr_tpu_torch.config import LIB_TO_SEQ, MAP_PB
    from telr_tpu_torch.kernels import dp
    from telr_tpu_torch.tools.bench_pipeline import device_record
    from telr_tpu_torch.utils.device import resolve

    dev = resolve(device)
    os.environ["TELR_DP_THREADS"] = str(threads)
    workdir = workdir or os.path.join(tempfile.gettempdir(), "telr_s1bench")
    t0 = time.perf_counter()
    jobs = plan_jobs(size, coverage, seed, workdir)
    cum = np.cumsum(job_cells(jobs))
    sizes = sweep_sizes(cum, max_cells)
    print(f"planned {len(jobs)} chain jobs, {int(cum[-1])} estimated cells, "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    shut = int(cum[-1]) + 1
    record = {"threads": threads, "reps": reps, "jobs": len(jobs),
              "score_sets": {}}
    for label, preset in (("reads", MAP_PB), ("library", LIB_TO_SEQ)):
        params = dp.DPParams(preset.match, preset.mismatch,
                             preset.gap_open, preset.gap_extend)
        groups = [(_Route(params, dev), None)]
        # the first call of each route pays its start-up (the CUDA
        # context, the kernels' library, the native engine)
        first = jobs[:sizes[0][1]]
        time_dispatch(groups, first, shut, dev)
        time_dispatch(groups, first, 0, dev)
        rows = []
        for cells, n in sizes:
            part = jobs[:n]
            host, wave = [], []
            for r in range(reps):
                order = ((shut, host), (0, wave))
                for gate, out in (order if r % 2 == 0 else order[::-1]):
                    out.append(time_dispatch(groups, part, gate, dev))
            row = {"cells": cells, "jobs": n,
                   "pieces": sum(len(p) for _g, p in part)}
            for key, xs in (("host_s", host), ("wavefront_s", wave)):
                row[key] = {"median": statistics.median(xs),
                            "min": min(xs), "max": max(xs), "runs": xs}
            rows.append(row)
            print(f"{label} {params.tuple()[:4]}: {cells} cells, {n} jobs: "
                  f"host {row['host_s']['median']:.4f} s "
                  f"[{row['host_s']['min']:.4f}, "
                  f"{row['host_s']['max']:.4f}], wavefront "
                  f"{row['wavefront_s']['median']:.4f} s "
                  f"[{row['wavefront_s']['min']:.4f}, "
                  f"{row['wavefront_s']['max']:.4f}]", flush=True)
        record["score_sets"][label] = {
            "params": list(params.tuple()[:4]), "sizes": rows,
            "crossover": crossover(rows)}
        print(f"{label}: crossover {json.dumps(crossover(rows))}",
              flush=True)
    record.update(device_record(dev))
    return record


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--size", type=int, default=1_000_000)
    ap.add_argument("--coverage", type=int, default=30)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--max-cells", type=float, default=4e9)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    rec = run(args.threads, args.reps, args.size, args.coverage, args.seed,
              args.max_cells, "cpu" if args.device == "cpu" else None,
              args.workdir)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
