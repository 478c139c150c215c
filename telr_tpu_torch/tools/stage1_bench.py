"""Stage-1 (read -> genome) wall-clock bench of the port with the hoststats
breakdown.

The counterpart of the repository's tools/stage1_bench.py.  Simulates a
genome and its reads once with tools/genome_eval.py's generators (cached as
an npz in --workdir, the same file and draws as that tool's), then times
--repeat passes of ONE map_batch_parallel call over the full read set, as
the pipeline's stage 1 makes it (MAP_PB with chain_prune_frac 0.5), in one
process.  Each pass prints reads/s, Mb/s, the alignments, the hoststats
attribution (plan fan-out, piece planning, wavefront prep / launch / device
wait / decode) and the wavefront kernels' launches; the last line is one
JSON object with every pass, the device and, on a card, its nvidia-smi name
and power limit and the peak device memory.

--wavefront routes the DPs to the wavefront kernels, on the first CUDA card
unless --device cpu (where their plain versions run); without it the native
host engine runs them.

Usage:
    python -m telr_tpu_torch.tools.stage1_bench [--size 3000000]
        [--coverage 30] [--seed 11] [--threads 4] [--wavefront]
        [--device cuda|cpu] [--repeat N] [--workdir DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np


def load_or_sim(size, coverage, seed, workdir):
    """(genome, [(read name, codes)]) from WORKDIR/s1_{size}_{coverage}_
    {seed}.npz, simulated and cached there on the first call."""
    os.makedirs(workdir, exist_ok=True)
    cache = os.path.join(workdir, f"s1_{size}_{coverage}_{seed}.npz")
    if os.path.exists(cache):
        z = np.load(cache, allow_pickle=True)
        return z["genome"], list(zip(z["names"], z["codes"]))
    from telr_tpu_torch.tools.genome_eval import generators
    ge = generators()
    rng = np.random.default_rng(seed)
    lib = ge.make_te_library(rng)
    genome = ge.make_genome(size, lib, rng)
    truth = ge.plant_insertions(genome, lib, max(10, size // 300_000), rng)
    reads = ge.simulate_reads(genome, truth, coverage, rng)
    np.savez(cache, genome=genome,
             names=np.array([n for n, _ in reads], dtype=object),
             codes=np.array([c for _, c in reads], dtype=object))
    return genome, reads


def run(size=3_000_000, coverage=30, seed=11, threads=4, wavefront=False,
        device=None, repeat=1, workdir=None):
    """The passes; returns the final record (see the module docstring)."""
    from telr_tpu_torch.utils.procpool import ensure_forkserver
    ensure_forkserver()   # before CUDA starts threads (see procpool.py)
    import dataclasses

    import torch

    from telr_tpu_torch.config import MAP_PB
    from telr_tpu_torch.io.seqs import SeqDict, Sequence
    from telr_tpu_torch.kernels.mapper import Aligner
    from telr_tpu_torch.tools.bench_pipeline import (device_record,
                                                     kernel_launches,
                                                     reset_launches)
    from telr_tpu_torch.utils import hoststats
    from telr_tpu_torch.utils.device import resolve

    dev = resolve(device)
    workdir = workdir or os.path.join(tempfile.gettempdir(), "telr_s1bench")
    genome, reads = load_or_sim(size, coverage, seed, workdir)
    n_bases = sum(len(c) for _, c in reads)
    print(f"workload: {len(reads)} reads, {n_bases / 1e6:.0f}Mb", flush=True)
    targets = SeqDict([Sequence("chr", np.asarray(genome))])
    pre = dataclasses.replace(MAP_PB, chain_prune_frac=0.5)
    t0 = time.time()
    al = Aligner(targets, pre, use_wavefront=wavefront, device=dev)
    index_s = time.time() - t0
    print(f"index: {index_s:.1f}s", flush=True)
    queries = {n: np.asarray(c) for n, c in reads}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    passes = []
    for it in range(repeat):
        hoststats.reset()
        reset_launches()
        t0 = time.time()
        res = al.map_batch_parallel(queries, threads)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.time() - t0
        rec = {
            "pass": it,
            "wall_s": round(dt, 2),
            "reads_per_s": round(len(reads) / dt, 1),
            "mb_per_s": round(n_bases / 1e6 / dt, 3),
            "alignments": sum(len(v) for v in res.values()),
            "breakdown": hoststats.snapshot(),
            "launches": kernel_launches(),
        }
        print(json.dumps(rec, indent=1), flush=True)
        passes.append(rec)
    return {"workload": {"size": size, "coverage": coverage, "seed": seed,
                         "reads": len(reads), "read_mb": n_bases / 1e6},
            "threads": threads, "wavefront": wavefront,
            "index_s": round(index_s, 2), "passes": passes,
            **device_record(dev)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=3_000_000)
    ap.add_argument("--coverage", type=int, default=30)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--wavefront", action="store_true")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--workdir", default=None,
                    help="where the simulated data is cached (default: "
                         "TMPDIR/telr_s1bench)")
    ap.add_argument("--repeat", type=int, default=1,
                    help="time the call N times in one process; the later "
                         "passes run with the kernels built and the index "
                         "warm")
    a = ap.parse_args(argv)
    rec = run(a.size, a.coverage, a.seed, a.threads, a.wavefront,
              "cpu" if a.device == "cpu" else None, a.repeat, a.workdir)
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
