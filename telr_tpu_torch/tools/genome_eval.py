"""Genome-scale evaluation of the port on a simulated D. melanogaster-like
genome.

The counterpart of the repository's tools/genome_eval.py.  It builds the
same repeat-dense genome (planted reference TE copies at varying divergence
and tandem repeats), plants the same non-reference TE insertions (hom and
het, with TSDs) and simulates the same noisy long reads at a target coverage
(the same generators, same seed, same FASTA files), runs the port's FULL
pipeline, and scores the calls against the planted truth: F1 over insertions
(a call within +-100 bp of a truth site, family matching), reads/s in stage
1, loci/s from assembly to liftover, and the stage seconds.

The generators (make_te_library, make_genome, plant_insertions,
simulate_reads, score_calls) are taken from tools/genome_eval.py by file
path: they need only numpy.  That file's own simulate_dataset and run_eval
import the JAX package and are never called here.

Routing is the CLI's (--wavefront auto|on|off, --wavefront-stages); the run
goes to the first CUDA card unless --device cpu.  The last line printed is
the report as one JSON object: the JAX tool's keys plus the device, the
card's nvidia-smi name and power limit, each kernel's launches (in all and
by stage, with each grouped dispatch's estimated cells and whether it
crossed the mapper's size gate: bench_pipeline.stage_record) and the peak
device memory.

Usage:
    python -m telr_tpu_torch.tools.genome_eval [--size 5000000]
        [--coverage 30] [--n-ins 30] [--seed 0] [--out JSON]
        [--device cuda|cpu] [--wavefront auto|on|off]
        [--wavefront-stages alignment,assembly] [--workdir DIR]
        [--read-len 9000] [--threads T] [--chroms K] [--ont]
        [--hard-library]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def generators():
    """tools/genome_eval.py as a module of its own, loaded by file path (its
    module level imports only numpy)."""
    spec = importlib.util.spec_from_file_location(
        "genome_eval_generators",
        os.path.join(REPO, "tools", "genome_eval.py"))
    ge = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ge)
    return ge


def simulate_dataset(size=5_000_000, coverage=30, n_ins=30, seed=0,
                     workdir=None, read_len=9000, chroms=1,
                     ont_profile=False, hard=False):
    """tools/genome_eval.py's dataset, draw for draw, written with the
    port's FASTA writer to the same files (ref.fa, reads.fa, lib.fa under
    workdir) with the same names: chromosome chr2L, or chr1..chrK with
    chroms > 1; reads c{chrom index}_read{n}.  Returns (ref_fa, reads_fa,
    lib_fa, truth, n_reads, n_bases)."""
    from telr_tpu_torch.io.fasta import write_fasta
    from telr_tpu_torch.io.seqs import SeqDict, Sequence

    ge = generators()
    rng = np.random.default_rng(seed)
    t0 = time.time()
    library = ge.make_te_library(rng, hard=hard)
    ref_seqs, truth, reads = [], [], []
    for ci in range(chroms):
        cname = f"chr{ci + 1}" if chroms > 1 else "chr2L"
        genome = ge.make_genome(size // chroms, library, rng, hard=hard)
        ctruth = ge.plant_insertions(genome, library,
                                     max(1, n_ins // chroms), rng)
        creads = ge.simulate_reads(genome, ctruth, coverage, rng,
                                   read_len_mean=read_len,
                                   ont_profile=ont_profile)
        for t in ctruth:
            t["chrom"] = cname
        truth.extend(ctruth)
        ref_seqs.append(Sequence(cname, genome))
        reads.extend((f"c{ci}_{n}", c) for n, c in creads)
    n_bases = sum(len(c) for _, c in reads)
    print(f"simulated: genome {size / 1e6:.1f}Mb x{chroms} chroms, "
          f"{len(truth)} insertions, {len(reads)} reads "
          f"({n_bases / 1e6:.0f}Mb) in {time.time() - t0:.0f}s", flush=True)

    workdir = workdir or tempfile.mkdtemp(prefix="telr_eval")
    os.makedirs(workdir, exist_ok=True)
    ref_fa = os.path.join(workdir, "ref.fa")
    reads_fa = os.path.join(workdir, "reads.fa")
    lib_fa = os.path.join(workdir, "lib.fa")
    write_fasta(SeqDict(ref_seqs), ref_fa)
    write_fasta(SeqDict([Sequence(n, c) for n, c in reads]), reads_fa)
    write_fasta(SeqDict([Sequence(n, c) for n, c in library.items()]),
                lib_fa)
    return ref_fa, reads_fa, lib_fa, truth, len(reads), n_bases


def run_eval(size=5_000_000, coverage=30, n_ins=30, seed=0,
             wavefront="auto", out_path=None, workdir=None, read_len=9000,
             threads=1, chroms=1, ont_profile=False, wavefront_stages=None,
             hard=False, device=None):
    """Simulate, run the port's pipeline on `device` (None: the first CUDA
    card, raising when there is none; "cpu": the kernels' plain versions),
    score, and write the report to out_path (default
    WORKDIR/genome_eval.json).  Returns the report."""
    from telr_tpu_torch.utils.procpool import ensure_forkserver
    ensure_forkserver()   # before CUDA starts threads (see procpool.py)
    import torch

    from telr_tpu_torch.cli import _resolve_wavefront
    from telr_tpu_torch.config import SVConfig, TELRConfig
    from telr_tpu_torch.pipeline import run_pipeline
    from telr_tpu_torch.tools.bench_pipeline import (device_record,
                                                     kernel_launches,
                                                     reset_launches,
                                                     stage_record)
    from telr_tpu_torch.utils.device import resolve

    dev = resolve(device)
    use_wf, stages = _resolve_wavefront(
        wavefront, ",".join(wavefront_stages) if wavefront_stages else None,
        dev.type)
    workdir = workdir or tempfile.mkdtemp(prefix="telr_eval")
    ref_fa, reads_fa, lib_fa, truth, n_reads, n_bases = simulate_dataset(
        size, coverage, n_ins, seed, workdir, read_len, chroms,
        ont_profile=ont_profile, hard=hard)
    cfg = TELRConfig(sv=SVConfig(min_support=max(3, coverage // 8)),
                     use_wavefront=use_wf, threads=threads,
                     wavefront_stages=stages,
                     presets="ont" if ont_profile else "pacbio")
    cfg.validate()   # a misspelt stage name fails here, not silently
    reset_launches()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    with stage_record() as stages_rec:
        res = run_pipeline(reads_fa, ref_fa, lib_fa,
                           os.path.join(workdir, "out"), cfg,
                           checkpoint_dir=os.path.join(workdir, "ckpt"),
                           device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    pipe_s = time.time() - t0

    score = generators().score_calls(res.final_report, truth)
    restored = set(res.restored_stages)
    # a restored stage's seconds are a checkpoint load, not compute: no
    # throughput is reported from them
    align_s = (float("nan") if "alignment" in restored
               else res.stage_seconds.get("alignment", float("nan")))
    locus_stages = (0.0 if "assembly" in restored
                    else sum(res.stage_seconds.get(k, 0.0) for k in
                             ("assembly", "annotate_contig",
                              "allele_frequency", "liftover")))
    report = {
        "workload": {"genome_mb": size / 1e6, "coverage": coverage,
                     "n_reads": n_reads, "read_mb": n_bases / 1e6,
                     "n_truth": len(truth), "seed": seed,
                     "read_len_mean": read_len,
                     "ont_profile": ont_profile,
                     "hard_library": hard,
                     "chroms": chroms,
                     "use_wavefront": use_wf,
                     "wavefront_stages": list(stages) if stages else None},
        "score": score,
        "throughput": {
            "reads_per_s": round(n_reads / align_s, 2)
            if align_s == align_s else None,
            "read_mb_per_s": round(n_bases / 1e6 / align_s, 3)
            if align_s == align_s else None,
            "loci_per_s": round(len(res.records) / locus_stages, 3)
            if locus_stages else None,
        },
        "restored_stages": sorted(restored),
        "stage_seconds": {k: round(v, 2)
                          for k, v in res.stage_seconds.items()},
        "wall_s": round(pipe_s, 1),
        "n_calls": len(res.final_report),
        "launches": kernel_launches(),
        # per stage: launches, and each grouped dispatch's estimated cells
        # and whether it crossed the size gate to the kernels
        "stages": stages_rec,
        "workdir": workdir,
        **device_record(dev),
    }
    out_path = out_path or os.path.join(workdir, "genome_eval.json")
    with open(out_path, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report["score"]))
    print(json.dumps(report["throughput"]))
    print(json.dumps(report), flush=True)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=5_000_000)
    ap.add_argument("--coverage", type=int, default=30)
    ap.add_argument("--n-ins", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="the report (default: WORKDIR/genome_eval.json)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--wavefront", choices=["auto", "on", "off"],
                    default="auto",
                    help="the CLI's routing of DP to the wavefront kernels")
    ap.add_argument("--wavefront-stages", default=None,
                    help="comma list: route only these stages' DPs to "
                         "the device (overrides --wavefront)")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--read-len", type=int, default=9000)
    ap.add_argument("--threads", type=int, default=1)
    ap.add_argument("--chroms", type=int, default=1)
    ap.add_argument("--ont", action="store_true",
                    help="ONT-like error profile + MAP_ONT preset")
    ap.add_argument("--hard-library", action="store_true",
                    help="harder TE library: diverged subfamilies, "
                         "inter-family homology, 5'-truncated LINE "
                         "copies, satellite arrays")
    a = ap.parse_args(argv)
    stages = (tuple(x.strip() for x in a.wavefront_stages.split(","))
              if a.wavefront_stages else None)
    return run_eval(a.size, a.coverage, a.n_ins, a.seed, a.wavefront, a.out,
                    a.workdir, read_len=a.read_len, threads=a.threads,
                    chroms=a.chroms, ont_profile=a.ont,
                    wavefront_stages=stages, hard=a.hard_library,
                    device="cpu" if a.device == "cpu" else None)


if __name__ == "__main__":
    main()
