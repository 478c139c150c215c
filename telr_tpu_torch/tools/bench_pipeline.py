"""Pipeline-level benchmark of the port on a synthetic dataset.

The counterpart of the repository's bench_pipeline.py: generates the
synthetic multi-locus dataset (a 120 kb genome with three planted
insertions), runs the port's full pipeline once, and prints ONE JSON line
with the same keys:

  - aligned read bases / s (stage 1 throughput)
  - loci assembled / s (stage 2 throughput)
  - end-to-end wall-clock and per-stage split
  - recall on the known planted insertions

plus the device, the card's name and power limit when it ran on one, each
kernel's launches and the peak device memory.  Stage routing is the CLI's
(--wavefront auto|on|off).  --synthetic is the only dataset: the bundled
TELR test data is not part of the repository.

Also the home of the small datasets the port's tests and chip_smoke.py's
card-route phase run: `small_dataset` (a 12 kb genome, one insertion),
`tiny_dataset` (the same recipe at 6 kb) and `tail_dataset` (12 kb with a
reference TE copy, so that every tail stage has a DP to run); and of
`stage_record`, which attributes the kernels' launches and the mapper's
grouped dispatches to the pipeline stage that made them.

Usage:
    python -m telr_tpu_torch.tools.bench_pipeline --synthetic
        [--device cuda|cpu] [--wavefront auto|on|off] [--threads T]
        [--workdir DIR]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import sys
import tempfile
import time

import numpy as np


def _noisy(rng, codes, err=0.04):
    """Each base deleted, preceded by a random insertion, or substituted,
    with err / 3 each (the loop both dataset recipes share)."""
    out = []
    for c in codes:
        r = rng.random()
        if r < err / 3:
            continue
        if r < 2 * err / 3:
            out.append(rng.integers(0, 4))
        out.append(rng.integers(0, 4) if rng.random() < err / 3 else c)
    return np.array(out, dtype=np.int8)


def _sample_reads(rng, hap, read_len, step, reads):
    """Reads of `hap` starting every `step` bases, twice over, through
    _noisy, every third (counting those already in `reads`)
    reverse-complemented; appended to `reads` (the loop every dataset recipe
    shares)."""
    from telr_tpu_torch.io.seqs import Sequence, revcomp_codes
    for _rep in range(2):
        for start in range(0, len(hap) - read_len, step):
            seq = _noisy(rng, hap[start:start + read_len])
            if len(reads) % 3 == 2:
                seq = revcomp_codes(seq)
            reads.append(Sequence(f"read{len(reads)}", seq))


def synthetic_dataset(outdir: str):
    """bench_pipeline.py's dataset, byte for byte: a 120 kb genome (chrS),
    two insertions of a 2 kb TE (alpha, one reverse-complemented) and one of
    a 1.2 kb TE (beta), 12 kb reads every 3 kb twice over, 4 % errors, every
    third read reverse-complemented.  Returns (reads, ref, lib, truth)."""
    from telr_tpu_torch.io.fasta import write_fasta
    from telr_tpu_torch.io.seqs import Sequence, revcomp_codes
    rng = np.random.default_rng(7)
    G = 120_000
    ref = rng.integers(0, 4, G).astype(np.int8)
    te1 = rng.integers(0, 4, 2_000).astype(np.int8)
    te2 = rng.integers(0, 4, 1_200).astype(np.int8)
    sites = [(30_000, te1), (70_000, revcomp_codes(te1)), (100_000, te2)]
    parts, prev = [], 0
    for pos, te in sites:
        parts.append(ref[prev:pos])
        parts.append(te)
        prev = pos
    parts.append(ref[prev:])
    hap = np.concatenate(parts)

    reads = []
    _sample_reads(rng, hap, 12_000, 3_000, reads)
    write_fasta([Sequence("chrS", ref)], os.path.join(outdir, "ref.fa"))
    write_fasta(reads, os.path.join(outdir, "reads.fa"))
    write_fasta([Sequence("alpha", te1), Sequence("beta", te2)],
                os.path.join(outdir, "lib.fa"))
    truth = [(30_000, "alpha"), (70_000, "alpha"), (100_000, "beta")]
    return (os.path.join(outdir, "reads.fa"), os.path.join(outdir, "ref.fa"),
            os.path.join(outdir, "lib.fa"), truth)


def small_dataset(outdir: str, genome: int = 12_000, te_len: int = 1_200,
                  read_len: int = 4_000, step: int = 1_000, chroms: int = 1):
    """synthetic_dataset's recipe at a tenth of the size: a 12 kb genome
    (chrS), one 1.2 kb insertion (alpha) in its middle, 4 kb reads every
    1 kb, twice over (8x), 4 % errors, every third read reverse-complemented.
    chroms > 1 repeats the recipe on chromosomes chr1, chr2, ... with an
    insertion of the same TE each.  Returns ((reads, ref, lib), truth) with
    truth [(pos, family)] (one chromosome) or [(chrom, pos, family)]."""
    from telr_tpu_torch.io.fasta import write_fasta
    from telr_tpu_torch.io.seqs import Sequence
    rng = np.random.default_rng(11)
    names = ["chrS"] if chroms == 1 else [f"chr{k + 1}" for k in
                                           range(chroms)]
    refs = [rng.integers(0, 4, genome).astype(np.int8) for _ in names]
    te = rng.integers(0, 4, te_len).astype(np.int8)
    pos = genome // 2
    reads, truth = [], []
    for name, ref in zip(names, refs):
        hap = np.concatenate([ref[:pos], te, ref[pos:]])
        _sample_reads(rng, hap, read_len, step, reads)
        truth.append((name, pos, "alpha") if chroms > 1 else (pos, "alpha"))
    paths = [os.path.join(outdir, f) for f in ("reads.fa", "ref.fa",
                                                 "lib.fa")]
    write_fasta(reads, paths[0])
    write_fasta([Sequence(n, r) for n, r in zip(names, refs)], paths[1])
    write_fasta([Sequence("alpha", te)], paths[2])
    return paths, truth


def tiny_dataset(outdir: str):
    """small_dataset at half the size: a 6 kb genome, a 0.6 kb insertion,
    2 kb reads every 500 bases (8x).  Small enough for the reference's
    stage 1 to run its interpret-mode kernel in a CPU test."""
    return small_dataset(outdir, genome=6_000, te_len=600, read_len=2_000,
                         step=500)


def tail_dataset(outdir: str):
    """small_dataset's recipe with a reference TE: a 12 kb genome (chrS)
    holding a truncated copy of alpha (its last 700 bases, 3 % diverged, at
    1 kb) besides one 1.2 kb insertion of alpha in its middle; the library
    has alpha and a 1 kb beta.  Reads as small_dataset's: 4 kb every 1 kb,
    twice over (8x), 4 % errors, every third reverse-complemented.  On it
    every tail stage has a DP to run: ref_repeatmask finds the copy, and
    liftover reads it as the nearest reference TE of the insertion's family
    (its distance is in liftover_report.json).  Returns ((reads, ref, lib),
    truth) with truth [(pos, family)]."""
    from telr_tpu_torch.io.fasta import write_fasta
    from telr_tpu_torch.io.seqs import Sequence
    rng = np.random.default_rng(13)
    genome = 12_000
    ref = rng.integers(0, 4, genome).astype(np.int8)
    lib = {"alpha": rng.integers(0, 4, 1_200).astype(np.int8),
           "beta": rng.integers(0, 4, 1_000).astype(np.int8)}
    copy = _noisy(rng, lib["alpha"][-700:], err=0.03)
    ref = np.concatenate([ref[:1_000], copy,
                          ref[1_000 + len(copy):]])[:genome]
    pos = genome // 2
    hap = np.concatenate([ref[:pos], lib["alpha"], ref[pos:]])
    reads = []
    _sample_reads(rng, hap, 4_000, 1_000, reads)
    paths = [os.path.join(outdir, f) for f in ("reads.fa", "ref.fa",
                                                 "lib.fa")]
    write_fasta(reads, paths[0])
    write_fasta([Sequence("chrS", ref)], paths[1])
    write_fasta([Sequence(n, c) for n, c in lib.items()], paths[2])
    return paths, [(pos, "alpha")]


def nvidia_smi() -> str:
    """The card's `name, power limit` as nvidia-smi gives them (the first
    card)."""
    import subprocess
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def _kernel_wrappers():
    from telr_tpu_torch.kernels import hopper_dp
    from telr_tpu_torch.kernels import hopper_wavefront as hw
    return (hw.wavefront_dp, hw.wavefront_walk, hopper_dp.rowband_dp,
            hopper_dp.rowband_walk)


def kernel_launches() -> dict:
    """Each hand-written kernel's CUDA launches since reset_launches()."""
    return {k.__name__: k.launches for k in _kernel_wrappers()}


def kernel_launches_by_card() -> dict:
    """Each hand-written kernel's CUDA launches by card index since
    reset_launches()."""
    return {k.__name__: dict(k.cards) for k in _kernel_wrappers()}


def reset_launches() -> None:
    for k in _kernel_wrappers():
        k.launches = 0
        k.cards.clear()


class StageTap(logging.Handler):
    """The stage a pipeline run is in, read from the "stage <name> ..." line
    run_pipeline logs as each stage starts (on the "telr_tpu" logger, which
    the JAX package's pipeline logs the same line to).  A `with` block
    attaches it, at INFO, for the block; `on_stage(old, new)` callbacks run
    at every stage change."""

    LOGGER = "telr_tpu"

    def __init__(self):
        super().__init__(logging.INFO)
        self.stage = None
        self.on_stage = []

    def emit(self, record):
        if record.msg == "stage %s ...":
            new = record.args[0]
            for fn in self.on_stage:
                fn(self.stage, new)
            self.stage = new

    def __enter__(self):
        log = logging.getLogger(self.LOGGER)
        self._level = log.level
        log.setLevel(logging.INFO)
        log.addHandler(self)
        return self

    def __exit__(self, *exc):
        log = logging.getLogger(self.LOGGER)
        log.removeHandler(self)
        log.setLevel(self._level)


@contextlib.contextmanager
def stage_record():
    """Within the block, per pipeline stage: each kernel's launches, and
    every grouped dispatch with wavefront work as [estimated cells
    (mapper._wave_cells), whether it crossed the size gate to the kernels].
    Yields {stage: {"launches": {...}, "dispatches": [[cells, on_card],
    ...]}}, filled as the run goes."""
    from telr_tpu_torch.kernels import mapper
    rec = {}
    last = [kernel_launches()]

    def entry(stage):
        return rec.setdefault(stage, {
            "launches": {k: 0 for k in last[0]}, "dispatches": []})

    def switch(old, _new):
        now = kernel_launches()
        if old is not None:
            for k, v in now.items():
                entry(old)["launches"][k] += v - last[0][k]
        last[0] = now

    real_gate = mapper._wave_goes_to_host
    tap = StageTap()

    def gate(wave_buckets, wave_ext_items):
        to_host = real_gate(wave_buckets, wave_ext_items)
        if wave_buckets or wave_ext_items:
            entry(tap.stage)["dispatches"].append(
                [mapper._wave_cells(wave_buckets, wave_ext_items),
                 not to_host])
        return to_host

    tap.on_stage.append(switch)
    mapper._wave_goes_to_host = gate
    try:
        with tap:
            yield rec
    finally:
        mapper._wave_goes_to_host = real_gate
        switch(tap.stage, None)


def device_record(dev) -> dict:
    """`device`, and on a card its nvidia-smi name and power limit and the
    peak device memory since the last reset."""
    import torch
    rec = {"device": str(dev)}
    if dev.type == "cuda":
        rec["nvidia_smi"] = nvidia_smi()
        rec["peak_device_bytes"] = torch.cuda.max_memory_allocated(dev)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--synthetic", action="store_true",
                    help="the synthetic 120 kb dataset (the only one)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--wavefront", choices=["auto", "on", "off"],
                    default="auto")
    ap.add_argument("--threads", type=int, default=1)
    ap.add_argument("--workdir", default=None)
    args = ap.parse_args(argv)
    if not args.synthetic:
        sys.exit("bench_pipeline: only --synthetic is available (the "
                 "bundled TELR test data is not in the repository)")

    from telr_tpu_torch.utils.procpool import ensure_forkserver
    ensure_forkserver()   # before CUDA starts threads (see procpool.py)
    import torch

    from telr_tpu_torch.cli import _resolve_wavefront
    from telr_tpu_torch.config import SVConfig, TELRConfig
    from telr_tpu_torch.io.fasta import read_fasta
    from telr_tpu_torch.pipeline import run_pipeline
    from telr_tpu_torch.utils.device import resolve

    dev = resolve("cpu" if args.device == "cpu" else None)
    use_wf, stages = _resolve_wavefront(args.wavefront, device=dev.type)
    cfg = TELRConfig(sv=SVConfig(min_support=3), threads=args.threads,
                     use_wavefront=use_wf, wavefront_stages=stages)
    tmp = args.workdir or tempfile.mkdtemp(prefix="telr_bench_")
    os.makedirs(tmp, exist_ok=True)
    reads_p, ref_p, lib_p, truth = synthetic_dataset(tmp)

    total_bases = sum(len(s) for s in read_fasta(reads_p))
    reset_launches()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    res = run_pipeline(reads_p, ref_p, lib_p, os.path.join(tmp, "out"),
                       config=cfg, device=dev)
    wall = time.time() - t0

    n_loci = len(res.contigs)
    align_s = res.stage_seconds.get("alignment", 1e-9)
    asm_s = res.stage_seconds.get("assembly", 1e-9)
    hits = 0
    for pos, fam in truth:
        for call in res.final_report:
            if call["family"] == fam and abs(call["start"] - pos) < 200:
                hits += 1
                break
    report = {
        "wall_s": round(wall, 1),
        "aligned_bases_per_s": round(total_bases / align_s),
        "loci_assembled_per_s": round(n_loci / asm_s, 3),
        "recall": round(hits / len(truth), 3),
        "calls": len(res.final_report),
        "stages_s": {k: round(v, 1) for k, v in res.stage_seconds.items()},
        "wavefront_stages": list(stages) if stages else None,
        "launches": kernel_launches(),
        **device_record(dev),
    }
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
