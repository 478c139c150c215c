#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (telr_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py [--size BASES] [--coverage X] [--n-ins N] [--seed S]

Phases, in order; any failure raises and the script exits non-zero:

  1. probe     torch / CUDA / nvcc versions and the card's name and power
               limit; fails unless torch.cuda.is_available();
  2. build     nvcc builds the hand-written kernels (telr_tpu_torch/csrc);
  3. parity    each kernel against its plain torch version on the card, bit
               for bit, in all three DP modes.  The wavefront kernels at
               W = 128, 512 and 2048 (the W=2048 batch is bench.py's 64
               pairs of 2 kb x 3 kb), plus an EXTEND batch shaped like the
               mapper's chunked rounds; then, in GLOBAL and EXTEND, a batch
               of tail-stage region DPs (0.4-0.9 kb at W = 128) and that
               EXTEND batch at the tail stages' score sets, LIB_TO_SEQ's
               (2, 3, 5, 2) and ASM10's (1, 9, 16, 2).  The row-banded DP at
               the shapes of
               the mesh path: bench.py's row-banded batch (64 pairs, 2048 x
               3072, W = 512), an extension round (256 pairs, 512 x 704 in
               the 1024 bucket, W = 512), a region batch (64 related pairs of
               1.5-3.5 kb in the 4096 bucket, W = 128) and a wide band
               (W = 2048).  Each scores-only instance against its traceback
               instance.  The row-banded walk on those direction bytes
               against its plain version and against the native host walk
               (ops, start and end cell, band margin, bad flag).  Kernel and
               plain times, and what a launch sends to the host: the packed
               walks, against the direction bytes the host walk needed.
               Each walk case prints its longest walk and the nanoseconds a
               step of it took;
  4. walk-tiles  both walks on cases made to cross the walk kernels' tile
               edges (walk_tile_cases), in all three modes: D and I runs of
               150-450 steps, a walk along a constraining band edge, walks
               that leave the band, a LOCAL STOP in mid-tile, starts on row 0
               and at (0, 0); each against its plain version on every output
               byte, the row-banded walk also against the native host walk;
  5. dist      the score steps, the sharded runner (its direction bytes, and
               align_pairs through its device walks against the native
               engine's align_pairs, both cigar forms), the depth reduction
               and the locus all-to-all on a one-card mesh, against the plain
               version, AlignmentStore.coverage and the owner rule;
  6. pipeline  the CLI (--device cuda, default auto routing) on a simulated
               genome (--size: by default 3 Mb at 30x with 10 planted
               insertions, seed 3, from tools/genome_eval.py's generators):
               stage seconds, launches by shape, peak device memory,
               precision / recall / F1 against the planted truth.
               Fails if a wavefront kernel was not launched, the vote did not
               run on the card, an output file is missing or F1 < 0.8.  The
               run keeps per-stage checkpoints (--checkpoint_dir) for the
               next phase;
  7. entry-points  that run entered by other ways: its checkpointed stage-1
               alignments written as a BAM (write_bam, with the reference's
               sizes), the CLI on the BAM (--device cuda, auto routing; the
               alignment stage is skipped) while a process of its own writes
               them as a SAM and reads the SAM and the BAM back, then the
               FASTA run again on its checkpoint directory.  Prints
               the BAM's size and its write and read seconds, the runs'
               stage seconds and walls, the BAM run's launches by stage and
               peak device memory.  Fails unless the BAM run writes the FASTA
               run's nine files, launches both wavefront kernels in assembly,
               runs the vote on the card and reaches F1 >= 0.8; unless the SAM
               gives the BAM's alignments and reads and every read rebuilt
               from the records is its FASTA read; and unless the resumed run
               restores alignment, te_filter, assembly and ref_repeatmask and
               writes the first run's files (its loci_eval.tsv less the lines
               of the loci te_filter and assembly dropped, which a restored
               stage does not log again, as in the JAX package);
  8. pipeline-mesh  the CLI with --mesh_devices 1 --wavefront off on a
               genome of the same make cut to MESH_SIZE (1 Mb, so that the
               whole script stays well inside its time limit): the same
               checks, plus the locus_redistribute
               stage, row-banded DP and walk launches (by shape), the bytes
               stage 1 copied back from the card and the depth reduction on
               the card; then at 300 kb the mesh run's output files byte for
               byte against a --wavefront off run without a mesh (the
               native host engine);
  9. multiprocess  run_pipeline_multiprocess through
               telr_tpu_torch/tools/two_process_pipeline.py on a genome of
               the same make cut to MP_SIZE with MP_N_INS insertions (1 Mb
               and 5, for the time limit since the card-route, eval and bench
               phases joined the script; auto routing, --device cuda): one
               process, then two
               that share the card with collectives over gloo.  Fails unless
               the runs' seven files are byte-identical, every rank launched
               both wavefront kernels and ran the vote on the card, and
               F1 >= 0.8; prints stage seconds, walls, T1 / (2 T2), and each
               rank's launches and peak device memory;
 10. profile   the CLI with --profile_dir at 300 kb and
               telr_tpu_torch/tools/profile_report.py on its trace: per-stage
               device seconds and top kernels, the trace's size.  Fails
               unless alignment and assembly each show time in both
               wavefront kernels and no stage has more device time than wall;
 11. card-route  the CLI with the mappers' size gate at 0 on
               telr_tpu_torch/tools/bench_pipeline.py's small_dataset with
               --wavefront_stages alignment,assembly, and on its tail_dataset
               (a reference copy of the inserted family) with --wavefront on,
               each with --device cuda and with --device cpu (the kernels'
               plain versions, which the CPU tests hold to the JAX package's
               files on the same routes; the CPU runs in processes of their
               own, started when the script starts, so that they run beside
               the phases before this one).  Prints the tail run's launches by
               stage.  Fails unless each pair's nine files are
               byte-identical, both wavefront kernels launched on the card
               and, on tail_dataset, in each of the five tail stages;
 12. eval      telr_tpu_torch/tools/genome_eval.py's run_eval on the card,
               auto routing: 1 Mb in two chromosomes, ONT-like reads and the
               ONT preset, the pipeline phases' coverage, insertions and
               seed.  Fails unless F1 >= 0.8 and both wavefront kernels
               launched;
 13. bench     telr_tpu_torch/tools/bench.py with 3 trials (the score-only
               wavefront DP on bench.py's workload, and its traceback path).
               Fails unless the kernel's gscore and best of the 64 pairs
               equal the plain version's (timed there).

One phase runs only when asked for, alone, on a host of two or more cards
(`python3 chip_smoke.py --phases multicard`; its checks are sized for
four):

 multicard  the multi-card half, on every card torch sees: (a) the dist
               components (score steps, runner with walks, depth reduction,
               all-to-all) on a (2, 2) mesh, bit for bit against a one-card
               mesh and the host references, and one batch of the runner on
               one card and on all of them, with each card's busy window
               from a torch.profiler trace; (b) tools/exchange_bench.py at
               one rank a card, over gloo and over NCCL on the same seeded
               inputs, the received items equal, each timed; (c) the
               multi-process runner at 1, 2 and 4 ranks, one a card, over
               NCCL, on the pipeline phase's genome (--size); (d) the CLI at
               --mesh_devices 1, 2 and 4 (--wavefront off) on that genome.
               Fails unless every file equals the one-card run's, every
               rank ran over NCCL with its kernels and vote on its own card,
               every card of a mesh launched both row-banded kernels, and
               F1 >= 0.8.  Prints stage seconds, launches by card, peak
               device memory, the exchange's seconds and bytes, then a JSON
               summary, nvidia-smi's line for every card and the ok line.

Every kernel's launch count is set to 0 just before the phase that drives its
path and read just after.  The last lines are a JSON summary of the kernels
(time, plain time, launches and the least time the card could take, see
`bounds`), the card's nvidia-smi name and power limit, and {"ok": true,
"device": {...}}.  Nothing here imports jax or the JAX package.
"""

import argparse
import contextlib
import json
import logging
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

try:
    # the least time the card could take (roofline.bounds), the operations
    # a band cell or walk step costs
    from telr_tpu_torch.tools.roofline import (ROWBAND_OPS, WALK_OPS_PER_STEP,
                                               WAVEFRONT_OPS, bounds)
    # tools/genome_eval.py's dataset as the port's tools write it
    from telr_tpu_torch.tools.two_process_pipeline import simulate
    # each kernel's launches by the stage the pipeline logs
    from telr_tpu_torch.tools.bench_pipeline import stage_record
except ImportError:
    sys.exit("chip_smoke: telr_tpu_torch/ is not beside this script; run it "
             "from a checkout of the repository")

OUTPUTS = ("json", "expanded.json", "vcf", "bed", "te.fasta", "contig.fasta")
# every file a run writes but its provenance and its timestamped log
RUN_FILES = tuple("reads.telr." + x for x in OUTPUTS) + (
    "reads.loci_eval.tsv", "liftover_summary.json", "liftover_report.json")
KERNELS = {
    "wavefront_dp": ("telr_tpu_torch/csrc/wavefront_dp.cu",
                     "telr_tpu/kernels/pallas_wavefront.py:75"),
    "wavefront_walk": ("telr_tpu_torch/csrc/wavefront_walk.cu",
                       "telr_tpu/kernels/pallas_wavefront.py:941"),
    "rowband_dp": ("telr_tpu_torch/csrc/rowband_dp.cu",
                   "telr_tpu/kernels/pallas_dp.py:53"),
    "rowband_walk": ("telr_tpu_torch/csrc/rowband_walk.cu",
                     "telr_tpu/kernels/dp.py:379"),
}

PHASES = ("parity", "rowband-parity", "walk-tiles", "dist", "pipeline",
          "entry-points", "pipeline-mesh", "mesh-identity", "multiprocess",
          "profile", "card-route", "eval", "bench")
# phases that run only when --phases names them: the multi-card half needs
# two or more cards
EXTRA_PHASES = ("multicard",)
# the pipeline-mesh phase's genome: on an NVIDIA H100 80GB HBM3 host the
# mesh path at 3 Mb took 112-123 s of 802-938 s of phases; at 1 Mb the
# script keeps its margin to its time limit on a slower host
MESH_SIZE = 1_000_000
# the multiprocess phase's genome and insertions: with 10 insertions that
# phase took 175-231 s at 3 Mb and 172-215 s at 2 Mb on the same card (its
# assembly follows the loci); at 1 Mb and 5 the new phases (about 230 s)
# fit beside it
MP_SIZE = 1_000_000
MP_N_INS = 5
# the files run_pipeline_multiprocess writes
MP_FILES = tuple("reads.telr." + x for x in OUTPUTS) + (
    "reads.loci_eval.tsv",)
# the dropped-locus ledger, and the drop reasons of the stages a resumed run
# restores (te_filter's and assembly's)
LEDGER = "reads.loci_eval.tsv"
RESTORED_REASONS = ("VCF sequence not repeatmasked", "local assembly failed")


def _related(rng, lq, lt, n_sub, indel=0):
    """A (query, target) pair: the query is the target's first lq bases with
    n_sub substitutions and, when indel > 0, an indel of that length."""
    t = rng.integers(0, 4, lt).astype("int8")
    q = t[:lq].copy()
    idx = rng.integers(0, lq, n_sub)
    q[idx] = rng.integers(0, 4, n_sub)
    if indel:
        k = int(rng.integers(lq // 4, lq // 2))
        if rng.random() < 0.5:
            q = np.delete(q, np.arange(k, k + indel))
        else:
            q = np.insert(q, k, rng.integers(0, 4, indel)).astype("int8")
    return q, t


def ptxas_summary(log):
    """One line per compiled kernel from nvcc's -Xptxas -v report: its
    template instance, registers and spill bytes."""
    out, name, spills = [], "?", ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = re.search(r"((?:wavefront|rowband)_[a-z]+_kernel)(\w*)",
                          m.group(1))
            if k:
                # template arguments as mangled: Li<int>E, Lb<0|1>E
                targs = [v if t == "i" else ("false", "true")[int(v)]
                         for t, v in re.findall(r"L([ib])(\d+)E", k.group(2))]
                name = k.group(1) + (f"<{', '.join(targs)}>" if targs else "")
            else:
                name = m.group(1)
        elif "spill stores" in line:
            spills = line.split(":")[-1].strip()
        elif "Used" in line:
            out.append(f"{name}: {line.split(':')[-1].strip()}; {spills}")
    return out


def parity_cases(seed=0):
    """(name, width, pairs, guides) batches at the main path's shapes."""
    rng = np.random.default_rng(seed)
    cases = []
    # stage-1 region DPs at W=128: read-sized pairs
    pairs = []
    for _ in range(64):
        lq = int(rng.integers(1500, 3500))
        pairs.append(_related(rng, lq, lq + 200, lq // 10,
                              indel=int(rng.integers(0, 40))))
    cases.append(("region128", 128, pairs, None))
    # wider region DPs at W=512 with a long indel inside the band
    pairs = [_related(rng, 2000, 2400, 200, indel=int(rng.integers(50, 200)))
             for _ in range(32)]
    cases.append(("region512", 512, pairs, None))
    # bench.py's batch: 64 pairs of 2 kb x 3 kb at W=2048, diagonal guides
    pairs = [_related(rng, 2048, 3072, 200) for _ in range(64)]
    aq = np.arange(256, 2048 - 256, 512, dtype=np.int64)
    cases.append(("bench2048", 2048, pairs, [(aq, aq)] * 64))
    return cases


def extend_round_case(seed=1):
    """The mapper's chunked EXTEND round: 512 query x 704 target at W=128."""
    rng = np.random.default_rng(seed)
    pairs = [_related(rng, 512, 704, 50, indel=int(rng.integers(0, 30)))
             for _ in range(256)]
    return ("extend_round128", 128, pairs, None)


def tail_cases(seed=4):
    """Batches shaped like the tail stages' dispatches: region DPs of
    insertion sequences, library consensi and liftover flanks (0.4-0.9 kb,
    so that a pair's steps fit the 2048 rung) at W=128, and the chunked
    EXTEND round."""
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(64):
        lq = int(rng.integers(400, 900))
        pairs.append(_related(rng, lq, lq + 100, lq // 10,
                              indel=int(rng.integers(0, 30))))
    return [("tail_region128", 128, pairs, None), extend_round_case()]


def tail_score_sets():
    """The score sets the tail stages give the wavefront kernels besides the
    reads' (2, 4, 4, 2): the library's (LIB_TO_SEQ: te_filter, the family
    re-annotation, ref_repeatmask) and ASM10's (liftover)."""
    from telr_tpu_torch.config import ASM10, LIB_TO_SEQ
    from telr_tpu_torch.kernels.dp import DPParams
    return {p.name: DPParams(p.match, p.mismatch, p.gap_open, p.gap_extend)
            for p in (LIB_TO_SEQ, ASM10)}


def _timed(fn, reps, device):
    """Mean milliseconds of fn() over reps runs on the card (CUDA events,
    after two warm-up runs: the loop holds one result while the next is
    made, so the allocator must have cached two sets of outputs before the
    clock starts)."""
    import torch
    out = fn()
    out = fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps, out


def _max_err(pairs_of_tensors, rows=None):
    """Largest |a - b| over tensor pairs; with rows, only over the dirs rows
    it marks (taken eight pairs at a time to bound the temporaries)."""
    import torch
    err = 0
    for a, b in pairs_of_tensors:
        for lo in range(0, a.shape[0], 8):
            d = (a[lo:lo + 8].to(torch.int32) - b[lo:lo + 8].to(torch.int32)
                 ).abs()
            if rows is not None:
                d = d * rows[lo:lo + 8]
            if d.numel():
                err = max(err, int(d.max()))
    return err


def check_case(name, width, mode, pairs, guides, device, reps=3,
               params=None):
    """One batch through both kernels and both plain versions on `device`,
    at the score set `params` (default DPParams(), the reads'); raises on
    any difference.  Returns the per-kernel timings and errors."""
    import torch
    from telr_tpu_torch.kernels import cuda_lib
    from telr_tpu_torch.kernels import hopper_wavefront as hw
    from telr_tpu_torch.kernels.dp import DPParams
    params = params or DPParams()
    meta, init, scal = hw.prepare_wavefront_batch(pairs, width, guides)
    n = len(pairs)
    meta, init, scal = (torch.from_numpy(x).to(device)
                        for x in (meta, init, scal))
    S_pad = meta.shape[2]

    dp_ms, k_out = _timed(lambda: hw.wavefront_dp(
        meta, init, scal, n, width, mode, params, tb=True), reps, device)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    p_out = hw._wavefront_dp_plain(meta, init, scal, n, width, mode,
                                   params.tuple(), True)
    torch.cuda.synchronize(device)
    dp_plain_ms = (time.perf_counter() - t0) * 1e3
    for what, a, b in zip(("gscore", "best", "best_s", "best_p"),
                          k_out[:4], p_out[:4]):
        if not torch.equal(a, b):
            raise AssertionError(f"{name} mode {mode}: wavefront_dp {what} "
                                 "differs from the plain version")
    lq, lt = scal.reshape(-1, 8)[:n, 0], scal.reshape(-1, 8)[:n, 1]
    rows = (torch.arange(S_pad, device=device)[None, :]
            < (lq + lt)[:, None])[:, :, None]
    dirs_err = _max_err([(k_out[4], p_out[4])], rows)
    if dirs_err:
        raise AssertionError(f"{name} mode {mode}: wavefront_dp direction "
                             "bytes differ from the plain version")
    dp_err = max(_max_err(zip(k_out[:4], p_out[:4])), dirs_err)

    # every lanes-a-thread choice the wrapper can make, both instances,
    # against the one it made for this batch
    for lanes in cuda_lib.cell_options("wavefront_dp", width):
        o = hw.wavefront_dp(meta, init, scal, n, width, mode, params,
                            tb=True, lanes=lanes)
        o2 = hw.wavefront_dp(meta, init, scal, n, width, mode, params,
                             tb=False, lanes=lanes)
        if not (all(torch.equal(a, b) for a, b in zip(o[:4], k_out[:4]))
                and all(torch.equal(a, b) for a, b in zip(o2, k_out[:2]))
                and _max_err([(o[4], k_out[4])], rows) == 0):
            raise AssertionError(f"{name} mode {mode}: wavefront_dp at "
                                 f"{lanes} lanes a thread differs")
        del o, o2
    sc_ms, _ = _timed(lambda: hw.wavefront_dp(
        meta, init, scal, n, width, mode, params, tb=False), reps, device)

    walk = check_wavefront_walk(name, mode, k_out[4], meta, scal,
                                k_out[:4], device, reps)
    steps = int((lq + lt).sum())
    cells = steps * width
    wire = sum(x.numel() * x.element_size() for x in (meta, init, scal))
    # the DP reads the wire arrays and writes a byte per cell of its own
    # steps
    dp_bound = bounds(wire + cells + 16 * n, WAVEFRONT_OPS[True] * cells)
    sc_bound = bounds(wire + 8 * n, WAVEFRONT_OPS[False] * cells)
    return {"case": name, "width": width, "mode": mode, "pairs": n,
            "params": list(params.tuple()[:4]), "S_pad": S_pad,
            "cells": cells,
            "lanes": cuda_lib.pick_cells(
                width, n, cuda_lib.cell_options("wavefront_dp", width)),
            "dp_bound_ms": dp_bound[0], "dp_bound_by": dp_bound[1],
            "dp_scores_bound_ms": sc_bound[0],
            "dp_scores_bound_by": sc_bound[1],
            "dp_ms": dp_ms, "dp_plain_ms": dp_plain_ms, "dp_err": dp_err,
            "dp_scores_ms": sc_ms, **walk}


def check_wavefront_walk(name, mode, dirs, meta, scal, dp_out, device, reps,
                         allow_bad=False):
    """wavefront_walk on one batch's direction bytes against its plain
    version, every output byte; raises on any difference, and on a walk
    that left the band unless allow_bad.  Returns timings, errors, the
    steps walked and the bound."""
    import torch
    from telr_tpu_torch.kernels import hopper_wavefront as hw
    walk_in = (dirs, meta, scal) + tuple(dp_out) + (mode,)
    ms, (packed, small) = _timed(lambda: hw.wavefront_walk(*walk_in), reps,
                                 device)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    ppacked, psmall = hw._wavefront_walk_plain(*walk_in)
    torch.cuda.synchronize(device)
    plain_ms = (time.perf_counter() - t0) * 1e3
    if not (torch.equal(packed, ppacked) and torch.equal(small, psmall)):
        raise AssertionError(f"{name} mode {mode}: wavefront_walk differs "
                             "from the plain version")
    n_bad = int(small[4].sum())
    if n_bad and not allow_bad:
        raise AssertionError(f"{name} mode {mode}: {n_bad} walks left the "
                             "band")
    walked = _walked(packed.cpu().numpy(), 1)
    steps = int(walked.sum())
    longest = int(walked.max()) if walked.size else 0
    # a direction byte per step walked, the meta bytes of the steps up to
    # each start (the band base there is their sum), the DP outputs and wire
    # scalars read, the packed ops and the scalar stack written
    starts = int((small[5].long() + small[6].long()).sum())
    n = small.shape[1]
    out_bytes = packed.numel() + small.numel() * 4
    bound = bounds(steps + starts + 32 * n + out_bytes,
                   WALK_OPS_PER_STEP * steps + starts)
    return {"walk_ms": ms, "walk_plain_ms": plain_ms,
            "walk_bound_ms": bound[0], "walk_bound_by": bound[1],
            "walk_steps": steps, "walk_longest": longest,
            "walk_ns_per_step": ms * 1e6 / longest if longest else None,
            "walk_bad": n_bad,
            "walk_err": _max_err([(packed, ppacked), (small, psmall)])}


def phase_parity(device):
    from telr_tpu_torch.kernels.dp import EXTEND, GLOBAL, LOCAL
    results = []
    for name, width, pairs, guides in parity_cases():
        for mode in (GLOBAL, EXTEND, LOCAL):
            results.append(check_case(name, width, mode, pairs, guides,
                                      device))
    name, width, pairs, guides = extend_round_case()
    results.append(check_case(name, width, EXTEND, pairs, guides, device))
    # the tail stages' score sets, in the modes the mapper launches
    for params in tail_score_sets().values():
        for name, width, pairs, guides in tail_cases():
            for mode in (GLOBAL, EXTEND):
                results.append(check_case(name, width, mode, pairs, guides,
                                          device, params=params))
    return results


def rowband_batch(pairs, width, offs=None):
    """Pad (q, t) pairs to one row-banded batch as dp._prep_pair pads them
    (codes 4 past the lengths, the last offset repeated): (q, t, off, qlen,
    tlen)."""
    from telr_tpu_torch.kernels import dp
    lq_b = dp._bucket(max(len(q) for q, _ in pairs))
    lt_b = dp._bucket(max(len(t) for _, t in pairs))
    B = len(pairs)
    q = np.full((B, lq_b), 4, np.int8)
    t = np.full((B, lt_b), 4, np.int8)
    off = np.zeros((B, lq_b + 1), np.int32)
    qlen = np.zeros(B, np.int32)
    tlen = np.zeros(B, np.int32)
    for b, (qq, tt) in enumerate(pairs):
        o = (dp.make_band_offsets(len(qq), len(tt), width)
             if offs is None else offs[b])
        q[b, :len(qq)] = qq
        t[b, :len(tt)] = tt
        off[b] = o[-1]
        off[b, :len(o)] = o
        qlen[b], tlen[b] = len(qq), len(tt)
    return q, t, off, qlen, tlen


def rowband_cases(seed=2):
    """(name, width, (q, t, off, qlen, tlen)) padded batches at the shapes
    the mesh path hands the row-banded DP, built as dp._prep_pair pads them
    (codes 4 past the lengths, the last offset repeated)."""
    from telr_tpu_torch.kernels import dp
    rng = np.random.default_rng(seed)
    cases = []
    # bench.py's row-banded batch: 64 unrelated pairs, 2048 x 3072, W = 512
    B, LQ, LT, W = 64, 2048, 3072, 512
    brng = np.random.default_rng(0)
    q = brng.integers(0, 4, size=(B, LQ)).astype(np.int8)
    t = brng.integers(0, 4, size=(B, LT)).astype(np.int8)
    off = np.broadcast_to(dp.make_band_offsets(LQ, LT, W), (B, LQ + 1)).copy()
    cases.append(("bench512", W, (q, t, off, np.full(B, LQ, np.int32),
                                  np.full(B, LT, np.int32))))
    # one round of the mapper's chunked extension: 512 query bases against
    # 704 target bases, at the width dp._prep_pair picks for them (512)
    pairs = []
    for _ in range(256):
        q, t = _related(rng, 560, 704, 50, indel=int(rng.integers(0, 30)))
        pairs.append((q[:512], t))
    cases.append(("ext_round512", 512, rowband_batch(pairs, 512)))
    # stage-1 region DPs: read-sized related pairs in the 4096 bucket
    pairs = []
    for _ in range(64):
        lq = int(rng.integers(1500, 3500))
        pairs.append(_related(rng, lq, lq, lq // 10,
                              indel=int(rng.integers(0, 40))))
    cases.append(("region128", 128, rowband_batch(pairs, 128)))
    # a wide band following an anchor path across a long indel
    pairs, offs = [], []
    for _ in range(16):
        lq = int(rng.integers(2600, 3400))
        q, t = _related(rng, lq, 4000, lq // 10,
                        indel=int(rng.integers(300, 600)))
        pairs.append((q, t))
        anchors = np.arange(256, min(len(q), len(t)) // 4, 256)
        offs.append(dp.offsets_from_path(len(q), len(t), 2048, anchors,
                                         anchors))
    cases.append(("wide2048", 2048, rowband_batch(pairs, 2048, offs)))
    return cases


def _gapped(rng, core, gap, flank):
    """A (query, target) pair around a shared core of `core` bases with 2%
    substitutions: a gap of |gap| bases in its middle (gap > 0: deleted from
    the query, a run of D; gap < 0: inserted into it, a run of I), and
    `flank` unrelated bases on either side of both sequences, so a LOCAL
    walk stops where the core begins, in the middle of the matrix."""
    t = rng.integers(0, 4, core).astype("int8")
    q = t.copy()
    idx = rng.integers(0, core, core // 50)
    q[idx] = rng.integers(0, 4, len(idx))
    k = (core - max(gap, 0)) // 2
    if gap > 0:
        q = np.delete(q, np.arange(k, k + gap))
    elif gap < 0:
        q = np.insert(q, k, rng.integers(0, 4, -gap)).astype("int8")

    def fl():
        return rng.integers(0, 4, flank).astype("int8")
    return np.concatenate([fl(), q, fl()]), np.concatenate([fl(), t, fl()])


def walk_tile_cases(seed=7, core=1200, flank=100):
    """Walks that cross the walk kernels' tile edges, for both walks:
    (name, width, pairs, edit).  `gaps`: a D run and an I run of 150-450
    steps in a band wide enough for them (W = 1024 row-banded, 512
    wavefront), every run several tiles long; `edge`: the same gaps in a band
    too narrow for them (W = 128), so the walk runs along a constraining band
    edge (margin 0); `escape_d` / `escape_i`: every walk leaves the band;
    `row0`: starts on row 0 and at (0, 0).  The flanks put a LOCAL walk's
    STOP in the middle of a tile.  The edits (edit_rowband_walk,
    edit_wavefront_walk) are made to the DP outputs before the walk."""
    rng = np.random.default_rng(seed)
    pairs = [_gapped(rng, core, g, flank)
             for g in (150, -150, 300, -300, 450, -450, 200, -200)]
    return [("gaps", None, pairs, "none"), ("edge", 128, pairs, "none"),
            ("escape_d", None, pairs, "all_d"),
            ("escape_i", None, pairs, "all_i"),
            ("row0", None, pairs, "row0")]


def edit_rowband_walk(edit, mode, dp_out, qlen, tlen):
    """Apply a walk_tile_cases edit to the row-banded DP's outputs [dirs,
    gscore, best, besti, bestp] (torch tensors on any device): `all_d` /
    `all_i` make every direction byte an extended D (the walk runs left
    along its row) or an extended I (up its column); `row0` starts pair k's
    walk at the cell (0, k % 9), for GLOBAL through the lengths (0, k % 9).
    A walk from row 0 is the run of D along it, which the kernel writes
    without a tile.  dp_out is edited in place; returns (qlen, tlen)."""
    import torch
    from telr_tpu_torch.kernels.dp import GLOBAL
    if edit == "all_d":
        dp_out[0].fill_(1 | 4)
    elif edit == "all_i":
        dp_out[0].fill_(2 | 8)
    elif edit == "row0":
        k9 = torch.arange(len(qlen), device=qlen.device,
                          dtype=torch.int32) % 9
        if mode == GLOBAL:
            qlen, tlen = torch.zeros_like(qlen), k9
        else:
            dp_out[3], dp_out[4] = torch.zeros_like(k9), k9
    return qlen, tlen


def edit_wavefront_walk(edit, mode, dirs, meta, scal, best_s, best_p):
    """The same edits to the wavefront DP's outputs: `all_d` / `all_i` to
    its direction bytes; `row0` starts pair k's walk at (0, k % 9), for
    GLOBAL through the wire lengths (lq, lt) = (0, k % 9), else through
    best_s = k % 9 and the band position that puts that step's cell on row
    0 (best_s = 0: the empty alignment, which starts at (0, 0)).  The kernel
    walks only while i > 0 and j > 0 (the decode adds the run along row 0),
    so a row0 case tests the start cell's arithmetic and no tile.  dirs is
    edited in place; returns (scal, best_s, best_p)."""
    import torch
    from telr_tpu_torch.kernels.dp import GLOBAL
    if edit == "all_d":
        dirs.fill_(1 | 4)
    elif edit == "all_i":
        dirs.fill_(2 | 8)
    elif edit == "row0":
        n = dirs.shape[0]
        scal = scal.clone()
        sc = scal.view(-1, 8)[:n]
        k9 = torch.arange(n, device=dirs.device, dtype=torch.int32) % 9
        if mode == GLOBAL:
            sc[:, 0] = 0
            sc[:, 1] = k9
        else:
            # the band base m_s of each step: m0 plus the drifts up to s
            drift = (meta.view(-1, meta.shape[2])[:n].to(torch.int32)
                     & 1) * 2 - 1
            m = (sc[:, 3] - sc[:, 2])[:, None] + torch.cumsum(
                drift, dim=1, dtype=torch.int32)
            best_s = k9
            ms = m.gather(1, (best_s - 1).clamp(min=0).long()[:, None])[:, 0]
            # si = (s - m_s - 2 p) >> 1 = 0
            best_p = torch.div(best_s - ms, 2, rounding_mode="floor")
    return scal, best_s, best_p


def _walked(packed, pair_axis):
    """Steps each pair's walk took: the op codes other than 3 (none) in its
    packed slots."""
    codes = np.stack([(packed >> (2 * k)) & 3 for k in range(4)])
    return (codes != 3).sum(axis=(0, 1 + (1 - pair_axis)))


def phase_walk_tiles(device, reps=3):
    """Both walk kernels on walk_tile_cases in all three modes, each against
    its plain version on every output byte, the row-banded walk also against
    the native host walk.  Returns one result per walk, case and mode."""
    import torch
    from telr_tpu_torch.kernels import hopper_dp
    from telr_tpu_torch.kernels import hopper_wavefront as hw
    from telr_tpu_torch.kernels.dp import DPParams, EXTEND, GLOBAL, LOCAL
    params = DPParams()
    results = []
    for name, width, pairs, edit in walk_tile_cases():
        for mode in (GLOBAL, EXTEND, LOCAL):
            # the row-banded walk: its DP kernel on the band of each pair
            W = width or 1024
            arrays = rowband_batch(pairs, W)
            dts = (torch.int8, torch.int8, torch.int32, torch.int32,
                   torch.int32)
            q, t, off, qlen, tlen = (
                torch.from_numpy(a).to(device=device, dtype=dt)
                for a, dt in zip(arrays, dts))
            dp_out = list(hopper_dp.rowband_dp(
                q, t, off, qlen, tlen, width=W, mode=mode,
                params_tuple=params.tuple(), tb=True))
            qlen, tlen = edit_rowband_walk(edit, mode, dp_out, qlen, tlen)
            dirs_host = dp_out[0].cpu().numpy()
            r = check_rowband_walk(f"{name} W={W}", mode, dp_out, off, qlen,
                                   tlen, t.shape[1], dirs_host, device, reps)
            results.append({"kernel": "rowband_walk", "case": name,
                            "width": W, "mode": mode, "pairs": len(pairs),
                            **r})
            del dp_out, dirs_host
            # the wavefront walk: its DP kernel on the same pairs
            W = width or 512
            meta, init, scal = (torch.from_numpy(x).to(device) for x in
                                hw.prepare_wavefront_batch(pairs, W))
            n = len(pairs)
            g, b, bs, bp, dirs = hw.wavefront_dp(meta, init, scal, n, W,
                                                 mode, params, tb=True)
            scal, bs, bp = edit_wavefront_walk(edit, mode, dirs, meta, scal,
                                               bs, bp)
            r = check_wavefront_walk(f"{name} W={W}", mode, dirs, meta, scal,
                                     (g, b, bs, bp), device, reps,
                                     allow_bad=edit != "none")
            results.append({"kernel": "wavefront_walk", "case": name,
                            "width": W, "mode": mode, "pairs": n, **r})
            del dirs
    for kernel in ("rowband_walk", "wavefront_walk"):
        # the walks these cases are for
        if not any(r["walk_longest"] >= 300 for r in results
                   if r["kernel"] == kernel and r["case"] == "gaps"):
            raise AssertionError(f"{kernel}: no long gapped walk")
        if not any(r["walk_bad"] for r in results
                   if r["kernel"] == kernel and r["case"].startswith(
                       "escape")):
            raise AssertionError(f"{kernel}: no walk left the band")
    return results


def check_rowband(name, width, mode, arrays, device, reps=3):
    """One batch through both instances of the row-banded DP kernel and its
    plain version on `device`; raises on any difference.  Returns timings,
    errors and the kernel's bounds for this batch."""
    import torch
    from telr_tpu_torch.kernels import cuda_lib, hopper_dp
    from telr_tpu_torch.kernels.dp import DPParams
    ptuple = DPParams().tuple()
    dts = (torch.int8, torch.int8, torch.int32, torch.int32, torch.int32)
    q, t, off, qlen, tlen = (torch.from_numpy(a).to(device=device, dtype=dt)
                             for a, dt in zip(arrays, dts))
    kw = dict(width=width, mode=mode, params_tuple=ptuple)
    tb_ms, k_out = _timed(lambda: hopper_dp.rowband_dp(
        q, t, off, qlen, tlen, tb=True, **kw), reps, device)
    sc_ms, k_sc = _timed(lambda: hopper_dp.rowband_dp(
        q, t, off, qlen, tlen, tb=False, **kw), reps, device)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    p_out = hopper_dp._rowband_dp_plain(q, t, off, qlen, tlen, width, mode,
                                        ptuple, True)
    torch.cuda.synchronize(device)
    plain_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    p_sc = hopper_dp._rowband_dp_plain(q, t, off, qlen, tlen, width, mode,
                                       ptuple, False)
    torch.cuda.synchronize(device)
    plain_sc_ms = (time.perf_counter() - t0) * 1e3
    for what, a, b in zip(("gscore", "best", "besti", "bestp"),
                          k_out[1:], p_out[1:]):
        if not torch.equal(a, b):
            raise AssertionError(f"{name} mode {mode}: rowband_dp {what} "
                                 "differs from the plain version")
    B, Lq = q.shape
    # the kernel stops at each pair's qlen: later dirs rows are unwritten
    rows = (torch.arange(Lq, device=device)[None, :]
            < qlen[:, None])[:, :, None]
    err = _max_err([(k_out[0], p_out[0])], rows)
    if err:
        raise AssertionError(f"{name} mode {mode}: rowband_dp direction "
                             "bytes differ from the plain version")
    for a, b, c in zip(k_sc, k_out[1:3], p_sc):
        if not (torch.equal(a, b) and torch.equal(a, c)):
            raise AssertionError(f"{name} mode {mode}: the scores-only "
                                 "instance differs")
    # every cells-a-thread choice the wrapper can make, both instances,
    # against the one it made for this batch
    for cells_opt in cuda_lib.cell_options("rowband_dp", width):
        o = hopper_dp.rowband_dp(q, t, off, qlen, tlen, tb=True,
                                 cells=cells_opt, **kw)
        o2 = hopper_dp.rowband_dp(q, t, off, qlen, tlen, tb=False,
                                  cells=cells_opt, **kw)
        if not (all(torch.equal(a, b) for a, b in zip(o[1:], k_out[1:]))
                and all(torch.equal(a, b) for a, b in zip(o2, k_sc))
                and _max_err([(o[0], k_out[0])], rows) == 0):
            raise AssertionError(f"{name} mode {mode}: rowband_dp at "
                                 f"{cells_opt} cells a thread differs")
        del o, o2
    err = max(err, _max_err(list(zip(k_out[1:], p_out[1:]))
                            + list(zip(k_sc, p_sc))))
    # what the mesh runner copied for the host traceback before the walk
    # ran on the card
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    dirs_host = k_out[0].cpu().numpy()
    d2h_ms = (time.perf_counter() - t0) * 1e3
    walk = check_rowband_walk(name, mode, k_out, off, qlen, tlen,
                              t.shape[1], dirs_host, device, reps)
    # bounds: inputs read once, outputs written once (direction bytes of
    # the rows each pair has), operations per cell of those rows
    n_rows = int(torch.minimum(qlen, torch.tensor(Lq, device=device)).sum())
    cells = n_rows * width
    in_bytes = sum(x.numel() * x.element_size()
                   for x in (q, t, off, qlen, tlen))
    tb_bound = bounds(in_bytes + cells + 16 * B, ROWBAND_OPS[True] * cells)
    sc_bound = bounds(in_bytes + 8 * B, ROWBAND_OPS[False] * cells)
    return {"case": name, "width": width, "mode": mode, "pairs": B,
            "Lq": Lq, "Lt": t.shape[1], "cells": cells,
            "cells_a_thread": cuda_lib.pick_cells(
                width, B, cuda_lib.cell_options("rowband_dp", width)),
            "tb_ms": tb_ms, "tb_plain_ms": plain_ms,
            "tb_bound_ms": tb_bound[0], "tb_bound_by": tb_bound[1],
            "scores_ms": sc_ms, "scores_plain_ms": plain_sc_ms,
            "scores_bound_ms": sc_bound[0], "scores_bound_by": sc_bound[1],
            "dirs_to_host_ms": d2h_ms, "dirs_bytes": k_out[0].numel(),
            "err": err, **walk}


def check_rowband_walk(name, mode, dp_out, off, qlen, tlen, lt, dirs_host,
                       device, reps):
    """rowband_walk on one batch's direction bytes against its plain version
    (every output byte) and against the native host walk on the same bytes
    (ops, start and end cell, margin, bad); raises on any difference."""
    import torch
    from telr_tpu_torch.io import native
    from telr_tpu_torch.kernels import hopper_dp as hd
    from telr_tpu_torch.kernels.dp import GLOBAL
    args = (dp_out[0], off, qlen, tlen) + tuple(dp_out[1:])
    ms, (packed, small) = _timed(
        lambda: hd.rowband_walk(*args, lt=lt, mode=mode), reps, device)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    # the kernel leaves dirs rows past qlen unwritten and no walk reads them
    ppacked, psmall = hd._rowband_walk_plain(
        *args, hd.walk_steps(dp_out[0].shape[1], lt), mode)
    torch.cuda.synchronize(device)
    plain_ms = (time.perf_counter() - t0) * 1e3
    if not (torch.equal(packed, ppacked) and torch.equal(small, psmall)):
        raise AssertionError(f"{name} mode {mode}: rowband_walk differs from "
                             "the plain version")
    pk, sm = packed.cpu().numpy(), small.cpu().numpy()
    offsets, ops, lens = native.wave_decode_batch(
        pk.T, sm[hd.WALK_EI], sm[hd.WALK_EJ], sm[hd.WALK_BAD], False)
    off_h, ql_h, tl_h = (x.cpu().numpy() for x in (off, qlen, tlen))
    besti, bestp = (x.cpu().numpy() for x in dp_out[3:5])
    n_bad = 0
    for r in range(pk.shape[0]):
        if mode == GLOBAL:
            si, sj = int(ql_h[r]), int(tl_h[r])
        else:
            si = int(besti[r])
            sj = int(bestp[r]) + (int(off_h[r, si]) if si > 0 else 0)
        try:
            (hops, hlens), ei, ej, margin = native.traceback_arrays(
                dirs_host[r], off_h[r], si, sj, mode, int(tl_h[r]))
        except RuntimeError:
            if not sm[hd.WALK_BAD, r]:
                raise AssertionError(f"{name} mode {mode} pair {r}: the host "
                                     "walk fails, the device walk does not")
            n_bad += 1
            continue
        got = (ops[offsets[r]:offsets[r + 1]], lens[offsets[r]:offsets[r + 1]])
        same = (np.array_equal(got[0], hops) and np.array_equal(got[1], hlens)
                and tuple(sm[[hd.WALK_EI, hd.WALK_EJ, hd.WALK_BAD, hd.WALK_SI,
                              hd.WALK_SJ, hd.WALK_MARGIN], r])
                == (ei, ej, 0, si, sj, margin))
        if not same:
            raise AssertionError(f"{name} mode {mode} pair {r}: rowband_walk "
                                 "differs from the native host walk")
    # one direction byte and one offset read per op walked (the walks that
    # left the band included), the packed ops and the scalar stack written
    walked = _walked(pk, 0)
    steps = int(walked.sum())
    longest = int(walked.max()) if walked.size else 0
    out_bytes = packed.numel() + small.numel() * 4
    bound = bounds(5 * steps + out_bytes, WALK_OPS_PER_STEP * steps)
    return {"walk_ms": ms, "walk_plain_ms": plain_ms,
            "walk_bound_ms": bound[0], "walk_bound_by": bound[1],
            "walk_steps": steps, "walk_longest": longest,
            "walk_ns_per_step": ms * 1e6 / longest if longest else None,
            "walk_bad": n_bad,
            "walk_err": _max_err([(packed, ppacked), (small, psmall)]),
            "walk_bytes_to_host": out_bytes}


def phase_rowband_parity(device):
    from telr_tpu_torch.kernels.dp import EXTEND, GLOBAL, LOCAL
    return [check_rowband(name, width, mode, arrays, device)
            for name, width, arrays in rowband_cases()
            for mode in (GLOBAL, EXTEND, LOCAL)]


def phase_dist(device):
    """The single-process mesh modules on a one-card mesh.  Returns the
    row-banded launches the score steps made."""
    from telr_tpu_torch.dist.mesh import make_mesh
    mesh = make_mesh(1, device=device)
    if [str(d) for d in mesh.flat_devices()] != [str(device)]:
        raise AssertionError(f"the mesh is not on {device}: {mesh}")
    return dist_components(mesh)["score_launches"]


def dist_components(mesh):
    """The single-process mesh modules on `mesh`, each against its host
    reference: the score steps (against the plain DP), the sharded runner
    (its direction bytes against the native engine, and align_pairs through
    its device walks against the native engine's align_pairs), the depth
    reduction (against AlignmentStore.coverage) and the locus all-to-all
    (against the owner rule).  The inputs do not depend on the mesh.
    Returns every component's outputs, for holding one mesh's against
    another's, and the row-banded launches, in all and by card."""
    import torch
    from telr_tpu_torch.core.alignstore import AlignmentStore
    from telr_tpu_torch.dist import exec as dexec
    from telr_tpu_torch.dist import pipeline as dpipe
    from telr_tpu_torch.dist import redistribute as dred
    from telr_tpu_torch.dist.mesh import LOCI_AXIS, READS_AXIS
    from telr_tpu_torch.io import native
    from telr_tpu_torch.kernels import dp, hopper_dp
    n_reads, n_loci = mesh.shape[READS_AXIS], mesh.shape[LOCI_AXIS]
    # the plain version runs on the mesh's first card
    device = mesh.flat_devices()[0]
    ptuple = dp.DPParams().tuple()
    rng = np.random.default_rng(5)
    W = 128
    outs = {}

    def plain(q, t, off, qlen, tlen, mode, tb):
        dts = (torch.int8, torch.int8, torch.int32, torch.int32, torch.int32)
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(device=device,
                                                             dtype=dt)
                for a, dt in zip((q, t, off, qlen, tlen), dts)]
        return [x.cpu().numpy() for x in hopper_dp._rowband_dp_plain(
            *args, W, mode, ptuple, tb)]

    hopper_dp.rowband_dp.launches = 0
    hopper_dp.rowband_dp.cards.clear()
    hopper_dp.rowband_walk.cards.clear()
    # stage-1 score step: reads against one replicated reference window
    B, LQ, LT = 64, 1024, 1280
    t = rng.integers(0, 4, LT).astype(np.int8)
    q = np.stack([_related(rng, LQ, LT, 100)[0] for _ in range(B)])
    q[:, :900] = np.where(rng.random((B, 900)) < 0.9, t[None, 60:960],
                          q[:, :900])
    off = np.broadcast_to(dp.make_band_offsets(LQ, LT, W), (B, LQ + 1)).copy()
    qlen = rng.integers(500, LQ + 1, B).astype(np.int32)
    tb_ = np.repeat(t[None], B, axis=0)
    tl_ = np.full(B, LT, np.int32)
    for mode in (dp.GLOBAL, dp.EXTEND, dp.LOCAL):
        got = dpipe.make_sharded_align_step(mesh, W, mode, ptuple)(
            q, t, off, qlen, np.asarray(LT, np.int32))
        want = plain(q, tb_, off, qlen, tl_, mode, False)
        if not all(np.array_equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"sharded align step differs, mode {mode}")
        outs[f"align_step_{mode}"] = got
    # per-locus score step
    L, R = 8, 8
    contigs = rng.integers(0, 4, (L, LT)).astype(np.int8)
    reads = rng.integers(0, 4, (L, R, LQ)).astype(np.int8)
    reads[:, :, :800] = contigs[:, None, 100:900]
    off3 = np.broadcast_to(off[0], (L, R, LQ + 1)).copy()
    qlen3 = rng.integers(500, LQ + 1, (L, R)).astype(np.int32)
    tlen3 = rng.integers(1000, LT + 1, L).astype(np.int32)
    got = dpipe.make_locus_score_step(mesh, W, ptuple)(
        reads, contigs, off3, qlen3, tlen3)
    want = plain(reads.reshape(L * R, LQ), np.repeat(contigs, R, axis=0),
                 off3.reshape(L * R, LQ + 1), qlen3.reshape(-1),
                 np.repeat(tlen3, R), dp.EXTEND, False)
    if not all(np.array_equal(g.reshape(-1), w) for g, w in zip(got, want)):
        raise AssertionError("locus score step differs")
    outs["locus_step"] = got
    score_launches = hopper_dp.rowband_dp.launches
    # the sharded runner (numpy in, numpy out) against the native engine
    got = dexec.sharded_dp_runner(mesh)(q, tb_, off, qlen, tl_, width=W,
                                        mode=dp.EXTEND, params_tuple=ptuple)
    want = native.banded_dp_batch(q, tb_, off, qlen, tl_, width=W,
                                  mode=dp.EXTEND, params_tuple=ptuple)
    for g, w in zip(got[1:], want[1:]):
        if not np.array_equal(g, w):
            raise AssertionError("sharded runner scores differ from the "
                                 "native engine")
    for b in range(B):
        if not np.array_equal(got[0][b, :qlen[b]], want[0][b, :qlen[b]]):
            raise AssertionError("sharded runner direction bytes differ "
                                 "from the native engine")
    outs["runner"] = [got[0][b, :qlen[b]] for b in range(B)] + list(got[1:])
    launches = hopper_dp.rowband_dp.launches
    if score_launches != 3 * n_reads + n_loci \
            or launches != score_launches + n_reads:
        raise AssertionError(f"expected {3 * n_reads + n_loci} + {n_reads} "
                             f"launches, saw {score_launches} + "
                             f"{launches - score_launches}")
    # align_pairs through the runner's device walks against the native
    # engine's align_pairs: the result dicts, both cigar forms
    par = dp.DPParams()
    ap_items = []
    for k in range(48):
        lq = int(rng.integers(200, 1500))
        qq, tt = _related(rng, lq, lq + int(rng.integers(0, 300)), lq // 8,
                          indel=int(rng.integers(0, 40)))
        ap_items.append((qq, tt, k % 3, par, None, None))
    qq, tt = _related(rng, 2600, 3300, 260, indel=400)
    anchors = np.arange(256, 800, 256)
    ap_items.append((qq, tt, dp.GLOBAL, par, 1024, dp.offsets_from_path(
        len(qq), len(tt), 1024, anchors, anchors)))
    ap_items.append((qq[:4], np.zeros(0, np.int8), dp.GLOBAL, par, None, None))
    runner = dexec.sharded_dp_runner(mesh)
    hopper_dp.rowband_walk.launches = 0
    for arrays in (False, True):
        want = dp.align_pairs(ap_items, cigar_arrays=arrays)
        got = dp.align_pairs(ap_items, runner=runner, cigar_arrays=arrays)
        for k, (w, g) in enumerate(zip(want, got)):
            same = set(w) == set(g) and all(
                (all(np.array_equal(a, b) for a, b in zip(w[key], g[key]))
                 if key == "cigar" and arrays else w[key] == g[key])
                for key in w)
            if not same:
                raise AssertionError(f"align_pairs item {k} (cigar_arrays="
                                     f"{arrays}) differs between the walk "
                                     "runner and the native engine")
        outs[f"align_pairs_{arrays}"] = got
    walk_launches = hopper_dp.rowband_walk.launches
    if walk_launches == 0 or \
            hopper_dp.rowband_dp.launches != launches + walk_launches:
        raise AssertionError("the walk runner did not launch a walk per DP")
    # depth reduction against AlignmentStore.coverage
    from telr_tpu_torch.config import MAP_PB
    from telr_tpu_torch.io.seqs import Sequence, SeqDict
    from telr_tpu_torch.kernels.mapper import Aligner
    G = 20000
    ref = rng.integers(0, 4, G).astype(np.int8)
    aligner = Aligner(SeqDict([Sequence("c", ref)]), MAP_PB)
    alns = []
    for i in range(60):
        s0 = int(rng.integers(0, G - 2100))
        codes = ref[s0:s0 + 2000].copy()
        codes = np.concatenate([codes[:1000],
                                rng.integers(0, 4, 20).astype(np.int8),
                                codes[1010:]])
        alns.extend(aligner.map_seq(f"r{i}", codes))
    store = AlignmentStore(alns)
    dexec.mesh_coverage.device_calls.clear()
    cov = dexec.mesh_coverage(mesh, store, "c", G)
    if not np.array_equal(cov, store.coverage("c", 0, G)) or cov.max() < 2:
        raise AssertionError("mesh_coverage differs from the alignment "
                             "store's coverage")
    if dexec.mesh_coverage.device_calls != {"cuda": 1}:
        raise AssertionError("the depth reduction did not run on the card: "
                             f"{dexec.mesh_coverage.device_calls}")
    outs["depth"] = cov
    # locus all-to-all: item k starts on shard k % n, each shard receives
    # exactly its loci's items
    all_items = [(int(rng.integers(0, 50)), k, k % 2,
                  rng.integers(0, 4, int(rng.integers(500, 20000))).astype(
                      np.int8)) for k in range(200)]
    items = [all_items[s::n_reads] for s in range(n_reads)]
    got = dred.redistribute_payloads(mesh, items, max_bytes=1 << 22)
    for dst in range(n_reads):
        want = sorted((it for it in all_items
                       if dred.owner_of(it[0], n_reads) == dst),
                      key=lambda x: (x[0], x[2], x[1]))
        if len(got[dst]) != len(want) or not all(
                g[:3] == w[:3] and np.array_equal(g[3], w[3])
                for g, w in zip(got[dst], want)):
            raise AssertionError(f"redistribute_payloads differs on shard "
                                 f"{dst} of {n_reads}")
    outs["all_to_all"] = sorted((it for lst in got for it in lst),
                                key=lambda x: (x[0], x[2], x[1]))
    by_card = {"rowband_dp": dict(hopper_dp.rowband_dp.cards),
               "rowband_walk": dict(hopper_dp.rowband_walk.cards)}
    print(f"dist: score steps, runner, depth ({len(alns)} alignments, peak "
          f"depth {int(cov.max())}) and all-to-all ({len(all_items)} "
          f"payloads) agree on {mesh}; row-banded launches {launches}, then "
          f"{walk_launches} DP + walk launches for {len(ap_items)} align_pairs "
          "items in both cigar forms"
          + (f"; launches by card {json.dumps(by_card)}"
             if mesh.size > 1 else ""), flush=True)
    return {"outputs": outs, "score_launches": score_launches,
            "by_card": by_card}


def same_outputs(a, b):
    """The names of the dist_components outputs that differ between two
    runs, compared bit for bit (arrays, numbers, dicts of them, lists)."""
    def eq(x, y):
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            return np.array_equal(x, y) and np.asarray(x).dtype == \
                np.asarray(y).dtype
        if isinstance(x, dict):
            return isinstance(y, dict) and set(x) == set(y) and all(
                eq(x[k], y[k]) for k in x)
        if isinstance(x, (list, tuple)):
            return isinstance(y, (list, tuple)) and len(x) == len(y) and all(
                eq(u, v) for u, v in zip(x, y))
        return x == y
    return [k for k in a if not eq(a[k], b[k])]


def cli_argv(inputs, out, threads, coverage, extra=(), cli_device="cuda"):
    reads, ref, lib = inputs
    return ["-i", reads, "-r", ref, "-l", lib, "-o", out, "-t", str(threads),
            "--device", cli_device,
            # tools/genome_eval.py's setting: max(3, coverage // 8)
            "--min_support", str(max(3, coverage // 8))] + list(extra)


def run_cli(device, inputs, out, threads, coverage, extra=(),
            cli_device="cuda", mesh_devices=1):
    """One run of the port's CLI (--device cli_device) with every launch
    count set to 0 just before it.  Returns the result, the kernels' launch
    counts (and, under "shapes", launches by shape and the bytes the mesh
    runner copied back from the card), the vote and depth-reduction device
    counts, wall seconds and peak device bytes.  `shapes` also holds
    "by_card", each kernel's launches and the vote's calls by card, and
    "peak_by_card", the peak device bytes of cards 0 .. mesh_devices - 1
    (the cards of a --mesh_devices run)."""
    import torch
    from telr_tpu_torch import cli
    from telr_tpu_torch.assembly.device_vote import vote_many
    from telr_tpu_torch.dist.exec import mesh_coverage, sharded_dp_runner
    from telr_tpu_torch.dist.mesh import make_mesh
    from telr_tpu_torch.kernels import hopper_dp
    from telr_tpu_torch.kernels import hopper_wavefront as hw
    from telr_tpu_torch.tools.bench_pipeline import (kernel_launches_by_card,
                                                     reset_launches)
    from telr_tpu_torch.utils import hoststats
    argv = cli_argv(inputs, out, threads, coverage, extra, cli_device)
    # the runner of the mesh the CLI builds (one runner per equal mesh)
    runner = sharded_dp_runner(make_mesh(mesh_devices, device="cuda"))
    # run_pipeline's logging.basicConfig opens this run's TELR.log only when
    # the root logger has no handler left from an earlier run
    for h in logging.root.handlers[:]:
        logging.root.removeHandler(h)
        h.close()
    # ... and its alignment breakdown reads the spans since the last reset
    hoststats.reset()
    reset_launches()
    hw.wavefront_dp.shapes.clear()
    hopper_dp.rowband_dp.shapes.clear()
    runner.bytes_to_host = 0
    vote_many.device_calls.clear()
    vote_many.card_calls.clear()
    mesh_coverage.device_calls.clear()
    cards = range(mesh_devices)
    for k in cards:
        torch.cuda.reset_peak_memory_stats(k)
    t0 = time.perf_counter()
    res = cli.main(argv)
    for k in cards:
        torch.cuda.synchronize(k)
    wall = time.perf_counter() - t0
    launches = {"wavefront_dp": hw.wavefront_dp.launches,
                "wavefront_walk": hw.wavefront_walk.launches,
                "rowband_dp": hopper_dp.rowband_dp.launches,
                "rowband_walk": hopper_dp.rowband_walk.launches,
                "runner_bytes_to_host": runner.bytes_to_host}
    shapes = {"wavefront_dp": dict(hw.wavefront_dp.shapes),
              "rowband_dp": dict(hopper_dp.rowband_dp.shapes),
              "by_card": kernel_launches_by_card(),
              "peak_by_card": [torch.cuda.max_memory_allocated(k)
                               for k in cards]}
    shapes["by_card"]["vote"] = dict(vote_many.card_calls)
    return (res, launches, shapes, dict(vote_many.device_calls),
            dict(mesh_coverage.device_calls), wall,
            torch.cuda.max_memory_allocated(device))


def shape_lines(shapes, fields):
    """Launches by shape, pairs per launch summed up: one line per shape
    without its pair count, most launches first."""
    groups = {}
    for key, count in shapes.items():
        groups.setdefault(key[:-1], []).extend([key[-1]] * count)
    lines = []
    for key, pairs in sorted(groups.items(), key=lambda kv: -len(kv[1])):
        pairs.sort()
        what = ", ".join(f"{f} {v}" for f, v in zip(fields, key))
        n = len(pairs)
        lines.append(f"{what}: {n} launches, pairs a launch min {pairs[0]} "
                     f"quartiles {pairs[n // 4]} {pairs[n // 2]} "
                     f"{pairs[3 * n // 4]} max {pairs[-1]} sum {sum(pairs)}")
    return lines


def phase_pipeline(device, size, coverage, n_ins, seed, threads, mesh=False,
                   work=None):
    """The CLI on the simulated genome: default auto routing, or with
    mesh=True the mesh path (--mesh_devices 1 --wavefront off).  Given
    `work`, a directory that outlives the phase, the run goes there with
    --checkpoint_dir work/ckpt, and the entry-points phase reuses its
    inputs, files and checkpoints.  Returns the launches and that run's
    record."""
    tag = "pipeline-mesh" if mesh else "pipeline"
    extra = ["--mesh_devices", "1", "--wavefront", "off"] if mesh else []
    with contextlib.ExitStack() as stack:
        if work is None:
            work = stack.enter_context(
                tempfile.TemporaryDirectory(prefix="telr_smoke_"))
        else:
            extra += ["--checkpoint_dir", os.path.join(work, "ckpt")]
        t0 = time.perf_counter()
        inputs, truth, n_reads, n_bases, score_calls = simulate(
            work, size, coverage, n_ins, seed)
        print(f"{tag}: simulated {size / 1e6:g} Mb at {coverage}x, "
              f"{len(truth)} insertions, {n_reads} reads "
              f"({n_bases / 1e6:.1f} Mb) in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        out = os.path.join(work, "out")
        with stage_record() as rec:
            res, launches, shapes, votes, depth, wall, peak = run_cli(
                device, inputs, out, threads, coverage, extra)
        missing = [x for x in OUTPUTS
                   if not os.path.isfile(os.path.join(out, "reads.telr."
                                                      + x))]
        score = score_calls(res.final_report, truth)
        with open(os.path.join(out, "TELR.log")) as f:
            breakdown = [ln.split(": ", 2)[-1].strip() for ln in f
                         if "alignment breakdown" in ln]
    print(f"{tag}: stage seconds " + json.dumps(
        {k: round(v, 2) for k, v in res.stage_seconds.items()}))
    print(f"{tag}: wall {wall:.1f} s, "
          f"{n_reads / res.stage_seconds['alignment']:.1f} "
          f"reads/s in alignment, peak device memory "
          f"{peak / 2**30:.2f} GiB, launches {json.dumps(launches)}, "
          f"vote calls {json.dumps(votes)}, depth reductions "
          f"{json.dumps(depth)}")
    print(f"{tag}: launches by stage (wavefront_dp / wavefront_walk): "
          + launch_line(rec))
    for ln in breakdown:
        print(f"{tag}: " + ln)
    for ln in shape_lines(shapes["wavefront_dp"], ("W", "mode", "S_pad")):
        print(f"{tag}: wavefront_dp " + ln)
    for ln in shape_lines(shapes["rowband_dp"],
                          ("W", "Lq", "Lt", "mode", "tb")):
        print(f"{tag}: rowband_dp " + ln)
    if mesh:
        print(f"{tag}: stage 1 copied {launches['runner_bytes_to_host']} "
              f"bytes from the card to the host in {launches['rowband_dp']} "
              "launches (the packed walks and their scalars)")
        # a pair's packed walk has one slot per step of its padded matrix
        # and eight int32 scalars, however short the walk
        from telr_tpu_torch.kernels.hopper_dp import walk_steps
        by_size = {}
        for (_w, lq, lt, _mode, tb, pairs), count in \
                shapes["rowband_dp"].items():
            if tb:
                by_size[(lq, lt)] = by_size.get((lq, lt), 0) + count * pairs \
                    * (walk_steps(lq, lt) // 4 + 32)
        print(f"{tag}: of these, by padded (Lq, Lt): " + ", ".join(
            f"{k}: {v}" for k, v in sorted(by_size.items(),
                                           key=lambda kv: -kv[1])))
    print(f"{tag}: {len(res.final_report)} calls, precision "
          f"{score['precision']} recall {score['recall']} F1 {score['f1']} "
          f"(tp {score['tp']} fp {score['fp']} fn {score['fn']})",
          flush=True)
    on_path = (("rowband_dp", "rowband_walk") if mesh
               else ("wavefront_dp", "wavefront_walk"))
    for k in on_path:
        if launches[k] == 0:
            raise AssertionError(f"the {tag} run never launched {k}")
    if mesh:
        if "locus_redistribute" not in res.stage_seconds:
            raise AssertionError("the mesh run has no locus_redistribute "
                                 "stage")
        if depth.get("cuda", 0) == 0 or set(depth) != {"cuda"}:
            raise AssertionError("the depth reduction did not run on the "
                                 f"card: {depth}")
    if votes.get("cuda", 0) == 0:
        raise AssertionError(f"the vote did not run on the card: {votes}")
    if missing:
        raise AssertionError(f"missing outputs: {missing}")
    if score["f1"] < 0.8:
        raise AssertionError(f"F1 {score['f1']} < 0.8")
    return launches, {"work": work, "inputs": inputs, "out": out,
                      "ckpt": os.path.join(work, "ckpt"), "truth": truth,
                      "score_calls": score_calls, "wall": wall,
                      "n_reads": n_reads}


def launch_line(rec):
    """A stage_record's wavefront launches, one `stage dp / walk` a stage
    that launched."""
    return ", ".join(f"{st} {r['launches']['wavefront_dp']} / "
                     f"{r['launches']['wavefront_walk']}"
                     for st, r in rec.items()
                     if r["launches"]["wavefront_dp"]
                     or r["launches"]["wavefront_walk"]) or "none"


def same_files(a, b, files=RUN_FILES):
    """The files of `files` that differ between directories a and b."""
    differ = []
    for f in files:
        with open(os.path.join(a, f), "rb") as x, \
                open(os.path.join(b, f), "rb") as y:
            if x.read() != y.read():
                differ.append(f)
    return differ


def _store_rows(store):
    return [(a.qname, a.qlen, a.qstart, a.qend, a.strand, a.tname, a.tlen,
             a.tstart, a.tend, a.matches, a.blocklen, a.mapq, a.score,
             tuple(a.cigar), a.primary) for a in store.all()]


def sam_check(ckpt_dir, reads_fa, ref_fa, bam, sam):
    """The entry-points phase's SAM half, in a process of its own beside the
    BAM run: the checkpointed stage-1 store written as SAM with write_sam,
    the SAM and the BAM read back.  Prints one JSON line: each step's
    seconds, the files' sizes, the counts, and `faults`, the ways the SAM's
    store or reads differ from the BAM's, the BAM holds fewer alignments
    than the store, or a read rebuilt from the BAM differs from its FASTA
    read."""
    from telr_tpu_torch.io.fasta import read_fasta
    from telr_tpu_torch.io.samio import read_bam, read_sam, write_sam
    from telr_tpu_torch.utils.checkpoint import Checkpointer
    rec, faults = {}, []

    def timed(key, fn, *a, **k):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        rec[key] = time.perf_counter() - t0
        return out
    store = Checkpointer(ckpt_dir, lock=False).load_alignments("alignment")
    reads = read_fasta(reads_fa)
    timed("write_sam_s", write_sam, store, reads, sam,
          tlens=read_fasta(ref_fa).sizes())
    sam_store, sam_reads = timed("read_sam_s", read_sam, sam)
    bam_store, bam_reads = timed("read_bam_s", read_bam, bam)
    if len(bam_store) != len(store):
        faults.append(f"the BAM holds {len(bam_store)} of {len(store)} "
                      "alignments")
    if _store_rows(sam_store) != _store_rows(bam_store):
        faults.append("the SAM and the BAM give different stores")
    if sam_reads.names() != bam_reads.names() or any(
            not np.array_equal(x.codes, y.codes)
            for x, y in zip(sam_reads, bam_reads)):
        faults.append("the SAM and the BAM give different reads")
    faults += [f"read {r.name} rebuilt from the BAM differs from the FASTA "
               "read" for r in bam_reads
               if not np.array_equal(r.codes, reads[r.name].codes)][:5]
    rec.update(sam_bytes=os.path.getsize(sam), alignments=len(bam_store),
               reads=len(bam_reads), fasta_reads=len(reads), faults=faults)
    print(json.dumps(rec), flush=True)


def phase_entry_points(device, run, threads, coverage, timeout_s=600):
    """The pipeline phase's run entered another way, on its genome and with
    its checkpoints: stage 1's alignments (as the run checkpointed them)
    written as a BAM with write_bam, the CLI on that BAM (--device cuda,
    auto routing: the alignment stage is skipped) while sam_check writes
    the same store as SAM and reads both files back in a process of its
    own, then the FASTA run again on its checkpoint directory.  Fails
    unless the BAM run writes the FASTA run's nine files, launches both
    wavefront kernels in assembly, runs the vote on the card and reaches
    F1 >= 0.8; unless the SAM gives the BAM's store and reads, and each of
    those reads is the FASTA read of its name; and unless the resumed run
    writes the first run's nine files with alignment, te_filter, assembly
    and ref_repeatmask restored (its loci_eval.tsv less the first run's
    te_filter and assembly lines: a restored stage logs no drops, in the
    JAX package too).  Returns the BAM run's launches and its launches by
    stage."""
    from telr_tpu_torch import pipeline
    from telr_tpu_torch.io.fasta import read_fasta
    from telr_tpu_torch.io.samio import write_bam
    from telr_tpu_torch.utils.checkpoint import Checkpointer
    reads_fa, ref_fa, lib_fa = run["inputs"]
    work = os.path.join(run["work"], "entry")
    os.makedirs(work)
    t0 = time.perf_counter()
    store = Checkpointer(run["ckpt"], lock=False).load_alignments("alignment")
    reads = read_fasta(reads_fa)
    t_load = time.perf_counter() - t0
    # named as the FASTA reads, so the run's sample and file names match
    bam, sam = os.path.join(work, "reads.bam"), os.path.join(work,
                                                            "reads.sam")
    t0 = time.perf_counter()
    write_bam(store, reads, bam, tlens=read_fasta(ref_fa).sizes())
    t_write = time.perf_counter() - t0
    print(f"entry-points: {len(store)} alignments of {len(reads)} reads from "
          f"the checkpoint and the FASTA reads in {t_load:.2f} s; BAM "
          f"{os.path.getsize(bam)} bytes, write_bam {t_write:.2f} s",
          flush=True)
    del store, reads
    check = subprocess.Popen(
        [sys.executable, "-c",
         "import sys, chip_smoke; chip_smoke.sam_check(*sys.argv[1:])",
         run["ckpt"], reads_fa, ref_fa, bam, sam],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, text=True)
    try:
        out = os.path.join(work, "bam_out")
        with stage_record() as rec:
            res, launches, _s, votes, _d, wall, peak = run_cli(
                device, [bam, ref_fa, lib_fa], out, threads, coverage)
        sam_out, _err = check.communicate(timeout=timeout_s)
    finally:
        if check.poll() is None:
            check.kill()
            check.wait()
    if check.returncode:
        raise AssertionError(f"the SAM check exited {check.returncode}")
    sc = json.loads(sam_out.strip().splitlines()[-1])
    print(f"entry-points: beside the BAM run: read_bam "
          f"{sc['read_bam_s']:.2f} s ({sc['alignments']} alignments, "
          f"{sc['reads']} of the {sc['fasta_reads']} reads); SAM "
          f"{sc['sam_bytes']} bytes, write_sam {sc['write_sam_s']:.2f} s, "
          f"read_sam {sc['read_sam_s']:.2f} s; faults {sc['faults']}",
          flush=True)
    score = run["score_calls"](res.final_report, run["truth"])
    print("entry-points: BAM run stage seconds " + json.dumps(
        {k: round(v, 2) for k, v in res.stage_seconds.items()}))
    print(f"entry-points: BAM run wall {wall:.1f} s (the FASTA run "
          f"{run['wall']:.1f} s), peak device memory {peak / 2**30:.2f} GiB, "
          f"launches {json.dumps(launches)}, vote calls {json.dumps(votes)}",
          flush=True)
    print("entry-points: BAM run launches by stage (wavefront_dp / "
          "wavefront_walk): " + launch_line(rec), flush=True)
    print(f"entry-points: BAM run {len(res.final_report)} calls, precision "
          f"{score['precision']} recall {score['recall']} F1 {score['f1']} "
          f"(tp {score['tp']} fp {score['fp']} fn {score['fn']})",
          flush=True)
    differ = same_files(out, run["out"])
    print(f"entry-points: BAM run against the FASTA run: "
          f"{len(RUN_FILES) - len(differ)} of {len(RUN_FILES)} files "
          "byte-identical", flush=True)

    # the FASTA run again on its checkpoints; ref_repeatmask's restore is
    # not among restored_stages (the JAX package's pipeline leaves it out
    # too), so a spy counts the sweeps
    sweeps = []
    real_sweep = pipeline.repeatmask_reference

    def sweep(*a, **k):
        sweeps.append(1)
        return real_sweep(*a, **k)
    pipeline.repeatmask_reference = sweep
    try:
        out2 = os.path.join(work, "resume_out")
        res2, launches2, _s, _v, _d, wall2, _p = run_cli(
            device, run["inputs"], out2, threads, coverage,
            ["--checkpoint_dir", run["ckpt"]])
    finally:
        pipeline.repeatmask_reference = real_sweep
    restored = res2.restored_stages + ([] if sweeps else ["ref_repeatmask"])
    # a restored stage does not run, so the loci it dropped are not logged
    # again: the resumed ledger is the first run's less its te_filter and
    # assembly lines, in the JAX package as in the port
    # (tests/test_torch_resume.py holds both to that)
    resumed_differ = same_files(out2, run["out"],
                                [f for f in RUN_FILES if f != LEDGER])
    with open(os.path.join(run["out"], LEDGER)) as f:
        first_ledger = f.read().splitlines()
    with open(os.path.join(out2, LEDGER)) as f:
        resumed_ledger = f.read().splitlines()
    kept = [ln for ln in first_ledger
            if ln.split("\t", 1)[1] not in RESTORED_REASONS]
    print(f"entry-points: resumed run wall {wall2:.1f} s, restored "
          f"{', '.join(restored)}, stage seconds " + json.dumps(
              {k: round(v, 2) for k, v in res2.stage_seconds.items()})
          + f", launches {json.dumps(launches2)}; "
          f"{len(RUN_FILES) - 1 - len(resumed_differ)} of "
          f"{len(RUN_FILES) - 1} files byte-identical to the first run's; "
          f"{LEDGER} {len(resumed_ledger)} lines against the first run's "
          f"{len(first_ledger)}, of which {len(first_ledger) - len(kept)} "
          "te_filter / assembly lines", flush=True)

    if sc["faults"]:
        raise AssertionError("; ".join(sc["faults"]))
    if differ:
        raise AssertionError(f"the BAM run and the FASTA run differ in "
                             f"{differ}")
    for k in ("wavefront_dp", "wavefront_walk"):
        if rec.get("assembly", {}).get("launches", {}).get(k, 0) == 0:
            raise AssertionError(f"the BAM run never launched {k} in "
                                 "assembly")
    if votes.get("cuda", 0) == 0:
        raise AssertionError(f"the BAM run's vote did not run on the card: "
                             f"{votes}")
    if score["f1"] < 0.8:
        raise AssertionError(f"BAM run F1 {score['f1']} < 0.8")
    if restored != ["alignment", "te_filter", "assembly", "ref_repeatmask"]:
        raise AssertionError(f"the resumed run restored {restored}")
    if resumed_differ:
        raise AssertionError(f"the resumed run's files differ in "
                             f"{resumed_differ}")
    if resumed_ledger != kept:
        raise AssertionError(f"the resumed run's {LEDGER} is not the first "
                             "run's less its te_filter and assembly lines")
    return launches, {st: r["launches"] for st, r in rec.items()}


def phase_mesh_identity(device, coverage, n_ins, seed, threads,
                        size=300_000):
    """At 300 kb: the mesh run's output files byte for byte against a
    --wavefront off run without a mesh (the native host engine), which the
    row-banded kernel's bit-exactness promises."""
    with tempfile.TemporaryDirectory(prefix="telr_smoke_") as work:
        inputs, _truth, n_reads, _n_bases, _score = simulate(
            work, size, coverage, n_ins, seed)
        outs = {}
        for name, extra in (("mesh", ["--mesh_devices", "1",
                                      "--wavefront", "off"]),
                            ("host", ["--wavefront", "off"])):
            outs[name] = os.path.join(work, name)
            _res, launches, _shapes, _v, _d, wall, _peak = run_cli(
                device, inputs, outs[name], threads, coverage, extra)
            print(f"mesh-identity: {name} run of {size / 1e6:g} Mb, "
                  f"{n_reads} reads: {wall:.1f} s, launches "
                  f"{json.dumps(launches)}", flush=True)
            if (launches["rowband_dp"] > 0) != (name == "mesh"):
                raise AssertionError(f"{name} run: unexpected row-banded "
                                     f"launches {launches}")
        for f in RUN_FILES:
            with open(os.path.join(outs["mesh"], f), "rb") as a, \
                    open(os.path.join(outs["host"], f), "rb") as b:
                if a.read() != b.read():
                    raise AssertionError(f"{f} differs between the mesh run "
                                         "and the meshless run")
    print(f"mesh-identity: {len(RUN_FILES)} output files byte-identical",
          flush=True)


def phase_multiprocess(size, coverage, n_ins, seed, threads, procs=2):
    """run_pipeline_multiprocess through telr_tpu_torch's multi-process tool
    on the pipeline phases' genome: one process, then `procs` processes that
    share the card (rank r takes card r % cards), `threads` host threads
    each, collectives over gloo.  Each rank is a fresh process, so its launch
    counts start at 0 with its run.  Fails unless the two runs' files are
    byte-identical, every rank launched both wavefront kernels and ran the
    vote on the card, and F1 >= 0.8.  Returns each rank's launches."""
    from telr_tpu_torch.tools import two_process_pipeline as tpp
    with tempfile.TemporaryDirectory(prefix="telr_smoke_") as work:
        inputs, truth, n_reads, n_bases, score_calls = simulate(
            work, size, coverage, n_ins, seed)
        res = tpp.run(inputs, work, procs=procs, threads=threads,
                      device="cuda", timeout_s=900)
        with open(os.path.join(res["one_process"]["out_dir"],
                               "reads.telr.json")) as f:
            score = score_calls(json.load(f), truth)
    runs = (("1 process", res["one_process"]),
            (f"{procs} processes", res["multi_process"]))
    for label, run in runs:
        for r in run["ranks"]:
            print(f"multiprocess: {label}, rank {r['rank']} on {r['device']} "
                  f"({r['device_name']}): wall {r['wall_s']:.1f} s, stage "
                  "seconds " + json.dumps({k: round(v, 2) for k, v in
                                           r["stage_seconds"].items()}))
            print(f"multiprocess: {label}, rank {r['rank']}: launches "
                  f"{json.dumps(r['launches'])}, vote calls "
                  f"{json.dumps(r['vote_calls'])}, peak device memory "
                  f"{r['peak_device_bytes'] / 2**30:.2f} GiB", flush=True)
    t1, t2 = res["one_process"]["wall_s"], res["multi_process"]["wall_s"]
    print(f"multiprocess: {n_reads} reads ({n_bases / 1e6:.1f} Mb), "
          f"{threads} threads a process: wall 1 process {t1:.1f} s, "
          f"{procs} processes {t2:.1f} s, T1 / ({procs} T2) "
          f"{res['scaling_efficiency']:.3f}; {len(res['output_files'])} "
          f"files, byte-identical: {res['bit_identical']}", flush=True)
    print(f"multiprocess: calls (both runs): precision {score['precision']} "
          f"recall {score['recall']} F1 {score['f1']} (tp {score['tp']} fp "
          f"{score['fp']} fn {score['fn']})", flush=True)
    if res["mismatches"]:
        raise AssertionError(f"1 and {procs} processes differ: "
                             f"{res['mismatches']}")
    missing = set(MP_FILES) - set(res["output_files"])
    if missing:
        raise AssertionError(f"missing outputs: {sorted(missing)}")
    for label, run in runs:
        for r in run["ranks"]:
            for k in ("wavefront_dp", "wavefront_walk"):
                if r["launches"][k] == 0:
                    raise AssertionError(f"{label}: rank {r['rank']} never "
                                         f"launched {k}")
            if r["vote_calls"].get("cuda", 0) == 0:
                raise AssertionError(f"{label}: rank {r['rank']} did not run "
                                     f"the vote on the card: "
                                     f"{r['vote_calls']}")
    if score["f1"] < 0.8:
        raise AssertionError(f"F1 {score['f1']} < 0.8")
    return [r["launches"] for r in res["multi_process"]["ranks"]]


def runner_overlap(cards, seed=11, per_card=512, reps=3):
    """One batch of the mesh runner's DP and walk (per_card pairs of 2 kb x
    2.5 kb a card, W = 512, GLOBAL) on a one-card mesh and on a mesh of
    `cards` cards: the packed walks and scalars bit for bit, each mesh's
    median wall over `reps` calls, then one more call of each under
    torch.profiler for every card's busy window (the windows overlap unless
    the runner serialises the cards).  Returns the record it prints."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from telr_tpu_torch.dist import exec as dexec
    from telr_tpu_torch.dist.mesh import make_mesh
    from telr_tpu_torch.kernels import dp
    from telr_tpu_torch.tools.profile_report import card_windows, load_trace
    rng = np.random.default_rng(seed)
    B, LQ, LT, W = per_card * cards, 2048, 2560, 512
    pairs = [_related(rng, LQ, LT, 200) for _ in range(B)]
    q = np.stack([p[0] for p in pairs])
    t = np.stack([p[1] for p in pairs])
    off = np.broadcast_to(dp.make_band_offsets(LQ, LT, W), (B, LQ + 1)).copy()
    qlen = np.full(B, LQ, np.int32)
    tlen = np.full(B, LT, np.int32)
    kw = dict(width=W, mode=dp.GLOBAL, params_tuple=dp.DPParams().tuple())
    got, walls, rows = {}, {}, {}
    with tempfile.TemporaryDirectory(prefix="telr_smoke_") as work:
        for n in (1, cards):
            runner = dexec.sharded_dp_runner(make_mesh(n, device="cuda"))
            got[n] = runner.walks(q, t, off, qlen, tlen, **kw)()  # warm-up
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                runner.walks(q, t, off, qlen, tlen, **kw)()
                times.append(time.perf_counter() - t0)
            walls[n] = sorted(times)[reps // 2]
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                runner.walks(q, t, off, qlen, tlen, **kw)()
            path = os.path.join(work, f"trace{n}.json")
            prof.export_chrome_trace(path)
            windows = card_windows(load_trace(path))
            if windows:
                t_min = min(w["start_us"] for w in windows.values())
                rows[n] = {k: {"start_ms": (w["start_us"] - t_min) / 1e3,
                               "end_ms": (w["end_us"] - t_min) / 1e3,
                               "busy_ms": w["busy_s"] * 1e3,
                               "events": w["events"]}
                           for k, w in windows.items()}
    if not all(np.array_equal(a, b) for a, b in zip(got[1], got[cards])):
        raise AssertionError(f"the runner's walks differ between 1 and "
                             f"{cards} cards")
    overlap = None
    if cards in rows:
        overlap = max(r["start_ms"] for r in rows[cards].values()) \
            < min(r["end_ms"] for r in rows[cards].values())
    print(f"multicard: runner, {B} pairs of {LQ} x {LT} at W={W}: median "
          f"wall of {reps} calls 1 card {walls[1] * 1e3:.1f} ms, {cards} "
          f"cards {walls[cards] * 1e3:.1f} ms; walks bit-identical",
          flush=True)
    for n in (1, cards):
        print(f"multicard: runner on {n} card(s), profiled call, busy "
              "windows (ms from the first start): " + (", ".join(
                  f"cuda:{k} {r['start_ms']:.2f}-{r['end_ms']:.2f} busy "
                  f"{r['busy_ms']:.2f} ({r['events']} events)"
                  for k, r in rows[n].items()) if n in rows else
                  "not measured (no device event in the trace)"),
              flush=True)
    print(f"multicard: runner: every card's window overlaps every other's: "
          f"{overlap}", flush=True)
    return {"walls_s": walls, "windows": rows, "overlap": overlap}


def phase_multicard_mesh(device, run, threads, coverage, counts):
    """The CLI with --mesh_devices 1 and then each of `counts` (and
    --wavefront off, so that stage 1 goes through the mesh runner) on the
    pipeline phase's genome.  Fails unless each many-card run writes the
    one-card run's nine files, launches rowband_dp and rowband_walk on every
    card of its mesh, reduces depth on the card, votes on the card and
    reaches F1 >= 0.8.  Returns each run's launches by card."""
    outs, by_card = {}, {}
    for n in (1,) + tuple(counts):
        outs[n] = os.path.join(run["work"], f"mesh{n}")
        res, launches, shapes, votes, depth, wall, _peak = run_cli(
            device, run["inputs"], outs[n], threads, coverage,
            ["--mesh_devices", str(n), "--wavefront", "off"],
            mesh_devices=n)
        score = run["score_calls"](res.final_report, run["truth"])
        by_card[n] = shapes["by_card"]
        print(f"multicard: --mesh_devices {n}: wall {wall:.1f} s, stage "
              "seconds " + json.dumps(
                  {k: round(v, 2) for k, v in res.stage_seconds.items()}),
              flush=True)
        print(f"multicard: --mesh_devices {n}: launches by card "
              f"{json.dumps(shapes['by_card'])}, peak device memory by card "
              + ", ".join(f"{b / 2**30:.2f}" for b in shapes["peak_by_card"])
              + f" GiB, stage 1 copied {launches['runner_bytes_to_host']} "
              f"bytes to the host, depth reductions {json.dumps(depth)}, "
              f"F1 {score['f1']} (tp {score['tp']} fp {score['fp']} fn "
              f"{score['fn']})", flush=True)
        for k in ("rowband_dp", "rowband_walk"):
            got = shapes["by_card"][k]
            if sorted(got) != list(range(n)) or min(got.values()) == 0:
                raise AssertionError(f"--mesh_devices {n}: {k} did not "
                                     f"launch on every card: {got}")
        if set(depth) != {"cuda"} or votes.get("cuda", 0) == 0:
            raise AssertionError(f"--mesh_devices {n}: depth {depth}, vote "
                                 f"{votes}: not on the card")
        if "locus_redistribute" not in res.stage_seconds:
            raise AssertionError(f"--mesh_devices {n}: no locus_redistribute "
                                 "stage")
        if score["f1"] < 0.8:
            raise AssertionError(f"--mesh_devices {n}: F1 {score['f1']} < "
                                 "0.8")
        if n > 1:
            differ = same_files(outs[1], outs[n])
            if differ:
                raise AssertionError(f"--mesh_devices {n} and 1 differ: "
                                     f"{differ}")
    print(f"multicard: --mesh_devices {', '.join(map(str, counts))}: "
          f"{len(RUN_FILES)} files byte-identical to --mesh_devices 1",
          flush=True)
    return by_card


def phase_multicard_runner(run, counts, timeout_s=900):
    """run_pipeline_multiprocess through the multi-process tool at one
    process and at each of `counts`, one rank a card (collectives over
    NCCL), on the pipeline phase's genome; each rank takes the host's cores
    over the ranks, at most 8.  Fails unless every run writes the one-process
    run's seven files, every rank of a group ran over NCCL with its
    collectives, wavefront kernels and vote on its own card only, and
    F1 >= 0.8.  Returns each run's ranks."""
    from telr_tpu_torch.tools import two_process_pipeline as tpp
    cores = os.cpu_count() or 1
    outs, runs = {}, {}
    for n in (1,) + tuple(counts):
        threads = max(1, min(8, cores // n))
        outs[n] = os.path.join(run["work"], f"mp{n}")
        t0 = time.perf_counter()
        ranks = tpp.launch(n, run["inputs"], outs[n],
                           os.path.join(run["work"], f"mp{n}_stats"),
                           threads, "cuda", timeout_s)
        launch_wall = time.perf_counter() - t0
        runs[n] = ranks
        with open(os.path.join(outs[n], "reads.telr.json")) as f:
            score = run["score_calls"](json.load(f), run["truth"])
        for r in ranks:
            print(f"multicard: {n} processes, rank {r['rank']} on "
                  f"{r['device']} ({r['backend']}, collectives on "
                  f"{r['collective_device']}): wall {r['wall_s']:.1f} s, "
                  "stage seconds " + json.dumps(
                      {k: round(v, 2) for k, v in
                       r["stage_seconds"].items()}), flush=True)
            print(f"multicard: {n} processes, rank {r['rank']}: launches by "
                  f"card {json.dumps(r['launches_by_card'])}, vote calls by "
                  f"card {json.dumps(r['vote_calls_by_card'])}, peak device "
                  f"memory {r['peak_device_bytes'] / 2**30:.2f} GiB",
                  flush=True)
        print(f"multicard: {n} processes, {threads} threads each: wall "
              f"{ranks[0]['wall_s']:.1f} s ({launch_wall:.1f} s with the "
              f"processes' start), F1 {score['f1']} (tp {score['tp']} fp "
              f"{score['fp']} fn {score['fn']})", flush=True)
        if score["f1"] < 0.8:
            raise AssertionError(f"{n} processes: F1 {score['f1']} < 0.8")
        for r in ranks:
            own = str(r["rank"]) if n > 1 else str(
                int(r["device"].partition(":")[2] or 0))
            if n > 1 and (r["backend"] != "nccl"
                          or r["device"] != f"cuda:{r['rank']}"
                          or r["collective_device"] != r["device"]):
                raise AssertionError(f"{n} processes: rank {r['rank']} ran "
                                     f"on {r['device']} over {r['backend']}"
                                     f" ({r['collective_device']})")
            for k in ("wavefront_dp", "wavefront_walk"):
                got = r["launches_by_card"][k]
                if list(got) != [own] or got[own] == 0:
                    raise AssertionError(f"{n} processes: rank {r['rank']}'s "
                                         f"{k} launches by card: {got}")
            if list(r["vote_calls_by_card"]) != [own]:
                raise AssertionError(f"{n} processes: rank {r['rank']}'s "
                                     "vote calls by card: "
                                     f"{r['vote_calls_by_card']}")
        if n > 1:
            differ = tpp._compare_dirs(outs[1], outs[n])
            if differ:
                raise AssertionError(f"{n} processes and 1 differ: {differ}")
    print(f"multicard: the runner at {', '.join(map(str, counts))} "
          "processes over NCCL wrote the one-process run's files byte for "
          "byte", flush=True)
    return runs


def phase_multicard_exchange(procs):
    """tools/exchange_bench.py at `procs` ranks, one a card: the payload
    and byte exchanges over gloo, then over NCCL, on the same seeded
    inputs (90 Mb of read codes, 16 MB of blobs).  Fails unless every rank
    ran over the backend asked for (NCCL's collectives on its own card),
    both received exactly what the owner rule routes to them, and the two
    backends' digests agree.  Returns both records."""
    from telr_tpu_torch.tools import exchange_bench
    res = {}
    for backend in ("gloo", "nccl"):
        res[backend] = rec = exchange_bench.run(procs, backend, "cuda",
                                                timeout_s=300)
        for r in rec["ranks"]:
            want = f"cuda:{r['rank']}" if backend == "nccl" else "cpu"
            if r["backend"] != backend or r["collective_device"] != want:
                raise AssertionError(f"exchange over {backend}: rank "
                                     f"{r['rank']} ran over {r['backend']} "
                                     f"on {r['collective_device']}")
        print(f"multicard: exchange at {procs} ranks over {backend}: "
              "payloads " + ", ".join(
                  f"{x:.4f}" for x in rec["payloads_seconds"])
              + f" s ({rec['payload_bytes']} bytes of codes, "
              f"{rec['payloads_wire_bytes']} on the wire), byte blobs "
              + ", ".join(f"{x:.4f}" for x in rec["bytes_seconds"])
              + f" s ({rec['blob_bytes']} bytes, {rec['bytes_wire_bytes']} "
              "on the wire), slowest rank per rep", flush=True)
    if res["gloo"]["digests"] != res["nccl"]["digests"]:
        raise AssertionError("NCCL's received items differ from gloo's")
    print(f"multicard: exchange: NCCL's received items equal gloo's on all "
          f"{procs} ranks", flush=True)
    return res


def phase_multicard(device, size, coverage, n_ins, seed, threads):
    """The multi-card half on every card torch sees (at least two): the
    mesh components on a (2, 2) mesh (a (1, 2) one on two or three cards)
    against a one-card mesh, the runner's overlap across the cards, the
    payload exchange at one rank a card over NCCL against gloo, the runner
    at one rank a card over NCCL against one process, and the CLI at
    --mesh_devices 2 and 4 (as many as there are cards) against 1, all on
    the pipeline phase's genome.  Returns the summary it prints."""
    import torch
    from telr_tpu_torch.dist.mesh import make_mesh
    cards = torch.cuda.device_count()
    if cards < 2:
        raise AssertionError(f"the multicard phase needs two or more cards; "
                             f"torch sees {cards}")
    counts = tuple(c for c in (2, 4) if c <= cards)
    clock = [time.perf_counter()]
    failed = []

    def part(what, fn, *args):
        """fn(*args), timed; a failure is printed and kept, and the parts
        after it still run (the phase fails at its end)."""
        try:
            return fn(*args)
        except Exception as e:   # noqa: BLE001 - reported, then re-raised
            import traceback
            traceback.print_exc()
            failed.append(f"{what}: {type(e).__name__}: {e}")
            return None
        finally:
            now = time.perf_counter()
            print(f"multicard: {what} took {now - clock[0]:.1f} s",
                  flush=True)
            clock[0] = now

    grid = make_mesh(4 if cards >= 4 else 2, loci_parallel=2, device="cuda")

    def components():
        one = dist_components(make_mesh(1, device=device))
        many = dist_components(grid)
        differ = same_outputs(one["outputs"], many["outputs"])
        if differ:
            raise AssertionError(f"{grid} differs from one card: {differ}")
        print(f"multicard: {grid}: every component bit-identical to the "
              "one-card mesh's and to its host reference", flush=True)
        return many["by_card"]

    grid_by_card = part("the mesh components", components)
    overlap = part("the runner's overlap", runner_overlap, cards)
    exchange = part("the exchange", phase_multicard_exchange, cards)
    with tempfile.TemporaryDirectory(prefix="telr_smoke_") as work:
        t0 = time.perf_counter()
        inputs, truth, n_reads, n_bases, score_calls = simulate(
            work, size, coverage, n_ins, seed)
        print(f"multicard: simulated {size / 1e6:g} Mb at {coverage}x, "
              f"{len(truth)} insertions, {n_reads} reads "
              f"({n_bases / 1e6:.1f} Mb) in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        run = {"work": work, "inputs": inputs, "truth": truth,
               "score_calls": score_calls}
        runner_runs = part("the runner at " + ", ".join(
            map(str, (1,) + counts)) + " processes", phase_multicard_runner,
            run, counts, max(300, size // 5000))
        mesh_by_card = part("the CLI at --mesh_devices " + ", ".join(
            map(str, (1,) + counts)), phase_multicard_mesh, device, run,
            threads, coverage, counts)
    if failed:
        raise AssertionError("multicard: " + " | ".join(failed))
    return {
        "cards": cards, "grid": str(grid),
        "grid_launches_by_card": grid_by_card,
        "runner_overlap": overlap,
        "exchange": {b: {k: r[k] for k in (
            "payloads_seconds", "bytes_seconds", "payload_bytes",
            "payloads_wire_bytes", "blob_bytes", "bytes_wire_bytes")}
            for b, r in exchange.items()},
        "mp": {n: [{"rank": r["rank"], "device": r["device"],
                    "backend": r["backend"], "wall_s": r["wall_s"],
                    "launches_by_card": r["launches_by_card"],
                    "peak_device_bytes": r["peak_device_bytes"]}
                   for r in ranks] for n, ranks in runner_runs.items()},
        "mesh_launches_by_card": mesh_by_card}


def phase_profile(device, coverage, n_ins, seed, threads, size=300_000):
    """The CLI with --profile_dir at 300 kb, then
    telr_tpu_torch/tools/profile_report.py on its trace: per-stage device
    seconds and top kernels.  Fails unless alignment and assembly each spent
    time in both wavefront kernels, and no stage has more device time than
    wall."""
    from telr_tpu_torch.tools import profile_report
    with tempfile.TemporaryDirectory(prefix="telr_smoke_") as work:
        inputs, _truth, n_reads, _n_bases, _score = simulate(
            work, size, coverage, n_ins, seed)
        trace_dir = os.path.join(work, "trace")
        res, launches, _shapes, _v, _d, wall, _peak = run_cli(
            device, inputs, os.path.join(work, "out"), threads, coverage,
            ["--profile_dir", trace_dir])
        rep = profile_report.report(trace_dir, top=50)
    print(f"profile: {size / 1e6:g} Mb, {n_reads} reads: wall {wall:.1f} s "
          f"under the profiler, trace {rep['trace_bytes']} bytes, devices "
          f"{rep['devices']}, launches {json.dumps(launches)}", flush=True)
    traced = {}
    for row in rep["stages"]:
        tops = ", ".join(f"{k['name']} {k['s']:.4f} s x{k['count']}"
                         for k in row["top"][:5])
        print(f"profile: {row['stage']}: wall {row['wall_s']:.3f} s, device "
              f"{row['device_s']:.4f} s ({row['busy_share'] * 100:.2f}%)"
              + (f"; {tops}" if tops else ""), flush=True)
        for k in row["top"]:
            traced[k["name"]] = traced.get(k["name"], 0) + k["count"]
    kernels = {k: v for k, v in traced.items() if k.endswith("_kernel")}
    print(f"profile: device total {rep['device_total_s']:.4f} s, outside "
          f"every stage {rep['unattributed_device_s']:.4f} s; kernel events "
          f"in the trace {json.dumps(kernels)}", flush=True)
    by = {row["stage"]: row for row in rep["stages"]}
    if set(by) != set(res.stage_seconds):
        raise AssertionError(f"trace stages {sorted(by)} != run stages "
                             f"{sorted(res.stage_seconds)}")
    for stage in ("alignment", "assembly"):
        secs = {k["name"]: k["s"] for k in by[stage]["top"]}
        for kernel in ("wavefront_dp_kernel", "wavefront_walk_kernel"):
            if not secs.get(kernel, 0) > 0:
                raise AssertionError(f"the trace gives {stage} no {kernel} "
                                     "time")
    for row in rep["stages"]:
        if row["device_s"] > row["wall_s"]:
            raise AssertionError(f"{row['stage']}: device {row['device_s']} s "
                                 f"> wall {row['wall_s']} s")


# one --device cpu run of the CLI (its arguments after -c) with the mappers'
# size gate at 0, in a process of its own; prints its wall seconds, the
# kernels' CUDA launches and the vote's calls as one JSON line
CPU_ROUTE_RUN = (
    "import json, sys, time\n"
    "import torch\n"
    "from telr_tpu_torch import cli\n"
    "from telr_tpu_torch.assembly.device_vote import vote_many\n"
    "from telr_tpu_torch.kernels import mapper\n"
    "from telr_tpu_torch.tools.bench_pipeline import kernel_launches\n"
    "mapper._WAVE_MIN_CELLS = 0\n"
    "torch.set_num_threads(1)\n"   # the plain versions are many small ops
    "t0 = time.perf_counter()\n"
    "cli.main(sys.argv[1:])\n"
    "print(json.dumps({'wall': time.perf_counter() - t0,\n"
    "                  'launches': kernel_launches(),\n"
    "                  'votes': vote_many.device_calls}))\n")
# the tail stages as the pipeline names them
TAIL_STAGES = ("te_filter", "annotate_contig", "allele_frequency",
               "ref_repeatmask", "liftover")


class CpuRoutes:
    """card-route's two --device cpu runs (the route the CPU tests hold to
    the JAX package's files), each in a process of its own, started when
    the script starts: they take most of that phase (70-120 s) and need
    neither the card nor any other phase, so they run beside the phases
    before it.  close() kills what still runs and removes their
    directory."""

    PAIRS = {"small": ("small_dataset",
                       ["--wavefront_stages", "alignment,assembly"]),
             "tail": ("tail_dataset", ["--wavefront", "on"])}

    def __init__(self, threads):
        from telr_tpu_torch.tools import bench_pipeline
        self._dir = tempfile.TemporaryDirectory(prefix="telr_smoke_")
        self.work = self._dir.name
        self.inputs, self.procs = {}, {}
        try:
            for key, (dataset, extra) in self.PAIRS.items():
                os.makedirs(os.path.join(self.work, key))
                self.inputs[key], _truth = getattr(bench_pipeline, dataset)(
                    os.path.join(self.work, key))
                # a file, not a pipe: nothing reads it until card-route
                with open(self.stdout(key), "w") as out:
                    self.procs[key] = subprocess.Popen(
                        [sys.executable, "-c", CPU_ROUTE_RUN] + cli_argv(
                            self.inputs[key],
                            os.path.join(self.work, key, "cpu"), threads, 8,
                            extra, cli_device="cpu"),
                        cwd=os.path.dirname(os.path.abspath(__file__)),
                        stdout=out)
        except BaseException:
            self.close()
            raise

    def stdout(self, key):
        return os.path.join(self.work, key, "cpu_run.out")

    def close(self):
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.wait()
        self._dir.cleanup()


def phase_card_route(device, threads, routes, timeout_s=900):
    """The card route against the route the CPU tests hold to the JAX
    package, the mappers' size gate at 0 so that the small batches reach the
    kernels, on two run pairs: the CLI on small_dataset
    (telr_tpu_torch/tools/bench_pipeline.py: a 12 kb genome, one insertion,
    4 kb reads at 8x) with --wavefront_stages alignment,assembly, and on
    tail_dataset (the same make with a reference copy of the inserted
    family) with --wavefront on, all seven stages.  Each pair runs once with
    --device cuda (the kernels) and once with --device cpu (their plain
    versions); the CPU runs are `routes` (CpuRoutes), started with the
    script.  Fails unless each pair's nine files are byte-identical, both
    wavefront kernels launched on the card and none in the CPU runs, and,
    on tail_dataset, both launched in each of the five tail stages.  Returns
    the card runs' launches and the tail run's by stage."""
    from telr_tpu_torch.kernels import mapper
    pairs, work = CpuRoutes.PAIRS, routes.work
    gate = mapper._WAVE_MIN_CELLS
    seen, by_stage, same = {}, {}, {}
    try:
        mapper._WAVE_MIN_CELLS = 0
        for key, (_dataset, extra) in pairs.items():
            with stage_record() as rec:
                _res, launches, _s, votes, _d, wall, _p = run_cli(
                    device, routes.inputs[key],
                    os.path.join(work, key, "cuda"), threads, 8, extra)
            seen[key] = {"cuda": (launches, votes, wall)}
            by_stage[key] = {st: r["launches"] for st, r in rec.items()}
    finally:
        mapper._WAVE_MIN_CELLS = gate
    for key, proc in routes.procs.items():
        if proc.wait(timeout=timeout_s):
            raise AssertionError(f"card-route: the {key} --device "
                                 f"cpu run exited {proc.returncode}")
        with open(routes.stdout(key)) as f:
            run = json.loads(f.read().strip().splitlines()[-1])
        seen[key]["cpu"] = (run["launches"], run["votes"], run["wall"])
        same[key] = []
        for f in RUN_FILES:
            with open(os.path.join(work, key, "cuda", f), "rb") as a, \
                    open(os.path.join(work, key, "cpu", f), "rb") as b:
                same[key].append(a.read() == b.read())
    for key, (_dataset, extra) in pairs.items():
        (lc, vc, wc), (lp, vp, wp) = seen[key]["cuda"], seen[key]["cpu"]
        print(f"card-route: {key}_dataset, {' '.join(extra)}, gate 0: "
              f"--device cuda {wc:.1f} s, launches wavefront_dp "
              f"{lc['wavefront_dp']} wavefront_walk {lc['wavefront_walk']}, "
              f"vote calls {json.dumps(vc)}; --device cpu {wp:.1f} s, "
              f"launches {lp['wavefront_dp']} / {lp['wavefront_walk']}, vote "
              f"calls {json.dumps(vp)}; {sum(same[key])} of {len(RUN_FILES)} "
              "files byte-identical", flush=True)
        print(f"card-route: {key}_dataset, --device cuda launches by stage "
              "(wavefront_dp / wavefront_walk): " + ", ".join(
                  f"{st} {n['wavefront_dp']} / {n['wavefront_walk']}"
                  for st, n in by_stage[key].items()
                  if n["wavefront_dp"] or n["wavefront_walk"]), flush=True)
        differ = [f for f, ok in zip(RUN_FILES, same[key]) if not ok]
        if differ:
            raise AssertionError(f"{key}_dataset: card and CPU routes differ "
                                 f"in {differ}")
        for k in ("wavefront_dp", "wavefront_walk"):
            if lc[k] == 0:
                raise AssertionError(f"{key}_dataset: the card run never "
                                     f"launched {k}")
            if lp[k] != 0:
                raise AssertionError(f"{key}_dataset: the CPU run launched "
                                     f"{k} on the card")
    for st in TAIL_STAGES:
        for k in ("wavefront_dp", "wavefront_walk"):
            if by_stage["tail"].get(st, {}).get(k, 0) == 0:
                raise AssertionError(f"tail_dataset: {st} never launched {k} "
                                     "on the card")
    return {"small": seen["small"]["cuda"][0],
            "tail": seen["tail"]["cuda"][0],
            "tail_by_stage": {st: by_stage["tail"][st] for st in TAIL_STAGES}}


def phase_eval(coverage, n_ins, seed, threads, size=1_000_000):
    """telr_tpu_torch/tools/genome_eval.py's run_eval on the card, auto
    routing: a 1 Mb genome in two chromosomes, ONT-like reads and the ONT
    preset, the pipeline phases' coverage, insertions and seed.  Fails
    unless F1 >= 0.8 and both wavefront kernels launched.  Returns the
    report."""
    from telr_tpu_torch.tools import genome_eval
    with tempfile.TemporaryDirectory(prefix="telr_smoke_") as work:
        rep = genome_eval.run_eval(size=size, coverage=coverage, n_ins=n_ins,
                                   seed=seed, ont_profile=True, chroms=2,
                                   threads=threads, workdir=work,
                                   out_path=os.path.join(work, "eval.json"))
    sc = rep["score"]
    print(f"eval: {size / 1e6:g} Mb in 2 chromosomes, ONT, seed {seed}: "
          f"{rep['workload']['n_reads']} reads, wall {rep['wall_s']} s, "
          f"precision {sc['precision']} recall {sc['recall']} F1 {sc['f1']} "
          f"(tp {sc['tp']} fp {sc['fp']} fn {sc['fn']}), family_exact "
          f"{sc['call_quality'].get('family_exact')}, launches "
          f"{json.dumps(rep['launches'])}, peak device memory "
          f"{rep['peak_device_bytes'] / 2**30:.2f} GiB, stage seconds "
          f"{json.dumps(rep['stage_seconds'])}", flush=True)
    for k in ("wavefront_dp", "wavefront_walk"):
        if rep["launches"][k] == 0:
            raise AssertionError(f"the eval run never launched {k}")
    if sc["f1"] < 0.8:
        raise AssertionError(f"eval F1 {sc['f1']} < 0.8")
    return rep


def phase_bench():
    """telr_tpu_torch/tools/bench.py with 3 trials: the score-only wavefront
    DP on bench.py's workload, its traceback path, and the kernel's gscore
    and best of all 64 pairs against the plain version's, which is timed on
    them.  Returns the record."""
    from telr_tpu_torch.tools import bench
    rec = bench.run(trials=3, check_pairs=64)
    tb = rec["traceback"]
    print(f"bench: {rec['value']} Gcells/s median of "
          f"{len(rec['trials_gcells_s'])} trials (min {rec['min']}, max "
          f"{rec['max']}), band512 {rec['band512_gcells_s']} Gcells/s, "
          f"{rec['ms_per_launch']:.3f} ms a launch against a bound of "
          f"{rec['bound_ms']:.3f} ms ({rec['bound_by']}; share "
          f"{rec['bound_share']:.3f}), {rec['launches']['wavefront_dp_scores']}"
          f" launches; {rec['checked_pairs']} pairs equal to the plain "
          f"version ({rec['plain_ms']:.1f} ms); traceback path "
          f"{tb['median_s_per_iter']:.4f} s a batch "
          f"({tb['gcells_s']:.2f} Gcells/s), a batch's DP "
          f"{tb['dp_ms_one_batch']:.3f} ms and walk "
          f"{tb['walk_ms_one_batch']:.3f} ms, split "
          f"{json.dumps(tb['split_last_call'])}", flush=True)
    return rec


def walk_lines(kernel, results):
    """One line per walk case: the longest walk and the time a step of it
    took (the launch's time over that walk's steps)."""
    for r in results:
        print(f"walk: {kernel} {r['case']} W={r['width']} mode {r['mode']}: "
              f"{r['pairs']} pairs, longest walk {r['walk_longest']} steps, "
              f"{r['walk_ms']:.4f} ms, " + (
                  f"{r['walk_ns_per_step']:.1f} ns a step"
                  if r["walk_ns_per_step"] is not None else
                  "no step walked") +
              f", plain {r['walk_plain_ms']:.1f} ms", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=3_000_000,
                    help="simulated genome bases of the pipeline phase "
                         "(pipeline-mesh takes at most MESH_SIZE, "
                         "multiprocess at most MP_SIZE)")
    ap.add_argument("--coverage", type=int, default=30)
    ap.add_argument("--n-ins", type=int, default=10)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of the phases after the "
                         "build, for debugging; a partial run prints no "
                         "summary and no ok line.  \"multicard\" alone "
                         "runs the multi-card half (two or more cards) and "
                         "prints its summary and the ok line")
    args = ap.parse_args(argv)

    import torch
    print(f"probe: python {sys.version.split()[0]}, torch {torch.__version__}"
          f", CUDA {torch.version.cuda}", flush=True)
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false")
    from telr_tpu_torch.kernels import cuda_lib
    from telr_tpu_torch.utils.procpool import ensure_forkserver
    ensure_forkserver()
    nvcc = subprocess.run([cuda_lib._nvcc(), "--version"], check=True,
                          capture_output=True, text=True).stdout
    print("probe: " + nvcc.strip().splitlines()[-1])
    smi_lines = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                "--format=csv,noheader"], check=True,
                               capture_output=True, text=True
                               ).stdout.strip().splitlines()
    smi = smi_lines[0]
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(device)
    print(f"probe: {kind} ({'; '.join(smi_lines)}), "
          f"{torch.cuda.device_count()} device(s)",
          flush=True)

    t0 = time.perf_counter()
    cuda_lib.load()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc "
          f"{' '.join(cuda_lib.NVCC_FLAGS)})")
    for line in ptxas_summary(cuda_lib.build_log):
        print("build: " + line)
    sys.stdout.flush()

    phases = set(args.phases.split(","))
    known = set(PHASES) | set(EXTRA_PHASES)
    if not phases <= known:
        sys.exit(f"chip_smoke: unknown phases {sorted(phases - known)}")
    threads = min(8, os.cpu_count() or 1)
    clock = [time.perf_counter()]

    def done(phase):
        now = time.perf_counter()
        print(f"{phase}: phase took {now - clock[0]:.1f} s", flush=True)
        clock[0] = now

    # the native host engine, built at its first use: here, before this
    # script starts processes that load it
    from telr_tpu_torch.io import native
    native.load()
    with contextlib.ExitStack() as stack:
        # card-route's CPU runs need neither the card nor any other phase:
        # they start now and run beside the phases before card-route
        if "card-route" in phases:
            routes = CpuRoutes(threads)
            stack.callback(routes.close)
        if "parity" in phases:
            results = phase_parity(device)
            for r in results:
                print("parity: " + json.dumps(r) + f" [{smi}]", flush=True)
            walk_lines("wavefront_walk", results)
            done("parity")
        if "rowband-parity" in phases:
            rb_results = phase_rowband_parity(device)
            for r in rb_results:
                print("parity: " + json.dumps(r) + f" [{smi}]", flush=True)
            walk_lines("rowband_walk", rb_results)
            done("rowband-parity")
        if "walk-tiles" in phases:
            tile_results = phase_walk_tiles(device)
            for r in tile_results:
                print("walk-tiles: " + json.dumps(r) + f" [{smi}]", flush=True)
            for kernel in ("rowband_walk", "wavefront_walk"):
                walk_lines(kernel, [r for r in tile_results
                                    if r["kernel"] == kernel])
            done("walk-tiles")
        if "dist" in phases:
            score_launches = phase_dist(device)
            done("dist")
        # the pipeline phase's run, its files and checkpoints, which the
        # entry-points phase enters again by other ways (or makes itself when
        # --phases leaves the pipeline phase out)
        with tempfile.TemporaryDirectory(prefix="telr_smoke_") as pipe_work:
            pipe_run = None
            if "pipeline" in phases:
                launches, pipe_run = phase_pipeline(
                    device, args.size, args.coverage, args.n_ins, args.seed,
                    threads, work=pipe_work)
                done("pipeline")
            if "entry-points" in phases:
                if pipe_run is None:
                    _l, pipe_run = phase_pipeline(
                        device, args.size, args.coverage, args.n_ins, args.seed,
                        threads, work=pipe_work)
                entry_launches, entry_by_stage = phase_entry_points(
                    device, pipe_run, threads, args.coverage)
                done("entry-points")
        if "pipeline-mesh" in phases:
            mesh_launches, _run = phase_pipeline(
                device, min(args.size, MESH_SIZE), args.coverage, args.n_ins,
                args.seed, threads, mesh=True)
            done("pipeline-mesh")
        if "mesh-identity" in phases:
            phase_mesh_identity(device, args.coverage, args.n_ins, args.seed,
                                threads)
            done("mesh-identity")
        if "multiprocess" in phases:
            # two ranks share the host's cores: the same thread budget each
            mp_launches = phase_multiprocess(min(args.size, MP_SIZE),
                                             args.coverage,
                                             min(args.n_ins, MP_N_INS), args.seed,
                                             max(1, threads // 2))
            done("multiprocess")
        if "profile" in phases:
            phase_profile(device, args.coverage, args.n_ins, args.seed, threads)
            done("profile")
        if "card-route" in phases:
            route_launches = phase_card_route(device, threads, routes)
            done("card-route")
        if "eval" in phases:
            eval_rep = phase_eval(args.coverage, args.n_ins, args.seed, threads)
            done("eval")
        if "bench" in phases:
            bench_rec = phase_bench()
            done("bench")
        if "multicard" in phases:
            multicard = phase_multicard(device, args.size, args.coverage,
                                        args.n_ins, args.seed, threads)
            done("multicard")

    for mod in ("jax", "telr_tpu"):
        if mod in sys.modules:
            raise AssertionError(f"{mod} was imported")
    if phases == {"multicard"}:
        print(json.dumps({"multicard": multicard}))
        print("; ".join(smi_lines))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return
    if phases != set(PHASES):
        print(f"partial run ({sorted(phases)}): no summary")
        return
    print("parity: every case bit-exact (tolerance 0)", flush=True)
    # the summary's times are bench.py's batch in EXTEND mode (its metric)
    bench = next(r for r in results
                 if r["case"] == "bench2048" and r["mode"] == 1)
    # ... and, for the row-banded DP, bench.py's batch in GLOBAL mode
    rb_bench = next(r for r in rb_results
                    if r["case"] == "bench512" and r["mode"] == 0)
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces}
        # the walk-tiles cases of this kernel (none for the DP kernels)
        tiles = [r for r in tile_results if r["kernel"] == name]
        if name == "rowband_dp":
            # launches: the traceback instance on the mesh pipeline's path,
            # the scores-only instance on the dist score steps'
            entry.update(
                launches=mesh_launches[name],
                max_abs_err=max(r["err"] for r in rb_results),
                ms=rb_bench["tb_ms"], plain_ms=rb_bench["tb_plain_ms"],
                bound_ms=rb_bench["tb_bound_ms"],
                bound_by=rb_bench["tb_bound_by"], library_ms=None,
                scores_launches=score_launches,
                scores_ms=rb_bench["scores_ms"],
                scores_plain_ms=rb_bench["scores_plain_ms"],
                scores_bound_ms=rb_bench["scores_bound_ms"],
                scores_bound_by=rb_bench["scores_bound_by"])
        elif name == "rowband_walk":
            # the bytes a launch sends to the host, against the direction
            # bytes (and the time of their copy) the host walk needed
            entry.update(
                launches=mesh_launches[name],
                max_abs_err=max(r["walk_err"] for r in rb_results + tiles),
                ms=rb_bench["walk_ms"], plain_ms=rb_bench["walk_plain_ms"],
                bound_ms=rb_bench["walk_bound_ms"],
                bound_by=rb_bench["walk_bound_by"], library_ms=None,
                bytes_to_host=rb_bench["walk_bytes_to_host"],
                dirs_bytes=rb_bench["dirs_bytes"],
                dirs_to_host_ms=rb_bench["dirs_to_host_ms"])
        else:
            key = "dp" if name == "wavefront_dp" else "walk"
            entry.update(
                launches=launches[name],
                max_abs_err=max(r[key + "_err"] for r in results + tiles),
                ms=bench[key + "_ms"], plain_ms=bench[key + "_plain_ms"],
                bound_ms=bench[key + "_bound_ms"],
                bound_by=bench[key + "_bound_by"], library_ms=None,
                mp_launches_per_rank=[r[name] for r in mp_launches],
                card_route_launches=route_launches["small"][name],
                tail_route_launches=route_launches["tail"][name],
                tail_route_launches_by_stage={
                    st: n[name] for st, n in
                    route_launches["tail_by_stage"].items()},
                eval_launches=eval_rep["launches"][name],
                bam_run_launches=entry_launches[name],
                bam_run_launches_by_stage={
                    st: n[name] for st, n in entry_by_stage.items()
                    if n[name]})
            if name == "wavefront_dp":
                # the score-only instance on the bench's path
                entry.update(
                    bench_scores_launches=bench_rec["launches"][
                        "wavefront_dp_scores"],
                    bench_scores_ms=bench_rec["ms_per_launch"],
                    bench_scores_plain_ms=bench_rec["plain_ms"],
                    bench_scores_bound_ms=bench_rec["bound_ms"])
        kernels.append(entry)
    # library_ms is null throughout: no single PyTorch call computes a
    # banded affine-gap DP or a traceback walk
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
