"""Traffic `map`: stage-1 mapping of a whole sample's reads, pass after pass.

A pass is run_pipeline's stage-1 call itself: one
Aligner.map_batch_parallel over every read of the sample with the
configuration's threads, on the Aligner (reference index, planning pool)
that set-up built.  Warm-up maps the first `warm_reads` reads, which starts
the pool and loads the kernels.  The rate is read bases mapped a second.

The judge takes a sample of reads drawn from the seed (`judged_reads`),
with the longest reads in it (`judged_longest`: their dispatches are the
largest, past the size gate that sends a dispatch to the card), and holds each one's best primary alignment in the last pass to what
the reference knows without the program:
  passes_differ  reads whose alignments differ between the first and the
                 last pass (exact: 0)
  cigar_bad      alignments whose cigar does not spell the read against the
                 reference at the reported coordinates, or whose residue
                 matches are miscounted (exact: 0)
  unaligned      share of the sampled reads with no primary alignment
  misplaced      share of the aligned ones whose alignment misses the
                 interval the read was simulated from
  score_gap      the widest gap, in score points, between the best GLOBAL
                 score of the read's aligned span against the reference
                 span (refdp, the whole matrix) and the score of the
                 program's cigar over it
The control puts the reference in the program's place with its band cut to
CONTROL_BAND columns, an eighth of the narrowest band the mapper uses.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from benchmark import port, refdp

RATE = "map_Mb_per_s"
CONTROL_BAND = 16


def setup(run) -> dict:
    tcfg = port.telr_config(run.config, run.device)
    reference, _, _ = port.seqdicts(run.sample)
    return {"tcfg": tcfg,
            "aligner": port.stage1_aligner(reference, tcfg, run.device),
            "queries": {n: c for n, c in run.sample.reads}}


def warm(run, st) -> None:
    n = int(run.cell["traffic_params"]["warm_reads"])
    first = dict(list(st["queries"].items())[:n])
    st["aligner"].map_batch_parallel(first, st["tcfg"].threads)


def one_pass(run, st):
    res = st["aligner"].map_batch_parallel(st["queries"], st["tcfg"].threads)
    return run.sample.read_bases / 1e6, len(st["queries"]), res


def trace_hooks(run, st, patches) -> None:
    from telr_tpu_torch.kernels import hopper_wavefront
    from telr_tpu_torch.utils import procpool
    patches.wrap(procpool.AlignerPool, "plan", run.spans, "map.plan_pool")
    patches.wrap(hopper_wavefront, "prepare_wavefront_batch", run.spans,
                 "map.wave_prep", before=run.launch_spy)


def close(run, st) -> None:
    port.close_aligner(st.pop("aligner"))


def missing(run, out) -> int:
    """Reads the last pass returned no alignment for."""
    return sum(1 for n in run.sample.reads if not out.get(n[0]))


def _picked(run) -> List[int]:
    reads, tp = run.sample.reads, run.cell["traffic_params"]
    n = min(int(tp["judged_reads"]), len(reads))
    rng = np.random.default_rng([int(run.seed), 1])
    picked = set(rng.choice(len(reads), n, replace=False).tolist())
    by_len = np.argsort([-len(c) for _, c in reads], kind="stable")
    picked.update(int(k) for k in by_len[:int(tp["judged_longest"])])
    return sorted(picked)


def kept(run, out) -> dict:
    """The part of a pass's answers the judge reads: the sampled reads'."""
    return {n: out[n] for n in (run.sample.reads[k][0] for k in _picked(run))
            if n in out}


def _key(hits) -> list:
    return [(h.tname, h.tstart, h.tend, h.strand, h.score, h.primary,
             tuple(h.cigar)) for h in hits]


def _judged(run, st, first, last):
    """Per sampled read: its counts, and the (query, target) span and cigar
    score of the alignments the DP reference is to score."""
    pre = st["tcfg"].read_preset
    genome = run.sample.genome
    counts = {"passes_differ": 0, "cigar_bad": 0, "unaligned": 0,
              "misplaced": 0}
    spans, scores = [], []
    picked = _picked(run)
    for k in picked:
        name, codes = run.sample.reads[k]
        hits = last.get(name, [])
        if _key(first.get(name, [])) != _key(hits):
            counts["passes_differ"] += 1
        prim = [h for h in hits if h.primary]
        if not prim:
            counts["unaligned"] += 1
            continue
        a = max(prim, key=lambda h: h.score)
        o0, o1 = run.sample.origin[k]
        if a.tname != run.sample.chrom or a.tend <= o0 or a.tstart >= o1:
            counts["misplaced"] += 1
        qc = refdp.revcomp(codes) if a.strand == "-" else codes
        qs = a.qlen - a.qend if a.strand == "-" else a.qstart
        q = qc[qs:qs + (a.qend - a.qstart)]
        t = genome[a.tstart:a.tend]
        ok = (a.qlen == len(codes) and 0 <= a.qstart <= a.qend <= len(codes)
              and 0 <= a.tstart <= a.tend <= len(genome)
              and a.tname == run.sample.chrom)
        if ok:
            try:
                sc, matches, nq, nt = refdp.cigar_score(
                    q, t, a.cigar, pre.match, pre.mismatch, pre.gap_open,
                    pre.gap_extend)
                ok = nq == len(q) and nt == len(t) and matches == a.matches
            except (IndexError, ValueError):
                ok = False
        if not ok:
            counts["cigar_bad"] += 1
            continue
        spans.append((q, t))
        scores.append(sc)
    aligned = len(picked) - counts["unaligned"]
    return {
        "passes_differ": counts["passes_differ"],
        "cigar_bad": counts["cigar_bad"],
        "unaligned": counts["unaligned"] / len(picked),
        "misplaced": counts["misplaced"] / max(1, aligned),
    }, spans, scores


def _dp(run, st, spans, band=None) -> List[int]:
    pre = st["tcfg"].read_preset
    return refdp.global_scores(spans, pre.match, pre.mismatch, pre.gap_open,
                               pre.gap_extend, band=band,
                               device=run.ref_device)


def judge(run, st, outs) -> Dict[str, float]:
    nums, spans, scores = _judged(run, st, outs[0], outs[-1])
    best = _dp(run, st, spans)
    nums["score_gap"] = float(max((b - s for b, s in zip(best, scores)),
                                  default=0))
    return nums


def control(run, st, outs) -> Dict[str, float]:
    """The judge's numbers with the control's scores in the program's
    place: the same spans, scored by the reference inside a band of
    CONTROL_BAND columns."""
    nums, spans, _ = _judged(run, st, outs[-1], outs[-1])
    best = _dp(run, st, spans)
    ctl = _dp(run, st, spans, band=CONTROL_BAND)
    nums["score_gap"] = float(max((b - c for b, c in zip(best, ctl)),
                                  default=0))
    return nums


def faults(run, st, outs) -> Dict[str, Dict[str, float]]:
    """The judge's numbers on the last pass's answers broken as the timed
    path could break them: half of the reads left out, and every
    alignment moved 20 kb along the reference (modulo its length) where it
    is produced."""
    last = outs[-1]
    names = [n for n, _ in run.sample.reads]
    half = {n: last[n] for n in names[::2] if n in last}
    size = len(run.sample.genome)

    def move(h):
        span = h.tend - h.tstart
        t0 = (h.tstart + 20_000) % max(1, size - span)
        return dataclasses.replace(h, tstart=t0, tend=t0 + span)

    moved = {n: [move(h) for h in hits] for n, hits in last.items()}
    return {"half_batch": judge(run, st, [half, half]),
            "answer_altered": judge(run, st, [moved, moved])}
