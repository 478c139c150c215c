"""Device-side pileup consensus vote (the wtpoa-cns replacement's hot half).

The consensus stage (reference wtpoa-cns, TELR_assembly.py:225-247 + polish
loop 185-260) is realign + column vote.  Realignment already runs through the
shared DP kernels; this module moves the *vote* onto the device too, as dense
torch ops over padded per-locus alignment batches:

  1. host packs each alignment's CIGAR as (op, len) run arrays + the
     strand-oriented query codes (ragged -> bucketed padded shapes),
  2. one batched torch computation per bucket shape expands runs to
     per-column labels
     (base 0..4 / deletion / uncovered) with a vectorized searchsorted over
     run end offsets — no scatter, no host bincount — and reduces them to
     per-column base votes, deletion votes and coverage, then applies the
     backbone-tie / no-vote / deletion-majority rules,
  3. loci that share a bucket shape are stacked so a polish round over
     hundreds of loci issues a handful of batched calls, all enqueued on
     the device before any result is copied back.

Insertion events (ragged, a handful per locus) stay host-side; they are read
straight off the run boundaries, and the consensus of every event of a round
is one call into the port's host library (csrc/ins_events.cpp).

Parity: bit-identical to assembly.local.consensus_vote (the numpy reference
implementation) — pinned by tests/test_torch_vote.py.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

OP_M, OP_I, OP_D, OP_PAD = 0, 1, 2, 3
_OP_CODE = {"M": OP_M, "I": OP_I, "D": OP_D}


def _bucket(n: int, step: int) -> int:
    """Power-of-two padded size with floor `step`: loci of one bucket
    stack into one batched call, at most 2x padding per axis."""
    b = step
    while b < n:
        b *= 2
    return b


def leftshift_ins(backbone: np.ndarray, tj: int,
                  seq: np.ndarray) -> Tuple[int, np.ndarray]:
    """VCF-style left normalization of an insertion event: rotate the
    inserted sequence left while the preceding backbone base equals its
    last base.  The DP places an insertion anywhere inside a repeat
    context; normalizing makes every read's restoration of the same
    deleted base vote on the SAME column."""
    while seq.size and tj > 0 and backbone[tj - 1] == seq[-1]:
        seq = np.concatenate([seq[-1:], seq[:-1]])
        tj -= 1
    return tj, seq


def _vote_torch(qcodes, opcode, oplen, qstart, tstart, backbone):
    """Per-column vote of K stacked loci, as torch ops on their device.

    qcodes (K,A,Q) int8, opcode (K,A,R) int8, oplen (K,A,R) int32,
    qstart/tstart (K,A) int32, backbone (K,N) int8.  Returns best (K,N)
    int8, keep (K,N) bool, cov and delv (K,N) int32."""
    import torch
    K, A, R = opcode.shape
    Q = qcodes.shape[2]
    N = backbone.shape[1]
    i64 = torch.int64
    dev = opcode.device
    opcode = opcode.to(i64)
    oplen = oplen.to(i64)
    cols = torch.arange(N, dtype=i64, device=dev)
    tcons = torch.where((opcode == OP_M) | (opcode == OP_D), oplen, 0)
    qcons = torch.where((opcode == OP_M) | (opcode == OP_I), oplen, 0)
    tend = tstart.to(i64)[..., None] + torch.cumsum(tcons, dim=2)   # (K,A,R)
    tbeg = tend - tcons
    qbeg = qstart.to(i64)[..., None] + torch.cumsum(qcons, dim=2) - qcons
    # covering run for column j = first r with tend[r] > j; zero-length
    # (I / pad) runs never win because their tbeg == tend
    run = torch.searchsorted(tend, cols.expand(K, A, N).contiguous(),
                             right=True)
    run_c = run.clamp_max(R - 1)
    op_j = opcode.gather(2, run_c)
    tb_j = tbeg.gather(2, run_c)
    qb_j = qbeg.gather(2, run_c)
    covered = ((run < R) & (tb_j <= cols) & (op_j != OP_PAD)
               & (op_j != OP_I))
    qidx = (qb_j + (cols - tb_j)).clamp(0, Q - 1)
    base = qcodes.to(i64).gather(2, qidx)
    # label: 0..4 base vote (4 = N base), 5 deletion, 6 uncovered
    lab = torch.where(covered, torch.where(op_j == OP_D, 5, base), 6)
    cov = (lab <= 5).sum(dim=1, dtype=torch.int32)                 # (K,N)
    delv = (lab == 5).sum(dim=1, dtype=torch.int32)
    votes = torch.stack([(lab == b).sum(dim=1, dtype=torch.int32)
                         for b in range(5)], dim=2)                # (K,N,5)
    bb = backbone.to(i64).clamp(0, 4)
    vbest = votes.max(dim=2).values
    # first maximum, written out (the tie rule of numpy/jnp argmax)
    five = torch.arange(5, dtype=i64, device=dev)
    best = torch.where(votes == vbest[..., None], five, 5).min(dim=2).values
    vbb = votes.gather(2, bb[..., None])[..., 0]
    best = torch.where(vbest == vbb, bb, best)
    best = torch.where(votes.sum(dim=2) == 0, bb, best)
    keep = ~(delv * 2 > cov)
    return best.to(torch.int8), keep, cov, delv


# elements of the (loci, reads, columns) label tensor one vote call may
# build: bounds the vote's device memory (several int64 temporaries of
# this size are live at once)
_VOTE_ELEMS = 1 << 25


class InsTable:
    """One locus's insertion sequences, left-shifted (leftshift_ins), by
    the column they vote on: `cols` maps a column to its sequences' ids in
    the order the alignments gave them.  freeze() lays the sequences out
    once in one flat buffer, which the round's event batch reads."""

    __slots__ = ("cols", "seqs", "codes", "lens")

    def __init__(self) -> None:
        self.cols: Dict[int, List[int]] = {}
        self.seqs: List[np.ndarray] = []
        self.codes = self.lens = None

    def add(self, col: int, seq: np.ndarray) -> None:
        self.cols.setdefault(col, []).append(len(self.seqs))
        self.seqs.append(seq)

    def freeze(self) -> "InsTable":
        self.codes = (np.concatenate(self.seqs).astype(np.int8, copy=False)
                      if self.seqs else np.zeros(0, dtype=np.int8))
        self.lens = np.fromiter(map(len, self.seqs), dtype=np.int64,
                                count=len(self.seqs))
        self.seqs = []
        return self


class _PackedLocus:
    __slots__ = ("qcodes", "opcode", "oplen", "qstart", "tstart",
                 "backbone", "n", "ins", "n_reads")

    def __init__(self, backbone: np.ndarray, alignments) -> None:
        from telr_tpu_torch.assembly.local import _oriented
        n = len(backbone)
        a_n = len(alignments)
        r_max = max(len(a.cigar) for a, _ in alignments)
        q_max = max(a.qlen for a, _ in alignments)
        qcodes = np.zeros((a_n, q_max), dtype=np.int8)
        opcode = np.full((a_n, r_max), OP_PAD, dtype=np.int8)
        oplen = np.zeros((a_n, r_max), dtype=np.int32)
        qstart = np.zeros(a_n, dtype=np.int32)
        tstart = np.zeros(a_n, dtype=np.int32)
        ins = InsTable()
        for i, (a, codes) in enumerate(alignments):
            qc, qi = _oriented(a, codes)
            qcodes[i, : len(qc)] = qc
            qstart[i] = qi
            tstart[i] = a.tstart
            tj = a.tstart
            for r, (op, ln) in enumerate(a.cigar):
                opcode[i, r] = _OP_CODE[op]
                oplen[i, r] = ln
                if op == "I":
                    ins.add(*leftshift_ins(backbone, tj, qc[qi:qi + ln]))
                    qi += ln
                elif op == "M":
                    qi += ln
                    tj += ln
                else:
                    tj += ln
        self.qcodes = qcodes
        self.opcode = opcode
        self.oplen = oplen
        self.qstart = qstart
        self.tstart = tstart
        self.backbone = np.asarray(backbone, dtype=np.int8)
        self.n = n
        self.ins = ins.freeze()
        self.n_reads = a_n

    def buckets(self) -> Tuple[int, int, int, int]:
        return (_bucket(self.n_reads, 8), _bucket(self.opcode.shape[1], 32),
                _bucket(self.qcodes.shape[1], 2048), _bucket(self.n, 2048))


def _plan_events(cov: np.ndarray, ins: InsTable, n_reads: int,
                 min_cov: int):
    """Tip trimming and the choice of insertion events of one locus: (lo,
    hi, [(column, supporter ids)] by column), or None when no column is
    covered.  Which events exist depends only on the coverage and the
    supporter counts, so a round's events are all known before any
    consensus is computed."""
    covered = np.nonzero(cov >= (min_cov if n_reads > 2 else 1))[0]
    if covered.size == 0:
        return None
    lo, hi = int(covered[0]), int(covered[-1]) + 1
    cols = ins.cols
    events: List[Tuple[int, List[int]]] = []
    weak: List[int] = []
    for j in sorted(cols):
        if not (lo < j < hi):
            continue
        if 2 * len(cols[j]) > int(cov[j]):
            events.append((j, cols[j]))
        else:
            weak.append(j)
    # adjacent-column pooling of sub-majority insertions: a deleted
    # backbone base is restored by reads inserting it back, but alignment
    # ambiguity scatters those insertions over neighbouring columns, so no
    # single column reaches majority and the base stays lost (observed on
    # deletion-dominated ONT noise as ~7% contig shrinkage).  Columns that
    # individually failed the gate pool with neighbours within 2 columns.
    # Pooled events demand a 2/3 SUPERMAJORITY: genuine restorations carry
    # ~90% of coverage split over the window, while homopolymer insertion
    # noise piles (PacBio CLR) reach 30-45% — a bare pooled majority tips
    # those piles and bloats the contig instead.
    taken = {j for j, _ in events}
    cluster: List[int] = []
    for j in weak + [hi + 10]:
        if cluster and (j - cluster[-1] > 2 or j >= hi):
            if not any(c in taken or c - 1 in taken or c + 1 in taken
                       for c in cluster):
                ids = [i for c in cluster for i in cols[c]]
                jm = cluster[len(cluster) // 2]
                if 3 * len(ids) > 2 * int(cov[jm]):
                    events.append((cluster[0], ids))
            cluster = []
        if j < hi:
            cluster.append(j)
    events.sort(key=lambda e: e[0])
    return lo, hi, events


def _events_consensus(loci_events) -> List[np.ndarray]:
    """The consensus of every event of a round in one native call
    (csrc/ins_events.cpp), in order: loci_events is (InsTable, [supporter
    ids of each event]) per locus.  One `vote.ins_events` span.

    An event's consensus is a column vote over its supporters aligned to
    the median-length one (tiny global DPs), with sub-majority-deleted
    columns restored by nested insertion majority: splicing one raw read's
    bases instead would give every junction-adjacent event, where the TSD
    bases live, that read's error rate (~12% on ONT; reference wtpoa-cns
    computes a POA consensus here, TELR_assembly.py:225-247)."""
    from telr_tpu_torch.io import host_lib
    from telr_tpu_torch.utils import hoststats
    with hoststats.timer("vote.ins_events"):
        codes, lens, ev_sup, ev_off, base = [], [], [], [0], 0
        for ins, events in loci_events:
            if not events:
                continue
            codes.append(ins.codes)
            lens.append(ins.lens)
            for ids in events:
                ev_sup.extend(base + i for i in ids)
                ev_off.append(len(ev_sup))
            base += len(ins.lens)
        stats = {"dp_events": 0, "pairs": 0, "cells": 0}
        out: List[np.ndarray] = []
        if codes:
            sup_off = np.zeros(base + 1, dtype=np.int64)
            np.cumsum(np.concatenate(lens), out=sup_off[1:])
            out = host_lib.ins_event_consensus_batch(
                np.concatenate(codes), sup_off,
                np.asarray(ev_sup, dtype=np.int64),
                np.asarray(ev_off, dtype=np.int64), stats=stats)
        hoststats.annotate(events=len(ev_off) - 1, **stats)
    return out


def _splice(best: np.ndarray, keep: np.ndarray, plan,
            seqs) -> np.ndarray:
    """The trimmed consensus of one locus with its events' sequences
    (taken in order from the iterator `seqs`) spliced in."""
    if plan is None:
        return np.zeros(0, dtype=np.int8)
    lo, hi, events = plan
    best = best[lo:hi].astype(np.int8)
    keep = keep[lo:hi]
    parts: List[np.ndarray] = []
    prev = lo
    for j, ids in events + [(hi, None)]:
        m = keep[prev - lo:j - lo]
        parts.append(best[prev - lo:j - lo][m])
        if ids is not None:
            parts.append(next(seqs))
        prev = j
    return np.concatenate(parts).astype(np.int8)


def finalize_many(loci, min_cov: int = 2) -> List[np.ndarray]:
    """The ragged host finish of the vote (consensus_vote steps 3-4), for
    every locus of a round: loci is (best, keep, cov, InsTable, n_reads)
    per locus.  Three phases: each locus's trim and events (Python), every
    event's consensus in one native call, each locus's splice."""
    plans = [_plan_events(cov, ins, n_reads, min_cov)
             for _best, _keep, cov, ins, n_reads in loci]
    seqs = iter(_events_consensus(
        [(ins, [ids for _j, ids in plan[2]])
         for (_b, _k, _c, ins, _n), plan in zip(loci, plans) if plan]))
    return [_splice(best, keep, plan, seqs)
            for (best, keep, *_rest), plan in zip(loci, plans)]


def finalize_consensus(backbone: np.ndarray, best: np.ndarray,
                       keep: np.ndarray, cov: np.ndarray,
                       ins_seqs: Dict[int, List[np.ndarray]],
                       n_reads: int, min_cov: int = 2) -> np.ndarray:
    """finalize_many over one locus whose insertion sequences come by
    column (the numpy path, local.consensus_vote)."""
    ins = InsTable()
    for j, seqs in ins_seqs.items():
        for sq in seqs:
            ins.add(j, sq)
    return finalize_many([(best, keep, cov, ins.freeze(), n_reads)],
                         min_cov)[0]


def vote_many(items: Sequence[Tuple[np.ndarray, list]],
              min_cov: int = 2, device=None) -> List[np.ndarray]:
    """Batched consensus over (backbone, alignments) loci on `device`
    (None: the first CUDA card, raising when there is none; "cpu" must be
    asked for).

    Loci sharing a padded bucket shape are stacked into torch calls of at
    most _VOTE_ELEMS label cells; every call is enqueued before any result
    is copied back.  Returns one consensus codes array per locus (same
    contract as consensus_vote per locus)."""
    import torch
    from telr_tpu_torch.utils import hoststats
    from telr_tpu_torch.utils.device import resolve
    dev = resolve(device)
    vote_many.device_calls[dev.type] = \
        vote_many.device_calls.get(dev.type, 0) + 1
    if dev.type == "cuda":
        card = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        vote_many.card_calls[card] = vote_many.card_calls.get(card, 0) + 1

    with hoststats.timer("vote.pack"):
        packed = [_PackedLocus(bb, alns) for bb, alns in items]
        groups: Dict[Tuple[int, int, int, int], List[int]] = {}
        for i, p in enumerate(packed):
            groups.setdefault(p.buckets(), []).append(i)

    # every call is enqueued before the first copy back; each call's host
    # arrays (vote.stack) are let go once they are on the device
    with hoststats.timer("vote.device"):
        pending = []
        for (a_b, r_b, q_b, n_b), all_idxs in groups.items():
            step = max(1, _VOTE_ELEMS // (a_b * n_b))
            for lo in range(0, len(all_idxs), step):
                idxs = all_idxs[lo:lo + step]
                with hoststats.timer("vote.stack"):
                    arrays = _stack(packed, idxs, a_b, r_b, q_b, n_b)
                pending.append((idxs, _vote_torch(
                    *(torch.from_numpy(x).to(dev) for x in arrays))))
        fetched = [(idxs, best.cpu().numpy(), keep.cpu().numpy(),
                    cov.cpu().numpy())
                   for idxs, (best, keep, cov, _delv) in pending]

    results: List[np.ndarray] = [None] * len(packed)  # type: ignore
    with hoststats.timer("vote.finalize"):
        order = [i for idxs, *_rest in fetched for i in idxs]
        loci = [(best[s, : packed[i].n], keep[s, : packed[i].n],
                 cov[s, : packed[i].n], packed[i].ins, packed[i].n_reads)
                for idxs, best, keep, cov in fetched
                for s, i in enumerate(idxs)]
        for i, out in zip(order, finalize_many(loci, min_cov)):
            results[i] = out
    return results


def _stack(packed, idxs, a_b: int, r_b: int, q_b: int, n_b: int):
    """The padded (qcodes, opcode, oplen, qstart, tstart, backbone) arrays
    of one vote call over the loci `idxs` of `packed`."""
    k = len(idxs)
    qcodes = np.zeros((k, a_b, q_b), dtype=np.int8)
    opcode = np.full((k, a_b, r_b), OP_PAD, dtype=np.int8)
    oplen = np.zeros((k, a_b, r_b), dtype=np.int32)
    qstart = np.zeros((k, a_b), dtype=np.int32)
    tstart = np.zeros((k, a_b), dtype=np.int32)
    backbone = np.zeros((k, n_b), dtype=np.int8)
    for s, i in enumerate(idxs):
        p = packed[i]
        a_n, r_n = p.opcode.shape
        qcodes[s, :a_n, : p.qcodes.shape[1]] = p.qcodes
        opcode[s, :a_n, :r_n] = p.opcode
        oplen[s, :a_n, :r_n] = p.oplen
        qstart[s, :a_n] = p.qstart
        tstart[s, :a_n] = p.tstart
        # padded alignment rows are all-OP_PAD -> label 6 everywhere
        backbone[s, : p.n] = p.backbone
    return qcodes, opcode, oplen, qstart, tstart, backbone


# calls per device type ("cuda", "cpu"), so a run can show where it voted,
# and the calls on a card by its index
vote_many.device_calls = {}
vote_many.card_calls = {}
