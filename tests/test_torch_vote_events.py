"""The vote's insertion-event consensus in one native batch
(csrc/ins_events.cpp) against the JAX package's per-event rule
(telr_tpu.assembly.device_vote._ins_event_consensus), event for event with
tolerance zero, on seeded fuzz at the loci cells' shapes; and vote_many on
loci with many short insertion events against the JAX vote and both
consensus_votes."""

from collections import Counter

import numpy as np
import pytest

from telr_tpu.assembly.device_vote import _ins_event_consensus
from telr_tpu.assembly.device_vote import vote_many as jax_vote_many
from telr_tpu.assembly.local import consensus_vote
from telr_tpu.config import MAP_PB
from telr_tpu.io.seqs import SeqDict, Sequence, revcomp_codes
from telr_tpu.kernels.mapper import Aligner
from telr_tpu_torch.assembly.device_vote import vote_many
from telr_tpu_torch.assembly.local import \
    consensus_vote as port_consensus_vote
from telr_tpu_torch.io import host_lib


def _noisy(rng, base, rate):
    """`base` with substitutions, deletions and insertions, each at
    rate / 3 a base."""
    out = []
    for b in base.tolist():
        r = rng.random()
        if r < rate / 3:
            continue
        if r < 2 * rate / 3:
            out.append(int(rng.integers(0, 4)))
        elif r < rate:
            out += [b, int(rng.integers(0, 4))]
        else:
            out.append(b)
    return np.array(out, dtype=np.int8)


def _fuzz(rng, lens, supporters, rate):
    seqs = []
    base = rng.integers(0, 4, int(rng.integers(*lens))).astype(np.int8)
    for _ in range(int(rng.integers(*supporters))):
        s = _noisy(rng, base, rate)
        seqs.append(s if len(s) else base[:1].copy())
    return seqs


def _majority(rng, near):
    """n copies of one string and n (near) or n - 1 others: exactly half
    (falls through to the DP) or a strict majority."""
    top = rng.integers(0, 4, int(rng.integers(1, 5))).astype(np.int8)
    n = int(rng.integers(3, 12))
    others = [np.concatenate([top, rng.integers(0, 4, int(rng.integers(
        1, 3))).astype(np.int8)]) for _ in range(n if near else n - 1)]
    seqs = [top.copy() for _ in range(n)] + others
    return [seqs[i] for i in rng.permutation(len(seqs))]


def _past_end(rng):
    """Equal-length supporters: the one at the median keeps its core, every
    other drops an inner base and carries a tail base the core does not
    end with, so the nested insertion past the representative's end is
    spliced."""
    core = rng.integers(0, 4, int(rng.integers(4, 9))).astype(np.int8)
    tail = np.int8((int(core[-1]) + 1 + int(rng.integers(0, 3))) % 4)
    n = int(rng.integers(3, 10))
    seqs = []
    for _ in range(n):
        k = int(rng.integers(1, len(core) - 1))
        seqs.append(np.concatenate([core[:k], core[k + 1:], [tail]])
                    .astype(np.int8))
    seqs[n // 2] = core.copy()
    return seqs


_SHAPES = {
    # the loci cells' events: 1-3 bp, 10-40 supporters
    "short": lambda rng: _fuzz(rng, (1, 4), (10, 41), 0.3),
    # 100-400 bp: _prep_pair's banded width rule
    "long": lambda rng: _fuzz(rng, (100, 401), (2, 9), 0.12),
    "single": lambda rng: _fuzz(rng, (1, 60), (1, 2), 0.1),
    "majority": lambda rng: _majority(rng, near=False),
    "near_majority": lambda rng: _majority(rng, near=True),
    # a representative over 400 bp is kept as it is
    "over_cap": lambda rng: _fuzz(rng, (401, 460), (2, 6), 0.05),
    # empty supporters: under half of them align as an empty cigar; over
    # half are the empty majority
    "empty": lambda rng: ([np.zeros(0, np.int8)] * int(rng.integers(1, 4))
                          + _fuzz(rng, (1, 6), (4, 9), 0.3)),
    "empty_majority": lambda rng: ([np.zeros(0, np.int8)] * 5
                                   + _fuzz(rng, (1, 6), (2, 5), 0.3)),
    "past_end": _past_end,
}
_COUNTS = {"long": 12, "over_cap": 6}


def expected_stats(events):
    """dp_events, pairs and cells of a batch, counted from the rule: the
    events with more than one supporter, no strict majority and a
    median-length representative of 1..400 bases run the DP."""
    dp_events = pairs = cells = 0
    for seqs in events:
        if len(seqs) == 1:
            continue
        if 2 * Counter(s.tobytes() for s in seqs).most_common(1)[0][1] \
                > len(seqs):
            continue
        rep = sorted(seqs, key=len)[len(seqs) // 2]
        if not 0 < len(rep) <= 400:
            continue
        dp_events += 1
        pairs += len(seqs)
        cells += sum(len(s) * len(rep) for s in seqs)
    return {"dp_events": dp_events, "pairs": pairs, "cells": cells}


def batch(events):
    """The native batch over `events`, each supporter once in the flat
    buffer, in the events' order."""
    flat = [s for seqs in events for s in seqs]
    sup_off = np.zeros(len(flat) + 1, dtype=np.int64)
    sup_off[1:] = np.cumsum([len(s) for s in flat])
    ev_off = np.zeros(len(events) + 1, dtype=np.int64)
    ev_off[1:] = np.cumsum([len(e) for e in events])
    codes = (np.concatenate(flat) if flat else np.zeros(0, np.int8))
    stats = {}
    out = host_lib.ins_event_consensus_batch(
        codes, sup_off, np.arange(len(flat), dtype=np.int64), ev_off,
        stats=stats)
    return out, stats


@pytest.mark.parametrize("shape", sorted(_SHAPES))
def test_batch_matches_the_jax_rule(shape):
    rng = np.random.default_rng(1700 + sorted(_SHAPES).index(shape))
    events = [_SHAPES[shape](rng) for _ in range(_COUNTS.get(shape, 60))]
    got, stats = batch(events)
    assert len(got) == len(events)
    for seqs, g in zip(events, got):
        w = _ins_event_consensus(seqs)
        assert g.dtype == np.int8 and np.array_equal(g, w)
    assert stats == expected_stats(events)
    if shape in ("near_majority", "short", "long", "past_end"):
        assert stats["dp_events"] > 0
    if shape in ("majority", "single", "over_cap", "empty_majority"):
        assert stats["dp_events"] == 0
    if shape == "past_end":
        # the splice past the end: the consensus ends with the tail base,
        # which the representative does not
        ends = sum(int(g[-1]) == int(seqs[0][-1]) != int(seqs[len(seqs)
                   // 2][-1]) for seqs, g in zip(events, got) if len(g))
        assert ends >= len(events) // 2


def test_batch_of_no_events():
    got, stats = batch([])
    assert got == [] and stats == {"dp_events": 0, "pairs": 0, "cells": 0}


def test_mixed_batch_is_the_events_one_by_one():
    """One batch over every shape, supporters shared between events (the
    pooled events' columns) and listed out of order, equals each event
    alone."""
    rng = np.random.default_rng(1799)
    events = [_SHAPES[s](rng) for s in sorted(_SHAPES) for _ in range(4)]
    flat = [s for seqs in events for s in seqs]
    perm = rng.permutation(len(flat))
    where = np.argsort(perm)          # supporter k sits at where[k]
    pool = [flat[i] for i in perm]
    sup_off = np.zeros(len(pool) + 1, dtype=np.int64)
    sup_off[1:] = np.cumsum([len(s) for s in pool])
    ids, ev_off, k = [], [0], 0
    for seqs in events:
        ids += [int(where[k + x]) for x in range(len(seqs))]
        k += len(seqs)
        ev_off.append(len(ids))
    # one event twice over: the ids of the first again
    ids += ids[:ev_off[1]]
    ev_off.append(len(ids))
    got = host_lib.ins_event_consensus_batch(
        np.concatenate(pool), sup_off, np.array(ids, dtype=np.int64),
        np.array(ev_off, dtype=np.int64))
    for seqs, g in zip(events + events[:1], got):
        assert np.array_equal(g, _ins_event_consensus(seqs))


def event_loci(rng, n_loci=3, n_reads=16, bb_len=1500, hotspots=24):
    """Loci built as test_device_vote._make_locus builds them, whose reads
    carry short insertions at many shared hotspots (a true 1-3 bp
    insertion, mutated in about half the reads that carry it, so that most
    events have no exact majority and run the DP) and single-base
    deletions beside a few of them, besides substitutions: many short
    insertion events a round, strong and pooled."""
    items = []
    for _ in range(n_loci):
        backbone = rng.integers(0, 4, bb_len).astype(np.int8)
        spots = np.sort(rng.choice(np.arange(50, bb_len - 50), hotspots,
                                   replace=False))
        truth = {int(j): rng.integers(0, 4, int(rng.integers(1, 4)))
                 .astype(np.int8) for j in spots}
        reads = {}
        for i in range(n_reads):
            lo = int(rng.integers(0, bb_len // 5))
            hi = int(rng.integers(4 * bb_len // 5, bb_len))
            parts, prev = [], lo
            for j in spots.tolist():
                if not lo < j < hi:
                    continue
                seg = backbone[prev:j].copy()
                if rng.random() < 0.15 and len(seg) > 2:
                    seg = np.delete(seg, len(seg) - 1 - int(
                        rng.integers(0, 2)))
                parts.append(seg)
                r = rng.random()
                if r < 0.4:
                    parts.append(truth[j])
                elif r < 0.85:
                    parts.append(_noisy(rng, truth[j], 0.6))
                prev = j
            parts.append(backbone[prev:hi])
            read = np.concatenate(parts).astype(np.int8)
            idx = rng.integers(0, len(read), max(1, len(read) // 60))
            read[idx] = rng.integers(0, 4, idx.size)
            if i % 3 == 2:
                read = revcomp_codes(read)
            reads[f"r{i}"] = read.astype(np.int8)
        aligner = Aligner(SeqDict([Sequence("bb", backbone)]), MAP_PB)
        alns = []
        for name, hits in aligner.map_batch(reads).items():
            prim = [h for h in hits if h.primary]
            if prim:
                alns.append((max(prim, key=lambda h: h.score), reads[name]))
        assert len(alns) >= 3
        items.append((backbone, alns))
    return items


def test_vote_many_on_loci_of_short_events(monkeypatch):
    """One native batch per vote_many call over every locus's events; the
    consensus equals the JAX vote and both consensus_votes byte for
    byte."""
    items = event_loci(np.random.default_rng(1717))
    calls = []
    orig = host_lib.ins_event_consensus_batch

    def spy(codes, sup_off, ev_sup, ev_off, stats=None):
        calls.append({"events": len(ev_off) - 1})
        return orig(codes, sup_off, ev_sup, ev_off, stats=calls[-1])

    monkeypatch.setattr(host_lib, "ins_event_consensus_batch", spy)
    got = vote_many(items, device="cpu")
    assert len(calls) == 1
    assert calls[0]["events"] >= 30 and calls[0]["dp_events"] >= 10
    want = jax_vote_many(items)
    for (bb, alns), g, w in zip(items, got, want):
        assert np.array_equal(g, w)
        assert np.array_equal(g, consensus_vote(bb, alns))
        assert np.array_equal(g, port_consensus_vote(bb, alns))
