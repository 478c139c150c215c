"""The port's span and counter recorder (telr_tpu_torch/utils/hoststats.py)
and the spans at its layer boundaries, on the CPU: no span is kept without a
profiler and the counters read as before; under a profiler each span carries
its thread, perf_counter bounds, cause and attributes; the pipeline's trace
holds the POA pool's spans, one a poa_consensus call; the vote's
insertion-event batch is one span inside its host finish, counting what the
JAX package's per-event rule counts; a wavefront launch counts the cells the
benchmark's roofline counts; profile_report names the idle stretches of a
trace."""

from __future__ import annotations

import collections
import gzip
import json
import os
import threading
import time

import numpy as np
import pytest

from telr_tpu_torch.tools.bench_pipeline import small_dataset
from telr_tpu_torch.utils import hoststats


def _profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU])


def _work():
    """Timers nested two deep, one count after the fact."""
    with hoststats.timer("outer", locus="a"):
        with hoststats.timer("inner", pairs=3):
            time.sleep(0.002)
        hoststats.add("after", 0.25, start=time.perf_counter())


def test_no_span_without_a_profiler():
    """Without a profiler nothing is kept, and the counters are the
    per-thread seconds and counts the timers always gave."""
    hoststats.reset()
    before = len(hoststats.spans())
    t0 = time.perf_counter()
    _work()
    _work()
    total = time.perf_counter() - t0
    assert not hoststats.recording()
    assert len(hoststats.spans()) == before
    assert hoststats.current() is None
    snap = hoststats.snapshot()
    assert sorted(snap) == ["after", "inner", "outer"]
    assert {k: v["n"] for k, v in snap.items()} == {
        "after": 2, "inner": 2, "outer": 2}
    assert snap["after"]["s"] == 0.5
    secs = hoststats._c()[0]
    assert 0.004 <= secs["inner"] <= secs["outer"] <= total


def test_spans_under_a_profiler():
    """Under a torch.profiler session each span has its thread, its
    perf_counter bounds, the span that caused it (the innermost open one,
    or `parent=` on a pool thread) and its attributes."""
    hoststats.drain_spans()
    prof = _profiler()
    prof.start()
    try:
        assert hoststats.recording()
        t0 = time.perf_counter()
        with hoststats.timer("outer", locus="a"):
            outer = hoststats.current()
            with hoststats.timer("inner", pairs=3):
                hoststats.annotate(cells=12)
            hoststats.add("after", 0.0, start=time.perf_counter())

            def pool():
                with hoststats.timer("pooled", parent=outer, locus="b"):
                    pass
            th = threading.Thread(target=pool)
            th.start()
            th.join()
        t1 = time.perf_counter()
    finally:
        prof.stop()
    got = {s.name: s for s in hoststats.drain_spans()}
    assert sorted(got) == ["after", "inner", "outer", "pooled"]
    out = got["outer"]
    assert out.id == outer and out.parent is None
    assert t0 <= out.t0 <= got["inner"].t0 <= got["inner"].t1 <= out.t1 <= t1
    assert got["inner"].parent == outer and got["after"].parent == outer
    assert got["inner"].attrs == {"pairs": 3, "cells": 12}
    assert got["pooled"].parent == outer
    assert got["pooled"].attrs == {"locus": "b"}
    assert got["pooled"].tid == th.ident != out.tid == threading.get_ident()
    # the thread the profiler instruments also has the span in its trace
    names = {e.name for e in prof.events()}
    assert "outer" in names and "inner" in names
    assert hoststats.current() is None


def test_reset_keeps_the_spans():
    hoststats.drain_spans()
    prof = _profiler()
    prof.start()
    try:
        _work()
        hoststats.reset()
    finally:
        prof.stop()
    assert [s.name for s in hoststats.spans()] == ["inner", "after", "outer"]
    assert hoststats.snapshot() == {}
    assert len(hoststats.drain_spans()) == 3 and hoststats.spans() == []


@pytest.fixture(scope="module")
def traced_run(tmp_path_factory):
    """The CLI on small_dataset (--device cpu) with --profile_dir, each
    native.poa_consensus call seen by a spy: (result, trace events, the
    spy's calls as (thread, segments, backbone length))."""
    from telr_tpu_torch import cli
    from telr_tpu_torch.io import native
    from telr_tpu_torch.pipeline import PROFILE_TRACE
    work = tmp_path_factory.mktemp("trace")
    (reads, ref, lib), _truth = small_dataset(str(work))
    calls = []
    orig = native.poa_consensus

    def spy(backbone, segs, *a, **kw):
        calls.append((threading.get_ident(), len(segs), len(backbone)))
        return orig(backbone, segs, *a, **kw)

    native.poa_consensus = spy
    try:
        res = cli.main(["-i", reads, "-r", ref, "-l", lib, "-o",
                        os.path.join(str(work), "out"), "--device", "cpu",
                        "--min_support", "3", "--profile_dir",
                        os.path.join(str(work), "p")])
    finally:
        native.poa_consensus = orig
    with gzip.open(os.path.join(str(work), "p", PROFILE_TRACE), "rt") as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    return res, events, calls


def _spans(events):
    return [e for e in events if e.get("cat") == "telr_span"]


def test_poa_spans_are_the_poa_calls(traced_run):
    """Each assembly.poa span in the pipeline's trace is one poa_consensus
    call, on the POA pool's thread, with its locus, its segments and its
    backbone, caused by its round's realignment span, and the row-form DP's
    rows and cells, which the binding puts on it."""
    res, events, calls = traced_run
    assert calls, "the run made no POA call"
    spans = _spans(events)
    by_id = {e["args"]["id"]: e for e in spans}
    poa = [e for e in spans if e["name"] == "assembly.poa"]
    assert collections.Counter(
        (e["tid"], e["args"]["segs"], e["args"]["backbone_len"])
        for e in poa) == collections.Counter(calls)
    loci = {r.locus_name for r in res.records}
    for e in poa:
        assert e["args"]["locus"] in loci
        assert e["args"]["dp_rows"] > 0
        assert e["args"]["dp_cells"] >= e["args"]["dp_rows"]
        assert e["args"]["late_pred_rows"] >= 0
        round_span = by_id[e["args"]["parent"]]
        assert round_span["name"] == "assembly.realign"
        assert round_span["args"]["round"] == e["args"]["round"]
        assert round_span["args"]["loci"] >= sum(
            1 for x in poa if x["args"]["parent"] == round_span["args"]["id"])
        assert round_span["tid"] != e["tid"]
        assert by_id[round_span["args"]["parent"]]["name"] == "assembly"
    # the stage spans stay the profiler's own, once each
    stages = [e for e in events if e["name"].startswith("telr_stage:")]
    assert len(stages) == len(res.stage_seconds)
    assert all(e.get("cat") != "telr_span" for e in stages)


def test_tail_and_vote_spans_in_the_trace(traced_run):
    """The tail stages and the vote have their spans, and the host engine's
    DP batches under them carry pairs and cells."""
    _res, events, _calls = traced_run
    spans = _spans(events)
    names = collections.Counter(e["name"] for e in spans)
    for name in ("assembly", "annotate", "annotate.families", "af",
                 "liftover", "vote.pack", "vote.device", "vote.finalize",
                 "vote.ins_events", "map_dispatch", "map_postprocess", "dp.host"):
        assert names[name] >= 1, name
    by_id = {e["args"]["id"]: e for e in spans}

    def stage(e):
        while e["args"]["parent"] in by_id:
            e = by_id[e["args"]["parent"]]
        return e["name"]

    dp_host = [e for e in spans if e["name"] == "dp.host"]
    assert {stage(e) for e in dp_host} >= {"assembly", "annotate", "af"}
    assert all(e["args"]["pairs"] >= 1 and e["args"]["cells"] > 0
               for e in dp_host)
    # the insertion events are one batch a vote round, inside its finish;
    # the per-event realignment span is gone
    ins = [e for e in spans if e["name"] == "vote.ins_events"]
    assert len(ins) == names["vote.finalize"]
    assert all(by_id[e["args"]["parent"]]["name"] == "vote.finalize"
               for e in ins)
    assert names["vote.ins_realign"] == 0


def test_vote_ins_events_span():
    """vote_many's insertion-event batch is one `vote.ins_events` span
    inside `vote.finalize`; its events, dp_events, pairs and cells equal a
    count of the JAX package's per-event calls on the same loci, and no
    `vote.ins_realign` span is left."""
    from telr_tpu.assembly import device_vote as jax_vote
    from telr_tpu_torch.assembly.device_vote import vote_many
    from test_torch_vote_events import event_loci, expected_stats
    items = event_loci(np.random.default_rng(1718), n_loci=2)
    seen = []
    orig = jax_vote._ins_event_consensus

    def count(seqs):
        seen.append(list(seqs))
        return orig(seqs)

    jax_vote._ins_event_consensus = count
    try:
        jax_vote.vote_many(items)
    finally:
        jax_vote._ins_event_consensus = orig
    want = dict(events=len(seen), **expected_stats(seen))
    assert want["dp_events"] > 0
    hoststats.drain_spans()
    prof = _profiler()
    prof.start()
    try:
        vote_many(items, device="cpu")
    finally:
        prof.stop()
    spans = hoststats.drain_spans()
    ins = [s for s in spans if s.name == "vote.ins_events"]
    fin = [s for s in spans if s.name == "vote.finalize"]
    assert len(ins) == len(fin) == 1
    assert ins[0].parent == fin[0].id
    assert fin[0].t0 <= ins[0].t0 <= ins[0].t1 <= fin[0].t1
    assert ins[0].attrs == want
    assert not [s for s in spans if s.name == "vote.ins_realign"]


def test_wave_launch_counts_the_rooflines_cells():
    """wave_launch's steps and useful cells are the sums over the pairs
    handed in, the cells benchmark/roofline.py counts; launched cells are
    the direction buffer's pairs x S_pad x width."""
    from benchmark.roofline import WAVEFRONT_OPS, wavefront_launch
    from telr_tpu_torch.kernels import dp
    from telr_tpu_torch.kernels import hopper_wavefront as hw
    rng = np.random.default_rng(5)
    pairs = [(rng.integers(0, 4, lq).astype(np.int8),
              rng.integers(0, 4, lt).astype(np.int8))
             for lq, lt in ((60, 70), (90, 30), (40, 40), (200, 380))]
    hoststats.drain_spans()
    prof = _profiler()
    prof.start()
    try:
        hw.wavefront_align(pairs, 128, dp.EXTEND, dp.DPParams(),
                           device="cpu")
    finally:
        prof.stop()
    launches = [s.attrs for s in hoststats.drain_spans()
                if s.name == "wave_launch"]
    # three step rungs (S <= 128, 512 and 1280): three launches
    assert sorted(a["pairs"] for a in launches) == [1, 1, 2]
    assert sum(a["steps"] for a in launches) == sum(
        len(q) + len(t) for q, t in pairs)
    _bytes, ops = wavefront_launch([(len(q), len(t)) for q, t in pairs], 128)
    assert sum(a["useful_cells"] for a in launches) == \
        ops // WAVEFRONT_OPS[True]
    for a in launches:
        assert a["width"] == 128 and a["useful_cells"] == a["steps"] * 128
        assert a["launched_cells"] == a["pairs"] * a["S_pad"] * 128
    assert {a["S_pad"] for a in launches} == {128, 512, 1280}


def _dispatch_spans(monkeypatch, gate):
    """The spans of one grouped dispatch of a few reads on the wavefront
    route (CPU), with the size gate at `gate` cells."""
    from telr_tpu_torch.config import MAP_PB
    from telr_tpu_torch.io.seqs import SeqDict, Sequence
    from telr_tpu_torch.kernels import mapper
    rng = np.random.default_rng(21)
    ref = rng.integers(0, 4, 4000).astype(np.int8)
    reads = {f"r{k}": ref[lo:lo + 220].copy()
             for k, lo in enumerate(rng.integers(0, 3700, 4))}
    monkeypatch.setattr(mapper, "_WAVE_MIN_CELLS", gate)
    al = mapper.Aligner(SeqDict([Sequence("chr", ref)]), MAP_PB,
                        use_wavefront=True, device="cpu")
    hoststats.drain_spans()
    prof = _profiler()
    prof.start()
    try:
        mapper.map_batch_grouped([(al, reads)])
    finally:
        prof.stop()
    return hoststats.drain_spans()


def test_dispatch_records_the_size_gates_side(monkeypatch):
    """map_dispatch carries the side the size gate sent the wavefront work
    to and the cells it weighed; the work runs there (wave_launch on the
    card's route, dp.host on the host engine)."""
    from telr_tpu_torch.kernels import mapper
    sides = {}
    for gate, side in ((mapper._WAVE_MIN_CELLS, "host"), (0, "card")):
        spans = _dispatch_spans(monkeypatch, gate)
        disp = [s for s in spans if s.name == "map_dispatch"]
        assert len(disp) == 1 and disp[0].attrs["side"] == side
        below = {s.name for s in spans if s.parent == disp[0].id}
        assert ("wave_launch" in below) == (side == "card")
        assert ("dp.host" in below) == (side == "host")
        sides[side] = disp[0].attrs["wave_cells"]
    assert sides["host"] == sides["card"] > 0


def test_profile_report_names_the_idle_gaps():
    """A canned trace: the stretches with no device event, longest first,
    each named by the innermost program span over it, with the part inside
    no span below the stage level."""
    from telr_tpu_torch.tools.profile_report import build_report
    ev = [
        {"ph": "X", "cat": "cpu_op", "name": "telr_stage:assembly",
         "ts": 0, "dur": 10_000_000},
        {"ph": "X", "cat": "telr_span", "name": "assembly", "ts": 0,
         "dur": 10_000_000, "args": {"id": 1, "parent": None}},
        {"ph": "X", "cat": "telr_span", "name": "assembly.poa",
         "ts": 1_000_000, "dur": 4_000_000, "args": {"id": 2, "parent": 1}},
        {"ph": "X", "cat": "telr_span", "name": "vote.finalize",
         "ts": 6_000_000, "dur": 1_000_000, "args": {"id": 3, "parent": 1}},
        {"ph": "X", "cat": "kernel", "name": "wavefront_dp_kernel",
         "ts": 5_500_000, "dur": 500_000},
    ]
    gaps = build_report({"traceEvents": ev})["idle_gaps"]
    # 0 to 5.5 s, then 6 to 10 s; a tie goes to the program's span
    assert [g["name"] for g in gaps] == ["assembly.poa", "assembly"]
    assert [g["seconds"] for g in gaps] == pytest.approx([5.5, 4.0])
    assert [g["unnamed_s"] for g in gaps] == pytest.approx([1.5, 3.0])
