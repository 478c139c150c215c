"""The readers of the program's own spans (benchmark/progspans.py), each on
canned spans put where the program keeps them (hoststats.spans), and their
silence on a program that keeps none."""

from __future__ import annotations

import os
import types

import pytest

from benchmark import progspans
from benchmark.registry import Registry
from benchmark.tests.conftest import REPO

NEW = ("assembly.poa_straggler_share", "assembly.realign_share",
       "assembly.vote_host_share", "tail.host_dp_share",
       "wavefront_dp.useful_cell_share.map",
       "wavefront_dp.useful_cell_share.loci", "device.idle_unnamed.map",
       "device.idle_unnamed.loci")


def span(sid, name, t0, t1, parent=None, tid=1, **attrs):
    return types.SimpleNamespace(id=sid, name=name, tid=tid, t0=t0, t1=t1,
                                 parent=parent, attrs=attrs)


def canned_spans():
    """A window from 100 to 110 s: assembly with two realign rounds and
    three POA calls on two pool threads, the vote, a tail stage with host
    DP batches under it, and two wavefront launches."""
    return [
        span(1, "assembly", 100.0, 106.0),
        span(2, "assembly.realign", 100.0, 101.0, 1, round=0, loci=2),
        span(3, "wave_launch", 100.2, 100.3, 2, pairs=2, steps=1000,
             width=128, S_pad=1280, useful_cells=128_000,
             launched_cells=2 * 1280 * 128),
        span(4, "wave_launch", 100.4, 100.5, 2, pairs=1, steps=500,
             width=512, S_pad=512, useful_cells=256_000,
             launched_cells=512 * 512),
        span(5, "vote.pack", 101.0, 101.5, 1),
        span(6, "vote.device", 101.5, 101.75, 1),
        span(7, "vote.stack", 101.5, 101.6, 6),
        span(8, "vote.finalize", 101.75, 102.0, 1),
        span(9, "vote.ins_realign", 101.8, 101.9, 8),
        span(10, "dp.host", 101.8, 101.85, 9, pairs=3, cells=900),
        span(11, "assembly.realign", 102.0, 102.5, 1, round=1, loci=2),
        span(12, "assembly.poa", 102.5, 104.0, 11, tid=2, locus="a"),
        span(13, "assembly.poa", 102.5, 103.0, 11, tid=3, locus="b"),
        span(14, "assembly.poa", 103.0, 103.5, 11, tid=3, locus="c"),
        span(15, "annotate", 106.0, 108.0),
        span(16, "map_dispatch", 106.0, 107.0, 15),
        span(17, "dp.host", 106.0, 106.5, 16, pairs=4, cells=1000),
        span(18, "dp.host", 106.25, 106.75, 16, pairs=4, cells=1000),
        span(19, "af", 108.0, 109.0),
        span(20, "dp.host", 108.0, 108.25, 19, pairs=1, cells=10),
    ]


@pytest.fixture
def tr(monkeypatch):
    from telr_tpu_torch.utils import hoststats
    spans = canned_spans()
    monkeypatch.setattr(hoststats, "spans", lambda: list(spans))
    dev = [{"name": "wavefront_dp_kernel", "t0": 100.2, "t1": 100.6},
           {"name": "vote", "t0": 101.6, "t1": 101.7}]
    return types.SimpleNamespace(w0=100.0, w1=110.0, window_s=10.0,
                                 spans=[], device=dev, counters={},
                                 launches=[])


@pytest.mark.parametrize("name,want", [
    # one POA open alone: 104.0 - 103.5
    ("assembly.poa_straggler_share", 0.05),
    ("assembly.realign_share", 0.15),
    # pack, stack and finalize: 101.0-101.6 and 101.75-102.0
    ("assembly.vote_host_share", 0.085),
    # dp.host under annotate and af, not the vote's: 106.0-106.75, 108-108.25
    ("tail.host_dp_share", 0.1),
    ("wavefront_dp.useful_cell_share.map",
     384_000 / (2 * 1280 * 128 + 512 * 512)),
    ("wavefront_dp.useful_cell_share.loci",
     384_000 / (2 * 1280 * 128 + 512 * 512)),
    # idle and in no span below the stage level: 104-106, 107-108,
    # 108.25-110
    ("device.idle_unnamed.map", 0.475),
    ("device.idle_unnamed.loci", 0.475)])
def test_reader_on_canned_spans(tr, name, want):
    reg = Registry(REPO, os.path.join(REPO, "benchmark"))
    assert reg.reader(name).read(tr) == pytest.approx(want)


@pytest.mark.parametrize("name", NEW)
def test_reader_is_silent_on_a_program_without_spans(tr, monkeypatch, name):
    """A program that keeps no spans (the parent of this recorder) leaves
    each metric out, and raises nothing."""
    from telr_tpu_torch.utils import hoststats
    monkeypatch.delattr(hoststats, "spans")
    reg = Registry(REPO, os.path.join(REPO, "benchmark"))
    assert reg.reader(name).read(tr) is None


def test_named_gaps(tr):
    """The idle stretches, longest first, named by the innermost span over
    each, with the part inside no span below the stage level."""
    from telr_tpu_torch.utils import hoststats
    gaps = progspans.named_gaps(tr.device, hoststats.spans(), tr.w0,
                                tr.w1, top=4)
    # 101.7-110: assembly alone covers half of it; inside no span below the
    # stage level: 104-106, 107-108 and 108.25-110
    assert gaps[0] == pytest.approx(["assembly", 8.3, 4.75])
    # 100.6-101.6: vote.pack is the shortest span over half of it
    assert gaps[1] == pytest.approx(["vote.pack", 1.0, 0.0])
    assert gaps[2] == pytest.approx(["assembly.realign", 0.2, 0.0])
    assert len(gaps) == 3
