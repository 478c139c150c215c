"""The harness end to end on the CPU (`--device cpu`, the tiny
configuration): each traffic driver runs outside the timed contract and
prints the contract's last line; with the timed path broken underneath, as
each fault a cell can have would break it, `correct` comes out false; a run
without a card, or in a directory with the benchmark alone, prints no
result.  The card test runs the tiny map cell on the first CUDA card."""

from __future__ import annotations

import dataclasses
import os
import shutil
import subprocess
import sys

import pytest

from benchmark.registry import Registry
from benchmark.tests.conftest import REPO, run_cell

KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


@pytest.mark.parametrize("cell", ["tiny-map", "tiny-loci"])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_rehearses_on_the_cpu(tiny_root, capsys, cell, trace):
    rc, line = run_cell(tiny_root, cell, capsys, trace=trace)
    assert rc == 3                      # a rehearsal is never a result
    assert KEYS <= set(line) and list(line)[-1] == "checks"
    assert line["device"]["platform"] == "cpu"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] >= 0
    reg = Registry(tiny_root, os.path.join(tiny_root, "benchmark"))
    names = {m["name"] for m in reg.metrics(cell, trace=bool(trace))}
    assert set(line["metrics"]) <= names
    if not trace:
        assert set(line["metrics"]) == names
        assert all(m["value"] > 0 for m in line["metrics"].values())
    elif cell == "tiny-loci":
        assert {"assembly.poa_share", "assembly.vote_share",
                "tail.stage_share"} <= set(line["metrics"])
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def _map_fault(monkeypatch, kind):
    from telr_tpu_torch.kernels.mapper import Aligner
    orig = Aligner.map_batch_parallel

    def broken(self, queries, processes, max_hits=None):
        if kind == "half_batch":
            keep = sorted(queries)[::2]
            return orig(self, {n: queries[n] for n in keep}, processes,
                        max_hits)
        res = orig(self, queries, processes, max_hits)
        return {n: [dataclasses.replace(h, tstart=h.tstart + 5,
                                        tend=h.tend + 5) for h in hits]
                for n, hits in res.items()}

    monkeypatch.setattr(Aligner, "map_batch_parallel", broken)


def _loci_fault(monkeypatch, kind):
    if kind == "state_unchanged":
        from telr_tpu_torch.assembly import device_vote
        from telr_tpu_torch.io import native
        monkeypatch.setattr(device_vote, "vote_many",
                            lambda items, device=None: [b for b, _ in items])
        monkeypatch.setattr(native, "has_poa", lambda: False)
    elif kind == "half_batch":
        from telr_tpu_torch.assembly import local
        orig = local.assemble_all
        monkeypatch.setattr(local, "assemble_all",
                            lambda records, *a, **k: orig(records[::2], *a,
                                                          **k))
    else:
        from telr_tpu_torch.liftover import engine
        orig = engine.liftover

        def moved(*a, **k):
            lift, bed, summary = orig(*a, **k)
            for item in lift:
                info = item.get("report")
                if info and info.get("type") == "non-reference":
                    info["start"] += 1000
                    info["end"] += 1000
            return lift, bed, summary

        monkeypatch.setattr(engine, "liftover", moved)


@pytest.mark.parametrize("cell,fault", [
    ("tiny-map", "half_batch"), ("tiny-map", "answer_altered"),
    ("tiny-loci", "state_unchanged"), ("tiny-loci", "half_batch"),
    ("tiny-loci", "answer_altered")])
def test_a_broken_timed_path_is_not_correct(tiny_root, capsys, monkeypatch,
                                            cell, fault):
    run_cell(tiny_root, cell, capsys)       # the set-up cache, unbroken
    (_map_fault if cell == "tiny-map" else _loci_fault)(monkeypatch, fault)
    rc, line = run_cell(tiny_root, cell, capsys)
    assert rc == 3 and line["correct"] is False, line["checks"]


def test_no_card_prints_no_result(tiny_root):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    out = subprocess.run(
        [sys.executable, os.path.join(tiny_root, "benchmark", "run.py"),
         "--workload", "tiny-map", "--seed", "5", "--seconds", "1",
         "--trace", "0", "--root", tiny_root], capture_output=True,
        text=True, timeout=300, cwd=tiny_root)
    assert out.returncode == 2 and out.stdout.strip() == ""


def test_the_benchmark_alone_prints_no_result(tmp_path):
    """A directory with BENCHMARK.json and benchmark/ only: the program is
    missing, so the run fails before any result."""
    shutil.copytree(os.path.join(REPO, "benchmark"),
                    tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "pacbio-map",
         "--seed", "5", "--seconds", "1", "--trace", "0", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path),
        env=env)
    assert out.returncode not in (0, 3) and out.stdout.strip() == ""


@pytest.mark.card
def test_tiny_map_on_the_card(card, tiny_root, capsys):
    from benchmark import run as bench_run
    rc = bench_run.main(["--workload", "tiny-map", "--seed", "7",
                         "--seconds", "1", "--trace", "1", "--root",
                         tiny_root])
    out = capsys.readouterr().out.strip().splitlines()
    import json
    line = json.loads(out[-1])
    assert rc == 0 and line["correct"] is True
    assert line["device"]["platform"] == "gpu" and line["device"]["busy_s"] > 0
