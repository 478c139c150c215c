"""Fixtures of the benchmark's own tests.  `tiny_root` is a checkout-like
directory holding a copy of benchmark/ and a BENCHMARK.json that adds a tiny
configuration and a cell of each traffic kind to the real ones, as files
and entries alone: the harness runs them on the CPU (`--device cpu`)."""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

TINY = {"genome_size": 150_000, "coverage": 20, "n_insertions": 2,
        "threads": 2}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """The first CUDA card, or a skip: decided here, never at import."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


def make_root(path: str) -> str:
    """A copy of benchmark/ under `path` with the tiny configuration and
    the cells tiny-map and tiny-loci added beside the real ones."""
    shutil.copytree(os.path.join(REPO, "benchmark"),
                    os.path.join(path, "benchmark"),
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        spec = json.load(f)
    cdir = os.path.join(path, "benchmark", "configs")
    with open(os.path.join(cdir, "dmel-pacbio-3mb.json")) as f:
        cfg = json.load(f)
    cfg.update(TINY)
    with open(os.path.join(cdir, "tiny-pacbio.json"), "w") as f:
        json.dump(cfg, f)
    spec["configs"].append({
        "name": "tiny-pacbio", "source": "benchmark/tests/conftest.py",
        "file": "benchmark/configs/tiny-pacbio.json",
        "reduced": sorted(TINY), "why": "the CPU tests' size"})
    wdir = os.path.join(path, "benchmark", "workloads")
    for kind in ("map", "loci"):
        with open(os.path.join(wdir, f"pacbio-{kind}.json")) as f:
            cell = json.load(f)
        if kind == "map":
            cell["traffic_params"].update(warm_reads=16, judged_reads=8,
                                          judged_longest=1)
        with open(os.path.join(wdir, f"tiny-{kind}.json"), "w") as f:
            json.dump(cell, f)
        spec["workloads"].append({
            "name": f"tiny-{kind}", "config": "tiny-pacbio", "traffic": kind,
            "chips": 1, "why": "the CPU tests' size"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [w.replace("pacbio-", "tiny-")
                               for w in m["workloads"]
                               if w.startswith("pacbio-")]
    with open(os.path.join(path, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f, indent=1)
    return path


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("checkout")))


def run_cell(root, cell, capsys, seed=5, trace=0, seconds=1):
    """benchmark/run.py's main on the CPU, in this process: (rc, the last
    line of standard output as JSON)."""
    from benchmark import run as bench_run
    rc = bench_run.main(["--workload", cell, "--seed", str(seed),
                         "--seconds", str(seconds), "--trace", str(trace),
                         "--device", "cpu", "--root", root])
    out = capsys.readouterr().out.strip().splitlines()
    return rc, (json.loads(out[-1]) if out else None)
