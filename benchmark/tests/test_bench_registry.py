"""The harness is driven by data: a configuration, a cell and a per-layer
metric are found from added files and entries alone; BENCHMARK.json keeps
to its contract's shape; every metric reader reads a canned trace; and the
import check compares whole top-level names."""

from __future__ import annotations

import json
import os
import sys
import types

import pytest

from benchmark.registry import Registry
from benchmark.tests.conftest import REPO


def test_added_files_are_found(tmp_path):
    from benchmark.tests.conftest import make_root
    root = make_root(str(tmp_path))
    bench = os.path.join(root, "benchmark")
    with open(os.path.join(bench, "metrics", "map.extra_count.py"),
              "w") as f:
        f.write("def read(tr):\n    return float(len(tr.spans))\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["per_layer"].append({
        "name": "map.extra_count", "unit": "spans", "better": "lower",
        "source": "program_span", "layer": "device", "moves": "map_Mb_per_s"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    reg = Registry(root, bench)
    cell = reg.cell("tiny-map")
    assert (cell["config"], cell["traffic"]) == ("tiny-pacbio", "map")
    assert reg.config("tiny-pacbio")["genome_size"] == 150_000
    assert hasattr(reg.traffic("map"), "one_pass")
    names = [m["name"] for m in reg.metrics("tiny-map", trace=True)]
    assert "map.extra_count" in names and "map.plan_share" in names
    assert "assembly.poa_share" not in names
    assert "map.extra_count" not in [
        m["name"] for m in reg.metrics("tiny-loci", trace=True)]
    tr = types.SimpleNamespace(spans=[("a", 0, 0.0, 1.0)])
    assert reg.reader("map.extra_count").read(tr) == 1.0
    assert [m["name"] for m in reg.metrics("tiny-map", trace=False)] == [
        "map_Mb_per_s", "setup_s"]


def test_benchmark_json_shape():
    reg = Registry(REPO, os.path.join(REPO, "benchmark"))
    spec = reg.spec
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert "setup_s" in [m["name"] for m in spec["end_to_end"]]
    cells = {w["name"] for w in spec["workloads"]}
    for w in spec["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        cell = reg.cell(w["name"])
        assert cell["limits"]
        reg.config(w["config"])
        e2e = reg.metrics(w["name"], trace=False)
        assert len(e2e) >= 2 and len(reg.metrics(w["name"], trace=True)) >= 1
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert set(m.get("workloads", [])) <= cells
        if m in spec["per_layer"]:
            assert os.path.isfile(reg.reader(m["name"]).__file__)
        if m["name"].rpartition(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"


def canned():
    """Two passes of a window from 0 to 10 s: device events, spans on two
    threads, the hoststats counters and two wavefront launches."""
    dev = [{"name": "wavefront_dp_kernel", "t0": 1.0, "t1": 1.5},
           {"name": "wavefront_dp_kernel", "t0": 1.25, "t1": 2.0},
           {"name": "Memcpy HtoD (Pageable -> Device)", "t0": 5.0,
            "t1": 5.5}]
    spans = [("pass", 1, 0.0, 10.0), ("assembly.poa", 1, 2.0, 4.0),
             ("assembly.poa", 2, 3.0, 5.0), ("assembly.vote", 1, 5.0, 6.0),
             ("tail.annotate", 1, 7.0, 8.0), ("tail.af", 1, 8.0, 8.5),
             ("tail.liftover", 1, 8.5, 9.5)]
    return types.SimpleNamespace(
        w0=0.0, w1=10.0, window_s=10.0, spans=spans, device=dev,
        counters={"plan_pool": {"s": 4.0, "n": 2},
                  "wave_prep": {"s": 2.5, "n": 40}},
        launches=[{"pairs": [(1000, 1100)], "width": 128},
                  {"pairs": [(500, 400), (300, 300)], "width": 256}])


@pytest.mark.parametrize("name,want", [
    ("map.plan_share", 0.4), ("map.wave_prep_share", 0.25),
    ("device.idle.map", 0.85), ("device.idle.loci", 0.85),
    # a split a later cell adds shares the reader without a file of its own
    ("device.idle.refmask", 0.85),
    ("assembly.poa_share", 0.3), ("assembly.vote_share", 0.1),
    ("tail.stage_share", 0.25)])
def test_readers_on_a_canned_trace(name, want):
    reg = Registry(REPO, os.path.join(REPO, "benchmark"))
    assert reg.reader(name).read(canned()) == pytest.approx(want)


@pytest.mark.parametrize("name", ["wavefront_dp_roofline.map",
                                  "wavefront_dp_roofline.loci"])
def test_roofline_reader(name):
    from benchmark.roofline import bound_s, wavefront_launch
    reg = Registry(REPO, os.path.join(REPO, "benchmark"))
    tr = canned()
    least = (bound_s(*wavefront_launch([(1000, 1100)], 128))
             + bound_s(*wavefront_launch([(500, 400), (300, 300)], 256)))
    assert reg.reader(name).read(tr) == pytest.approx(100 * least / 1.25)
    # nothing to read: no launch, or no kernel time
    assert reg.reader(name).read(types.SimpleNamespace(
        device=tr.device, launches=[])) is None
    assert reg.reader(name).read(types.SimpleNamespace(
        device=[], launches=tr.launches)) is None


def test_readers_return_nothing_when_nothing_ran():
    reg = Registry(REPO, os.path.join(REPO, "benchmark"))
    empty = types.SimpleNamespace(w0=0.0, w1=1.0, window_s=1.0, spans=[],
                                  device=[], counters={}, launches=[])
    for m in reg.spec["per_layer"]:
        assert reg.reader(m["name"]).read(empty) is None


def test_import_check_compares_whole_names():
    from benchmark.run import forbidden_modules
    assert forbidden_modules(["telr_tpu_torch", "telr_tpu_torch.cli",
                              "jaxtyping", "flax_like", "numpy"]) == []
    assert forbidden_modules(["telr_tpu.cli", "jax.numpy", "jaxlib",
                              "flax", "telr_tpu_torch"]) == [
        "flax", "jax", "jaxlib", "telr_tpu"]


def test_the_harness_loads_no_jax(tmp_path):
    """A fresh interpreter that imports every module of the harness and the
    port's entry points a run calls holds none of the forbidden names."""
    import subprocess
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import benchmark.run, benchmark.calibrate, benchmark.inputs\n"
        "import benchmark.registry as r\n"
        "reg = r.Registry()\n"
        "[reg.traffic(k) for k in ('map', 'loci')]\n"
        "[reg.reader(m['name']) for m in reg.spec['per_layer']]\n"
        "import telr_tpu_torch.pipeline, telr_tpu_torch.cli\n"
        "print(benchmark.run.forbidden_modules())\n" % REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
