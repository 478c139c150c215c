"""The port's measurement and evaluation tools (telr_tpu_torch/tools/) on the
CPU, at small sizes.

- genome_eval.simulate_dataset writes the FASTA files of
  tools/genome_eval.py's simulate_dataset byte for byte, with the same truth,
  for PacBio and ONT reads, two chromosomes and the hard library;
- bench_pipeline.synthetic_dataset equals bench_pipeline.py's;
- genome_eval.run_eval(device="cpu") writes the JAX tool's report keys and,
  on the host route, its very scores; profile_stage reads its workdir;
- bench, stage1_bench and bench_pipeline print one JSON line last with their
  keys.

Tolerance: none (bytes, integers and equal scores)."""

import importlib.util
import json
import os

import numpy as np
import pytest

import bench_pipeline as root_bench_pipeline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_genome_eval():
    """tools/genome_eval.py (its simulate_dataset and run_eval import the JAX
    package), loaded by file path."""
    spec = importlib.util.spec_from_file_location(
        "jax_genome_eval", os.path.join(ROOT, "tools", "genome_eval.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _same_truth(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            if isinstance(g[k], np.ndarray):
                assert np.array_equal(g[k], w[k])
            else:
                assert g[k] == w[k], k


# each at the least size that tools/genome_eval.py can plant in: it draws
# insertion sites 50 kb from either end of a chromosome
SIM_CASES = {
    "pacbio": dict(size=120_000),
    "ont": dict(size=120_000, ont_profile=True),
    "chroms2": dict(size=240_000, chroms=2),
    "hard": dict(size=120_000, hard=True),
}


@pytest.mark.parametrize("case", list(SIM_CASES))
def test_simulate_dataset_equals_the_jax_tool(case, tmp_path):
    from telr_tpu_torch.tools import genome_eval
    kw = dict(coverage=4, n_ins=4, seed=5, **SIM_CASES[case])
    got = genome_eval.simulate_dataset(workdir=str(tmp_path / "port"), **kw)
    want = _jax_genome_eval().simulate_dataset(
        workdir=str(tmp_path / "jax"), **kw)
    for p, q in zip(got[:3], want[:3]):
        assert os.path.basename(p) == os.path.basename(q)
        assert _read(p) == _read(q), os.path.basename(p)
    _same_truth(got[3], want[3])
    assert got[4:] == want[4:]
    with open(got[0]) as f:
        names = [ln[1:].strip() for ln in f if ln.startswith(">")]
    assert names == (["chr1", "chr2"] if case == "chroms2" else ["chr2L"])


def test_synthetic_dataset_equals_bench_pipeline(tmp_path):
    from telr_tpu_torch.tools import bench_pipeline
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got = bench_pipeline.synthetic_dataset(str(tmp_path / "port"))
    want = root_bench_pipeline.synthetic_dataset(str(tmp_path / "jax"))
    for p, q in zip(got[:3], want[:3]):
        assert _read(p) == _read(q), os.path.basename(p)
    assert got[3] == want[3]


def _keys(d):
    """The nested key set of a report (lists of records excepted)."""
    return {k: _keys(v) if isinstance(v, dict) else None
            for k, v in d.items()}


@pytest.fixture(scope="module")
def evals(tmp_path_factory):
    from telr_tpu_torch.tools import genome_eval
    work = tmp_path_factory.mktemp("eval")
    kw = dict(size=120_000, coverage=10, n_ins=2, seed=1, threads=1)
    port = genome_eval.run_eval(workdir=str(work / "port"), device="cpu",
                                **kw)
    want = _jax_genome_eval().run_eval(workdir=str(work / "jax"),
                                       out_path=str(work / "jax.json"), **kw)
    return port, want, str(work / "port")


def test_run_eval_writes_the_jax_tools_keys(evals):
    port, want, workdir = evals
    got = _keys(port)
    for extra in ("device", "launches", "stages", "workdir"):
        got.pop(extra)
    got["workload"].pop("chroms")
    assert got == _keys(want)
    assert port["device"] == "cpu"
    assert set(port["launches"]) == {"wavefront_dp", "wavefront_walk",
                                     "rowband_dp", "rowband_walk"}
    # auto routing on the CPU: every stage on the host engine
    assert set(port["stages"]) == set(port["stage_seconds"])
    for rec in port["stages"].values():
        assert rec["launches"] == dict.fromkeys(port["launches"], 0)
        assert rec["dispatches"] == []
    with open(os.path.join(workdir, "genome_eval.json")) as f:
        assert json.load(f)["score"] == port["score"]


def test_run_eval_scores_equal_the_jax_tools(evals):
    """Host route on both sides: the same calls, so the same scores."""
    port, want, _workdir = evals
    assert port["score"] == want["score"]
    assert port["n_calls"] == want["n_calls"] >= 1
    assert port["score"]["f1"] == 1.0


def test_profile_stage_reads_the_eval_workdir(evals, capsys):
    from telr_tpu_torch.tools import profile_stage
    port, _want, workdir = evals
    profile_stage.main(["--stage", "assembly", "--workdir", workdir,
                        "--device", "cpu", "--lines", "5"])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["stage"] == "assembly" and rep["presets"] == "pacbio"
    assert rep["loci"] >= rep["passed"] >= port["n_calls"] >= 1
    split = rep["split"]
    assert split["poa_calls"] > 0 and split["poa_s"] > 0
    assert split["vote_s"] > 0
    assert split["poa_s"] + split["prep_s"] + split["vote_s"] <= rep["wall_s"]
    assert rep["top_own_time"]


@pytest.mark.parametrize("stage", ["alignment", "annotate", "af"])
def test_profile_stage_other_stages(evals, stage, capsys):
    from telr_tpu_torch.tools import profile_stage
    _port, _want, workdir = evals
    profile_stage.main(["--stage", stage, "--workdir", workdir, "--device",
                        "cpu", "--lines", "3", "--max-reads", "10"])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["stage"] == stage and rep["wall_s"] > 0
    assert "split" not in rep


BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "dispatch",
              "window_cols", "band512_gcells_s"}


def test_bench_prints_one_json_line(capsys):
    from telr_tpu_torch.tools import bench
    bench.main(["--device", "cpu", "--pairs", "4", "--lq", "160", "--lt",
                "240", "--width", "128", "--trials", "3", "--iters", "2",
                "--check-pairs", "4"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert BENCH_KEYS <= set(rec)
    assert len(rec["trials_gcells_s"]) == 3
    assert rec["min"] <= rec["value"] <= rec["max"]
    assert rec["window_cols"] == 256 and rec["checked_pairs"] == 4
    assert rec["plain_ms"] > 0
    assert 0 < rec["bound_ms"] and rec["bound_by"] in ("bytes", "operations")
    assert rec["bound_share"] == pytest.approx(rec["bound_ms"]
                                               / rec["ms_per_launch"])
    # the counters count CUDA launches only
    assert rec["launches"] == {"wavefront_dp_scores": 0}
    assert rec["traceback"]["pairs_per_call"] == 12
    assert {"wave_prep", "wave_launch", "wave_device_wait",
            "wave_decode"} <= set(rec["traceback"]["split_last_call"])
    assert rec["device"] == "cpu"


def test_bench_workload_is_bench_pys():
    from telr_tpu_torch.tools import bench
    pairs, guides = bench.workload()
    assert len(pairs) == 64
    assert all(len(q) == 2048 and len(t) == 3072 for q, t in pairs)
    assert all(np.array_equal(g[0], np.arange(256, 1792, 512))
               for g in guides)
    rng = np.random.default_rng(0)
    t = rng.integers(0, 4, 3072).astype(np.int8)
    assert np.array_equal(pairs[0][1], t)
    assert (pairs[0][0] != t[:2048]).sum() <= 200


def test_stage1_bench_prints_one_json_line(tmp_path, capsys):
    from telr_tpu_torch.tools import stage1_bench
    argv = ["--device", "cpu", "--size", "150000", "--coverage", "3",
            "--threads", "1", "--repeat", "2", "--workdir", str(tmp_path)]
    stage1_bench.main(argv)
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [p["pass"] for p in rec["passes"]] == [0, 1]
    assert rec["passes"][0]["alignments"] == rec["passes"][1]["alignments"]
    assert "map_dispatch" in rec["passes"][0]["breakdown"]
    assert rec["device"] == "cpu" and rec["wavefront"] is False
    assert os.path.isfile(tmp_path / "s1_150000_3_11.npz")
    # the second call reads the cached reads
    stage1_bench.main(argv[:-4] + ["--repeat", "1", "--workdir",
                                   str(tmp_path)])
    again = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert again["workload"] == rec["workload"]
    assert again["passes"][0]["alignments"] == rec["passes"][0]["alignments"]


def test_bench_pipeline_prints_one_json_line(tmp_path, capsys):
    from telr_tpu_torch.tools import bench_pipeline
    bench_pipeline.main(["--synthetic", "--device", "cpu", "--workdir",
                         str(tmp_path)])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"wall_s", "aligned_bases_per_s", "loci_assembled_per_s",
            "recall", "calls", "stages_s"} <= set(rec)
    assert rec["recall"] == 1.0 and rec["calls"] == 3
    assert rec["device"] == "cpu" and rec["wavefront_stages"] is None


def test_gate_sweep_prints_one_json_line(tmp_path, capsys):
    """The sweep's record at one size (the plain kernels stand in for the
    card on the CPU): both routes timed at both score sets."""
    from telr_tpu_torch.tools import gate_sweep
    gate_sweep.main(["--device", "cpu", "--size", "150000", "--coverage",
                     "3", "--threads", "1", "--reps", "1", "--max-cells",
                     "1.5e6", "--workdir", str(tmp_path)])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["device"] == "cpu" and rec["threads"] == 1
    assert set(rec["score_sets"]) == {"reads", "library"}
    assert rec["score_sets"]["library"]["params"] == [2, 3, 5, 2]
    for sset in rec["score_sets"].values():
        (row,) = sset["sizes"]
        assert 1 << 20 <= row["cells"] and row["jobs"] >= 1
        for route in ("host_s", "wavefront_s"):
            assert len(row[route]["runs"]) == 1 and row[route]["min"] > 0
        assert set(sset["crossover"]) == {"cells", "clear_of_spread"}
