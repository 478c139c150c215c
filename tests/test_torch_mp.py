"""The port's multi-process slice against the JAX package: the genome region
map, the `_mp` collectives on torch.distributed (gloo) at 1, 2 and 4
processes, and run_pipeline_multiprocess at 1 and 2 processes against the
JAX runner at 1.  Every comparison is exact (tolerance 0: equal integers,
equal bytes).

The JAX runner runs as a subprocess of tools/two_process_pipeline.py in that
tool's own environment (one XLA host device): this process has the 8 virtual
devices of tests/conftest.py, and the JAX runner builds its global arrays
from one local row a process."""

import importlib.util
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

import bench_pipeline
import jax

from telr_tpu.dist import mesh as jmesh
from telr_tpu.dist import redistribute as jred
from telr_tpu.dist import regions as jregions
from telr_tpu.io.seqs import SeqDict as JSeqDict, Sequence as JSequence
from telr_tpu_torch.dist import mesh as tmesh
from telr_tpu_torch.dist import redistribute as tred
from telr_tpu_torch.dist import regions as tregions
from telr_tpu_torch.io.seqs import SeqDict, Sequence
from telr_tpu_torch.tools import two_process_pipeline as tpp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MP_FILES = ["reads.telr.json", "reads.telr.expanded.json", "reads.telr.vcf",
            "reads.telr.bed", "reads.telr.te.fasta",
            "reads.telr.contig.fasta", "reads.loci_eval.tsv"]


# ---------------------------------------------------------------- regions

@pytest.mark.parametrize("seed", range(4))
def test_region_map_equals_jax(seed):
    rng = np.random.default_rng(seed)
    lens = rng.integers(1_000, 400_000, size=int(rng.integers(1, 6)))
    names = [f"chr{k}" for k in range(len(lens))]
    port = SeqDict([Sequence(n, np.zeros(ln, np.int8))
                    for n, ln in zip(names, lens)])
    ref = JSeqDict([JSequence(n, np.zeros(ln, np.int8))
                    for n, ln in zip(names, lens)])
    for n_regions in (1, 2, 3, 4, 8):
        got = tregions.RegionMap(port, n_regions)
        want = jregions.RegionMap(ref, n_regions)
        assert np.array_equal(got.bounds, want.bounds)
        for _ in range(200):
            c = names[int(rng.integers(len(names)))]
            pos = int(rng.integers(-300_000, lens.max() + 300_000))
            span = int(rng.integers(0, 50_000))
            halo = int(rng.choice([0, 1_000, tregions.DEFAULT_HALO]))
            assert got.region_of(c, pos) == want.region_of(c, pos)
            assert got.dests_for_span(c, pos, pos + span, halo) \
                == want.dests_for_span(c, pos, pos + span, halo)
    assert tregions.DEFAULT_HALO == jregions.DEFAULT_HALO


# ------------------------------------------------------------ collectives

MAX_BYTES, CHUNK = 4096, 100

_COLLECTIVE_WORKER = """
import datetime, pickle, sys
from telr_tpu_torch.dist import mesh, redistribute as red
n, r, port, case_path, out_path = sys.argv[1:6]
n, r = int(n), int(r)
mesh.init_distributed(f"localhost:{port}", n, r,
                      timeout=datetime.timedelta(seconds=90))
with open(case_path, "rb") as f:
    case = pickle.load(f)
pm = mesh.process_mesh("cpu")
got = red.redistribute_payloads_mp(pm, case["items"][r],
                                   max_bytes=case["max_bytes"])
blobs = red.exchange_bytes_mp(pm, case["blobs"][r], chunk=case["chunk"],
                              max_bytes=case["max_bytes"])
with open(out_path, "wb") as f:
    pickle.dump((got, blobs), f)
"""


def _collective_case(n, seed=5):
    """Seeded items with unique (locus, kind, rank) keys spread over n
    source processes, and seeded byte blobs for every (src, dst)."""
    rng = np.random.default_rng(seed + n)
    keys = {(int(rng.integers(0, 40)), int(rng.integers(0, 2)),
             int(rng.integers(0, 12))) for _ in range(160)}
    items = [[] for _ in range(n)]
    for li, kind, rank in sorted(keys):
        codes = rng.integers(-1, 4, size=int(rng.integers(0, 300))
                             ).astype(np.int8)
        items[int(rng.integers(n))].append((li, rank, kind, codes))
    blobs = [[rng.integers(0, 256, size=int(rng.integers(0, 1000)),
                           dtype=np.uint8).tobytes() for _d in range(n)]
             for _s in range(n)]
    return items, blobs


@pytest.mark.parametrize("n", [1, 2, 4])
def test_mp_collectives_equal_jax(n, tmp_path):
    """redistribute_payloads_mp on each of n gloo processes gives exactly
    what the JAX package's redistribute_payloads gives that shard on an
    n-device host mesh; exchange_bytes_mp delivers every blob.  A small
    max_bytes and chunk make several rounds and chunks.  One process takes
    the self-route, with no process group."""
    if len(jax.devices()) < 4:
        pytest.skip("needs the 8 virtual host devices of tests/conftest.py")
    items, blobs = _collective_case(n)
    want = jred.redistribute_payloads(jmesh.make_mesh(n), items,
                                      max_bytes=MAX_BYTES)
    if n == 1:
        pm = tmesh.process_mesh("cpu")
        results = [(tred.redistribute_payloads_mp(pm, items[0],
                                                  max_bytes=MAX_BYTES),
                    tred.exchange_bytes_mp(pm, blobs[0], chunk=CHUNK,
                                           max_bytes=MAX_BYTES))]
    else:
        case = tmp_path / "case.pkl"
        with open(case, "wb") as f:
            pickle.dump({"items": items, "blobs": blobs,
                         "max_bytes": MAX_BYTES, "chunk": CHUNK}, f)
        port = str(tpp.free_port())
        outs = [tmp_path / f"rank{r}.pkl" for r in range(n)]
        tpp.run_ranks([[sys.executable, "-c", _COLLECTIVE_WORKER, str(n),
                        str(r), port, str(case), str(outs[r])]
                       for r in range(n)], timeout_s=180)
        results = []
        for out in outs:
            with open(out, "rb") as f:
                results.append(pickle.load(f))
    assert sum(len(w) for w in want) == sum(len(i) for i in items)
    for r, (got, got_blobs) in enumerate(results):
        assert len(got) == len(want[r])
        for g, w in zip(got, want[r]):
            assert g[:3] == w[:3] and g[3].dtype == np.int8
            assert np.array_equal(g[3], w[3])
        assert got_blobs == [blobs[s][r] for s in range(n)]


def test_mp_geometry_equals_jax():
    """The round geometry (l_pad, capacity) and the packed send row equal
    the JAX package's for the same items."""
    items, _blobs = _collective_case(4)
    for cap, l_pad in ((2, 512), (8, 512), (64, 1024)):
        got = tred._pack_local_row(items[1][:cap], 4, cap, l_pad)
        want = jred._pack_local_row(items[1][:cap], 4, cap, l_pad)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)
    with pytest.raises(ValueError, match="capacity"):
        tred._pack_local_row([(0, 0, 0, np.zeros(3, np.int8))] * 2, 1, 1,
                             128)


def test_mp_collectives_refuse_a_mesh_of_another_size():
    with pytest.raises(ValueError, match="process_mesh"):
        tred.redistribute_payloads_mp(tmesh.make_mesh(2, device="cpu"), [])


def test_a_dead_rank_ends_the_run(tmp_path):
    """A rank that dies while its peer waits in the process group ends the
    run with an error at once, and the waiting peer is killed."""
    import time
    port = str(tpp.free_port())
    waiter = ("import datetime\nfrom telr_tpu_torch.dist import mesh\n"
              f"mesh.init_distributed('localhost:{port}', 2, 1, "
              "timeout=datetime.timedelta(seconds=600))\n")
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 0 exited with code 3"):
        tpp.run_ranks([[sys.executable, "-c", "import sys; sys.exit(3)"],
                       [sys.executable, "-c", waiter]], timeout_s=300)
    assert time.monotonic() - t0 < 60


# --------------------------------------------------------------- pipeline

def _jax_tool_env():
    """tools/two_process_pipeline.py's own worker environment."""
    spec = importlib.util.spec_from_file_location(
        "jax_two_process_pipeline",
        os.path.join(ROOT, "tools", "two_process_pipeline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._env(1)


@pytest.fixture(scope="module")
def mp_runs(tmp_path_factory):
    data = tmp_path_factory.mktemp("mp_data")
    reads, ref, lib, truth = bench_pipeline.synthetic_dataset(str(data))
    jax_out = str(tmp_path_factory.mktemp("mp_jax"))
    # the JAX runner at one process, beside the port's two runs
    jax_proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tools",
                                      "two_process_pipeline.py"),
         "worker", "1", "0", reads, ref, lib, jax_out,
         os.path.join(jax_out, "stats.json"), "1"],
        env=_jax_tool_env(), cwd=ROOT)
    try:
        result = tpp.run([reads, ref, lib],
                         str(tmp_path_factory.mktemp("mp_port")), procs=2,
                         threads=1, device="cpu", timeout_s=400)
        assert jax_proc.wait(timeout=400) == 0
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.wait()
    return result, jax_out, truth


@pytest.mark.parametrize("procs", [1, 2])
@pytest.mark.parametrize("name", MP_FILES)
def test_mp_output_byte_identical_to_jax(mp_runs, procs, name):
    result, jax_out, _truth = mp_runs
    run = result["one_process" if procs == 1 else "multi_process"]
    with open(os.path.join(jax_out, name), "rb") as f:
        want = f.read()
    with open(os.path.join(run["out_dir"], name), "rb") as f:
        assert f.read() == want


def test_mp_runs_write_what_the_jax_runner_writes(mp_runs):
    """The same file set as the JAX runner, the two port runs identical,
    every rank's stats present, the vote on the asked-for device, and the
    planted insertions found."""
    import json
    result, jax_out, truth = mp_runs
    assert sorted(f for f in os.listdir(jax_out) if f != "stats.json") \
        == sorted(MP_FILES) == result["output_files"]
    assert result["bit_identical"] and not result["mismatches"]
    ranks = result["multi_process"]["ranks"]
    assert [r["rank"] for r in ranks] == [0, 1]
    for r in ranks:
        assert r["nprocs"] == 2 and r["device"] == "cpu"
        assert r["vote_calls"].get("cpu", 0) > 0
        assert "assembly" in r["stage_seconds"]
        assert set(r["launches"]) == {"wavefront_dp", "wavefront_walk",
                                      "rowband_dp", "rowband_walk"}
    with open(os.path.join(result["one_process"]["out_dir"],
                           "reads.telr.json")) as f:
        calls = json.load(f)
    assert len(calls) == len(truth)
    for pos, fam in truth:
        assert any(c["family"] == fam and abs(c["start"] - pos) < 200
                   for c in calls), (pos, fam)


def test_mp_ranks_report_their_backend(mp_runs):
    """Each rank of the two-process CPU run says it went over gloo with its
    collectives on host tensors, and counts no launch on any card; the
    one-process run joined no group."""
    result, _jax_out, _truth = mp_runs
    for r in result["multi_process"]["ranks"]:
        assert (r["backend"], r["collective_device"]) == ("gloo", "cpu")
        assert all(c == {} for c in r["launches_by_card"].values())
        assert r["vote_calls_by_card"] == {}
    (one,) = result["one_process"]["ranks"]
    assert one["backend"] is None and one["collective_device"] == "cpu"
    assert "gloo" in result["backend"]
