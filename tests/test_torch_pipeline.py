"""The port's run_pipeline against the JAX package's on the same synthetic
dataset (bench_pipeline.synthetic_dataset: a 120 kb genome with three planted
insertions), host routing, one thread: every output file but the run's
provenance (run_env.json) and its timestamped log must be byte-identical.

The mesh path (run_pipeline(mesh=...): stage-1 DP through the sharded
row-banded runner, the locus all-to-all, the mesh depth reduction) is held the
same way against the JAX package's run on its 8-device host mesh.  On the CPU
the port's runner walks the DP rows in plain torch ops, about half a
millisecond a row and shard whatever the batch, so that comparison runs on a
smaller dataset of the same make (telr_tpu_torch.tools.bench_pipeline's
small_dataset: a 12 kb genome, one planted insertion, 4 kb reads at 8x); the
comparison itself is not cut."""

import os

import pytest
import torch

import bench_pipeline
from telr_tpu_torch.tools.bench_pipeline import small_dataset

OUTPUTS = [
    "reads.telr.json", "reads.telr.expanded.json", "reads.telr.vcf",
    "reads.telr.bed", "reads.telr.te.fasta", "reads.telr.contig.fasta",
    "reads.loci_eval.tsv", "liftover_summary.json", "liftover_report.json",
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain row loop is thousands of small tensor ops: intra-op threads
    gain nothing there and thrash when several test workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from telr_tpu.config import SVConfig as JSVConfig, TELRConfig as JConfig
    from telr_tpu.pipeline import run_pipeline as jax_run
    from telr_tpu_torch.config import SVConfig, TELRConfig
    from telr_tpu_torch.pipeline import run_pipeline

    data = tmp_path_factory.mktemp("data")
    reads, ref, lib, truth = bench_pipeline.synthetic_dataset(str(data))
    port_out = str(tmp_path_factory.mktemp("port"))
    jax_out = str(tmp_path_factory.mktemp("jax"))
    port = run_pipeline(reads, ref, lib, port_out,
                        TELRConfig(sv=SVConfig(min_support=3), threads=1),
                        device="cpu")
    ref_res = jax_run(reads, ref, lib, jax_out,
                      JConfig(sv=JSVConfig(min_support=3), threads=1))
    return port, ref_res, port_out, jax_out, truth


@pytest.mark.parametrize("name", OUTPUTS)
def test_output_byte_identical(runs, name):
    _port, _ref, port_out, jax_out, _truth = runs
    with open(os.path.join(port_out, name), "rb") as f:
        got = f.read()
    with open(os.path.join(jax_out, name), "rb") as f:
        want = f.read()
    assert got == want


def test_run_finds_the_planted_insertions(runs):
    port, _ref, port_out, _jax_out, truth = runs
    assert len(port.final_report) == len(truth)
    for pos, fam in truth:
        assert any(c["family"] == fam and abs(c["start"] - pos) < 200
                   for c in port.final_report), (pos, fam)
    import json
    with open(os.path.join(port_out, "run_env.json")) as f:
        env = json.load(f)
    assert env["device"] == "cpu" and "torch" in env and "jax" not in env


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    import jax

    from telr_tpu.config import SVConfig as JSVConfig, TELRConfig as JConfig
    from telr_tpu.dist.mesh import make_mesh as jax_make_mesh
    from telr_tpu.pipeline import run_pipeline as jax_run
    from telr_tpu_torch.config import SVConfig, TELRConfig
    from telr_tpu_torch.dist.mesh import make_mesh
    from telr_tpu_torch.kernels import hopper_dp
    from telr_tpu_torch.pipeline import run_pipeline

    data = tmp_path_factory.mktemp("mesh_data")
    (reads, ref, lib), truth = small_dataset(str(data))
    port_out = str(tmp_path_factory.mktemp("mesh_port"))
    jax_out = str(tmp_path_factory.mktemp("mesh_jax"))
    calls = []
    plain = hopper_dp._rowband_dp_plain

    def counting(*args):
        calls.append(args[0].shape[0])
        return plain(*args)

    hopper_dp._rowband_dp_plain = counting
    try:
        port = run_pipeline(
            reads, ref, lib, port_out,
            TELRConfig(sv=SVConfig(min_support=3), threads=1), device="cpu",
            mesh=make_mesh(4, device="cpu"))
    finally:
        hopper_dp._rowband_dp_plain = plain
    # the JAX package on its own mesh when the host has the 8 virtual
    # devices, else meshless, which its contract makes the same
    jmesh = jax_make_mesh(8) if len(jax.devices()) >= 8 else None
    ref_res = jax_run(reads, ref, lib, jax_out,
                      JConfig(sv=JSVConfig(min_support=3), threads=1),
                      mesh=jmesh)
    return port, ref_res, port_out, jax_out, truth, calls


@pytest.mark.parametrize("name", OUTPUTS)
def test_mesh_output_byte_identical(mesh_runs, name):
    port_out, jax_out = mesh_runs[2], mesh_runs[3]
    with open(os.path.join(port_out, name), "rb") as f:
        got = f.read()
    with open(os.path.join(jax_out, name), "rb") as f:
        want = f.read()
    assert got == want


def test_mesh_run_goes_through_the_mesh(mesh_runs):
    port, ref_res, _port_out, _jax_out, truth, calls = mesh_runs
    assert "locus_redistribute" in port.stage_seconds
    assert list(port.stage_seconds) == list(ref_res.stage_seconds)
    assert port.te_freq == ref_res.te_freq and port.te_freq
    # stage 1 ran the row-banded DP, four equal shards a batch
    assert calls and len(calls) % 4 == 0
    assert all(len(set(calls[k:k + 4])) == 1 for k in range(0, len(calls), 4))
    assert len(port.final_report) == len(truth)
    (pos, fam), = truth
    assert port.final_report[0]["family"] == fam
    assert abs(port.final_report[0]["start"] - pos) < 200
