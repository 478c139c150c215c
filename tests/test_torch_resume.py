"""Checkpoint and resume of the port's run_pipeline (the counterpart of
tests/test_resume.py, which needs the bundled TELR data): a second run into
the same checkpoint_dir restores the alignment, te_filter and assembly stages
and writes the same files byte for byte; a change of the inputs or of the
semantic config invalidates the checkpoints.  On small_dataset (a 12 kb
genome, one insertion), host routing, one thread, device="cpu".

On ledger_dataset (an insertion that is no TE beside one of alpha) the
port's first and resumed runs are held byte for byte to the JAX package's:
there the resumed run's loci_eval.tsv lacks the lines of the loci te_filter
dropped, as the reference's does."""

import os
import shutil

import pytest

from telr_tpu_torch.tools.bench_pipeline import small_dataset
from test_torch_pipeline import OUTPUTS

RESTORED = ["alignment", "te_filter", "assembly"]


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    from telr_tpu_torch.config import SVConfig, TELRConfig
    from telr_tpu_torch.pipeline import run_pipeline
    work = tmp_path_factory.mktemp("resume")
    inputs, _truth = small_dataset(str(work))
    ck = str(work / "ckpt")
    cfg = TELRConfig(sv=SVConfig(min_support=3), threads=1)
    runs = [run_pipeline(*inputs, str(work / f"out{k}"), cfg,
                         checkpoint_dir=ck, device="cpu") for k in (1, 2)]
    return work, inputs, ck, runs


def test_first_run_restores_nothing(resumed):
    _work, _inputs, ck, (first, _second) = resumed
    assert first.restored_stages == []
    assert os.path.isfile(os.path.join(ck, "MANIFEST.json"))


def test_second_run_restores_the_checkpointed_stages(resumed):
    _work, _inputs, _ck, (first, second) = resumed
    assert second.restored_stages == RESTORED
    assert second.final_report == first.final_report and first.final_report
    assert list(second.stage_seconds) == list(first.stage_seconds)


@pytest.mark.parametrize("name", OUTPUTS)
def test_resumed_output_byte_identical(resumed, name):
    work = resumed[0]
    with open(work / "out1" / name, "rb") as f1, \
            open(work / "out2" / name, "rb") as f2:
        assert f1.read() == f2.read()


def test_changed_inputs_invalidate_checkpoints(resumed, tmp_path):
    from telr_tpu_torch.config import SVConfig, TELRConfig
    from telr_tpu_torch.pipeline import run_pipeline
    _work, (reads, ref, lib), ck, (first, _second) = resumed
    # a copy of the checkpoints, so the other tests' runs stay as they were
    ck2 = str(tmp_path / "ckpt")
    shutil.copytree(ck, ck2)
    same = run_pipeline(reads, ref, lib, str(tmp_path / "same"),
                        TELRConfig(sv=SVConfig(min_support=3), threads=3),
                        checkpoint_dir=ck2, device="cpu")
    # threads are an execution knob, not a semantic one: it resumes
    assert same.restored_stages == RESTORED
    cfg = TELRConfig(sv=SVConfig(min_support=4), threads=1)
    changed_cfg = run_pipeline(reads, ref, lib, str(tmp_path / "cfg"), cfg,
                               checkpoint_dir=ck2, device="cpu")
    assert changed_cfg.restored_stages == []
    reads2 = str(tmp_path / "reads2.fa")
    shutil.copy(reads, reads2)
    with open(reads2, "a") as f:
        f.write(">extra\nACGTACGTACGT\n")
    changed_reads = run_pipeline(reads2, ref, lib, str(tmp_path / "reads"),
                                 cfg, checkpoint_dir=ck2, device="cpu")
    assert changed_reads.restored_stages == []
    assert len(changed_reads.final_report) == len(first.final_report)


# the drop reasons the restorable stages log to loci_eval.tsv: te_filter's
# and assembly's (sv/filter.py, assembly/local.py)
RESTORED_REASONS = ("VCF sequence not repeatmasked", "local assembly failed")


def ledger_dataset(outdir):
    """small_dataset's recipe with a second insertion that is no TE: a 12 kb
    genome (chrS) with 900 random bases inserted at 4 kb and a 1.2 kb alpha
    at 8 kb, 4 kb reads every 1 kb, twice over (8x), 4 % errors, every third
    reverse-complemented; the library holds alpha only, so te_filter drops
    the first locus and logs it.  Returns (reads, ref, lib)."""
    import numpy as np

    from telr_tpu_torch.io.fasta import write_fasta
    from telr_tpu_torch.io.seqs import Sequence
    from telr_tpu_torch.tools.bench_pipeline import _sample_reads
    rng = np.random.default_rng(17)
    ref = rng.integers(0, 4, 12_000).astype(np.int8)
    other = rng.integers(0, 4, 900).astype(np.int8)
    alpha = rng.integers(0, 4, 1_200).astype(np.int8)
    hap = np.concatenate([ref[:4_000], other, ref[4_000:8_000], alpha,
                          ref[8_000:]])
    reads = []
    _sample_reads(rng, hap, 4_000, 1_000, reads)
    paths = [os.path.join(outdir, f) for f in ("reads.fa", "ref.fa",
                                                 "lib.fa")]
    write_fasta(reads, paths[0])
    write_fasta([Sequence("chrS", ref)], paths[1])
    write_fasta([Sequence("alpha", alpha)], paths[2])
    return paths


@pytest.fixture(scope="module")
def ledger_runs(tmp_path_factory):
    """Each package's first run and resumed run on ledger_dataset, into a
    checkpoint directory of its own."""
    from telr_tpu.config import SVConfig as JSVConfig, TELRConfig as JConfig
    from telr_tpu.pipeline import run_pipeline as jax_run
    from telr_tpu_torch.config import SVConfig, TELRConfig
    from telr_tpu_torch.pipeline import run_pipeline
    work = tmp_path_factory.mktemp("ledger")
    inputs = ledger_dataset(str(work))
    runs = {}
    for package, run, cfg, device in (
            ("port", run_pipeline,
             TELRConfig(sv=SVConfig(min_support=3), threads=1),
             {"device": "cpu"}),
            ("jax", jax_run,
             JConfig(sv=JSVConfig(min_support=3), threads=1), {})):
        ck = str(work / f"{package}_ckpt")
        runs[package] = [
            (run(*inputs, str(work / f"{package}_{k}"), cfg,
                 checkpoint_dir=ck, **device), work / f"{package}_{k}")
            for k in ("first", "resumed")]
    return runs


@pytest.mark.parametrize("name", OUTPUTS)
def test_resumed_output_equals_the_reference(ledger_runs, name):
    """The port's resumed run writes the JAX package's resumed run's files
    (and its first run the JAX package's first run's)."""
    for k in (0, 1):
        with open(ledger_runs["port"][k][1] / name, "rb") as f1, \
                open(ledger_runs["jax"][k][1] / name, "rb") as f2:
            assert f1.read() == f2.read()


def test_resume_drops_the_restored_stages_ledger_lines(ledger_runs):
    """The reference's behaviour, which the port keeps: a restored stage
    does not run, so the loci it would drop are not logged again, and the
    resumed run's loci_eval.tsv lacks the first run's te_filter and
    assembly lines; its other eight files are the first run's."""
    for package, ((first, first_out), (resumed, resumed_out)) in \
            ledger_runs.items():
        assert resumed.restored_stages == RESTORED, package
        assert resumed.final_report == first.final_report and \
            len(first.final_report) == 1, package
        with open(first_out / "reads.loci_eval.tsv") as f:
            lines = f.read().splitlines()
        with open(resumed_out / "reads.loci_eval.tsv") as f:
            kept = f.read().splitlines()
        assert any(ln.endswith("\tVCF sequence not repeatmasked")
                   for ln in lines), package
        assert kept == [ln for ln in lines
                        if ln.split("\t", 1)[1] not in RESTORED_REASONS]
        for name in OUTPUTS:
            if name != "reads.loci_eval.tsv":
                assert (first_out / name).read_bytes() == \
                    (resumed_out / name).read_bytes(), (package, name)
