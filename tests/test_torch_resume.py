"""Checkpoint and resume of the port's run_pipeline (the counterpart of
tests/test_resume.py, which needs the bundled TELR data): a second run into
the same checkpoint_dir restores the alignment, te_filter and assembly stages
and writes the same files byte for byte; a change of the inputs or of the
semantic config invalidates the checkpoints.  On small_dataset (a 12 kb
genome, one insertion), host routing, one thread, device="cpu"."""

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
