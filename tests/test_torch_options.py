"""The CLI options that no other port test sets, through both packages'
CLIs: `-p 0` and `-p 2` (one and three assembly polish rounds, each round one
realignment batch and one vote), `--minimap2_family` (the aligner's family
labels kept: no re-annotation against the library) and
`--different_contig_name` (liftover takes a flank's hits on any reference
sequence).  `telr_tpu_torch.cli --device cpu` against `telr_tpu.cli` on the
host CPU, both on the native host engine, on small_dataset (a 12 kb genome,
one 1.2 kb insertion, 4 kb reads at 8x), one thread, `--min_support 3`.

Every output file but the run's provenance and its timestamped log is held
byte for byte, and in each package a spy sees the option reach its stage.
`-k` (keep the stage checkpoints under <out>/intermediate_files) runs twice
into one directory in each package, so the second run resumes: its files
and the checkpoints' stages are held to the JAX package's too.
Tolerance: none (bytes)."""

import functools
import importlib
import os

import pytest

from telr_tpu_torch.tools.bench_pipeline import small_dataset
from test_torch_inputs import run_cli
from test_torch_pipeline import OUTPUTS

# option -> (its flags, what the spies must see: polish votes, calls of the
# re-annotation, liftover's different_contig_name)
OPTIONS = {
    "p0": (["-p", "0"], (1, 1, False)),
    "p2": (["-p", "2"], (3, 1, False)),
    "minimap2_family": (["--minimap2_family"], (2, 0, False)),
    "different_contig_name": (["--different_contig_name"], (2, 1, True)),
}
PACKAGES = {"port": "telr_tpu_torch", "jax": "telr_tpu"}


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    data = tmp_path_factory.mktemp("options")
    inputs, _truth = small_dataset(str(data))
    return data, inputs


def _spied_run(package, argv_extra, inputs, out):
    """One CLI run with spies on the package's vote, re-annotation and
    liftover; returns what they saw."""
    pkg = PACKAGES[package]
    vote = importlib.import_module(pkg + ".assembly.device_vote")
    pipeline = importlib.import_module(pkg + ".pipeline")
    seen = {"votes": 0, "reannotate": 0, "different_contig_name": None}

    def counted(fn, key):
        # wraps: the port's vote_many keeps its counts on itself
        @functools.wraps(fn)
        def wrapped(*a, **k):
            seen[key] += 1
            return fn(*a, **k)
        return wrapped

    def lift(*a, **k):
        seen["different_contig_name"] = k["different_contig_name"]
        return real_lift(*a, **k)

    real_lift = pipeline.liftover
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(vote, "vote_many", counted(vote.vote_many, "votes"))
        mp.setattr(pipeline, "reannotate_families",
                   counted(pipeline.reannotate_families, "reannotate"))
        mp.setattr(pipeline, "liftover", lift)
        reads, ref, lib = inputs
        run_cli(package, reads, ref, lib, out, argv_extra)
    return (seen["votes"], seen["reannotate"],
            seen["different_contig_name"])


@pytest.fixture(scope="module", params=list(OPTIONS))
def option_runs(request, dataset):
    data, inputs = dataset
    flags, _want = OPTIONS[request.param]
    outs, seen = {}, {}
    for package in PACKAGES:
        outs[package] = str(data / f"{package}_{request.param}")
        seen[package] = _spied_run(package, flags, inputs, outs[package])
    return request.param, outs, seen


@pytest.mark.parametrize("name", OUTPUTS)
def test_option_output_byte_identical(option_runs, name):
    _option, outs, _seen = option_runs
    with open(os.path.join(outs["port"], name), "rb") as f:
        got = f.read()
    with open(os.path.join(outs["jax"], name), "rb") as f:
        assert got == f.read()


def test_option_reaches_its_stage(option_runs):
    option, _outs, seen = option_runs
    assert seen["port"] == seen["jax"] == OPTIONS[option][1]


@pytest.fixture(scope="module")
def kept_runs(dataset):
    """Each package's CLI with -k run twice into one output directory: the
    first run keeps its stage checkpoints in <out>/intermediate_files, the
    second resumes from them."""
    data, (reads, ref, lib) = dataset
    runs = {}
    for package in PACKAGES:
        out = str(data / f"{package}_keep_files")
        runs[package] = [run_cli(package, reads, ref, lib, out, ["-k"])[0]
                         for _ in range(2)] + [out]
    return runs


@pytest.mark.parametrize("name", OUTPUTS)
def test_keep_files_resume_byte_identical(kept_runs, name):
    with open(os.path.join(kept_runs["port"][2], name), "rb") as f:
        got = f.read()
    with open(os.path.join(kept_runs["jax"][2], name), "rb") as f:
        assert got == f.read()


def test_keep_files_keeps_and_restores_the_stages(kept_runs):
    import json
    stages = {}
    for package, (first, second, out) in kept_runs.items():
        assert first.restored_stages == [], package
        assert second.restored_stages == ["alignment", "te_filter",
                                          "assembly"], package
        with open(os.path.join(out, "intermediate_files",
                               "MANIFEST.json")) as f:
            stages[package] = json.load(f)["stages"]
    assert stages["port"] == stages["jax"] and "ref_repeatmask" in \
        stages["port"]
