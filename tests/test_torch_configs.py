"""The ONT preset and a multi-chromosome reference through the port's
run_pipeline against the JAX package's, host routing, one thread: every
output file but the run's provenance and its timestamped log must be
byte-identical.

- `-x ont` (presets="ont": MAP_ONT for every alignment role) on
  small_dataset (a 12 kb genome, one 1.2 kb insertion, 4 kb reads at 8x);
- a two-chromosome reference of the same make (chr1 and chr2, 12 kb each,
  an insertion of the same TE in each).

Tolerance: none (bytes)."""

import os

import pytest

from telr_tpu_torch.tools.bench_pipeline import small_dataset
from test_torch_pipeline import OUTPUTS

CASES = {"ont": ("ont", 1), "two_chromosomes": ("pacbio", 2)}


@pytest.fixture(scope="module", params=list(CASES))
def config_runs(request, tmp_path_factory):
    from telr_tpu.config import SVConfig as JSVConfig, TELRConfig as JConfig
    from telr_tpu.pipeline import run_pipeline as jax_run
    from telr_tpu_torch.config import SVConfig, TELRConfig
    from telr_tpu_torch.pipeline import run_pipeline

    presets, chroms = CASES[request.param]
    data = tmp_path_factory.mktemp(f"config_{request.param}")
    (reads, ref, lib), truth = small_dataset(str(data), chroms=chroms)
    port_out, jax_out = str(data / "port"), str(data / "jax")
    port = run_pipeline(reads, ref, lib, port_out,
                        TELRConfig(presets=presets,
                                   sv=SVConfig(min_support=3), threads=1),
                        device="cpu")
    want = jax_run(reads, ref, lib, jax_out,
                   JConfig(presets=presets, sv=JSVConfig(min_support=3),
                           threads=1))
    return port, want, port_out, jax_out, truth, chroms


@pytest.mark.parametrize("name", OUTPUTS)
def test_config_output_byte_identical(config_runs, name):
    _port, _want, port_out, jax_out, _truth, _chroms = config_runs
    with open(os.path.join(port_out, name), "rb") as f:
        got = f.read()
    with open(os.path.join(jax_out, name), "rb") as f:
        want = f.read()
    assert got == want


def test_config_calls_every_insertion(config_runs):
    port, want, _port_out, _jax_out, truth, chroms = config_runs
    assert port.final_report == want.final_report
    assert len(port.final_report) == len(truth)
    for site in truth:
        chrom, pos, fam = site if chroms > 1 else ("chrS",) + site
        assert any(c["chrom"] == chrom and c["family"] == fam
                   and abs(c["start"] - pos) < 200
                   for c in port.final_report), site
