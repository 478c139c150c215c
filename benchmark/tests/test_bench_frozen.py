"""The benchmark's frozen copies held to their sources: the generators to
tools/genome_eval.py (through the port's simulate_dataset, byte for byte),
the roofline arithmetic to telr_tpu_torch/tools/roofline.py, and the trace
arithmetic to telr_tpu_torch/tools/profile_report.py."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark import devtrace, generators, roofline


@pytest.mark.parametrize("ont", [False, True])
def test_generators_match_the_ports_dataset(tmp_path, ont):
    from telr_tpu_torch.io.fasta import read_fasta
    from telr_tpu_torch.tools.genome_eval import simulate_dataset
    ref_fa, reads_fa, lib_fa, truth, n_reads, _ = simulate_dataset(
        size=120_000, coverage=6, n_ins=2, seed=11, workdir=str(tmp_path),
        ont_profile=ont)
    rng = np.random.default_rng(11)
    lib = generators.make_te_library(rng)
    genome = generators.make_genome(120_000, lib, rng)
    want_truth = generators.plant_insertions(genome, lib, 2, rng)
    reads = generators.simulate_reads(genome, want_truth, 6, rng,
                                      ont_profile=ont)
    assert read_fasta(ref_fa)["chr2L"].codes.tobytes() == genome.tobytes()
    got_lib = read_fasta(lib_fa)
    assert [s.name for s in got_lib] == list(lib)
    assert all(got_lib[n].codes.tobytes() == c.tobytes()
               for n, c in lib.items())
    got_reads = read_fasta(reads_fa)
    assert len(got_reads) == n_reads == len(reads)
    assert all(got_reads[f"c0_{n}"].codes.tobytes() == c.tobytes()
               for n, c in reads)
    assert [(t["pos"], t["family"], t["tsd"], t["zygosity"])
            for t in truth] == [(t["pos"], t["family"], t["tsd"],
                                 t["zygosity"]) for t in want_truth]


def test_roofline_matches_its_source():
    from telr_tpu_torch.tools import roofline as src
    assert roofline.HBM_BYTES_PER_S == src.HBM_BYTES_PER_S
    assert roofline.INT32_OPS_PER_S == src.INT32_OPS_PER_S
    assert roofline.WAVEFRONT_OPS == src.WAVEFRONT_OPS
    for n_bytes, n_ops in ((1e9, 1e9), (1e6, 5e12), (3e12, 1.0)):
        ms, _ = src.bounds(n_bytes, n_ops)
        assert roofline.bound_s(n_bytes, n_ops) == pytest.approx(ms / 1e3)
    # one pair of 100 x 150 at width 64 with the traceback
    n_bytes, n_ops = roofline.wavefront_launch([(100, 150)], 64)
    assert n_ops == 50 * 250 * 64
    assert n_bytes == 250 + 2 * 64 + 48 + 250 * 64


def test_trace_arithmetic_matches_its_source():
    from telr_tpu_torch.tools import profile_report as src
    for name in ("void (anonymous namespace)::wavefront_dp_kernel<true, 4>"
                 "(signed char const*, int)", "void at::native::elementwise"
                 "_kernel<128, 4>(int)", "wavefront_walk_kernel"):
        assert devtrace.kernel_name(name) == src.kernel_name(name)
    # disjoint events: the union is profile_report's busy sum
    events = [{"ph": "X", "cat": "kernel", "name": "k", "ts": t, "dur": d,
               "args": {"device": 0}}
              for t, d in ((0, 5), (10, 2.5), (20, 7))]
    busy = src.card_windows({"traceEvents": events})[0]["busy_s"]
    ours = [{"name": "k", "t0": e["ts"] / 1e6,
             "t1": (e["ts"] + e["dur"]) / 1e6} for e in events]
    assert devtrace.busy_s(ours, 0.0, 1.0) == pytest.approx(busy)
    # overlapping events count once
    ours.append({"name": "c", "t0": 1e-6, "t1": 4e-6})
    assert devtrace.busy_s(ours, 0.0, 1.0) == pytest.approx(busy)
    gaps = devtrace.idle_gaps(ours, 0.0, 30e-6)
    assert gaps[0] == pytest.approx((12.5e-6, 20e-6))
