"""--profile_dir on the CPU: the torch.profiler trace of a CLI run holds one
`telr_stage:<name>` span per stage, each as long as the stage's own timer
says (within 5%), and telr_tpu_torch/tools/profile_report.py reads it."""

import gzip
import json
import os

import pytest

from telr_tpu_torch.tools.bench_pipeline import small_dataset


@pytest.fixture(scope="module")
def profiled(tmp_path_factory):
    from telr_tpu_torch import cli
    from telr_tpu_torch.pipeline import PROFILE_TRACE
    work = tmp_path_factory.mktemp("profile")
    (reads, ref, lib), _truth = small_dataset(str(work))
    trace_dir = os.path.join(str(work), "trace")
    res = cli.main(["-i", reads, "-r", ref, "-l", lib, "-o",
                    os.path.join(str(work), "out"), "--device", "cpu",
                    "--min_support", "3", "--profile_dir", trace_dir])
    return res, trace_dir, os.path.join(trace_dir, PROFILE_TRACE)


def test_trace_has_one_span_per_stage(profiled):
    res, _trace_dir, path = profiled
    with gzip.open(path, "rt") as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X"
             and str(e.get("name", "")).startswith("telr_stage:")]
    names = [e["name"].split(":", 1)[1] for e in spans]
    assert sorted(names) == sorted(res.stage_seconds)
    assert len(names) == len(set(names))
    for e in spans:
        want = res.stage_seconds[e["name"].split(":", 1)[1]]
        assert abs(e["dur"] / 1e6 - want) <= 0.05 * want, (e["name"], want)


def test_report_reads_the_trace(profiled, tmp_path):
    from telr_tpu_torch.tools import profile_report
    res, trace_dir, path = profiled
    out = tmp_path / "report.json"
    profile_report.main([trace_dir, "--out", str(out)])
    with open(out) as f:
        rep = json.load(f)
    assert rep["trace"] == path and rep["trace_bytes"] > 0
    assert [r["stage"] for r in rep["stages"]] == list(res.stage_seconds)
    for row in rep["stages"]:
        want = res.stage_seconds[row["stage"]]
        assert abs(row["wall_s"] - want) <= 0.05 * want
        # a CPU run launches nothing on a card
        assert row["device_s"] == 0 and row["busy_share"] == 0
        assert row["top"] == []
    assert rep["device_total_s"] == 0 and rep["unattributed_device_s"] == 0


def test_report_attributes_device_events_by_launch():
    """Synthetic trace: a kernel launched inside a stage but run after the
    span closed counts for that stage (by its correlation id), a memcpy
    without a launch record goes by its own start, the profiler's
    gpu_user_annotation copy of a span is not a stage, and events outside
    every span are kept apart."""
    from telr_tpu_torch.tools.profile_report import build_report, kernel_name
    ev = [
        {"ph": "X", "cat": "cpu_op", "name": "telr_stage:alignment",
         "ts": 0, "dur": 1000},
        {"ph": "X", "cat": "cpu_op", "name": "telr_stage:assembly",
         "ts": 1000, "dur": 2000},
        {"ph": "X", "cat": "gpu_user_annotation",
         "name": "telr_stage:alignment", "ts": 10, "dur": 990},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 900, "dur": 5, "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel",
         "name": "void (anonymous namespace)::wavefront_dp_kernel<true, 4>"
                 "(signed char const*)",
         "ts": 1100, "dur": 300, "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "wavefront_walk_kernel(int)",
         "ts": 1500, "dur": 100, "args": {"correlation": 8}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
         "ts": 1600, "dur": 50},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 5000,
         "dur": 20},
    ]
    rep = build_report({"traceEvents": ev,
                        "deviceProperties": [{"name": "card"}]})
    by = {r["stage"]: r for r in rep["stages"]}
    assert list(by) == ["alignment", "assembly"]
    assert by["alignment"]["device_s"] == pytest.approx(300e-6)
    assert by["alignment"]["top"] == [
        {"name": "wavefront_dp_kernel", "s": pytest.approx(300e-6),
         "count": 1}]
    assert by["assembly"]["device_s"] == pytest.approx(150e-6)
    assert by["assembly"]["busy_share"] == pytest.approx(150e-6 / 2e-3)
    assert rep["unattributed_device_s"] == pytest.approx(20e-6)
    assert rep["device_total_s"] == pytest.approx(470e-6)
    assert rep["devices"] == ["card"]
    assert kernel_name("rowband_walk_kernel") == "rowband_walk_kernel"
    assert kernel_name("void at::native::reduce_kernel<512, 1>(int)") \
        == "at::native::reduce_kernel"
