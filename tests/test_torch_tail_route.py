"""The tail stages' wavefront route held to the reference, on the CPU.

The port's run_pipeline(device="cpu") with the DPs of tail stages on the
wavefront route, where the kernels' plain torch versions stand in for the
CUDA kernels, against the JAX package's run_pipeline on the same stages with
its Pallas wavefront kernel in interpret mode; the other stages run on the
native host engine in both.  Both mappers' size gate (_WAVE_MIN_CELLS) is 0,
so that the small dataset reaches the kernels, and the dataset is
bench_pipeline.tail_dataset (a 12 kb genome with a reference copy of the
inserted family), on which every tail stage has a DP to run.  Every output
file but the run's provenance and its timestamped log must be
byte-identical (tolerance: none), and spies, tagged with the stage the
pipeline logged it was in, count the port's calls of both kernels and the
reference's wavefront_align calls in each route stage: a stage quietly sent
to the host engine fails.

The reference's interpret-mode kernel costs about a minute a compile key
(score set x mode; the JAX side is padded to one step rung and one group a
chunk, as in test_torch_card_route.py).  The five stages need six keys: the
reads' score set (annotate, af), the library's (te_filter, the family
re-annotation, repeatmask) and ASM10's (liftover), in GLOBAL and EXTEND.  So
the route is held in two files that pytest-xdist's --dist loadfile gives two
workers: this one te_filter, annotate and af (four keys), and
test_torch_tail_route_lift.py repeatmask and liftover (four keys)."""

import os

import pytest
import torch

from telr_tpu_torch.tools.bench_pipeline import tail_dataset
from test_torch_pipeline import OUTPUTS

# the pipeline stage each wavefront_stages name runs in
STAGE_OF = {"alignment": "alignment", "te_filter": "te_filter",
            "assembly": "assembly", "annotate": "annotate_contig",
            "af": "allele_frequency", "repeatmask": "ref_repeatmask",
            "liftover": "liftover"}


def run_tail_route(stages, tmp_path_factory):
    """Both pipelines on tail_dataset with `stages` on the wavefront route.
    Returns (port result, JAX result, port out dir, JAX out dir, truth,
    calls: {pipeline stage: {"wavefront_dp": n, "wavefront_walk": n,
    "jax": n}})."""
    from telr_tpu.config import SVConfig as JSVConfig, TELRConfig as JConfig
    from telr_tpu.kernels import mapper as jmapper
    from telr_tpu.kernels import pallas_wavefront as jpw
    from telr_tpu.pipeline import run_pipeline as jax_run
    from telr_tpu_torch.config import SVConfig, TELRConfig
    from telr_tpu_torch.kernels import hopper_wavefront as hw
    from telr_tpu_torch.kernels import mapper
    from telr_tpu_torch.pipeline import run_pipeline
    from telr_tpu_torch.tools.bench_pipeline import StageTap

    data = tmp_path_factory.mktemp("tail_" + "_".join(stages))
    (reads, ref, lib), truth = tail_dataset(str(data))
    port_out, jax_out = str(data / "port"), str(data / "jax")
    tap = StageTap()
    calls = {}

    def spy(module, name, key):
        real = getattr(module, name)

        def counted(*args, **kwargs):
            at = calls.setdefault(tap.stage, {"wavefront_dp": 0,
                                              "wavefront_walk": 0, "jax": 0})
            at[key] += 1
            return real(*args, **kwargs)
        return counted

    real_init = jmapper.Aligner.__init__

    def interpreting_init(self, *args, **kwargs):
        # the flag is set per instance in __init__; run_pipeline builds
        # its Aligners itself
        real_init(self, *args, **kwargs)
        self._wave_interpret = True

    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)   # the plain kernels are many small ops
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mapper, "_WAVE_MIN_CELLS", 0)
        mp.setattr(jmapper, "_WAVE_MIN_CELLS", 0)
        for name in ("wavefront_dp", "wavefront_walk"):
            mp.setattr(hw, name, spy(hw, name, name))
        # the reference's route: the mapper imports it at each call
        mp.setattr(jpw, "wavefront_align",
                   spy(jpw, "wavefront_align", "jax"))
        mp.setattr(jmapper.Aligner, "__init__", interpreting_init)
        # one unpadded group a chunk, and one rung of the step ladder up to
        # 8192 steps: the kernel masks the steps past each pair's lq + lt,
        # so padding changes only the compile keys (about a minute each in
        # interpret mode), never a result
        mp.setattr(jpw, "_g_fixed", lambda sp, width: 1)
        mp.setattr(jpw, "_S_LADDER", (8192,))
        try:
            with tap:
                port = run_pipeline(
                    reads, ref, lib, port_out,
                    TELRConfig(sv=SVConfig(min_support=3), threads=1,
                               use_wavefront=True, wavefront_stages=stages),
                    device="cpu")
                want = jax_run(
                    reads, ref, lib, jax_out,
                    JConfig(sv=JSVConfig(min_support=3), threads=1,
                            use_wavefront=True, wavefront_stages=stages))
        finally:
            torch.set_num_threads(n_threads)
    return port, want, port_out, jax_out, truth, calls


def check_byte_identical(route, name):
    _port, _want, port_out, jax_out, _truth, _calls = route
    with open(os.path.join(port_out, name), "rb") as f:
        got = f.read()
    with open(os.path.join(jax_out, name), "rb") as f:
        want = f.read()
    assert got == want


def check_stages_ran_both_kernels(route, stages):
    """Each route stage called both port kernels, one walk a DP launch as
    wavefront_align issues them, and the reference's kernel; no other stage
    called either."""
    port, want, _port_out, _jax_out, _truth, calls = route
    assert set(calls) == {STAGE_OF[s] for s in stages}, calls
    for stage, at in calls.items():
        assert at["wavefront_dp"] > 0 and at["jax"] > 0, (stage, at)
        assert at["wavefront_dp"] == at["wavefront_walk"], (stage, at)
    assert list(port.stage_seconds) == list(want.stage_seconds)


def check_calls_the_insertion(route):
    port, _want, _port_out, _jax_out, truth, _calls = route
    (pos, fam), = truth
    assert [c["family"] for c in port.final_report] == [fam]
    assert abs(port.final_report[0]["start"] - pos) < 200


STAGES = ("te_filter", "annotate", "af")


@pytest.fixture(scope="module")
def route(tmp_path_factory):
    return run_tail_route(STAGES, tmp_path_factory)


@pytest.mark.parametrize("name", OUTPUTS)
def test_tail_route_byte_identical(route, name):
    check_byte_identical(route, name)


def test_tail_route_ran_both_kernels_in_each_stage(route):
    check_stages_ran_both_kernels(route, STAGES)


def test_tail_route_calls_the_insertion(route):
    check_calls_the_insertion(route)
