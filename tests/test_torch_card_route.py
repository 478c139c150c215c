"""The card route held to the reference end to end, on the CPU.

The port's run_pipeline(device="cpu") with its DPs on the wavefront route
(use_wavefront=True, wavefront_stages as below), where the kernels' plain
torch versions stand in for the CUDA kernels, against the JAX package's
run_pipeline on the same stages with its Pallas wavefront kernel in
interpret mode.  Both mappers' size gate (_WAVE_MIN_CELLS) is set to 0 so a
small dataset reaches the kernels.  Every output file but the run's
provenance and its timestamped log must be byte-identical, and spies count
the port's calls of both kernels (their launch counters count CUDA launches
only) and the reference's wavefront_align calls, so a run that sent every
DP to the host engine cannot pass.

The reference's interpret-mode kernel costs about a minute a compile key
(the kernel's jaxpr to MLIR, then XLA), which the JAX side pads down to a
few keys; its stage 1 still needs more keys than its assembly, so the route
is held in two cases: the alignment route on tiny_dataset (a 6 kb genome, a
0.6 kb insertion, 2 kb reads at 8x), then the assembly route on
small_dataset (a 12 kb genome, one 1.2 kb insertion, 4 kb reads at 8x).
Tolerance: none (bytes)."""

import os

import pytest
import torch

from telr_tpu_torch.tools.bench_pipeline import small_dataset, tiny_dataset
from test_torch_pipeline import OUTPUTS

# alignment first: the reference's kernel keys that the assembly case needs
# are then compiled already in this process
CASES = {"alignment": (tiny_dataset, ("alignment",)),
         "assembly": (small_dataset, ("assembly",))}


@pytest.fixture(scope="module", params=list(CASES))
def route(request, tmp_path_factory):
    from telr_tpu.config import SVConfig as JSVConfig, TELRConfig as JConfig
    from telr_tpu.kernels import mapper as jmapper
    from telr_tpu.kernels import pallas_wavefront as jpw
    from telr_tpu.pipeline import run_pipeline as jax_run
    from telr_tpu_torch.config import SVConfig, TELRConfig
    from telr_tpu_torch.kernels import hopper_wavefront as hw
    from telr_tpu_torch.kernels import mapper
    from telr_tpu_torch.pipeline import run_pipeline

    dataset, stages = CASES[request.param]
    data = tmp_path_factory.mktemp(f"route_{request.param}")
    (reads, ref, lib), truth = dataset(str(data))
    port_out, jax_out = str(data / "port"), str(data / "jax")
    calls = {"wavefront_dp": 0, "wavefront_walk": 0, "jax": 0}

    def spy(module, name, key):
        real = getattr(module, name)

        def counted(*args, **kwargs):
            calls[key] += 1
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


@pytest.mark.parametrize("name", OUTPUTS)
def test_card_route_byte_identical(route, name):
    _port, _want, port_out, jax_out, _truth, _calls = route
    with open(os.path.join(port_out, name), "rb") as f:
        got = f.read()
    with open(os.path.join(jax_out, name), "rb") as f:
        want = f.read()
    assert got == want


def test_card_route_ran_both_kernels(route):
    port, want, _port_out, _jax_out, _truth, calls = route
    assert calls["wavefront_dp"] > 0 and calls["wavefront_walk"] > 0, calls
    # one walk a DP launch, as wavefront_align issues them
    assert calls["wavefront_dp"] == calls["wavefront_walk"]
    # ... and the reference went through its interpret-mode kernel
    assert calls["jax"] > 0, calls
    assert list(port.stage_seconds) == list(want.stage_seconds)


def test_card_route_calls_the_insertion(route):
    port, _want, _port_out, _jax_out, truth, _calls = route
    (pos, fam), = truth
    assert len(port.final_report) == 1
    assert port.final_report[0]["family"] == fam
    assert abs(port.final_report[0]["start"] - pos) < 200
