"""The run's device reaches the tail stages, on a host without a card.

The five stages after assembly (te_filter, annotate, af, repeatmask,
liftover) build their own Aligners.  With their DPs on the wavefront route
(--wavefront on, the mappers' size gate at 0 so that the small dataset
reaches the kernels) and --device cpu, each must run the kernels' plain
versions on the CPU, which needs the run's device on every Aligner they
build: an Aligner without one looks for a card and raises without one.
Both entry points are held: the CLI, and the multi-process runner at one
process."""

import os

import pytest
import torch

from telr_tpu_torch.tools.bench_pipeline import tail_dataset
from test_torch_pipeline import OUTPUTS

TAIL = ("te_filter", "annotate", "af", "repeatmask", "liftover")
# the functions that build each tail stage's Aligners: (module, name)
TAIL_FUNCTIONS = {
    "te_filter": [("telr_tpu_torch.sv.filter", "filter_te_candidates")],
    "annotate": [("telr_tpu_torch.annotate.contig", "annotate_contigs"),
                 ("telr_tpu_torch.annotate.contig", "reannotate_families")],
    "af": [("telr_tpu_torch.af.freq", "estimate_af")],
    "repeatmask": [("telr_tpu_torch.annotate.repeatmask",
                    "repeatmask_reference")],
    "liftover": [("telr_tpu_torch.liftover.engine", "liftover")],
}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("tail_device")
    return tail_dataset(str(d)), d


def test_cli_runs_the_tail_route_on_the_cpu(data, monkeypatch):
    """cli --device cpu --wavefront on without a card: every stage, the
    tail's too, runs the wavefront route's plain kernels on CPU tensors, and
    the run writes its files and calls the insertion.  stage_record sees
    every stage's dispatches cross the gate and no launch on a card."""
    from telr_tpu_torch import cli
    from telr_tpu_torch.kernels import hopper_wavefront as hw
    from telr_tpu_torch.kernels import mapper
    from telr_tpu_torch.tools.bench_pipeline import StageTap, stage_record
    ((reads, ref, lib), truth), d = data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(mapper, "_WAVE_MIN_CELLS", 0)
    seen = {}
    tap = StageTap()

    class Spy:
        """wavefront_dp, noting its inputs' devices by stage; its name and
        launch count are the wrapper's (stage_record reads them)."""

        real = staticmethod(hw.wavefront_dp)
        __name__ = hw.wavefront_dp.__name__

        @property
        def launches(self):
            return self.real.launches

        def __call__(self, meta, init, scal, *args, **kwargs):
            devices = seen.setdefault(tap.stage, set())
            devices.update(str(x.device) for x in (meta, init, scal))
            return self.real(meta, init, scal, *args, **kwargs)

    monkeypatch.setattr(hw, "wavefront_dp", Spy())
    out = str(d / "cli")
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)   # the plain kernels are many small ops
    try:
        with stage_record() as rec, tap:
            res = cli.main(["-i", reads, "-r", ref, "-l", lib, "-o", out,
                            "--device", "cpu", "--wavefront", "on",
                            "--min_support", "3"])
    finally:
        torch.set_num_threads(n_threads)
    for name in OUTPUTS:
        assert os.path.isfile(os.path.join(out, name)), name
    route = {"alignment", "te_filter", "assembly", "annotate_contig",
             "allele_frequency", "ref_repeatmask", "liftover"}
    assert set(seen) == route, seen
    assert all(v == {"cpu"} for v in seen.values()), seen
    assert {st for st, r in rec.items() if r["dispatches"]} == route
    for st, r in rec.items():
        assert all(on_card for _cells, on_card in r["dispatches"]), st
        assert not any(r["launches"].values()), (st, r["launches"])
    (pos, fam), = truth
    assert [c["family"] for c in res.final_report] == [fam]
    assert abs(res.final_report[0]["start"] - pos) < 200


def test_runner_hands_its_device_to_every_tail_aligner(data, monkeypatch):
    """run_pipeline_multiprocess(device="cpu") at one process with the tail
    stages on the wavefront route: every Aligner each tail stage builds
    carries the rank's device."""
    import importlib

    from telr_tpu_torch.config import SVConfig, TELRConfig
    from telr_tpu_torch.dist.runner import run_pipeline_multiprocess
    from telr_tpu_torch.kernels import mapper
    ((reads, ref, lib), _truth), d = data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(mapper, "_WAVE_MIN_CELLS", 0)
    current = [None]
    built = []
    real_init = mapper.Aligner.__init__

    def init(self, *args, **kwargs):
        real_init(self, *args, **kwargs)
        built.append((current[0], self.use_wavefront, self.device))

    monkeypatch.setattr(mapper.Aligner, "__init__", init)
    for stage, fns in TAIL_FUNCTIONS.items():
        for mod_name, fn_name in fns:
            mod = importlib.import_module(mod_name)
            real = getattr(mod, fn_name)

            def in_stage(*args, _stage=stage, _real=real, **kwargs):
                current[0] = _stage
                try:
                    return _real(*args, **kwargs)
                finally:
                    current[0] = None

            monkeypatch.setattr(mod, fn_name, in_stage)
    cfg = TELRConfig(sv=SVConfig(min_support=3), threads=1,
                     use_wavefront=True, wavefront_stages=TAIL)
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        run_pipeline_multiprocess(reads, ref, lib, str(d / "runner"), cfg,
                                  device="cpu")
    finally:
        torch.set_num_threads(n_threads)
    # the runner writes every file but the liftover summary and report
    for name in OUTPUTS[:7]:
        assert os.path.isfile(str(d / "runner" / name)), name
    by_stage = {}
    for stage, wave, dev in built:
        if stage is not None:
            by_stage.setdefault(stage, set()).add((wave, dev))
    assert by_stage == {s: {(True, "cpu")} for s in TAIL}, by_stage
