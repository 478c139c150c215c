"""The control of each traffic kind, kept at a size a test run holds: on the
tiny configuration, the sound pass keeps within every limit of the cell's
check and the control (map: the reference's DP in the program's place with
its band cut to an eighth; loci: each contig one raw read, the vote and the
POA rounds handing the backbone back) exceeds at least one."""

from __future__ import annotations

import os
import types

import pytest
import torch

from benchmark import inputs
from benchmark.registry import Registry
from benchmark.spans import LaunchSpy, Recorder


@pytest.mark.parametrize("cell", ["tiny-map", "tiny-loci"])
def test_the_control_fails_the_check(tiny_root, cell):
    from telr_tpu_torch.utils.procpool import ensure_forkserver
    ensure_forkserver()
    reg = Registry(tiny_root, os.path.join(tiny_root, "benchmark"))
    spec = reg.cell(cell)
    cfg = reg.config(spec["config"])
    traffic = reg.traffic(spec["traffic"])
    inputs.CACHE = os.path.join(tiny_root, "benchmark", ".cache")
    dev = torch.device("cpu")
    run = types.SimpleNamespace(
        cell=spec, config=cfg, seed=5, device=dev, ref_device=dev,
        spans=Recorder(), launch_spy=LaunchSpy(),
        sample_seed=inputs.sample_seed(spec, 5))
    run.sample = inputs.load_or_make(cfg, run.sample_seed)
    st = traffic.setup(run)
    try:
        _, _, out = traffic.one_pass(run, st)
        sound = traffic.judge(run, st, [out, out])
        control = traffic.control(run, st, [out])
    finally:
        traffic.close(run, st)
    limits = spec["limits"]
    assert all(sound[k] <= v for k, v in limits.items()), sound
    assert any(control[k] > v for k, v in limits.items()), control
