"""The calls into the program that more than one traffic driver makes: the
pipeline's configuration under the CLI's auto routing, the sample as the
program's sequence containers, and stage 1's Aligner as run_pipeline builds
it."""

from __future__ import annotations

import dataclasses


def telr_config(cfg: dict, device):
    """The TELRConfig that telr_tpu_torch/tools/genome_eval.py::run_eval
    gives run_pipeline for this configuration, routed as the CLI's
    `--wavefront auto` routes a run on `device`."""
    from telr_tpu_torch.cli import _resolve_wavefront
    from telr_tpu_torch.config import SVConfig, TELRConfig
    use_wf, stages = _resolve_wavefront("auto", None, device.type)
    tcfg = TELRConfig(sv=SVConfig(min_support=int(cfg["sv_min_support"])),
                      use_wavefront=use_wf, wavefront_stages=stages,
                      threads=int(cfg["threads"]), presets=cfg["preset"])
    tcfg.validate()
    return tcfg


def seqdicts(sample):
    """(reference, library, reads) as the program's SeqDicts."""
    from telr_tpu_torch.io.seqs import SeqDict, Sequence
    return (SeqDict([Sequence(sample.chrom, sample.genome)]),
            SeqDict([Sequence(n, c) for n, c in sample.library.items()]),
            SeqDict([Sequence(n, c) for n, c in sample.reads]))


def stage1_aligner(reference, tcfg, device):
    """run_pipeline's stage-1 Aligner: the read preset with weak secondary
    chains pruned before the DP, routed as the alignment stage is."""
    from telr_tpu_torch.kernels.mapper import Aligner
    preset = dataclasses.replace(tcfg.read_preset, chain_prune_frac=0.5)
    return Aligner(reference, preset,
                   use_wavefront=tcfg.wavefront_for("alignment"),
                   device=device)


def close_aligner(aligner) -> None:
    """Stop the Aligner's planning workers, if it started them."""
    pool = getattr(aligner, "_pool", None)
    if pool is not None:
        pool.close()
        aligner._pool = None
