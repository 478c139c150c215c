"""Rerun one stage of a genome-eval run under cProfile, with its device
seconds.

One module for the repository's four stage profilers, each --stage standing
for one JAX file:

  alignment  tools/profile_stage1.py   stage-1 read -> genome mapping
                                       (map_batch_parallel of the reads)
  assembly   tools/profile_assembly.py assemble_all from the alignment and
                                       te_filter checkpoints
  annotate   tools/profile_annotate.py annotate_contigs and
                                       reannotate_families from the assembly
                                       checkpoint
  af         tools/profile_af.py       estimate_af (annotate runs first,
                                       unprofiled, for its input)

It reads a workdir that telr_tpu_torch/tools/genome_eval.py wrote (reads.fa,
ref.fa, lib.fa, ckpt/; the preset from its genome_eval.json unless
--presets), reruns the stage in this process under cProfile and prints the
cumulative and own-time tables.  The stage's DPs are routed as the CLI's
--wavefront auto|on|off routes them, on the first CUDA card unless --device
cpu.  Each launch of a hand-written kernel is timed on the card with CUDA
events (on the CPU, its plain version with the host clock), so the stage's
device seconds stand beside its wall.  For assembly the wall is split into
POA (the host telr_poa_consensus_rows calls, as wall time across their
threads), the per-round prep (the per-locus index builds, the piece
planning, the wavefront batch prep and launch, the extension scheduling),
the device wait (the wavefront route's copies back, which wait for its
kernels), the pileup vote (vote_many, its device work included), and the
rest.  The last line is one JSON object.

Usage:
    python -m telr_tpu_torch.tools.profile_stage --stage assembly
        --workdir DIR [--device cuda|cpu] [--wavefront auto|on|off]
        [--threads T] [--max-loci N] [--max-reads N] [--lines N]
"""

from __future__ import annotations

import argparse
import cProfile
import io
import json
import os
import pstats
import threading
import time

STAGES = ("alignment", "assembly", "annotate", "af")
# the hoststats counters that make up assembly's per-round prep
PREP_COUNTERS = ("asm_index", "map_plan_pieces", "wave_prep", "wave_launch",
                 "ext_schedule")


class _Spy:
    """Wraps a function and times each call: its (start, end) on the host
    clock, from whichever thread made it, and CUDA events around it when its
    first argument is a tensor on a card (read after the stage, when every
    launch has ended).  Reads and writes of any other attribute (the kernels'
    launch counters, vote_many's counts) go to the wrapped function."""

    def __init__(self, fn):
        for name, value in (("fn", fn), ("spans", []), ("events", []),
                            ("lock", threading.Lock())):
            object.__setattr__(self, name, value)

    def __call__(self, *args, **kwargs):
        events = None
        if getattr(args[0] if args else None, "is_cuda", False):
            import torch
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record()
        t0 = time.perf_counter()
        try:
            return self.fn(*args, **kwargs)
        finally:
            t1 = time.perf_counter()
            if events:
                events[1].record()
            with self.lock:
                self.spans.append((t0, t1))
                if events:
                    self.events.append(events)

    def __getattr__(self, name):
        return getattr(self.fn, name)

    def __setattr__(self, name, value):
        setattr(self.fn, name, value)

    def wall(self) -> float:
        """Seconds in which some thread was inside a call."""
        total, end = 0.0, None
        for a, b in sorted(self.spans):
            if end is None or a > end:
                total += b - a
                end = b
            elif b > end:
                total += b - end
                end = b
        return total

    def device_seconds(self) -> float:
        """The card's seconds between the calls' events."""
        return sum(s.elapsed_time(e) for s, e in self.events) / 1e3


def _presets(workdir, presets):
    if presets:
        return presets
    path = os.path.join(workdir, "genome_eval.json")
    if os.path.isfile(path):
        with open(path) as f:
            if json.load(f)["workload"].get("ont_profile"):
                return "ont"
    return "pacbio"


def run(stage, workdir, device=None, wavefront="auto", threads=1,
        max_loci=0, max_reads=0, presets=None, lines=35):
    """Rerun `stage` from `workdir`; returns the report (see the module
    docstring)."""
    if stage not in STAGES:
        raise ValueError(f"stage must be one of {STAGES}, got {stage!r}")
    from telr_tpu_torch.utils.procpool import ensure_forkserver
    ensure_forkserver()   # before CUDA starts threads (see procpool.py)
    import dataclasses

    import torch

    from telr_tpu_torch.assembly import device_vote, local
    from telr_tpu_torch.cli import _resolve_wavefront
    from telr_tpu_torch.config import TELRConfig
    from telr_tpu_torch.io import native
    from telr_tpu_torch.io.fasta import read_fasta
    from telr_tpu_torch.io.seqs import SeqDict
    from telr_tpu_torch.kernels import hopper_dp, mapper
    from telr_tpu_torch.kernels import hopper_wavefront as hw
    from telr_tpu_torch.tools.bench_pipeline import device_record
    from telr_tpu_torch.utils import hoststats
    from telr_tpu_torch.utils.checkpoint import Checkpointer
    from telr_tpu_torch.utils.evallog import LociEval
    from telr_tpu_torch.utils.device import resolve

    dev = resolve(device)
    use_wf, stages = _resolve_wavefront(wavefront, device=dev.type)
    cfg = TELRConfig(presets=_presets(workdir, presets), threads=threads,
                     use_wavefront=use_wf, wavefront_stages=stages)
    cfg.validate()
    route = cfg.wavefront_for(stage)

    t0 = time.time()
    reads = read_fasta(os.path.join(workdir, "reads.fa"))
    library = read_fasta(os.path.join(workdir, "lib.fa"))
    ckpt = Checkpointer(os.path.join(workdir, "ckpt"), lock=False)
    if stage == "alignment":
        reference = read_fasta(os.path.join(workdir, "ref.fa"))
        names = [s.name for s in reads]
        if max_reads:
            names = names[:max_reads]
        queries = {n: reads[n].codes for n in names}
        preset = dataclasses.replace(cfg.read_preset, chain_prune_frac=0.5)
    else:
        store = ckpt.load_alignments("alignment")
        records = ckpt.load_records("te_filter")
        if stage == "assembly":
            if max_loci:
                records = records[:max_loci]
            extra_voters = local.collect_extra_voters(records, store,
                                                      cfg.assembly.window)
        else:
            contigs, meta = ckpt.load_seqs("assembly")
            passed = set(meta["passed"])
            if max_loci:
                keep = set(sorted(passed)[:max_loci])
                passed &= keep
                records = [r for r in records if r.locus_name in keep]
                contigs = SeqDict([contigs[n] for n in keep
                                   if n in contigs])
    ckpt.close()
    load_s = time.time() - t0

    from telr_tpu_torch.annotate.contig import (annotate_contigs,
                                                reannotate_families)

    def annotate():
        contig_te, te_seqs = annotate_contigs(
            contigs, passed, library, records, cfg.read_preset,
            cfg.annotate, LociEval(),
            use_wavefront=cfg.wavefront_for("annotate"), device=dev)
        if not cfg.minimap2_family:
            contig_te = reannotate_families(
                contig_te, te_seqs, library,
                use_wavefront=cfg.wavefront_for("annotate"), device=dev)
        return contig_te

    if stage == "af":
        contig_te = annotate()

    def body():
        if stage == "alignment":
            al = mapper.Aligner(reference, preset, use_wavefront=route,
                                device=dev)
            res = al.map_batch_parallel(queries, threads)
            return {"reads": len(queries),
                    "alignments": sum(len(v) for v in res.values())}
        if stage == "assembly":
            _contigs, ok = local.assemble_all(
                records, reads, cfg.read_preset, cfg.assembly, LociEval(),
                use_wavefront=route, extra_voters=extra_voters, device=dev)
            return {"loci": len(records), "passed": len(ok)}
        if stage == "annotate":
            return {"loci": len(passed), "annotations": len(annotate())}
        from telr_tpu_torch.af.freq import estimate_af
        te_freq = estimate_af(records, contigs, contig_te, reads, store,
                              cfg.read_preset, cfg.af, cfg.assembly,
                              use_wavefront=cfg.wavefront_for("af"),
                              device=dev)
        return {"loci": len(records), "entries": len(te_freq)}

    kernels = {"wavefront_dp": (hw, "wavefront_dp"),
               "wavefront_walk": (hw, "wavefront_walk"),
               "rowband_dp": (hopper_dp, "rowband_dp"),
               "rowband_walk": (hopper_dp, "rowband_walk")}
    timed = {k: _Spy(getattr(m, a)) for k, (m, a) in kernels.items()}
    poa = _Spy(native.poa_consensus)
    vote = _Spy(device_vote.vote_many)
    real_aligner = local.Aligner

    def indexed_aligner(*args, **kwargs):
        with hoststats.timer("asm_index"):
            return real_aligner(*args, **kwargs)

    for k, (m, a) in kernels.items():
        setattr(m, a, timed[k])
        timed[k].launches = 0
    native.poa_consensus = poa
    device_vote.vote_many = vote
    local.Aligner = indexed_aligner
    hoststats.reset()
    prof = cProfile.Profile()
    try:
        t0 = time.time()
        prof.enable()
        counts = body()
        prof.disable()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.time() - t0
    finally:
        for k, (m, a) in kernels.items():
            setattr(m, a, timed[k].fn)
        native.poa_consensus = poa.fn
        device_vote.vote_many = vote.fn
        local.Aligner = real_aligner
    counters = hoststats.snapshot()
    # on the CPU the plain versions have host seconds and no device ones
    kernels_used = {k: {"launches": t.launches,
                        "device_s": t.device_seconds() if t.events else None,
                        "host_wall_s": t.wall()}
                    for k, t in timed.items() if t.spans}

    s = io.StringIO()
    st = pstats.Stats(prof, stream=s)
    st.sort_stats("cumulative").print_stats(lines)
    st.sort_stats("tottime").print_stats(max(1, lines * 5 // 7))
    print(s.getvalue())
    top = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:15]
    report = {
        "stage": stage, "workdir": workdir, "presets": cfg.presets,
        "wavefront": route, "load_s": round(load_s, 2), "wall_s": wall,
        **counts,
        "device_s": (sum(t.device_seconds() for t in timed.values())
                     if dev.type == "cuda" else None),
        "kernels": kernels_used,
        "hoststats": counters,
        "top_own_time": [{"function": f"{fn}:{line}({name})",
                          "own_s": round(v[2], 3), "cum_s": round(v[3], 3)}
                         for (fn, line, name), v in top],
        **device_record(dev),
    }
    if stage == "assembly":
        poa_s = poa.wall()
        prep_s = sum(counters.get(k, {}).get("s", 0.0)
                     for k in PREP_COUNTERS)
        wait_s = counters.get("wave_device_wait", {}).get("s", 0.0)
        vote_s = vote.wall()
        report["split"] = {"poa_s": poa_s, "poa_calls": len(poa.spans),
                           "prep_s": prep_s, "device_wait_s": wait_s,
                           "vote_s": vote_s,
                           "rest_s": wall - poa_s - prep_s - wait_s - vote_s}
        print("assembly split: " + json.dumps(report["split"]))
    print(json.dumps(report), flush=True)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stage", required=True, choices=STAGES)
    ap.add_argument("--workdir", required=True,
                    help="a workdir of telr_tpu_torch.tools.genome_eval")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--wavefront", choices=["auto", "on", "off"],
                    default="auto")
    ap.add_argument("--threads", type=int, default=1,
                    help="host threads of the alignment stage's planning")
    ap.add_argument("--presets", choices=["pacbio", "ont"], default=None,
                    help="default: the workdir's genome_eval.json")
    ap.add_argument("--max-loci", type=int, default=0)
    ap.add_argument("--max-reads", type=int, default=0)
    ap.add_argument("--lines", type=int, default=35)
    a = ap.parse_args(argv)
    return run(a.stage, a.workdir, "cpu" if a.device == "cpu" else None,
               a.wavefront, a.threads, a.max_loci, a.max_reads, a.presets,
               a.lines)


if __name__ == "__main__":
    main()
