"""telr_tpu_torch command line interface (`python -m telr_tpu_torch.cli`).

Mirrors the reference `telr` CLI surface (TELR_input.py:10-256) and telr_tpu's
flags: same required arguments, same tunables, same defaults.
Aligner/assembler/polisher choices are accepted for compatibility; all of them
resolve to the built-in kernels (there are no external tools to choose
between).
"""

from __future__ import annotations

import argparse
import os
import sys

from telr_tpu_torch.config import (AFConfig, AssemblyConfig, LiftoverConfig,
                                   SVConfig, TELRConfig)
from telr_tpu_torch.pipeline import run_pipeline


def get_args(argv=None):
    p = argparse.ArgumentParser(
        description="GPU program for detecting non-reference TEs in "
                    "long read data")
    required = p.add_argument_group("required arguments")
    required.add_argument("-i", "--reads", required=True,
                          help="reads in fasta/fastq format, or a "
                               "pre-aligned BAM/SAM (skips the alignment "
                               "stage, reference TELR_input.py:299-305)")
    required.add_argument("-r", "--reference", required=True,
                          help="reference genome in fasta format")
    required.add_argument("-l", "--library", required=True,
                          help="TE consensus sequences in fasta format")
    p.add_argument("--aligner", default="native",
                   help="compat option; the built-in aligner is always used")
    p.add_argument("--assembler", default="native",
                   help="compat option; the built-in assembler is always used")
    p.add_argument("--polisher", default="native",
                   help="compat option; the built-in polisher is always used")
    p.add_argument("-x", "--presets", default="pacbio",
                   choices=["pacbio", "ont"])
    p.add_argument("-p", "--polish_iterations", type=int, default=1)
    p.add_argument("-o", "--out", default=".")
    p.add_argument("-t", "--thread", type=int, default=1)
    p.add_argument("-g", "--gap", type=int, default=20,
                   help="max gap size for flanking sequence alignment")
    p.add_argument("-v", "--overlap", type=int, default=20,
                   help="max overlap size for flanking sequence alignment")
    p.add_argument("--flank_len", type=int, default=500)
    p.add_argument("--af_flank_interval", type=int, default=100)
    p.add_argument("--af_flank_offset", type=int, default=200)
    p.add_argument("--af_te_interval", type=int, default=50)
    p.add_argument("--af_te_offset", type=int, default=50)
    p.add_argument("--min_support", type=int, default=5,
                   help="min supporting reads per insertion")
    p.add_argument("--different_contig_name", action="store_true")
    p.add_argument("--minimap2_family", action="store_true",
                   help="keep the aligner-derived TE family labels instead "
                        "of re-annotating against the library (reference "
                        "default is re-annotation, TELR_input.py:137-142)")
    p.add_argument("-k", "--keep_files", action="store_true",
                   help="keep per-stage intermediate checkpoints under "
                        "<out>/intermediate_files (reference telr.py:179-180)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the device work runs: the first CUDA card "
                        "(the run fails when there is none), or the CPU, "
                        "where the kernels' plain torch versions run")
    p.add_argument("--wavefront", choices=["auto", "on", "off"],
                   default="auto",
                   help="route DP through the CUDA wavefront kernels "
                        "(auto: on a CUDA card, route the stages with "
                        "large DP batches — alignment and assembly — and "
                        "keep latency-bound stages on the native host "
                        "engine, and with --device cpu route none; on: "
                        "every stage; off: none)")
    p.add_argument("--wavefront_stages", default=None,
                   help="comma list of stages to route to the device "
                        "(overrides --wavefront; names: alignment, "
                        "te_filter, assembly, annotate, af, repeatmask, "
                        "liftover)")
    p.add_argument("--mesh_devices", type=int, default=0,
                   help="shard stage-1 DP, the locus all-to-all and depth "
                        "reductions over an N-device mesh driven by this "
                        "process: N CUDA cards, or N CPU shards under "
                        "--device cpu (0 = off).  The row-banded DP reaches "
                        "the mesh in the stages that stay off the wavefront "
                        "route, so pair it with --wavefront off")
    p.add_argument("--checkpoint_dir", default=None,
                   help="per-stage checkpoint directory (resume after the "
                        "last completed stage)")
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler trace of the run here, one "
                        "telr_stage:<name> span per stage "
                        "(telr_tpu_torch/tools/profile_report.py reads it)")
    args = p.parse_args(argv)

    for path in (args.reads, args.reference, args.library):
        if not os.path.isfile(path):
            print(f"Can not open input file: {path}", file=sys.stderr)
            sys.exit(1)
    if args.polish_iterations < 0:
        print("Please provide a valid number of iterations for polishing, "
              "exiting...", file=sys.stderr)
        sys.exit(1)
    return args


# The stages "auto" routes to the device: stage-1 mapping and the assembly
# polish realignments, the same routing as telr_tpu's.  The other stages
# stay on the native host engine under auto, though on an H100 at 10 Mb
# each ran faster on the kernels (PERF.md section 5; ROADMAP queue 1).
AUTO_WAVEFRONT_STAGES = ("alignment", "assembly")


def _resolve_wavefront(choice: str, stages: str = None,
                       device: str = "cuda"):
    """-> (use_wavefront, wavefront_stages).  "auto" follows the run's
    device: the large-batch stages on a card, none on the CPU."""
    if stages:
        return True, tuple(s.strip() for s in stages.split(",") if s.strip())
    if choice == "on":
        return True, None
    if choice == "off":
        return False, None
    return ((True, AUTO_WAVEFRONT_STAGES) if device == "cuda"
            else (False, None))


def config_from_args(args) -> TELRConfig:
    use_wf, wf_stages = _resolve_wavefront(
        getattr(args, "wavefront", "auto"),
        getattr(args, "wavefront_stages", None),
        getattr(args, "device", "cuda"))
    return TELRConfig(
        presets=args.presets,
        sv=SVConfig(min_support=args.min_support),
        assembly=AssemblyConfig(polish_iterations=args.polish_iterations),
        liftover=LiftoverConfig(flank_len=args.flank_len,
                                flank_gap_max=args.gap,
                                flank_overlap_max=args.overlap),
        af=AFConfig(flank_interval=args.af_flank_interval,
                    flank_offset=args.af_flank_offset,
                    te_interval=args.af_te_interval,
                    te_offset=args.af_te_offset),
        minimap2_family=args.minimap2_family,
        different_contig_name=args.different_contig_name,
        keep_files=args.keep_files,
        threads=args.thread,
        use_wavefront=use_wf,
        wavefront_stages=wf_stages,
    )


def main(argv=None):
    from telr_tpu_torch.utils.procpool import ensure_forkserver
    ensure_forkserver()   # before CUDA starts threads (see procpool.py)
    args = get_args(argv)
    from telr_tpu_torch.utils.device import resolve
    # the card unless the CPU was asked for; no card and no --device cpu
    # raises here, before any stage runs
    device = resolve("cpu" if args.device == "cpu" else None)
    cfg = config_from_args(args)
    cfg.validate()
    out = os.path.abspath(args.out)
    os.makedirs(out, exist_ok=True)
    # -k keeps per-stage intermediates: without an explicit checkpoint_dir,
    # route them to <out>/intermediate_files (the reference's kept tmp dir)
    ckpt_dir = args.checkpoint_dir
    if ckpt_dir is None and args.keep_files:
        ckpt_dir = os.path.join(out, "intermediate_files")
    mesh = None
    if args.mesh_devices:
        from telr_tpu_torch.dist.mesh import make_mesh
        mesh = make_mesh(args.mesh_devices, device=device)
    result = run_pipeline(args.reads, args.reference, args.library, out, cfg,
                          checkpoint_dir=ckpt_dir, device=device, mesh=mesh,
                          profile_dir=args.profile_dir)
    print("TELR finished!")
    return result


if __name__ == "__main__":
    main()
