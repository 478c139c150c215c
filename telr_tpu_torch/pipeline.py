"""The telr_tpu_torch pipeline driver.

Mirrors the reference's four-stage flow (telr.py:22-189) with sharded arrays
and in-memory records as the ABI instead of intermediate files:

  stage 1a  read -> reference alignment           (TELR_alignment.alignment)
  stage 1b  insertion detection + TE filter + merge  (TELR_sv)
  stage 2   per-locus assembly + polish           (TELR_assembly)
  stage 3a  contig TE annotation                  (TELR_te.annotate_contig)
  stage 4   allele frequency                      (TELR_te.get_af)
  ref mask  reference repeatmask -> ref TE bed    (TELR_te.repeatmask)
  stage 3b  flank liftover + classification       (TELR_liftover.liftover)
  output    VCF/JSON/BED/fasta                    (TELR_output.generate_output)

One process drives one device: the stages routed to the wavefront kernels
(cli.AUTO_WAVEFRONT_STAGES under auto routing) and the assembly vote run on
the `device` handed to run_pipeline.  With a `mesh` (dist/mesh.py) the
stage-1 DP batches that stay off the wavefront route run on the mesh's
devices instead of the native host engine, every (locus, read) payload goes
through the locus all-to-all before assembly, and AF depth is reduced over
the mesh.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import time
from typing import Dict, List, Optional

from telr_tpu_torch.af.freq import estimate_af
from telr_tpu_torch.annotate.contig import annotate_contigs, reannotate_families
from telr_tpu_torch.annotate.repeatmask import repeatmask_reference
from telr_tpu_torch.assembly.local import assemble_all, collect_extra_voters
from telr_tpu_torch.config import TELRConfig, default_config
from telr_tpu_torch.core.alignstore import AlignmentStore
from telr_tpu_torch.io.fasta import read_fasta
from telr_tpu_torch.io.seqs import SeqDict
from telr_tpu_torch.kernels.mapper import Aligner
from telr_tpu_torch.liftover.engine import liftover
from telr_tpu_torch.ops.intervals import Intervals
from telr_tpu_torch.report.output import generate_output
from telr_tpu_torch.sv.detect import SVRecord, detect_insertions
from telr_tpu_torch.sv.filter import filter_te_candidates
from telr_tpu_torch.sv.merge import merge_nearby_records
from telr_tpu_torch.utils import hoststats
from telr_tpu_torch.utils.checkpoint import Checkpointer
from telr_tpu_torch.utils.evallog import LociEval

logger = logging.getLogger("telr_tpu")


def _redistribute_loci(mesh, records: List[SVRecord], reads: SeqDict,
                       extra_voters: Dict[str, List[str]]
                       ) -> "SeqDict":
    """Route every (locus, read) PAYLOAD through the device all-to-all to
    its locus' owner shard and rebuild the assembly-stage read set from
    what the owner received (SURVEY §2c locus redistribution; replaces
    the reference's csplit per-locus read files TELR_assembly.py:418-456).

    Items are (locus_id, rank, kind, read_codes) — kind 0 = supporting
    read (rank indexes rec.reads), kind 1 = extra voter (rank indexes
    extra_voters[locus]).  Source shard = crc32(read name) mod S (the
    data-parallel read layout), owner = locus_id mod S.  Assembly then
    consumes ONLY the received codes: on a single host they must
    reproduce the local reads bit-for-bit — a routing or payload bug
    surfaces as a hard error, so the collective is load-bearing, not
    decorative."""
    import zlib

    import numpy as np

    from telr_tpu_torch.dist.mesh import READS_AXIS
    from telr_tpu_torch.dist.redistribute import owner_of, redistribute_payloads
    from telr_tpu_torch.io.seqs import Sequence

    n = int(mesh.shape[READS_AXIS])
    items_per_shard: List[List[tuple]] = [[] for _ in range(n)]
    name_of: Dict[tuple, str] = {}
    for li, rec in enumerate(records):
        for kind, names in ((0, rec.reads),
                            (1, extra_voters.get(rec.locus_name, []))):
            for rank, rn in enumerate(names):
                src = zlib.crc32(rn.encode()) % n
                items_per_shard[src].append(
                    (li, rank, kind, reads[rn].codes))
                name_of[(li, rank, kind)] = rn
    n_items = sum(len(x) for x in items_per_shard)
    if n_items == 0:
        return reads
    merged = redistribute_payloads(mesh, items_per_shard)
    got: Dict[tuple, np.ndarray] = {}
    for dst, lst in enumerate(merged):
        for li, rank, kind, codes in lst:
            if owner_of(li, n) != dst:
                raise RuntimeError(
                    f"locus {li} landed on shard {dst}, owner is "
                    f"{owner_of(li, n)}")
            got[(li, rank, kind)] = codes
    if set(got) != set(name_of):
        raise RuntimeError("locus redistribution dropped or duplicated "
                           "(locus, read) items")
    rebuilt = SeqDict()
    for key, codes in got.items():
        rn = name_of[key]
        if not np.array_equal(codes, reads[rn].codes):
            raise RuntimeError(
                f"locus redistribution corrupted read payload for {rn}")
        if rn not in rebuilt:
            rebuilt.add(Sequence(name=rn, codes=codes))
    logger.info("locus all-to-all: %d payload items (%d unique reads), "
                "%d loci over %d shards", n_items, len(rebuilt),
                len(records), n)
    return rebuilt


def _input_fingerprint(paths, config: TELRConfig) -> str:
    """Content hash of the input files + the semantic config fields.

    Execution knobs (threads, wavefront backend, keep_files) are
    excluded on purpose: they must not invalidate checkpoints, because
    both backends produce identical alignments and the knobs don't
    change results."""
    import hashlib
    h = hashlib.blake2b(digest_size=16)
    for p in paths:
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            while True:
                chunk = f.read(1 << 22)
                if not chunk:
                    break
                h.update(chunk)
    sem = (config.presets, config.sv, config.assembly, config.annotate,
           config.af, config.liftover, config.minimap2_family,
           config.different_contig_name, config.read_preset)
    h.update(repr(sem).encode())
    return h.hexdigest()


PROFILE_TRACE = "telr.trace.json.gz"
STAGE_SPAN = "telr_stage:"
# a RecordFunction entered at the profiler's start, with time.perf_counter
# read inside it: it puts the program's spans on the trace's clock
CLOCK_MARK = "telr:clock"
SPAN_CAT = "telr_span"


def _start_profiler(device):
    """A running torch.profiler over the host and, on a card, its kernels
    and copies.  No shapes, stacks or memory events: a trace holds one small
    record per torch op, launch and device event, a few per kernel launch on
    a card.  Under device="cpu" every op of the kernels' plain versions is
    in it too, which on the mesh path runs to hundreds of MB."""
    import torch
    from torch.profiler import ProfilerActivity
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities, record_shapes=False,
                                  with_stack=False, profile_memory=False,
                                  with_flops=False, with_modules=False)
    prof.start()
    with torch._C._profiler._RecordFunctionFast(CLOCK_MARK):
        prof.telr_clock = time.perf_counter()
    return prof


def _stop_profiler(prof, profile_dir: str) -> Dict[str, float]:
    """Stop the profiler and write its trace, with the spans the program
    recorded meanwhile (utils/hoststats.py; the profiler saw those of the
    main thread alone, without their attributes) added as "X" events of
    category SPAN_CAT on the trace's clock: all but the stage spans, which
    the trace holds as the profiler's own events.  Returns each stage
    span's seconds as the trace records them."""
    import gzip
    import tempfile
    import torch
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, PROFILE_TRACE)
    fd, raw = tempfile.mkstemp(suffix=".json", dir=profile_dir)
    os.close(fd)
    try:
        prof.export_chrome_trace(raw)
        with open(raw) as f:
            trace = json.load(f)
    finally:
        os.remove(raw)
    trace["traceEvents"] += _span_events(
        trace, prof.telr_clock, [s for s in hoststats.drain_spans()
                                 if not s.name.startswith(STAGE_SPAN)])
    with gzip.open(path, "wt") as f:
        json.dump(trace, f)
    size = os.path.getsize(path)
    logger.info("profiler trace written to %s (%d bytes)", path, size)
    print(f"profiler trace: {path} ({size} bytes)")
    cpu = torch.autograd.DeviceType.CPU
    return {e.name()[len(STAGE_SPAN):]: e.duration_ns() / 1e9
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == cpu and e.name().startswith(STAGE_SPAN)}


def _span_events(trace: dict, clock: float, spans) -> List[dict]:
    """The program's spans as chrome-trace "X" events, placed by the
    CLOCK_MARK event: its start on the trace's clock is `clock` on
    time.perf_counter's."""
    marks = [float(e["ts"]) for e in trace.get("traceEvents", [])
             if e.get("ph") == "X" and e.get("name") == CLOCK_MARK]
    if not marks:
        logger.warning("the profiler trace has no %s event: the program's "
                       "spans are left out of it", CLOCK_MARK)
        return []
    pid = os.getpid()
    return [{"ph": "X", "cat": SPAN_CAT, "name": s.name, "pid": pid,
             "tid": s.tid, "ts": marks[0] + (s.t0 - clock) * 1e6,
             "dur": (s.t1 - s.t0) * 1e6,
             "args": dict(s.attrs, id=s.id, parent=s.parent)}
            for s in spans]


@dataclasses.dataclass
class PipelineResult:
    sample_name: str
    records: List[SVRecord]
    contigs: SeqDict
    contig_te: Intervals
    te_freq: Dict[str, dict]
    liftover_report: List[dict]
    summary: dict
    final_report: List[dict]
    loci_eval: LociEval
    stage_seconds: Dict[str, float]
    # stages whose stage_seconds reflect a checkpoint restore, not compute —
    # throughput derived from them is meaningless
    restored_stages: List[str] = dataclasses.field(default_factory=list)


def run_pipeline(
    reads_path: str,
    reference_path: str,
    library_path: str,
    out_dir: str,
    config: Optional[TELRConfig] = None,
    sample_name: Optional[str] = None,
    checkpoint_dir: Optional[str] = None,
    device=None,
    mesh=None,
    profile_dir: Optional[str] = None,
) -> PipelineResult:
    """device: where the wavefront DP kernels and the assembly vote run
    (None: the first CUDA card, and a RuntimeError when there is none;
    "cpu" runs the kernels' plain versions on the CPU).

    mesh: optional dist.mesh.Mesh with a "reads" axis.  When given,
    stage-1 DP batches execute sharded over the mesh, candidate loci are
    redistributed with the device all-to-all before assembly, and AF depth
    reductions are summed over the "reads" axis.

    profile_dir: write a torch.profiler trace of the run there
    (PROFILE_TRACE, gzipped chrome JSON) with one `telr_stage:<name>` span
    per stage; telr_tpu_torch/tools/profile_report.py attributes the
    card's kernels and copies to the stages."""
    from telr_tpu_torch.utils.procpool import ensure_forkserver
    ensure_forkserver()   # before CUDA starts threads (see procpool.py)
    from telr_tpu_torch.utils.device import resolve
    device = resolve(device)
    config = config or default_config()
    prof = _start_profiler(device) if profile_dir else None
    os.makedirs(out_dir, exist_ok=True)
    if sample_name is None:
        sample_name = os.path.splitext(os.path.basename(reads_path))[0]
    ckpt = Checkpointer(checkpoint_dir)
    if checkpoint_dir:
        # stage checkpoints are keyed by name only — fingerprint the
        # inputs + semantic config so a rerun with different reads or
        # thresholds can never silently resume stale results
        fp = _input_fingerprint(
            (reads_path, reference_path, library_path), config)
        if not ckpt.validate_fingerprint(fp):
            logger.warning("checkpoint inputs/config changed; existing "
                           "checkpoints invalidated")

    logging.basicConfig(
        level=logging.INFO,
        filename=os.path.join(out_dir, "TELR.log"),
        filemode="w",
        format="%(asctime)s: %(levelname)s: %(message)s",
        datefmt="%m/%d/%Y %H:%M:%S",
    )

    stage_seconds: Dict[str, float] = {}
    restored_stages: List[str] = []

    @contextlib.contextmanager
    def timed(name):
        # the stage's span (hoststats: in the profiler's trace under
        # --profile_dir), so tools/profile_report.py can attribute device
        # time to it
        logger.info("stage %s ...", name)
        t0 = time.time()
        try:
            with hoststats.timer(STAGE_SPAN + name):
                yield
        finally:
            stage_seconds[name] = time.time() - t0
            logger.info("stage %s finished in %.2fs", name,
                        stage_seconds[name])

    # pre-aligned input (BAM/SAM) skips stage 1a, mirroring the reference's
    # BAM path (TELR_input.py:299-305, telr.py:58-61); reads are
    # reconstructed from the alignment records like `samtools fasta`
    prealigned = reads_path.endswith((".bam", ".sam", ".sam.gz"))
    with timed("parse_input"):
        if prealigned:
            from telr_tpu_torch.io.samio import read_alignment_file
            store, reads = read_alignment_file(reads_path)
            logger.info("pre-aligned input provided, skip alignment step")
        else:
            reads = read_fasta(reads_path)
            store = None
        reference = read_fasta(reference_path)
        library = read_fasta(library_path)
    loci_eval = LociEval()

    with timed("alignment"):
        if store is not None:
            pass  # pre-aligned input
        elif ckpt.has("alignment"):
            store = ckpt.load_alignments("alignment")
            logger.info("alignment stage restored from checkpoint")
            restored_stages.append("alignment")
        else:
            # stage-1 genome mapping prunes weak secondary chains before
            # the DP (minimap2-style) — the big mapping-throughput lever
            # on repeat-dense genomes; per-locus realignments keep every
            # chain (the AF depth windows count all local reads)
            stage1_preset = dataclasses.replace(config.read_preset,
                                                chain_prune_frac=0.5)
            aligner = Aligner(reference, stage1_preset,
                              use_wavefront=config.wavefront_for("alignment"),
                              device=device, mesh=mesh)
            result = aligner.map_batch_parallel(
                {s.name: s.codes for s in reads}, config.threads)
            alns = [a for hits in result.values() for a in hits]
            store = AlignmentStore(alns)
            ckpt.save_alignments("alignment", store)

    if ("alignment" in stage_seconds and stage_seconds["alignment"] > 0
            and "alignment" not in restored_stages and not prealigned):
        n_bases = sum(len(s) for s in reads)
        logger.info(
            "alignment throughput: %.2f reads/s, %.3f Mbases/s "
            "(%d reads, %d alignments)",
            len(reads) / stage_seconds["alignment"],
            n_bases / 1e6 / stage_seconds["alignment"],
            len(reads), len(store))
        logger.info("alignment breakdown: %s", hoststats.snapshot())
        hoststats.reset()

    with timed("sv_detection"):
        records = detect_insertions(store, reads, config.sv, sample_name)

    with timed("te_filter"):
        if ckpt.has("te_filter"):
            records = ckpt.load_records("te_filter")
            logger.info("te_filter stage restored from checkpoint")
            restored_stages.append("te_filter")
        else:
            records = filter_te_candidates(
                records, library, loci_eval,
                use_wavefront=config.wavefront_for("te_filter"),
                device=device)
            records = merge_nearby_records(records, config.sv.merge_window)
            ckpt.save_records("te_filter", records)

    # non-support reads overlapping each locus polish the flank
    # columns to full local depth (the other haplotype + flank-only
    # reads; assemble_all guards against deletion-of-the-TE votes)
    assembly_reads = reads
    extra_voters = None
    if mesh is not None and records and not ckpt.has("assembly"):
        with timed("locus_redistribute"):
            # device all-to-all: co-locate each locus' read PAYLOADS
            # (support + voter codes) on its owner shard before batched
            # assembly (SURVEY §2c); assembly consumes only the received
            # codes
            extra_voters = collect_extra_voters(
                records, store, config.assembly.window)
            assembly_reads = _redistribute_loci(mesh, records, reads,
                                                extra_voters)

    with timed("assembly"):
        if ckpt.has("assembly"):
            contigs, extra = ckpt.load_seqs("assembly")
            passed = set(extra.get("passed", []))
            logger.info("assembly stage restored from checkpoint")
            restored_stages.append("assembly")
        else:
            if extra_voters is None:
                extra_voters = collect_extra_voters(
                    records, store, config.assembly.window)
            contigs, passed = assemble_all(
                records, assembly_reads, config.read_preset,
                config.assembly, loci_eval,
                use_wavefront=config.wavefront_for("assembly"),
                extra_voters=extra_voters, device=device)
            ckpt.save_seqs("assembly", contigs,
                           {"passed": sorted(passed)})
    if (records and stage_seconds.get("assembly", 0) > 0
            and "assembly" not in restored_stages):
        logger.info("assembly throughput: %.3f loci/s (%d loci)",
                    len(records) / stage_seconds["assembly"], len(records))

    with timed("annotate_contig"):
        contig_te, te_seqs = annotate_contigs(
            contigs, passed, library, records, config.read_preset,
            config.annotate, loci_eval,
            use_wavefront=config.wavefront_for("annotate"), device=device)
        if not config.minimap2_family:
            contig_te = reannotate_families(
                contig_te, te_seqs, library,
                use_wavefront=config.wavefront_for("annotate"),
                device=device)

    with timed("allele_frequency"):
        te_freq = estimate_af(records, contigs, contig_te, reads, store,
                              config.read_preset, config.af, config.assembly,
                              use_wavefront=config.wavefront_for("af"),
                              mesh=mesh, device=device)

    with timed("ref_repeatmask"):
        # checkpointed: depends only on (reference, library), and the
        # whole-genome homology sweep is among the most expensive stages
        # at scale (the reference RepeatMasks the full genome every run,
        # TELR_te.py:391-433)
        if ckpt.has("ref_repeatmask"):
            ref_te_bed = ckpt.load_intervals("ref_repeatmask")
        else:
            ref_te_bed = repeatmask_reference(
                reference, library,
                use_wavefront=config.wavefront_for("repeatmask"),
                device=device)
            ckpt.save_intervals("ref_repeatmask", ref_te_bed)
        if len(ref_te_bed) == 0:
            ref_te_bed = None

    with timed("liftover"):
        lift_report, nonref_bed, summary = liftover(
            contigs, reference, contig_te, ref_te_bed, config.liftover,
            different_contig_name=config.different_contig_name,
            telr_mode=True,
            use_wavefront=config.wavefront_for("liftover"),
            device=device)
        # component-retry entries (liftover/engine.py) carry sub-interval
        # coords the annotate stage never extracted; slice their TE
        # sequences now so the output stage can look them up
        from telr_tpu_torch.io.seqs import Sequence as _Seq
        for item in lift_report:
            info = item.get("report")
            if not info or info.get("type") != "non-reference":
                continue
            ins_name = item["genome1_coord"]
            if ins_name in te_seqs:
                continue
            cname, _, coord = ins_name.rpartition(":")
            if cname in contigs:
                cs, ce = (int(x) for x in coord.split("-"))
                te_seqs.add(_Seq(name=ins_name,
                                 codes=contigs[cname].slice(cs, ce)))

    with timed("output"):
        final = generate_output(
            lift_report, te_freq, te_seqs, records, contig_te, contigs,
            reference, out_dir, sample_name, ref_path=reference_path)
        # run provenance (the reference exports its conda env,
        # telr.py:184-185 / TELR_utility.py:76-89)
        import sys
        import numpy as np
        import torch
        import telr_tpu_torch
        with open(os.path.join(out_dir, "run_env.json"), "w") as f:
            json.dump({
                "telr_tpu_torch": telr_tpu_torch.__version__,
                "python": sys.version.split()[0],
                "torch": torch.__version__,
                "cuda": torch.version.cuda,
                "device": (torch.cuda.get_device_name(device)
                           if device.type == "cuda" else str(device)),
                "numpy": np.__version__,
                "config": dataclasses.asdict(config),
            }, f, indent=2)
        loci_eval.write(os.path.join(out_dir,
                                     sample_name + ".loci_eval.tsv"))
        with open(os.path.join(out_dir, "liftover_summary.json"), "w") as f:
            json.dump(summary, f, indent=4, sort_keys=False)
        with open(os.path.join(out_dir, "liftover_report.json"), "w") as f:
            json.dump(lift_report, f, indent=4, sort_keys=False)

    if prof is not None:
        # a profiled run's stage seconds are its spans' own: one pair of
        # clock reads gives both, however briefly the stage ran
        stage_seconds.update(_stop_profiler(prof, profile_dir))

    if not final:
        print("No non-reference TE insertion found")
        logger.info("TELR found no non-reference TE insertions")

    ckpt.close()  # release the checkpoint-dir lock
    return PipelineResult(
        sample_name=sample_name, records=records, contigs=contigs,
        contig_te=contig_te, te_freq=te_freq, liftover_report=lift_report,
        summary=summary, final_report=final, loci_eval=loci_eval,
        stage_seconds=stage_seconds,
        restored_stages=restored_stages)
