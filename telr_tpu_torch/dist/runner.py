"""True multi-process pipeline runner (the reference has nothing like it —
SURVEY §2c defines the distributed design this realizes).

Each process owns a READ SHARD: it parses only the reads whose
crc32(name) mod P equals its process id, maps them against the replicated
reference index, and never materializes another shard's read sequences
except through the payload all-to-all.  What crosses process boundaries:

  * alignment RECORDS (positions + CIGARs, no sequences) — all-gathered so
    every process can cluster breakpoints over the full evidence
    (SURVEY §2c "halo exchange of boundary clusters" generalized to a
    gather; records are ~100x smaller than reads),
  * insertion SIGNATURES (clipped segment strings) — all-gathered,
  * read PAYLOADS for candidate loci — the all_to_all_single payload
    redistribution (dist/redistribute.py), each locus' support + voter
    read codes landing on its compute owner,
  * per-locus RESULTS (contigs, TE intervals, AF dicts) — gathered to
    process 0, which runs the replicated tail (reference repeatmask,
    liftover, output) and writes the report files.

Determinism: signatures and alignments are sorted canonically after each
gather, so output is bit-identical to the single-process run of this same
flow (telr_tpu_torch/tools/two_process_pipeline.py asserts it).

Collectives go through torch.distributed: over NCCL on each rank's card
where every rank has a card of its own, else over gloo on host tensors
(dist/mesh.py::init_distributed); each rank's stage-1 mapping and assembly
polish rounds run on its own device (utils/device.py::resolve)."""

from __future__ import annotations

import dataclasses
import logging
import pickle
import time
import zlib
from typing import Dict, List, Optional

import numpy as np

logger = logging.getLogger("telr_tpu.dist")


def _allgather_obj(obj):
    """All-gather one pickleable object per process; returns the list of
    every process' object, in process order.  Under NCCL the pickled bytes
    travel on the current card, which init_distributed set to the rank's."""
    from telr_tpu_torch.dist.mesh import process_count
    n = process_count()
    if n == 1:
        return [obj]
    import torch.distributed as dist
    out = [None] * n
    dist.all_gather_object(out, obj)
    return out


def _aln_key(a):
    return (a.tname, a.tstart, a.tend, a.qname, a.qstart, a.strand,
            not a.primary)


def run_pipeline_multiprocess(
    reads_path: str,
    reference_path: str,
    library_path: str,
    out_dir: str,
    config=None,
    sample_name: Optional[str] = None,
    device=None,
) -> Dict[str, float]:
    """Run the pipeline with the current torch.distributed process topology
    (call dist.mesh.init_distributed first for P>1).  Every process must
    call this with identical arguments; process 0 writes the output files.
    Returns per-stage wall-clock seconds (all processes).

    device: where this rank's wavefront kernels and assembly vote run
    (None: its CUDA card, cuda:(rank % cards), and a RuntimeError when there
    is none; "cpu" runs the kernels' plain versions on the CPU)."""
    import os

    from telr_tpu_torch.utils.procpool import ensure_forkserver
    ensure_forkserver()   # before CUDA starts threads (see procpool.py)

    from telr_tpu_torch.af.freq import estimate_af
    from telr_tpu_torch.annotate.contig import (annotate_contigs,
                                                reannotate_families)
    from telr_tpu_torch.annotate.repeatmask import repeatmask_reference
    from telr_tpu_torch.assembly.local import assemble_all
    from telr_tpu_torch.config import default_config
    from telr_tpu_torch.core.alignstore import AlignmentStore
    from telr_tpu_torch.dist.mesh import (process_count, process_index,
                                          process_mesh)
    from telr_tpu_torch.dist.redistribute import (exchange_bytes_mp,
                                                  redistribute_payloads_mp)
    from telr_tpu_torch.dist.regions import RegionMap
    from telr_tpu_torch.io.fasta import read_fasta
    from telr_tpu_torch.io.seqs import SeqDict, Sequence
    from telr_tpu_torch.kernels.mapper import Aligner
    from telr_tpu_torch.liftover.engine import liftover
    from telr_tpu_torch.ops.intervals import Intervals
    from telr_tpu_torch.report.output import generate_output
    from telr_tpu_torch.sv.detect import (cluster_signatures,
                                          extract_signatures)
    from telr_tpu_torch.sv.filter import filter_te_candidates
    from telr_tpu_torch.sv.merge import merge_nearby_records
    from telr_tpu_torch.utils.evallog import LociEval

    from telr_tpu_torch.utils.device import resolve
    device = resolve(device)
    config = config or default_config()
    P = process_count()
    pid = process_index()
    mesh = process_mesh(device)
    if sample_name is None:
        sample_name = os.path.splitext(os.path.basename(reads_path))[0]
    stage_s: Dict[str, float] = {}

    def timed(name):
        class _T:
            def __enter__(self):
                self.t0 = time.time()
                return self

            def __exit__(self, *a):
                stage_s[name] = time.time() - self.t0
        return _T()

    with timed("parse_input"):
        # each process materializes ONLY its read shard
        local_reads = read_fasta(
            reads_path,
            keep=lambda n: zlib.crc32(n.encode()) % P == pid)
        reference = read_fasta(reference_path)
        library = read_fasta(library_path)

    with timed("alignment"):
        stage1_preset = dataclasses.replace(config.read_preset,
                                            chain_prune_frac=0.5)
        aligner = Aligner(reference, stage1_preset,
                          use_wavefront=config.wavefront_for("alignment"),
                          device=device)
        result = aligner.map_batch_parallel(
            {s.name: s.codes for s in local_reads}, config.threads)
        local_alns = [a for hits in result.values() for a in hits]
        local_store = AlignmentStore(local_alns)

    with timed("sv_detection"):
        # Region-sharded evidence exchange (SURVEY §2c halo exchange, not
        # full replication): the genome is split into P contiguous regions
        # balanced by bases; each process routes its alignment RECORDS,
        # signatures and junction-read codes to the region(s) their span
        # (± halo) overlaps, then clusters ONLY its own genome slice.
        # Records (tiny) are all-gathered afterwards; the former pickle
        # allgather of every alignment to every process grew sv_detection
        # 3.0s -> 10.9s at just P=2 (SCALING_r03) and was a wall at P=16.
        local_sigs = extract_signatures(local_store, local_reads,
                                        config.sv)
        regions = RegionMap(reference, P)
        send_alns: List[list] = [[] for _ in range(P)]
        for a in local_alns:
            for d in regions.dests_for_span(a.tname, a.tstart, a.tend):
                send_alns[d].append(a)
        send_sigs: List[list] = [[] for _ in range(P)]
        jnames_by_dst: List[set] = [set() for _ in range(P)]
        for s in local_sigs:
            for d in regions.dests_for_span(s.tname, s.tpos, s.tpos + 1):
                send_sigs[d].append(s)
                # junction-pair stitching needs the clipped reads' codes
                # (sv/detect.py _stitch_junctions)
                if s.kind != "ins":
                    jnames_by_dst[d].add(s.read)
        blobs = [pickle.dumps(
            (send_alns[d], send_sigs[d],
             {nm: local_reads[nm].codes
              for nm in sorted(jnames_by_dst[d]) if nm in local_reads}))
            for d in range(P)]
        recv = exchange_bytes_mp(mesh, blobs)
        region_alns: list = []
        region_sigs: list = []
        jreads = SeqDict()
        for blob in recv:
            alns_part, sigs_part, jpart = pickle.loads(blob)
            region_alns.extend(alns_part)
            region_sigs.extend(sigs_part)
            for nm in sorted(jpart):
                if nm not in jreads:
                    jreads.add(Sequence(name=nm, codes=jpart[nm]))
        region_alns.sort(key=_aln_key)
        # the region-local store: complete for every positional fetch
        # within ± halo of this region (genotype DR, voter windows, AF)
        store = AlignmentStore(region_alns)
        my_records = cluster_signatures(region_sigs, store, config.sv,
                                        sample_name, reads=jreads)
        # keep clusters anchored inside MY region (halo-side duplicates
        # of a neighbour's clusters are dropped symmetrically)
        my_records = [r for r in my_records
                      if regions.region_of(r.chrom, r.start) == pid]
        # gather the per-region records (tiny) and renumber sv_id in the
        # global canonical order: disjoint cluster position ranges make
        # (chrom, start) reproduce the single-process emission order
        records = [r for part in _allgather_obj(my_records) for r in part]
        records.sort(key=lambda r: (r.chrom, r.start, r.length))
        for k, rec in enumerate(records):
            rec.sv_id = str(k)

    loci_eval = LociEval()
    with timed("te_filter"):
        # owner-parallel TE-homology filtering: each record's outcome
        # depends only on its own INS seq, so each process filters its
        # region's records and the survivors (with te fields set) are
        # re-gathered in sv_id order
        mine = [r for r in records
                if regions.region_of(r.chrom, r.start) == pid]
        mine = filter_te_candidates(
            mine, library, loci_eval,
            use_wavefront=config.wavefront_for("te_filter"),
            device=device)
        records = [r for part in _allgather_obj(mine) for r in part]
        records.sort(key=lambda r: int(r.sv_id))
        records = merge_nearby_records(records, config.sv.merge_window)

    with timed("locus_redistribute"):
        # The REGION owner is the only process whose store covers a locus
        # window, so it resolves every per-locus read-NAME list the later
        # stages need: voters = AF-window reads (superset of the assembly
        # voters: every read with any alignment in the +-window, minus
        # support), AF breakpoint-window reads (store fetch order), and
        # primary-only polish voters.  The name lists are all-gathered —
        # they are tiny — which frees COMPUTE ownership of each locus
        # from genome-region geometry (see the LPT balance below).
        my_voters: Dict[str, List[str]] = {}
        my_window: Dict[str, List[str]] = {}
        my_extra: Dict[str, List[str]] = {}
        for rec in records:
            if regions.region_of(rec.chrom, rec.start) != pid:
                continue
            support = set(rec.reads)
            lo = max(0, rec.start - config.assembly.window)
            hi = rec.end + config.assembly.window
            near = store.fetch_read_names(rec.chrom, lo, hi)
            my_voters[rec.locus_name] = sorted(set(near) - support)
            bp = round((rec.start + rec.end) / 2)
            my_window[rec.locus_name] = store.fetch_read_names(
                rec.chrom, max(0, bp - config.assembly.window),
                bp + config.assembly.window)
            my_extra[rec.locus_name] = sorted(
                {a.qname for a in store.fetch(rec.chrom, lo, hi)
                 if a.primary} - support)
        voter_names: Dict[str, List[str]] = {}
        window_names: Dict[str, List[str]] = {}
        extra_names: Dict[str, List[str]] = {}
        for part in _allgather_obj((my_voters, my_window, my_extra)):
            voter_names.update(part[0])
            window_names.update(part[1])
            extra_names.update(part[2])
        # Deterministic LPT balance of locus COMPUTE ownership: region
        # ownership concentrates loci wherever the genome puts them, and
        # the resulting straggler skew surfaced as a 72s gather_results
        # barrier wait at P=2 (SCALING_r04 first cut).  Weight = routed
        # read count (support + voters), a good proxy for the realign
        # cost that dominates assembly/AF.  Every process derives the
        # same assignment from the same all-gathered inputs, so the
        # payload routing keys agree without further communication.
        weights = [(len(rec.reads) + len(voter_names[rec.locus_name]), li)
                   for li, rec in enumerate(records)]
        loads = [0] * P
        owner_of_li: Dict[int, int] = {}
        for w, li in sorted(weights, key=lambda t: (-t[0], t[1])):
            p = min(range(P), key=lambda q: (loads[q], q))
            owner_of_li[li] = p
            loads[p] += w
        # payload routing key: encoded so that key % P == compute owner
        # (the redistribute contract) and li = key // P
        items = []
        name_of: Dict[tuple, str] = {}
        for li, rec in enumerate(records):
            key = li * P + owner_of_li[li]
            for kind, names in ((0, rec.reads),
                                (1, voter_names[rec.locus_name])):
                for rank, rn in enumerate(names):
                    name_of[(li, rank, kind)] = rn
                    if rn in local_reads:
                        items.append((key, rank, kind,
                                      local_reads[rn].codes))
        got = redistribute_payloads_mp(mesh, items)
        shard_reads = SeqDict()
        for key, rank, kind, codes in got:
            rn = name_of[(key // P, rank, kind)]
            if rn not in shard_reads:
                shard_reads.add(Sequence(name=rn, codes=codes))

    owned = [(li, rec) for li, rec in enumerate(records)
             if owner_of_li[li] == pid]
    own_recs = [rec for _li, rec in owned]

    with timed("assembly"):
        # primary-only voters for the polish vote (collect_extra_voters
        # semantics), names resolved by the REGION owner above
        extra_voters = {rec.locus_name: extra_names[rec.locus_name]
                        for rec in own_recs}
        contigs, passed = assemble_all(
            own_recs, shard_reads, config.read_preset, config.assembly,
            loci_eval, use_wavefront=config.wavefront_for("assembly"),
            extra_voters=extra_voters, device=device)

    with timed("annotate_contig"):
        contig_te, te_seqs = annotate_contigs(
            contigs, passed, library, own_recs, config.read_preset,
            config.annotate, loci_eval,
            use_wavefront=config.wavefront_for("annotate"), device=device)
        if not config.minimap2_family:
            contig_te = reannotate_families(
                contig_te, te_seqs, library,
                use_wavefront=config.wavefront_for("annotate"),
                device=device)

    with timed("allele_frequency"):
        te_freq = estimate_af(own_recs, contigs, contig_te, shard_reads,
                              store, config.read_preset, config.af,
                              config.assembly,
                              use_wavefront=config.wavefront_for("af"),
                              window_names=window_names, device=device)

    with timed("ref_repeatmask"):
        # chain-job-sharded reference repeatmask: family sharding was
        # flat 33-43 s from 1p to 4p (SCALING_r04*) because one
        # high-copy family carries nearly all the chain jobs; sharding
        # the jobs themselves round-robin balances regardless of the
        # library's copy-count skew, and the merged postprocess is
        # bit-identical to the serial run (annotate/repeatmask.py).
        ref_te = repeatmask_reference(
            reference, library,
            use_wavefront=config.wavefront_for("repeatmask"),
            shard=(pid, P), allgather=_allgather_obj, device=device)
        ref_rows = [ref_te.row(i) for i in range(len(ref_te))]

    with timed("gather_results"):
        payload = {
            "contigs": [(s.name, s.codes) for s in contigs],
            "passed": sorted(passed),
            "te_rows": [(contig_te.chrom[i], int(contig_te.start[i]),
                         int(contig_te.end[i]),
                         *(contig_te.cols[c][i] for c in contig_te.cols))
                        for i in range(len(contig_te))],
            "te_cols": list(contig_te.cols.keys()),
            "te_seqs": [(s.name, s.codes) for s in te_seqs],
            "te_freq": te_freq,
            "loci_eval": loci_eval.entries,
        }
        parts = _allgather_obj(payload)

    if pid != 0:
        return stage_s

    # ---- process 0: merge per-owner results in canonical records order,
    # then run the replicated tail and write outputs
    by_name: Dict[str, np.ndarray] = {}
    passed_all: set = set()
    te_rows_all: List[tuple] = []
    te_cols = parts[0]["te_cols"]
    te_seq_map: Dict[str, np.ndarray] = {}
    te_freq_all: Dict[str, dict] = {}
    eval_map: Dict[str, List[tuple]] = {}
    for part in parts:
        by_name.update({n: c for n, c in part["contigs"]})
        passed_all.update(part["passed"])
        te_rows_all.extend(tuple(r) for r in part["te_rows"])
        te_seq_map.update({n: c for n, c in part["te_seqs"]})
        te_freq_all.update(part["te_freq"])
        for locus, reason in part["loci_eval"]:
            eval_map.setdefault(locus, []).append((locus, reason))

    order = {rec.locus_name: li for li, rec in enumerate(records)}
    contigs = SeqDict()
    for rec in records:
        if rec.locus_name in by_name:
            contigs.add(Sequence(name=rec.locus_name,
                                 codes=by_name[rec.locus_name]))
    te_rows_all.sort(key=lambda r: (order.get(r[0], 1 << 30), r[1], r[2]))
    contig_te = Intervals.from_rows(te_rows_all, te_cols)
    te_seqs = SeqDict()
    for name in sorted(te_seq_map,
                       key=lambda n: (order.get(n.rpartition(":")[0],
                                                1 << 30), n)):
        te_seqs.add(Sequence(name=name, codes=te_seq_map[name]))
    te_freq = {rec.locus_name: te_freq_all[rec.locus_name]
               for rec in records if rec.locus_name in te_freq_all}
    merged_eval = LociEval()
    for rec in records:
        for e in eval_map.get(rec.locus_name, []):
            merged_eval.entries.append(e)

    ref_te_bed = Intervals.from_rows(
        ref_rows, ("family", "score", "strand")).sort()
    if len(ref_te_bed) == 0:
        ref_te_bed = None

    with timed("liftover"):
        lift_report, _nonref_bed, summary = liftover(
            contigs, reference, contig_te, ref_te_bed, config.liftover,
            different_contig_name=config.different_contig_name,
            telr_mode=True,
            use_wavefront=config.wavefront_for("liftover"),
            device=device)
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
                te_seqs.add(Sequence(name=ins_name,
                                     codes=contigs[cname].slice(cs, ce)))

    with timed("output"):
        os.makedirs(out_dir, exist_ok=True)
        generate_output(lift_report, te_freq, te_seqs, records, contig_te,
                        contigs, reference, out_dir, sample_name,
                        ref_path=reference_path)
        merged_eval.write(os.path.join(out_dir,
                                       sample_name + ".loci_eval.tsv"))
    return stage_s
