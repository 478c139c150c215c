"""Contig TE annotation: locate the TE interval on each assembled contig.

Port of the reference's annotate_contig (TELR_te.py:21-381):

  1. map each locus' Sniffles INS sequence to its contig (minimap2 -cx map-pb
     --secondary=no, TELR_te.py:68-78) -> seq2contig intervals,
  2. map the TE library to each contig (TELR_te.py:118-132) -> te2contig
     intervals with family + strand,
  3. bedtools intersect -wao between them, keep TE-contig hits overlapping
     the INS-seq placement by >10bp (TELR_te.py:146-175),
  4. bedtools merge -d 10000 with distinct collapse of family/strand
     (TELR_te.py:199-230); mixed strands become '.',
  5. extract TE sequences (bedtools getfasta naming 'contig:start-end',
     TELR_te.py:254-265).

Family labels come from the aligner (the --minimap2_family path,
TELR_te.py:110-142); a RepeatMasker-style re-annotation using the LOCAL
library aligner is available via `reannotate_families`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from telr_tpu_torch.config import AnnotateConfig, AlignPreset, LIB_TO_SEQ
from telr_tpu_torch.io.seqs import SeqDict, Sequence, encode
from telr_tpu_torch.kernels.mapper import Aligner
from telr_tpu_torch.ops.intervals import Intervals, intersect_wao, merge_intervals
from telr_tpu_torch.sv.detect import SVRecord
from telr_tpu_torch.utils import hoststats
from telr_tpu_torch.utils.evallog import LociEval


@hoststats.timed("annotate")
def annotate_contigs(
    contigs: SeqDict,
    passed_loci: Set[str],
    library: SeqDict,
    records: List[SVRecord],
    read_preset: AlignPreset,
    cfg: AnnotateConfig,
    loci_eval: LociEval,
    use_wavefront: bool = False,
    device=None,
) -> Tuple[Intervals, SeqDict]:
    """Returns (contig TE annotation intervals with family/strand cols,
    TE sequences named 'contig:start-end').

    The per-locus INS-seq->contig and library->contig mappings (reference
    serial loops at TELR_te.py:54-84, 113-133) are pooled into one grouped
    DP dispatch each via `map_batch_grouped`."""
    from telr_tpu_torch.kernels.mapper import map_batch_grouped
    rec_by_locus = {r.locus_name: r for r in records}

    # 1. INS seq -> contig (primary only), all loci in one dispatch.
    # The INS sequence is a single-read fragment at read error rate, so
    # seed with the sensitive small-k profile — exact 15-mers are too
    # sparse on short noisy fragments (reference relies on minimap2's
    # HPC seeding for the same reason, TELR_te.py:68-78)
    import dataclasses as _dc
    ins_preset = _dc.replace(read_preset, k=11, w=5,
                             min_chain_anchors=2, min_chain_score=24)
    step1_loci = [locus for locus in sorted(passed_loci)
                  if rec_by_locus.get(locus) is not None
                  and locus in contigs]
    groups1 = []
    for locus in step1_loci:
        aligner = Aligner(SeqDict([contigs[locus]]), ins_preset,
                          use_wavefront=use_wavefront, device=device)
        groups1.append((aligner,
                        {locus: encode(rec_by_locus[locus].seq)}))
    seq2contig_rows = []
    seq2contig_passed: Set[str] = set()
    for locus, result in zip(step1_loci, map_batch_grouped(groups1)):
        hits = [a for a in result[locus] if a.primary]
        if not hits:
            loci_eval.add(locus, "VCF sequence not mapped to contig")
            continue
        best = max(hits, key=lambda a: a.score)
        seq2contig_rows.append((best.tname, best.tstart, best.tend,
                                locus, best.mapq, best.strand))
        seq2contig_passed.add(locus)
    seq2contig = Intervals.from_rows(seq2contig_rows,
                                     ("name", "score", "strand"))

    # 2. TE library -> contig, all loci in one dispatch
    step2_loci = sorted(seq2contig_passed)
    groups2 = []
    for locus in step2_loci:
        aligner = Aligner(SeqDict([contigs[locus]]), read_preset,
                          use_wavefront=use_wavefront, device=device)
        groups2.append((aligner, {s.name: s.codes for s in library}))
    te2contig_rows = []
    for locus, result in zip(step2_loci, map_batch_grouped(groups2)):
        for s in library:
            for a in result[s.name]:
                te2contig_rows.append((a.tname, a.tstart, a.tend,
                                       s.name, a.mapq, a.strand))
    te2contig = Intervals.from_rows(te2contig_rows,
                                    ("family", "score", "strand"))

    # 3. intersect -wao, keep overlap > min_seq_overlap
    kept_rows = []
    for a_idx, b_idx, ov in intersect_wao(te2contig, seq2contig):
        if b_idx >= 0 and ov > cfg.min_seq_overlap:
            kept_rows.append(te2contig.row(a_idx))
    kept = Intervals.from_rows(kept_rows, ("family", "score", "strand")).sort()

    # loci whose INS placement has no overlapping TE annotation
    overlap_loci = set(kept.chrom)
    for locus in sorted(seq2contig_passed):
        if locus not in overlap_loci:
            loci_eval.add(locus,
                          "VCF sequence doesn't overlap contig annotation")

    # 4. merge -d merge_dist, distinct family/strand
    merged = merge_intervals(kept, dist=cfg.merge_dist,
                             collapse={"family": "distinct",
                                       "strand": "distinct"}, delim="|")
    # per-family dist=0 sub-blocks of each merged annotation: the -d 10000
    # rule (reference parity, TELR_te.py:199-230) can weld a novel
    # insertion to a nearby reference TE copy present on the same contig
    # (or even NESTED inside one — an insertion planted within a reference
    # TE leaves the host family's alignment spanning straight across it);
    # the welded interval then classifies "reference" at liftover (flank
    # gap spans the reference copy) and the real insertion is lost.
    # Record each family's own blocks so the liftover engine can re-lift
    # them individually when that happens (component retry).
    fam_blocks: List[Intervals] = []
    fams = sorted({f for f in kept.cols.get("family", [])})
    for fam in fams:
        sub = kept.take([j for j in range(len(kept))
                         if kept.cols["family"][j] == fam])
        fam_blocks.append(merge_intervals(
            sub, dist=0, collapse={"family": "distinct",
                                   "strand": "distinct"}, delim="|"))
    ann_rows = []
    for i in range(len(merged)):
        strand = merged.cols["strand"][i]
        if strand not in ("+", "-"):
            strand = "."
        comp = []
        for blocks in fam_blocks:
            for j in range(len(blocks)):
                if (blocks.chrom[j] == merged.chrom[i]
                        and int(blocks.start[j]) >= int(merged.start[i])
                        and int(blocks.end[j]) <= int(merged.end[i])):
                    bstr = blocks.cols["strand"][j]
                    comp.append("%d-%d:%s:%s" % (
                        int(blocks.start[j]), int(blocks.end[j]),
                        blocks.cols["family"][j],
                        bstr if bstr in ("+", "-") else "."))
        comp.sort(key=lambda c: int(c.split("-", 1)[0]))
        ann_rows.append((merged.chrom[i], int(merged.start[i]),
                         int(merged.end[i]), merged.cols["family"][i],
                         ".", strand,
                         ";".join(comp) if len(comp) > 1 else ""))
    annotation = Intervals.from_rows(
        ann_rows, ("family", "score", "strand", "components")).sort()

    # 5. TE sequences (bedtools getfasta naming)
    te_seqs = SeqDict()
    for i in range(len(annotation)):
        cname = annotation.chrom[i]
        s, e = int(annotation.start[i]), int(annotation.end[i])
        te_seqs.add(Sequence(
            name=f"{cname}:{s}-{e}",
            codes=contigs[cname].slice(s, e)))
    return annotation, te_seqs


@hoststats.timed("annotate.families")
def reannotate_families(
    annotation: Intervals,
    te_seqs: SeqDict,
    library: SeqDict,
    preset: AlignPreset = LIB_TO_SEQ,
    use_wavefront: bool = False,
    device=None,
) -> Intervals:
    """RepeatMasker-style family re-annotation of the contig TE sequences
    (reference TELR_te.py:267-370): align each extracted TE sequence against
    the library and replace the family label with the distinct '|'-joined
    labels of the hits, dropping annotations with no hit."""
    aligner = Aligner(library, preset, use_wavefront=use_wavefront,
                      device=device)
    results = aligner.map_batch({s.name: s.codes for s in te_seqs})
    fam_by_contig: Dict[str, str] = {}
    for s in te_seqs:
        contig_name = s.name.rsplit(":", 1)[0]
        hits = results.get(s.name, [])
        if not hits:
            continue
        fams: List[str] = []
        for a in sorted(hits, key=lambda a: a.tstart):
            if a.tname not in fams:
                fams.append(a.tname)
        fam_by_contig[contig_name] = "|".join(sorted(fams))
    comp_col = annotation.cols.get("components")
    rows = []
    for i in range(len(annotation)):
        cname = annotation.chrom[i]
        if cname not in fam_by_contig:
            continue
        rows.append((cname, int(annotation.start[i]), int(annotation.end[i]),
                     fam_by_contig[cname], ".",
                     annotation.cols["strand"][i],
                     comp_col[i] if comp_col is not None else ""))
    return Intervals.from_rows(rows,
                               ("family", "score", "strand", "components"))
