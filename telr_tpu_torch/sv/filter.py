"""TE-candidate filter: keep insertion records whose inserted sequence has
homology to the TE consensus library.

Replaces RepeatMasker on the VCF insertion sequences (reference
TELR_sv.py:231-324): library hits on each INS sequence are merged and the
total covered proportion recorded (`ins_te_prop`, TELR_sv.py:298-308); loci
with no hit are dropped and reported to the loci-eval ledger.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from telr_tpu_torch.config import LIB_TO_SEQ, AlignPreset
from telr_tpu_torch.io.seqs import SeqDict, Sequence, encode
from telr_tpu_torch.kernels.mapper import Aligner
from telr_tpu_torch.sv.detect import SVRecord
from telr_tpu_torch.utils.evallog import LociEval


def te_hits_on_seq(aligner: Aligner, name: str, codes: np.ndarray
                   ) -> List[Tuple[int, int, str, str, int]]:
    """Map one sequence against the TE library; return homology intervals on
    the sequence as (start, end, family, strand, score)."""
    hits = []
    for a in aligner.map_seq(name, codes):
        hits.append((a.qstart, a.qend, a.tname, a.strand, a.score))
    return hits


def merged_hit_length(hits: List[Tuple[int, int, str, str, int]]) -> List[Tuple[int, int]]:
    """Merge intervals (bedtools merge equivalent, reference TELR_sv.py:287-295)."""
    iv = sorted((h[0], h[1]) for h in hits)
    out: List[Tuple[int, int]] = []
    for s, e in iv:
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def filter_te_candidates(
    records: List[SVRecord],
    library: SeqDict,
    loci_eval: LociEval,
    preset: AlignPreset = LIB_TO_SEQ,
    use_wavefront: bool = False,
    device=None,
) -> List[SVRecord]:
    """Keep records whose INS sequence repeat-masks against the library.

    ins_te_prop follows the reference's accumulation: per merged interval,
    round(length/seq_len, 2), summed (TELR_sv.py:298-308).  All INS
    sequences are homology-searched in one batched dispatch.
    """
    aligner = Aligner(library, preset, use_wavefront=use_wavefront,
                      device=device)
    results = aligner.map_batch(
        {rec.locus_name: encode(rec.seq) for rec in records})
    kept: List[SVRecord] = []
    for rec in records:
        hits = [(a.qstart, a.qend, a.tname, a.strand, a.score)
                for a in results.get(rec.locus_name, [])]
        if not hits:
            loci_eval.add(rec.locus_name, "VCF sequence not repeatmasked")
            continue
        prop = 0.0
        for s, e in merged_hit_length(hits):
            prop += round((e - s) / len(rec.seq), 2)
        best = max(hits, key=lambda h: h[4])
        rec.ins_te_prop = round(prop, 2)
        rec.ins_te_family = best[2]
        rec.ins_te_strand = best[3]
        kept.append(rec)
    return kept
