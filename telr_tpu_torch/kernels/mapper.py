"""Seed–chain–extend long-read mapper.

The single aligner that serves every aligner role in the reference pipeline
(SURVEY.md §2b): read->genome (NGMLR/minimap2, TELR_alignment.py:9-100),
INS-seq->contig and TE-library->contig (TELR_te.py:68-132), flank->reference
asm10 (TELR_liftover.py:248-266), AF realignment (TELR_te.py:495-512) and the
TE homology search replacing RepeatMasker (TELR_sv.py:254-273).

Pipeline per query: minimizer sketch -> index lookup -> per-(target,strand)
chaining -> one banded GLOBAL DP over the chain region (band follows the
anchor guide path, so TE-insertion-sized I runs come out in one CIGAR) ->
EXTEND DP at both ends -> PAF-equivalent record.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from telr_tpu_torch.config import AlignPreset
from telr_tpu_torch.io.seqs import SeqDict, revcomp_codes
from telr_tpu_torch.kernels import dp
from telr_tpu_torch.kernels.chain import Chain, chain_anchors
from telr_tpu_torch.kernels.index import MinimizerIndex
from telr_tpu_torch.kernels.minimizer import minimizers
from telr_tpu_torch.utils import hoststats


@dataclasses.dataclass
class Alignment:
    """PAF-equivalent alignment record (fields consumed by the reference at
    TELR_liftover.py:356-380 and TELR_te.py:89-95,136-142)."""

    qname: str
    qlen: int
    qstart: int          # original query coordinates (strand-independent)
    qend: int
    strand: str          # '+' or '-'
    tname: str
    tlen: int
    tstart: int
    tend: int
    matches: int         # residue matches (PAF col 10)
    blocklen: int        # alignment block length (PAF col 11)
    mapq: int
    score: int
    cigar: List[Tuple[str, int]]  # over strand-oriented query vs target
    primary: bool = True

    @property
    def identity(self) -> float:
        return self.matches / self.blocklen if self.blocklen else 0.0

    def paf_row(self) -> str:
        return "\t".join(str(x) for x in (
            self.qname, self.qlen, self.qstart, self.qend, self.strand,
            self.tname, self.tlen, self.tstart, self.tend, self.matches,
            self.blocklen, self.mapq))


class Aligner:
    """Index a target SeqDict once; map many queries.

    use_wavefront=True routes the chain-region and extension DPs through the
    wavefront kernels (kernels/hopper_wavefront.py) on `device` ("cpu": the
    kernels' plain versions; None: the first CUDA card, raising when there
    is none).  The default path is the native host engine (dp.align_pairs);
    both produce oracle-optimal alignments."""

    def __init__(self, targets: SeqDict, preset: AlignPreset,
                 max_occ: int = 512, use_wavefront: bool = False,
                 device=None, mesh=None):
        self.targets = targets
        self.preset = preset
        self.use_wavefront = use_wavefront
        # kept as a string so pool workers unpickle it without torch
        self.device = None if device is None else str(device)
        # dist.mesh.Mesh: run the host-engine DP batches on the mesh's
        # devices instead, sharded over "reads"
        self.mesh = mesh
        with hoststats.timer("aligner_index"):
            self.index = MinimizerIndex.build(targets, preset.k, preset.w,
                                              max_occ=max_occ)
        self._tcodes = {s.name: s.codes for s in targets}

    # ------------------------------------------------------------------
    # planning: chains + primary/secondary selection (shared by map_seq and
    # map_batch; semantics identical to the original inline loop)
    def _plan(self, codes: np.ndarray):
        pre = self.preset
        qlen = len(codes)
        if qlen < pre.k:
            return []
        qpos, qh, qstrand = minimizers(codes, pre.k, pre.w)
        if len(qpos) == 0:
            return []
        q_idx, t_gpos, t_strand = self.index.lookup(qh)
        if len(q_idx) == 0:
            return []
        sid, t_local = self.index.seq_of_gpos(t_gpos)
        rel_strand = (qstrand[q_idx] != t_strand).astype(np.int64)
        a_qpos = qpos[q_idx]

        chains: List[Tuple[Chain, int, int]] = []
        for s_id in np.unique(sid):
            for st in (0, 1):
                m = (sid == s_id) & (rel_strand == st)
                if m.sum() < pre.min_chain_anchors:
                    continue
                aq = a_qpos[m]
                at = t_local[m]
                if st == 1:
                    aq = qlen - pre.k - aq
                cs = chain_anchors(
                    aq, at, pre.k,
                    max_gap=pre.max_anchor_gap,
                    max_target_skew=max(256, pre.band_width - 128),
                    min_score=pre.min_chain_score,
                    min_anchors=pre.min_chain_anchors,
                    max_chains=pre.max_secondary + 4)
                chains.extend((c, int(s_id), st) for c in cs)
        if not chains:
            return []
        chains.sort(key=lambda x: -x[0].score)
        if pre.chain_prune_frac > 0 and len(chains) > 1:
            # prune weak REDUNDANT chains BEFORE the DP (minimap2-style):
            # drop a chain only when it scores below the fraction floor
            # AND its query span mostly overlaps a kept, better chain —
            # query-disjoint chains are split-read segments (the flanks
            # of a long TE insertion) and must survive regardless of
            # score, or long insertions lose their SV evidence
            floor = pre.chain_prune_frac * chains[0][0].score
            kept_spans: List[Tuple[int, int]] = []
            pruned = []
            for c, s_id, st in chains:
                qs, qe = c.q_span
                if st == 1:
                    qs, qe = qlen - qe, qlen - qs
                redundant = any(
                    min(qe, pe) - max(qs, ps) > 0.5 * (qe - qs)
                    for ps, pe in kept_spans)
                if c.score >= floor or not redundant:
                    pruned.append((c, s_id, st))
                    kept_spans.append((qs, qe))
            chains = pruned

        picked: List[Tuple[Chain, int, int, bool]] = []
        marked = []
        for c, s_id, st in chains:
            qs, qe = c.q_span
            if st == 1:
                qs, qe = qlen - qe, qlen - qs
            is_secondary = False
            for (pc, ps_id, pst, pprim) in marked:
                pqs, pqe = pc.q_span
                if pst == 1:
                    pqs, pqe = qlen - pqe, qlen - pqs
                ov = min(qe, pqe) - max(qs, pqs)
                if ov > 0.5 * (qe - qs):
                    is_secondary = True
            marked.append((c, s_id, st, not is_secondary))
        # secondary cap applied in order (matches the original loop)
        n_secondary = 0
        for c, s_id, st, primary in marked:
            if not primary:
                n_secondary += 1
                if n_secondary > pre.max_secondary:
                    continue
            picked.append((c, s_id, st, primary))
        return picked

    # ------------------------------------------------------------------
    # piece construction: the three independent DP jobs of one chain
    def _chain_pieces(self, codes: np.ndarray, chain: Chain, s_id: int,
                      strand: int, width_floor: int = 128):
        pre = self.preset
        qlen = len(codes)
        tname = self.index.seq_names[s_id]
        tcodes = self._tcodes[tname]
        tlen = len(tcodes)
        qc = revcomp_codes(codes) if strand else codes

        qs, qe = chain.q_span
        ts, te = chain.t_span
        qe = min(qe, qlen)
        te = min(te, tlen)

        if chain.n_anchors > 1:
            link_dt = int(np.diff(chain.tpos).max())
            # the band must contain the largest diagonal-offset excursion
            # between nearby anchors — a query-side gap (an insertion: dq
            # large, dt ~ 0) bends the path as sharply as a target-side
            # one, and a band sized from dt alone shreds the insertion
            # into band-width I fragments.  Windowed measure: a stray
            # anchor inside the insertion splits one big jump into
            # adjacent smaller links (chain.py splits chains whose
            # excursion exceeds max_offset_jump, so 2048 always suffices)
            from telr_tpu_torch.kernels.chain import windowed_offset_jump
            link_jump = windowed_offset_jump(chain.qpos, chain.tpos)
        else:
            link_dt = link_jump = 0
        # the band tracks the interpolated anchor path, so it must contain
        # (a) the measured offset excursion between nearby anchors
        # (link_jump: an insertion bends the path by its full length) and
        # (b) the path's wobble INSIDE the largest anchor gap, where no
        # anchor pins the interpolation — bounded by half the gap in the
        # worst case but tiny in practice (random indel walk).  Sizing for
        # the practical case (jump + 96, link_dt/2 + 32) instead of the
        # worst (link_dt + 160) halves the DP cells of a typical read;
        # walks that touch a constraining band edge are retried at 4x by
        # map_batch_grouped, so the adversarial case costs a retry, not
        # correctness
        wneed = int(max(width_floor, link_jump + 96, link_dt // 2 + 32))
        width = min(dp._bucket(wneed), 2048)

        pieces = {}
        pieces["region"] = (qc[qs:qe], tcodes[ts:te], dp.GLOBAL, width,
                           (chain.qpos - qs, chain.tpos - ts))
        ext_t_len = min(tlen - te, (qlen - qe) + 500)
        qr_cap = min(qlen - qe, ext_t_len + pre.band_width)
        if qr_cap > 0 and ext_t_len > 0:
            pieces["rext"] = (qc[qe:qe + qr_cap], tcodes[te:te + ext_t_len],
                              dp.EXTEND, None, None)
        ext_t_len_l = min(ts, qs + 500)
        ql_cap = min(qs, ext_t_len_l + pre.band_width)
        if ql_cap > 0 and ext_t_len_l > 0:
            pieces["lext"] = (qc[qs - ql_cap:qs][::-1].copy(),
                              tcodes[ts - ext_t_len_l:ts][::-1].copy(),
                              dp.EXTEND, None, None)
        return pieces, (qc, qs, qe, ts, te, tname, tlen)

    def _assemble_chain(self, qname, codes, chain, s_id, strand, primary,
                        geom, results) -> Optional[Alignment]:
        qlen = len(codes)
        (qc, qs, qe, ts, te, tname, tlen) = geom
        res = results.get("region")
        if res is None or res["score"] <= dp.NEG_INF // 2 or \
                res.get("failed"):
            return None
        cigar = dp.cigar_to_arrays(res["cigar"])
        score = res["score"]
        r = results.get("rext")
        if r is not None and r.get("failed"):
            return None
        if r is not None:
            cigar = dp.merge_cigar_arrays(cigar,
                                          dp.cigar_to_arrays(r["cigar"]))
            qe += r["qend"]
            te += r["tend"]
            score += r["score"]
        r = results.get("lext")
        if r is not None and r.get("failed"):
            return None
        if r is not None:
            lo, ll = dp.cigar_to_arrays(r["cigar"])
            left_cigar = (lo[::-1].copy(), ll[::-1].copy())
            cigar = dp.merge_cigar_arrays(left_cigar, cigar)
            qs -= r["qend"]
            ts -= r["tend"]
            score += r["score"]

        nm, ni, nd, blk = dp.cigar_arrays_stats(cigar)
        if blk == 0:
            return None
        # geometry check: a corrupted walk (band escape on a degenerate
        # pair) yields a cigar inconsistent with its span — drop it
        if nm + ni != qe - qs or nm + nd != te - ts:
            return None
        matches = dp.count_matches(qc, self._tcodes[tname], cigar, qs, ts)
        if strand:
            oqs, oqe = qlen - qe, qlen - qs
        else:
            oqs, oqe = qs, qe
        return Alignment(
            qname=qname, qlen=qlen, qstart=int(oqs), qend=int(oqe),
            strand="-" if strand else "+", tname=tname, tlen=tlen,
            tstart=int(ts), tend=int(te), matches=int(matches),
            blocklen=int(blk), mapq=0, score=int(score),
            cigar=dp.arrays_to_cigar(cigar), primary=primary)

    def _postprocess(self, alns: List[Alignment],
                     max_hits: Optional[int]) -> List[Alignment]:
        pre = self.preset
        best_primary = max((a.score for a in alns
                            if a is not None and a.primary), default=0)
        out: List[Alignment] = []
        for aln in alns:
            if aln is None or aln.identity < pre.min_identity:
                continue
            if (not aln.primary and pre.secondary_ratio > 0
                    and aln.score < pre.secondary_ratio * best_primary):
                continue
            redundant = False
            for kept in out:
                if kept.tname != aln.tname or kept.strand != aln.strand:
                    continue
                tov = min(kept.tend, aln.tend) - max(kept.tstart, aln.tstart)
                shorter = min(kept.tend - kept.tstart, aln.tend - aln.tstart)
                if shorter > 0 and tov >= 0.5 * shorter:
                    redundant = True
                    break
            if redundant:
                continue
            out.append(aln)
            if max_hits and len(out) >= max_hits:
                break
        self._assign_mapq(out)
        return out

    # ------------------------------------------------------------------
    def map_seq(self, qname: str, codes: np.ndarray,
                max_hits: Optional[int] = None) -> List[Alignment]:
        return self.map_batch({qname: codes}, max_hits=max_hits)[qname]

    def _params(self) -> dp.DPParams:
        return dp.DPParams(match=self.preset.match,
                           mismatch=self.preset.mismatch,
                           gap_open=self.preset.gap_open,
                           gap_extend=self.preset.gap_extend)

    def map_batch(self, queries: Dict[str, np.ndarray],
                  max_hits: Optional[int] = None
                  ) -> Dict[str, List[Alignment]]:
        """Map many queries, batching every chain-region/extension DP across
        the whole batch (the wavefront backend dispatches one bucketed
        kernel call per (mode, width) group)."""
        return map_batch_grouped([(self, queries)], max_hits=max_hits)[0]

    # ------------------------------------------------------------------
    @staticmethod
    def _assign_mapq(alns: List[Alignment]) -> None:
        for a in alns:
            if not a.primary:
                a.mapq = 0
                continue
            s2 = 0
            for b in alns:
                if b is a:
                    continue
                ov = min(a.qend, b.qend) - max(a.qstart, b.qstart)
                if ov <= 0.5 * (a.qend - a.qstart):
                    continue
                # a near-duplicate of the same target span is chain-extension
                # convergence, not a genuine repeat copy: ignore for mapq
                if b.tname == a.tname:
                    tov = min(a.tend, b.tend) - max(a.tstart, b.tstart)
                    shorter = min(a.tend - a.tstart, b.tend - b.tstart)
                    if shorter > 0 and tov >= 0.9 * shorter:
                        continue
                s2 = max(s2, b.score)
            if a.score <= 0:
                a.mapq = 0
            else:
                frac = 1.0 - (s2 / a.score)
                a.mapq = int(max(0, min(60, round(60 * frac))))

    # ------------------------------------------------------------------
    def map_all(self, queries: SeqDict, max_hits: Optional[int] = None
                ) -> Dict[str, List[Alignment]]:
        return self.map_batch({s.name: s.codes for s in queries},
                              max_hits=max_hits)

    # ------------------------------------------------------------------
    def __getstate__(self):
        # picklable snapshot for pool workers: a Mesh's devices belong to
        # the parent, and the worker pool itself is parent-only
        d = dict(self.__dict__)
        d["_pool"] = None
        d["mesh"] = None
        return d

    def _worker_pool(self, processes: int):
        """Persistent forkserver pool of Aligner replicas (lazy)."""
        from telr_tpu_torch.utils.procpool import AlignerPool
        pool = getattr(self, "_pool", None)
        if pool is None or pool.processes != processes:
            if pool is not None:
                pool.close()
            pool = AlignerPool(self, processes)
            self._pool = pool
        return pool

    # ------------------------------------------------------------------
    def map_batch_parallel(self, queries: Dict[str, np.ndarray],
                           processes: int,
                           max_hits: Optional[int] = None
                           ) -> Dict[str, List[Alignment]]:
        """map_batch fanned out over pool worker processes (the -t
        thread parity of the reference's aligner thread passthrough,
        TELR_alignment.py:31-51).

        Host-side planning (seeding/chaining) is GIL-bound Python, so
        process parallelism is the only way to scale it.  Workers are
        forkserver children holding their own Aligner replica (see
        utils/procpool.py for why plain fork() is unsound here), which
        makes the fan-out safe whatever runtime threads the parent holds
        (a CUDA context does not survive fork either).  Per-read results
        are independent, so output is identical to map_batch."""
        from telr_tpu_torch.io import native
        small = len(queries) < max(16, 2 * processes)
        if self.use_wavefront and self.mesh is None and processes > 1 \
                and not small:
            # device path: fan out the HOST PLANNING only (seeding/
            # chaining — numpy + native C++ in the workers); the device
            # DP dispatch stays in the parent, the one process that
            # touches CUDA
            with hoststats.timer("plan_pool"):
                plans = self._worker_pool(processes).plan(queries)
            return map_batch_grouped([(self, queries)],
                                     max_hits=max_hits,
                                     plans=[plans])[0]
        if (processes <= 1 or small
                or self.use_wavefront or self.mesh is not None
                # without the native DP the worker path has no DP at all
                or not native.has_banded_dp()):
            return self.map_batch(queries, max_hits=max_hits)
        with hoststats.timer("map_pool"):
            return self._worker_pool(processes).map_batch(queries,
                                                          max_hits=max_hits)


_EXT_CHUNK = 512       # query bases per extension round
_EXT_SLACK = 192       # extra target per round (net-deletion headroom)
_EXT_CONT_MARGIN = 64  # path must reach this close to the chunk end to
                       # continue — the z-drop analogue: junk extensions
                       # (secondary repeat hits) die after one cheap round
_EXT_DIRECT_MAX = 768  # extensions at most this long skip the chunking

# grouped-dispatch calls whose total wavefront work is below this many DP
# cells run on the native host engine instead (hybrid dispatch; see
# _wave_goes_to_host).  The crossover that tools/gate_sweep.py measured on
# an NVIDIA H100 80GB HBM3 (700 W) with the host engine at 8 threads: one
# dispatch of 9.3M cells took 17 ms on the card's route against 18-19 ms on
# the host, at 5.3M 15 ms against 11 ms, at the reads' and the library's
# score sets alike (PERF.md).
_WAVE_MIN_CELLS = 9_300_000


def _run_ext_round_cpu(jobs, runner=None):
    items = [(q, t, dp.EXTEND, params, None, None) for q, t, params in jobs]
    return dp.align_pairs(items, runner=runner, cigar_arrays=True)


def _run_ext_round_wave(jobs, device=None):
    from telr_tpu_torch.kernels.hopper_wavefront import wavefront_align
    out = [None] * len(jobs)
    by_params: Dict[tuple, list] = {}
    for i, (q, t, params) in enumerate(jobs):
        by_params.setdefault(params.tuple(), []).append((i, q, t))
    for ptuple, items in by_params.items():
        res = wavefront_align([(q, t) for _, q, t in items], 128,
                              dp.EXTEND, dp.DPParams(*ptuple),
                              cigar_arrays=True, device=device)
        for (i, *_r), r in zip(items, res):
            out[i] = r
    return out


def _extend_chunked(ext_items, run_round):
    """Greedy chunked EXTEND alignment over many (q, t, params) items.

    One full-length extension DP costs len(q) x W where W must contain the
    whole rectangle's diagonal drift (the 500bp deletion slack pushes it to
    1024); measured at genome scale these pieces are 75% of all DP cells,
    and most belong to secondary repeat hits whose extension dies within a
    few hundred bases.  Chunked greedy extension (the batched analogue of
    minimap2's z-drop early stop) runs rounds of 512-query-base EXTEND DPs
    across ALL items, continuing an item only while its best path reaches
    within 64 of the chunk end.  Returns align_pair-style EXTEND results
    with array cigars.  run_round: callback mapping a list of
    (q, t, params) chunk jobs to align_pair-style results (CPU batch or
    wavefront kernel launch)."""
    import time
    t_start, t_rounds = time.perf_counter(), 0.0
    t_host = t_start    # the start of the scheduler's current stretch
    n = len(ext_items)
    state = [{"qoff": 0, "toff": 0, "score": 0,
              "cigar": (np.zeros(0, np.uint8), np.zeros(0, np.int32)),
              "done": False} for _ in range(n)]
    pending = list(range(n))
    while pending:
        jobs, slots = [], []
        for i in pending:
            q, t, params = ext_items[i]
            s = state[i]
            qc = q[s["qoff"]:s["qoff"] + _EXT_CHUNK]
            tc = t[s["toff"]:s["toff"] + _EXT_CHUNK + _EXT_SLACK]
            if len(qc) == 0 or len(tc) == 0:
                s["done"] = True
                continue
            jobs.append((qc, tc, params))
            slots.append(i)
        if not jobs:
            break
        t0 = time.perf_counter()
        hoststats.record("ext_schedule", t_host, t0)
        results = run_round(jobs)
        t_host = time.perf_counter()
        t_rounds += t_host - t0
        nxt = []
        for i, res in zip(slots, results):
            s = state[i]
            q, t, params = ext_items[i]
            chunk_q = min(_EXT_CHUNK, len(q) - s["qoff"])
            if not res.get("failed") and res["score"] > 0 \
                    and res["qend"] > 0:
                s["score"] += res["score"]
                s["qoff"] += res["qend"]
                s["toff"] += res["tend"]
                s["cigar"] = dp.merge_cigar_arrays(
                    s["cigar"], dp.cigar_to_arrays(res["cigar"]))
                if (res["qend"] >= chunk_q - _EXT_CONT_MARGIN
                        and s["qoff"] < len(q) and s["toff"] < len(t)):
                    nxt.append(i)
                    continue
            s["done"] = True
        pending = nxt
    # the scheduler's own host time: slicing the chunks, merging the cigars
    t_end = time.perf_counter()
    hoststats.record("ext_schedule", t_host, t_end)
    hoststats.add("ext_schedule", t_end - t_start - t_rounds)
    return [{"score": s["score"], "cigar": s["cigar"], "qend": s["qoff"],
             "tend": s["toff"], "qstart": 0, "tstart": 0}
            for s in state]


def _wave_width(width) -> int:
    """The wavefront band of a piece planned at row-band `width` (None: an
    extension): half of it, quantized to {128, 512, 2048}.  Every distinct
    width is a separate dispatch pool (chunking amortizes per pool); a wider
    band only adds reachable cells, never changes optimal alignments."""
    wave_w = max(128, (width or 256) // 2)
    return 128 if wave_w <= 128 else 512 if wave_w <= 512 else 2048


def _wave_cells(wave_buckets, wave_ext_items) -> int:
    """Estimated DP cells of a grouped dispatch's wavefront work: S x W per
    piece, and one chunk-round rectangle per query base of a chunked
    extension."""
    est = 0
    for k, items in wave_buckets.items():
        for (_ji, _tag, q, t, _g, _w) in items:
            est += (len(q) + len(t)) * k[2]
    for (q, _t, _p) in wave_ext_items:
        est += len(q) * (_EXT_CHUNK + _EXT_SLACK)
    return est


def _wave_goes_to_host(wave_buckets, wave_ext_items) -> bool:
    """Hybrid dispatch: a grouped dispatch whose wavefront work is below
    _WAVE_MIN_CELLS runs on the native host engine, where it costs less
    than a round of device launches and copies.  Decided per call, from
    the call's own size."""
    return bool(wave_buckets or wave_ext_items) and \
        _wave_cells(wave_buckets, wave_ext_items) < _WAVE_MIN_CELLS


def _dispatch_pieces(groups, jobs, piece_results, job_ids=None):
    """Run the DP for every piece of the given jobs (all by default),
    filling piece_results[ji][tag].  Pools work across jobs into bucketed
    batches: wavefront kernel launches on the device path, chunked native
    batches on the CPU path."""
    wave_buckets: Dict[tuple, list] = {}
    cpu_items: list = []    # align_pairs inputs
    cpu_slots: list = []    # (job_idx, tag) per input
    ext_items: list = []    # long extensions -> chunked scheduler (CPU)
    ext_slots: list = []
    wave_ext_items: list = []   # same, wavefront backend
    wave_ext_slots: list = []
    wave_ext_device = None
    runner = None
    import time
    t_collect = time.perf_counter()
    for ji in (range(len(jobs)) if job_ids is None else job_ids):
        (gi, *_x, pieces) = jobs[ji]
        al = groups[gi][0]
        params = al._params()
        if al.use_wavefront:
            for tag, (q, t, mode, width, guide) in pieces.items():
                if mode == dp.EXTEND and len(q) > _EXT_DIRECT_MAX:
                    wave_ext_items.append((q, t, params))
                    wave_ext_slots.append((ji, tag))
                    wave_ext_device = al.device
                    continue
                wave_w = _wave_width(width)
                if len(q) == 0 or len(t) == 0:
                    piece_results[ji][tag] = dp.align_pair(q, t, mode,
                                                           params)
                    continue
                key = (params.tuple(), mode, wave_w, al.device)
                wave_buckets.setdefault(key, []).append((ji, tag, q, t,
                                                         guide, width))
        else:
            if al.mesh is not None:
                from telr_tpu_torch.dist.exec import sharded_dp_runner
                runner = sharded_dp_runner(al.mesh)
            for tag, (q, t, mode, width, guide) in pieces.items():
                if mode == dp.EXTEND and len(q) > _EXT_DIRECT_MAX:
                    ext_items.append((q, t, params))
                    ext_slots.append((ji, tag))
                elif guide is not None and width is not None and len(q) \
                        and len(t):
                    off = dp.offsets_from_path(len(q), len(t), width,
                                               guide[0], guide[1])
                    cpu_items.append((q, t, mode, params, width, off))
                    cpu_slots.append((ji, tag))
                else:
                    cpu_items.append((q, t, mode, params, width, None))
                    cpu_slots.append((ji, tag))
    hoststats.add("map_collect", time.perf_counter() - t_collect,
                  start=t_collect)
    to_host = _wave_goes_to_host(wave_buckets, wave_ext_items)
    if hoststats.recording() and (wave_buckets or wave_ext_items):
        # the size gate's side and the wavefront work it weighed
        hoststats.annotate(side="host" if to_host else "card",
                           wave_cells=_wave_cells(wave_buckets,
                                                  wave_ext_items))
    if to_host:
        for (ptuple, mode, _wave_w, _dev), items in wave_buckets.items():
            params = dp.DPParams(*ptuple)
            for (ji, tag, q, t, guide, width) in items:
                if guide is not None and width is not None:
                    off = dp.offsets_from_path(len(q), len(t), width,
                                               guide[0], guide[1])
                    cpu_items.append((q, t, mode, params, width, off))
                else:
                    cpu_items.append((q, t, mode, params, width, None))
                cpu_slots.append((ji, tag))
        wave_buckets = {}
        ext_items.extend(wave_ext_items)
        ext_slots.extend(wave_ext_slots)
        wave_ext_items, wave_ext_slots = [], []
    if cpu_items:
        for (ji, tag), res in zip(cpu_slots,
                                  dp.align_pairs(cpu_items, runner=runner,
                                                 cigar_arrays=True)):
            piece_results[ji][tag] = res
    if ext_items:
        import functools
        run = functools.partial(_run_ext_round_cpu, runner=runner)
        for (ji, tag), res in zip(ext_slots,
                                  _extend_chunked(ext_items, run)):
            piece_results[ji][tag] = res
    if wave_ext_items:
        import functools
        run = functools.partial(_run_ext_round_wave, device=wave_ext_device)
        for (ji, tag), res in zip(wave_ext_slots,
                                  _extend_chunked(wave_ext_items, run)):
            piece_results[ji][tag] = res
    if wave_buckets:
        from telr_tpu_torch.kernels.hopper_wavefront import wavefront_align
        for (ptuple, mode, wave_w, device), items in wave_buckets.items():
            pairs = [(q, t) for _, _, q, t, _, _ in items]
            guides = [g for _, _, _, _, g, _ in items]
            res = wavefront_align(pairs, wave_w, mode,
                                  dp.DPParams(*ptuple), guides=guides,
                                  cigar_arrays=True, device=device)
            for (ji, tag, *_r), r in zip(items, res):
                piece_results[ji][tag] = r


_REGION_WIDTH_CAP = 2048


def map_batch_grouped(
    groups: List[Tuple["Aligner", Dict[str, np.ndarray]]],
    max_hits: Optional[int] = None,
    plans: Optional[List[Dict[str, list]]] = None,
    job_shard: Optional[Tuple[int, int]] = None,
    raw: bool = False,
):
    """Map many (aligner, queries) groups with ONE pooled DP dispatch.

    This is the cross-locus batching the reference gets from its
    multiprocessing fan-outs (TELR_assembly.py:70-73, TELR_te.py:644-648):
    every chain-region/extension DP from every group lands in the same
    (params, mode, width) bucket, so a polish round over hundreds of loci
    issues a handful of padded wavefront kernel launches instead of one
    host dispatch per locus.  Returns one result dict per group, exactly
    what each group's `map_batch` would return.

    job_shard=(pid, P): dispatch + assemble only the chain jobs whose
    global job index is ≡ pid (mod P); the other slots stay None.  The
    job list itself is built identically on every process (planning is
    deterministic), so P processes each running a shard and merging
    slot-wise reconstruct exactly the serial job results — the
    distribution axis for the reference-repeatmask stage, whose 5-family
    query set is too coarse to balance.

    raw=True: skip per-query postprocessing and return, per group, the
    list of (qname, Optional[Alignment]) in job order — the mergeable
    form (postprocess is order-dependent, so it must run once, on the
    merged full list).

    Region DPs start at a narrow anchor-guided band (width floor 128) and
    are retried at 4x width when the traceback path touches a constraining
    band edge (band_margin 0 — the band likely clipped the optimal path),
    when the walk corrupts (geometry mismatch / band escape), or when the
    DP found no in-band path.  The retry re-runs the region piece only."""
    jobs = []  # [group_idx, qname, codes, chain, s_id, st, primary,
    #            geom, pieces]
    with hoststats.timer("map_plan_pieces"):
        for gi, (al, queries) in enumerate(groups):
            gplans = plans[gi] if plans is not None else None
            for qname, codes in queries.items():
                picked = (gplans[qname] if gplans is not None
                          else al._plan(codes))
                for chain, s_id, st, primary in picked:
                    pieces, geom = al._chain_pieces(codes, chain, s_id,
                                                    st)
                    jobs.append([gi, qname, codes, chain, s_id, st,
                                 primary, geom, pieces])

    if job_shard is not None:
        pid, P = job_shard
        own_ids = [ji for ji in range(len(jobs)) if ji % P == pid]
    else:
        own_ids = None

    piece_results = [dict() for _ in jobs]
    with hoststats.timer("map_dispatch"):
        _dispatch_pieces(groups, jobs, piece_results, job_ids=own_ids)

    # assemble + per-query postprocess per group (order preserved);
    # jobs whose region band proved too narrow get one retry round
    per_group: List[Dict[str, List[Alignment]]] = [
        {q: [] for q in queries} for _, queries in groups]
    slots: List[Tuple[int, str, int]] = []  # (gi, qname, slot index)
    alns_by_job: List[Optional[Alignment]] = [None] * len(jobs)

    def _try_assemble(ji) -> Tuple[Optional[Alignment], bool]:
        """(alignment, wants_retry)."""
        (gi, qname, codes, chain, s_id, st, primary, geom, pieces) = jobs[ji]
        al = groups[gi][0]
        res = piece_results[ji]
        region = res.get("region")
        try:
            aln = al._assemble_chain(qname, codes, chain, s_id, st,
                                     primary, geom, res)
        except RuntimeError:
            aln = None
        if aln is not None and region is not None and \
                region.get("band_margin", 8) >= 4:
            return aln, False
        # failed, or the region walk hugged the band edge: retry wider
        # when the region piece has headroom (device path quantizes its
        # own widths and reports no margin — no retry there)
        if "region" in pieces and not al.use_wavefront:
            width = pieces["region"][3] or 0
            if width and width < min(_REGION_WIDTH_CAP,
                                     dp._bucket(len(pieces["region"][1]))):
                return aln, True
        return aln, False

    retry_ids = []
    with hoststats.timer("map_assemble"):
        for ji in (own_ids if own_ids is not None else range(len(jobs))):
            aln, wants_retry = _try_assemble(ji)
            alns_by_job[ji] = aln
            if wants_retry:
                retry_ids.append(ji)

    if retry_ids:
        for ji in retry_ids:
            (gi, qname, codes, chain, s_id, st, primary, geom,
             pieces) = jobs[ji]
            al = groups[gi][0]
            q, t, mode, width, guide = pieces["region"]
            new_w = min(dp._bucket(width * 4),
                        min(_REGION_WIDTH_CAP, dp._bucket(len(t) + 1)))
            jobs[ji][8] = {"region": (q, t, mode, new_w, guide)}
        with hoststats.timer("map_retry"):
            _dispatch_pieces(groups, jobs, piece_results, retry_ids)
            for ji in retry_ids:
                aln, _ = _try_assemble(ji)
                alns_by_job[ji] = aln

    if raw:
        raw_out: List[List[Tuple[str, Optional[Alignment]]]] = [
            [] for _ in groups]
        for ji, (gi, qname, *_rest) in enumerate(jobs):
            raw_out[gi].append((qname, alns_by_job[ji]))
        return raw_out

    with hoststats.timer("map_postprocess"):
        for ji, (gi, qname, *_rest) in enumerate(jobs):
            per_group[gi][qname].append(alns_by_job[ji])
        return [
            {qname: groups[gi][0]._postprocess(alns, max_hits)
             for qname, alns in result.items()}
            for gi, result in enumerate(per_group)]


def _merge_cigar(a: List[Tuple[str, int]], b: List[Tuple[str, int]]
                 ) -> List[Tuple[str, int]]:
    if not a:
        return list(b)
    if not b:
        return list(a)
    out = list(a)
    if out[-1][0] == b[0][0]:
        out[-1] = (out[-1][0], out[-1][1] + b[0][1])
        out.extend(b[1:])
    else:
        out.extend(b)
    return out
