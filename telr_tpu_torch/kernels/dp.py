"""Banded affine-gap dynamic-programming alignment core.

This single DP engine replaces the inner loops of every external aligner the
reference shells out to — NGMLR / minimap2 (reference TELR_alignment.py:31-82),
minimap2 contig/flank remaps (TELR_te.py:68-132, TELR_liftover.py:248-266),
wtpoa-cns polishing realignment (TELR_assembly.py:199-223) and rmblast inside
RepeatMasker (TELR_sv.py:254-273).

Host side of the row-banded DP (PyTorch port):
  * The DP matrix is banded: row i (query position) only holds a static-width
    window of W target columns starting at `off[i]`.  Band offsets follow the
    seed chain, so arbitrarily long indels are representable as long as each
    *piece* between anchors fits its band (the mapper stitches pieces).
  * align_pair / align_pairs run the recurrence in the native C++ engine
    (native/telr_native.cpp, bound by io/native.py); there is no fallback
    when that library is missing — they raise.
  * banded_dp_batch / banded_dp_scores run the same recurrence on a torch
    device through kernels/hopper_dp.py (a hand-written CUDA kernel on a
    card, plain torch ops on the CPU).  align_pairs takes them only as an
    explicit `runner` (the mesh path's dist/exec.sharded_dp_runner).
  * Direction bits (2b H-choice, 1b D-extend, 1b I-extend) are emitted per
    cell.  On the native route the traceback is a host-side walk; on the
    runner route banded_dp_walk also walks on the device, and only the
    packed alignment comes back to the host.

Modes:
  GLOBAL — end-to-end (0,0)->(Lq,Lt) within the band (anchor stitching).
  EXTEND — start pinned at (0,0), best cell anywhere (read-end extension).
  LOCAL  — Smith-Waterman, scores clamped at 0 (TE-library homology search).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

NEG_INF = -(2 ** 30)

GLOBAL, EXTEND, LOCAL = 0, 1, 2

# direction byte layout
_CHOICE_DIAG, _CHOICE_D, _CHOICE_I, _CHOICE_STOP = 0, 1, 2, 3
_DEXT_BIT = 4
_IEXT_BIT = 8


@dataclasses.dataclass(frozen=True)
class DPParams:
    match: int = 2
    mismatch: int = 4     # positive; applied as negative
    gap_open: int = 4     # gap of length L costs gap_open + L*gap_extend
    gap_extend: int = 2
    ambig: int = -1       # score when either base is N

    def tuple(self) -> Tuple[int, int, int, int, int]:
        return (self.match, self.mismatch, self.gap_open, self.gap_extend,
                self.ambig)


def make_band_offsets(lq: int, lt: int, width: int) -> np.ndarray:
    """Band offsets for a plain (0,0)->(lq,lt) alignment: the band follows the
    main diagonal, clipped so row 0 contains column 0 and row lq contains
    column lt.  Returns int32 (lq+1,)."""
    if lq == 0:
        return np.zeros(1, dtype=np.int32)
    i = np.arange(lq + 1, dtype=np.float64)
    center = i * (lt / lq)
    off = np.rint(center).astype(np.int64) - width // 2
    off = np.clip(off, 0, max(0, lt - width + 1))
    off = np.maximum.accumulate(off)  # monotone non-decreasing
    # limit per-row shift to width (path continuity)
    for _ in range(2):
        d = np.diff(off)
        if (d <= width).all():
            break
        d = np.minimum(d, width)
        off = np.concatenate([[off[0]], off[0] + np.cumsum(d)])
        off = np.clip(off, 0, max(0, lt - width + 1))
    return off.astype(np.int32)


def offsets_from_path(lq: int, lt: int, width: int,
                      qs: np.ndarray, ts: np.ndarray) -> np.ndarray:
    """Band offsets following a monotone guide path given by matched points
    (qs[m], ts[m]) (e.g. chain anchors), linearly interpolated, endpoints
    pinned to (0,0) and (lq,lt)."""
    qs = np.concatenate([[0], np.asarray(qs, np.int64), [lq]])
    ts = np.concatenate([[0], np.asarray(ts, np.int64), [lt]])
    keep = np.concatenate([[True], (np.diff(qs) > 0)])
    qs, ts = qs[keep], np.maximum.accumulate(ts[keep])
    i = np.arange(lq + 1, dtype=np.float64)
    center = np.interp(i, qs.astype(np.float64), ts.astype(np.float64))
    off = np.rint(center).astype(np.int64) - width // 2
    off = np.clip(off, 0, max(0, lt - width + 1))
    off = np.maximum.accumulate(off)
    d = np.minimum(np.diff(off), width)
    off = np.concatenate([[off[0]], off[0] + np.cumsum(d)])
    off = np.clip(off, 0, max(0, lt - width + 1)).astype(np.int32)
    return off


# ---------------------------------------------------------------------------
# Reference implementation (full matrix, numpy) — test oracle only.
# ---------------------------------------------------------------------------

def numpy_affine_dp(q: np.ndarray, t: np.ndarray, mode: int,
                    params: DPParams) -> Tuple[int, Tuple[int, int]]:
    """Full-matrix Gotoh DP. Returns (best_score, (best_i, best_j))."""
    ma, mi, go, ge, amb = params.tuple()
    lq, lt = len(q), len(t)
    H = np.full((lq + 1, lt + 1), NEG_INF, dtype=np.int64)
    E = np.full((lq + 1, lt + 1), NEG_INF, dtype=np.int64)  # horizontal (D)
    F = np.full((lq + 1, lt + 1), NEG_INF, dtype=np.int64)  # vertical (I)
    H[0, 0] = 0
    for j in range(1, lt + 1):
        H[0, j] = 0 if mode == LOCAL else -(go + ge * j)
    for i in range(1, lq + 1):
        H[i, 0] = 0 if mode == LOCAL else -(go + ge * i)
    for i in range(1, lq + 1):
        for j in range(1, lt + 1):
            s = amb if (q[i - 1] == 4 or t[j - 1] == 4) else (
                ma if q[i - 1] == t[j - 1] else -mi)
            E[i, j] = max(H[i, j - 1] - go - ge, E[i, j - 1] - ge)
            F[i, j] = max(H[i - 1, j] - go - ge, F[i - 1, j] - ge)
            h = max(H[i - 1, j - 1] + s, E[i, j], F[i, j])
            if mode == LOCAL:
                h = max(h, 0)
            H[i, j] = h
    if mode == GLOBAL:
        return int(H[lq, lt]), (lq, lt)
    best = int(H.max())
    bi, bj = np.unravel_index(int(H.argmax()), H.shape)
    return best, (int(bi), int(bj))


# ---------------------------------------------------------------------------
# Batched row-banded DP on a torch device
# ---------------------------------------------------------------------------

def _to_device(device, q, t, off, qlen, tlen):
    """The batch arrays (numpy or torch) as contiguous tensors on `device`
    (None: the first CUDA card, see utils.device.resolve) in the DP's
    dtypes."""
    import torch
    from telr_tpu_torch.utils.device import resolve
    dev = resolve(device)
    return tuple(
        torch.as_tensor(x).to(device=dev, dtype=dt).contiguous()
        for x, dt in ((q, torch.int8), (t, torch.int8), (off, torch.int32),
                      (qlen, torch.int32), (tlen, torch.int32)))


def banded_dp_scores(q, t, off, qlen, tlen, *, width, mode, params_tuple,
                     device=None):
    """Batched score-only banded DP.  Returns (gscore (B,), best (B,)) as
    int32 tensors on `device`."""
    from telr_tpu_torch.kernels.hopper_dp import rowband_dp
    return rowband_dp(*_to_device(device, q, t, off, qlen, tlen),
                      width=width, mode=mode, params_tuple=params_tuple,
                      tb=False)


def banded_dp_batch(q, t, off, qlen, tlen, *, width, mode, params_tuple,
                    device=None):
    """Banded DP with direction bytes over a batch.

    q: (B, Lq) int8, t: (B, Lt) int8, off: (B, Lq+1) int32,
    qlen/tlen: (B,) int32 (numpy arrays or tensors).
    Returns dirs (B, Lq, W) uint8, gscore (B,), best (B,), besti (B,),
    bestp (B,) as tensors on `device`.
    """
    from telr_tpu_torch.kernels.hopper_dp import rowband_dp
    return rowband_dp(*_to_device(device, q, t, off, qlen, tlen),
                      width=width, mode=mode, params_tuple=params_tuple,
                      tb=True)


def banded_dp_walk(q, t, off, qlen, tlen, *, width, mode, params_tuple,
                   device=None, walk: bool = True):
    """Banded DP and traceback walk over a batch, both on `device`: the
    direction bytes never leave it.

    Arguments as banded_dp_batch.  Returns (packed, small) as tensors on
    `device`, hopper_dp.rowband_walk's outputs: packed (B, S_pad / 4) uint8
    op codes and the (8, B) int32 stack [gscore, best, ei, ej, bad, si, sj,
    margin].  walk=False skips the walk: packed is None and the stack holds
    the scores and the start cell (si, sj) only (ei = ej = bad = 0,
    margin = width)."""
    import torch
    from telr_tpu_torch.kernels import hopper_dp
    q, t, off, qlen, tlen = _to_device(device, q, t, off, qlen, tlen)
    dirs, gscore, best, besti, bestp = hopper_dp.rowband_dp(
        q, t, off, qlen, tlen, width=width, mode=mode,
        params_tuple=params_tuple, tb=True)
    if walk:
        return hopper_dp.rowband_walk(dirs, off, qlen, tlen, gscore, best,
                                      besti, bestp, lt=t.shape[1], mode=mode)
    if mode == GLOBAL:
        si, sj = qlen, tlen
    else:
        si = besti
        sj = torch.where(si > 0, off.gather(1, si.long()[:, None])[:, 0]
                         + bestp, bestp)
    zero = torch.zeros_like(gscore)
    return None, torch.stack([gscore, best, zero, zero, zero, si, sj,
                              torch.full_like(gscore, width)])


# ---------------------------------------------------------------------------
# Host-side traceback
# ---------------------------------------------------------------------------

def traceback(dirs: np.ndarray, off: np.ndarray, start_i: int, start_j: int,
              mode: int, lt: int = 1 << 30
              ) -> Tuple[List[Tuple[str, int]], int, int]:
    """Walk direction bits from cell (start_i, start_j) back to the alignment
    start.  Returns (cigar ops as (op, len) in forward order, end_i, end_j)
    where (end_i, end_j) is the matrix cell where the alignment begins
    (always (0,0) for GLOBAL/EXTEND)."""
    if _native_walks():
        from telr_tpu_torch.io import native
        return native.traceback(dirs, off, int(start_i), int(start_j),
                                mode, lt)
    ops: List[Tuple[str, int]] = []
    i, j = int(start_i), int(start_j)

    def push(op: str):
        if ops and ops[-1][0] == op:
            ops[-1] = (op, ops[-1][1] + 1)
        else:
            ops.append((op, 1))

    state = "H"
    while i > 0 or j > 0:
        if i == 0:
            # leading horizontal run along row 0 (global init row)
            push("D")
            j -= 1
            continue
        p = j - int(off[i])
        if p < 0 or p >= dirs.shape[1]:
            raise RuntimeError(
                f"traceback left the band at i={i} j={j} p={p}")
        byte = int(dirs[i - 1, p])
        choice = byte & 3
        if state == "H":
            if mode == LOCAL and choice == _CHOICE_STOP:
                break
            if j == 0 or choice == _CHOICE_I:
                state = "I"
                continue
            if choice == _CHOICE_DIAG:
                push("M")
                i -= 1
                j -= 1
                continue
            if choice == _CHOICE_D:
                state = "D"
                continue
            # STOP in non-local mode shouldn't happen
            raise RuntimeError(f"bad traceback state at i={i} j={j}")
        elif state == "D":
            push("D")
            ext = byte & _DEXT_BIT
            j -= 1
            if not ext:
                state = "H"
        else:  # state == "I"
            push("I")
            ext = byte & _IEXT_BIT
            i -= 1
            if not ext:
                state = "H"
    ops.reverse()
    return ops, i, j


# ---------------------------------------------------------------------------
# Convenience single-pair API (used by the mapper for stitching pieces)
# ---------------------------------------------------------------------------

def _bucket(n: int, quanta=(64, 128, 256, 512, 1024, 2048, 4096, 8192,
                            16384, 32768, 65536)) -> int:
    for b in quanta:
        if n <= b:
            return b
    return ((n + 8191) // 8192) * 8192


def _prep_pair(q: np.ndarray, t: np.ndarray, mode: int, params: DPParams,
               width: Optional[int] = None,
               off: Optional[np.ndarray] = None):
    """Shared padding/bucketing front half of align_pair.

    Returns ("quick", result_dict) for degenerate pairs, else
    ("job", (q_pad, t_pad, off_pad, lq, lt, width))."""
    lq, lt = len(q), len(t)
    if lq == 0 or (lt == 0 and mode != GLOBAL):
        return "quick", {"score": 0, "cigar": [], "qend": 0, "tend": 0,
                         "qstart": 0, "tstart": 0}
    if lt == 0:
        return "quick", {
            "score": -(params.gap_open + params.gap_extend * lq),
            "cigar": [("I", lq)], "qend": lq, "tend": 0,
            "qstart": 0, "tstart": 0}
    if width is None:
        width = _bucket(max(abs(lt - lq) + 65, 128, min(max(lq, lt) + 2, 256)))
    width = min(width, _bucket(lt + 1))
    if off is None:
        off_arr = make_band_offsets(lq, lt, width)
    else:
        off_arr = np.asarray(off, dtype=np.int32)

    lq_b = _bucket(lq)
    q_pad = np.full(lq_b, 4, dtype=np.int8)
    q_pad[:lq] = q
    lt_b = _bucket(lt)
    t_pad = np.full(lt_b, 4, dtype=np.int8)
    t_pad[:lt] = t
    off_pad = np.full(lq_b + 1, off_arr[-1], dtype=np.int32)
    off_pad[: len(off_arr)] = off_arr
    return "job", (q_pad, t_pad, off_pad, lq, lt, width)


def _finish_pair(dirs, gscore, best, besti, bestp, off_pad, lq, lt, mode,
                 want_cigar: bool, cigar_arrays: bool = False):
    """Shared traceback back half of align_pair."""
    out = {"qstart": 0, "tstart": 0}
    if mode == GLOBAL:
        out["score"] = int(gscore)
        si, sj = lq, lt
    else:
        out["score"] = int(best)
        si = int(besti)
        sj = int(off_pad[si]) + int(bestp) if si > 0 else int(bestp)
    out["qend"], out["tend"] = si, sj
    if want_cigar:
        if cigar_arrays:
            arr, ei, ej, margin = traceback_arrays(
                np.asarray(dirs), off_pad, si, sj, mode, lt)
            out["cigar"] = arr
            out["band_margin"] = margin
        else:
            arr, ei, ej = traceback(np.asarray(dirs), off_pad, si, sj,
                                    mode, lt)
            out["cigar"] = arr
        out["qstart"], out["tstart"] = ei, ej
    return out


# ---------------------------------------------------------------------------
# Array-form cigars: (ops uint8 [M=0,D=1,I=2], lens int32) in forward order.
# The hot path (mapper piece assembly) stays in this form end-to-end; the
# list-of-(str, int) form remains the public ABI of Alignment.cigar.
# ---------------------------------------------------------------------------

_OP_STR = np.array(["M", "D", "I"])
_OP_CODE = {"M": 0, "D": 1, "I": 2}


def cigar_to_arrays(cigar) -> Tuple[np.ndarray, np.ndarray]:
    if isinstance(cigar, tuple):
        return cigar
    n = len(cigar)
    ops = np.fromiter((_OP_CODE[op] for op, _ in cigar), dtype=np.uint8,
                      count=n)
    lens = np.fromiter((ln for _, ln in cigar), dtype=np.int32, count=n)
    return ops, lens


def arrays_to_cigar(arr) -> List[Tuple[str, int]]:
    if isinstance(arr, list):
        return arr
    ops, lens = arr
    return list(zip(_OP_STR[ops].tolist(),
                    np.asarray(lens).astype(np.int64).tolist()))


def merge_cigar_arrays(a, b):
    """Concatenate two array-form cigars, joining an equal boundary op."""
    aops, alens = a
    bops, blens = b
    if len(aops) == 0:
        return b
    if len(bops) == 0:
        return a
    if aops[-1] == bops[0]:
        lens = np.concatenate([alens[:-1],
                               [alens[-1] + blens[0]], blens[1:]])
        ops = np.concatenate([aops, bops[1:]])
        return ops, lens.astype(np.int32)
    return (np.concatenate([aops, bops]),
            np.concatenate([alens, blens]))


def cigar_arrays_stats(arr) -> Tuple[int, int, int, int]:
    """(n_M, n_I, n_D, block_len) of an array-form cigar — vectorized
    sibling of cigar_stats."""
    ops, lens = arr
    if len(ops) == 0:
        return 0, 0, 0, 0
    sums = np.bincount(ops, weights=lens, minlength=3)
    nm, nd, ni = int(sums[0]), int(sums[1]), int(sums[2])
    return nm, ni, nd, nm + ni + nd


def traceback_arrays(dirs: np.ndarray, off: np.ndarray, start_i: int,
                     start_j: int, mode: int, lt: int = 1 << 30):
    """traceback returning the array cigar form (no per-run tuple list)
    plus the walk's minimum constraining-band-edge margin (W on the
    non-native fallback: no retry signal, band sizing is conservative
    there anyway)."""
    if _native_walks():
        from telr_tpu_torch.io import native
        return native.traceback_arrays(dirs, off, int(start_i),
                                       int(start_j), mode, lt)
    ops, ei, ej = traceback(dirs, off, start_i, start_j, mode)
    return cigar_to_arrays(ops), ei, ej, int(dirs.shape[1])


def align_pair(q: np.ndarray, t: np.ndarray, mode: int, params: DPParams,
               width: Optional[int] = None,
               off: Optional[np.ndarray] = None,
               want_cigar: bool = True):
    """Align one code-array pair on the native engine.

    Returns dict with score, cigar, and (for EXTEND/LOCAL) the end cell
    (query_end, target_end) plus for LOCAL the start cell.
    """
    kind, payload = _prep_pair(q, t, mode, params, width, off)
    if kind == "quick":
        return payload
    q_pad, t_pad, off_pad, lq, lt, width = payload
    dirs, gscore, best, besti, bestp = _native_dp()(
        q_pad[None], t_pad[None], off_pad[None],
        np.array([lq], np.int32), np.array([lt], np.int32),
        width=width, mode=mode, params_tuple=params.tuple())
    return _finish_pair(dirs[0], gscore[0], best[0], besti[0], bestp[0],
                        off_pad, lq, lt, mode, want_cigar)


# native route: cap on dirs bytes (B * Lq * W) per batch; bounds host memory
_MAX_BATCH_CELLS = 1 << 26
_MAX_BATCH = 256
# walk-runner route: the direction bytes stay on the device, so a launch is
# sized for the card: dirs bytes one launch may hold on each shard (two
# launches are in flight at a time)
WALK_DIRS_BUDGET = 1 << 32


def _native_walks() -> bool:
    """True when the C++ traceback/count_matches walks are available."""
    from telr_tpu_torch.io import native
    return native.has_traceback()


def _native_dp():
    """The C++ banded-DP batch entry (native/telr_native.cpp).

    Raises when the engine is missing: the torch row-banded DP
    (banded_dp_batch) is an explicit runner of align_pairs, never a silent
    stand-in for the engine."""
    from telr_tpu_torch.io import native
    if not native.has_banded_dp():
        raise RuntimeError(
            "the native host engine (native/libtelr_native.so) is required "
            "for the row-banded DP; build it with `make -C native`")
    return native.banded_dp_batch


def align_pairs(items, runner=None, want_cigar: bool = True,
                cigar_arrays: bool = False):
    """Batched align_pair: one native batch per shape bucket instead of
    one call per piece.

    items: list of (q, t, mode, params, width, off) — exactly align_pair's
    arguments.  Jobs are grouped by (mode, width, Lq-bucket, Lt-bucket,
    params) and each group runs as exact-size batches bounded by dirs
    memory; numerics are identical to per-piece align_pair.

    runner: optional override with banded_dp_batch's calling convention,
    numpy in and numpy out — the hook dist/exec.py uses to run the same
    batches on the mesh's devices (stage-1 data parallelism over the "reads"
    axis).  A runner that has a `walks` method (dist/exec.py's has) also
    walks on its devices: its batches are sized by its `dirs_budget`, not
    by the host-memory caps, and pairs are finished from the packed walks
    (_align_groups_walks).  Without a runner the batches go to the native
    engine.

    Returns one align_pair-style result dict per item."""
    from telr_tpu_torch.utils import hoststats
    results: List[Optional[dict]] = [None] * len(items)
    groups: dict = {}
    with hoststats.timer("align_prep"):
        for i, (q, t, mode, params, width, off) in enumerate(items):
            kind, payload = _prep_pair(q, t, mode, params, width, off)
            if kind == "quick":
                if cigar_arrays and "cigar" in payload:
                    payload = dict(payload,
                                   cigar=cigar_to_arrays(payload["cigar"]))
                results[i] = payload
                continue
            q_pad, t_pad, off_pad, lq, lt, w = payload
            key = (mode, w, len(q_pad), len(t_pad), params.tuple())
            groups.setdefault(key, []).append((i, q_pad, t_pad, off_pad, lq,
                                               lt))
    if not groups:
        return results
    if getattr(runner, "walks", None) is not None:
        _align_groups_walks(groups, results, runner, want_cigar,
                            cigar_arrays)
        return results
    run = runner if runner is not None else _native_dp()
    # a batch on the native host engine is a `dp.host` span (its DP, its
    # walks); the mesh runner's batches run on its devices
    span = "dp.host" if runner is None else "dp.runner"
    for (mode, w, lq_b, lt_b, ptuple), jobs in groups.items():
        chunk = min(_MAX_BATCH, max(1, _MAX_BATCH_CELLS // (lq_b * w)))
        for c0 in range(0, len(jobs), chunk):
            part = jobs[c0:c0 + chunk]
            qb, tb, ob, ql, tl = _pack_batch(part, lq_b, lt_b)
            with hoststats.timer(span, pairs=len(part),
                                 cells=int(ql.sum()) * w):
                dirs, gscore, best, besti, bestp = run(
                    qb, tb, ob, ql, tl, width=w, mode=mode,
                    params_tuple=ptuple)
                dirs = np.asarray(dirs)
                gscore = np.asarray(gscore)
                best = np.asarray(best)
                besti = np.asarray(besti)
                bestp = np.asarray(bestp)
                for r, (i, _q, _t, off_pad, lq, lt) in enumerate(part):
                    results[i] = _finish_pair(
                        dirs[r], gscore[r], best[r], besti[r], bestp[r],
                        off_pad, lq, lt, mode, want_cigar, cigar_arrays)
    return results


def _pack_batch(part, lq_b: int, lt_b: int):
    """The padded (q, t, off, qlen, tlen) arrays of one exact-size batch of
    align_pairs jobs."""
    B = len(part)
    qb = np.full((B, lq_b), 4, dtype=np.int8)
    tb = np.full((B, lt_b), 4, dtype=np.int8)
    ob = np.zeros((B, lq_b + 1), dtype=np.int32)
    ql = np.ones(B, dtype=np.int32)
    tl = np.ones(B, dtype=np.int32)
    for r, (_i, q_pad, t_pad, off_pad, lq, lt) in enumerate(part):
        qb[r] = q_pad
        tb[r] = t_pad
        ob[r] = off_pad
        ql[r] = lq
        tl[r] = lt
    return qb, tb, ob, ql, tl


def _align_groups_walks(groups, results, runner, want_cigar: bool,
                        cigar_arrays: bool) -> None:
    """align_pairs' batches through a runner that walks on its devices.

    runner.walks(q, t, off, qlen, tlen, width=, mode=, params_tuple=,
    walk=) launches the DP and the walk and returns a function that waits
    for them and gives (packed (B, S4) uint8 or None, small (8, B) int32)
    as numpy.  A group is cut by runner.dirs_budget (device memory);
    results are per pair, so the cut cannot change a bit.  The next batch
    is launched before the last one is collected, so its packing and the
    decode overlap the device's work.  Fills `results` with exactly what
    _finish_pair gives on the native route; a walk the host walker would
    refuse raises the host walker's error."""
    import time
    from telr_tpu_torch.io import native
    from telr_tpu_torch.kernels.hopper_dp import (
        WALK_BAD, WALK_BEST, WALK_EI, WALK_EJ, WALK_GSCORE, WALK_MARGIN,
        WALK_SI, WALK_SJ)
    from telr_tpu_torch.utils import hoststats
    if want_cigar and not native.has_wave_decode():
        raise RuntimeError("the native host engine (native/libtelr_native"
                           ".so) is required to decode device tracebacks")

    def collect(item):
        part, mode, fetch = item
        with hoststats.timer("rowband_device_wait"):
            packed, small = fetch()
        t0 = time.perf_counter()
        si, sj = small[WALK_SI], small[WALK_SJ]
        bad = small[WALK_BAD]
        if bad.any():
            r = int(np.flatnonzero(bad)[0])
            raise RuntimeError(
                f"traceback left the band from ({int(si[r])},{int(sj[r])})")
        score = small[WALK_GSCORE if mode == GLOBAL else WALK_BEST]
        if want_cigar:
            offsets, ops, lens = native.wave_decode_batch(
                packed.T, small[WALK_EI], small[WALK_EJ], bad, False)
        for r, (i, *_rest) in enumerate(part):
            out = {"qstart": 0, "tstart": 0, "score": int(score[r]),
                   "qend": int(si[r]), "tend": int(sj[r])}
            if want_cigar:
                arr = (ops[offsets[r]:offsets[r + 1]],
                       lens[offsets[r]:offsets[r + 1]])
                if cigar_arrays:
                    out["cigar"] = arr
                    out["band_margin"] = int(small[WALK_MARGIN, r])
                else:
                    out["cigar"] = arrays_to_cigar(arr)
                out["qstart"] = int(small[WALK_EI, r])
                out["tstart"] = int(small[WALK_EJ, r])
            results[i] = out
        hoststats.add("rowband_decode", time.perf_counter() - t0, start=t0)

    pending = None
    for (mode, w, lq_b, lt_b, ptuple), jobs in groups.items():
        chunk = max(1, runner.dirs_budget // (lq_b * w))
        for c0 in range(0, len(jobs), chunk):
            part = jobs[c0:c0 + chunk]
            with hoststats.timer("rowband_pack"):
                batch = _pack_batch(part, lq_b, lt_b)
            with hoststats.timer("rowband_launch"):
                fetch = runner.walks(*batch, width=w, mode=mode,
                                     params_tuple=ptuple, walk=want_cigar)
            if pending is not None:
                collect(pending)
            pending = (part, mode, fetch)
    if pending is not None:
        collect(pending)


def cigar_stats(cigar) -> Tuple[int, int, int, int]:
    """(n_M, n_I, n_D, block_len)."""
    if isinstance(cigar, tuple):
        return cigar_arrays_stats(cigar)
    nm = sum(l for op, l in cigar if op == "M")
    ni = sum(l for op, l in cigar if op == "I")
    nd = sum(l for op, l in cigar if op == "D")
    return nm, ni, nd, nm + ni + nd


def count_matches(q: np.ndarray, t: np.ndarray, cigar, qstart=0, tstart=0) -> int:
    """Number of exact residue matches along a cigar path (PAF col 10)."""
    if _native_walks():
        from telr_tpu_torch.io import native
        return native.count_matches(q, t, cigar, qstart, tstart)
    if isinstance(cigar, tuple):
        cigar = arrays_to_cigar(cigar)
    qi, tj = qstart, tstart
    matches = 0
    for op, ln in cigar:
        if op == "M":
            matches += int(np.sum(q[qi:qi + ln] == t[tj:tj + ln]))
            qi += ln
            tj += ln
        elif op == "I":
            qi += ln
        elif op == "D":
            tj += ln
    return matches
