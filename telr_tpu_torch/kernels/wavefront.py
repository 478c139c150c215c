"""Wavefront (anti-diagonal) banded affine-gap DP — schedule + reference.

The row-oriented banded DP (dp.py / hopper_dp.py) needs dynamic band shifts
and an intra-row max-plus scan.  Re-indexing the DP by anti-diagonals
removes both:

  cell (i, j), step s = i + j, offset o = j - i (o ≡ s mod 2).
  The band holds W offsets of step parity: p -> o = m_s + 2p, where the band
  base m_s drifts by EXACTLY ±1 each step (parity forces |m_s - m_{s-1}|=1).

  H[s][p] = max(H[s-2][p''] + score, I[s][p], D[s][p])
  I[s][p] = max(H[s-1][p'v] - go - ge, I[s-1][p'v] - ge)   (vertical)
  D[s][p] = max(H[s-1][p'h] - go - ge, D[s-1][p'h] - ge)   (horizontal)

  with p'v = p + (1+d)/2, p'h = p + (d-1)/2, p'' = p + (d + d_prev)/2 for
  drift d = m_s - m_{s-1} in {-1, +1}: every predecessor access is a shift
  by -1/0/+1 — static rolls plus per-pair selects.  The D recurrence crosses
  steps, so no scan is needed at all.

The schedule (per-step drift + entering q/t codes) is host-precomputed from
a guide path; the kernel streams it as packed metadata.  A band of W wave
positions covers a 2W-column window per matrix row (adjacent rows hold the
interleaving parities), so W_wave = W_row/2 matches a row-band of W_row.

This module holds the host-side schedule builder and a numpy reference used
as the test oracle for the Pallas kernel (pallas_wavefront.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from telr_tpu_torch.kernels.dp import GLOBAL, EXTEND, LOCAL, NEG_INF, DPParams


@dataclasses.dataclass
class WaveSchedule:
    """Per-pair wavefront schedule.

    drift:  (S,) int8 in {-1,+1}; drift[s-1] = m_s - m_{s-1} for step s>=1
    q_in:   (S,) int8  code entering the reversed q-window when i0 advances
    t_in:   (S,) int8  code entering the t-window when j0 advances
    m0:     band base at s=0 (even)
    n_steps: number of real steps (= lq + lt)
    """

    drift: np.ndarray
    q_in: np.ndarray
    t_in: np.ndarray
    m0: int
    n_steps: int
    lq: int
    lt: int


def _cluster_corrections(target_m: np.ndarray, S: int,
                         width: int) -> np.ndarray:
    """Quantize the band-center guide into piecewise-constant plateaus.

    The parity walk alternates drift sign (+1/-1/+1/...) wherever the
    target is flat — the regime the kernel's shift-free interior body
    (pallas_wavefront.py alt range) exploits.  Interpolating the guide
    smoothly spreads length-mismatch corrections evenly, breaking
    alternation in nearly every 8-step block; rounding the target to
    multiples of q clusters the same corrections into rare q-sized jumps
    instead.  Deviation from the smooth guide is bounded by q/2 =
    width//16 offset units, far inside the band's ~width half-slack, so
    band coverage of the guide path is unchanged.  The guide is
    piecewise-linear through the chain anchors, so the number of jumps is
    bounded by its total variation / q — no oscillation at plateau
    boundaries."""
    q = float(max(2, width // 8))
    return (np.rint(target_m / q) * q).astype(np.int64)


def build_schedule(q: np.ndarray, t: np.ndarray, width: int,
                   guide_qs: Optional[np.ndarray] = None,
                   guide_ts: Optional[np.ndarray] = None,
                   n_steps_pad: Optional[int] = None) -> WaveSchedule:
    """Build the drift schedule following a guide path.

    The guide is a monotone set of matched points (guide_qs[k], guide_ts[k])
    (chain anchors); defaults to the straight diagonal.  The band base m_s
    tracks target_m(s) = o_guide(s) - width (band centered on the guide).
    """
    lq, lt = len(q), len(t)
    S = lq + lt
    if guide_qs is None or len(guide_qs) == 0:
        gq = np.array([0, lq], dtype=np.float64)
        gt = np.array([0, lt], dtype=np.float64)
    else:
        gq = np.concatenate([[0], np.asarray(guide_qs, np.float64), [lq]])
        gt = np.concatenate([[0], np.asarray(guide_ts, np.float64), [lt]])
        keep = np.concatenate([[True], np.diff(gq) > 0])
        gq, gt = gq[keep], np.maximum.accumulate(gt[keep])
    gs = gq + gt                       # step coordinate of guide points
    go_ = gt - gq                      # offset coordinate
    s_axis = np.arange(S + 1, dtype=np.float64)
    o_guide = np.interp(s_axis, gs, go_)
    target_m = np.rint(o_guide).astype(np.int64) - width
    if width >= 64:
        target_m = _cluster_corrections(target_m, S, width)

    # parity walk: m_s ≡ s (mod 2), |m_s - m_{s-1}| = 1, tracking target
    m0 = int(target_m[0])
    if m0 % 2 != 0:
        m0 += 1

    try:
        from telr_tpu_torch.io import native
        nat = native.load()
    except ImportError:
        nat = None
    if nat is not None:
        import ctypes
        qa = np.ascontiguousarray(q, dtype=np.int8)
        ta = np.ascontiguousarray(t, dtype=np.int8)
        tm = np.ascontiguousarray(target_m, dtype=np.int64)
        drift = np.empty(S, dtype=np.int8)
        q_in = np.empty(S, dtype=np.int8)
        t_in = np.empty(S, dtype=np.int8)
        nat.telr_wave_schedule(qa.ctypes.data, lq, ta.ctypes.data, lt,
                               tm.ctypes.data, S, m0, width,
                               drift.ctypes.data, q_in.ctypes.data,
                               t_in.ctypes.data)
        return WaveSchedule(drift=drift, q_in=q_in, t_in=t_in, m0=m0,
                            n_steps=S, lq=lq, lt=lt)

    m = np.zeros(S + 1, dtype=np.int64)
    m[0] = m0
    for s in range(1, S + 1):
        if target_m[s] >= m[s - 1] + 1:
            m[s] = m[s - 1] + 1
        elif target_m[s] <= m[s - 1] - 1:
            m[s] = m[s - 1] - 1
        else:
            # stay near target while alternating parity
            m[s] = m[s - 1] + (1 if (target_m[s] - m[s - 1]) >= 0 else -1)
    drift = np.diff(m).astype(np.int8)

    # i0(s) = (s - m_s)/2, j0(s) = (s + m_s)/2; windows hold
    # QW[p] = q[i0-1-p], TW[p] = t[j0-1+p].
    i0 = (np.arange(S + 1) - m) // 2
    j0 = (np.arange(S + 1) + m) // 2
    q_in = np.full(S, 4, dtype=np.int8)
    t_in = np.full(S, 4, dtype=np.int8)
    for s in range(1, S + 1):
        if i0[s] != i0[s - 1]:  # i0 advanced (drift == -1)
            idx = i0[s] - 1
            q_in[s - 1] = q[idx] if 0 <= idx < lq else 4
        if j0[s] != j0[s - 1]:  # j0 advanced (drift == +1)
            idx = j0[s] - 1 + (width - 1)
            t_in[s - 1] = t[idx] if 0 <= idx < lt else 4
    return WaveSchedule(drift=drift, q_in=q_in, t_in=t_in, m0=int(m[0]),
                        n_steps=S, lq=lq, lt=lt)


def numpy_wavefront(q: np.ndarray, t: np.ndarray, sched: WaveSchedule,
                    width: int, mode: int, params: DPParams,
                    qlen: Optional[int] = None, tlen: Optional[int] = None
                    ) -> Tuple[int, int]:
    """Reference implementation of the wavefront recurrence — computes
    exactly what the Pallas kernel computes (same windows, same masks).
    Returns (global_score, best_score)."""
    ma, mi, go, ge, amb = params.tuple()
    qlen = sched.lq if qlen is None else qlen
    tlen = sched.lt if tlen is None else tlen
    W = width
    p_idx = np.arange(W)
    neg = NEG_INF

    m_s = sched.m0
    i0 = (0 - m_s) // 2
    j0 = (0 + m_s) // 2
    # windows: QW[p] = q[i0-1-p], TW[p] = t[j0-1+p]
    def fill_qw():
        idx = i0 - 1 - p_idx
        w = np.full(W, 4, dtype=np.int64)
        ok = (idx >= 0) & (idx < len(q))
        w[ok] = q[idx[ok]]
        return w

    def fill_tw():
        idx = j0 - 1 + p_idx
        w = np.full(W, 4, dtype=np.int64)
        ok = (idx >= 0) & (idx < len(t))
        w[ok] = t[idx[ok]]
        return w

    QW = fill_qw()
    TW = fill_tw()

    def shiftL(x):  # x[p] <- x[p+1]
        return np.concatenate([x[1:], [neg]])

    def shiftR(x):  # x[p] <- x[p-1]
        return np.concatenate([[neg], x[:-1]])

    # H at s=0: boundary cell (0,0) if in band
    i_vec = i0 - p_idx
    j_vec = j0 + p_idx
    H1 = np.where((i_vec == 0) & (j_vec == 0), 0, neg)
    H2 = np.full(W, neg)
    I1 = np.full(W, neg)
    D1 = np.full(W, neg)
    d_prev = 0  # undefined before first step (H2 is -inf anyway)
    best = 0 if mode != GLOBAL else neg
    gbest = neg

    for s in range(1, sched.n_steps + 1):
        d = int(sched.drift[s - 1])
        # advance window bases
        if d == -1:
            i0 += 1
            QW = np.concatenate([[sched.q_in[s - 1]], QW[:-1]])
        else:
            j0 += 1
            TW = np.concatenate([TW[1:], [sched.t_in[s - 1]]])
        m_s += d
        i_vec = i0 - p_idx
        j_vec = j0 + p_idx

        # predecessors
        Hv = shiftL(H1) if d == 1 else H1
        Iv = shiftL(I1) if d == 1 else I1
        Hh = H1 if d == 1 else shiftR(H1)
        Dh = D1 if d == 1 else shiftR(D1)
        dd = d + d_prev
        if dd == 2:
            Hd = shiftL(H2)
        elif dd == -2:
            Hd = shiftR(H2)
        else:
            Hd = H2

        # no sentinel clamping — mirrors the kernel exactly (int32 headroom:
        # sentinels stay far below real scores for any feasible step count)
        I = np.maximum(Hv - go - ge, Iv - ge)
        D = np.maximum(Hh - go - ge, Dh - ge)
        qs = QW
        ts = TW
        sc = np.where((qs == 4) | (ts >= 4), amb,
                      np.where(qs == ts, ma, -mi))
        Hdg = Hd + sc
        H = np.maximum(Hdg, np.maximum(I, D))
        if mode == LOCAL:
            H = np.maximum(H, 0)

        # boundary overrides and validity
        if mode == LOCAL:
            b_i = np.zeros(W, dtype=np.int64)
            b_j = np.zeros(W, dtype=np.int64)
        else:
            b_i = -(go + ge * i_vec)
            b_j = -(go + ge * j_vec)
        H = np.where((i_vec == 0) & (j_vec == 0), 0,
                     np.where(i_vec == 0, b_j,
                              np.where(j_vec == 0, b_i, H)))
        valid = (i_vec >= 0) & (i_vec <= qlen) & (j_vec >= 0) & (j_vec <= tlen)
        H = np.where(valid, H, neg)
        I = np.where(valid, I, neg)
        D = np.where(valid, D, neg)

        inner = valid & (i_vec >= 1) & (j_vec >= 1)
        if mode != GLOBAL:
            best = max(best, int(np.max(np.where(inner, H, neg),
                                        initial=neg)))
        at_end = inner & (i_vec == qlen) & (j_vec == tlen)
        if at_end.any():
            gbest = max(gbest, int(H[at_end][0]))

        H2, H1, I1, D1 = H1, H, I, D
        d_prev = d

    if mode == GLOBAL:
        return gbest, gbest
    return gbest, best


def wavefront_traceback(dirs: np.ndarray, sched: "WaveSchedule",
                        start_i: int, start_j: int, mode: int):
    """Walk the kernel's direction bytes from cell (start_i, start_j) back
    to the alignment start.

    dirs: (S, W) int8, row s-1 holds step s; byte layout: 2b choice
    (0=diag, 1=D/horizontal, 2=I/vertical, 3=stop) | D-ext<<2 | I-ext<<3.
    Returns (cigar, end_i, end_j)."""
    W = dirs.shape[1]
    m = np.concatenate([[sched.m0],
                        sched.m0 + np.cumsum(sched.drift.astype(np.int64))])
    ops = []

    def push(op):
        if ops and ops[-1][0] == op:
            ops[-1] = (op, ops[-1][1] + 1)
        else:
            ops.append((op, 1))

    i, j = int(start_i), int(start_j)
    state = "H"
    while i > 0 and j > 0:
        s = i + j
        o = j - i
        p = (o - m[s]) // 2
        if (o - m[s]) % 2 != 0 or not (0 <= p < W):
            raise RuntimeError(
                f"traceback left the wave band at i={i} j={j} p={p}")
        byte = int(dirs[s - 1, p])
        ch = byte & 3
        if state == "H":
            if ch == 3:
                break  # LOCAL start / boundary marker
            if ch == 0:
                push("M")
                i -= 1
                j -= 1
            elif ch == 1:
                state = "D"
            else:
                state = "I"
        elif state == "D":
            push("D")
            ext = byte & 4
            j -= 1
            if not ext:
                state = "H"
        else:
            push("I")
            ext = byte & 8
            i -= 1
            if not ext:
                state = "H"
    if mode != LOCAL:
        while j > 0:
            push("D")
            j -= 1
        while i > 0:
            push("I")
            i -= 1
    ops.reverse()
    return ops, i, j
