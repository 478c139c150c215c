"""The plain reference's alignment arithmetic: nothing of the program.

`global_scores` is the best GLOBAL affine-gap score of each (query, target)
pair, over the whole matrix or, for the control, inside a band around the
pair's diagonal.  It runs row by row in plain torch ops on any device, all
pairs of a batch at once; within a row the horizontal gap is a running
maximum: with gap_open >= 0, F[j] = max over k < j of G[k] - open - extend *
(j - k), G being the row before its horizontal gaps.  A gap of length L
costs open + L * extend, as in the program's presets.

`cigar_score` scores a cigar against its sequences with the same rules, and
`edit_distance` is the unit-cost distance, the same DP with match 0,
mismatch 1, open 0, extend 1 (with `fit`, the query against the stretch of
the target it fits best: row 0 costs nothing and the best cell of the last
row ends it; with `free`, the query against the target less at most a given
number of its first and of its last bases).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

NEG = -(1 << 29)


def global_scores(pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
                  match: int, mismatch: int, gap_open: int, gap_extend: int,
                  band: Optional[int] = None, fit: bool = False,
                  free: Optional[Sequence[Tuple[int, int]]] = None,
                  device="cpu") -> List[int]:
    """Best GLOBAL score of each pair (query codes, target codes; int8 0-3).
    band: keep only cells within `band` columns of the straight line from
    (0, 0) to (lq, lt).  fit: the whole query against any stretch of the
    target (the target's ends are free).  free: per pair (a, b), the whole
    query against the target less at most its first a and its last b bases,
    which cost nothing."""
    import torch
    if gap_open < 0:
        raise ValueError("the running-maximum form needs gap_open >= 0")
    dev = torch.device(device)
    i32 = torch.int32
    B = len(pairs)
    if not B:
        return []
    lq = np.array([len(q) for q, _ in pairs], np.int64)
    lt = np.array([len(t) for _, t in pairs], np.int64)
    M, N = int(lq.max()), int(lt.max())
    Q = torch.full((B, M), 5, dtype=torch.int8)
    T = torch.full((B, N), 6, dtype=torch.int8)
    for b, (q, t) in enumerate(pairs):
        Q[b, :len(q)] = torch.from_numpy(np.asarray(q, np.int8))
        T[b, :len(t)] = torch.from_numpy(np.asarray(t, np.int8))
    Q, T = Q.to(dev), T.to(dev)
    cols = torch.arange(N + 1, dtype=i32, device=dev)
    ext = gap_extend * cols                       # e * j
    lq_t = torch.as_tensor(lq, device=dev)
    lt_t = torch.as_tensor(lt, device=dev)
    slope = (lt_t.double() / lq_t.clamp(min=1).double())[:, None]
    colsd = cols.double()[None, :]

    if fit:
        lead = lt_t.to(i32)[:, None]
        trail = lt_t.to(i32)
    elif free is not None:
        lead = torch.as_tensor([a for a, _ in free], dtype=i32,
                               device=dev)[:, None]
        trail = torch.as_tensor([b for _, b in free], dtype=i32, device=dev)
    else:
        lead = torch.zeros((B, 1), dtype=i32, device=dev)
        trail = torch.zeros(B, dtype=i32, device=dev)

    def last_row(rows, H):
        live = ((cols[None, :] <= lt_t[rows, None])
                & (cols[None, :] >= (lt_t - trail)[rows, None]))
        return torch.where(live, H[rows], NEG).max(dim=1).values

    def in_band(i: int):
        return (colsd - i * slope).abs() <= band

    skip = cols[None, :] - lead                  # bases past the free lead
    H = torch.where(skip <= 0, 0, -(gap_open + gap_extend * skip)).to(i32)
    if band is not None:
        H = torch.where(in_band(0), H, torch.full_like(H, NEG))
    E = torch.full((B, N + 1), NEG, dtype=i32, device=dev)
    out = torch.full((B,), NEG, dtype=i32, device=dev)
    ends = {}
    for b, n in enumerate(lq):
        ends.setdefault(int(n), []).append(b)
    ends = {i: torch.as_tensor(bs, device=dev) for i, bs in ends.items()}
    if 0 in ends:
        out[ends[0]] = last_row(ends[0], H)
    neg_col = torch.full((B, 1), NEG, dtype=i32, device=dev)
    for i in range(1, M + 1):
        qi = Q[:, i - 1:i]
        s = torch.where(qi == T, match, -mismatch).to(i32)
        diag = H[:, :-1] + s
        E = torch.maximum(H - (gap_open + gap_extend), E - gap_extend)
        G = torch.cat([torch.full((B, 1), -(gap_open + gap_extend * i),
                                  dtype=i32, device=dev),
                       torch.maximum(diag, E[:, 1:])], dim=1)
        if band is not None:
            keep = in_band(i)
            G = torch.where(keep, G, torch.full_like(G, NEG))
        run = torch.cummax(G + ext, dim=1).values
        F = torch.cat([neg_col, run[:, :-1] - gap_open - ext[1:]], dim=1)
        H = torch.maximum(G, F)
        if band is not None:
            H = torch.where(keep, H, torch.full_like(H, NEG))
        E[:, 0] = NEG
        if i in ends:
            out[ends[i]] = last_row(ends[i], H)
    return [int(x) for x in out.cpu()]


def edit_distance(pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
                  fit: bool = False,
                  free: Optional[Sequence[Tuple[int, int]]] = None,
                  device="cpu") -> List[int]:
    """Unit-cost edit distance of each pair; fit: of the whole query to its
    best-fitting stretch of the target; free: as global_scores's."""
    return [-s for s in global_scores(pairs, 0, 1, 0, 1, fit=fit, free=free,
                                      device=device)]


def cigar_score(q: np.ndarray, t: np.ndarray, cigar, match: int,
                mismatch: int, gap_open: int, gap_extend: int
                ) -> Tuple[int, int, int, int]:
    """(score, matches, query bases, target bases) of `cigar` laid over q and
    t from their starts.  Raises IndexError where the cigar runs past
    either sequence."""
    qi = ti = score = matches = 0
    for op, ln in cigar:
        if op == "M":
            if qi + ln > len(q) or ti + ln > len(t):
                raise IndexError("cigar runs past its sequences")
            eq = int(np.count_nonzero(q[qi:qi + ln] == t[ti:ti + ln]))
            matches += eq
            score += match * eq - mismatch * (ln - eq)
            qi += ln
            ti += ln
        elif op == "I":
            score -= gap_open + gap_extend * ln
            qi += ln
        elif op == "D":
            score -= gap_open + gap_extend * ln
            ti += ln
        else:
            raise ValueError(f"unexpected cigar op {op!r}")
    return score, matches, qi, ti


def revcomp(codes: np.ndarray) -> np.ndarray:
    return (3 - np.asarray(codes, np.int8))[::-1].copy()
