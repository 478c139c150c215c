"""The plain reference's DP (benchmark/refdp.py) against a cell-by-cell
Gotoh recurrence written out in Python, on small random pairs at the score
sets the judges use."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark import refdp

NEG = -10 ** 9


def gotoh(q, t, ma, mi, o, e, fit=False, free=(0, 0)):
    m, n = len(q), len(t)
    a, b = (n, n) if fit else free
    H = [[NEG] * (n + 1) for _ in range(m + 1)]
    E = [[NEG] * (n + 1) for _ in range(m + 1)]
    F = [[NEG] * (n + 1) for _ in range(m + 1)]
    H[0][0] = 0
    for j in range(1, n + 1):
        H[0][j] = 0 if j <= a else -(o + e * (j - a))
        F[0][j] = H[0][j]
    for i in range(1, m + 1):
        H[i][0] = E[i][0] = -(o + e * i)
        for j in range(1, n + 1):
            E[i][j] = max(H[i - 1][j] - o - e, E[i - 1][j] - e)
            F[i][j] = max(H[i][j - 1] - o - e, F[i][j - 1] - e)
            s = ma if q[i - 1] == t[j - 1] else -mi
            H[i][j] = max(H[i - 1][j - 1] + s, E[i][j], F[i][j])
    return max(H[m][max(0, n - b):])


def pairs(seed=0, k=30):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        q = rng.integers(0, 4, int(rng.integers(0, 25))).astype(np.int8)
        if len(q) and rng.random() < 0.5:
            t = np.delete(q, rng.integers(0, len(q), 2)).astype(np.int8)
        else:
            t = rng.integers(0, 4, int(rng.integers(0, 25))).astype(np.int8)
        out.append((q, t))
    return out


@pytest.mark.parametrize("params", [(2, 4, 4, 2), (1, 9, 16, 2),
                                    (0, 1, 0, 1)])
def test_global_scores_match_gotoh(params):
    ps = pairs()
    assert refdp.global_scores(ps, *params) == [gotoh(q, t, *params)
                                                for q, t in ps]
    banded = refdp.global_scores(ps, *params, band=3)
    assert all(b <= g for b, g in zip(banded, refdp.global_scores(ps,
                                                                   *params)))


def test_fit_distance_matches_gotoh():
    ps = pairs(1)
    assert refdp.edit_distance(ps, fit=True) == [-gotoh(q, t, 0, 1, 0, 1, True)
                                                 for q, t in ps]
    t = np.random.default_rng(2).integers(0, 4, 80).astype(np.int8)
    q = t[20:50].copy()
    q[7] = (q[7] + 1) % 4
    assert refdp.edit_distance([(q, t)], fit=True) == [1]


@pytest.mark.parametrize("params", [(2, 4, 4, 2), (0, 1, 0, 1)])
def test_free_ends_match_gotoh(params):
    ps = pairs(3)
    free = [(k % 4, (k * 3) % 5) for k in range(len(ps))]
    assert refdp.global_scores(ps, *params, free=free) == [
        gotoh(q, t, *params, free=f) for (q, t), f in zip(ps, free)]
    # a query that is the target less 3 and 2 bases of its ends
    t = np.random.default_rng(4).integers(0, 4, 60).astype(np.int8)
    q = t[3:-2].copy()
    assert refdp.edit_distance([(q, t)] * 3,
                               free=[(3, 2), (2, 2), (0, 0)]) == [0, 1, 5]


def test_cigar_score():
    q = np.array([0, 1, 2, 3, 0, 1], np.int8)
    t = np.array([0, 1, 3, 3, 0, 1, 2], np.int8)
    got = refdp.cigar_score(q, t, [("M", 4), ("D", 1), ("M", 2)], 2, 4, 4, 2)
    # 3 matches and a mismatch, a 1-base gap, then two mismatches
    assert got == (2 * 3 - 4 - (4 + 2) - 2 * 4, 3, 6, 7)
    with pytest.raises(IndexError):
        refdp.cigar_score(q, t, [("M", 9)], 2, 4, 4, 2)
