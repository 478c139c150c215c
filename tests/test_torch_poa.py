"""The port's POA binding (telr_poa_consensus_rows in the port's own host
library, csrc/poa_rows.cpp, the row-form DP) against the JAX package's
(telr_poa_consensus in native/telr_native.cpp): the same consensus bytes on
a seeded fuzz set of PacBio-like and ONT-like loci, band widths 16-192,
backbones of 0.3-12 kb, 0-40 segments, whole and partial; the DP counters
it returns; calls on eight threads at once, each with its own buffers; and
a gap-open bonus, which it refuses."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from telr_tpu.io import native as jax_native
from telr_tpu_torch.io import host_lib, native

from test_poa import _mutate

pytestmark = pytest.mark.skipif(not jax_native.has_poa(),
                                reason="the JAX package's native engine, "
                                "the reference, is not built")

PROFILES = {
    "pacbio": (0.10, dict(p_sub=0.25, p_ins=0.40, ins_extra=1,
                          del_extra=1)),
    "ont": (0.12, dict(p_sub=0.20, p_ins=0.25, ins_extra=1, del_extra=3)),
}

# (seed, profile, backbone length, segments, segment length or None for the
# whole backbone, W, min_cov, share of N bases)
CASES = [
    (1, "pacbio", 300, 1, None, 16, 1, 0.0),
    (2, "ont", 300, 40, 120, 64, 2, 0.0),
    (3, "pacbio", 1000, 12, None, 192, 2, 0.0),
    (4, "ont", 1000, 12, None, 192, 1, 0.02),
    (5, "pacbio", 3000, 20, 1500, 64, 1, 0.0),
    (6, "ont", 3000, 25, 2000, 16, 2, 0.01),
    (7, "pacbio", 5000, 40, 500, 64, 2, 0.0),
    (8, "ont", 6000, 8, 4000, 192, 2, 0.0),
    (9, "pacbio", 12000, 6, 6000, 16, 2, 0.0),
    (10, "ont", 12000, 3, 3000, 192, 1, 0.005),
    (11, "pacbio", 2000, 0, None, 64, 2, 0.0),
]

# a case whose graph has an edge into a node ranked before its source (a
# merged ALT node's), so some row reads a predecessor not computed yet
LATE = 8


def _locus(seed, profile, bb_len, n_segs, seg_len, n_share):
    rng = np.random.default_rng(seed)
    err, kw = PROFILES[profile]
    truth = rng.integers(0, 4, bb_len).astype(np.int8)
    segs, c0s, c1s = [], [], []
    for i in range(n_segs):
        if seg_len is None:
            a, b = 0, bb_len
        else:
            a = int(rng.integers(0, bb_len - seg_len + 1))
            b = a + seg_len
        seg = _mutate(truth[a:b], rng, err, **kw)
        if n_share:
            seg[rng.random(len(seg)) < n_share] = 4
        if i == 3:
            seg = seg[:0]               # an empty segment is skipped
        segs.append(seg)
        c0s.append(a)
        c1s.append(b)
    bb = _mutate(truth, rng, err, **kw)
    if n_share:
        bb[rng.random(len(bb)) < n_share] = 4
    return bb, segs, c0s, [min(c, len(bb)) for c in c1s]


def _both(case):
    seed, profile, bb_len, n_segs, seg_len, width, min_cov, n_share = case
    bb, segs, c0s, c1s = _locus(seed, profile, bb_len, n_segs, seg_len,
                                n_share)
    kw = dict(width=width, match=2, mismatch=4, gap_open=4, gap_extend=2,
              min_cov=min_cov)
    got = {}
    port = native.poa_consensus(bb, segs, c0s, c1s, stats=got, **kw)
    ref = jax_native.poa_consensus(bb, segs, c0s, c1s, **kw)
    return port, ref, got


@pytest.mark.parametrize("case", CASES, ids=[
    f"{c[1]}-{c[2]}bp-{c[3]}segs-W{c[5]}-cov{c[6]}" for c in CASES])
def test_consensus_equals_reference(case):
    port, ref, got = _both(case)
    assert port.dtype == ref.dtype == np.int8
    assert port.tobytes() == ref.tobytes()
    if case[3]:
        assert got["dp_rows"] > 0
        assert got["dp_cells"] >= got["dp_rows"]
    else:
        assert got == dict(dp_rows=0, dp_cells=0, late_pred_rows=0)


def test_late_predecessor_case():
    """The pinned case reads a predecessor ranked later, and still equals
    the reference."""
    port, ref, got = _both(CASES[LATE - 1])
    assert got["late_pred_rows"] > 0
    assert port.tobytes() == ref.tobytes()


def test_threads_equal_serial():
    """Eight calls on eight threads (the ctypes call releases the GIL)
    give the serial calls' bytes: no state is shared between calls."""
    jobs = []
    for case in CASES[:8]:
        seed, profile, bb_len, n_segs, seg_len, width, min_cov, ns = case
        bb, segs, c0s, c1s = _locus(seed, profile, bb_len, n_segs,
                                    seg_len, ns)
        jobs.append((bb, segs, c0s, c1s,
                     dict(width=width, min_cov=min_cov)))

    def run(job):
        bb, segs, c0s, c1s, kw = job
        return native.poa_consensus(bb, segs, c0s, c1s, **kw).tobytes()

    serial = [run(j) for j in jobs]
    with ThreadPoolExecutor(max_workers=8) as ex:
        futures = [ex.submit(run, j) for j in jobs]
        threaded = [f.result(timeout=120) for f in futures]
    assert threaded == serial


def test_gap_open_bonus_is_refused():
    """The row form's insertion scan takes gap_open >= 0 only: a bonus
    raises, rather than leaving the consensus silently unrefined."""
    bb, segs, c0s, c1s = _locus(1, "pacbio", 300, 3, None, 0.0)
    with pytest.raises(ValueError, match="gap_open"):
        native.poa_consensus(bb, segs, c0s, c1s, gap_open=-1)


def test_port_library_is_its_own():
    """The port's POA entry lives in the port's own host library, which
    does not carry the JAX package's engine."""
    lib = host_lib.load()
    assert hasattr(lib, "telr_poa_consensus_rows")
    assert not hasattr(lib, "telr_poa_consensus")
    assert native.has_poa()
