"""The two walks' plain versions on the kinds of walks that cross the CUDA
walk kernels' tile edges (long D and I runs, a constraining band edge, walks
that leave the band, a LOCAL STOP in mid-matrix, starts on row 0 and at
(0, 0)), at small size, against the JAX package on the same direction bytes:

  * hopper_dp.rowband_walk against telr_tpu.kernels.dp.traceback /
    traceback_arrays, on direction bytes of its banded_dp_batch;
  * hopper_wavefront.wavefront_walk against the JAX package's device walk
    pallas_wavefront._device_traceback_from_best (jitted XLA), on direction
    bytes of the port's plain wavefront DP (held to the JAX Pallas kernel by
    tests/test_torch_wavefront.py).

Every value is an integer and every comparison is exact (tolerance 0).  The
wavefront cases fit the 512-step rung at the widths of
tests/test_torch_wavefront.py (128, 512), so the JAX walk compiles once per
(mode, width)."""

import jax
import numpy as np
import pytest
import torch

from telr_tpu.kernels import dp as jdp
from telr_tpu.kernels import pallas_wavefront as jpw
from telr_tpu_torch.io import native
from telr_tpu_torch.kernels import dp as tdp
from telr_tpu_torch.kernels import hopper_dp
from telr_tpu_torch.kernels import hopper_wavefront as hw

from chip_smoke import _gapped, edit_rowband_walk, edit_wavefront_walk
from test_torch_rowband import _batch
from test_torch_rowband_walk import _check_against_host_walk, _decode, \
    _jax_dp

MODES = [jdp.GLOBAL, jdp.EXTEND, jdp.LOCAL]
EDITS = ["none", "all_d", "all_i", "row0"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain walks are thousands of small tensor ops: intra-op threads
    gain nothing there and thrash when several test workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pairs(core, flank, gaps, seed=7):
    """chip_smoke's gapped pairs (a shared core, a D or I run in its middle,
    unrelated flanks) at small size."""
    rng = np.random.default_rng(seed)
    return [_gapped(rng, core, g, flank) for g in gaps]


def _longest_runs(cigar):
    """The longest D and I runs of an array-form cigar (ops 0=M 1=D 2=I)."""
    ops, lens = cigar
    return (max([int(n) for o, n in zip(ops, lens) if o == 1], default=0),
            max([int(n) for o, n in zip(ops, lens) if o == 2], default=0))


# ----------------------------------------------------------------------
# the row-banded walk

def _rowband_case(name):
    """(args, W): gaps of 130-150 in a band as wide as the matrix (W = 512),
    or the same pairs in a band too narrow for them (W = 64), which the
    walks of the all-D and all-I edits leave."""
    pairs = _pairs(300, 30, (130, -130, 150, -150))
    W = 64 if name in ("edge", "all_d", "all_i") else 512
    return _batch(pairs, W), W


def _edit_rowband(args, mode, out, edit):
    """Apply a walk case's edit (chip_smoke.edit_rowband_walk) to numpy DP
    outputs (and, for a GLOBAL start on row 0, to the lengths the walk starts
    from)."""
    q, t, off, qlen, tlen = args
    out = [torch.from_numpy(x) for x in out]
    qlen, tlen = edit_rowband_walk(edit, mode, out, torch.from_numpy(qlen),
                                   torch.from_numpy(tlen))
    return (q, t, off, qlen.numpy(), tlen.numpy()), [x.numpy() for x in out]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", ["gaps", "edge"] + EDITS[1:])
def test_rowband_walk_equals_host_walk(case, mode):
    """Every pair's plain walk against the JAX package's host walk: ops,
    start and end cell, margin, and `bad` where the host walk refuses."""
    if not native.has_wave_decode():
        pytest.skip("native library not built")
    args, W = _rowband_case(case)
    out = _jax_dp(args, W, mode)
    args, out = _edit_rowband(args, mode, out,
                              case if case in EDITS else "none")
    small = _check_against_host_walk(args, W, mode, out)
    bad = small[hopper_dp.WALK_BAD]
    if case in ("all_d", "all_i"):
        assert bad.any()
    else:
        assert not bad.any()
    if case == "row0":
        assert (small[hopper_dp.WALK_SI] == 0).all()


def test_rowband_cases_are_what_they_say():
    """The gaps walk D and I runs longer than two 64-row tiles; the narrow
    band's GLOBAL walks touch a constraining edge; LOCAL walks stop in the
    middle of the matrix."""
    if not native.has_wave_decode():
        pytest.skip("native library not built")
    args, W = _rowband_case("gaps")
    packed, small = _walk_plain(args, W, jdp.GLOBAL)
    runs = [_longest_runs(c) for c in _decode(packed, small)]
    assert max(d for d, _ in runs) > 128 and max(i for _, i in runs) > 128
    args, W = _rowband_case("edge")
    _packed, small = _walk_plain(args, W, jdp.GLOBAL)
    assert (small[hopper_dp.WALK_MARGIN] == 0).any()
    args, W = _rowband_case("gaps")
    _packed, small = _walk_plain(args, W, jdp.LOCAL)
    assert (small[hopper_dp.WALK_EI] > 0).all()


def _walk_plain(args, W, mode):
    out = _jax_dp(args, W, mode)
    _q, t, off, qlen, tlen = args
    dirs, g, b, bi, bp = out
    i32 = lambda a: torch.from_numpy(np.array(a, np.int32))
    packed, small = hopper_dp.rowband_walk(
        torch.from_numpy(np.array(dirs, np.uint8)), i32(off), i32(qlen),
        i32(tlen), i32(g), i32(b), i32(bi), i32(bp), lt=t.shape[1],
        mode=mode)
    return packed.numpy(), small.numpy()


# ----------------------------------------------------------------------
# the wavefront walk

def _wave_case(name):
    """(pairs, guides, W) at lq + lt <= 512: gaps of 70-130 in a band that
    holds them (W = 512), or the same pairs with the band pinned to the main
    diagonal (guides at mid-query) and too narrow for the gaps (W = 128),
    which the walks of the all-D and all-I edits leave."""
    pairs = _pairs(160, 15, (70, -70, 100, -100, 130, -130, 0, 40))
    assert max(len(q) + len(t) for q, t in pairs) <= 512
    if name == "edge":
        guides = [(np.array([len(q) // 2]), np.array([len(q) // 2]))
                  for q, _t in pairs]
        return pairs, guides, 128
    return pairs, None, 512


def _to_jax_dirs(dirs, G):
    """(n, S_pad, W) pair-major bytes to the JAX kernel's (G, S_pad / 8, 64,
    W) layout: block, 8 steps, 8 pairs."""
    n, S_pad, W = dirs.shape
    d = np.zeros((G * 8, S_pad, W), np.int8)
    d[:n] = dirs
    d = d.reshape(G, 8, S_pad // 8, 8, W).transpose(0, 2, 3, 1, 4)
    return d.reshape(G, S_pad // 8, 64, W)


def _wave_inputs(case, mode):
    """The walk's inputs for one case: the port's plain DP on the case's
    pairs, then the case's edit."""
    pairs, guides, W = _wave_case(
        "edge" if case in ("edge", "all_d", "all_i") else "gaps")
    meta, init, scal = (torch.from_numpy(x) for x in
                        hw.prepare_wavefront_batch(pairs, W, guides))
    n = len(pairs)
    g, b, bs, bp, dirs = hw.wavefront_dp(meta, init, scal, n, W, mode,
                                         tdp.DPParams(), tb=True)
    scal, bs, bp = edit_wavefront_walk(
        case if case in EDITS else "none", mode, dirs, meta, scal, bs, bp)
    return W, dirs, meta, scal, (g, b, bs, bp)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", ["gaps", "edge"] + EDITS[1:])
def test_wavefront_walk_equals_jax_device_walk(case, mode):
    W, dirs, meta, scal, dp_out = _wave_inputs(case, mode)
    n, S_pad, _ = dirs.shape
    packed, small = hw.wavefront_walk(dirs, meta, scal, *dp_out, mode)
    G = meta.shape[0]
    pad = [np.zeros(G * 8, np.int32) for _ in dp_out]
    for p, x in zip(pad, dp_out):
        p[:n] = x.numpy()
    jpacked, jsmall = jpw._device_traceback_from_best(
        jax.device_put(_to_jax_dirs(dirs.numpy(), G)),
        jax.device_put(meta.numpy()), jax.device_put(scal.numpy()), *pad,
        mode=mode, S_max=S_pad, NB=S_pad // 8, W=W,
        extract=jpw._walk_extract())
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jpacked)[:, :n].view(np.uint8))
    np.testing.assert_array_equal(small.numpy(), np.asarray(jsmall)[:, :n])
    bad = small[4].numpy()
    if case in ("all_d", "all_i"):
        assert bad.any()
    elif case != "row0":
        assert not bad.any()
    if case == "gaps" and mode == jdp.LOCAL:
        assert (small[2] > 0).all()    # each walk stops in mid-matrix
    if case == "gaps" and mode == jdp.GLOBAL:
        # D and I runs longer than 64 steps cross a tile edge
        offsets, ops, lens = native.wave_decode_batch(
            packed.numpy(), small[2].numpy(), small[3].numpy(), bad, False)
        runs = [_longest_runs((ops[offsets[r]:offsets[r + 1]],
                               lens[offsets[r]:offsets[r + 1]]))
                for r in range(n)]
        assert max(d for d, _ in runs) > 64 and max(i for _, i in runs) > 64
