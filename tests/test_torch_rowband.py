"""The port's row-banded DP (kernels/hopper_dp.py, plain torch version on the
CPU) against the JAX package: dp.banded_dp_batch / banded_dp_scores, the
Pallas kernel pallas_dp_scores in interpret mode, and the native C++ engine.
All results are int32 / uint8 and every comparison is exact (tolerance 0)."""

import functools

import numpy as np
import pytest
import torch

from telr_tpu.kernels import dp as jdp
from telr_tpu.kernels.pallas_dp import pallas_dp_scores
from telr_tpu_torch.io import native
from telr_tpu_torch.kernels import dp as tdp
from telr_tpu_torch.kernels import hopper_dp

PARAMS = jdp.DPParams().tuple()
MODES = [jdp.GLOBAL, jdp.EXTEND, jdp.LOCAL]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain row loop is thousands of small tensor ops: intra-op threads
    gain nothing there and thrash when several test workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand_seq(rng, n, hi=4):
    return rng.integers(0, hi, size=n).astype(np.int8)


def _mutate(rng, codes, sub=0.1, ins=0.05, dele=0.05):
    out = []
    for c in codes:
        r = rng.random()
        if r < dele:
            continue
        if r < dele + ins:
            out.append(rng.integers(0, 4))
        out.append(rng.integers(0, 4) if rng.random() < sub else c)
    return np.array(out, dtype=np.int8)


def _batch(pairs, width, offs=None):
    """Pad (q, t) pairs to one bucketed batch the way dp._prep_pair does."""
    lq_b = jdp._bucket(max(len(q) for q, _ in pairs))
    lt_b = jdp._bucket(max(len(t) for _, t in pairs))
    B = len(pairs)
    q = np.full((B, lq_b), 4, np.int8)
    t = np.full((B, lt_b), 4, np.int8)
    off = np.zeros((B, lq_b + 1), np.int32)
    qlen = np.zeros(B, np.int32)
    tlen = np.zeros(B, np.int32)
    for b, (qq, tt) in enumerate(pairs):
        o = (jdp.make_band_offsets(len(qq), len(tt), width)
             if offs is None else offs[b])
        q[b, :len(qq)] = qq
        t[b, :len(tt)] = tt
        off[b] = o[-1]
        off[b, :len(o)] = o
        qlen[b], tlen[b] = len(qq), len(tt)
    return q, t, off, qlen, tlen


def _case_related():
    """tests/test_dp.py's related pairs: ragged qlen / tlen in one batch."""
    pairs = []
    for seed in range(4):
        rng = np.random.default_rng(seed)
        t = _rand_seq(rng, rng.integers(40, 120))
        pairs.append((_mutate(rng, t), t))
    return _batch(pairs, 256) + (256,)


def _case_big_insertion():
    """tests/test_dp.py's anchor-led band with a 400-base query insertion."""
    rng = np.random.default_rng(7)
    left, right, ins = (_rand_seq(rng, n) for n in (300, 300, 400))
    t = np.concatenate([left, right])
    q = np.concatenate([left, ins, right])
    off = jdp.offsets_from_path(len(q), len(t), 512,
                                np.array([150, 300, 700, 850]),
                                np.array([150, 300, 300, 450]))
    return _batch([(q, t)], 512, [off]) + (512,)


def _case_codes_0_to_4():
    """tests/test_pallas_dp.py's batch: codes 0-4, qlen short of Lq while
    the offsets keep moving past it."""
    rng = np.random.default_rng(1)
    B, LQ, LT, W = 3, 700, 900, 128
    q = rng.integers(0, 5, size=(B, LQ)).astype(np.int8)
    t = rng.integers(0, 5, size=(B, LT)).astype(np.int8)
    qlen = np.array([700, 512, 300], np.int32)
    tlen = np.array([900, 750, 420], np.int32)
    off = np.stack([jdp.make_band_offsets(LQ, int(tl), W) for tl in tlen])
    return q, t, off, qlen, tlen, W


def _case_pallas_anchored():
    """tests/test_pallas_dp.py's anchor-led band at W = 256."""
    rng = np.random.default_rng(2)
    left, right, ins = (_rand_seq(rng, n) for n in (300, 300, 400))
    t = np.concatenate([left, right])
    q = np.concatenate([left, ins, right])
    off = jdp.offsets_from_path(len(q), len(t), 256,
                                np.array([150, 300, 700, 850]),
                                np.array([150, 300, 300, 450]))
    return (q[None], t[None], off[None], np.array([len(q)], np.int32),
            np.array([len(t)], np.int32), 256)


CASES = {"related": _case_related, "big_insertion": _case_big_insertion,
         "codes_0_to_4": _case_codes_0_to_4,
         "pallas_anchored": _case_pallas_anchored}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_banded_dp_batch_equals_jax(case, mode):
    *args, W = CASES[case]()
    kw = dict(width=W, mode=mode, params_tuple=PARAMS)
    want = jdp.banded_dp_batch(*args, **kw)
    got = tdp.banded_dp_batch(*args, **kw, device="cpu")
    assert got[0].dtype == torch.uint8
    for name, w, g in zip(("dirs", "gscore", "best", "besti", "bestp"),
                          want, got):
        assert np.array_equal(np.asarray(w), g.numpy()), (case, mode, name)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", ["codes_0_to_4", "pallas_anchored"])
def test_banded_dp_scores_equals_jax_and_pallas(case, mode):
    *args, W = CASES[case]()
    kw = dict(width=W, mode=mode, params_tuple=PARAMS)
    got = tdp.banded_dp_scores(*args, **kw, device="cpu")
    scan = jdp.banded_dp_scores(*args, **kw)
    pallas = pallas_dp_scores(*args, **kw, interpret=True)
    for g, s, p in zip(got, scan, pallas):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(s)), (case, mode)
        assert np.array_equal(g.numpy(), np.asarray(p)), (case, mode)


@pytest.mark.parametrize("mode", MODES)
def test_scores_instance_equals_traceback_instance(mode):
    *args, W = _case_related()
    kw = dict(width=W, mode=mode, params_tuple=PARAMS)
    _d, g, b, _i, _p = tdp.banded_dp_batch(*args, **kw, device="cpu")
    g2, b2 = tdp.banded_dp_scores(*args, **kw, device="cpu")
    assert torch.equal(g, g2) and torch.equal(b, b2)


@pytest.mark.parametrize("mode", MODES)
def test_plain_version_equals_native_engine(mode):
    """As tests/test_native.py holds the JAX DP against the C++ engine."""
    if not native.has_banded_dp():
        pytest.skip("native library not built")
    rng = np.random.default_rng(9)
    for trial in range(12):
        lq = int(rng.integers(1, 300))
        lt = int(rng.integers(1, 400))
        W = min(int(rng.choice([64, 128])), tdp._bucket(lt + 1))
        q, t = _rand_seq(rng, lq, 5), _rand_seq(rng, lt, 5)
        args = _batch([(q, t)], W)
        kw = dict(width=W, mode=mode, params_tuple=PARAMS)
        got = tdp.banded_dp_batch(*args, **kw, device="cpu")
        nat = native.banded_dp_batch(*args, **kw)
        for g, n in zip(got[1:], nat[1:]):
            assert int(g[0]) == int(n[0]), (trial, mode)
        assert np.array_equal(got[0][0][:lq].numpy(), nat[0][0][:lq]), \
            (trial, mode)


def _align_items():
    rng = np.random.default_rng(21)
    par = tdp.DPParams()
    items = []
    for k in range(10):
        t = _rand_seq(rng, int(rng.integers(30, 400)))
        q = _mutate(rng, t)
        items.append((q, t, MODES[k % 3], par, None, None))
    # an anchor-led band, an explicit width, and the degenerate pairs
    left, right, ins = (_rand_seq(rng, n) for n in (300, 300, 400))
    t = np.concatenate([left, right])
    q = np.concatenate([left, ins, right])
    off = tdp.offsets_from_path(len(q), len(t), 512,
                                np.array([150, 300, 700, 850]),
                                np.array([150, 300, 300, 450]))
    items.append((q, t, tdp.GLOBAL, par, 512, off))
    items.append((q[:50], t[:40], tdp.EXTEND, par, 128, None))
    items.append((q[:4], np.zeros(0, np.int8), tdp.GLOBAL, par, None, None))
    items.append((np.zeros(0, np.int8), t[:4], tdp.GLOBAL, par, None, None))
    return items


@pytest.mark.parametrize("cigar_arrays", [False, True])
def test_align_pairs_runner_equals_native_engine(cigar_arrays):
    if not native.has_banded_dp():
        pytest.skip("native library not built")
    items = _align_items()
    runner = functools.partial(tdp.banded_dp_batch, device="cpu")
    want = tdp.align_pairs(items, cigar_arrays=cigar_arrays)
    got = tdp.align_pairs(items, runner=runner, cigar_arrays=cigar_arrays)
    assert len(got) == len(want) == len(items)
    for w, g in zip(want, got):
        assert set(w) == set(g)
        for key in w:
            if key == "cigar" and cigar_arrays:
                assert all(np.array_equal(a, b)
                           for a, b in zip(w[key], g[key]))
            else:
                assert w[key] == g[key], key


def test_align_pairs_without_runner_needs_the_native_engine(monkeypatch):
    """The torch DP is an explicit runner, never a silent fallback."""
    monkeypatch.setattr(native, "has_banded_dp", lambda: False)
    with pytest.raises(RuntimeError, match="native"):
        tdp.align_pairs(_align_items()[:2])


def _tensors(args):
    dts = (torch.int8, torch.int8, torch.int32, torch.int32, torch.int32)
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dt)
            for a, dt in zip(args, dts)]


@pytest.mark.parametrize("bad", ["non_monotone", "step_over_width",
                                 "negative_start", "past_target"])
def test_offsets_outside_the_contract_raise(bad):
    """jax.lax.dynamic_slice would clamp these silently; the port refuses."""
    *args, W = _case_codes_0_to_4()
    q, t, off, qlen, tlen = _tensors(args)
    off = off.clone()
    if bad == "non_monotone":
        off[1, 300] = off[1, 299] - 1
    elif bad == "step_over_width":
        off[0, 400:] += W + 1
    elif bad == "negative_start":
        off[2, 0] = -1
    else:
        off[0, -1] = t.shape[1] + 1
    with pytest.raises(ValueError, match="band offsets"):
        hopper_dp.rowband_dp(q, t, off, qlen, tlen, width=W,
                             mode=tdp.GLOBAL, params_tuple=PARAMS)


@pytest.mark.parametrize("bad", ["q_dtype", "off_dtype", "off_shape",
                                 "tlen_shape", "not_contiguous"])
def test_wrapper_refuses_bad_batches(bad):
    *args, W = _case_codes_0_to_4()
    q, t, off, qlen, tlen = _tensors(args)
    err = ValueError
    if bad == "q_dtype":
        q, err = q.to(torch.int32), TypeError
    elif bad == "off_dtype":
        off, err = off.to(torch.int64), TypeError
    elif bad == "off_shape":
        off = off[:, :-1].contiguous()
    elif bad == "tlen_shape":
        tlen = tlen[:-1]
    else:
        t = t.t().contiguous().t()
    with pytest.raises(err):
        hopper_dp.rowband_dp(q, t, off, qlen, tlen, width=W,
                             mode=tdp.GLOBAL, params_tuple=PARAMS)


def test_cpu_tensors_never_count_as_launches():
    *args, W = _case_related()
    before = hopper_dp.rowband_dp.launches
    hopper_dp.rowband_dp(*_tensors(args), width=W, mode=tdp.EXTEND,
                         params_tuple=PARAMS, tb=False)
    assert hopper_dp.rowband_dp.launches == before
