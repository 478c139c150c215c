"""The port's device walk over the row-banded direction bytes
(kernels/hopper_dp.py::rowband_walk, plain torch version on the CPU) and the
walk route of align_pairs, against the JAX package: the direction bytes come
from telr_tpu.kernels.dp.banded_dp_batch, the walks from its traceback /
traceback_arrays, the pair results from its align_pairs.  Everything is
integer data and every comparison is exact (tolerance 0)."""

import numpy as np
import pytest
import torch

from telr_tpu.kernels import dp as jdp
from telr_tpu_torch.dist import exec as texec
from telr_tpu_torch.dist import mesh as tmesh
from telr_tpu_torch.io import native
from telr_tpu_torch.kernels import dp as tdp
from telr_tpu_torch.kernels import hopper_dp

from test_torch_rowband import CASES, MODES, PARAMS, _align_items, _batch, \
    _mutate, _rand_seq


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain loops are thousands of small tensor ops: intra-op threads
    gain nothing there and thrash when several test workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_dp(args, W, mode):
    out = jdp.banded_dp_batch(*args, width=W, mode=mode, params_tuple=PARAMS)
    return [np.array(x) for x in out]      # writable copies


def _walk(args, W, mode, dp_out):
    """rowband_walk (CPU: the plain version) on numpy DP outputs."""
    _q, t, off, qlen, tlen = args
    dirs, g, b, bi, bp = dp_out
    i32 = lambda a: torch.from_numpy(np.array(a, np.int32))
    packed, small = hopper_dp.rowband_walk(
        torch.from_numpy(np.array(dirs, np.uint8)), i32(off),
        i32(qlen), i32(tlen), i32(g), i32(b), i32(bi), i32(bp),
        lt=t.shape[1], mode=mode)
    return packed.numpy(), small.numpy()


def _decode(packed, small):
    offsets, ops, lens = native.wave_decode_batch(
        packed.T, small[hopper_dp.WALK_EI], small[hopper_dp.WALK_EJ],
        small[hopper_dp.WALK_BAD], False)
    return [(ops[offsets[r]:offsets[r + 1]], lens[offsets[r]:offsets[r + 1]])
            for r in range(packed.shape[0])]


def _check_against_host_walk(args, W, mode, dp_out):
    _q, t, off, qlen, tlen = args
    dirs, g, b, bi, bp = dp_out
    packed, small = _walk(args, W, mode, dp_out)
    B, Lq = dirs.shape[:2]
    assert packed.shape == (B, hopper_dp.walk_steps(Lq, t.shape[1]) // 4)
    assert packed.dtype == np.uint8 and small.dtype == np.int32
    assert small.shape == (8, B)
    cigars = _decode(packed, small)
    assert np.array_equal(small[hopper_dp.WALK_GSCORE], g)
    assert np.array_equal(small[hopper_dp.WALK_BEST], b)
    for r in range(B):
        if mode == jdp.GLOBAL:
            si, sj = int(qlen[r]), int(tlen[r])
        else:
            si = int(bi[r])
            sj = int(off[r, si]) + int(bp[r]) if si > 0 else int(bp[r])
        assert (small[hopper_dp.WALK_SI, r], small[hopper_dp.WALK_SJ, r]) \
            == (si, sj)
        try:
            (ops, lens), ei, ej, margin = jdp.traceback_arrays(
                dirs[r], off[r], si, sj, mode, int(tlen[r]))
        except RuntimeError:
            # where the host walker refuses a walk, the device walk says so
            assert small[hopper_dp.WALK_BAD, r] == 1
            continue
        assert not small[hopper_dp.WALK_BAD, r]
        assert (small[hopper_dp.WALK_SI, r], small[hopper_dp.WALK_SJ, r]) \
            == (si, sj)
        assert (small[hopper_dp.WALK_EI, r], small[hopper_dp.WALK_EJ, r]) \
            == (ei, ej)
        assert small[hopper_dp.WALK_MARGIN, r] == margin
        assert np.array_equal(cigars[r][0], ops)
        assert np.array_equal(cigars[r][1], lens)
        # ... and the list form of the same walk
        cig, ei2, ej2 = jdp.traceback(dirs[r], off[r], si, sj, mode,
                                      int(tlen[r]))
        assert tdp.arrays_to_cigar(cigars[r]) == list(cig)
        assert (ei2, ej2) == (ei, ej)
    return small


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_walk_equals_host_walk(case, mode):
    if not native.has_wave_decode():
        pytest.skip("native library not built")
    *args, W = CASES[case]()
    _check_against_host_walk(args, W, mode, _jax_dp(args, W, mode))


@pytest.mark.parametrize("mode", [jdp.EXTEND, jdp.LOCAL])
def test_walk_from_a_best_cell_on_row_0(mode):
    """Unrelated sequences under EXTEND / LOCAL: nothing scores above the
    empty alignment, so the best cell stays on row 0 and the walk is empty
    (or, from a start at column j of row 0, a run of j D)."""
    if not native.has_wave_decode():
        pytest.skip("native library not built")
    q = np.zeros(40, np.int8)
    t = np.full(60, 1, np.int8)
    args = _batch([(q, t), (_rand_seq(np.random.default_rng(0), 30), t)], 128)
    out = _jax_dp(args, 128, mode)
    assert out[3][0] == 0                      # besti: row 0
    small = _check_against_host_walk(args, 128, mode, out)
    assert small[hopper_dp.WALK_SI, 0] == 0
    # a start further along row 0 walks back as a run of D, as on the host
    out[3][:] = 0
    out[4][:] = 7
    small = _check_against_host_walk(args, 128, mode, out)
    assert small[hopper_dp.WALK_SJ, 0] == 7 and small[hopper_dp.WALK_EJ, 0] == 0


def _edge_case():
    """A band just too narrow for its pair: a 33-base insertion in the query
    under a diagonal band of 64 (32 either side), so the best in-band path
    runs along a band edge that has matrix cells beyond it."""
    rng = np.random.default_rng(5)
    t = _rand_seq(rng, 400)
    q = np.concatenate([t[:150], _rand_seq(rng, 33), t[150:367]])
    return _batch([(q, t)], 64), 64


@pytest.mark.parametrize("mode", MODES)
def test_walk_touching_a_constraining_edge_has_margin_0(mode):
    if not native.has_wave_decode():
        pytest.skip("native library not built")
    args, W = _edge_case()
    small = _check_against_host_walk(args, W, mode, _jax_dp(args, W, mode))
    if mode == jdp.GLOBAL:
        assert small[hopper_dp.WALK_MARGIN, 0] == 0


def _escaping_case():
    """Direction bytes that lead out of the band: every cell says 'gap in
    the target' (D, extended), so the walk runs left along its row and
    leaves the band where the band does not start at column 0."""
    rng = np.random.default_rng(6)
    t = _rand_seq(rng, 300)
    args = _batch([(_mutate(rng, t)[:200], t)], 64)
    out = _jax_dp(args, 64, jdp.GLOBAL)
    out[0][:] = 1 | 4
    return args, out


def test_walk_leaving_the_band_is_flagged_bad():
    args, out = _escaping_case()
    _q, _t, off, qlen, tlen = args
    assert off[0, qlen[0]] > 0
    with pytest.raises(RuntimeError, match="left the band"):
        jdp.traceback_arrays(out[0][0], off[0], int(qlen[0]), int(tlen[0]),
                             jdp.GLOBAL, int(tlen[0]))
    _packed, small = _walk(args, 64, jdp.GLOBAL, out)
    assert small[hopper_dp.WALK_BAD, 0] == 1


def test_stop_byte_outside_local_is_flagged_bad():
    args, out = _escaping_case()
    out[0][:] = 3
    _q, _t, off, qlen, tlen = args
    with pytest.raises(RuntimeError):
        jdp.traceback_arrays(out[0][0], off[0], int(qlen[0]), int(tlen[0]),
                             jdp.GLOBAL, int(tlen[0]))
    _packed, small = _walk(args, 64, jdp.GLOBAL, out)
    assert small[hopper_dp.WALK_BAD, 0] == 1
    # in LOCAL the same byte ends the walk where it stands
    _packed, small = _walk(args, 64, jdp.LOCAL, out)
    assert small[hopper_dp.WALK_BAD, 0] == 0
    assert small[hopper_dp.WALK_EI, 0] == small[hopper_dp.WALK_SI, 0]


class _EscapingRunner:
    """A walk runner whose DP results lead out of the band."""
    dirs_budget = 1 << 28

    def walks(self, q, t, off, qlen, tlen, *, width, mode, params_tuple,
              walk=True):
        out = _jax_dp((q, t, off, qlen, tlen), width, mode)
        out[0][:] = 1 | 4
        return lambda: _walk((q, t, off, qlen, tlen), width, mode, out)


def test_align_pairs_raises_the_host_walkers_error():
    if not native.has_banded_dp():
        pytest.skip("native library not built")
    rng = np.random.default_rng(6)
    t = _rand_seq(rng, 300)
    q = _mutate(rng, t)[:200]
    items = [(q, t, tdp.GLOBAL, tdp.DPParams(), 64, None)]

    def escaping_batch(*args, **kw):
        out = _jax_dp(args, kw["width"], kw["mode"])
        out[0][:] = 1 | 4
        return out

    with pytest.raises(RuntimeError) as host:
        jdp.align_pairs(items, runner=escaping_batch)
    with pytest.raises(RuntimeError) as port:
        tdp.align_pairs(items, runner=_EscapingRunner())
    assert str(port.value) == str(host.value)
    assert "traceback left the band from" in str(port.value)


def _assert_results_equal(want, got, cigar_arrays):
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert set(w) == set(g)
        for key in w:
            if key == "cigar" and cigar_arrays:
                assert all(np.array_equal(a, b) and a.dtype == b.dtype
                           for a, b in zip(w[key], g[key]))
            else:
                assert w[key] == g[key], key


@pytest.mark.parametrize("n_shards", [1, 3])
@pytest.mark.parametrize("cigar_arrays", [False, True])
def test_align_pairs_walk_runner_equals_jax(cigar_arrays, n_shards):
    """align_pairs through the mesh runner's device walks against the JAX
    package's align_pairs with its own device DP and host walk."""
    if not native.has_wave_decode():
        pytest.skip("native library not built")
    items = _align_items()
    jitems = [(q, t, mode, jdp.DPParams(*par.tuple()), w, off)
              for q, t, mode, par, w, off in items]
    want = jdp.align_pairs(jitems, runner=jdp.banded_dp_batch,
                           cigar_arrays=cigar_arrays)
    runner = texec.sharded_dp_runner(tmesh.make_mesh(n_shards, device="cpu"))
    assert runner.walks is not None
    got = tdp.align_pairs(items, runner=runner, cigar_arrays=cigar_arrays)
    _assert_results_equal(want, got, cigar_arrays)


def test_align_pairs_walk_runner_without_cigars():
    items = _align_items()
    jitems = [(q, t, mode, jdp.DPParams(*par.tuple()), w, off)
              for q, t, mode, par, w, off in items]
    want = jdp.align_pairs(jitems, runner=jdp.banded_dp_batch,
                           want_cigar=False)
    runner = texec.sharded_dp_runner(tmesh.make_mesh(2, device="cpu"))
    got = tdp.align_pairs(items, runner=runner, want_cigar=False)
    _assert_results_equal(want, got, False)


def _many_items():
    rng = np.random.default_rng(33)
    par = tdp.DPParams()
    items = []
    for k in range(9):
        t = _rand_seq(rng, int(rng.integers(70, 120)))
        items.append((_mutate(rng, t), t, MODES[k % 3], par, 64, None))
    return items


@pytest.mark.parametrize("budget", [1, 2 * 128 * 64, 1 << 28])
def test_chunking_by_the_device_budget_changes_nothing(budget, monkeypatch):
    """One pair a launch, two a launch or all in one: the same results as
    the native route under its own caps, and as many launches as the budget
    implies."""
    if not native.has_banded_dp():
        pytest.skip("native library not built")
    items = _many_items()
    want = tdp.align_pairs(items, cigar_arrays=True)
    runner = texec.ShardedDPRunner(tmesh.make_mesh(1, device="cpu"))
    monkeypatch.setattr(runner, "dirs_budget", budget)
    calls = []
    walks = runner.walks
    monkeypatch.setattr(runner, "walks", lambda *a, **kw: (
        calls.append(a[0].shape[0]), walks(*a, **kw))[1])
    got = tdp.align_pairs(items, runner=runner, cigar_arrays=True)
    _assert_results_equal(want, got, True)
    # three modes of three pairs each, all in the (128, 128) bucket
    per_launch = {1: 1, 2 * 128 * 64: 2}.get(budget, 3)
    assert sorted(calls) == sorted(
        [n for _ in range(3) for n in ([1, 1, 1], [1, 2], [3])[per_launch - 1]])
    assert runner.bytes_to_host > 0


def test_walk_runner_brings_back_walks_not_direction_bytes():
    """What the runner copies back per pair is the packed walk and eight
    scalars, not Lq x W direction bytes."""
    items = _many_items()[:3]
    runner = texec.ShardedDPRunner(tmesh.make_mesh(1, device="cpu"))
    tdp.align_pairs(items, runner=runner, cigar_arrays=True)
    lq_b = lt_b = 128
    per_pair = hopper_dp.walk_steps(lq_b, lt_b) // 4 + 8 * 4
    assert runner.bytes_to_host == 3 * per_pair
    assert per_pair * 50 < lq_b * 64


def test_banded_dp_walk_without_walk_gives_start_cells():
    *args, W = CASES["related"]()
    for mode in MODES:
        packed, small = tdp.banded_dp_walk(*args, width=W, mode=mode,
                                           params_tuple=PARAMS, device="cpu")
        none, short = tdp.banded_dp_walk(*args, width=W, mode=mode,
                                         params_tuple=PARAMS, device="cpu",
                                         walk=False)
        assert none is None and short.shape == small.shape
        for row in (hopper_dp.WALK_GSCORE, hopper_dp.WALK_BEST,
                    hopper_dp.WALK_SI, hopper_dp.WALK_SJ):
            assert torch.equal(short[row], small[row])


def test_walk_wrapper_checks():
    *args, W = CASES["related"]()
    out = _jax_dp(args, W, jdp.GLOBAL)
    _q, t, off, qlen, tlen = args
    i32 = lambda a: torch.from_numpy(np.array(a, np.int32))
    dirs = torch.from_numpy(out[0])
    rest = [i32(x) for x in (off, qlen, tlen) + tuple(out[1:])]
    kw = dict(lt=t.shape[1], mode=jdp.GLOBAL)
    hopper_dp.rowband_walk(dirs, *rest, **kw)
    with pytest.raises(TypeError, match="uint8"):
        hopper_dp.rowband_walk(dirs.to(torch.int8), *rest, **kw)
    with pytest.raises(ValueError, match="off"):
        hopper_dp.rowband_walk(dirs, rest[0][:, :-1].contiguous(), *rest[1:],
                               **kw)
    with pytest.raises(ValueError, match="int32"):
        hopper_dp.rowband_walk(dirs, rest[0], rest[1].to(torch.int64),
                               *rest[2:], **kw)
    with pytest.raises(ValueError, match="target length"):
        hopper_dp.rowband_walk(dirs, *rest, lt=0, mode=jdp.GLOBAL)
