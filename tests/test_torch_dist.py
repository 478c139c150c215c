"""The port's single-process mesh modules (telr_tpu_torch/dist) against the
JAX package's on its 8-device host mesh: mesh shape, the score steps, the
sharded DP runner, the depth reduction and the locus all-to-all.  The port's
meshes here are CPU shards (make_mesh(n, device="cpu")); every comparison is
exact (int32 / uint8 / int8 data, tolerance 0)."""

import numpy as np
import pytest
import torch

import jax

from telr_tpu.dist import exec as jexec
from telr_tpu.dist import mesh as jmesh
from telr_tpu.dist import pipeline as jpipe
from telr_tpu.dist import redistribute as jred
from telr_tpu.kernels import dp as jdp
from telr_tpu_torch.dist import exec as texec
from telr_tpu_torch.dist import mesh as tmesh
from telr_tpu_torch.dist import pipeline as tpipe
from telr_tpu_torch.dist import redistribute as tred

PARAMS = jdp.DPParams().tuple()
SHARDS = [1, 2, 8]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain row loop is thousands of small tensor ops: intra-op threads
    gain nothing there and thrash when several test workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual host devices of tests/conftest.py")
    return jmesh.make_mesh(8, loci_parallel=1)


def test_make_mesh_axes():
    mesh = tmesh.make_mesh(8, loci_parallel=2, device="cpu")
    assert mesh.axis_names == (tmesh.READS_AXIS, tmesh.LOCI_AXIS) \
        == (jmesh.READS_AXIS, jmesh.LOCI_AXIS)
    assert mesh.shape == {"reads": 4, "loci": 2} and mesh.size == 8
    assert all(d.type == "cpu" for d in mesh.flat_devices())
    assert len(mesh.axis_devices("reads")) == 4
    assert len(mesh.axis_devices("loci")) == 2
    with pytest.raises(ValueError, match="divisible"):
        tmesh.make_mesh(6, loci_parallel=4, device="cpu")


def test_mesh_is_a_cache_key():
    a = tmesh.make_mesh(4, device="cpu")
    b = tmesh.make_mesh(4, device="cpu")
    c = tmesh.make_mesh(2, device="cpu")
    assert a == b and hash(a) == hash(b) and a != c
    assert texec.sharded_dp_runner(a) is texec.sharded_dp_runner(b)
    assert texec.sharded_dp_runner(a) is not texec.sharded_dp_runner(c)


def test_make_mesh_refuses_more_cards_than_there_are(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="requested 4 devices, have 2"):
        tmesh.make_mesh(4, device="cuda")
    mesh = tmesh.make_mesh(2, device="cuda")
    assert [str(d) for d in mesh.flat_devices()] == ["cuda:0", "cuda:1"]


def test_init_distributed_is_not_ported(monkeypatch):
    """A single process stays a no-op, with no process group; NCCL is taken
    only where every rank has a card of its own: asked for without a card,
    or with more ranks than cards, it raises before any group is made; no
    backend but gloo and NCCL is taken.  (The name predates the NCCL path:
    the test now holds where NCCL is refused.)"""
    tmesh.init_distributed()
    tmesh.init_distributed("localhost:1", 1, 0)
    assert not torch.distributed.is_initialized()
    assert (tmesh.process_index(), tmesh.process_count()) == (0, 1)
    assert tmesh.process_mesh("cpu").shape == {"reads": 1, "loci": 1}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="nccl.*none"):
        tmesh.init_distributed("localhost:1", 2, 0, backend="nccl")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 ranks, 1 cards"):
        tmesh.init_distributed("localhost:1", 2, 0, backend="nccl")
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="gloo"):
        tmesh.init_distributed("localhost:1", 2, 0, backend="mpi")


_GROUP_WORKER = """
import sys, datetime
import torch
from telr_tpu_torch.dist import mesh
from telr_tpu_torch.dist.runner import _allgather_obj
from telr_tpu_torch.utils.device import resolve
n, r, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
mesh.init_distributed(f"localhost:{port}", n, r,
                      timeout=datetime.timedelta(seconds=60))
assert (mesh.process_index(), mesh.process_count()) == (r, n)
assert _allgather_obj({"rank": r}) == [{"rank": k} for k in range(n)]
pm = mesh.process_mesh("cpu")
assert pm.shape == {"reads": n, "loci": 1}
assert resolve("cpu").type == "cpu"
torch.cuda.is_available = lambda: True
torch.cuda.device_count = lambda: 1
assert str(resolve(None)) == "cuda:0" and str(resolve("cuda")) == "cuda:0"
torch.cuda.device_count = lambda: 4
assert str(resolve(None)) == f"cuda:{r}"
assert [str(d) for d in mesh.process_mesh().flat_devices()] == [
    f"cuda:{k}" for k in range(n)]
"""


def test_init_distributed_two_process_group():
    """Two ranks over gloo: ranks, the object all-gather, the group's mesh,
    and each rank's card (rank % cards)."""
    import sys

    from telr_tpu_torch.tools.two_process_pipeline import (free_port,
                                                           run_ranks)
    port = str(free_port())
    run_ranks([[sys.executable, "-c", _GROUP_WORKER, "2", str(r), port]
               for r in range(2)], timeout_s=120)


def test_pad_to_multiple_equals_jax():
    a = np.arange(10, dtype=np.int32).reshape(5, 2)
    for mult in (1, 2, 4, 5):
        assert np.array_equal(tmesh.pad_to_multiple(a, mult, fill=4),
                              jmesh.pad_to_multiple(a, mult, fill=4))


def _align_batch():
    rng = np.random.default_rng(0)
    B, LQ, LT, W = 16, 128, 256, 128
    q = rng.integers(0, 4, size=(B, LQ)).astype(np.int8)
    t = rng.integers(0, 4, size=(LT,)).astype(np.int8)
    q[:, :100] = t[None, 20:120]          # related, so scores are not trivial
    off = np.broadcast_to(jdp.make_band_offsets(LQ, LT, W),
                          (B, LQ + 1)).copy()
    qlen = rng.integers(60, LQ + 1, size=B).astype(np.int32)
    tlen = np.asarray(LT, np.int32)
    return (q, t, off, qlen, tlen), W


@pytest.mark.parametrize("mode", [jdp.GLOBAL, jdp.EXTEND, jdp.LOCAL])
@pytest.mark.parametrize("n", SHARDS)
def test_sharded_align_step_equals_jax(jax_mesh, n, mode):
    args, W = _align_batch()
    want = jpipe.make_sharded_align_step(jax_mesh, width=W, mode=mode,
                                         params_tuple=PARAMS)(*args)
    got = tpipe.make_sharded_align_step(
        tmesh.make_mesh(n, device="cpu"), width=W, mode=mode,
        params_tuple=PARAMS)(*args)
    for w, g in zip(want, got):
        assert g.dtype == np.int32
        assert np.array_equal(np.asarray(w), g)


@pytest.mark.parametrize("n,loci", [(1, 1), (2, 2), (8, 2), (8, 8)])
def test_locus_score_step_equals_jax(n, loci):
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual host devices of tests/conftest.py")
    rng = np.random.default_rng(1)
    L, R, Lq, Lt, W = 8, 4, 64, 128, 128
    contigs = rng.integers(0, 4, size=(L, Lt)).astype(np.int8)
    reads = rng.integers(0, 4, size=(L, R, Lq)).astype(np.int8)
    reads[:, :, :48] = contigs[:, None, 10:58]
    off = np.broadcast_to(jdp.make_band_offsets(Lq, Lt, W),
                          (L, R, Lq + 1)).copy()
    qlen = rng.integers(30, Lq + 1, size=(L, R)).astype(np.int32)
    tlen = rng.integers(100, Lt + 1, size=(L,)).astype(np.int32)
    args = (reads, contigs, off, qlen, tlen)
    want = jpipe.make_locus_score_step(
        jmesh.make_mesh(8, loci_parallel=2), width=W,
        params_tuple=PARAMS)(*args)
    mesh = tmesh.make_mesh(n, loci_parallel=loci, device="cpu")
    got = tpipe.make_locus_score_step(mesh, width=W,
                                      params_tuple=PARAMS)(*args)
    assert tpipe.make_locus_depth_step is tpipe.make_locus_score_step
    for w, g in zip(want, got):
        assert g.shape == (L, R)
        assert np.array_equal(np.asarray(w), g)


def test_steps_refuse_batches_that_do_not_divide():
    args, W = _align_batch()
    step = tpipe.make_sharded_align_step(
        tmesh.make_mesh(3, device="cpu"), width=W, mode=jdp.GLOBAL,
        params_tuple=PARAMS)
    with pytest.raises(ValueError, match="does not divide"):
        step(*args)


@pytest.mark.parametrize("mode", [jdp.GLOBAL, jdp.EXTEND, jdp.LOCAL])
@pytest.mark.parametrize("n", SHARDS)
def test_sharded_dp_runner_equals_jax(jax_mesh, n, mode):
    """A batch of 11 does not divide by 2 or 8: both runners pad it with
    the same fill rows and trim the results back."""
    (q, t, off, qlen, tlen), W = _align_batch()
    B = 11
    tb = np.broadcast_to(t, (B, len(t))).copy()
    tl = np.full(B, int(tlen), np.int32)
    args = (q[:B], tb, off[:B], qlen[:B], tl)
    kw = dict(width=W, mode=mode, params_tuple=PARAMS)
    want = jexec.sharded_dp_runner(jax_mesh)(*args, **kw)
    got = texec.sharded_dp_runner(tmesh.make_mesh(n, device="cpu"))(
        *args, **kw)
    assert len(got) == 5
    for w, g in zip(want, got):
        assert isinstance(g, np.ndarray) and g.shape[0] == B
        assert g.dtype == w.dtype
        assert np.array_equal(w, g)


def _indel_store(target_mod, aligner_mod, store_mod, config_mod):
    rng = np.random.default_rng(3)
    L = 3000
    ref = rng.integers(0, 4, L).astype(np.int8)
    target = target_mod.SeqDict([target_mod.Sequence("c", ref)])
    aligner = aligner_mod.Aligner(target, config_mod.MAP_PB)
    alns = []
    for i in range(12):
        s = int(rng.integers(0, L - 600))
        codes = ref[s:s + 500].copy()
        # plant indels so CIGARs carry I/D blocks
        codes[100:103] = (codes[100:103] + 1) % 4
        codes = np.concatenate([codes[:250],
                                rng.integers(0, 4, 20).astype(np.int8),
                                codes[250:]])
        alns.extend(aligner.map_seq(f"r{i}", codes))
    return store_mod.AlignmentStore(alns), L


@pytest.mark.parametrize("n", SHARDS)
def test_mesh_coverage_equals_alignstore_and_jax(jax_mesh, n):
    import telr_tpu.config as jcfg
    import telr_tpu.core.alignstore as jstore
    import telr_tpu.io.seqs as jseqs
    import telr_tpu.kernels.mapper as jmapper
    import telr_tpu_torch.config as tcfg
    import telr_tpu_torch.core.alignstore as tstore
    import telr_tpu_torch.io.seqs as tseqs
    import telr_tpu_torch.kernels.mapper as tmapper
    store, L = _indel_store(tseqs, tmapper, tstore, tcfg)
    jstore_, _ = _indel_store(jseqs, jmapper, jstore, jcfg)
    texec.mesh_coverage.device_calls.clear()
    got = texec.mesh_coverage(tmesh.make_mesh(n, device="cpu"), store, "c", L)
    assert got.dtype == np.int32 and got.shape == (L,)
    assert texec.mesh_coverage.device_calls == {"cpu": 1}
    assert np.array_equal(got, store.coverage("c", 0, L))
    assert got.max() > 1
    assert np.array_equal(got, jexec.mesh_coverage(jax_mesh, jstore_, "c", L))
    # a contig with no alignments
    assert not texec.mesh_coverage(tmesh.make_mesh(n, device="cpu"), store,
                                   "other", 50).any()


@pytest.mark.parametrize("n", SHARDS)
def test_depth_psum_step_equals_jax(jax_mesh, n):
    rng = np.random.default_rng(5)
    spans = np.full((16, 4, 2), -1, dtype=np.int32)
    for b in range(16):
        for k in range(int(rng.integers(0, 5))):
            s = int(rng.integers(0, 120))
            spans[b, k] = (s, s + int(rng.integers(1, 40)))   # may pass 128
    want = np.asarray(jexec.make_depth_psum_step(jax_mesh, 128, 4)(spans))
    got = texec.make_depth_psum_step(tmesh.make_mesh(n, device="cpu"),
                                     128, 4)(spans)
    assert got.dtype == torch.int32
    assert np.array_equal(want, got.numpy())


def test_spans_from_store_equals_jax():
    import telr_tpu.config as jcfg
    import telr_tpu.core.alignstore as jstore
    import telr_tpu.io.seqs as jseqs
    import telr_tpu.kernels.mapper as jmapper
    import telr_tpu_torch.config as tcfg
    import telr_tpu_torch.core.alignstore as tstore
    import telr_tpu_torch.io.seqs as tseqs
    import telr_tpu_torch.kernels.mapper as tmapper
    store, _L = _indel_store(tseqs, tmapper, tstore, tcfg)
    jst, _L = _indel_store(jseqs, jmapper, jstore, jcfg)
    for max_blocks in (2, 8):          # 2 folds the tail blocks into one
        assert np.array_equal(
            texec.spans_from_store(store, "c", 4096, max_blocks, 8),
            jexec.spans_from_store(jst, "c", 4096, max_blocks, 8))


@pytest.mark.parametrize("n", SHARDS)
def test_pair_all_to_all_equals_jax_and_host(n):
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual host devices of tests/conftest.py")
    rng = np.random.default_rng(6)
    pairs = [[(int(rng.integers(0, 23)), int(rng.integers(0, 1000)))
              for _ in range(int(rng.integers(0, 6)))] for _src in range(n)]
    sends = tred.pack_sends(pairs, n, capacity=8)
    assert np.array_equal(sends, jred.pack_sends(pairs, n, capacity=8))
    recv = tred.make_redistribute_step(tmesh.make_mesh(n, device="cpu"),
                                       capacity=8)(sends)
    jrecv = np.asarray(jred.make_redistribute_step(
        jmesh.make_mesh(n), capacity=8)(sends))
    assert np.array_equal(recv, jrecv)
    got = tred.unpack_received(recv)
    assert got == jred.unpack_received(jrecv) \
        == tred.redistribute_host(pairs, n) == jred.redistribute_host(pairs, n)
    for dst, lst in enumerate(got):
        assert all(tred.owner_of(li, n) == dst for li, _ri in lst)
    with pytest.raises(ValueError, match="capacity"):
        tred.pack_sends([[(0, k) for k in range(9)]] + [[]] * (n - 1), n,
                        capacity=8)


def _payload_items(n):
    prng = np.random.default_rng(2)
    # ranks are unique, as the pipeline's (locus, rank, kind) keys are
    return [[(int(prng.integers(0, 11)), 5 * src + k,
              int(prng.integers(0, 2)),
              prng.integers(0, 4, size=int(prng.integers(40, 200))).astype(
                  np.int8)) for k in range(5)] for src in range(n)]


@pytest.mark.parametrize("max_bytes", [1 << 20, 1 << 12])
@pytest.mark.parametrize("n", SHARDS)
def test_redistribute_payloads_equals_jax(n, max_bytes):
    """Item for item against the JAX collective and against the owner rule;
    the small max_bytes forces several rounds."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual host devices of tests/conftest.py")
    items = _payload_items(n)
    got = tred.redistribute_payloads(tmesh.make_mesh(n, device="cpu"), items,
                                     max_bytes=max_bytes)
    ref = jred.redistribute_payloads(jmesh.make_mesh(n), items,
                                     max_bytes=max_bytes)
    want = [[] for _ in range(n)]
    for src_items in items:
        for it in src_items:
            want[tred.owner_of(it[0], n)].append(it)
    for lst in want:
        lst.sort(key=lambda x: (x[0], x[2], x[1]))
    assert len(got) == n
    for dst in range(n):
        assert len(got[dst]) == len(want[dst]) == len(ref[dst])
        for g, w, r in zip(got[dst], want[dst], ref[dst]):
            assert g[:3] == w[:3] == r[:3]
            assert g[3].dtype == np.int8
            assert np.array_equal(g[3], w[3]) and np.array_equal(g[3], r[3])


def test_payload_wire_equals_jax():
    n = 4
    items = _payload_items(n)
    hdr, codes = tred.pack_payload_sends(items, n, capacity=8, l_pad=256)
    jh, jc = jred.pack_payload_sends(items, n, capacity=8, l_pad=256)
    assert tred.HDR_COLS == jred.HDR_COLS
    assert np.array_equal(hdr, jh) and np.array_equal(codes, jc)
    rh, rc = tred.make_payload_redistribute_step(
        tmesh.make_mesh(n, device="cpu"), 8, 256)(hdr, codes)
    assert np.array_equal(rh, hdr.swapaxes(0, 1))
    assert np.array_equal(rc, codes.swapaxes(0, 1))
    got = tred.unpack_payload_received(rh, rc)
    want = jred.unpack_payload_received(rh, rc)
    for g_lst, w_lst in zip(got, want):
        assert [g[:3] for g in g_lst] == [w[:3] for w in w_lst]
        assert all(np.array_equal(g[3], w[3])
                   for g, w in zip(g_lst, w_lst))
    with pytest.raises(ValueError, match="l_pad"):
        tred.pack_payload_sends(items, n, capacity=8, l_pad=32)
