"""The port's process-group backend (telr_tpu_torch/dist/mesh.py): NCCL where
every rank of the host has a card of its own, gloo on the CPU and where
ranks share a card, an explicit NCCL refused without a card for every rank;
and the `_mp` collectives through the collective-device code path (host
tensors under gloo here) at 2 and 4 processes, against the JAX package's
redistribute_payloads on its host mesh.  Card counts are patched in
fixtures; every comparison is exact."""

import pickle
import sys

import numpy as np
import pytest
import torch

import jax

from telr_tpu.dist import mesh as jmesh
from telr_tpu.dist import redistribute as jred
from telr_tpu_torch.dist import mesh as tmesh
from telr_tpu_torch.kernels import cuda_lib
from telr_tpu_torch.tools import exchange_bench
from telr_tpu_torch.tools import two_process_pipeline as tpp


@pytest.fixture
def cards(monkeypatch):
    """set_cards(n): torch sees n CUDA cards (none for 0)."""
    def set_cards(n):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: n > 0)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
    return set_cards


@pytest.fixture
def group_calls(monkeypatch):
    """Record init_process_group and set_device instead of running them."""
    calls = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda *a, **k: calls.append(("init", a, k)))
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: calls.append(("set_device", d)))
    return calls


@pytest.mark.parametrize("n_cards,ranks,device,want", [
    (1, 2, None, "gloo"),      # two ranks would share the one card
    (4, 4, None, "nccl"),      # a card each
    (4, 2, None, "nccl"),
    (4, 4, "cuda", "nccl"),
    (2, 4, None, "gloo"),      # more ranks than cards
    (4, 4, "cpu", "gloo"),     # --device cpu
    (0, 2, None, "gloo"),      # no card: the CPU
])
def test_backend_follows_the_topology(cards, n_cards, ranks, device, want):
    cards(n_cards)
    assert tmesh.pick_backend(ranks, device) == want
    # an explicit backend wins where it can run
    assert tmesh.pick_backend(ranks, device, "gloo") == "gloo"


@pytest.mark.parametrize("n_cards,ranks,device", [
    (0, 2, None), (0, 1, None), (2, 4, None), (4, 4, "cpu")])
def test_nccl_without_a_card_for_every_rank_raises(cards, group_calls,
                                                   n_cards, ranks, device):
    cards(n_cards)
    with pytest.raises(RuntimeError, match="nccl"):
        tmesh.pick_backend(ranks, device, "nccl")
    with pytest.raises(RuntimeError, match="nccl"):
        tmesh.init_distributed("localhost:1", ranks, 0, backend="nccl",
                               device=device)
    assert group_calls == []


def test_a_cuda_device_without_a_card_raises(cards):
    cards(0)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tmesh.pick_backend(2, "cuda")


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="gloo or nccl"):
        tmesh.pick_backend(2, "cpu", "mpi")


def test_nccl_rank_sets_its_card_first(cards, group_calls):
    """Under NCCL a rank takes card rank % cards as its current device
    before it joins, and binds the group to it."""
    cards(4)
    tmesh.init_distributed("localhost:7", 4, 3)
    assert [c[0] for c in group_calls] == ["set_device", "init"]
    assert group_calls[0][1] == torch.device("cuda", 3)
    _tag, args, kwargs = group_calls[1]
    assert args == ("nccl",)
    assert kwargs["device_id"] == torch.device("cuda", 3)
    assert (kwargs["world_size"], kwargs["rank"]) == (4, 3)
    assert kwargs["init_method"] == "tcp://localhost:7"


def test_gloo_rank_leaves_the_card_alone(cards, group_calls):
    """Two ranks on one card join over gloo: no current device is set and
    the group is bound to none."""
    cards(1)
    tmesh.init_distributed("localhost:7", 2, 1)
    assert [c[0] for c in group_calls] == ["init"]
    _tag, args, kwargs = group_calls[0]
    assert args == ("gloo",) and "device_id" not in kwargs


def test_single_process_joins_no_group(cards, group_calls):
    cards(4)
    tmesh.init_distributed()
    tmesh.init_distributed("localhost:1", 1, 0, device="cpu")
    assert group_calls == []
    assert tmesh.collective_device() == torch.device("cpu")


def test_collective_device_follows_the_backend(monkeypatch):
    monkeypatch.setattr(tmesh, "_group_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)
    monkeypatch.setattr(torch.distributed, "get_backend", lambda: "nccl")
    assert tmesh.collective_device() == torch.device("cuda", 2)
    monkeypatch.setattr(torch.distributed, "get_backend", lambda: "gloo")
    assert tmesh.collective_device() == torch.device("cpu")


def test_launches_are_counted_by_card():
    """cuda_lib.count_launch adds one to a wrapper's launches and to its
    card's; the tools read and reset both."""
    from telr_tpu_torch.kernels import hopper_dp
    from telr_tpu_torch.tools import bench_pipeline

    def wrapper():
        pass
    wrapper.launches, wrapper.cards = 0, {}
    for k in (2, 0, 2):
        cuda_lib.count_launch(wrapper, torch.device("cuda", k))
    assert wrapper.launches == 3 and wrapper.cards == {0: 1, 2: 2}
    hopper_dp.rowband_walk.cards[1] = 5
    assert bench_pipeline.kernel_launches_by_card()["rowband_walk"][1] == 5
    bench_pipeline.reset_launches()
    assert bench_pipeline.kernel_launches_by_card() == {
        "wavefront_dp": {}, "wavefront_walk": {}, "rowband_dp": {},
        "rowband_walk": {}}


# ------------------------------------------------------------ collectives

MAX_BYTES, CHUNK = 4096, 100

_WORKER = """
import datetime, pickle, sys
import torch
import torch.distributed as dist
from telr_tpu_torch.dist import mesh, redistribute as red
from telr_tpu_torch.dist.runner import _allgather_obj
n, r, port, case_path, out_path = sys.argv[1:6]
n, r = int(n), int(r)
mesh.init_distributed(f"localhost:{port}", n, r,
                      timeout=datetime.timedelta(seconds=90))
assert dist.get_backend() == "gloo"
# every tensor handed to a collective, by the collective
seen = {"all_to_all_single": [], "all_gather": []}
for name in seen:
    def spy(*a, _f=getattr(dist, name), _name=name, **k):
        tensors = [a[0], a[1]] if _name == "all_to_all_single" else \\
            list(a[0]) + [a[1]]
        seen[_name].extend(str(t.device) for t in tensors)
        return _f(*a, **k)
    setattr(dist, name, spy)
with open(case_path, "rb") as f:
    case = pickle.load(f)
pm = mesh.process_mesh("cpu")
red._exchange_row.bytes = 0
got = red.redistribute_payloads_mp(pm, case["items"][r],
                                   max_bytes=case["max_bytes"])
blobs = red.exchange_bytes_mp(pm, case["blobs"][r], chunk=case["chunk"],
                              max_bytes=case["max_bytes"])
objs = _allgather_obj({"rank": r, "codes": case["items"][r][:2]})
with open(out_path, "wb") as f:
    pickle.dump({"got": got, "blobs": blobs, "objs": objs, "seen": seen,
                 "collective_device": str(mesh.collective_device()),
                 "wire_bytes": red._exchange_row.bytes}, f)
"""


def _case(n, seed=11):
    """Seeded items with unique (locus, kind, rank) keys over n source
    processes, and a seeded blob for every (src, dst)."""
    rng = np.random.default_rng(seed + n)
    keys = {(int(rng.integers(0, 40)), int(rng.integers(0, 2)),
             int(rng.integers(0, 12))) for _ in range(160)}
    items = [[] for _ in range(n)]
    for li, kind, rank in sorted(keys):
        codes = rng.integers(-1, 4, size=int(rng.integers(0, 300))
                             ).astype(np.int8)
        items[int(rng.integers(n))].append((li, rank, kind, codes))
    blobs = [[rng.integers(0, 256, size=int(rng.integers(0, 1000)),
                           dtype=np.uint8).tobytes() for _d in range(n)]
             for _s in range(n)]
    return items, blobs


@pytest.mark.parametrize("n", [2, 4])
def test_collectives_on_the_collective_device_equal_jax(n, tmp_path):
    """redistribute_payloads_mp, exchange_bytes_mp and the runner's object
    all-gather at n gloo processes: every tensor handed to a collective
    lies on the collective device (the host under gloo), several rounds and
    chunks go over the wire, and each rank receives exactly what the JAX
    package's redistribute_payloads gives its shard on an n-device host
    mesh, every blob and every rank's object."""
    if len(jax.devices()) < n:
        pytest.skip("needs the 8 virtual host devices of tests/conftest.py")
    items, blobs = _case(n)
    want = jred.redistribute_payloads(jmesh.make_mesh(n), items,
                                      max_bytes=MAX_BYTES)
    case = tmp_path / "case.pkl"
    with open(case, "wb") as f:
        pickle.dump({"items": items, "blobs": blobs, "max_bytes": MAX_BYTES,
                     "chunk": CHUNK}, f)
    port = str(tpp.free_port())
    outs = [tmp_path / f"rank{r}.pkl" for r in range(n)]
    tpp.run_ranks([[sys.executable, "-c", _WORKER, str(n), str(r), port,
                    str(case), str(outs[r])] for r in range(n)],
                  timeout_s=180)
    for r, out in enumerate(outs):
        with open(out, "rb") as f:
            res = pickle.load(f)
        assert res["collective_device"] == "cpu"
        assert res["seen"]["all_to_all_single"] and res["seen"]["all_gather"]
        assert {d for v in res["seen"].values() for d in v} == {"cpu"}
        assert res["wire_bytes"] > 0
        assert len(res["got"]) == len(want[r])
        for g, w in zip(res["got"], want[r]):
            assert g[:3] == w[:3] and g[3].dtype == np.int8
            assert np.array_equal(g[3], w[3])
        assert res["blobs"] == [blobs[s][r] for s in range(n)]
        assert [o["rank"] for o in res["objs"]] == list(range(n))
        for o in res["objs"]:
            for g, w in zip(o["codes"], items[o["rank"]][:2]):
                assert g[:3] == w[:3] and np.array_equal(g[3], w[3])


def test_exchange_bench_checks_and_digests(tmp_path):
    """tools/exchange_bench.py at 2 gloo processes on the CPU: each rank's
    received items pass its owner-rule check, and a rerun on the same seed
    gives the same digests."""
    argv = ["--procs", "2", "--backend", "gloo", "--device", "cpu", "--mb",
            "0.5", "--blob-mb", "0.1", "--reps", "1", "--workdir",
            str(tmp_path)]
    a = exchange_bench.main(argv)
    b = exchange_bench.main(argv)
    assert a["digests_agree"] and a["gloo"]["digests"] == b["gloo"]["digests"]
    rec = a["gloo"]
    assert [r["backend"] for r in rec["ranks"]] == ["gloo", "gloo"]
    assert rec["payload_bytes"] >= 500_000
    assert rec["payloads_wire_bytes"] >= rec["payload_bytes"]
    assert sum(r["received_items"] for r in rec["ranks"]) \
        == sum(r["items"] for r in rec["ranks"])
