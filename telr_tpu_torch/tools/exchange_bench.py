"""The multi-process payload exchange alone, over one backend, timed.

Starts P ranks on localhost (dist/mesh.py::init_distributed, the backend
named by --backend, or both one after the other) and has each run the
runner's two exchanges on seeded inputs:

  * redistribute_payloads_mp: (locus, rank, kind, read codes) items, read
    lengths drawn like PacBio-CLR reads (log-normal around 9 kb, 500 bases
    to 30 kb), --mb megabases of codes over all ranks, each item on a
    random source rank, routed to owner_of(locus);
  * exchange_bytes_mp: a seeded blob from every rank to every rank,
    --blob-mb megabases in all.

Every rank makes every rank's inputs from --seed, so it checks what it
received against the owner rule exactly, and digests it (SHA-256 over the
items in their order and the blobs), so that two backends' runs can be
compared.  Each exchange runs --reps times after a warm-up, the ranks lined
up by a barrier before each; a rep's seconds are the slowest rank's.
Bytes: the read codes a rank routes, and what its send rows put on the wire
(redistribute._exchange_row.bytes: the padded (S, capacity, ...) rows of
every round).

Usage:
    python -m telr_tpu_torch.tools.exchange_bench [--procs 4]
        [--backend nccl|gloo|both] [--device cuda|cpu] [--mb 90]
        [--blob-mb 16] [--reps 3] [--seed 0] [--out JSON]
    python -m telr_tpu_torch.tools.exchange_bench worker NPROCS PID PORT \\
        BACKEND DEVICE MB BLOB_MB REPS SEED OUT TIMEOUT_S

Prints one JSON line last: per backend the ranks' seconds, bytes and
digests, and whether the backends' digests agree.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile
import time

import numpy as np

N_LOCI = 40


def make_items(nprocs: int, mb: float, seed: int):
    """Every rank's items: one list per source rank of (locus, rank, kind,
    codes), with (locus, kind, rank) unique."""
    rng = np.random.default_rng(seed)
    target = int(mb * 1e6)
    lens = []
    total = 0
    while total < target:
        n = int(np.clip(rng.lognormal(np.log(9000), 0.5), 500, 30000))
        lens.append(n)
        total += n
    items = [[] for _ in range(nprocs)]
    codes = rng.integers(0, 4, total, dtype=np.int8)
    loci = rng.integers(0, N_LOCI, len(lens))
    kinds = rng.integers(0, 2, len(lens))
    srcs = rng.integers(0, nprocs, len(lens))
    off = 0
    for g, n in enumerate(lens):
        items[int(srcs[g])].append((int(loci[g]), g, int(kinds[g]),
                                    codes[off:off + n]))
        off += n
    return items


def make_blob(nprocs: int, blob_mb: float, seed: int, src: int, dst: int):
    """The seeded blob rank src sends rank dst."""
    rng = np.random.default_rng([seed, src, dst])
    mean = blob_mb * 1e6 / (nprocs * nprocs)
    n = int(rng.integers(0, max(1, int(2 * mean)) + 1))
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def _digest(got, blobs) -> str:
    h = hashlib.sha256()
    for li, rank, kind, codes in got:
        h.update(np.array([li, rank, kind, len(codes)], np.int64).tobytes())
        h.update(codes.tobytes())
    for b in blobs:
        h.update(len(b).to_bytes(8, "little"))
        h.update(b)
    return h.hexdigest()


def worker(nprocs: int, pid: int, port: int, backend: str, device: str,
           mb: float, blob_mb: float, reps: int, seed: int, out: str,
           timeout_s: float) -> None:
    """One rank: join the group over `backend`, run and time both
    exchanges, check and digest what arrived, write this rank's JSON."""
    import datetime

    import torch
    import torch.distributed as dist

    from telr_tpu_torch.dist import mesh as dmesh
    from telr_tpu_torch.dist import redistribute as red
    dmesh.init_distributed(f"localhost:{port}", nprocs, pid,
                           backend=backend,
                           timeout=datetime.timedelta(seconds=timeout_s),
                           device="cpu" if device == "cpu" else None)
    pm = dmesh.process_mesh("cpu" if device == "cpu" else None)
    items = make_items(nprocs, mb, seed)
    mine = items[pid]
    want = sorted((it for src in items for it in src
                   if red.owner_of(it[0], nprocs) == pid),
                  key=lambda x: (x[0], x[2], x[1]))
    per_dst = [make_blob(nprocs, blob_mb, seed, pid, d)
               for d in range(nprocs)]
    want_blobs = [make_blob(nprocs, blob_mb, seed, s, pid)
                  for s in range(nprocs)]

    def line_up():
        dist.barrier()
        if dmesh.collective_device().type == "cuda":
            torch.cuda.synchronize()

    # warm-up: the backend's connections between every pair of ranks
    red.redistribute_payloads_mp(pm, mine[:8])
    rec = {"rank": pid, "nprocs": nprocs, "backend": dist.get_backend(),
           "collective_device": str(dmesh.collective_device()),
           "payload_bytes": int(sum(len(it[3]) for it in mine)),
           "items": len(mine), "received_items": len(want)}
    for name in ("payloads", "bytes"):
        seconds = []
        for _ in range(reps):
            line_up()
            red._exchange_row.bytes = 0
            t0 = time.perf_counter()
            if name == "payloads":
                got = red.redistribute_payloads_mp(pm, mine)
            else:
                blobs = red.exchange_bytes_mp(pm, per_dst)
            seconds.append(time.perf_counter() - t0)
        rec[name + "_seconds"] = seconds
        rec[name + "_wire_bytes"] = red._exchange_row.bytes
    if len(got) != len(want) or not all(
            g[:3] == w[:3] and np.array_equal(g[3], w[3])
            for g, w in zip(got, want)):
        raise AssertionError(f"rank {pid}: the received items break the "
                             "owner rule")
    if blobs != want_blobs:
        raise AssertionError(f"rank {pid}: a received blob differs")
    rec["blob_bytes"] = int(sum(len(b) for b in per_dst))
    rec["digest"] = _digest(got, blobs)
    with open(out, "w") as f:
        json.dump(rec, f)


def run(procs: int, backend: str, device: str = "cuda", mb: float = 90.0,
        blob_mb: float = 16.0, reps: int = 3, seed: int = 0,
        workdir=None, timeout_s: float = 600.0) -> dict:
    """Both exchanges at `procs` ranks over `backend`; returns each rank's
    record and each rep's slowest-rank seconds."""
    from telr_tpu_torch.tools import two_process_pipeline as tpp
    workdir = workdir or tempfile.mkdtemp(prefix="telr_exchange_")
    os.makedirs(workdir, exist_ok=True)
    port = tpp.free_port()
    outs = [os.path.join(workdir, f"{backend}_rank{r}.json")
            for r in range(procs)]
    t0 = time.perf_counter()
    tpp.run_ranks([[sys.executable, "-m",
                    "telr_tpu_torch.tools.exchange_bench", "worker",
                    str(procs), str(r), str(port), backend, device, str(mb),
                    str(blob_mb), str(reps), str(seed), outs[r],
                    str(max(10.0, timeout_s - 10.0))]
                   for r in range(procs)], timeout_s, env=tpp._env(1))
    ranks = []
    for path in outs:
        with open(path) as f:
            ranks.append(json.load(f))
    return {
        "backend": backend, "procs": procs, "launch_wall_s":
        time.perf_counter() - t0, "ranks": ranks,
        "payloads_seconds": [max(r["payloads_seconds"][k] for r in ranks)
                             for k in range(reps)],
        "bytes_seconds": [max(r["bytes_seconds"][k] for r in ranks)
                          for k in range(reps)],
        "payload_bytes": sum(r["payload_bytes"] for r in ranks),
        "payloads_wire_bytes": sum(r["payloads_wire_bytes"] for r in ranks),
        "blob_bytes": sum(r["blob_bytes"] for r in ranks),
        "bytes_wire_bytes": sum(r["bytes_wire_bytes"] for r in ranks),
        "digests": [r["digest"] for r in ranks]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=4)
    ap.add_argument("--backend", choices=["nccl", "gloo", "both"],
                    default="both")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--mb", type=float, default=90.0,
                    help="megabases of read codes over all ranks")
    ap.add_argument("--blob-mb", type=float, default=16.0)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    backends = ["gloo", "nccl"] if a.backend == "both" else [a.backend]
    result = {b: run(a.procs, b, a.device, a.mb, a.blob_mb, a.reps, a.seed,
                     a.workdir) for b in backends}
    result["digests_agree"] = len({tuple(result[b]["digests"])
                                   for b in backends}) == 1
    if a.out:
        with open(a.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    if not result["digests_agree"]:
        sys.exit("the backends received different items")
    return result


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "worker":
        worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
               sys.argv[5], sys.argv[6], float(sys.argv[7]),
               float(sys.argv[8]), int(sys.argv[9]), int(sys.argv[10]),
               sys.argv[11], float(sys.argv[12]))
    else:
        main()
