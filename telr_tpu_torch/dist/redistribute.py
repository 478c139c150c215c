"""Locus redistribution: the pipeline's all-to-all.

After data-parallel SV detection, candidate loci are discovered on the shards
that hold their supporting reads; batched per-locus work (assembly, AF
realignment) wants each locus' reads co-located.  This module implements the
ragged all-to-all (SURVEY.md §2c): every (locus, read) pair is routed to the
locus' owner shard `locus_id % n_shards`, with bounded padding.

Device path: fixed-capacity send buffers per (src, dst) shard pair.  Within
one process the all-to-all over the "reads" axis is an exchange of the
(src, dst) blocks between the shards' tensors: shard `dst` gathers block
[src, dst] from every source shard's device (device-to-device copies where
the shards sit on different cards).  A numpy reference implementation
provides the test oracle.

Across processes (redistribute_payloads_mp, exchange_bytes_mp) each rank
packs only its own send row and one torch.distributed all_to_all_single per
array and round moves the (src, dst) blocks: on the rank's card under NCCL,
on host tensors under gloo (dist.mesh.collective_device).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from telr_tpu_torch.dist.mesh import (READS_AXIS, Mesh, collective_device,
                                      process_count, process_index)


def owner_of(locus_id: int, n_shards: int) -> int:
    return locus_id % n_shards


def redistribute_host(
    pairs_per_shard: Sequence[Sequence[Tuple[int, int]]],
    n_shards: int,
) -> List[List[Tuple[int, int]]]:
    """Reference: route (locus_id, read_id) pairs to owner shards."""
    out: List[List[Tuple[int, int]]] = [[] for _ in range(n_shards)]
    for shard_pairs in pairs_per_shard:
        for locus_id, read_id in shard_pairs:
            out[owner_of(locus_id, n_shards)].append((locus_id, read_id))
    for lst in out:
        lst.sort()
    return out


def _all_to_all(mesh: Mesh, *arrays):
    """Exchange (S, S, ...) send buffers over the "reads" axis: row src of
    each array is placed on shard src's device, then shard dst stacks block
    [src, dst] of every source on its own device.  Returns, per array, the
    list of the S received rows ((S, ...) tensors, row dst on shard dst's
    device), where [dst][src] holds what dst received from src."""
    import torch
    devices = mesh.axis_devices(READS_AXIS)
    n = len(devices)
    out = []
    for a in arrays:
        a = np.ascontiguousarray(a)
        if a.shape[0] != n or a.shape[1] != n:
            raise ValueError(f"send buffers must lead with ({n}, {n}), got "
                             f"{a.shape}")
        sends = [torch.from_numpy(a[src]).to(devices[src])
                 for src in range(n)]
        out.append([torch.stack([sends[src][dst].to(devices[dst])
                                 for src in range(n)])
                    for dst in range(n)])
    return out


def _to_host(rows) -> np.ndarray:
    """The received rows of one array gathered into one (S, S, ...) numpy
    array."""
    return np.stack([r.cpu().numpy() for r in rows])


def make_redistribute_step(mesh: Mesh, capacity: int):
    """Build the all-to-all step over the "reads" axis.

    Input: pairs (S, S, capacity, 2) int32 where pairs[src, dst] holds the
    (locus_id, read_id) rows shard `src` sends to shard `dst`, padded with
    -1.  Row src lives on shard src.
    Output: same shape (numpy), where row [dst, src] holds what `dst`
    RECEIVED from `src`.
    """
    def step(pairs):
        if pairs.shape[2:] != (capacity, 2):
            raise ValueError(f"expected (S, S, {capacity}, 2) send buffers")
        (recv,) = _all_to_all(mesh, pairs)
        return _to_host(recv)

    return step


def pack_sends(pairs_per_shard: Sequence[Sequence[Tuple[int, int]]],
               n_shards: int, capacity: int) -> np.ndarray:
    """Host packing: (S, S, capacity, 2) send buffers padded with -1.
    Raises if any (src, dst) route exceeds capacity (callers size capacity
    from the max per-route count, or chunk the sends)."""
    out = np.full((n_shards, n_shards, capacity, 2), -1, dtype=np.int32)
    for src, shard_pairs in enumerate(pairs_per_shard):
        counts = np.zeros(n_shards, dtype=np.int64)
        for locus_id, read_id in shard_pairs:
            dst = owner_of(locus_id, n_shards)
            c = counts[dst]
            if c >= capacity:
                raise ValueError(
                    f"route {src}->{dst} exceeds capacity {capacity}")
            out[src, dst, c] = (locus_id, read_id)
            counts[dst] += 1
    return out


def unpack_received(received: np.ndarray) -> List[List[Tuple[int, int]]]:
    """(S, S, cap, 2) received buffers -> per-shard sorted pair lists."""
    n = received.shape[0]
    out: List[List[Tuple[int, int]]] = []
    for dst in range(n):
        rows = received[dst].reshape(-1, 2)
        rows = rows[rows[:, 0] >= 0]
        out.append(sorted(map(tuple, rows.tolist())))
    return out


# ----------------------------------------------------------------------
# payload-carrying all-to-all: the read SEQUENCES move with the routing
# pairs, so a locus' owner shard can assemble from what it RECEIVED —
# reads resident only on their source shard never need to exist on the
# owner beforehand (replaces TELR_assembly.py:418-456 csplit per-locus
# read files; SURVEY §2c "all-to-all redistribution of (locus, read)
# pairs" with payloads).

HDR_COLS = 4  # [locus_id, rank, length, kind]


def make_payload_redistribute_step(mesh: Mesh, capacity: int, l_pad: int):
    """All-to-all over the "reads" axis moving header + codes.

    Inputs (row src on shard src):
      hdr   (S, S, capacity, HDR_COLS) int32, -1 padded
      codes (S, S, capacity, l_pad)    int8 read codes, -1 padded
    Outputs: same shapes (numpy), [dst, src] = what dst received from src.
    """
    def step(hdr, codes):
        if hdr.shape[2:] != (capacity, HDR_COLS) \
                or codes.shape[2:] != (capacity, l_pad):
            raise ValueError("send buffers do not match the step's "
                             f"capacity {capacity} / l_pad {l_pad}")
        rh, rc = _all_to_all(mesh, hdr, codes)
        return _to_host(rh), _to_host(rc)

    return step


def pack_payload_sends(
    items_per_shard: Sequence[Sequence[Tuple[int, int, int, np.ndarray]]],
    n_shards: int, capacity: int, l_pad: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Host packing of (locus_id, rank, kind, codes) items into send
    buffers.  Raises if a route exceeds capacity (callers chunk)."""
    hdr = np.full((n_shards, n_shards, capacity, HDR_COLS), -1,
                  dtype=np.int32)
    codes = np.full((n_shards, n_shards, capacity, l_pad), -1,
                    dtype=np.int8)
    for src, items in enumerate(items_per_shard):
        counts = np.zeros(n_shards, dtype=np.int64)
        for locus_id, rank, kind, rc in items:
            if len(rc) > l_pad:
                raise ValueError(f"read length {len(rc)} exceeds l_pad "
                                 f"{l_pad}")
            dst = owner_of(locus_id, n_shards)
            c = counts[dst]
            if c >= capacity:
                raise ValueError(
                    f"route {src}->{dst} exceeds capacity {capacity}")
            hdr[src, dst, c] = (locus_id, rank, len(rc), kind)
            codes[src, dst, c, :len(rc)] = rc
            counts[dst] += 1
    return hdr, codes


def unpack_payload_received(
    hdr: np.ndarray, codes: np.ndarray,
) -> List[List[Tuple[int, int, int, np.ndarray]]]:
    """Received buffers -> per-dst lists of (locus_id, rank, kind, codes),
    sorted by (locus_id, kind, rank)."""
    n = hdr.shape[0]
    out: List[List[Tuple[int, int, int, np.ndarray]]] = []
    for dst in range(n):
        h = hdr[dst].reshape(-1, HDR_COLS)
        c = codes[dst].reshape(-1, codes.shape[-1])
        keep = h[:, 0] >= 0
        items = [(int(hh[0]), int(hh[1]), int(hh[3]),
                  cc[:hh[2]].copy())
                 for hh, cc in zip(h[keep], c[keep])]
        items.sort(key=lambda x: (x[0], x[2], x[1]))
        out.append(items)
    return out


def _pack_local_row(
    items: Sequence[Tuple[int, int, int, np.ndarray]],
    n_shards: int, capacity: int, l_pad: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """One source shard's send row: (1, S, cap, HDR) + (1, S, cap, l_pad)."""
    hdr = np.full((1, n_shards, capacity, HDR_COLS), -1, dtype=np.int32)
    codes = np.full((1, n_shards, capacity, l_pad), -1, dtype=np.int8)
    counts = np.zeros(n_shards, dtype=np.int64)
    for locus_id, rank, kind, rc in items:
        dst = owner_of(locus_id, n_shards)
        c = counts[dst]
        if c >= capacity:
            raise ValueError(f"route ->{dst} exceeds capacity {capacity}")
        hdr[0, dst, c] = (locus_id, rank, len(rc), kind)
        codes[0, dst, c, :len(rc)] = rc
        counts[dst] += 1
    return hdr, codes


def _exchange_row(row: np.ndarray) -> np.ndarray:
    """All-to-all of this process' (1, S, ...) send row over the process
    group, on the collective device: returns (1, S, ...) where [0, src] is
    what src sent here."""
    import torch
    import torch.distributed as dist
    send = torch.from_numpy(np.ascontiguousarray(row[0])).to(
        collective_device())
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send)
    _exchange_row.bytes += send.numel() * send.element_size()
    return recv.cpu().numpy()[None]


# the bytes this process' send rows have put on the wire (a measure for
# tools/exchange_bench.py; set it to 0 before what it measures)
_exchange_row.bytes = 0


def redistribute_payloads_mp(
    mesh: Mesh,
    local_items: Sequence[Tuple[int, int, int, np.ndarray]],
    max_bytes: int = 256 << 20,
) -> List[Tuple[int, int, int, np.ndarray]]:
    """Multi-process payload all-to-all: THIS process contributes the send
    row for its own source shard and receives only the items whose loci it
    owns.  Buffer geometry (l_pad, capacity, round count) is agreed across
    processes with a scalar all-gather; rounds bound resident bytes.

    `mesh` is the group's dist.mesh.process_mesh (one shard a process).
    Works identically in a single process (mesh of 1), where it degrades
    to a self-route that touches no collective."""
    n = int(mesh.shape[READS_AXIS])
    n_procs = process_count()
    pid = process_index()
    if n != n_procs:
        raise ValueError(f"the mesh has {n} shards along {READS_AXIS!r}, the "
                         f"process group {n_procs} ranks: pass "
                         "dist.mesh.process_mesh()")

    longest = max((len(it[3]) for it in local_items), default=1)
    route_counts: Dict[int, int] = {}
    for it in local_items:
        d = owner_of(it[0], n)
        route_counts[d] = route_counts.get(d, 0) + 1
    local_max = np.array([longest, max(route_counts.values(), default=0)],
                         dtype=np.int64)
    if n_procs > 1:
        import torch
        import torch.distributed as dist
        dev = collective_device()
        parts = [torch.zeros(2, dtype=torch.int64, device=dev)
                 for _ in range(n_procs)]
        dist.all_gather(parts, torch.from_numpy(local_max).to(dev))
        gmax = torch.stack(parts).cpu().numpy().max(axis=0)
    else:
        gmax = local_max
    l_pad = 1 << max(7, (int(gmax[0]) - 1).bit_length())
    cap_budget = max(1, max_bytes // (n * l_pad))
    cap = min(cap_budget, max(1, int(gmax[1])))
    cap = 1 << (cap - 1).bit_length()
    n_rounds = -(-max(1, int(gmax[1])) // cap)

    rounds: List[List] = [[] for _ in range(n_rounds)]
    counts = {}
    for it in local_items:
        d = owner_of(it[0], n)
        c = counts.get(d, 0)
        counts[d] = c + 1
        rounds[c // cap].append(it)

    got: List[Tuple[int, int, int, np.ndarray]] = []
    for rnd in rounds:
        h, c = _pack_local_row(rnd, n, cap, l_pad)
        if n_procs > 1:
            h, c = _exchange_row(h), _exchange_row(c)
        hrow = h.reshape(-1, HDR_COLS)
        crow = c.reshape(-1, c.shape[-1])
        keep = hrow[:, 0] >= 0
        got.extend((int(hh[0]), int(hh[1]), int(hh[3]), cc[:hh[2]].copy())
                   for hh, cc in zip(hrow[keep], crow[keep]))
    got.sort(key=lambda x: (x[0], x[2], x[1]))
    for li, _rank, _kind, _c in got:
        if owner_of(li, n) != pid:
            raise RuntimeError(f"received locus {li} not owned by shard "
                               f"{pid}")
    return got


def exchange_bytes_mp(
    mesh: Mesh,
    per_dst: Sequence[bytes],
    chunk: int = 4 << 20,
    max_bytes: int = 256 << 20,
) -> List[bytes]:
    """Generic multi-process byte all-to-all over the process group.

    per_dst[d] = the blob THIS process sends to process d (len == P).
    Returns the list of blobs this process received, indexed by source.
    Implemented on redistribute_payloads_mp by encoding the destination as
    the routed key (owner_of(d, P) == d), the chunk sequence number as the
    rank and the source pid as the kind; the chunked rounds bound resident
    bytes exactly like the read-payload path."""
    n = int(mesh.shape[READS_AXIS])
    pid = process_index()
    items: List[Tuple[int, int, int, np.ndarray]] = []
    for d, blob in enumerate(per_dst):
        arr = np.frombuffer(blob, dtype=np.uint8).view(np.int8)
        if len(arr) == 0:
            items.append((d, 0, pid, arr))
            continue
        for seq, off in enumerate(range(0, len(arr), chunk)):
            items.append((d, seq, pid, arr[off:off + chunk]))
    got = redistribute_payloads_mp(mesh, items, max_bytes=max_bytes)
    # got is sorted by (dst=pid, src, seq) — reassemble per source
    parts: Dict[int, List[np.ndarray]] = {}
    for _d, _seq, src, codes in got:
        parts.setdefault(src, []).append(codes)
    return [b"".join(c.view(np.uint8).tobytes() for c in parts.get(s, []))
            for s in range(n)]


def redistribute_payloads(
    mesh: Mesh,
    items_per_shard: Sequence[Sequence[Tuple[int, int, int, np.ndarray]]],
    max_bytes: int = 256 << 20,
) -> List[List[Tuple[int, int, int, np.ndarray]]]:
    """Route (locus_id, rank, kind, read_codes) items to each locus'
    owner shard through the device all-to-all, chunking rounds so the
    send buffers stay under max_bytes."""
    n = int(mesh.shape[READS_AXIS])
    longest = max((len(it[3]) for items in items_per_shard
                   for it in items), default=1)
    l_pad = 1 << max(7, (int(longest) - 1).bit_length())
    cap_budget = max(1, max_bytes // (n * n * l_pad))

    # split each shard's items into rounds so every (src, dst) route fits
    rounds: List[List[List[Tuple[int, int, int, np.ndarray]]]] = []
    counts = [dict() for _ in range(len(items_per_shard))]
    placed: List[List[Tuple[int, List]]] = []  # (round, item) flat order
    for src, items in enumerate(items_per_shard):
        for it in items:
            dst = owner_of(it[0], n)
            c = counts[src].get(dst, 0)
            counts[src][dst] = c + 1
            rnd = c // cap_budget
            while len(rounds) <= rnd:
                rounds.append([[] for _ in range(n)])
            rounds[rnd][src].append(it)

    max_route = max((c for d in counts for c in d.values()), default=1)
    cap = min(cap_budget, max_route)
    cap = 1 << (cap - 1).bit_length()
    step = make_payload_redistribute_step(mesh, cap, l_pad)

    merged: List[List[Tuple[int, int, int, np.ndarray]]] = [
        [] for _ in range(n)]
    for rnd in rounds:
        hdr, codes = pack_payload_sends(rnd, n, cap, l_pad)
        rh, rc = step(hdr, codes)
        for dst, items in enumerate(
                unpack_payload_received(rh, rc)):
            merged[dst].extend(items)
    for lst in merged:
        lst.sort(key=lambda x: (x[0], x[2], x[1]))
    return merged
