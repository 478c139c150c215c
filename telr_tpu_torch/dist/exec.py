"""Mesh execution of the mapper's DP batches.

`sharded_dp_runner(mesh)` adapts the batched banded DP to the mesh's "reads"
axis: the (B, ...) piece batch is padded to a multiple of the mesh size, cut
into one slice per shard, and each slice runs the row-banded DP kernel on
its shard's device, so stage-1 alignment compute executes through the mesh
on the same `run_pipeline` path.  Launches are asynchronous, so the shards'
kernels overlap.  The runner speaks two conventions: called like
dp.banded_dp_batch it returns the direction bytes and scores as numpy (the
form the tests hold against the JAX package's runner); its `walks` method,
which dp.align_pairs uses, also walks the direction bytes on each shard
(dp.banded_dp_walk) and brings back only the packed alignments, through a
pinned buffer on a CUDA shard.

`make_depth_psum_step(mesh, cov_bins, max_blocks)` is the CIGAR-true depth
reduction: each shard scatter-adds its reads' aligned M-block spans into a
diff array and the per-base coverage is summed over "reads" — samtools
depth -aa semantics (deletion gaps excluded) on device.  The sums are int32,
so their order cannot change a bit.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from telr_tpu_torch.dist.mesh import READS_AXIS, Mesh, shard_slices
from telr_tpu_torch.kernels import dp

# keyed by the Mesh itself (hashable by devices+axes)
_runner_cache: Dict[object, object] = {}

# direction bytes a CPU shard may hold per launch (host memory; a CUDA shard
# takes dp.WALK_DIRS_BUDGET of its card's)
_CPU_DIRS_BUDGET = 1 << 28


def _to_host(x):
    """A device tensor as numpy; a CUDA tensor goes through a pinned buffer
    (pageable copies run at a fraction of the link's rate)."""
    import torch
    if x.device.type != "cuda":
        return x.numpy()
    buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    buf.copy_(x)
    return buf.numpy()


class ShardedDPRunner:
    """The mesh's DP runner (see the module docstring).  `bytes_to_host`
    counts what its calls copied back from the devices."""

    def __init__(self, mesh: Mesh):
        self.n = mesh.size
        self.devices = mesh.axis_devices(READS_AXIS)
        per_shard = (dp.WALK_DIRS_BUDGET
                     if self.devices[0].type == "cuda" else _CPU_DIRS_BUDGET)
        self.dirs_budget = per_shard * len(self.devices)
        self.bytes_to_host = 0

    def _padded(self, q, t, off, qlen, tlen):
        """The batch padded with fill rows to a multiple of the mesh size."""
        n = self.n
        B = q.shape[0]
        Bp = max(B, n)
        if Bp % n:
            Bp += n - Bp % n
        if Bp != B:
            pad = Bp - B
            q = np.concatenate([q, np.full((pad,) + q.shape[1:], 4,
                                           q.dtype)])
            t = np.concatenate([t, np.full((pad,) + t.shape[1:], 4,
                                           t.dtype)])
            off = np.concatenate([off, np.zeros((pad,) + off.shape[1:],
                                                off.dtype)])
            qlen = np.concatenate([qlen, np.ones(pad, qlen.dtype)])
            tlen = np.concatenate([tlen, np.ones(pad, tlen.dtype)])
        return Bp, (q, t, off, qlen, tlen)

    def _fetch(self, tensors):
        out = [_to_host(x) for x in tensors]
        self.bytes_to_host += sum(a.nbytes for a in out)
        return out

    def __call__(self, q, t, off, qlen, tlen, *, width, mode, params_tuple):
        """dp.banded_dp_batch's convention, numpy in and numpy out."""
        B = q.shape[0]
        Bp, arrays = self._padded(q, t, off, qlen, tlen)
        # launch every shard before reading any back: the copies to the
        # host wait for their own device only
        outs = [dp.banded_dp_batch(*(a[s] for a in arrays), width=width,
                                   mode=mode, params_tuple=params_tuple,
                                   device=dev)
                for s, dev in shard_slices(Bp, self.devices)]
        outs = [self._fetch(o) for o in outs]
        if len(outs) == 1:
            return tuple(o[:B] for o in outs[0])
        return tuple(np.concatenate([o[k] for o in outs])[:B]
                     for k in range(5))

    def walks(self, q, t, off, qlen, tlen, *, width, mode, params_tuple,
              walk: bool = True):
        """Launch DP and walk on every shard; returns a function that waits
        for them and gives (packed (B, S4) uint8, or None with walk=False;
        small (8, B) int32) as numpy."""
        B = q.shape[0]
        Bp, arrays = self._padded(q, t, off, qlen, tlen)
        outs = [dp.banded_dp_walk(*(a[s] for a in arrays), width=width,
                                  mode=mode, params_tuple=params_tuple,
                                  device=dev, walk=walk)
                for s, dev in shard_slices(Bp, self.devices)]

        def fetch():
            small = np.concatenate(
                [self._fetch([sm])[0] for _p, sm in outs], axis=1)[:, :B]
            if not walk:
                return None, small
            packed = np.concatenate(
                [self._fetch([p])[0] for p, _sm in outs])[:B]
            return packed, small

        return fetch


def sharded_dp_runner(mesh: Mesh) -> ShardedDPRunner:
    """The mesh's runner for dp.align_pairs(runner=), one per mesh."""
    cached = _runner_cache.get(mesh)
    if cached is None:
        cached = _runner_cache[mesh] = ShardedDPRunner(mesh)
    return cached


def make_depth_psum_step(mesh: Mesh, cov_bins: int, max_blocks: int):
    """CIGAR-true per-base depth, reduced over the "reads" axis.

    Input: spans (B, max_blocks, 2) int32 numpy — each read's aligned
    M-block [start, end) intervals (from its CIGAR), padded with (-1, -1);
    the batch dim is cut over "reads".  Output: (cov_bins,) int32 depth as a
    tensor on the mesh's first device (samtools depth -aa semantics: M bases
    count, D gaps don't — reference TELR_te.py:870-884)."""
    import torch
    devices = mesh.axis_devices(READS_AXIS)

    def shard_fn(block):
        starts = block[:, :, 0].reshape(-1)
        ends = block[:, :, 1].reshape(-1)
        valid = starts >= 0
        s = torch.where(valid, starts, 0).clamp(0, cov_bins).to(torch.int64)
        e = torch.where(valid, ends, 0).clamp(0, cov_bins).to(torch.int64)
        ones = valid.to(torch.int32)
        diff = torch.zeros(cov_bins + 1, dtype=torch.int32,
                           device=block.device)
        diff.index_add_(0, s, ones)
        diff.index_add_(0, e, -ones)
        return torch.cumsum(diff[:-1], dim=0, dtype=torch.int32)

    def step(spans):
        spans = np.ascontiguousarray(spans, dtype=np.int32)
        local = [shard_fn(torch.from_numpy(spans[s]).to(dev))
                 for s, dev in shard_slices(spans.shape[0], devices)]
        total = local[0]
        for part in local[1:]:
            total = total + part.to(total.device)
        return total

    return step


_depth_cache: Dict[tuple, object] = {}


def mesh_coverage(mesh: Mesh, store, tname: str, length: int) -> np.ndarray:
    """Per-base aligned (M) coverage of [0, length) on `tname`, computed by
    the sharded depth step.  Bit-identical to
    AlignmentStore.coverage(tname, 0, length) — same M spans, same
    semantics — but the reduction executes on the mesh."""
    from telr_tpu_torch.kernels.dp import _bucket
    n = int(mesh.shape[READS_AXIS])
    alns = store.fetch(tname, 0, length)
    if not alns:
        return np.zeros(length, dtype=np.int32)
    nblocks = max(sum(1 for op, _l in a.cigar if op == "M") for a in alns)
    max_blocks = _bucket(max(nblocks, 1), quanta=(8, 16, 32, 64, 128, 256,
                                                  512, 1024, 2048))
    cov_bins = _bucket(length)
    key = (mesh, cov_bins, max_blocks)
    step = _depth_cache.get(key)
    if step is None:
        step = make_depth_psum_step(mesh, cov_bins, max_blocks)
        _depth_cache[key] = step
    spans = spans_from_store(store, tname, cov_bins, max_blocks, n)
    depth = step(spans)
    calls = mesh_coverage.device_calls
    calls[depth.device.type] = calls.get(depth.device.type, 0) + 1
    return depth.cpu().numpy()[:length]


# reductions run so far, by the device type they ran on
mesh_coverage.device_calls = {}


def spans_from_store(store, tname: str, cov_bins: int, max_blocks: int,
                     n_shards: int) -> np.ndarray:
    """Pack each alignment's M-block target intervals into the depth step's
    (B, max_blocks, 2) layout (B padded to a multiple of n_shards)."""
    rows: List[np.ndarray] = []
    for a in store.fetch(tname, 0, cov_bins):
        blocks = []
        tj = a.tstart
        for op, ln in a.cigar:
            if op == "M":
                blocks.append((tj, tj + ln))
                tj += ln
            elif op == "D":
                tj += ln
        # merge down to max_blocks by span-union of the smallest gaps is
        # unnecessary: counts beyond the cap fold into one closing block
        if len(blocks) > max_blocks:
            head = blocks[:max_blocks - 1]
            head.append((blocks[max_blocks - 1][0], blocks[-1][1]))
            blocks = head
        arr = np.full((max_blocks, 2), -1, dtype=np.int32)
        for k, (s, e) in enumerate(blocks):
            arr[k] = (s, e)
        rows.append(arr)
    B = len(rows)
    Bp = max(n_shards, B)
    if Bp % n_shards:
        Bp += n_shards - Bp % n_shards
    out = np.full((Bp, max_blocks, 2), -1, dtype=np.int32)
    for i, r in enumerate(rows):
        out[i] = r
    return out
