"""Sharded device-side pipeline steps.

Compute-dense inner steps of the pipeline, expressed over a
("reads", "loci") mesh:

  * `make_sharded_align_step` — stage-1 scoring: the read batch (padded
    (B, Lq) codes + band offsets) is cut over the "reads" axis with the
    reference window replicated; each shard runs the score-only row-banded
    DP kernel over its reads.  The full mapper path runs the same
    partitioning through `dist.exec.sharded_dp_runner` (with traceback);
    this score-only step is the screening surface.
  * `make_locus_score_step` — batched per-locus realignment scoring cut
    over the "loci" axis (post all-to-all layout: each locus' read pile
    stays together).

Depth reductions live in `dist.exec.make_depth_psum_step` — CIGAR-true
M-span coverage summed over "reads" (samtools depth -aa semantics), which
is what `run_pipeline(mesh=...)` consumes for AF windows.

The steps take numpy arrays and return numpy arrays; the batch must divide
by the number of shards on its axis.
"""

from __future__ import annotations

import numpy as np

from telr_tpu_torch.dist.mesh import (LOCI_AXIS, READS_AXIS, Mesh,
                                      shard_slices)
from telr_tpu_torch.kernels import dp


def make_sharded_align_step(mesh: Mesh, width: int, mode: int,
                            params_tuple):
    """Build a sharded scoring step:
       (q (B,Lq) int8, t (Lt,) int8, off (B,Lq+1) i32, qlen (B,), tlen ())
       -> (scores (B,), best (B,))
    with q/off/qlen cut over "reads" and t replicated."""
    devices = mesh.axis_devices(READS_AXIS)

    def step(q, t, off, qlen, tlen):
        q, off, qlen = (np.asarray(x) for x in (q, off, qlen))
        outs = []
        for s, dev in shard_slices(q.shape[0], devices):
            n = q[s].shape[0]
            tb = np.repeat(np.asarray(t)[None], n, axis=0)
            tl = np.full(n, int(tlen), np.int32)
            outs.append(dp.banded_dp_scores(
                q[s], tb, off[s], qlen[s], tl, width=width, mode=mode,
                params_tuple=params_tuple, device=dev))
        return tuple(np.concatenate([o[k].cpu().numpy() for o in outs])
                     for k in range(2))

    return step


def make_locus_score_step(mesh: Mesh, width: int, params_tuple):
    """Batched per-locus realignment scoring cut over the "loci" axis:
       (reads (L, R, Lq) int8, contigs (L, Lt) int8, off (L, R, Lq+1),
        qlen (L, R), tlen (L,)) -> (gscore (L, R), best (L, R))."""
    devices = mesh.axis_devices(LOCI_AXIS)

    def step(reads, contigs, off, qlen, tlen):
        reads, contigs, off, qlen, tlen = (
            np.asarray(x) for x in (reads, contigs, off, qlen, tlen))
        L, R, Lq = reads.shape
        outs = []
        for s, dev in shard_slices(L, devices):
            n = reads[s].shape[0]
            # every read of a locus shares its contig: one (n*R) batch
            tb = np.repeat(contigs[s], R, axis=0)
            tl = np.repeat(tlen[s].astype(np.int32), R)
            outs.append(dp.banded_dp_scores(
                reads[s].reshape(n * R, Lq), tb,
                off[s].reshape(n * R, Lq + 1), qlen[s].reshape(n * R), tl,
                width=width, mode=dp.EXTEND, params_tuple=params_tuple,
                device=dev))
        return tuple(
            np.concatenate([o[k].cpu().numpy() for o in outs]).reshape(L, R)
            for k in range(2))

    return step


# backwards-compatible alias (previous name)
make_locus_depth_step = make_locus_score_step
