"""Kernel benchmark of the port: the banded affine-gap DP on the card.

The counterpart of the repository's bench.py, on the same workload: B = 64
pairs of a 2048-base query against a 3072-base target (the query is the
target's first 2048 bases with 200 substitutions), band W = 2048, EXTEND
mode, a chain-anchor guide on the diagonal every 512 bases from 256, made
with np.random.default_rng(0) exactly as bench.py makes it.

Headline: the score-only wavefront DP (hopper_wavefront.wavefront_dp,
tb=False).  The wire arrays go to the card once; a trial issues --iters (32)
launches and synchronises once, timed with CUDA events.  --trials (5) trials,
each recorded; `value` is the median trial's useful Gcells/s (B * LQ * 2W
cells a launch, bench.py's unit), with the min and max beside it, and
`band512_gcells_s` recounts the median trial at a 512-column band.
`bound_ms` is the least time a launch could take (tools/roofline.py: the
wire arrays in and the scores out over the memory rate, against 34 integer
operations a band cell over the int32 rate) and `bound_share` is bound_ms
over the median trial's milliseconds a launch.

Traceback path (on stderr, and under "traceback" in the JSON): one
wavefront_align call over 3 x 64 pairs (DP with direction bytes, the walk
kernel, the native decode), three times after a warm-up call: seconds per 64
pairs, Gcells/s, the hoststats split (wave_prep, wave_launch,
wave_device_wait, wave_decode) of the last call, and the device milliseconds
of the DP (with direction bytes) and of the walk on one 64-pair batch.

On --device cpu the kernels' plain torch versions run, at the size the
--pairs / --lq / --lt / --width flags give (for the tests; the card's record
is the default workload).

Usage:
    python -m telr_tpu_torch.tools.bench [--device cuda|cpu] [--trials 5]
        [--iters 32] [--pairs 64] [--lq 2048] [--lt 3072] [--width 2048]
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np


def workload(B=64, LQ=2048, LT=3072, n_sub=200):
    """bench.py's pairs and diagonal guides."""
    rng = np.random.default_rng(0)
    pairs = []
    for _ in range(B):
        t = rng.integers(0, 4, LT).astype(np.int8)
        q = t[:LQ].copy()
        idx = rng.integers(0, LQ, n_sub)
        q[idx] = rng.integers(0, 4, n_sub)
        pairs.append((q, t))
    aq = np.arange(256, LQ - 256, 512, dtype=np.int64)
    return pairs, [(aq, aq) for _ in range(B)]


def _elapsed_s(fn, dev):
    """Seconds fn() takes to its results: CUDA events around it on a card
    (everything it issued has ended), the host clock on the CPU."""
    import torch
    if dev.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(dev)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / 1e3


def run(device=None, trials=5, iters=32, B=64, LQ=2048, LT=3072, W=2048,
        check_pairs=0):
    """The benchmark; returns the report (see the module docstring).  With
    check_pairs > 0, also holds the kernel's gscore and best of the first
    check_pairs pairs against the plain version's on the same wire arrays,
    raising on any difference, and times the plain version on them
    (`plain_ms`)."""
    import torch

    from telr_tpu_torch.kernels import hopper_wavefront as hw
    from telr_tpu_torch.kernels.dp import EXTEND, DPParams
    from telr_tpu_torch.tools.bench_pipeline import device_record
    from telr_tpu_torch.tools.roofline import WAVEFRONT_OPS, bounds
    from telr_tpu_torch.utils import hoststats
    from telr_tpu_torch.utils.device import resolve

    dev = resolve(device)
    params = DPParams()
    pairs, guides = workload(B, LQ, LT)
    meta, init, scal = (torch.from_numpy(x).to(dev) for x in
                        hw.prepare_wavefront_batch(pairs, W, guides))

    def launches():
        for _ in range(iters):
            out = hw.wavefront_dp(meta, init, scal, B, W, EXTEND, params,
                                  tb=False)
        return out

    t0 = time.perf_counter()
    gscore, best = launches()   # the first launch builds the kernels
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print(f"first: {time.perf_counter() - t0:.1f}s", file=sys.stderr)
    hw.wavefront_dp.launches = 0
    trial_s = [_elapsed_s(launches, dev) for _ in range(trials)]
    bench_launches = hw.wavefront_dp.launches
    useful = B * LQ * (2 * W)
    gcells = [useful * iters / s / 1e9 for s in trial_s]
    print("trials: " + ", ".join(f"{g:.1f}" for g in gcells) + " Gcells/s",
          file=sys.stderr)
    med_s = statistics.median(trial_s)
    ms_per_launch = med_s / iters * 1e3
    steps = int(sum(len(q) + len(t) for q, t in pairs))
    wire = sum(x.numel() * x.element_size() for x in (meta, init, scal))
    bound_ms, bound_by = bounds(wire + 8 * B,
                                WAVEFRONT_OPS[False] * steps * W)

    checked = plain_ms = None
    if check_pairs:
        got = []
        plain_ms = 1e3 * _elapsed_s(lambda: got.append(
            hw._wavefront_dp_plain(meta, init, scal, check_pairs, W, EXTEND,
                                   params.tuple(), False)), dev)
        want = got[0]
        for what, a, b in zip(("gscore", "best"), (gscore, best), want):
            if not torch.equal(a[:check_pairs], b):
                raise AssertionError(f"wavefront_dp {what} of the first "
                                     f"{check_pairs} pairs differs from the "
                                     "plain version")
        checked = check_pairs

    # the traceback path: one wavefront_align over three batches' pairs
    reps = 3
    big, big_guides = pairs * reps, guides * reps
    hw.wavefront_align(pairs, W, EXTEND, params, guides=guides, device=dev)
    tb_s = []
    for _ in range(3):
        hoststats.reset()
        t0 = time.perf_counter()
        hw.wavefront_align(big, W, EXTEND, params, guides=big_guides,
                           device=dev)
        tb_s.append((time.perf_counter() - t0) / reps)
    # the last call's host counters, unrounded (snapshot() rounds to 10 ms)
    secs, calls = hoststats._c()
    split = {k: {"s": v, "n": calls[k]} for k, v in sorted(secs.items())
             if k.startswith("wave_")}
    # the two kernels of one 64-pair batch, each the mean of three calls
    # after a warm one
    def dp_tb():
        return hw.wavefront_dp(meta, init, scal, B, W, EXTEND, params,
                               tb=True)

    g, b, bs, bp, dirs = dp_tb()
    dp_tb_s = _elapsed_s(lambda: [dp_tb() for _ in range(3)], dev) / 3

    def walk():
        return hw.wavefront_walk(dirs, meta, scal, g, b, bs, bp, EXTEND)

    walk()
    walk_s = _elapsed_s(lambda: [walk() for _ in range(3)], dev) / 3
    del dirs
    tb_med = statistics.median(tb_s)
    traceback = {"s_per_iter": tb_s, "median_s_per_iter": tb_med,
                 "gcells_s": useful / tb_med / 1e9,
                 "pairs_per_call": B * reps, "split_last_call": split,
                 "dp_ms_one_batch": dp_tb_s * 1e3,
                 "walk_ms_one_batch": walk_s * 1e3}
    print(f"traceback path: {tb_med:.3f}s/iter "
          f"({useful / tb_med / 1e9:.2f} Gcells/s), split of the last call "
          f"{json.dumps(split)}; a {B}-pair batch: DP with direction bytes "
          f"{dp_tb_s * 1e3:.3f} ms, walk {walk_s * 1e3:.3f} ms",
          file=sys.stderr)

    baseline_gcps = 1.0   # SIMD CPU aligner class, single core (bench.py)
    value = statistics.median(gcells)
    return {
        "metric": "banded alignment DP throughput",
        "value": round(value, 3),
        "unit": "Gcells/s",
        "vs_baseline": round(value / baseline_gcps, 3),
        "dispatch": "pipelined",
        "window_cols": 2 * W,
        "band512_gcells_s": round(B * LQ * 512 * iters / med_s / 1e9, 3),
        "min": round(min(gcells), 3), "max": round(max(gcells), 3),
        "trials_gcells_s": gcells,
        "trials_s": trial_s,
        "iters": iters,
        "ms_per_launch": ms_per_launch,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_share": bound_ms / ms_per_launch,
        "launches": {"wavefront_dp_scores": bench_launches},
        "workload": {"pairs": B, "lq": LQ, "lt": LT, "width": W,
                     "mode": "EXTEND", "substitutions": 200,
                     "anchors": "diagonal, every 512 from 256"},
        "checked_pairs": checked,
        "plain_ms": plain_ms,
        "traceback": traceback,
        **device_record(dev),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--iters", type=int, default=32,
                    help="launches a trial, one synchronisation")
    ap.add_argument("--pairs", type=int, default=64)
    ap.add_argument("--lq", type=int, default=2048)
    ap.add_argument("--lt", type=int, default=3072)
    ap.add_argument("--width", type=int, default=2048)
    ap.add_argument("--check-pairs", type=int, default=0,
                    help="hold the kernel's scores of this many pairs "
                         "against the plain version's")
    a = ap.parse_args(argv)
    rec = run("cpu" if a.device == "cpu" else None, a.trials, a.iters,
              a.pairs, a.lq, a.lt, a.width, a.check_pairs)
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
