#!/usr/bin/env python3
"""Time the port's DP kernels in two or more checkouts on one NVIDIA GPU.

    python3 tools/port_kernel_ab.py --trees parent=DIR change=. [--reps 10]
        [--mult 8] [--sass]
    python3 tools/port_kernel_ab.py --sweep [--reps 5]

Each tree is a checkout of the repository (the current one, `git archive` of
another commit unpacked somewhere, or a copy with one line changed).  The
trees are run in the order given and then in reverse (parent, change, change,
parent), each run in a process of its own that builds that tree's kernels and
times them at chip_smoke.py's parity shapes: wavefront_dp and rowband_dp with
and without direction bytes in all three modes, wavefront_walk, and
rowband_walk where the tree has it.  Times are CUDA-event means of --reps
launches after a warm-up; a digest of each kernel's scores shows that the
trees computed the same thing.  --mult N repeats every batch N times, which
is how the pipelines launch them (hundreds to thousands of pairs a launch).
--sass also prints, per compiled kernel, ptxas's registers / spills and an
instruction histogram from cuobjdump.  Compare two trees only within one
call of this script: two calls may land on two cards.

--sweep times, in this checkout only, both threads-per-pair choices the two
DP kernels are built for (wavefront_dp's `lanes`, rowband_dp's `cells`), in
EXTEND mode, at the same shapes with the batch repeated 1, 4 and 16 times:
the table that kernels/cuda_lib.py::pick_cells is set from.  The choice the
wrapper makes on its own is marked with a star.
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys


# batches whose direction bytes would take more than this are left out
MAX_DIRS_BYTES = 6 << 30


def _timed(fn, reps, device):
    """Mean milliseconds of fn() over reps launches (CUDA events), after two
    warm-up runs that leave two sets of outputs in the allocator's cache.
    (Not a tree's own chip_smoke._timed: both trees are timed the same way.)"""
    import torch
    out = fn()
    out = fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps, out


def _digest(tensors):
    h = hashlib.sha1()
    for t in tensors:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:12]


def worker(tree, reps, sass, mult):
    sys.path.insert(0, tree)
    os.chdir(tree)
    import numpy as np
    import torch
    import chip_smoke as cs
    from telr_tpu_torch.kernels import cuda_lib, hopper_dp
    from telr_tpu_torch.kernels import hopper_wavefront as hw
    from telr_tpu_torch.kernels.dp import DPParams
    device = torch.device("cuda", 0)
    cuda_lib.load()
    for line in cs.ptxas_summary(cuda_lib.build_log):
        print(json.dumps({"ptxas": line}), flush=True)
    if sass:
        for line in sass_histogram(cuda_lib.lib_path(), cuda_lib._nvcc()):
            print(json.dumps({"sass": line}), flush=True)
    params = DPParams()

    def emit(kernel, case, mode, ms, digest):
        print(json.dumps({"kernel": kernel, "case": case, "mode": mode,
                          "ms": ms, "digest": digest}), flush=True)

    cases = cs.parity_cases() + [cs.extend_round_case()]
    for name, width, pairs, guides in cases:
        pairs, guides = pairs * mult, guides * mult if guides else None
        if len(pairs) * hw._sbucket(max(len(q) + len(t) for q, t in pairs)) \
                * width > MAX_DIRS_BYTES:
            continue
        wire = [torch.from_numpy(x).to(device)
                for x in hw.prepare_wavefront_batch(pairs, width, guides)]
        n = len(pairs)
        for mode in ((1,) if name.startswith("extend_round") else (0, 1, 2)):
            ms, out = _timed(lambda: hw.wavefront_dp(
                *wire, n, width, mode, params, tb=True), reps, device)
            emit("wavefront_dp", name, mode, ms, _digest(out[:4]))
            ms2, out2 = _timed(lambda: hw.wavefront_dp(
                *wire, n, width, mode, params, tb=False), reps, device)
            emit("wavefront_dp_scores", name, mode, ms2, _digest(out2))
            ms3, out3 = _timed(lambda: hw.wavefront_walk(
                out[4], wire[0], wire[2], *out[:4], mode), reps, device)
            emit("wavefront_walk", name, mode, ms3, _digest(out3))
    dts = (torch.int8, torch.int8, torch.int32, torch.int32, torch.int32)
    for name, width, arrays in cs.rowband_cases():
        if arrays[0].size * mult * width > MAX_DIRS_BYTES:
            continue
        q, t, off, qlen, tlen = (
            torch.from_numpy(np.concatenate([a] * mult)).to(device=device,
                                                            dtype=dt)
            for a, dt in zip(arrays, dts))
        for mode in (0, 1, 2):
            kw = dict(width=width, mode=mode, params_tuple=params.tuple())
            ms, out = _timed(lambda: hopper_dp.rowband_dp(
                q, t, off, qlen, tlen, tb=True, **kw), reps, device)
            emit("rowband_dp", name, mode, ms, _digest(out[1:]))
            ms2, out2 = _timed(lambda: hopper_dp.rowband_dp(
                q, t, off, qlen, tlen, tb=False, **kw), reps, device)
            emit("rowband_dp_scores", name, mode, ms2, _digest(out2))
            if hasattr(hopper_dp, "rowband_walk"):
                ms3, out3 = _timed(lambda: hopper_dp.rowband_walk(
                    out[0], off, qlen, tlen, *out[1:], lt=t.shape[1],
                    mode=mode), reps, device)
                emit("rowband_walk", name, mode, ms3, _digest(out3))


def sweep(reps, max_dirs_bytes=MAX_DIRS_BYTES):
    import numpy as np
    import torch
    tree = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, tree)
    import chip_smoke as cs
    from telr_tpu_torch.kernels import cuda_lib, hopper_dp
    from telr_tpu_torch.kernels import hopper_wavefront as hw
    from telr_tpu_torch.kernels.dp import EXTEND, DPParams
    device = torch.device("cuda", 0)
    cuda_lib.load()
    params = DPParams()
    print("kernel case pairs tb | ms by cells a thread (* = the wrapper's "
          "choice)", flush=True)

    def row(kernel, case, n, tb, times, chosen):
        print(f"{kernel} {case} {n} {'tb' if tb else 'scores'} | " + "  ".join(
            f"{c}{'*' if c == chosen else ''}: {ms:.3f}"
            for c, ms in times.items()), flush=True)

    for name, width, pairs, guides in (cs.parity_cases()
                                       + [cs.extend_round_case()]):
        for mult in (1, 4, 16):
            n = len(pairs) * mult
            wire = hw.prepare_wavefront_batch(
                pairs * mult, width, guides * mult if guides else None)
            if n * wire[0].shape[2] * width > max_dirs_bytes:
                continue
            wire = [torch.from_numpy(x).to(device) for x in wire]
            options = cuda_lib.cell_options("wavefront_dp", width)
            for tb in (True, False):
                times = {lanes: _timed(lambda: hw.wavefront_dp(
                    *wire, n, width, EXTEND, params, tb=tb, lanes=lanes),
                    reps, device)[0] for lanes in options}
                row("wavefront_dp", name, n, tb, times,
                    cuda_lib.pick_cells(width, n, options))
            del wire
            torch.cuda.empty_cache()
    dts = (torch.int8, torch.int8, torch.int32, torch.int32, torch.int32)
    for name, width, arrays in cs.rowband_cases():
        for mult in (1, 4, 16):
            q, t, off, qlen, tlen = (
                torch.from_numpy(np.concatenate([a] * mult)).to(
                    device=device, dtype=dt) for a, dt in zip(arrays, dts))
            n = q.shape[0]
            if n * q.shape[1] * width > max_dirs_bytes:
                continue
            options = cuda_lib.cell_options("rowband_dp", width)
            for tb in (True, False):
                times = {cells: _timed(lambda: hopper_dp.rowband_dp(
                    q, t, off, qlen, tlen, width=width, mode=EXTEND,
                    params_tuple=params.tuple(), tb=tb, cells=cells),
                    reps, device)[0] for cells in options}
                row("rowband_dp", name, n, tb, times,
                    cuda_lib.pick_cells(width, n, options))
            torch.cuda.empty_cache()


def sass_histogram(lib, nvcc):
    """Per kernel in the library: instructions in all, and those that touch
    shared or local memory, shuffle or wait at a barrier."""
    cuobjdump = os.path.join(os.path.dirname(os.path.realpath(nvcc)),
                             "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    out, name, counts = [], None, {}
    watch = ("LDS", "STS", "LDL", "STL", "SHFL", "BAR", "LDG", "STG", "BRA",
             "VIMNMX", "VIADDMNMX", "IMNMX", "SEL", "MOV")

    def flush():
        if name:
            out.append(name + ": " + " ".join(
                f"{k}={v}" for k, v in sorted(counts.items())))

    for line in text.splitlines():
        line = line.strip()
        if line.startswith("Function :"):
            flush()
            name, counts = line.split(":", 1)[1].strip(), {"all": 0}
        elif line.startswith("/*") and ";" in line and name:
            parts = line.split("*/", 1)[1].split()
            if not parts:
                continue
            op = parts[1] if parts[0].startswith("@") and len(parts) > 1 \
                else parts[0]
            counts["all"] += 1
            for w in watch:
                if op.startswith(w):
                    counts[w] = counts.get(w, 0) + 1
                    break
    flush()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", metavar="NAME=DIR",
                    help="checkouts to time, in order")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--mult", type=int, default=1,
                    help="repeat every batch this many times")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--sweep", action="store_true",
                    help="time every threads-per-pair choice in this "
                         "checkout instead of comparing trees")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(os.path.abspath(args.worker), args.reps, args.sass,
                      args.mult)
    trees = [t.split("=", 1) for t in args.trees or ()]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    if args.sweep:
        sweep(args.reps)
        print(f"card: {smi}")
        return
    if not args.trees:
        ap.error("--trees or --sweep is required")
    rows = {}      # (kernel, case, mode) -> {tree: [ms, ...]}
    digests = {}   # (kernel, case, mode) -> {tree: digest}
    order = trees + trees[::-1]
    for rnd, (name, path) in enumerate(order):
        first = rnd < len(trees)
        cmd = [sys.executable, os.path.abspath(__file__), "--worker", path,
               "--reps", str(args.reps), "--mult", str(args.mult)] + (
                   ["--sass"] if args.sass and first else [])
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            sys.exit(f"{name}: worker failed\n{proc.stdout[-3000:]}\n"
                     f"{proc.stderr[-6000:]}")
        for line in proc.stdout.splitlines():
            if not line.startswith("{"):
                continue
            rec = json.loads(line)
            if "kernel" not in rec:
                if first:
                    print(f"{name}: " + next(iter(rec.values())), flush=True)
                continue
            key = (rec["kernel"], rec["case"], rec["mode"])
            rows.setdefault(key, {}).setdefault(name, []).append(rec["ms"])
            digests.setdefault(key, {})[name] = rec["digest"]
    names = [n for n, _ in trees]
    print("kernel case mode | " + " | ".join(
        f"{n} ms (each run)" for n in names) + " | same scores")
    for key, by_tree in rows.items():
        same = len({digests[key].get(n) for n in names
                    if n in digests[key]}) == 1
        print(" ".join(str(k) for k in key) + " | " + " | ".join(
            " ".join(f"{ms:.3f}" for ms in by_tree.get(n, [])) or "-"
            for n in names) + f" | {same}", flush=True)
    print(f"card: {smi}")


if __name__ == "__main__":
    main()
