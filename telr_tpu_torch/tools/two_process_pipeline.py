"""Multi-process pipeline harness: bit identity across process counts, and
scaling.

Runs telr_tpu_torch.dist.runner.run_pipeline_multiprocess

  1) as ONE process, then
  2) as --procs processes (torch.distributed on localhost), each loading
     ONLY its crc32 read shard, with the same thread budget each; rank r
     runs its kernels on card r % cards, and the collectives go over NCCL
     on the ranks' cards when every rank has a card of its own, else over
     gloo on host tensors (ranks sharing a card; --device cpu, where the
     kernels' plain versions run on the CPU),

byte-compares every output file of the two runs, and writes a JSON with
both runs' stage seconds and walls, T1 / (P * T2), and each rank's backend,
kernel launches (also by card), vote calls and peak device memory.  A rank that fails or outlives
--timeout ends the run with an error after every worker is killed.

Dataset: the FASTA files given with --inputs, or a genome simulated with the
repository's tools/genome_eval.py generators (--size, --coverage; by default
3 Mb at 30x, with 10 planted insertions, seed 3).
Stage routing is the CLI's auto routing for --device: on a card the
alignment and assembly DPs take the wavefront kernels, on the CPU none.

Usage:
    python -m telr_tpu_torch.tools.two_process_pipeline [--procs P]
        [--device cuda|cpu] [--threads T] [--size N] [--coverage X]
        [--inputs READS REF LIB] [--workdir DIR] [--out JSON]
    python -m telr_tpu_torch.tools.two_process_pipeline worker NPROCS PID \\
        PORT READS REF LIB OUT_DIR STATS_JSON THREADS DEVICE TIMEOUT_S
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MIN_SUPPORT = 3
# the simulated genome's planted insertions and seed (chip_smoke.py's)
N_INS, SEED = 10, 3


def simulate(workdir, size, coverage, n_ins, seed):
    """tools/genome_eval.py's dataset (one chromosome, chr2L) through
    telr_tpu_torch/tools/genome_eval.py's simulate_dataset.  Returns the
    three paths (reads, reference, library), the planted truth, the read
    count, the read bases and the generators' score_calls."""
    from telr_tpu_torch.tools.genome_eval import generators, simulate_dataset
    ref, reads, lib, truth, n_reads, n_bases = simulate_dataset(
        size, coverage, n_ins, seed, workdir)
    return [reads, ref, lib], truth, n_reads, n_bases, \
        generators().score_calls


def worker(nprocs: int, pid: int, port: int, reads_fa: str, ref_fa: str,
           lib_fa: str, out_dir: str, stats_path: str, threads: int,
           device: str, timeout_s: float) -> None:
    """One rank: join the process group, run the pipeline, write this
    rank's stats to stats_path."""
    from telr_tpu_torch.utils.procpool import ensure_forkserver
    ensure_forkserver()   # before gloo and CUDA start threads
    import datetime

    import logging
    handler = logging.StreamHandler()
    handler.setFormatter(logging.Formatter("%(name)s: %(message)s"))
    dist_log = logging.getLogger("telr_tpu.dist")
    dist_log.addHandler(handler)
    dist_log.setLevel(logging.INFO)

    from telr_tpu_torch.dist.mesh import init_distributed
    init_distributed(f"localhost:{port}", nprocs, pid,
                     timeout=datetime.timedelta(seconds=timeout_s),
                     device="cpu" if device == "cpu" else None)
    import torch

    from telr_tpu_torch.assembly.device_vote import vote_many
    from telr_tpu_torch.cli import _resolve_wavefront
    from telr_tpu_torch.config import SVConfig, TELRConfig
    from telr_tpu_torch.dist.mesh import collective_device
    from telr_tpu_torch.dist.runner import run_pipeline_multiprocess
    from telr_tpu_torch.tools.bench_pipeline import (kernel_launches,
                                                     kernel_launches_by_card,
                                                     reset_launches)
    from telr_tpu_torch.utils.device import resolve

    dev = resolve("cpu" if device == "cpu" else None)
    backend = (torch.distributed.get_backend() if nprocs > 1 else None)
    dist_log.info("rank %d of %d: kernels on %s, collectives on %s (%s)",
                  pid, nprocs, dev, collective_device(), backend)
    use_wf, wf_stages = _resolve_wavefront("auto", device=dev.type)
    cfg = TELRConfig(sv=SVConfig(min_support=MIN_SUPPORT), threads=threads,
                     use_wavefront=use_wf, wavefront_stages=wf_stages)
    reset_launches()
    vote_many.device_calls.clear()
    vote_many.card_calls.clear()
    if dev.type == "cuda":
        if dev.index is not None:
            torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    stage_s = run_pipeline_multiprocess(reads_fa, ref_fa, lib_fa, out_dir,
                                        cfg, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    stats = {
        "nprocs": nprocs, "rank": pid, "wall_s": wall,
        "stage_seconds": stage_s, "device": str(dev),
        "device_name": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
        "backend": backend, "collective_device": str(collective_device()),
        "launches": kernel_launches(),
        "launches_by_card": kernel_launches_by_card(),
        "vote_calls": dict(vote_many.device_calls),
        "vote_calls_by_card": dict(vote_many.card_calls),
        "peak_device_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None),
    }
    with open(stats_path, "w") as f:
        json.dump(stats, f, indent=1)


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env(threads: int) -> dict:
    env = dict(os.environ)
    env.update({
        "OMP_NUM_THREADS": "1",
        "TELR_DP_THREADS": str(threads),
        "PYTHONPATH": os.pathsep.join(
            [REPO] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else [])),
    })
    return env


def run_ranks(commands, timeout_s: float, env=None) -> None:
    """Start one process per command (from the repository's root) and wait
    for all of them.  A process that exits non-zero, or a run past
    timeout_s, kills every other process and raises: a dead rank ends the
    run instead of leaving its peers waiting in a collective."""
    procs = [subprocess.Popen(cmd, env=env, cwd=REPO) for cmd in commands]
    deadline = time.monotonic() + timeout_s
    try:
        while True:
            codes = [p.poll() for p in procs]
            failed = [(r, c) for r, c in enumerate(codes)
                      if c not in (None, 0)]
            if failed:
                raise RuntimeError(f"{len(procs)}-process run: rank "
                                   f"{failed[0][0]} exited with code "
                                   f"{failed[0][1]}")
            if all(c == 0 for c in codes):
                return
            if time.monotonic() > deadline:
                raise TimeoutError(f"{len(procs)}-process run still running "
                                   f"after {timeout_s:.0f} s")
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()


def launch(nprocs: int, inputs, out_dir: str, stats_dir: str, threads: int,
           device: str, timeout_s: float) -> list:
    """Run the pipeline's `nprocs` worker processes to their end.  Returns
    each rank's stats."""
    port = free_port()
    os.makedirs(stats_dir, exist_ok=True)
    paths = [os.path.join(stats_dir, f"rank{r}.json") for r in range(nprocs)]
    # the collectives time out a little before the run does, so a rank
    # stuck on a dead peer fails on its own
    collective_s = max(10.0, timeout_s - 10.0)
    run_ranks([[sys.executable, "-m",
                "telr_tpu_torch.tools.two_process_pipeline", "worker",
                str(nprocs), str(r), str(port), *inputs, out_dir, paths[r],
                str(threads), device, str(collective_s)]
               for r in range(nprocs)], timeout_s, env=_env(threads))
    stats = []
    for path in paths:
        with open(path) as f:
            stats.append(json.load(f))
    return stats


def _compare_dirs(d1: str, d2: str) -> list:
    """Byte-compare every output file; returns list of mismatches."""
    bad = []
    names = sorted(set(os.listdir(d1)) | set(os.listdir(d2)))
    for n in names:
        if n in ("TELR.log", "run_env.json"):
            continue
        p1, p2 = os.path.join(d1, n), os.path.join(d2, n)
        if not (os.path.isfile(p1) and os.path.isfile(p2)):
            bad.append(f"{n}: missing on one side")
            continue
        with open(p1, "rb") as f:
            b1 = f.read()
        with open(p2, "rb") as f:
            b2 = f.read()
        if b1 != b2:
            bad.append(f"{n}: differs ({len(b1)} vs {len(b2)} bytes)")
    return bad


def run(inputs, workdir: str, procs: int = 2, threads: int = 2,
        device: str = "cuda", timeout_s: float = 1800.0) -> dict:
    """The 1-process run, then the `procs`-process run, on the same inputs;
    outputs under workdir/out1 and workdir/out{procs}.  Returns the result
    (see the module docstring); raises when a run fails, and before any
    worker starts when device="cuda" finds no card."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    # the workers run from the repository's root
    inputs = [os.path.abspath(p) for p in inputs]
    workdir = os.path.abspath(workdir)
    import torch
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA card found (torch.cuda.is_available() "
                               "is false); to run on the CPU pass --device "
                               "cpu")
        # build the kernels once, before the ranks load them
        from telr_tpu_torch.kernels import cuda_lib
        cuda_lib.load()
    runs = {}
    for n in (1, procs):
        out = os.path.join(workdir, f"out{n}")
        t0 = time.perf_counter()
        ranks = launch(n, inputs, out, os.path.join(workdir, f"stats{n}"),
                       threads, device, timeout_s)
        runs[n] = {"out_dir": out, "launch_wall_s": time.perf_counter() - t0,
                   "wall_s": ranks[0]["wall_s"], "ranks": ranks}
    mismatches = _compare_dirs(runs[1]["out_dir"], runs[procs]["out_dir"])
    return {
        "procs": procs, "threads_per_process": threads, "device": device,
        "device_name": runs[procs]["ranks"][0]["device_name"],
        "one_process": runs[1], "multi_process": runs[procs],
        "scaling_efficiency": runs[1]["wall_s"]
        / (procs * runs[procs]["wall_s"]),
        "output_files": sorted(os.listdir(runs[1]["out_dir"])),
        "bit_identical": not mismatches, "mismatches": mismatches,
        "backend": f"torch.distributed {runs[procs]['ranks'][0]['backend']} "
                   "on localhost; each process parses only its crc32 shard "
                   "of the reads",
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=2,
                    help="process count of the multi-process run")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--threads", type=int, default=2,
                    help="host threads of each process")
    ap.add_argument("--size", type=int, default=3_000_000)
    ap.add_argument("--coverage", type=int, default=30)
    ap.add_argument("--inputs", nargs=3, metavar=("READS", "REF", "LIB"),
                    help="FASTA inputs instead of a simulated genome")
    ap.add_argument("--workdir", default=None,
                    help="where the data and both runs' outputs go "
                         "(default: a new temporary directory)")
    ap.add_argument("--timeout", type=float, default=1800.0,
                    help="seconds each run may take")
    ap.add_argument("--out", default=None,
                    help="the result JSON (default: WORKDIR/mp_pipeline.json)")
    a = ap.parse_args(argv)
    workdir = a.workdir or tempfile.mkdtemp(prefix="telr_mp_")
    os.makedirs(workdir, exist_ok=True)
    if a.inputs:
        inputs, workload = a.inputs, {"inputs": a.inputs}
    else:
        inputs, truth, n_reads, n_bases, _score = simulate(
            workdir, a.size, a.coverage, N_INS, SEED)
        workload = {"dataset": f"simulated {a.size} bases at {a.coverage}x, "
                               f"seed {SEED}", "n_reads": n_reads,
                    "read_bases": n_bases, "n_truth": len(truth)}
    result = run(inputs, workdir, a.procs, a.threads, a.device, a.timeout)
    result["workload"] = workload
    out = a.out or os.path.join(workdir, "mp_pipeline.json")
    with open(out, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result, indent=2))
    if result["mismatches"]:
        sys.exit(f"output mismatch between the 1- and {a.procs}-process runs")


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "worker":
        worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
               sys.argv[5], sys.argv[6], sys.argv[7], sys.argv[8],
               sys.argv[9], int(sys.argv[10]), sys.argv[11],
               float(sys.argv[12]))
    else:
        main()
