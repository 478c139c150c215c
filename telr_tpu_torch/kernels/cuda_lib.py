"""Build and load the hand-written CUDA kernels (telr_tpu_torch/csrc/*.cu).

The sources are compiled with nvcc for Hopper (sm_90a), one nvcc process per
source and all of them at once, and linked into one shared library with a
plain C interface, loaded with ctypes.  The build runs at first use, never
at import: the library lands in telr_tpu_torch/_build/,
keyed on a hash of the sources and flags, so a fresh checkout builds once
and every later process reuses it.  A build failure raises; there is no
fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()
build_log: str = ""   # nvcc output of this process's build (ptxas report)


def _sources():
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit to build")
    return path


def lib_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_DIR, h.hexdigest()[:16], "libtelr_cuda.so")


def _build(out: str) -> None:
    """Compile into `out` under an exclusive file lock, so concurrent
    processes build once."""
    global build_log
    import fcntl
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.isfile(out):
            return
        tmp = out + f".tmp{os.getpid()}"
        nvcc = _nvcc()
        srcs = [s for s in _sources() if s.endswith(".cu")]
        objs = [f"{tmp}.{os.path.basename(s)}.o" for s in srcs]
        procs = [subprocess.Popen(
            [nvcc] + NVCC_FLAGS + ["-c", s, "-o", o], text=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for s, o in zip(srcs, objs)]
        try:
            logs = [p.communicate(timeout=900)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        build_log = "".join(logs)
        if any(p.returncode != 0 for p in procs):
            raise RuntimeError("nvcc failed building the CUDA kernels:\n"
                               + build_log)
        link = subprocess.run([nvcc, "-shared", "-o", tmp] + objs,
                              capture_output=True, text=True, timeout=900)
        build_log += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError("nvcc failed linking the CUDA kernels:\n"
                               + build_log)
        for o in objs:
            os.remove(o)
        os.replace(tmp, out)


def load() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            path = lib_path()
            if not os.path.isfile(path):
                _build(path)
            lib = ctypes.CDLL(path)
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.telr_wavefront_dp.argtypes = [vp] * 3 + [ci] * 11 + [vp] * 6
            lib.telr_wavefront_dp.restype = ci
            lib.telr_wavefront_walk.argtypes = [vp] * 7 + [ci] * 4 + [vp] * 3
            lib.telr_wavefront_walk.restype = ci
            lib.telr_rowband_dp.argtypes = [vp] * 5 + [ci] * 12 + [vp] * 6
            lib.telr_rowband_dp.restype = ci
            lib.telr_rowband_walk.argtypes = [vp] * 8 + [ci] * 5 + [vp] * 3
            lib.telr_rowband_walk.restype = ci
            for fn in (lib.telr_wavefront_dp_cells,
                       lib.telr_rowband_dp_cells):
                fn.argtypes = [ci, ci]
                fn.restype = ci
            _LIB = lib
    return _LIB


# Warps a DP launch needs before long threads pay: about two for each of the
# card's 132 x 4 warp schedulers (tools/port_kernel_ab.py --sweep: below it
# the most threads a pair win, above it the fewest).
FILL_WARPS = 1024


def cell_options(kernel: str, width: int):
    """The cells a thread that `kernel` ("wavefront_dp" or "rowband_dp") is
    built for at this band width, as its source reports them: (fewest,
    most), or () for a width it has no instance of."""
    cells = getattr(load(), f"telr_{kernel}_cells")
    return tuple(c for c in (cells(width, 0), cells(width, 1)) if c)


def pick_cells(width: int, n: int, options) -> int:
    """How many neighbouring band cells a thread of a DP kernel owns, for a
    launch of n pairs at this band width.  A pair's steps are a dependent
    chain, so a launch is bound either by that chain (few pairs: the card is
    not full, and the step is shortest with the most threads a pair, one or
    two cells each) or by the instructions issued (many pairs: long threads
    do the least work per cell, the per-thread overhead of a step being
    shared by more cells).  The choice: the most cells a thread that still
    gives the card FILL_WARPS warps; below that, the fewest."""
    for cells in sorted(options, reverse=True):
        if n * width // (32 * cells) >= FILL_WARPS:
            return cells
    return min(options)


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError_t {rc}")


def count_launch(wrapper, dev) -> None:
    """One launch of `wrapper`'s kernel on card `dev` (a CUDA tensor's
    device, which always has its index): its `launches`, and its `cards`,
    the launches by card index."""
    wrapper.launches += 1
    wrapper.cards[dev.index] = wrapper.cards.get(dev.index, 0) + 1
