"""Build and load the port's own host kernels (telr_tpu_torch/csrc/*.cpp).

The sources are compiled with the C++ compiler into one shared library with
a plain C interface, loaded with ctypes: the row-form POA (csrc/poa_rows.cpp,
bound by io/native.py's poa_consensus) and the vote's insertion-event
consensus (csrc/ins_events.cpp, bound here: ins_event_consensus_batch).
The build runs at first use, never at import: the library lands in
telr_tpu_torch/_build/, keyed on a hash of the sources, the flags and the
target the compiler makes of -march=native on this host, so a fresh checkout
builds once, every later process reuses it, and a library built for another
CPU is never loaded.
A build failure raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import List, Optional

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ["-O3", "-march=native",
             "--param", "vect-max-version-for-alias-checks=200",
             "-shared", "-fPIC", "-std=c++17", "-pthread"]

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


def _sources():
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith(".cpp"))


def _cxx() -> str:
    return shutil.which("g++") or "c++"


def _target(cxx: str) -> str:
    """The compiler's report of what -march=native means on this host."""
    res = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                         capture_output=True, text=True, timeout=120)
    return res.stdout


def lib_path(cxx: str) -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode()
                       + _target(cxx).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_DIR, h.hexdigest()[:16], "libtelr_host.so")


def _build(cxx: str, out: str) -> None:
    """Compile into `out` under an exclusive file lock, so concurrent
    processes build once."""
    import fcntl
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.isfile(out):
            return
        tmp = out + f".tmp{os.getpid()}"
        res = subprocess.run([cxx] + CXX_FLAGS + ["-o", tmp] + _sources(),
                             capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise RuntimeError("building the host kernels failed:\n"
                               + res.stdout + res.stderr)
        os.replace(tmp, out)


def load() -> ctypes.CDLL:
    """The host kernels' shared library, built on first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            cxx = _cxx()
            path = lib_path(cxx)
            if not os.path.isfile(path):
                _build(cxx, path)
            lib = ctypes.CDLL(path)
            vp, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
            lib.telr_poa_consensus_rows.argtypes = (
                [vp, i64] + [vp] * 4 + [i64] + [i32] * 6 + [vp, i64, vp])
            lib.telr_poa_consensus_rows.restype = i64
            lib.telr_ins_event_consensus_batch.argtypes = (
                [vp] * 4 + [i64, vp, i64, vp, vp])
            lib.telr_ins_event_consensus_batch.restype = i64
            _LIB = lib
    return _LIB


def ins_event_consensus_batch(codes: np.ndarray, sup_off: np.ndarray,
                              ev_sup: np.ndarray, ev_off: np.ndarray,
                              stats: Optional[dict] = None
                              ) -> List[np.ndarray]:
    """The consensus of every insertion event of a vote round, in one call
    (csrc/ins_events.cpp; the rule of assembly/device_vote.py's events).

    Supporter s is codes[sup_off[s]:sup_off[s + 1]] (int8 codes 0..4);
    event e's supporters are ev_sup[ev_off[e]:ev_off[e + 1]], in the order
    the vote met them.  Returns one int8 array per event, views of one
    buffer.  A `stats` dict gets dp_events (the events that ran the DP),
    pairs (their supporters) and cells (the sum of len(supporter) x
    len(representative))."""
    lib = load()
    codes = np.ascontiguousarray(codes, dtype=np.int8)
    sup_off = np.ascontiguousarray(sup_off, dtype=np.int64)
    ev_sup = np.ascontiguousarray(ev_sup, dtype=np.int64)
    ev_off = np.ascontiguousarray(ev_off, dtype=np.int64)
    n_ev = len(ev_off) - 1
    # an event writes at most its representative plus its supporters
    cap = 2 * int((sup_off[ev_sup + 1] - sup_off[ev_sup]).sum())
    out = np.empty(max(cap, 1), dtype=np.int8)
    out_off = np.zeros(n_ev + 1, dtype=np.int64)
    counts = np.zeros(3, dtype=np.int64)
    n = lib.telr_ins_event_consensus_batch(
        codes.ctypes.data, sup_off.ctypes.data, ev_sup.ctypes.data,
        ev_off.ctypes.data, n_ev, out.ctypes.data, len(out),
        out_off.ctypes.data, counts.ctypes.data)
    if n < 0:
        raise RuntimeError(
            {-1: "an insertion event's traceback left the band",
             -2: "the insertion events' output buffer is too small",
             -3: "an insertion event holds a base code outside 0..4"}[n])
    if stats is not None:
        stats.update(dp_events=int(counts[0]), pairs=int(counts[1]),
                     cells=int(counts[2]))
    bounds = out_off.tolist()
    return [out[a:b] for a, b in zip(bounds, bounds[1:])]

