"""The wavefront DP on an H100: host prep, the two CUDA kernels, decode.

The counterpart of telr_tpu/kernels/pallas_wavefront.py.  One round of
`wavefront_align` over a chunk of (query, target) pairs is

  1. host prep — `prepare_wavefront_batch`: the parity walk of
     every pair's band schedule and the packing into the compact wire
     arrays (meta / init / scal), one threaded native call
     (native/telr_native.cpp telr_wave_prepare_batch);
  2. `wavefront_dp` — the banded anti-diagonal Gotoh DP with one direction
     byte per cell (csrc/wavefront_dp.cu);
  3. `wavefront_walk` — the traceback walk over those bytes into bit-packed
     op codes plus a (7, n) scalar stack (csrc/wavefront_walk.cu);
  4. the native decode of the packed ops into cigars (telr_wave_decode_*).

Each kernel wrapper runs its plain PyTorch version when handed CPU tensors
(the CPU tests hold both against the JAX package) and launches the CUDA
kernel, or raises, for CUDA tensors.  Each counts its CUDA launches in a
`launches` attribute, by card index in `cards` (wavefront_dp also by
shape, in `shapes`).  The kernels
are built at first launch
(kernels/cuda_lib.py), never at import.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from telr_tpu_torch.kernels.dp import GLOBAL, LOCAL, NEG_INF, DPParams

# Step-budget ladder: S_pad, the padded step count of a batch, is rounded up
# to a rung so a chunk's pairs share one dirs row length.
_S_LADDER = (128, 512, 1280, 2048, 8192, 32768)

# Bytes of direction bytes (n x S_pad x W) one chunk may hold on the device.
# Two chunks are in flight at a time (the next chunk's host prep overlaps the
# current chunk's kernels).
DIRS_BUDGET = 1 << 32


def _sbucket(s: int) -> int:
    for b in _S_LADDER:
        if s <= b:
            return b
    b = _S_LADDER[-1]
    while b < s:
        b *= 2
    return b


def _target_m_arr(q, t, width, gq, gt):
    """The guide-following band-base target (build_schedule lines 89-105,
    kept in numpy for exact np.rint parity) + the even m0."""
    from telr_tpu_torch.kernels.wavefront import _cluster_corrections
    lq, lt = len(q), len(t)
    S = lq + lt
    if gq is None or len(gq) == 0:
        gqa = np.array([0, lq], dtype=np.float64)
        gta = np.array([0, lt], dtype=np.float64)
    else:
        gqa = np.concatenate([[0], np.asarray(gq, np.float64), [lq]])
        gta = np.concatenate([[0], np.asarray(gt, np.float64), [lt]])
        keep = np.concatenate([[True], np.diff(gqa) > 0])
        gqa, gta = gqa[keep], np.maximum.accumulate(gta[keep])
    o_guide = np.interp(np.arange(S + 1, dtype=np.float64),
                        gqa + gta, gta - gqa)
    tm = np.rint(o_guide).astype(np.int64) - width
    if width >= 64:
        tm = _cluster_corrections(tm, S, width)
    m0 = int(tm[0])
    if m0 % 2 != 0:
        m0 += 1
    return tm, m0


def prepare_wavefront_batch(
    pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
    width: int,
    guides: Optional[Sequence] = None,
):
    """Host-side batch preparation: numpy target-m per pair, then ONE
    threaded native call (telr_wave_prepare_batch) does the parity walk of
    every pair's band schedule and the packing into the wire arrays.

    Returns (meta, init, scal): meta (G, 8, S_pad) int8, init (G, 16, W)
    int8 and scal (G, 8, 8) int32 with G = ceil(n / 8), equal to the first
    G groups of the JAX package's prepare_wavefront_batch(light=True)."""
    import ctypes
    from telr_tpu_torch.io import native as _native
    nat = _native.load()
    if nat is None or not hasattr(nat, "telr_wave_prepare_batch"):
        raise RuntimeError("the native host engine (native/libtelr_native"
                           ".so) is required to prepare wavefront batches")
    n = len(pairs)
    G = -(-n // 8)
    S_max = max((len(q) + len(t) for q, t in pairs), default=0)
    S_pad = _sbucket(S_max)
    PAD = np.int8(1 | (4 << 1) | (4 << 4))
    meta = np.full((G, 8, S_pad), PAD, dtype=np.int8)
    init = np.full((G, 16, width), 4, dtype=np.int8)
    scal = np.zeros((G, 8, 8), dtype=np.int32)
    if not n:
        return meta, init, scal
    # the native call also fills the JAX kernel's step-region tables; the
    # CUDA kernels read none of them, so they land in scratch buffers
    lohi = np.empty((n, 2), dtype=np.int64)
    alt_blocks = np.empty((n, S_pad // 8), dtype=np.uint8)
    q_ptrs = np.empty(n, np.int64)
    q_lens = np.empty(n, np.int64)
    t_ptrs = np.empty(n, np.int64)
    t_lens = np.empty(n, np.int64)
    tm_ptrs = np.empty(n, np.int64)
    m0s = np.empty(n, np.int64)
    keep = []          # keep contiguous copies + tm arrays alive
    for i, (q, t) in enumerate(pairs):
        gq, gt = (guides[i] if guides is not None and
                  guides[i] is not None else (None, None))
        tm, m0 = _target_m_arr(q, t, width, gq, gt)
        if not q.flags.c_contiguous:
            q = np.ascontiguousarray(q)
        if not t.flags.c_contiguous:
            t = np.ascontiguousarray(t)
        keep.append((q, t, tm))
        q_ptrs[i] = q.ctypes.data
        q_lens[i] = len(q)
        t_ptrs[i] = t.ctypes.data
        t_lens[i] = len(t)
        tm_ptrs[i] = tm.ctypes.data
        m0s[i] = m0
    nat.telr_wave_prepare_batch(
        q_ptrs.ctypes.data, q_lens.ctypes.data, t_ptrs.ctypes.data,
        t_lens.ctypes.data, tm_ptrs.ctypes.data, m0s.ctypes.data,
        ctypes.c_int64(n), ctypes.c_int64(width),
        ctypes.c_int64(S_pad), meta.ctypes.data, init.ctypes.data,
        scal.ctypes.data, lohi.ctypes.data, alt_blocks.ctypes.data)
    return meta, init, scal

# ----------------------------------------------------------------------
# Kernel 1: the wavefront DP

def _check_wire(meta, init, scal, n: int, width: int):
    import torch
    if meta.dtype != torch.int8 or init.dtype != torch.int8 \
            or scal.dtype != torch.int32:
        raise TypeError("wire arrays must be meta int8, init int8, "
                        "scal int32")
    G = meta.shape[0]
    if meta.dim() != 3 or meta.shape[1] != 8 \
            or tuple(init.shape) != (G, 16, width) \
            or tuple(scal.shape) != (G, 8, 8):
        raise ValueError(f"bad wire shapes {tuple(meta.shape)} "
                         f"{tuple(init.shape)} {tuple(scal.shape)} for "
                         f"width {width}")
    if not 0 <= n <= G * 8:
        raise ValueError(f"n={n} exceeds the {G * 8} wire rows")
    if meta.shape[2] % 4 != 0:
        raise ValueError("S_pad must be a multiple of 4")
    if not (meta.device == init.device == scal.device):
        raise ValueError("wire arrays must share one device")
    for t in (meta, init, scal):
        if not t.is_contiguous():
            raise ValueError("wire arrays must be contiguous")


def wavefront_dp(meta, init, scal, n: int, width: int, mode: int,
                 params: DPParams, tb: bool = True,
                 lanes: Optional[int] = None):
    """Banded anti-diagonal Gotoh DP of the first n pairs of a wire batch.

    meta (G, 8, S_pad) int8, init (G, 16, W) int8 and scal (G, 8, 8) int32
    are prepare_wavefront_batch's wire arrays as tensors on one device.
    Returns (gscore, best, best_s, best_p, dirs) — four (n,) int32 tensors
    and the (n, S_pad, W) int8 direction bytes, row s-1 holding step s —
    or (gscore, best) with tb=False.  Rows past a pair's lq + lt steps are
    left unwritten on CUDA: no walk reads them.  lanes: the band lanes a
    CUDA thread owns (None: cuda_lib.pick_cells' choice for n pairs); it
    moves the time, never a bit of the result."""
    import torch
    _check_wire(meta, init, scal, n, width)
    if meta.device.type == "cpu":
        return _wavefront_dp_plain(meta, init, scal, n, width, mode,
                                   params.tuple(), tb)
    if meta.device.type != "cuda":
        raise ValueError(f"unsupported device {meta.device}")
    from telr_tpu_torch.kernels import cuda_lib
    options = cuda_lib.cell_options("wavefront_dp", width)
    if not options:
        raise ValueError(f"the CUDA wavefront DP has no width {width}")
    if lanes is None:
        lanes = cuda_lib.pick_cells(width, n, options)
    elif lanes not in options:
        raise ValueError(f"the CUDA wavefront DP has no {lanes} lanes a "
                         f"thread at width {width}")
    lib = cuda_lib.load()
    S_pad = meta.shape[2]
    dev = meta.device
    gscore = torch.empty(n, dtype=torch.int32, device=dev)
    best = torch.empty(n, dtype=torch.int32, device=dev)
    if tb:
        best_s = torch.empty(n, dtype=torch.int32, device=dev)
        best_p = torch.empty(n, dtype=torch.int32, device=dev)
        dirs = torch.empty((n, S_pad, width), dtype=torch.int8, device=dev)
        ptrs = (best_s.data_ptr(), best_p.data_ptr(), dirs.data_ptr())
    else:
        ptrs = (None, None, None)
    ma, mi, go, ge, amb = params.tuple()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.telr_wavefront_dp(
            meta.data_ptr(), init.data_ptr(), scal.data_ptr(), n, S_pad,
            width, lanes, mode, int(tb), ma, mi, go, ge, amb,
            gscore.data_ptr(),
            best.data_ptr(), *ptrs, stream)
    cuda_lib.check(rc, "wavefront_dp")
    cuda_lib.count_launch(wavefront_dp, dev)
    key = (width, mode, S_pad, n)
    wavefront_dp.shapes[key] = wavefront_dp.shapes.get(key, 0) + 1
    if tb:
        return gscore, best, best_s, best_p, dirs
    return gscore, best


wavefront_dp.launches = 0
wavefront_dp.cards = {}    # CUDA launches by card index
wavefront_dp.shapes = {}   # CUDA launches by (width, mode, S_pad, pairs)


def _wavefront_dp_plain(meta, init, scal, n, width, mode, params_tuple, tb):
    """wavefront_dp in plain torch ops, vectorised over (pairs, band lanes)
    with a loop over steps; every pair runs to the batch's longest step
    count (cells past a pair's own lq + lt are all outside its matrix)."""
    import torch
    ma, mi, go, ge, amb = params_tuple
    dev = meta.device
    W = width
    S_pad = meta.shape[2]
    i32 = torch.int32
    neg = NEG_INF
    meta = meta.reshape(-1, S_pad)[:n].to(i32)
    QW = init[:, 0:8].reshape(-1, W)[:n].to(i32)
    TW = init[:, 8:16].reshape(-1, W)[:n].to(i32)
    sc_ = scal.reshape(-1, 8)[:n]
    lq, lt = sc_[:, 0:1], sc_[:, 1:2]
    i0, j0 = sc_[:, 2:3].clone(), sc_[:, 3:4].clone()
    lane = torch.arange(W, dtype=i32, device=dev)[None, :]
    negcol = torch.full((n, 1), neg, dtype=i32, device=dev)
    full_neg = torch.full((n, W), neg, dtype=i32, device=dev)
    H1 = torch.where((i0 - lane == 0) & (j0 + lane == 0),
                     torch.zeros((), dtype=i32, device=dev), full_neg)
    H2, I1, D1 = full_neg, full_neg, full_neg
    hb = torch.zeros((n, W), dtype=i32, device=dev)
    sb = torch.zeros((n, W), dtype=i32, device=dev)
    gb = full_neg
    dprev = torch.zeros((n, 1), dtype=i32, device=dev)
    dirs = (torch.zeros((n, S_pad, W), dtype=torch.int8, device=dev)
            if tb else None)
    n_run = int((lq + lt).max()) if n else 0

    def shl(x):   # x[p] <- x[p+1]
        return torch.cat([x[:, 1:], negcol], dim=1)

    def shr(x):   # x[p] <- x[p-1]
        return torch.cat([negcol, x[:, :-1]], dim=1)

    for s in range(1, n_run + 1):
        mcol = meta[:, s - 1:s]
        dbit = (mcol & 1) == 1
        d = torch.where(dbit, 1, -1).to(i32)
        q_in = (mcol >> 1) & 7
        t_in = (mcol >> 4) & 7
        i0 = i0 + (~dbit).to(i32)
        j0 = j0 + dbit.to(i32)
        QW = torch.where(dbit, QW, torch.cat([q_in, QW[:, :-1]], dim=1))
        TW = torch.where(dbit, torch.cat([TW[:, 1:], t_in], dim=1), TW)
        Hv = torch.where(dbit, shl(H1), H1)
        Iv = torch.where(dbit, shl(I1), I1)
        Hh = torch.where(dbit, H1, shr(H1))
        Dh = torch.where(dbit, D1, shr(D1))
        dd = d + dprev
        Hd = torch.where(dd == 2, shl(H2), torch.where(dd == -2, shr(H2), H2))
        I = torch.maximum(Hv - (go + ge), Iv - ge)
        D = torch.maximum(Hh - (go + ge), Dh - ge)
        sc = torch.where((QW == 4) | (TW >= 4), amb,
                         torch.where(QW == TW, ma, -mi)).to(i32)
        Hdg = Hd + sc
        H = torch.maximum(Hdg, torch.maximum(I, D))
        if mode == LOCAL:
            H = H.clamp_min(0)
        i_vec = i0 - lane
        j_vec = j0 + lane
        if mode == LOCAL:
            b_i = b_j = torch.zeros_like(H)
        else:
            b_i = -(go + ge * i_vec)
            b_j = -(go + ge * j_vec)
        H = torch.where((i_vec == 0) & (j_vec == 0), 0,
                        torch.where(i_vec == 0, b_j,
                                    torch.where(j_vec == 0, b_i, H))).to(i32)
        valid = (i_vec >= 0) & (i_vec <= lq) & (j_vec >= 0) & (j_vec <= lt)
        H = torch.where(valid, H, neg)
        I = torch.where(valid, I, neg)
        D = torch.where(valid, D, neg)
        inner = valid & (i_vec >= 1) & (j_vec >= 1)
        if mode == GLOBAL:
            at_end = inner & (i_vec == lq) & (j_vec == lt)
            gb = torch.where(at_end, torch.maximum(gb, H), gb)
        else:
            # strict >: the earliest step wins per lane
            take = torch.where(inner, H, neg) > hb
            hb = torch.where(take, H, hb)
            sb = torch.where(take, s, sb)
        if tb:
            choice = torch.where(H == Hdg, 0, torch.where(H == D, 1, 2))
            if mode == LOCAL:
                choice = torch.where(H == 0, 3, choice)
            choice = torch.where((i_vec <= 0) | (j_vec <= 0), 3, choice)
            dext = (D != Hh - (go + ge)) & (D > neg // 2)
            iext = (I != Hv - (go + ge)) & (I > neg // 2)
            dirs[:, s - 1] = (choice | dext.to(choice.dtype) * 4
                              | iext.to(choice.dtype) * 8).to(torch.int8)
        H2, H1, I1, D1 = H1, H, I, D
        dprev = d
    gbest = gb.max(dim=1).values if n else torch.zeros(0, dtype=i32,
                                                      device=dev)
    if mode != GLOBAL and n:
        best = hb.max(dim=1).values
        # the lowest lane among the maxima, then that lane's step
        arg = torch.where(hb == best[:, None], lane, 1 << 28).min(dim=1).values
        best_s = sb.gather(1, arg[:, None].long())[:, 0]
        best_p = arg.to(i32)
    else:
        best = gbest
        best_s = torch.zeros_like(gbest)
        best_p = torch.zeros_like(gbest)
    if tb:
        return gbest, best, best_s, best_p, dirs
    return gbest, best


# ----------------------------------------------------------------------
# Kernel 2: the traceback walk

def wavefront_walk(dirs, meta, scal, gscore, best, best_s, best_p,
                   mode: int):
    """Walk each pair's direction bytes back from its start cell.

    dirs (n, S_pad, W) int8 and the (n,) int32 DP outputs come from
    wavefront_dp on the wire arrays meta/scal (same device).  The start cell
    is (lq, lt) for GLOBAL, else the best cell (best_s, best_p); best_s == 0
    means the empty alignment won and the walk starts at (0, 0).  Returns
    `packed`, the (S_pad/4, n) uint8 op codes (0=M, 1=D, 2=I, 3=none) of
    sweep position s at row S_pad - s, four per byte, and `small`, the
    (7, n) int32 stack [gscore, best, fi, fj, bad, si, sj].  `bad` flags a
    walk that left the band or met a STOP byte outside LOCAL."""
    import torch
    n, S_pad, W = dirs.shape
    if dirs.dtype != torch.int8 or not dirs.is_contiguous():
        raise TypeError("dirs must be a contiguous int8 tensor")
    if tuple(meta.shape[1:]) != (8, S_pad) or meta.shape[0] * 8 < n \
            or tuple(scal.shape) != (meta.shape[0], 8, 8):
        raise ValueError("meta / scal do not match dirs")
    if meta.dtype != torch.int8 or scal.dtype != torch.int32 \
            or not (meta.is_contiguous() and scal.is_contiguous()):
        raise TypeError("meta / scal must be contiguous int8 / int32")
    if not meta.device == scal.device == dirs.device:
        raise ValueError("dirs, meta and scal must share one device")
    for t in (gscore, best, best_s, best_p):
        if t.dtype != torch.int32 or tuple(t.shape) != (n,) \
                or t.device != dirs.device:
            raise ValueError("DP outputs must be (n,) int32 on dirs' device")
    if dirs.device.type == "cpu":
        return _wavefront_walk_plain(dirs, meta, scal, gscore, best, best_s,
                                     best_p, mode)
    if dirs.device.type != "cuda":
        raise ValueError(f"unsupported device {dirs.device}")
    from telr_tpu_torch.kernels import cuda_lib
    lib = cuda_lib.load()
    dev = dirs.device
    packed = torch.full((S_pad // 4, n), 0xFF, dtype=torch.uint8, device=dev)
    small = torch.empty((7, n), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.telr_wavefront_walk(
            dirs.data_ptr(), meta.data_ptr(), scal.data_ptr(),
            gscore.data_ptr(), best.data_ptr(), best_s.data_ptr(),
            best_p.data_ptr(), n, S_pad, W, mode, packed.data_ptr(),
            small.data_ptr(), stream)
    cuda_lib.check(rc, "wavefront_walk")
    cuda_lib.count_launch(wavefront_walk, dev)
    return packed, small


wavefront_walk.launches = 0
wavefront_walk.cards = {}


def _wavefront_walk_plain(dirs, meta, scal, gscore, best, best_s, best_p,
                          mode):
    """wavefront_walk in plain torch ops: the anti-diagonal sweep of the
    JAX package, s from the highest start step down to 1, every pair acting
    where its own i + j equals the sweep position."""
    import torch
    n, S_pad, W = dirs.shape
    dev = dirs.device
    i32 = torch.int32
    drift = (meta.reshape(-1, S_pad)[:n].to(i32) & 1) * 2 - 1
    sc_ = scal.reshape(-1, 8)[:n]
    m0 = (sc_[:, 3] - sc_[:, 2])[:, None]               # m0 = j0 - i0
    m_arr = torch.cat([m0, m0 + torch.cumsum(drift, dim=1, dtype=i32)],
                      dim=1)
    lq, lt = sc_[:, 0], sc_[:, 1]
    if mode == GLOBAL:
        si, sj = lq.clone(), lt.clone()
    else:
        m_s = m_arr.gather(1, best_s[:, None].long())[:, 0]
        o = m_s + 2 * best_p
        zero = torch.zeros_like(best_s)
        si = torch.where(best_s == 0, zero,
                         torch.div(best_s - o, 2, rounding_mode="floor"))
        sj = torch.where(best_s == 0, zero,
                         torch.div(best_s + o, 2, rounding_mode="floor"))
    i, j = si.clone(), sj.clone()
    st = torch.zeros(n, dtype=i32, device=dev)           # 0=H, 1=D, 2=I
    stopped = torch.zeros(n, dtype=torch.bool, device=dev)
    bad = torch.zeros(n, dtype=torch.bool, device=dev)
    ops = torch.full((S_pad, n), 3, dtype=torch.uint8, device=dev)
    idx = torch.arange(n, device=dev)
    s_top = int((si + sj).max()) if n else 0
    for s in range(s_top, 0, -1):
        active = (i + j == s) & (i > 0) & (j > 0) & ~stopped
        off = j - i - m_arr[:, s]
        p_raw = torch.div(off, 2, rounding_mode="floor")
        bad = bad | (active & (((off & 1) != 0) | (p_raw < 0)
                               | (p_raw >= W)))
        p = p_raw.clamp(0, W - 1)
        byte = dirs[idx, s - 1, p.long()].to(i32)
        ch = byte & 3
        dext = (byte & 4) != 0
        iext = (byte & 8) != 0
        in_h = st == 0
        stop_now = in_h & (ch == 3)
        if mode != LOCAL:
            bad = bad | (active & stop_now)
        do_m = in_h & (ch == 0)
        do_d = ((in_h & (ch == 1)) | (st == 1)) & ~stop_now & ~do_m
        do_i = ((in_h & (ch == 2)) | (st == 2)) & ~stop_now & ~do_m & ~do_d
        op = torch.where(do_m, 0, torch.where(do_d, 1, torch.where(do_i, 2,
                                                                    3)))
        ops[S_pad - s] = torch.where(active, op, 3).to(torch.uint8)
        i = torch.where(active & (do_m | do_i), i - 1, i)
        j = torch.where(active & (do_m | do_d), j - 1, j)
        nst = torch.where(do_m, 0, torch.where(
            do_d, torch.where(dext, 1, 0),
            torch.where(do_i, torch.where(iext, 2, 0), st)))
        st = torch.where(active, nst, st).to(i32)
        stopped = stopped | (active & stop_now)
    packed = (ops[0::4] | (ops[1::4] << 2) | (ops[2::4] << 4)
              | (ops[3::4] << 6))
    small = torch.stack([gscore, best, i, j, bad.to(i32), si, sj]).to(i32)
    return packed, small


# ----------------------------------------------------------------------
# Full alignment: prep -> DP kernel -> walk kernel -> native decode

def wavefront_align(
    pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
    width: int,
    mode: int,
    params: DPParams,
    guides: Optional[Sequence] = None,
    cigar_arrays: bool = False,
    device=None,
):
    """Full alignment through the wavefront kernels: scores + CIGARs.

    Returns a list of dicts like dp.align_pair: score, cigar, qstart, qend,
    tstart, tend (or a "failed" entry when the walk left the band).
    cigar_arrays=True returns "cigar" in the (ops uint8, lens int32) array
    form that dp.cigar_to_arrays accepts verbatim.  device: where the DP and
    the walk run (None: the first CUDA card, raising when there is none;
    "cpu" runs the kernels' plain versions)."""
    import torch
    from telr_tpu_torch.io import native as _native
    from telr_tpu_torch.kernels.dp import arrays_to_cigar
    from telr_tpu_torch.utils import hoststats
    from telr_tpu_torch.utils.device import resolve
    dev = resolve(device)
    if pairs and not _native.has_wave_decode():
        raise RuntimeError("the native host engine (native/libtelr_native"
                           ".so) is required to decode wavefront tracebacks")
    # chunks hold pairs of one step bucket, as many as the dirs budget
    # (~S_pad x W bytes per pair) allows
    by_bucket: Dict[int, List[int]] = {}
    for i in range(len(pairs)):
        by_bucket.setdefault(
            _sbucket(len(pairs[i][0]) + len(pairs[i][1])), []).append(i)
    chunks: List[List[int]] = []
    for sp in sorted(by_bucket):
        idxs = by_bucket[sp]
        step = max(1, DIRS_BUDGET // (sp * width))
        chunks += [idxs[lo:lo + step] for lo in range(0, len(idxs), step)]

    def _launch(sel):
        cp = [pairs[i] for i in sel]
        cg = [guides[i] for i in sel] if guides is not None else None
        with hoststats.timer("wave_prep"):
            meta, init, scal = prepare_wavefront_batch(cp, width, cg)
        # the launch's work, read off its wire arrays (scal holds each
        # pair's lq and lt): `steps` x `width` cells computed, one block a
        # pair over its own lq + lt steps (csrc/wavefront_dp.cu), in a
        # direction buffer of n x S_pad x width
        s_pad = meta.shape[2]
        steps = int(scal.reshape(-1, 8)[:len(sel), :2].sum())
        with hoststats.timer("wave_launch", pairs=len(sel), steps=steps,
                             width=width, S_pad=s_pad,
                             useful_cells=steps * width,
                             launched_cells=len(sel) * s_pad * width):
            meta = torch.from_numpy(meta).to(dev)
            init = torch.from_numpy(init).to(dev)
            scal = torch.from_numpy(scal).to(dev)
            g, b, bs, bp, dirs = wavefront_dp(meta, init, scal, len(sel),
                                              width, mode, params, tb=True)
            packed, small = wavefront_walk(dirs, meta, scal, g, b, bs, bp,
                                           mode)
        return sel, packed, small

    out: List[Optional[dict]] = [None] * len(pairs)

    def _collect(item):
        sel, packed, small = item
        with hoststats.timer("wave_device_wait"):
            packed = packed.cpu().numpy()
            small = small.cpu().numpy()
        t0 = time.perf_counter()
        g, b, fi, fj, bad, si_a, sj_a = small
        offsets, opsc, lensc = _native.wave_decode_batch(
            packed, fi, fj, bad, mode != LOCAL)
        for k in range(len(sel)):
            if bad[k]:
                out[sel[k]] = {"score": NEG_INF, "cigar": [], "qstart": 0,
                               "tstart": 0, "qend": 0, "tend": 0,
                               "failed": True}
                continue
            cig = (opsc[offsets[k]:offsets[k + 1]],
                   lensc[offsets[k]:offsets[k + 1]])
            if not cigar_arrays:
                cig = arrays_to_cigar(cig)
            if mode != LOCAL:
                ei = ej = 0
            else:
                ei, ej = int(fi[k]), int(fj[k])
            out[sel[k]] = {
                "score": int(g[k]) if mode == GLOBAL else int(b[k]),
                "cigar": cig, "qstart": ei, "tstart": ej,
                "qend": int(si_a[k]), "tend": int(sj_a[k])}
        hoststats.add("wave_decode", time.perf_counter() - t0, start=t0)

    # the next chunk's host prep overlaps the current chunk's kernels: the
    # launches return at once and only the copy back waits for the device
    pending = None
    for sel in chunks:
        item = _launch(sel)
        if pending is not None:
            _collect(pending)
        pending = item
    if pending is not None:
        _collect(pending)
    return out
