"""The row-banded affine-gap DP on an H100: wrapper, kernel launch, plain form.

The counterpart of telr_tpu/kernels/pallas_dp.py.  `rowband_dp` runs the
banded recurrence of kernels/dp.py's module docstring over a batch of padded
(query, target) pairs whose band follows per-row offsets `off`:

  * tb=False — scores only (gscore, best): what pallas_dp_scores computes,
    the DP of the score steps in dist/pipeline.py;
  * tb=True  — also one direction byte per band cell and the best cell
    (besti, bestp): the DP that dist/exec.py's sharded runner puts on the
    device ahead of the host traceback.

Both are one CUDA kernel (csrc/rowband_dp.cu, a template with two
instances).  The wrapper runs the plain PyTorch version below when handed
CPU tensors (the CPU tests hold it against the JAX package) and launches
the kernel, or raises, for CUDA tensors; it counts its CUDA launches in
`rowband_dp.launches`.  The kernel is built at first launch
(kernels/cuda_lib.py), never at import.
"""

from __future__ import annotations

from telr_tpu_torch.kernels.dp import GLOBAL, LOCAL, NEG_INF

# band widths the CUDA kernel is instantiated for (csrc/rowband_dp.cu)
CUDA_WIDTHS = (64, 128, 256, 512, 1024, 2048, 4096, 8192)


def _check_batch(q, t, off, qlen, tlen, width: int):
    """Raise on what the kernel does not take.  The offsets contract is that
    of dp.make_band_offsets / dp.offsets_from_path: starting at >= 0,
    non-decreasing, a per-row step of at most `width`, ending inside the
    padded target.  (jax.lax.dynamic_slice would silently clamp offsets
    outside it; this port refuses them instead.)"""
    import torch
    if q.dtype != torch.int8 or t.dtype != torch.int8:
        raise TypeError("q and t must be int8 code arrays")
    if any(x.dtype != torch.int32 for x in (off, qlen, tlen)):
        raise TypeError("off, qlen and tlen must be int32")
    if q.dim() != 2 or t.dim() != 2 or q.shape[1] < 1:
        raise ValueError(f"bad shapes q {tuple(q.shape)} t {tuple(t.shape)}")
    B, Lq = q.shape
    if t.shape[0] != B or tuple(off.shape) != (B, Lq + 1) \
            or tuple(qlen.shape) != (B,) or tuple(tlen.shape) != (B,):
        raise ValueError(
            f"bad batch shapes q {tuple(q.shape)} t {tuple(t.shape)} off "
            f"{tuple(off.shape)} qlen {tuple(qlen.shape)} tlen "
            f"{tuple(tlen.shape)}")
    if width < 1:
        raise ValueError(f"bad band width {width}")
    for x in (q, t, off, qlen, tlen):
        if x.device != q.device:
            raise ValueError("the batch arrays must share one device")
        if not x.is_contiguous():
            raise ValueError("the batch arrays must be contiguous")
    if B:
        step = off[:, 1:] - off[:, :-1]
        bad = ((step < 0) | (step > width)).any() | (off[:, 0] < 0).any() \
            | (off[:, -1] > t.shape[1]).any()
        if bool(bad):
            raise ValueError(
                "band offsets must start at >= 0, be non-decreasing with a "
                f"per-row step of at most the width ({width}) and end inside "
                "the padded target")


def rowband_dp(q, t, off, qlen, tlen, *, width: int, mode: int,
               params_tuple, tb: bool = True):
    """Row-banded affine-gap DP over a batch of pairs.

    q (B, Lq) int8 codes (4 past qlen), t (B, Lt) int8, off (B, Lq+1) int32
    band offsets, qlen / tlen (B,) int32: tensors on one device.  Returns
    (dirs (B, Lq, W) uint8, gscore, best, besti, bestp) with tb=True and
    (gscore, best) with tb=False, the (B,) results int32.  On CUDA, dirs rows
    past a pair's qlen are left unwritten: no traceback reads them."""
    import torch
    _check_batch(q, t, off, qlen, tlen, width)
    if q.device.type == "cpu":
        return _rowband_dp_plain(q, t, off, qlen, tlen, width, mode,
                                 params_tuple, tb)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if width not in CUDA_WIDTHS:
        raise ValueError(f"the CUDA row-banded DP has no width {width}")
    from telr_tpu_torch.kernels import cuda_lib
    lib = cuda_lib.load()
    dev = q.device
    B, Lq = q.shape
    gscore = torch.empty(B, dtype=torch.int32, device=dev)
    best = torch.empty(B, dtype=torch.int32, device=dev)
    if tb:
        besti = torch.empty(B, dtype=torch.int32, device=dev)
        bestp = torch.empty(B, dtype=torch.int32, device=dev)
        dirs = torch.empty((B, Lq, width), dtype=torch.uint8, device=dev)
        ptrs = (besti.data_ptr(), bestp.data_ptr(), dirs.data_ptr())
    else:
        ptrs = (None, None, None)
    ma, mi, go, ge, amb = params_tuple
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.telr_rowband_dp(
            q.data_ptr(), t.data_ptr(), off.data_ptr(), qlen.data_ptr(),
            tlen.data_ptr(), B, Lq, t.shape[1], width, mode, int(tb),
            ma, mi, go, ge, amb, gscore.data_ptr(), best.data_ptr(), *ptrs,
            stream)
    cuda_lib.check(rc, "rowband_dp")
    rowband_dp.launches += 1
    if tb:
        return dirs, gscore, best, besti, bestp
    return gscore, best


rowband_dp.launches = 0


def _rowband_dp_plain(q, t, off, qlen, tlen, width, mode, params_tuple, tb):
    """rowband_dp in plain torch ops: the batch is the leading dimension, a
    Python loop walks the Lq rows, each row is int32 tensor ops over
    (B, width).  Every row of the padded batch is computed, so dirs is
    defined past qlen too (rows there leave H unchanged)."""
    import torch
    ma, mi, go, ge, amb = params_tuple
    dev = q.device
    B, Lq = q.shape
    Lt = t.shape[1]
    W = width
    i32 = torch.int32
    half = NEG_INF // 2

    neg = torch.full((), NEG_INF, dtype=i32, device=dev)
    zero = torch.zeros((), dtype=i32, device=dev)
    p_idx = torch.arange(W, dtype=i32, device=dev)[None, :]
    p64 = p_idx.to(torch.int64)
    win64 = torch.arange(W + 1, dtype=torch.int64, device=dev)[None, :]
    g_add = ge * p_idx - go - ge
    d_sub = ge * (p_idx - 1)
    tl = tlen[:, None]

    # row 0
    j0 = off[:, :1] + p_idx
    if mode == LOCAL:
        h_row0 = torch.zeros((B, W), dtype=i32, device=dev)
    else:
        h_row0 = torch.where(j0 == 0, zero, -(go + ge * j0)).to(i32)
    # index m of hbuf / ibuf holds band value m - 1 of the previous row;
    # the sentinel at 0 and the W + 1 at the tail stay -inf, so a window
    # shifted by d in [0, W] reads -inf outside the band
    hbuf = torch.full((B, 2 * W + 2), NEG_INF, dtype=i32, device=dev)
    ibuf = torch.full((B, 2 * W + 2), NEG_INF, dtype=i32, device=dev)
    h_prev = hbuf[:, 1:W + 1]
    i_prev = ibuf[:, 1:W + 1]
    h_prev.copy_(torch.where(j0 <= tl, h_row0, neg))

    # target codes: tpad[b, 1 + k] = t[b, k] for k < tlen, 5 elsewhere, so
    # the band of row i is tpad[b, off_i : off_i + W]
    tpad = torch.full((B, Lt + W + 2), 5, dtype=i32, device=dev)
    k_idx = torch.arange(Lt, dtype=i32, device=dev)[None, :]
    tpad[:, 1:Lt + 1] = torch.where(k_idx < tl, t.to(i32), 5)

    best = torch.full((B,), NEG_INF if mode == GLOBAL else 0, dtype=i32,
                      device=dev)
    besti = torch.zeros(B, dtype=i32, device=dev)
    bestp = torch.zeros(B, dtype=i32, device=dev)
    dirs = (torch.empty((B, Lq, W), dtype=torch.uint8, device=dev)
            if tb else None)
    side = torch.full((B, 1), NEG_INF, dtype=i32, device=dev)
    q32 = q.to(i32)
    off64 = off.to(torch.int64)

    for i in range(1, Lq + 1):
        off_i = off[:, i:i + 1]
        d64 = off64[:, i:i + 1] - off64[:, i - 1:i]
        qi = q32[:, i - 1:i]
        t_band = torch.gather(tpad, 1, off64[:, i:i + 1] + p64)
        h_win = torch.gather(hbuf, 1, d64 + win64)
        h_diag, h_up = h_win[:, :W], h_win[:, 1:]
        i_up = torch.gather(ibuf, 1, d64 + 1 + p64)

        i_open = torch.where(h_up > half, h_up - go - ge, neg)
        i_ext = torch.where(i_up > half, i_up - ge, neg)
        i_cur = torch.maximum(i_open, i_ext)

        s = torch.where((qi == 4) | (t_band >= 4), amb,
                        torch.where(t_band == qi, ma, -mi)).to(i32)
        diag = torch.where(h_diag > half, h_diag + s, neg)
        h_nod = torch.maximum(diag, i_cur)
        if mode == LOCAL:
            h_nod = torch.clamp(h_nod, min=0)

        # edge corrections before the horizontal pass, so D opens from true
        # cell values: column 0 is vertical-only, columns outside the target
        # are -inf
        j_col = off_i + p_idx
        in_t = (j_col >= 1) & (j_col <= tl)
        at_zero = j_col == 0
        h_zero = torch.clamp(i_cur, min=0) if mode == LOCAL else i_cur
        h_nod = torch.where(at_zero, h_zero, torch.where(in_t, h_nod, neg))

        # g[p] = Hnod[p] + ge*p - (go + ge): a gap opened after cell p and
        # extended to p' costs go + ge*(p' - p), so
        # D[p'] = max_{p<p'} g[p] - ge*(p' - 1)
        g = torch.where(h_nod > half, h_nod + g_add, neg)
        m = torch.cummax(g, dim=1).values
        m_excl = torch.cat([side, m[:, :-1]], dim=1)
        d_cur = torch.where(m_excl > half, m_excl - d_sub, neg)
        d_cur = torch.where(in_t, d_cur, neg)   # in_t excludes column 0 too
        h_cur = torch.maximum(h_nod, d_cur)

        if tb:
            i_ext_bit = (i_cur != i_open) & (i_cur > half)
            # unguarded on purpose: -inf - go - ge stays distinct from -inf
            open_cand = torch.cat([side, h_nod[:, :-1] - go - ge], dim=1)
            d_ext_bit = (d_cur != open_cand) & (d_cur > half)
            choice = torch.where(h_cur == diag, 0,
                                 torch.where(h_cur == d_cur, 1, 2))
            choice = torch.where(at_zero, 2, choice)
            if mode == LOCAL:
                choice = torch.where(h_cur == 0, 3, choice)
            dirs[:, i - 1] = (choice + 4 * d_ext_bit + 8 * i_ext_bit
                              ).to(torch.uint8)

        # rows past qlen pass H through unshifted
        valid = (qlen >= i)[:, None]
        masked = torch.where((in_t | at_zero) & valid, h_cur, neg)
        h_prev.copy_(torch.where(valid, h_cur, h_prev))
        i_prev.copy_(torch.where(valid, i_cur, neg))

        rb = masked.max(dim=1).values
        take = rb > best
        if tb:
            # the lowest position among the row's maxima
            rbp = torch.where(masked == rb[:, None], p_idx, W).min(
                dim=1).values.to(i32)
            besti = torch.where(take, i, besti).to(i32)
            bestp = torch.where(take, rbp, bestp)
        best = torch.where(take, rb, best)

    p_end = tlen - off[:, Lq]
    p_end_c = p_end.clamp(0, W - 1).to(torch.int64)
    gscore = torch.where((p_end >= 0) & (p_end < W),
                  h_prev.gather(1, p_end_c[:, None])[:, 0], neg)
    if tb:
        return dirs, gscore, best, besti, bestp
    return gscore, best
