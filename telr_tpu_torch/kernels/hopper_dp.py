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
instances).  `rowband_walk` (csrc/rowband_walk.cu) then walks the direction
bytes back from each pair's start cell on the device, as the host walk
(dp.traceback, native telr_traceback) does, and returns 2-bit op codes and a
small scalar stack: what crosses to the host is the alignment, not the
B x Lq x W direction bytes.

Each wrapper runs its plain PyTorch version below when handed CPU tensors
(the CPU tests hold them against the JAX package) and launches its kernel,
or raises, for CUDA tensors; each counts its CUDA launches in a `launches`
attribute, and by card index in `cards`.  The kernels are built at first
launch (kernels/cuda_lib.py), never at import.
"""

from __future__ import annotations

from telr_tpu_torch.kernels.dp import GLOBAL, LOCAL, NEG_INF

# rows of rowband_walk's scalar stack
WALK_GSCORE, WALK_BEST, WALK_EI, WALK_EJ, WALK_BAD, WALK_SI, WALK_SJ, \
    WALK_MARGIN = range(8)

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
               params_tuple, tb: bool = True, cells=None):
    """Row-banded affine-gap DP over a batch of pairs.

    q (B, Lq) int8 codes (4 past qlen), t (B, Lt) int8, off (B, Lq+1) int32
    band offsets, qlen / tlen (B,) int32: tensors on one device.  Returns
    (dirs (B, Lq, W) uint8, gscore, best, besti, bestp) with tb=True and
    (gscore, best) with tb=False, the (B,) results int32.  On CUDA, dirs rows
    past a pair's qlen are left unwritten: no traceback reads them.  cells:
    the band cells a CUDA thread owns (None: cuda_lib.pick_cells' choice for
    B pairs); it moves the time, never a bit of the result."""
    import torch
    _check_batch(q, t, off, qlen, tlen, width)
    if q.device.type == "cpu":
        return _rowband_dp_plain(q, t, off, qlen, tlen, width, mode,
                                 params_tuple, tb)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    from telr_tpu_torch.kernels import cuda_lib
    options = cuda_lib.cell_options("rowband_dp", width)
    if not options:
        raise ValueError(f"the CUDA row-banded DP has no width {width}")
    B, Lq = q.shape
    if cells is None:
        cells = cuda_lib.pick_cells(width, B, options)
    elif cells not in options:
        raise ValueError(f"the CUDA row-banded DP has no {cells} cells a "
                         f"thread at width {width}")
    lib = cuda_lib.load()
    dev = q.device
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
            tlen.data_ptr(), B, Lq, t.shape[1], width, cells, mode, int(tb),
            ma, mi, go, ge, amb, gscore.data_ptr(), best.data_ptr(), *ptrs,
            stream)
    cuda_lib.check(rc, "rowband_dp")
    cuda_lib.count_launch(rowband_dp, dev)
    key = (width, Lq, t.shape[1], mode, bool(tb), B)
    rowband_dp.shapes[key] = rowband_dp.shapes.get(key, 0) + 1
    if tb:
        return dirs, gscore, best, besti, bestp
    return gscore, best


rowband_dp.launches = 0
rowband_dp.cards = {}    # CUDA launches by card index
rowband_dp.shapes = {}   # CUDA launches by (width, Lq, Lt, mode, tb, pairs)


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


# ----------------------------------------------------------------------
# The traceback walk over the row-banded direction bytes

def walk_steps(lq: int, lt: int) -> int:
    """S_pad of a (lq, lt) padded batch: the slots of `packed`, one per
    step s = i + j of the matrix, rounded up to whole bytes."""
    return (lq + lt + 3) // 4 * 4


def rowband_walk(dirs, off, qlen, tlen, gscore, best, besti, bestp, *,
                 lt: int, mode: int):
    """Walk each pair's direction bytes back from its start cell.

    dirs (B, Lq, W) uint8 and the (B,) int32 DP outputs come from
    rowband_dp(tb=True) on the batch with offsets off (B, Lq+1) int32 and
    lengths qlen / tlen (B,) int32, padded target length lt.  The start cell
    is (qlen, tlen) for GLOBAL, else (besti, off[besti] + bestp), on row 0
    when besti == 0.  Returns `packed`, (B, S_pad / 4) uint8 with S_pad =
    walk_steps(Lq, lt): the op (0=M, 1=D, 2=I, 3=none) leaving the cell at
    step s = i + j in slot S_pad - s, four slots a byte, every op of the
    path included (native.wave_decode_batch(packed.T, ..., lead=False)
    decodes it); and `small`, the (8, B) int32 stack [gscore, best, ei, ej,
    bad, si, sj, margin]: (ei, ej) the cell where the alignment begins,
    margin the walk's least distance from a constraining band edge (W when
    none), bad where the host walk would fail (the walk left the band, a
    STOP byte outside LOCAL, a start cell outside the padded matrix)."""
    import torch
    if dirs.dtype != torch.uint8 or dirs.dim() != 3 \
            or not dirs.is_contiguous():
        raise TypeError("dirs must be a contiguous (B, Lq, W) uint8 tensor")
    B, Lq, W = dirs.shape
    if off.dtype != torch.int32 or tuple(off.shape) != (B, Lq + 1) \
            or not off.is_contiguous() or off.device != dirs.device:
        raise ValueError("off must be contiguous (B, Lq+1) int32 on dirs' "
                         "device")
    for x in (qlen, tlen, gscore, best, besti, bestp):
        if x.dtype != torch.int32 or tuple(x.shape) != (B,) \
                or x.device != dirs.device or not x.is_contiguous():
            raise ValueError("lengths and DP outputs must be (B,) int32 on "
                             "dirs' device")
    if lt < 1:
        raise ValueError(f"bad padded target length {lt}")
    S_pad = walk_steps(Lq, lt)
    if dirs.device.type == "cpu":
        return _rowband_walk_plain(dirs, off, qlen, tlen, gscore, best,
                                   besti, bestp, S_pad, mode)
    if dirs.device.type != "cuda":
        raise ValueError(f"unsupported device {dirs.device}")
    from telr_tpu_torch.kernels import cuda_lib
    lib = cuda_lib.load()
    dev = dirs.device
    packed = torch.full((B, S_pad // 4), 0xFF, dtype=torch.uint8, device=dev)
    small = torch.empty((8, B), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.telr_rowband_walk(
            dirs.data_ptr(), off.data_ptr(), qlen.data_ptr(),
            tlen.data_ptr(), gscore.data_ptr(), best.data_ptr(),
            besti.data_ptr(), bestp.data_ptr(), B, Lq, W, S_pad, mode,
            packed.data_ptr(), small.data_ptr(), stream)
    cuda_lib.check(rc, "rowband_walk")
    cuda_lib.count_launch(rowband_walk, dev)
    return packed, small


rowband_walk.launches = 0
rowband_walk.cards = {}


def _rowband_walk_plain(dirs, off, qlen, tlen, gscore, best, besti, bestp,
                        S_pad, mode):
    """rowband_walk in plain torch ops: all pairs take one step of the host
    walk per iteration (a state switch and the op that follows it count as
    one), until the longest walk has ended."""
    import torch
    B, Lq, W = dirs.shape
    dev = dirs.device
    i64 = torch.int64
    off64 = off.to(i64)
    tl = tlen.to(i64)
    if mode == GLOBAL:
        si, sj = qlen.to(i64), tl.clone()
    else:
        si = besti.to(i64)
        o = off64.gather(1, si.clamp(0, Lq)[:, None])[:, 0]
        sj = torch.where(si > 0, o + bestp, bestp.to(i64))
    bad = (si < 0) | (si > Lq) | (sj < 0) | (si + sj > S_pad)
    i, j = si.clone(), sj.clone()
    st = torch.zeros(B, dtype=i64, device=dev)            # 0=H, 1=D, 2=I
    done = bad.clone()
    margin = torch.full((B,), W, dtype=i64, device=dev)
    # one slot per step and a spare column that takes the writes of the
    # pairs with nothing to emit
    ops = torch.full((B, S_pad + 1), 3, dtype=torch.uint8, device=dev)
    flat = dirs.reshape(B, Lq * W)
    n_iter = int((si + sj)[~bad].max()) if bool((~bad).any()) else 0
    for _ in range(n_iter):
        act = ~done & ((i > 0) | (j > 0))
        row0 = act & (i == 0)
        cell = act & (i > 0)
        oi = off64.gather(1, i.clamp(0, Lq)[:, None])[:, 0]
        p = j - oi
        esc = cell & ((p < 0) | (p >= W))       # the walk left the band
        cell = cell & ~esc
        margin = torch.where(cell & (oi > 0) & (p < margin), p, margin)
        right = W - 1 - p
        margin = torch.where(cell & (oi + W <= tl) & (right < margin),
                             right, margin)
        idx = (i - 1).clamp(0, Lq - 1) * W + p.clamp(0, W - 1)
        byte = flat.gather(1, idx[:, None])[:, 0].to(i64)
        ch = byte & 3
        in_h = cell & (st == 0)
        if mode == LOCAL:
            brk = in_h & (ch == 3)
            in_h = in_h & ~brk
        else:
            brk = torch.zeros_like(in_h)
        to_i = in_h & ((j == 0) | (ch == 2))
        to_m = in_h & ~to_i & (ch == 0)
        to_d = in_h & ~to_i & (ch == 1)
        err = in_h & ~to_i & (ch == 3)          # STOP outside LOCAL
        do_d = to_d | (cell & (st == 1))
        do_i = to_i | (cell & (st == 2))
        emit = to_m | do_d | do_i | row0
        op = torch.where(to_m, 0, torch.where(do_i, 2, 1))
        slot = torch.where(emit, S_pad - (i + j), S_pad)
        ops.scatter_(1, slot[:, None], op.to(torch.uint8)[:, None])
        st = torch.where(to_m, 0, torch.where(
            do_d, (byte & 4) // 4, torch.where(do_i, (byte & 8) // 4, st)))
        i = i - (to_m | do_i).to(i64)
        j = j - (to_m | do_d | row0).to(i64)
        bad = bad | esc | err
        done = done | esc | err | brk
    o4 = ops[:, :S_pad].reshape(B, S_pad // 4, 4)
    packed = o4[:, :, 0] | (o4[:, :, 1] << 2) | (o4[:, :, 2] << 4) \
        | (o4[:, :, 3] << 6)
    small = torch.stack([gscore.to(i64), best.to(i64), i, j, bad.to(i64),
                         si, sj, margin]).to(torch.int32)
    return packed.contiguous(), small
