// Row-banded affine-gap (Gotoh) DP: a pair is owned by as many threads as the
// launch's size calls for, from one warp to the 32 warps of a block.
//
// Replaces: telr_tpu/kernels/pallas_dp.py::_scores_kernel, launched by
// pallas_dp_scores (the TB=false instance: gscore and best per pair, no
// direction bytes).  The TB=true instance also writes one direction byte per
// band cell (choice | 4*D-ext | 8*I-ext) as dirs[pair][i-1][p] and the best
// cell (besti, bestp): what telr_tpu/kernels/dp.py::_banded_dp_single gives,
// the DP that the mesh runner (dist/exec.py::sharded_dp_runner) puts on the
// device, where csrc/rowband_walk.cu then walks the bytes.  Both are bit for
// bit the recurrence of kernels/hopper_dp.py's plain version.
//
// Recurrence: row i (query base i-1) holds W target columns j = off[i] + p.
// Row i reads row i-1 shifted by d = off[i] - off[i-1] (0 <= d <= W, checked
// by the wrapper): H_diag[p] = Hprev[p+d-1], H_up[p] = Hprev[p+d].  The
// horizontal gap D is an exclusive max-plus prefix scan over the band:
// D[p] = max_{p'<p}(Hnod[p'] + ge*p') - go - ge - ge*(p-1), exact for affine
// gaps.
//
// What bounds it on an H100: integer operations (~54 a cell with direction
// bytes) against one byte written per cell; and, per pair, latency: a pair's
// rows are a dependent chain with two hand-overs a row (the previous row
// shifted by d, then the scan over this row).  Which of the two binds a
// launch depends on how many pairs it holds.
//
// What the design does about it:
//   * Cells a thread (LPT, 1 to 16) is the launch's choice
//     (kernels/cuda_lib.py::pick_cells).  Few pairs leave the card empty: the
//     row is shortest with many threads a pair, two block barriers a row.
//     Many pairs fill it: 16 cells a thread do the least work per cell, and
//     a band of 512 is then one warp, whose hand-overs are shuffles and
//     __syncwarp, no block barrier at all.  The callers size a launch for the
//     card (dp.WALK_DIRS_BUDGET), not for host memory, so the mesh path's
//     launches are the large kind.
//   * The scan over the warps' totals is a few independent reads of shared
//     memory, not a second shuffle scan.
//   * Shared memory without bank conflicts at any shift.  H and I of the
//     previous row (16 x W bytes for both rows) are stored cell-major (cell k
//     of thread t at k*T + t), so the read of position p + d is
//     lane-consecutive for every d.
//   * Target codes live in a register, 4 bits a cell, and where a thread has
//     four cells or more they move with the band: a row that moves by one or
//     two shifts them by as many nibbles and takes the next thread's low
//     nibbles by one shuffle, and only the last lane of a warp loads new
//     codes.  Other rows load theirs.  q, off and those loads are issued a
//     row ahead and used after the row's work.
//   * A warp whose cells all lie on target bases (1 <= j <= tlen) skips the
//     edge corrections; the results are the general path's.
//   * A thread's direction bytes leave as one store of LPT bytes, contiguous
//     across the warp.
//   * The -inf guards (> kNegHalf) and the unguarded open_cand stay exactly
//     as in the plain version; max on int32 is exact and associative, so the
//     scan's order cannot change a bit.  The per-thread best (value, row,
//     position) stays in registers and is reduced once, after the loop; a
//     pair stops at its own qlen rows (later dirs rows stay unwritten: no
//     traceback reads them).
// Tensor cores, TMA and clusters have no work here: an integer max-plus
// recurrence on 16 x W bytes of state per pair.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int kNegInf = -(1 << 30);
constexpr int kNegHalf = -(1 << 29);
constexpr int kGlobal = 0;
constexpr int kLocal = 2;
constexpr unsigned kFull = 0xffffffffu;

// target code of band cell j (matrix column j, base j-1); 5 outside [0, tlen)
__device__ __forceinline__ int t_code(const int8_t* __restrict__ t, int j,
                                      int tlen, int lt) {
  const int idx = j - 1;
  return (idx >= 0 && idx < tlen && idx < lt) ? t[idx] : 5;
}

__host__ __device__ constexpr int log2_of(int n) {
  return n <= 1 ? 0 : 1 + log2_of(n / 2);
}

// (value, row, position): higher value, then earlier row, then lower position
__device__ __forceinline__ bool better(int ov, int oi, int op, int cv, int ci,
                                       int cp) {
  return ov > cv || (ov == cv && (oi < ci || (oi == ci && op < cp)));
}

template <int LPT, int WARPS, bool TB>
__global__ void __launch_bounds__(32 * WARPS)
rowband_dp_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ t,
                  const int32_t* __restrict__ off,
                  const int32_t* __restrict__ qlen_in,
                  const int32_t* __restrict__ tlen_in, int lq, int lt,
                  int mode, int ma, int mi, int go, int ge, int amb,
                  int32_t* __restrict__ gscore_out,
                  int32_t* __restrict__ best_out,
                  int32_t* __restrict__ besti_out,
                  int32_t* __restrict__ bestp_out,
                  uint8_t* __restrict__ dirs) {
  constexpr int T = 32 * WARPS;   // threads of the pair
  constexpr int W = T * LPT;
  constexpr int LOG = log2_of(LPT);
  // a thread's target codes, 4 bits a cell
  using code_t = std::conditional_t<(LPT > 8), uint64_t, uint32_t>;
  constexpr code_t kCodeMask =
      4 * LPT >= 8 * sizeof(code_t)
          ? ~code_t(0)
          : static_cast<code_t>((uint64_t(1) << (4 * LPT)) - 1);
  // the codes move with the band by a shift and a shuffle where a thread has
  // cells enough and the band moves by at most two; else they are loaded
  constexpr bool kShiftCodes = LPT >= 4;
  // cell-major: band position x = thread * LPT + cell sits at cell * T + thread
  extern __shared__ int smem[];
  int* hbuf = smem;               // 2 x W: H of rows i-1 and i
  int* ibuf = smem + 2 * W;       // 2 x W: I of rows i-1 and i
  __shared__ int edge[WARPS];     // last Hnod of each warp
  __shared__ int wtot[WARPS];     // scan totals of the warps
  __shared__ int red[3][WARPS];   // the final reduction's warp results

  const int pair = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int p0 = tid * LPT;
  const int8_t* qrow = q + static_cast<size_t>(pair) * lq;
  const int8_t* trow = t + static_cast<size_t>(pair) * lt;
  const int32_t* orow = off + static_cast<size_t>(pair) * (lq + 1);
  const int qlen = qlen_in[pair];
  const int tlen = tlen_in[pair];
  const int n_rows = min(qlen, lq);
  const int gap1 = go + ge;

  auto sync = [&]() {
    if (WARPS == 1)
      __syncwarp();
    else
      __syncthreads();
  };
  auto pack_codes = [](const int (&raw)[LPT]) {
    code_t c = 0;
#pragma unroll
    for (int k = 0; k < LPT; ++k) c |= static_cast<code_t>(raw[k]) << (4 * k);
    return c;
  };

  // row 0
  const int off0 = orow[0];
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    const int j0 = off0 + p0 + k;
    int h0 = mode == kLocal ? 0 : (j0 == 0 ? 0 : -(go + ge * j0));
    if (j0 > tlen) h0 = kNegInf;
    hbuf[k * T + tid] = h0;
    ibuf[k * T + tid] = kNegInf;
  }
  int bv = mode == kGlobal ? kNegInf : 0, bi = 0, bp = 0;

  // operands of row 1, and the offset of row 2, fetched ahead
  int off_prev = off0;
  int off_cur = lq >= 1 ? orow[1] : off0;
  int off_nxt = lq >= 2 ? orow[2] : off_cur;
  int q_cur = n_rows >= 1 ? qrow[0] : 4;
  code_t tc;
  {
    int raw[LPT];
#pragma unroll
    for (int k = 0; k < LPT; ++k)
      raw[k] = t_code(trow, off_cur + p0 + k, tlen, lt);
    tc = pack_codes(raw);
  }
  sync();

  for (int i = 1; i <= n_rows; ++i) {
    const int* Hp = hbuf + ((i - 1) & 1) * W;
    const int* Ip = ibuf + ((i - 1) & 1) * W;
    int* Hn = hbuf + (i & 1) * W;
    int* In = ibuf + (i & 1) * W;

    // row i+1's operands, asked for while row i computes and used after it
    int q_nxt = 4, off_nxt2 = off_nxt;
    // the codes move dn cells into row i+1
    const int dn = i < n_rows ? off_nxt - off_cur : 0;
    const bool shift_codes = kShiftCodes && dn <= 2;
    int raw[LPT];            // row i+1's codes where they are loaded
    int in_a = 0, in_b = 0;  // else the codes entering at the warp's last lane
    if (i < n_rows) {
      q_nxt = qrow[i];
      if (i + 2 <= lq) off_nxt2 = orow[i + 2];
      if (!shift_codes) {
#pragma unroll
        for (int k = 0; k < LPT; ++k)
          raw[k] = t_code(trow, off_nxt + p0 + k, tlen, lt);
      } else if (lane == 31 && dn > 0) {
        if (dn == 2) in_a = t_code(trow, off_nxt + p0 + LPT - 2, tlen, lt);
        in_b = t_code(trow, off_nxt + p0 + LPT - 1, tlen, lt);
      }
    }

    const int d = off_cur - off_prev;
    int hnod[LPT], icur[LPT], diag[LPT];
    unsigned iext = 0;
    int hd;
    {
      // Hprev[p0 + d - 1]: the diagonal predecessor of the first cell
      const int e = d - 1;
      const int src = tid + (e >> LOG);   // arithmetic shift: e may be -1
      hd = (src >= 0 && src < T) ? Hp[(e & (LPT - 1)) * T + src] : kNegInf;
    }
    int run = kNegInf;   // running max of g over this thread's cells
    // every cell of the warp lies on a target base (1 <= j <= tlen): the
    // edge corrections fall away, the results are the general path's
    // (decided per warp, so that no warp runs both paths)
    const bool inside = __all_sync(
        kFull, off_cur + p0 >= 1 && off_cur + p0 + LPT - 1 <= tlen);
    auto phase1 = [&](auto inside_tag) {
      constexpr bool INSIDE = decltype(inside_tag)::value;
#pragma unroll
      for (int k = 0; k < LPT; ++k) {
        const int p = p0 + k;
        const int e = k + d;
        const int src = tid + (e >> LOG);
        const int at = (e & (LPT - 1)) * T + src;
        const int h_up = src < T ? Hp[at] : kNegInf;
        const int i_up = src < T ? Ip[at] : kNegInf;
        const int i_open = h_up > kNegHalf ? h_up - gap1 : kNegInf;
        const int i_ex = i_up > kNegHalf ? i_up - ge : kNegInf;
        const int ic = max(i_open, i_ex);
        if (ic != i_open && ic > kNegHalf) iext |= 1u << k;
        const int c = static_cast<int>((tc >> (4 * k)) & 15);
        const int sc = (q_cur == 4 || c >= 4) ? amb : (c == q_cur ? ma : -mi);
        const int dg = hd > kNegHalf ? hd + sc : kNegInf;
        hd = h_up;   // the next cell's diagonal predecessor
        int hn = max(dg, ic);
        if (mode == kLocal) hn = max(hn, 0);
        // edge corrections before the horizontal pass: column 0 is
        // vertical-only, columns outside the target are -inf
        if (!INSIDE) {
          const int j = off_cur + p;
          if (j == 0)
            hn = mode == kLocal ? max(ic, 0) : ic;
          else if (j < 1 || j > tlen)
            hn = kNegInf;
        }
        icur[k] = ic;
        diag[k] = dg;
        hnod[k] = hn;
        run = max(run, hn > kNegHalf ? hn + ge * p - gap1 : kNegInf);
      }
    };
    if (inside)
      phase1(std::true_type{});
    else
      phase1(std::false_type{});

    // exclusive max scan of the thread totals: over the warp by shuffles,
    // over the warps through shared memory
    int incl = run;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int o = __shfl_up_sync(kFull, incl, s);
      if (lane >= s) incl = max(incl, o);
    }
    int excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = kNegInf;
    // Hnod[p0 - 1]: the open_cand operand of this thread's first cell
    int h_left = __shfl_up_sync(kFull, hnod[LPT - 1], 1);
    if (WARPS > 1) {
      if (lane == 31) {
        wtot[warp] = incl;
        edge[warp] = hnod[LPT - 1];
      }
      __syncthreads();
      // the maximum over the warps before this one: a few independent loads
      // where the warps are few, else one load a lane and a butterfly
      if constexpr (WARPS <= 8) {
#pragma unroll
        for (int w = 0; w < WARPS - 1; ++w) {
          const int v = wtot[w];
          if (w < warp) excl = max(excl, v);
        }
      } else {
        int v = lane < warp ? wtot[lane] : kNegInf;   // warp <= 31 lanes
#pragma unroll
        for (int s = 16; s > 0; s >>= 1)
          v = max(v, __shfl_xor_sync(kFull, v, s));
        excl = max(excl, v);
      }
      if (lane == 0 && warp > 0) h_left = edge[warp - 1];
    }

    uint32_t pk[(LPT + 3) / 4];
#pragma unroll
    for (int k = 0; k < (LPT + 3) / 4; ++k) pk[k] = 0;
    int m_excl = excl;   // max of g over every cell left of this one
    auto phase2 = [&](auto inside_tag) {
      constexpr bool INSIDE = decltype(inside_tag)::value;
#pragma unroll
      for (int k = 0; k < LPT; ++k) {
        const int p = p0 + k;
        const int j = off_cur + p;
        const bool at_zero = !INSIDE && j == 0;
        const bool in_t = INSIDE || (j >= 1 && j <= tlen);
        int dc = m_excl > kNegHalf ? m_excl - ge * (p - 1) : kNegInf;
        if (at_zero || !in_t) dc = kNegInf;
        const int hc = max(hnod[k], dc);
        if (TB) {
          const int open_cand = p == 0 ? kNegInf : h_left - gap1;  // unguarded
          const bool dext = dc != open_cand && dc > kNegHalf;
          int choice = hc == diag[k] ? 0 : (hc == dc ? 1 : 2);
          if (at_zero) choice = 2;
          if (mode == kLocal && hc == 0) choice = 3;
          pk[k >> 2] |= static_cast<uint32_t>(choice | (dext ? 4 : 0) |
                                              ((iext >> k) & 1u) * 8u)
                        << (8 * (k & 3));
        }
        h_left = hnod[k];
        m_excl = max(m_excl,
                     hnod[k] > kNegHalf ? hnod[k] + ge * p - gap1 : kNegInf);
        Hn[k * T + tid] = hc;
        In[k * T + tid] = icur[k];
        // positions ascend within a thread and rows ascend in the loop, so a
        // strict > keeps the earliest row and its lowest position
        if ((in_t || at_zero) && hc > bv) {
          bv = hc;
          bi = i;
          bp = p;
        }
      }
    };
    if (inside)
      phase2(std::true_type{});
    else
      phase2(std::false_type{});
    if (TB) {
      uint8_t* drow =
          dirs + (static_cast<size_t>(pair) * lq + (i - 1)) * W + p0;
      if constexpr (LPT == 1)
        *drow = static_cast<uint8_t>(pk[0]);
      else if constexpr (LPT == 2)
        *reinterpret_cast<uint16_t*>(drow) = static_cast<uint16_t>(pk[0]);
      else if constexpr (LPT == 4)
        *reinterpret_cast<uint32_t*>(drow) = pk[0];
      else if constexpr (LPT == 8)
        *reinterpret_cast<uint2*>(drow) = make_uint2(pk[0], pk[1]);
      else
        *reinterpret_cast<uint4*>(drow) =
            make_uint4(pk[0], pk[1], pk[2], pk[3]);
    }

    // the codes of row i+1: loaded, or this row's moved dn cells down the
    // band, the next thread's first dn cells entering at the top
    if (dn > 0) {
      if (!shift_codes) {
        tc = pack_codes(raw);
      } else {
        code_t nb = __shfl_down_sync(kFull, tc, 1);
        if (lane == 31)
          nb = static_cast<code_t>(dn == 2 ? (in_a | (in_b << 4)) : in_b);
        tc = ((tc >> (4 * dn)) | (nb << (4 * (LPT - dn)))) & kCodeMask;
      }
    }
    off_prev = off_cur;
    off_cur = off_nxt;
    off_nxt = off_nxt2;
    q_cur = q_nxt;
    sync();
  }

  // rows past qlen pass H through unshifted, so the last computed row is
  // what the padded final offset off[lq] indexes
  if (tid == 0) {
    const int p_end = tlen - orow[lq];
    gscore_out[pair] =
        (p_end >= 0 && p_end < W)
            ? hbuf[(n_rows & 1) * W + (p_end & (LPT - 1)) * T + (p_end >> LOG)]
            : kNegInf;
  }

  // one reduction over the threads: highest value, then earliest row, then
  // lowest position
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const int ov = __shfl_xor_sync(kFull, bv, s);
    const int oi = __shfl_xor_sync(kFull, bi, s);
    const int op = __shfl_xor_sync(kFull, bp, s);
    if (better(ov, oi, op, bv, bi, bp)) {
      bv = ov;
      bi = oi;
      bp = op;
    }
  }
  if (WARPS > 1) {
    if (lane == 0) {
      red[0][warp] = bv;
      red[1][warp] = bi;
      red[2][warp] = bp;
    }
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < WARPS; ++w) {
        if (better(red[0][w], red[1][w], red[2][w], bv, bi, bp)) {
          bv = red[0][w];
          bi = red[1][w];
          bp = red[2][w];
        }
      }
    }
  }
  if (tid == 0) {
    best_out[pair] = bv;
    if (TB) {
      besti_out[pair] = bi;
      bestp_out[pair] = bp;
    }
  }
}

template <int LPT, int WARPS, bool TB>
cudaError_t launch(const int8_t* q, const int8_t* t, const int32_t* off,
                   const int32_t* qlen, const int32_t* tlen, int n, int lq,
                   int lt, int mode, int ma, int mi, int go, int ge, int amb,
                   int32_t* gscore, int32_t* best, int32_t* besti,
                   int32_t* bestp, uint8_t* dirs, cudaStream_t stream) {
  static_assert(LPT == 1 || LPT == 2 || LPT == 4 || LPT == 8 || LPT == 16,
                "cells a thread: a power of two, at most 16");
  // 16 x W bytes: H and I of two rows (over the 48 KB default from W = 4096)
  constexpr size_t smem = 4 * static_cast<size_t>(32 * WARPS * LPT) *
                          sizeof(int);
  auto kern = rowband_dp_kernel<LPT, WARPS, TB>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<n, 32 * WARPS, smem, stream>>>(q, t, off, qlen, tlen, lq, lt, mode,
                                        ma, mi, go, ge, amb, gscore, best,
                                        besti, bestp, dirs);
  return cudaGetLastError();
}

// The instances: for each band width the cells a thread of its two thread
// lengths, the most threads a pair (few pairs: the shortest dependent chain a
// row) and the fewest (many pairs: the least work a cell).  The wrapper reads
// them through telr_rowband_dp_cells and chooses by the launch's pairs.
#define TELR_RB_WIDTHS(X)                                                  \
  X(64, 1, 2) X(128, 1, 4) X(256, 1, 8) X(512, 2, 16) X(1024, 4, 16)       \
  X(2048, 8, 16) X(4096, 8, 16) X(8192, 8, 16)

template <bool TB>
cudaError_t dispatch(const int8_t* q, const int8_t* t, const int32_t* off,
                     const int32_t* qlen, const int32_t* tlen, int n, int lq,
                     int lt, int width, int cells, int mode, int ma, int mi,
                     int go, int ge, int amb, int32_t* gscore, int32_t* best,
                     int32_t* besti, int32_t* bestp, uint8_t* dirs,
                     cudaStream_t stream) {
#define TELR_RB_CASE(WIDTH, SHORT, LONG)                                     \
  case WIDTH * 32 + SHORT:                                                   \
    return launch<SHORT, WIDTH / (32 * SHORT), TB>(                          \
        q, t, off, qlen, tlen, n, lq, lt, mode, ma, mi, go, ge, amb, gscore, \
        best, besti, bestp, dirs, stream);                                   \
  case WIDTH * 32 + LONG:                                                    \
    return launch<LONG, WIDTH / (32 * LONG), TB>(                            \
        q, t, off, qlen, tlen, n, lq, lt, mode, ma, mi, go, ge, amb, gscore, \
        best, besti, bestp, dirs, stream);
  switch (width * 32 + cells) {   // width, cells a thread
    TELR_RB_WIDTHS(TELR_RB_CASE)
    default:
      return cudaErrorInvalidValue;
  }
#undef TELR_RB_CASE
}

}  // namespace

// The cells a thread of a width's instance with the most (longest == 0) or
// the fewest threads a pair; 0 for a width that has none.
extern "C" int telr_rowband_dp_cells(int width, int longest) {
#define TELR_RB_CELLS(WIDTH, SHORT, LONG) \
  case WIDTH:                             \
    return longest ? LONG : SHORT;
  switch (width) {
    TELR_RB_WIDTHS(TELR_RB_CELLS)
    default:
      return 0;
  }
#undef TELR_RB_CELLS
}

// Plain C entry point (bound with ctypes).  q (n, lq) int8, t (n, lt) int8,
// off (n, lq+1) int32, qlen / tlen (n,) int32, all contiguous on the current
// device.  `cells` is the number of neighbouring band cells a thread owns
// (width / cells threads a pair).  gscore and best (n,) int32 are always
// written; besti, bestp and dirs (n, lq, width) uint8 only when tb != 0 (dirs
// rows past a pair's qlen stay unwritten).  Returns cudaGetLastError() of the
// launch (cudaErrorInvalidValue for an unsupported width or cells).
extern "C" int telr_rowband_dp(const void* q, const void* t, const void* off,
                               const void* qlen, const void* tlen, int n,
                               int lq, int lt, int width, int cells, int mode,
                               int tb, int ma, int mi, int go, int ge,
                               int amb, void* gscore, void* best,
                               void* besti, void* bestp, void* dirs,
                               void* stream) {
  if (n == 0) return 0;
  auto qq = static_cast<const int8_t*>(q);
  auto tt = static_cast<const int8_t*>(t);
  auto oo = static_cast<const int32_t*>(off);
  auto ql = static_cast<const int32_t*>(qlen);
  auto tl = static_cast<const int32_t*>(tlen);
  auto gs = static_cast<int32_t*>(gscore);
  auto bs = static_cast<int32_t*>(best);
  auto st = static_cast<cudaStream_t>(stream);
  if (tb)
    return dispatch<true>(qq, tt, oo, ql, tl, n, lq, lt, width, cells, mode,
                          ma, mi, go, ge, amb, gs, bs,
                          static_cast<int32_t*>(besti),
                          static_cast<int32_t*>(bestp),
                          static_cast<uint8_t*>(dirs), st);
  return dispatch<false>(qq, tt, oo, ql, tl, n, lq, lt, width, cells, mode,
                         ma, mi, go, ge, amb, gs, bs, nullptr, nullptr,
                         nullptr, st);
}
