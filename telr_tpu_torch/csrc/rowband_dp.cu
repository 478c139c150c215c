// Row-banded affine-gap (Gotoh) DP, one thread block per (query, target) pair.
//
// Replaces: telr_tpu/kernels/pallas_dp.py::_scores_kernel, launched by
// pallas_dp_scores (the TB=false instance: gscore and best per pair, no
// direction bytes).  The TB=true instance also writes one direction byte per
// band cell (choice | 4*D-ext | 8*I-ext) as dirs[pair][i-1][p] and the best
// cell (besti, bestp): what telr_tpu/kernels/dp.py::_banded_dp_single gives,
// the DP that the mesh runner (dist/exec.py::sharded_dp_runner) puts on the
// device.  Both are bit for bit the recurrence of kernels/hopper_dp.py's
// plain version.
//
// Recurrence: row i (query base i-1) holds W target columns j = off[i] + p.
// Row i reads row i-1 shifted by d = off[i] - off[i-1] (0 <= d <= W, checked
// by the wrapper): H_diag[p] = Hprev[p+d-1], H_up[p] = Hprev[p+d].  The
// horizontal gap D is an exclusive max-plus prefix scan over the band:
// D[p] = max_{p'<p}(Hnod[p'] + ge*p') - go - ge - ge*(p-1), exact for affine
// gaps.
//
// What bounds it on an H100: operations, not bytes.  A pair's rows are a
// dependent chain, so only the W band positions of one row run in parallel;
// a row costs ~60 integer operations per cell plus a block-wide scan and two
// block barriers, against one direction byte per cell written (TB=true) and
// about one byte per row read.
//
// What the design does about it: the previous row's H and I live in shared
// memory (double-buffered, 16*W bytes, sized from W and not from Lq), so the
// data-dependent shift is an index and nothing but the direction bytes
// leaves the SM.  Each thread owns LPT neighbouring band positions, so the
// scan is a short serial pass in registers, one warp-shuffle scan of the
// thread totals and one shuffle scan of the warp totals, and the direction
// bytes of a thread go out as one store.  q, off and the target window of
// the next row are fetched one row ahead, into registers.  The per-thread
// best (value, row, position) stays in registers and is reduced once, after
// the loop; a pair stops at its own qlen rows (later dirs rows stay
// unwritten: no traceback reads them).  max on int32 is exact and
// associative, so the scan's order cannot change a bit.

#include <cstdint>
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

// threads per block = W / LPT; the widest band of each LPT sets the bound
template <int LPT>
constexpr int kMaxThreads = LPT == 8 ? 1024 : (LPT == 4 ? 512 : 256);

template <int LPT, bool TB>
__global__ void __launch_bounds__(kMaxThreads<LPT>)
rowband_dp_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ t,
                  const int32_t* __restrict__ off,
                  const int32_t* __restrict__ qlen_in,
                  const int32_t* __restrict__ tlen_in, int lq, int lt, int W,
                  int mode, int ma, int mi, int go, int ge, int amb,
                  int32_t* __restrict__ gscore_out,
                  int32_t* __restrict__ best_out,
                  int32_t* __restrict__ besti_out,
                  int32_t* __restrict__ bestp_out,
                  uint8_t* __restrict__ dirs) {
  extern __shared__ int smem[];
  int* hbuf = smem;            // 2 x W: H of rows i-1 and i
  int* ibuf = hbuf + 2 * W;    // 2 x W: I of rows i-1 and i
  // last Hnod of each thread: the open_cand operand of the next thread's p0
  __shared__ int edge[kMaxThreads<LPT>];
  __shared__ int wtot[32];     // scan totals of the warps

  const int pair = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int p0 = tid * LPT;
  const int8_t* qrow = q + static_cast<size_t>(pair) * lq;
  const int8_t* trow = t + static_cast<size_t>(pair) * lt;
  const int32_t* orow = off + static_cast<size_t>(pair) * (lq + 1);
  const int qlen = qlen_in[pair];
  const int tlen = tlen_in[pair];
  const int n_rows = min(qlen, lq);
  const int gap1 = go + ge;

  // row 0
  const int off0 = orow[0];
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    const int p = p0 + k;
    const int j0 = off0 + p;
    int h0 = mode == kLocal ? 0 : (j0 == 0 ? 0 : -(go + ge * j0));
    if (j0 > tlen) h0 = kNegInf;
    hbuf[p] = h0;
    ibuf[p] = kNegInf;
  }
  int bv = mode == kGlobal ? kNegInf : 0, bi = 0, bp = 0;

  // operands of row 1, and the offset of row 2, fetched ahead
  int off_prev = off0;
  int off_cur = lq >= 1 ? orow[1] : off0;
  int off_nxt = lq >= 2 ? orow[2] : off_cur;
  int q_cur = n_rows >= 1 ? qrow[0] : 4;
  int tc[LPT];
#pragma unroll
  for (int k = 0; k < LPT; ++k)
    tc[k] = t_code(trow, off_cur + p0 + k, tlen, lt);
  __syncthreads();

  for (int i = 1; i <= n_rows; ++i) {
    const int* Hp = hbuf + ((i - 1) & 1) * W;
    const int* Ip = ibuf + ((i - 1) & 1) * W;
    int* Hn = hbuf + (i & 1) * W;
    int* In = ibuf + (i & 1) * W;

    // fetch row i+1's operands while row i computes
    int q_nxt = 4, off_nxt2 = off_nxt, tn[LPT];
#pragma unroll
    for (int k = 0; k < LPT; ++k) tn[k] = 5;
    if (i < n_rows) {
      q_nxt = qrow[i];
      if (i + 2 <= lq) off_nxt2 = orow[i + 2];
#pragma unroll
      for (int k = 0; k < LPT; ++k)
        tn[k] = t_code(trow, off_nxt + p0 + k, tlen, lt);
    }

    const int d = off_cur - off_prev;
    int hnod[LPT], icur[LPT], diag[LPT], g[LPT];
    bool iext[LPT];
    int hd = (p0 + d - 1 >= 0 && p0 + d - 1 < W) ? Hp[p0 + d - 1] : kNegInf;
    int run = kNegInf;   // inclusive running max of g over this thread's cells
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      const int p = p0 + k;
      const int src = p + d;
      const int h_up = src < W ? Hp[src] : kNegInf;
      const int i_up = src < W ? Ip[src] : kNegInf;
      const int i_open = h_up > kNegHalf ? h_up - gap1 : kNegInf;
      const int i_ex = i_up > kNegHalf ? i_up - ge : kNegInf;
      const int ic = max(i_open, i_ex);
      iext[k] = ic != i_open && ic > kNegHalf;
      const int sc = (q_cur == 4 || tc[k] >= 4) ? amb
                                                : (tc[k] == q_cur ? ma : -mi);
      const int dg = hd > kNegHalf ? hd + sc : kNegInf;
      hd = h_up;   // the next cell's diagonal predecessor
      int hn = max(dg, ic);
      if (mode == kLocal) hn = max(hn, 0);
      // edge corrections before the horizontal pass: column 0 is
      // vertical-only, columns outside the target are -inf
      const int j = off_cur + p;
      if (j == 0)
        hn = mode == kLocal ? max(ic, 0) : ic;
      else if (j < 1 || j > tlen)
        hn = kNegInf;
      icur[k] = ic;
      diag[k] = dg;
      hnod[k] = hn;
      g[k] = run;   // exclusive within the thread, for now
      run = max(run, hn > kNegHalf ? hn + ge * p - gap1 : kNegInf);
    }
    edge[tid] = hnod[LPT - 1];

    // block-wide exclusive max scan of the thread totals
    int incl = run;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int o = __shfl_up_sync(kFull, incl, s);
      if (lane >= s) incl = max(incl, o);
    }
    int excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = kNegInf;
    if (lane == 31) wtot[warp] = incl;
    __syncthreads();
    {
      const int nwarps = (nthreads + 31) >> 5;
      int w = lane < nwarps ? wtot[lane] : kNegInf;
#pragma unroll
      for (int s = 1; s < 32; s <<= 1) {
        const int o = __shfl_up_sync(kFull, w, s);
        if (lane >= s) w = max(w, o);
      }
      const int wpre = __shfl_sync(kFull, w, warp > 0 ? warp - 1 : 0);
      if (warp > 0) excl = max(excl, wpre);
    }
    int h_left = tid > 0 ? edge[tid - 1] : 0;   // Hnod[p0-1]; unused at p=0

    uint64_t packed = 0;
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      const int p = p0 + k;
      const int j = off_cur + p;
      const bool at_zero = j == 0;
      const bool in_t = j >= 1 && j <= tlen;
      const int m_excl = max(excl, g[k]);
      int dc = m_excl > kNegHalf ? m_excl - ge * (p - 1) : kNegInf;
      if (at_zero || !in_t) dc = kNegInf;
      const int hc = max(hnod[k], dc);
      if (TB) {
        const int open_cand = p == 0 ? kNegInf : h_left - gap1;  // unguarded
        const bool dext = dc != open_cand && dc > kNegHalf;
        int choice = hc == diag[k] ? 0 : (hc == dc ? 1 : 2);
        if (at_zero) choice = 2;
        if (mode == kLocal && hc == 0) choice = 3;
        packed |= static_cast<uint64_t>(choice | (dext ? 4 : 0) |
                                        (iext[k] ? 8 : 0))
                  << (8 * k);
      }
      h_left = hnod[k];
      Hn[p] = hc;
      In[p] = icur[k];
      // positions ascend within a thread and rows ascend in the loop, so a
      // strict > keeps the earliest row and its lowest position
      if ((in_t || at_zero) && hc > bv) {
        bv = hc;
        bi = i;
        bp = p;
      }
    }
    if (TB) {
      uint8_t* drow = dirs + (static_cast<size_t>(pair) * lq + (i - 1)) * W + p0;
      if (LPT == 1)
        *drow = static_cast<uint8_t>(packed);
      else if (LPT == 2)
        *reinterpret_cast<uint16_t*>(drow) = static_cast<uint16_t>(packed);
      else if (LPT == 4)
        *reinterpret_cast<uint32_t*>(drow) = static_cast<uint32_t>(packed);
      else
        *reinterpret_cast<uint64_t*>(drow) = packed;
    }

    off_prev = off_cur;
    off_cur = off_nxt;
    off_nxt = off_nxt2;
    q_cur = q_nxt;
#pragma unroll
    for (int k = 0; k < LPT; ++k) tc[k] = tn[k];
    __syncthreads();
  }

  // rows past qlen pass H through unshifted, so the last computed row is
  // what the padded final offset off[lq] indexes
  const int* Hl = hbuf + (n_rows & 1) * W;
  if (tid == 0) {
    const int p_end = tlen - orow[lq];
    gscore_out[pair] = (p_end >= 0 && p_end < W) ? Hl[p_end] : kNegInf;
  }

  // one reduction over the threads: highest value, then earliest row, then
  // lowest position (the buffers of the other row parity are free now)
  int* rv = ibuf;
  int* ri = ibuf + W;
  int* rp = hbuf + ((n_rows + 1) & 1) * W;
  rv[tid] = bv;
  ri[tid] = bi;
  rp[tid] = bp;
  __syncthreads();
  for (int half = nthreads >> 1; half > 0; half >>= 1) {
    if (tid < half) {
      const int ov = rv[tid + half], oi = ri[tid + half], op = rp[tid + half];
      const int cv = rv[tid], ci = ri[tid], cp = rp[tid];
      if (ov > cv || (ov == cv && (oi < ci || (oi == ci && op < cp)))) {
        rv[tid] = ov;
        ri[tid] = oi;
        rp[tid] = op;
      }
    }
    __syncthreads();
  }
  if (tid == 0) {
    best_out[pair] = rv[0];
    if (TB) {
      besti_out[pair] = ri[0];
      bestp_out[pair] = rp[0];
    }
  }
}

template <int LPT, bool TB>
cudaError_t launch(const int8_t* q, const int8_t* t, const int32_t* off,
                   const int32_t* qlen, const int32_t* tlen, int n, int lq,
                   int lt, int width, int mode, int ma, int mi, int go, int ge,
                   int amb, int32_t* gscore, int32_t* best, int32_t* besti,
                   int32_t* bestp, uint8_t* dirs, cudaStream_t stream) {
  const size_t smem = 4 * static_cast<size_t>(width) * sizeof(int);
  auto kern = rowband_dp_kernel<LPT, TB>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<n, width / LPT, smem, stream>>>(q, t, off, qlen, tlen, lq, lt, width,
                                         mode, ma, mi, go, ge, amb, gscore,
                                         best, besti, bestp, dirs);
  return cudaGetLastError();
}

template <bool TB>
cudaError_t dispatch(const int8_t* q, const int8_t* t, const int32_t* off,
                     const int32_t* qlen, const int32_t* tlen, int n, int lq,
                     int lt, int width, int mode, int ma, int mi, int go,
                     int ge, int amb, int32_t* gscore, int32_t* best,
                     int32_t* besti, int32_t* bestp, uint8_t* dirs,
                     cudaStream_t stream) {
#define TELR_RB_CASE(WIDTH, LPT)                                             \
  case WIDTH:                                                                \
    return launch<LPT, TB>(q, t, off, qlen, tlen, n, lq, lt, width, mode,    \
                           ma, mi, go, ge, amb, gscore, best, besti, bestp,  \
                           dirs, stream);
  switch (width) {   // threads per block = width / LPT
    TELR_RB_CASE(64, 1)
    TELR_RB_CASE(128, 1)
    TELR_RB_CASE(256, 1)
    TELR_RB_CASE(512, 2)
    TELR_RB_CASE(1024, 4)
    TELR_RB_CASE(2048, 4)
    TELR_RB_CASE(4096, 8)
    TELR_RB_CASE(8192, 8)
    default:
      return cudaErrorInvalidValue;
  }
#undef TELR_RB_CASE
}

}  // namespace

// Plain C entry point (bound with ctypes).  q (n, lq) int8, t (n, lt) int8,
// off (n, lq+1) int32, qlen / tlen (n,) int32, all contiguous on the current
// device.  gscore and best (n,) int32 are always written; besti, bestp and
// dirs (n, lq, width) uint8 only when tb != 0 (dirs rows past a pair's qlen
// stay unwritten).  Returns cudaGetLastError() of the launch
// (cudaErrorInvalidValue for an unsupported width).
extern "C" int telr_rowband_dp(const void* q, const void* t, const void* off,
                               const void* qlen, const void* tlen, int n,
                               int lq, int lt, int width, int mode, int tb,
                               int ma, int mi, int go, int ge, int amb,
                               void* gscore, void* best, void* besti,
                               void* bestp, void* dirs, void* stream) {
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
    return dispatch<true>(qq, tt, oo, ql, tl, n, lq, lt, width, mode, ma, mi,
                          go, ge, amb, gs, bs, static_cast<int32_t*>(besti),
                          static_cast<int32_t*>(bestp),
                          static_cast<uint8_t*>(dirs), st);
  return dispatch<false>(qq, tt, oo, ql, tl, n, lq, lt, width, mode, ma, mi,
                         go, ge, amb, gs, bs, nullptr, nullptr, nullptr, st);
}
