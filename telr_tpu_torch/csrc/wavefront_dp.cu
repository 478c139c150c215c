// Banded Gotoh DP along anti-diagonals (the wavefront DP): the band state of
// a pair lives in the registers of one warp (W <= 256) or of the few warps of
// one block.
//
// Replaces: telr_tpu/kernels/pallas_wavefront.py::_kernel, launched by
// _call_kernel (tb=True for the traceback path, tb=False for scores only).
// It takes the same compact wire arrays (meta / init / scal) and computes the
// same outputs bit for bit: gscore, best, best_s, best_p and one direction
// byte per cell (choice | 4*D-ext | 8*I-ext), written per pair as
// dirs[pair][s-1][p] (the (n, S_pad, W) layout).
//
// Recurrence (see telr_tpu_torch/kernels/wavefront.py): cell (i, j) sits at
// step s = i + j and band lane p, with offset j - i = m_s + 2p.  The band
// base m_s drifts by +-1 per step (meta bit 0), so every predecessor is the
// same lane or a +-1 neighbour of the previous one or two steps.
//
// What bounds it on an H100: integer operations (~50 a cell with direction
// bytes) against one byte written per cell; and, per pair, latency: the steps
// are a dependent chain, so a pair's parallelism is its W lanes and the card
// is filled by pairs.
//
// What the design does about it:
//   * Each thread owns LPT neighbouring lanes (1 to 8) and keeps H of the
//     last two steps, I, D and the q / t codes of those lanes in registers.
//     A step needs from outside one edge value per array from
//     the neighbouring thread: a warp shuffle, and between the warps of a
//     wide band a few words of shared memory (double-buffered by the step's
//     parity, so one block barrier a step; none at all where a pair is one
//     warp).  No state array is in shared memory, no neighbour is loaded.
//   * The new H overwrites the registers of H two steps back (the two arrays
//     swap roles from step to step), so nothing is copied.
//   * The code windows are 4 bits a lane in one register each and move one
//     lane per step (q up on a -1 step, t down on a +1 step): a shift and a
//     shuffle.
//   * A thread's LPT direction bytes leave as one 4- or 8-byte store,
//     contiguous across the warp.
//   * The meta bytes are fetched a word (four steps) ahead of use, so no
//     step opens with a dependent global load.
//   * A warp whose lanes are all inner cells of the matrix (most warps at
//     most steps of a narrow band) takes a step without the boundary values,
//     the validity masks and the end-cell test, about half the general
//     step's instructions; the results are the same.
//   * Per-lane strict > for the best (the earliest step wins), the lowest
//     lane among the maxima, the choice order diagonal / D / I, STOP on
//     boundary and LOCAL-zero cells: as in the plain version.  Each pair
//     stops at its own lq + lt steps (rows past it stay unwritten).
//   * How many lanes a thread owns is the launch's choice (`lanes`): few
//     pairs leave the card empty and want many short threads, many pairs fill
//     it and want few long ones (kernels/cuda_lib.py::pick_cells).
// Tensor cores, TMA and clusters have no work here: an integer max-plus
// recurrence on a few KB of state per pair.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNegInf = -(1 << 30);
constexpr int kNegHalf = -(1 << 29);
constexpr int kGlobal = 0;
constexpr int kLocal = 2;
constexpr unsigned kFull = 0xffffffffu;

struct Scores {
  int ma, mi, go, ge, amb, gap1;
};

// The LPT cells of one thread at step s.  H1 is H of step s-1; H2 is H of
// step s-2 on entry and H of step s on return; I1 / D1 are updated in place.
// DBIT: the band base moved +1 (else -1); twice: it moved the same way at
// step s-1 too.  nbH / nbX / nbH2 are the neighbouring thread's edge values
// of H1, of I1 (DBIT) or D1, and of H2: the next thread's first lane when
// DBIT, the previous thread's last lane otherwise, -inf past the band's end.
// INSIDE: every cell of the thread is an inner cell of the matrix (1 <= i <=
// lq, 1 <= j <= lt) and none is the end cell, so the boundary values, the
// validity masks and GLOBAL's end-cell test fall away; the results are the
// general path's.
template <int LPT, bool TB, bool DBIT, bool INSIDE>
__device__ __forceinline__ void wavefront_cells(
    const int (&H1)[LPT], int (&H2)[LPT], int (&I1)[LPT], int (&D1)[LPT],
    int nbH, int nbX, int nbH2, bool twice, uint32_t qcodes, uint32_t tcodes,
    int i0, int j0, int p0, int lq, int lt, int mode, const Scores& sc, int s,
    int (&hbv)[LPT], int (&sbv)[LPT], int& gb, uint32_t (&pk)[(LPT + 3) / 4]) {
  int h2_left = nbH2;   // H2 of lane k-1 as it was on entry
  int d1_left = nbX;    // D1 of lane k-1 as it was on entry
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    const int p = p0 + k;
    const int h2_own = H2[k];
    int Hv, Iv, Hh, Dh, Hd;
    if (DBIT) {
      Hv = k < LPT - 1 ? H1[k + 1 < LPT ? k + 1 : k] : nbH;
      Iv = k < LPT - 1 ? I1[k + 1 < LPT ? k + 1 : k] : nbX;
      Hh = H1[k];
      Dh = D1[k];
      Hd = twice ? (k < LPT - 1 ? H2[k + 1 < LPT ? k + 1 : k] : nbH2) : h2_own;
    } else {
      Hv = H1[k];
      Iv = I1[k];
      Hh = k > 0 ? H1[k > 0 ? k - 1 : 0] : nbH;
      Dh = d1_left;
      Hd = twice ? h2_left : h2_own;
    }
    h2_left = h2_own;
    d1_left = D1[k];
    int I = max(Hv - sc.gap1, Iv - sc.ge);
    int D = max(Hh - sc.gap1, Dh - sc.ge);
    const int qc = static_cast<int>(qcodes >> (4 * k)) & 15;
    const int tc = static_cast<int>(tcodes >> (4 * k)) & 15;
    const int sub = (qc == 4 || tc >= 4) ? sc.amb
                                         : (qc == tc ? sc.ma : -sc.mi);
    const int Hdg = Hd + sub;
    // plain max: nvcc emits the three-way / add-max DPX instructions itself
    // (with the __vimax3_s32 intrinsic here, the LOCAL instance of the
    // inside path came out with D and I swapped in `choice` at 2 and 4 lanes
    // a thread: nvcc 12.9, sm_90a)
    int H = max(Hdg, max(I, D));
    if (mode == kLocal) H = max(H, 0);
    const int iv = i0 - p;
    const int jv = j0 + p;
    if (INSIDE) {
      if (mode != kGlobal && H > hbv[k]) {   // strict: the earliest step wins
        hbv[k] = H;
        if (TB) sbv[k] = s;
      }
    } else {
      if (iv == 0 && jv == 0)
        H = 0;
      else if (iv == 0)
        H = mode == kLocal ? 0 : -(sc.go + sc.ge * jv);
      else if (jv == 0)
        H = mode == kLocal ? 0 : -(sc.go + sc.ge * iv);
      const bool valid = iv >= 0 && iv <= lq && jv >= 0 && jv <= lt;
      if (!valid) {
        H = kNegInf;
        I = kNegInf;
        D = kNegInf;
      }
      const bool inner = valid && iv >= 1 && jv >= 1;
      if (mode == kGlobal) {
        if (inner && iv == lq && jv == lt) gb = max(gb, H);
      } else {
        const int Hm = inner ? H : kNegInf;
        if (Hm > hbv[k]) {   // strict: the earliest step wins per lane
          hbv[k] = Hm;
          if (TB) sbv[k] = s;
        }
      }
    }
    if (TB) {
      int choice = H == Hdg ? 0 : (H == D ? 1 : 2);
      if (mode == kLocal && H == 0) choice = 3;
      if (!INSIDE && (iv <= 0 || jv <= 0)) choice = 3;
      const bool dext = D != Hh - sc.gap1 && D > kNegHalf;
      const bool iext = I != Hv - sc.gap1 && I > kNegHalf;
      pk[k >> 2] |= static_cast<uint32_t>(choice | (dext ? 4 : 0) |
                                          (iext ? 8 : 0))
                    << (8 * (k & 3));
    }
    H2[k] = H;
    I1[k] = I;
    D1[k] = D;
  }
}

// The warps' edge lanes, [step parity][warp]: the first lane's H, I and t
// code, the last lane's H, D and q code.
template <int WARPS>
struct Edges {
  int Hf[2][WARPS], If[2][WARPS], Tf[2][WARPS];
  int Hl[2][WARPS], Dl[2][WARPS], Ql[2][WARPS];
};

// What a thread carries from step to step, beside the two H arrays.
template <int LPT>
struct Band {
  int I1[LPT], D1[LPT], hbv[LPT], sbv[LPT];
  uint32_t qcodes, tcodes;   // 4 bits a lane
  uint32_t mw_cur, mw_nxt;   // the meta bytes of these and the next 4 steps
  int i0, j0, gb;
  int nbH_last;              // the H edge value fetched at the previous step
  bool prev_dbit;
};

struct Pair {
  const uint32_t* mwords;    // the pair's meta row
  int8_t* drow0;             // this thread's bytes of the pair's first dirs row
  int s_pad, lq, lt, mode, p0, lane, warp;
  Scores sc;
};

template <int LPT, int WARPS>
__device__ __forceinline__ void publish(Edges<WARPS>& ex, int buf,
                                        const int (&H)[LPT],
                                        const Band<LPT>& st, const Pair& pr) {
  if (WARPS > 1) {
    if (pr.lane == 0) {
      ex.Hf[buf][pr.warp] = H[0];
      ex.If[buf][pr.warp] = st.I1[0];
      ex.Tf[buf][pr.warp] = static_cast<int>(st.tcodes & 15u);
    }
    if (pr.lane == 31) {
      ex.Hl[buf][pr.warp] = H[LPT - 1];
      ex.Dl[buf][pr.warp] = st.D1[LPT - 1];
      ex.Ql[buf][pr.warp] =
          static_cast<int>((st.qcodes >> (4 * (LPT - 1))) & 15u);
    }
    __syncthreads();
  }
}

// The next thread's first-lane value (x_first: the warps' first lanes);
// `far` is what stands past the band's end.
template <int WARPS>
__device__ __forceinline__ int from_next(int own_first, const int* x_first,
                                         int far, const Pair& pr) {
  int v = __shfl_down_sync(kFull, own_first, 1);
  if (pr.lane == 31)
    v = pr.warp < WARPS - 1 ? x_first[(pr.warp + 1) % WARPS] : far;
  return v;
}

// The previous thread's last-lane value.
template <int WARPS>
__device__ __forceinline__ int from_prev(int own_last, const int* x_last,
                                         int far, const Pair& pr) {
  int v = __shfl_up_sync(kFull, own_last, 1);
  if (pr.lane == 0)
    v = pr.warp > 0 ? x_last[pr.warp > 0 ? pr.warp - 1 : 0] : far;
  return v;
}

// Whether all cells of the warp at step s are inner cells of the matrix and
// none is the end cell (lq, lt), which only the last step holds: lane k of a
// thread is cell (i0 - p0 - k, j0 + p0 + k).  Decided per warp, so that no
// warp runs both paths.
template <int LPT>
__device__ __forceinline__ bool all_inside(int s, const Band<LPT>& st,
                                           const Pair& pr) {
  const int i_hi = st.i0 - pr.p0, j_lo = st.j0 + pr.p0;
  return __all_sync(kFull, i_hi - (LPT - 1) >= 1 && i_hi <= pr.lq &&
                               j_lo >= 1 && j_lo + (LPT - 1) <= pr.lt &&
                               s < pr.lq + pr.lt);
}

// One step: H1 is H of step s-1, H2 is H of step s-2 and becomes H of step s.
template <int LPT, int WARPS, bool TB>
__device__ __forceinline__ void wavefront_step(int s, int (&H1)[LPT],
                                               int (&H2)[LPT], Band<LPT>& st,
                                               const Pair& pr,
                                               Edges<WARPS>& ex) {
  constexpr uint32_t kCodeMask = LPT >= 8 ? 0xffffffffu
                                          : ((1u << (4 * LPT)) - 1u);
  const int b = s - 1;
  if ((b & 3) == 0) {
    st.mw_cur = st.mw_nxt;
    const int w = (b >> 2) + 1;
    if (4 * w < pr.s_pad) st.mw_nxt = pr.mwords[w];
  }
  const int mcol = static_cast<int>((st.mw_cur >> (8 * (b & 3))) & 0xffu);
  const bool dbit = (mcol & 1) != 0;
  const bool twice = s > 1 && dbit == st.prev_dbit;
  const int rd = (s - 1) & 1;   // the edge buffers written at step s-1
  uint32_t pk[(LPT + 3) / 4];
#pragma unroll
  for (int k = 0; k < (LPT + 3) / 4; ++k) pk[k] = 0;
  if (dbit) {
    ++st.j0;
    // the t window moves down a lane; the band's last lane takes the new code
    const int t_in = from_next<WARPS>(static_cast<int>(st.tcodes & 15u),
                                      ex.Tf[rd], (mcol >> 4) & 7, pr);
    st.tcodes = (st.tcodes >> 4) |
                (static_cast<uint32_t>(t_in) << (4 * (LPT - 1)));
    const int nbH = from_next<WARPS>(H1[0], ex.Hf[rd], kNegInf, pr);
    const int nbI = from_next<WARPS>(st.I1[0], ex.If[rd], kNegInf, pr);
    if (all_inside<LPT>(s, st, pr))
      wavefront_cells<LPT, TB, true, true>(
          H1, H2, st.I1, st.D1, nbH, nbI, st.nbH_last, twice, st.qcodes,
          st.tcodes, st.i0, st.j0, pr.p0, pr.lq, pr.lt, pr.mode, pr.sc, s,
          st.hbv, st.sbv, st.gb, pk);
    else
      wavefront_cells<LPT, TB, true, false>(
          H1, H2, st.I1, st.D1, nbH, nbI, st.nbH_last, twice, st.qcodes,
          st.tcodes, st.i0, st.j0, pr.p0, pr.lq, pr.lt, pr.mode, pr.sc, s,
          st.hbv, st.sbv, st.gb, pk);
    st.nbH_last = nbH;
  } else {
    ++st.i0;
    // the q window moves up a lane; the band's first lane takes the new code
    const int q_in = from_prev<WARPS>(
        static_cast<int>((st.qcodes >> (4 * (LPT - 1))) & 15u), ex.Ql[rd],
        (mcol >> 1) & 7, pr);
    st.qcodes = ((st.qcodes << 4) | static_cast<uint32_t>(q_in)) & kCodeMask;
    const int nbH = from_prev<WARPS>(H1[LPT - 1], ex.Hl[rd], kNegInf, pr);
    const int nbD = from_prev<WARPS>(st.D1[LPT - 1], ex.Dl[rd], kNegInf, pr);
    if (all_inside<LPT>(s, st, pr))
      wavefront_cells<LPT, TB, false, true>(
          H1, H2, st.I1, st.D1, nbH, nbD, st.nbH_last, twice, st.qcodes,
          st.tcodes, st.i0, st.j0, pr.p0, pr.lq, pr.lt, pr.mode, pr.sc, s,
          st.hbv, st.sbv, st.gb, pk);
    else
      wavefront_cells<LPT, TB, false, false>(
          H1, H2, st.I1, st.D1, nbH, nbD, st.nbH_last, twice, st.qcodes,
          st.tcodes, st.i0, st.j0, pr.p0, pr.lq, pr.lt, pr.mode, pr.sc, s,
          st.hbv, st.sbv, st.gb, pk);
    st.nbH_last = nbH;
  }
  st.prev_dbit = dbit;
  if (TB) {
    int8_t* drow = pr.drow0 + static_cast<size_t>(s - 1) * (32 * WARPS * LPT);
    if constexpr (LPT == 1)
      *drow = static_cast<int8_t>(pk[0]);
    else if constexpr (LPT == 2)
      *reinterpret_cast<uint16_t*>(drow) = static_cast<uint16_t>(pk[0]);
    else if constexpr (LPT == 4)
      *reinterpret_cast<uint32_t*>(drow) = pk[0];
    else
      *reinterpret_cast<uint2*>(drow) = make_uint2(pk[0], pk[1]);
  }
  publish<LPT, WARPS>(ex, s & 1, H2, st, pr);
}

template <int LPT, int WARPS, bool TB>
__global__ void __launch_bounds__(32 * WARPS)
wavefront_dp_kernel(const int8_t* __restrict__ meta,
                    const int8_t* __restrict__ init,
                    const int32_t* __restrict__ scal, int s_pad, int mode,
                    int ma, int mi, int go, int ge, int amb,
                    int32_t* __restrict__ gscore_out,
                    int32_t* __restrict__ best_out,
                    int32_t* __restrict__ best_s_out,
                    int32_t* __restrict__ best_p_out,
                    int8_t* __restrict__ dirs) {
  static_assert(LPT == 1 || LPT == 2 || LPT == 4 || LPT == 8,
                "lanes a thread: a power of two, at most 8");
  constexpr int T = 32 * WARPS;
  constexpr int W = T * LPT;
  __shared__ Edges<WARPS> ex;
  __shared__ int red[4][WARPS];

  const int pair = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int p0 = tid * LPT;
  const int g = pair >> 3, r = pair & 7;
  const int8_t* qw0 = init + (static_cast<size_t>(g) * 16 + r) * W;
  const int8_t* tw0 = init + (static_cast<size_t>(g) * 16 + 8 + r) * W;
  Pair pr;
  pr.mwords = reinterpret_cast<const uint32_t*>(
      meta + static_cast<size_t>(pair) * s_pad);
  pr.drow0 = TB ? dirs + static_cast<size_t>(pair) * s_pad * W + p0 : nullptr;
  pr.s_pad = s_pad;
  pr.lq = scal[pair * 8 + 0];
  pr.lt = scal[pair * 8 + 1];
  pr.mode = mode;
  pr.p0 = p0;
  pr.lane = lane;
  pr.warp = warp;
  pr.sc = {ma, mi, go, ge, amb, go + ge};
  const int n_steps = min(pr.lq + pr.lt, s_pad);

  // HA / HB: H of the last two steps, swapping roles from step to step
  int HA[LPT], HB[LPT];
  Band<LPT> st;
  st.i0 = scal[pair * 8 + 2];
  st.j0 = scal[pair * 8 + 3];
  st.qcodes = 0;
  st.tcodes = 0;
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    const int p = p0 + k;
    HA[k] = (st.i0 - p == 0 && st.j0 + p == 0) ? 0 : kNegInf;
    HB[k] = kNegInf;
    st.I1[k] = kNegInf;
    st.D1[k] = kNegInf;
    st.hbv[k] = 0;
    st.sbv[k] = 0;
    st.qcodes |= (static_cast<uint32_t>(qw0[p]) & 15u) << (4 * k);
    st.tcodes |= (static_cast<uint32_t>(tw0[p]) & 15u) << (4 * k);
  }
  st.gb = kNegInf;
  st.mw_cur = 0;
  st.mw_nxt = s_pad >= 4 ? pr.mwords[0] : 0u;
  st.prev_dbit = false;
  st.nbH_last = kNegInf;
  publish<LPT, WARPS>(ex, 0, HA, st, pr);

  for (int s = 1; s <= n_steps; s += 2) {
    wavefront_step<LPT, WARPS, TB>(s, HA, HB, st, pr, ex);
    if (s + 1 <= n_steps)
      wavefront_step<LPT, WARPS, TB>(s + 1, HB, HA, st, pr, ex);
  }

  // one cross-lane reduction: max, then the lowest lane among the maxima,
  // then the step of that lane's best
  int bv = kNegInf - 1, bp = 0, bs = 0, gb = st.gb;
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    if (st.hbv[k] > bv) {   // lanes ascend with k: ties keep the lowest lane
      bv = st.hbv[k];
      bp = p0 + k;
      bs = st.sbv[k];
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int ov = __shfl_xor_sync(kFull, bv, o);
    const int op = __shfl_xor_sync(kFull, bp, o);
    const int os = __shfl_xor_sync(kFull, bs, o);
    gb = max(gb, __shfl_xor_sync(kFull, gb, o));
    if (ov > bv || (ov == bv && op < bp)) {
      bv = ov;
      bp = op;
      bs = os;
    }
  }
  if (WARPS > 1) {
    if (lane == 0) {
      red[0][warp] = bv;
      red[1][warp] = bp;
      red[2][warp] = bs;
      red[3][warp] = gb;
    }
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < WARPS; ++w) {
        if (red[0][w] > bv || (red[0][w] == bv && red[1][w] < bp)) {
          bv = red[0][w];
          bp = red[1][w];
          bs = red[2][w];
        }
        gb = max(gb, red[3][w]);
      }
    }
  }
  if (tid == 0) {
    gscore_out[pair] = gb;
    if (mode == kGlobal) {
      best_out[pair] = gb;
      if (TB) {
        best_s_out[pair] = 0;
        best_p_out[pair] = 0;
      }
    } else {
      best_out[pair] = bv;
      if (TB) {
        best_s_out[pair] = bs;
        best_p_out[pair] = bp;
      }
    }
  }
}

template <int LPT, int WARPS, bool TB>
cudaError_t launch(const int8_t* meta, const int8_t* init, const int32_t* scal,
                   int n, int s_pad, int mode, int ma, int mi, int go, int ge,
                   int amb, int32_t* gscore, int32_t* best, int32_t* best_s,
                   int32_t* best_p, int8_t* dirs, cudaStream_t stream) {
  wavefront_dp_kernel<LPT, WARPS, TB><<<n, 32 * WARPS, 0, stream>>>(
      meta, init, scal, s_pad, mode, ma, mi, go, ge, amb, gscore, best,
      best_s, best_p, dirs);
  return cudaGetLastError();
}

// The instances: for each band width the lanes a thread of its two thread
// lengths, the most threads a pair (few pairs: the shortest dependent chain a
// step) and the fewest (many pairs: the least work a cell).  The wrapper
// reads them through telr_wavefront_dp_cells and chooses by the launch's
// pairs.
#define TELR_WF_WIDTHS(X) \
  X(128, 1, 4) X(256, 1, 8) X(512, 1, 8) X(1024, 2, 8) X(2048, 4, 8)

template <bool TB>
cudaError_t dispatch(int width, int lanes, const int8_t* meta,
                     const int8_t* init, const int32_t* scal, int n, int s_pad,
                     int mode, int ma, int mi, int go, int ge, int amb,
                     int32_t* gscore, int32_t* best, int32_t* best_s,
                     int32_t* best_p, int8_t* dirs, cudaStream_t stream) {
#define TELR_WF_CASE(WIDTH, SHORT, LONG)                                     \
  case WIDTH * 16 + SHORT:                                                   \
    return launch<SHORT, WIDTH / (32 * SHORT), TB>(                          \
        meta, init, scal, n, s_pad, mode, ma, mi, go, ge, amb, gscore, best, \
        best_s, best_p, dirs, stream);                                       \
  case WIDTH * 16 + LONG:                                                    \
    return launch<LONG, WIDTH / (32 * LONG), TB>(                            \
        meta, init, scal, n, s_pad, mode, ma, mi, go, ge, amb, gscore, best, \
        best_s, best_p, dirs, stream);
  switch (width * 16 + lanes) {   // width, lanes a thread
    TELR_WF_WIDTHS(TELR_WF_CASE)
    default:
      return cudaErrorInvalidValue;
  }
#undef TELR_WF_CASE
}

}  // namespace

// The lanes a thread of a width's instance with the most (longest == 0) or
// the fewest threads a pair; 0 for a width that has none.
extern "C" int telr_wavefront_dp_cells(int width, int longest) {
#define TELR_WF_CELLS(WIDTH, SHORT, LONG) \
  case WIDTH:                             \
    return longest ? LONG : SHORT;
  switch (width) {
    TELR_WF_WIDTHS(TELR_WF_CELLS)
    default:
      return 0;
  }
#undef TELR_WF_CELLS
}

// Plain C entry point (bound with ctypes).  meta (G*8, s_pad) int8, init
// (G, 16, width) int8, scal (G*8, 8) int32 are the wire arrays; only the
// first n pairs are computed.  s_pad is a multiple of 4.  `lanes` is the
// number of neighbouring band lanes a thread owns (width / lanes threads a
// pair).  dirs (n, s_pad, width) int8 and best_s / best_p are written only
// when tb != 0.  Returns cudaGetLastError() of the launch
// (cudaErrorInvalidValue for an unsupported width or lanes).
extern "C" int telr_wavefront_dp(const void* meta, const void* init,
                                 const void* scal, int n, int s_pad, int width,
                                 int lanes, int mode, int tb, int ma, int mi,
                                 int go, int ge, int amb, void* gscore,
                                 void* best, void* best_s, void* best_p,
                                 void* dirs, void* stream) {
  if (n == 0) return 0;
  auto m = static_cast<const int8_t*>(meta);
  auto in = static_cast<const int8_t*>(init);
  auto sc = static_cast<const int32_t*>(scal);
  auto st = static_cast<cudaStream_t>(stream);
  if (tb)
    return dispatch<true>(width, lanes, m, in, sc, n, s_pad, mode, ma, mi, go,
                          ge, amb, static_cast<int32_t*>(gscore),
                          static_cast<int32_t*>(best),
                          static_cast<int32_t*>(best_s),
                          static_cast<int32_t*>(best_p),
                          static_cast<int8_t*>(dirs), st);
  return dispatch<false>(width, lanes, m, in, sc, n, s_pad, mode, ma, mi, go,
                         ge, amb, static_cast<int32_t*>(gscore),
                         static_cast<int32_t*>(best), nullptr, nullptr,
                         nullptr, st);
}
