// Traceback walk over the row-banded DP's direction bytes, one warp per pair.
//
// Replaces: the host walk that followed telr_tpu/kernels/dp.py's jitted
// _banded_dp_single on the mesh path (telr_tpu/kernels/dp.py::traceback, in
// C++ native/telr_native.cpp::telr_traceback), which needed every pair's
// Lq x W direction bytes on the host to read at most lq + lt of them.  Here
// the bytes stay on the card; what leaves is 2 bits per alignment column.
//
// It is the host walk step for step: start at (qlen, tlen) for GLOBAL, else
// at (besti, off[besti] + bestp) (besti == 0 starts on row 0); states H / D /
// I; column 0 forces I; row 0 is a run of D; a STOP byte ends a LOCAL walk;
// the band margin is the least distance of a visited cell from a band edge
// that has matrix cells beyond it (W when there is none); `bad` is set where
// the host walk returns -1 (the walk left the band, or met a STOP byte
// outside LOCAL).
//
// Output, in the wavefront walk's packing so the native decode
// (telr_wave_decode_*) is reused: `packed` (n, s_pad / 4) uint8 holds the op
// (0 = M, 1 = D, 2 = I, 3 = none) that leaves the cell at step s = i + j in
// slot s_pad - s, four slots a byte, pair-major (the layout the decode reads,
// so no transpose on the host); every op of the path is in it, the runs along
// row 0 and column 0 included, so the decode adds no lead.  `small` is the
// (8, n) int32 stack [gscore, best, ei, ej, bad, si, sj, margin].
//
// What bounds it on an H100: latency.  A walk is a chain of dependent
// one-byte loads (the next cell depends on the byte just read), one per
// alignment column, ~20 integer operations each.
//
// What the design does about it: one walker per warp and as many warps as
// pairs, so the loads of many walks are in flight together; the band offset
// of the row above is fetched while the current byte is on its way, so a
// step waits for one load, not two; the packed byte is built in a register
// and stored once per four slots.  Tensor cores, TMA and clusters have no
// work here.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kGlobal = 0;
constexpr int kLocal = 2;
constexpr int kWarpsPerBlock = 4;

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
rowband_walk_kernel(const uint8_t* __restrict__ dirs,
                    const int32_t* __restrict__ off,
                    const int32_t* __restrict__ qlen,
                    const int32_t* __restrict__ tlen,
                    const int32_t* __restrict__ gscore,
                    const int32_t* __restrict__ best,
                    const int32_t* __restrict__ besti,
                    const int32_t* __restrict__ bestp, int n, int lq,
                    int width, int s_pad, int mode,
                    uint8_t* __restrict__ packed,
                    int32_t* __restrict__ small) {
  const int pair = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (pair >= n || (threadIdx.x & 31) != 0) return;
  const int32_t* orow = off + static_cast<size_t>(pair) * (lq + 1);
  const uint8_t* pdirs = dirs + static_cast<size_t>(pair) * lq * width;
  uint8_t* prow = packed + static_cast<size_t>(pair) * (s_pad >> 2);
  const int lt = tlen[pair];

  int si, sj;
  if (mode == kGlobal) {
    si = qlen[pair];
    sj = lt;
  } else {
    si = besti[pair];
    sj = si > 0 ? orow[si] + bestp[pair] : bestp[pair];
  }
  int i = si, j = sj, st = 0;   // st: 0 = H, 1 = D, 2 = I
  int margin = width;
  // a start outside the matrix the batch was padded for cannot be walked
  bool bad = si < 0 || si > lq || sj < 0 || si + sj > s_pad;
  int off_i = 0, off_up = 0;    // off[i] and off[i - 1]
  if (!bad && i > 0) {
    off_i = orow[i];
    off_up = orow[i - 1];
  }
  int cur_row = -1;
  unsigned cur_byte = 0xffu;

  while (!bad && (i > 0 || j > 0)) {
    int op;
    const int s = i + j;
    if (i == 0) {
      op = 1;   // the leading run of D along row 0
      --j;
    } else {
      const int p = j - off_i;
      if (p < 0 || p >= width) {   // the walk left the band
        bad = true;
        break;
      }
      const int byte = pdirs[static_cast<size_t>(i - 1) * width + p];
      // row i - 2's offset, wanted only after the next step up: its load
      // overlaps this step's work
      const int off_up2 = i >= 2 ? orow[i - 2] : 0;
      if (off_i > 0 && p < margin) margin = p;
      if (off_i + width <= lt && width - 1 - p < margin)
        margin = width - 1 - p;
      const int ch = byte & 3;
      if (st == 0) {
        if (mode == kLocal && ch == 3) break;
        if (j == 0 || ch == 2) {
          st = 2;
        } else if (ch == 1) {
          st = 1;
        } else if (ch == 3) {   // STOP outside LOCAL
          bad = true;
          break;
        }
      }
      bool up = false;
      if (st == 0) {
        op = 0;
        --j;
        up = true;
      } else if (st == 1) {
        op = 1;
        --j;
        if (!(byte & 4)) st = 0;
      } else {
        op = 2;
        up = true;
        if (!(byte & 8)) st = 0;
      }
      if (up) {
        --i;
        off_i = off_up;
        off_up = off_up2;
      }
    }
    const int row = s_pad - s;
    if ((row >> 2) != cur_row) {
      if (cur_row >= 0) prow[cur_row] = static_cast<uint8_t>(cur_byte);
      cur_row = row >> 2;
      cur_byte = 0xffu;
    }
    const int sh = 2 * (row & 3);
    cur_byte = (cur_byte & ~(3u << sh)) | (static_cast<unsigned>(op) << sh);
  }
  if (cur_row >= 0) prow[cur_row] = static_cast<uint8_t>(cur_byte);
  small[0 * n + pair] = gscore[pair];
  small[1 * n + pair] = best[pair];
  small[2 * n + pair] = i;
  small[3 * n + pair] = j;
  small[4 * n + pair] = bad ? 1 : 0;
  small[5 * n + pair] = si;
  small[6 * n + pair] = sj;
  small[7 * n + pair] = margin;
}

}  // namespace

// Plain C entry point (bound with ctypes).  dirs (n, lq, width) uint8 and
// the (n,) int32 DP outputs come from telr_rowband_dp (tb != 0) on the batch
// whose offsets are off (n, lq + 1) int32 and lengths qlen / tlen (n,) int32.
// `packed` (n, s_pad / 4) uint8 must be pre-filled with 0xff (code 3 in every
// slot), s_pad a multiple of 4; `small` is (8, n) int32.  Returns
// cudaGetLastError() of the launch.
extern "C" int telr_rowband_walk(const void* dirs, const void* off,
                                 const void* qlen, const void* tlen,
                                 const void* gscore, const void* best,
                                 const void* besti, const void* bestp, int n,
                                 int lq, int width, int s_pad, int mode,
                                 void* packed, void* small, void* stream) {
  if (n == 0) return 0;
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  rowband_walk_kernel<<<blocks, 32 * kWarpsPerBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(dirs), static_cast<const int32_t*>(off),
      static_cast<const int32_t*>(qlen), static_cast<const int32_t*>(tlen),
      static_cast<const int32_t*>(gscore), static_cast<const int32_t*>(best),
      static_cast<const int32_t*>(besti), static_cast<const int32_t*>(bestp),
      n, lq, width, s_pad, mode, static_cast<uint8_t*>(packed),
      static_cast<int32_t*>(small));
  return static_cast<int>(cudaGetLastError());
}
