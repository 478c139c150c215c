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
// What bounds it on an H100: the walk's dependent chain, not bytes or
// operations.  Each step's cell depends on the byte read at the step before,
// so a walk of L steps costs L x (that read + the step's instructions), and
// a launch of a few dozen pairs leaves the card too empty to hide it.  Read
// from device memory, one lane walking, a step took ~320 ns (bench512 GLOBAL
// on an H100).  From the tiles below it takes ~250 clocks (~70 instructions
// a step issued by one warp, ~125 ns at 1.98 GHz) plus the refills, one
// round trip each (~2,200 clocks per 45-67 steps with 64-byte windows;
// clock64 counters in a copy of this kernel).
//
// What the design does about it: the 32 lanes of a pair's warp walk the same
// path in lockstep (i, j, state and the tile origin are warp-uniform, so no
// branch diverges) and read each byte from a tile in shared memory: the
// bytes of the kRows = 64 matrix rows above the tile's origin cell (i0, j0),
// each in a window of kWin = 32 band positions, the 32-byte sector that holds
// the origin's band position.  A step lowers i by at most one, so the walk
// stays in the tile's rows for at least 64 steps; a walk that follows the
// band keeps its band position, so only a gap moves it out of the window.
// (Tiles of 32 and 64 rows by 32 and 64 bytes were timed on an H100 at the
// smoke's shapes: 64 x 32 was the fastest or within 8% of it everywhere,
// PERF.md.)  Then the warp refills the tile together, in one round trip: each lane
// copies a 4-byte word of each of a few rows' windows and a band offset or
// two straight to shared memory, coalesced.  A step reads its byte, and the
// next row's offset, from shared memory (a broadcast, ~30 clocks), not
// device memory.  The packed byte is built in a register and stored by lane 0 once
// per four slots, into a `packed` the wrapper has filled with 0xff.  Tensor
// cores, TMA and clusters have no work here: there is no product to compute,
// and the next tile's rows are not known before the walk leaves the current
// one.

#include <cstdint>
#include <cuda_runtime.h>

#include "walk_tile.cuh"

namespace {

constexpr int kGlobal = 0;
constexpr int kLocal = 2;
constexpr int kWarpsPerBlock = 4;
constexpr int kRows = 64;   // matrix rows a tile holds
constexpr int kWin = 32;    // bytes of each row's window, a multiple of 32
constexpr int kWords = kWin / 4;
constexpr int kRowsPerLoad = 32 / kWords;   // rows one warp-wide read covers
constexpr int kReads = kRows / kRowsPerLoad;  // words a lane copies a refill

struct Tile {
  uint32_t bytes[kRows][kWords];   // row r: matrix row i0 - r, dirs row i0-1-r
  // off[i0 - r]; the spare entry is off[i] of the next tile's first row
  int off[kRows + 1];
};

// Refill `t` for a walk standing at (i0, j0), i0 >= 1, whose band position
// there is p0 = j0 - off[i0]: every row's window covers the band positions
// [pb, pb + kWin), pb the sector boundary that puts p0 at least kWin / 2 - 16
// positions from either end (for kWin = 32, the sector that holds p0).
// Returns pb.  The window's bytes do not depend on the rows'
// offsets, so all copies are in flight together (walk_tile.cuh).  A step
// reads a byte only after checking that it is in the band, and none on row
// 0 (the walk along it needs none): words outside those are not copied.
__device__ __forceinline__ int refill(Tile& t, const uint8_t* pdirs,
                                      const int32_t* orow, int i0, int p0,
                                      int width, int lane) {
  const int pb = (p0 - kWin / 2 + 16) & ~31;
  __syncwarp();   // every lane is done reading the old tile
#pragma unroll
  for (int r = lane; r <= kRows; r += 32)
    if (i0 - r >= 1) copy4_async(&t.off[r], orow + i0 - r);
  const int w = lane % kWords;
#pragma unroll
  for (int k = 0; k < kReads; ++k) {
    const int r = lane / kWords + k * kRowsPerLoad;
    tile_word(&t.bytes[r][w], pdirs, i0 - 1 - r, pb + 4 * w, width);
  }
  copy_wait();
  __syncwarp();
  return pb;
}

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
  __shared__ Tile tiles[kWarpsPerBlock];
  const int pair = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (pair >= n) return;   // the whole warp
  Tile& t = tiles[threadIdx.x >> 5];
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
  // the tile row of i (kRows: no tile yet), off[i], and the tile's first
  // band position
  int r = kRows, off_i = 0, pb = 0;
  if (!bad && i > 0) off_i = orow[i];
  // the op leaving the cell at step s goes to slot s_pad - s: a byte of
  // four slots is built in a register and stored by lane 0 when the walk
  // moves on to the next byte
  int cur_row = -1;
  unsigned cur_byte = 0xffu;
  auto emit = [&](int s, int op) {
    const int slot = s_pad - s;
    const bool next = (slot >> 2) != cur_row;
    if (next && cur_row >= 0 && lane == 0)
      prow[cur_row] = static_cast<uint8_t>(cur_byte);
    cur_byte = next ? 0xffu : cur_byte;
    cur_row = slot >> 2;
    const int sh = 2 * (slot & 3);
    cur_byte = (cur_byte & ~(3u << sh)) | (static_cast<unsigned>(op) << sh);
  };

  // The step is written without branches but for the rare ones (a refill,
  // leaving the band, a STOP byte): a branch costs a warp with nothing to
  // hide it behind more than the selects it saves.
  bool stopped = false;   // a STOP byte ended the walk
  while (!bad && i > 0) {
    const int p = j - off_i;
    if (r >= kRows || static_cast<unsigned>(p - pb) >= kWin) {
      pb = refill(t, pdirs, orow, i, p, width, lane);
      r = 0;
    }
    if (static_cast<unsigned>(p) >= static_cast<unsigned>(width)) {
      bad = true;   // the walk left the band
      break;
    }
    const int byte = reinterpret_cast<const uint8_t*>(t.bytes[r])[p - pb];
    // the row above's offset, wanted only after a step up: its read overlaps
    // this step's work
    const int off_up = t.off[r + 1];
    margin = min(margin, off_i > 0 ? p : width);
    margin = min(margin, off_i + width <= lt ? width - 1 - p : width);
    const int ch = byte & 3;
    if (st == 0 && ch == 3 && (mode == kLocal || j != 0)) {
      // a STOP byte ends a LOCAL walk; anywhere else the host walk fails
      bad = mode != kLocal;
      stopped = true;
      break;
    }
    // in H the byte chooses the op (column 0 forces I), in D and I the
    // state does; the gap states go on while their bit of the byte is set
    const int op = st != 0 ? st : (j == 0 ? 2 : ch);
    st = op == 1 ? (byte >> 2) & 1 : (op == 2 ? (byte >> 2) & 2 : 0);
    emit(i + j, op);
    const bool up = op != 1;
    j -= op != 2;
    i -= up;
    r += up;
    off_i = up ? off_up : off_i;
  }
  // the leading run of D along row 0
  if (!bad && !stopped)
    for (; j > 0; --j) emit(j, 1);
  if (cur_row >= 0 && lane == 0)
    prow[cur_row] = static_cast<uint8_t>(cur_byte);
  if (lane == 0) {
    small[0 * n + pair] = gscore[pair];
    small[1 * n + pair] = best[pair];
    small[2 * n + pair] = i;
    small[3 * n + pair] = j;
    small[4 * n + pair] = bad ? 1 : 0;
    small[5 * n + pair] = si;
    small[6 * n + pair] = sj;
    small[7 * n + pair] = margin;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  dirs (n, lq, width) uint8 and
// the (n,) int32 DP outputs come from telr_rowband_dp (tb != 0) on the batch
// whose offsets are off (n, lq + 1) int32 and lengths qlen / tlen (n,) int32.
// `packed` (n, s_pad / 4) uint8 must be pre-filled with 0xff (code 3 in every
// slot), s_pad a multiple of 4; `small` is (8, n) int32.  Returns
// cudaGetLastError() of the launch (cudaErrorInvalidValue where the direction
// bytes cannot be read as 4-byte words: a width that is not a multiple of 4,
// or a misaligned dirs pointer).
extern "C" int telr_rowband_walk(const void* dirs, const void* off,
                                 const void* qlen, const void* tlen,
                                 const void* gscore, const void* best,
                                 const void* besti, const void* bestp, int n,
                                 int lq, int width, int s_pad, int mode,
                                 void* packed, void* small, void* stream) {
  if (n == 0) return 0;
  if (width % 4 != 0 || reinterpret_cast<uintptr_t>(dirs) % 4 != 0)
    return cudaErrorInvalidValue;
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
