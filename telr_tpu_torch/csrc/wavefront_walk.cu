// Traceback walk over the wavefront DP's direction bytes, one warp per pair.
//
// Replaces: telr_tpu/kernels/pallas_wavefront.py::_device_traceback_from_best
// and _device_traceback (jitted XLA).  Outputs are kept bit for bit so the
// native decode (telr_wave_decode_*) is reused: `packed` is (s_max/4, n)
// uint8 holding the 2-bit op code (0=M, 1=D, 2=I, 3=none) of sweep position
// s at row index s_max - s, four codes per byte, and `small` is the (7, n)
// int32 stack [gscore, best, fi, fj, bad, si, sj].
//
// The TPU version sweeps s from s_max down to 1 for all pairs at once,
// because the TPU has no per-lane gather; here each pair's walk visits only
// its own cells, as the host walker does.
//
// What bounds it on an H100: the walk's dependent chain, not bytes or
// operations.  The cell of a step depends on the direction byte of the step
// before, and the band base m of the next step on the op just decided and the
// drift bits of the steps it leaves, so a walk of L steps costs L x (those
// reads + the step's instructions), and a launch of a few dozen pairs leaves
// the card too empty to hide it.  Read from device memory (a direction byte,
// then one or two meta bytes, each a round trip), one lane walking, a step
// took ~300 ns (bench2048 EXTEND on an H100).  From the tiles below it takes
// ~260 clocks (the step's instructions, issued by one warp) plus the
// refills, one round trip each (~1,800-2,500 clocks per 32-38 steps with
// 64-byte windows; clock64 counters in a copy of this kernel).
//
// What the design does about it: nothing is materialised besides the outputs
// (the band base is recomputed from the drift bits instead of a (n, s_max+1)
// table); the warp of a pair first sums the drift bits up to the start step
// in parallel; then all 32 lanes walk the same path in lockstep (i, j, m,
// state and the tile origin are warp-uniform, so no branch diverges),
// reading each byte from a tile in shared memory: the kRows = 64 sweep rows
// below the tile's origin step s0, each in a window of kWin = 32 band
// positions, the 32-byte sector that holds the origin's position p0.  A step
// lowers s by one or two and moves p by at most one, so the walk stays in the
// tile for at least 32 steps, or until p leaves the sector.  (Tiles of 32 and
// 64 rows by 32 and 64 bytes were timed on an H100 at the smoke's shapes: 64
// x 32 was the fastest or within 1% of it everywhere, PERF.md.)
// The same refill reads the meta bytes of those rows and turns their drift
// bits into a 64-bit mask with two warp ballots, so a step's drift is a bit
// test in a register: no read at all.  A refill is one round trip for
// dozens of steps: each lane copies a 4-byte word of each of a few rows
// straight to shared memory and reads two meta bytes.  A step reads one byte
// from shared memory (a broadcast, ~30 clocks).  The
// packed byte is built in a register and stored by lane 0 once per four
// sweep positions.  Tensor cores, TMA and clusters have no work here: there
// is no product to compute, and the next tile's rows are not known before the
// walk leaves the current one.

#include <cstdint>
#include <cuda_runtime.h>

#include "walk_tile.cuh"

namespace {

constexpr int kGlobal = 0;
constexpr int kLocal = 2;
constexpr int kWarpsPerBlock = 4;
constexpr int kRows = 64;   // sweep rows a tile holds
constexpr int kWin = 32;    // band positions of each row's window, k x 32
constexpr int kWords = kWin / 4;
constexpr int kRowsPerLoad = 32 / kWords;   // rows one warp-wide read covers
constexpr int kReads = kRows / kRowsPerLoad;  // words a lane copies a refill
// an M step at tile row r needs the drift bits of rows r and r + 1
constexpr int kUsable = kRows < 64 ? kRows : 63;

__device__ __forceinline__ int drift_of(const int8_t* mrow, int s) {
  // drift of step s (1-based): m_s - m_{s-1}
  return (mrow[s - 1] & 1) ? 1 : -1;
}

// Refill the warp's tile for a walk at sweep step s0 and band position p0:
// rows r = 0 .. kRows-1 hold the direction bytes of step s0 - r (dirs row
// s0 - 1 - r) at band positions [pb, pb + kWin), pb the sector boundary that
// puts p0 at least kWin / 2 - 16 positions from either end (for kWin = 32,
// the sector that holds p0).  Returns pb; the
// drift bits of steps s0 - r, r < 64, go to `drift` (bit r set: +1).  All
// copies and reads are in flight together (walk_tile.cuh).  Band positions
// are clamped into the band and no step reaches a row below row 1, so words
// outside them are not copied.
__device__ __forceinline__ int refill(uint32_t (*tile)[kWords],
                                      uint64_t& drift, const uint8_t* pdirs,
                                      const int8_t* mrow, int s0, int p0,
                                      int width, int lane) {
  const int pb = (p0 - kWin / 2 + 16) & ~31;
  // meta byte s - 1 holds the drift of step s
  const int k0 = s0 - 1 - lane, k1 = k0 - 32;
  const int m0 = k0 >= 0 ? __ldg(mrow + k0) : 0;
  const int m1 = k1 >= 0 ? __ldg(mrow + k1) : 0;
  __syncwarp();   // every lane is done reading the old tile
  const int w = lane % kWords;
#pragma unroll
  for (int k = 0; k < kReads; ++k) {
    const int r = lane / kWords + k * kRowsPerLoad;
    tile_word(&tile[r][w], pdirs, s0 - 1 - r, pb + 4 * w, width);
  }
  drift = __ballot_sync(0xffffffffu, m0 & 1) |
          (static_cast<uint64_t>(__ballot_sync(0xffffffffu, m1 & 1)) << 32);
  copy_wait();
  __syncwarp();
  return pb;
}

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
wavefront_walk_kernel(const int8_t* __restrict__ dirs,
                      const int8_t* __restrict__ meta,
                      const int32_t* __restrict__ scal,
                      const int32_t* __restrict__ gscore,
                      const int32_t* __restrict__ best,
                      const int32_t* __restrict__ best_s,
                      const int32_t* __restrict__ best_p, int n, int s_pad,
                      int width, int mode,
                      uint8_t* __restrict__ packed,
                      int32_t* __restrict__ small) {
  __shared__ uint32_t tiles[kWarpsPerBlock][kRows][kWords];
  const int pair = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (pair >= n) return;   // the whole warp
  uint32_t (*tile)[kWords] = tiles[threadIdx.x >> 5];
  const int8_t* mrow = meta + static_cast<size_t>(pair) * s_pad;
  const int lq = scal[pair * 8 + 0];
  const int lt = scal[pair * 8 + 1];
  const int m0 = scal[pair * 8 + 3] - scal[pair * 8 + 2];  // j0 - i0

  const int s_star = mode == kGlobal ? lq + lt : best_s[pair];
  // m(s_star) = m0 + sum of the drifts of steps 1..s_star, summed by the warp
  int part = 0;
#pragma unroll 8
  for (int s = 1 + lane; s <= s_star; s += 32) part += drift_of(mrow, s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    part += __shfl_xor_sync(0xffffffffu, part, off);
  int m = m0 + part;

  int si, sj;
  if (mode == kGlobal) {
    si = lq;
    sj = lt;
  } else if (s_star == 0) {  // the empty alignment won: walk from (0, 0)
    si = 0;
    sj = 0;
  } else {
    const int o = m + 2 * best_p[pair];
    si = (s_star - o) >> 1;  // arithmetic shift: floor division
    sj = (s_star + o) >> 1;
  }

  int i = si, j = sj, st = 0;  // st: 0 = H, 1 = D, 2 = I
  bool bad = false;
  const uint8_t* pdirs = reinterpret_cast<const uint8_t*>(dirs) +
                        static_cast<size_t>(pair) * s_pad * width;
  // the tile's origin step and first band position, and the drift bits of
  // its rows (s0 = -1: no tile yet)
  int s0 = -1, pb = 0;
  uint64_t drift = 0;
  // the op leaving the cell at step s goes to slot s_pad - s: a byte of
  // four slots is built in a register and stored by lane 0 when the walk
  // moves on to the next byte
  int cur_row = -1;
  unsigned cur_byte = 0xffu;

  // The step is written without branches but for the rare ones (a refill,
  // a STOP byte): a branch costs a warp with nothing to hide it behind more
  // than the selects it saves.
  while (i > 0 && j > 0) {
    const int s = i + j;
    const int off = j - i - m;
    const int p_raw = off >> 1;
    // the host walker raises when a walk leaves the band; flag the pair
    bad = bad | ((off & 1) != 0) |
          (static_cast<unsigned>(p_raw) >= static_cast<unsigned>(width));
    const int p = min(max(p_raw, 0), width - 1);
    if (static_cast<unsigned>(s0 - s) >= kUsable ||
        static_cast<unsigned>(p - pb) >= kWin) {
      pb = refill(tile, drift, pdirs, mrow, s, p, width, lane);
      s0 = s;
    }
    const int r = s0 - s;
    const int byte = reinterpret_cast<const int8_t*>(tile[r])[p - pb];
    const int ch = byte & 3;
    if (st == 0 && ch == 3) {
      // a STOP byte ends a LOCAL walk; elsewhere it means corrupted dirs
      bad = bad | (mode != kLocal);
      break;
    }
    // in H the byte chooses the op, in D and I the state does; the gap
    // states go on while their bit of the byte is set
    const int op = st != 0 ? st : ch;
    st = op == 1 ? (byte >> 2) & 1 : (op == 2 ? (byte >> 2) & 2 : 0);
    const int slot = s_pad - s;
    const bool next = (slot >> 2) != cur_row;
    if (next && cur_row >= 0 && lane == 0)
      packed[static_cast<size_t>(cur_row) * n + pair] = cur_byte;
    cur_byte = next ? 0xffu : cur_byte;
    cur_row = slot >> 2;
    const int sh = 2 * (slot & 3);
    cur_byte = (cur_byte & ~(3u << sh)) | (static_cast<unsigned>(op) << sh);
    i -= op != 1;
    j -= op != 2;
    // band base of the next cell's step: undo the drifts of the steps left
    // (bit r: step s, bit r + 1: step s - 1; set means +1)
    m -= 2 * static_cast<int>((drift >> r) & 1) - 1;
    m -= op == 0 ? 2 * static_cast<int>((drift >> (r + 1)) & 1) - 1 : 0;
  }
  if (cur_row >= 0 && lane == 0)
    packed[static_cast<size_t>(cur_row) * n + pair] = cur_byte;
  if (lane == 0) {
    small[0 * n + pair] = gscore[pair];
    small[1 * n + pair] = best[pair];
    small[2 * n + pair] = i;
    small[3 * n + pair] = j;
    small[4 * n + pair] = bad ? 1 : 0;
    small[5 * n + pair] = si;
    small[6 * n + pair] = sj;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  dirs (n, s_pad, width) int8 and
// the (n,) int32 DP outputs come from telr_wavefront_dp; meta/scal are its
// wire arrays.  `packed` (s_pad/4, n) uint8 must be pre-filled with 0xff
// (code 3 in every slot).  Returns cudaGetLastError() of the launch
// (cudaErrorInvalidValue where the direction bytes cannot be read as 4-byte
// words: a width that is not a multiple of 4, or a misaligned dirs pointer).
extern "C" int telr_wavefront_walk(const void* dirs, const void* meta,
                                   const void* scal, const void* gscore,
                                   const void* best, const void* best_s,
                                   const void* best_p, int n, int s_pad,
                                   int width, int mode, void* packed,
                                   void* small, void* stream) {
  if (n == 0) return 0;
  if (width % 4 != 0 || reinterpret_cast<uintptr_t>(dirs) % 4 != 0)
    return cudaErrorInvalidValue;
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  wavefront_walk_kernel<<<blocks, 32 * kWarpsPerBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(dirs), static_cast<const int8_t*>(meta),
      static_cast<const int32_t*>(scal), static_cast<const int32_t*>(gscore),
      static_cast<const int32_t*>(best), static_cast<const int32_t*>(best_s),
      static_cast<const int32_t*>(best_p), n, s_pad, width, mode,
      static_cast<uint8_t*>(packed), static_cast<int32_t*>(small));
  return static_cast<int>(cudaGetLastError());
}
