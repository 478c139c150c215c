// The tile refill the two walk kernels share (rowband_walk.cu,
// wavefront_walk.cu): a warp copies the direction bytes of the rows a walk
// can reach next into shared memory, as 4-byte words of whole 32-byte
// sectors.
//
// A refill is one round trip only if every read is in flight before the
// first one is waited for.  The words go straight from device memory to
// shared memory (cp.async, sm_80 and later): a lane issues all of its
// copies, then waits once, and holds none of them in registers (staged in
// registers, 32 words a lane took the row-banded walk to 116 registers, a
// quarter of the warps an SM can keep).

#pragma once

#include <cstdint>

// Start a 4-byte copy from device memory to shared memory.
__device__ __forceinline__ void copy4_async(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(smem))),
               "l"(gmem));
}

// Wait for every copy this lane started.
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start the copy of the 4 direction bytes at band positions p .. p+3 of
// dirs row `row` (row stride `width` bytes, a multiple of 4 like p and the
// dirs pointer, which the entry points check) to `dst`, byte b in bits
// 8b .. 8b+7.  A word lies wholly inside or wholly outside the band; a word
// outside the band or the matrix is not copied (its shared-memory word keeps
// an old value that no step reads).
__device__ __forceinline__ void tile_word(uint32_t* dst, const uint8_t* dirs,
                                          int row, int p, int width) {
  if (row >= 0 && p >= 0 && p + 4 <= width)
    copy4_async(dst, dirs + static_cast<size_t>(row) * width + p);
}
