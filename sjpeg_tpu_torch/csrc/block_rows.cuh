// Coalesced staging of a CTA's block rows through shared memory, for the
// kernels that run one thread per 8x8 block (fdct.cu, quant_pack.cu,
// sample_pack.cu).  A CTA of kRowThreads threads owns as many consecutive
// [64]-value rows.  The global loads and stores run over consecutive
// addresses; in shared memory the rows sit kRowStride = 65 words apart, so
// that threads walking their own rows in step hit 32 different banks.
#pragma once

#include <stdint.h>

#include "block_core.cuh"

namespace sjpeg {

constexpr int kRowThreads = 128;  // rows per CTA, one per thread
constexpr int kRowStride = 65;    // padded shared-memory row, in words

// src [rows, 64] values of type T, each widened to int32 -> buf rows
template <typename T>
__device__ __forceinline__ void load_rows(const T* __restrict__ src,
                                          int rows, uint32_t* buf) {
  for (int i = threadIdx.x; i < rows * 64; i += kRowThreads)
    buf[(i >> 6) * kRowStride + (i & 63)] = (uint32_t)(int32_t)src[i];
}

// src [rows, 64] raster values, each widened to int32 -> buf rows in zigzag
// order (slot k holds raster value zigzag[k]).  The loads stay coalesced:
// raster value p goes to slot zigzag_slot(p), the same p for a thread at
// every step, since a step covers whole rows.  Writes meet at most 2-way
// bank conflicts.
template <typename T>
__device__ __forceinline__ void load_rows_zigzag(const T* __restrict__ src,
                                                 int rows, uint32_t* buf) {
  static_assert(kRowThreads % 64 == 0, "a step covers whole rows");
  const int slot = zigzag_slot(threadIdx.x & 63);
  for (int i = threadIdx.x; i < rows * 64; i += kRowThreads)
    buf[(i >> 6) * kRowStride + slot] = (uint32_t)(int32_t)src[i];
}

// buf rows -> dst [rows, 64]
__device__ __forceinline__ void store_rows(const uint32_t* buf, int rows,
                                           uint32_t* __restrict__ dst) {
  for (int i = threadIdx.x; i < rows * 64; i += kRowThreads)
    dst[i] = buf[(i >> 6) * kRowStride + (i & 63)];
}

}  // namespace sjpeg
