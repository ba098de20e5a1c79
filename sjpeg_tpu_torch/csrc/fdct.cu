// fdct: centred 8x8 sample blocks -> their exact fixed-point forward DCT
// coefficients (x16 scale), the transform of the staged paths.
//
// Replaces the TPU kernel sjpeg_tpu/ops/pallas_fdct.py fdct_blocks_pallas
// (_fdct_kernel), which runs the transform as integer matrix products on the
// MXU (a 64 x 64 column-pass matrix, then a row pass of lane rolls and
// selects), the TPU's way around per-lane gathers.  Here each thread runs
// the reference's butterfly network on one block held in registers
// (block_core.cuh fdct_block), the arithmetic sample_pack runs before it
// quantizes.
//
// Bound on the H100: bytes.  At 16 x 1024^2 4:2:0 (N = 393,216 blocks) it
// reads 100.7 MB of int32 samples (50.3 MB as int16) and writes 100.7 MB of
// coefficients, ~60 us at 3.35 TB/s; its ~1,250 32-bit operations a block,
// ~0.5 G in all, take ~7 us at 67 T/s.  Design: one thread per block, 128
// blocks per CTA, the CTA's rows staged through shared memory
// (block_rows.cuh) so that global reads and writes are coalesced.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_core.cuh"
#include "block_rows.cuh"

namespace {

constexpr int kThreads = sjpeg::kRowThreads;
constexpr int kStride = sjpeg::kRowStride;

template <typename T>
__global__ void __launch_bounds__(kThreads)
fdct_kernel(const T* __restrict__ blocks, uint32_t* __restrict__ coeffs,
            int n) {
  __shared__ uint32_t buf[kThreads * kStride];
  const int tid = threadIdx.x;
  const int64_t n0 = (int64_t)blockIdx.x * kThreads;
  const int rows = (int)min((int64_t)kThreads, (int64_t)n - n0);
  sjpeg::load_rows(blocks + n0 * 64, rows, buf);
  __syncthreads();

  // each thread reads and writes back only its own row
  uint32_t x[64];
#pragma unroll
  for (int k = 0; k < 64; ++k) x[k] = buf[tid * kStride + k];
  sjpeg::fdct_block(x);
#pragma unroll
  for (int k = 0; k < 64; ++k) buf[tid * kStride + k] = x[k];
  __syncthreads();

  sjpeg::store_rows(buf, rows, coeffs + n0 * 64);
}

}  // namespace

// blocks [n, 64] int16 (sample_bytes 2) or int32 (4) raster samples;
// coeffs [n, 64] int32 is written.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int sjpeg_fdct(const void* blocks, int sample_bytes, void* coeffs,
                          int n, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((n + kThreads - 1) / kThreads);
  if (sample_bytes == 2) {
    fdct_kernel<int16_t><<<grid, kThreads, 0, s>>>(
        (const int16_t*)blocks, (uint32_t*)coeffs, n);
  } else if (sample_bytes == 4) {
    fdct_kernel<int32_t><<<grid, kThreads, 0, s>>>(
        (const int32_t*)blocks, (uint32_t*)coeffs, n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
