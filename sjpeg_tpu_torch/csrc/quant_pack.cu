// quant_pack: raster fDCT coefficient blocks -> each block's packed Huffman
// bit stream (words, MSB-first) and its exact bit count, with one shared
// set of quantizers and LUTs.
//
// Replaces the TPU kernel sjpeg_tpu/ops/pallas_quant_pack.py
// quant_vlc_pack_pallas (_quant_pack_kernel): reciprocal quantizer, zigzag
// run/size/code, Huffman lookup and packing, per block, from coefficients
// the caller computed once (the single-image passes whose tables are known
// before they quantize).  The TPU kernel zigzags with a permutation matrix
// on the MXU and packs with lane-parallel prefix sums; here one thread runs
// block_core.cuh quant_emit_block, the half of sample_pack's per-block code
// after its fDCT, with the block in registers.
//
// Bound on the H100: bytes.  At 16 x 1024^2 4:2:0 (N = 393,216 blocks) it
// reads 100.7 MB of int32 coefficients plus 3.1 MB of DC codes and groups
// and writes 100.7 MB of words and 1.6 MB of counts, ~61 us at 3.35 TB/s;
// the integer work, ~7 operations a coefficient to quantize and test and
// ~20 a coded coefficient, is ~0.2 G operations.  Design: one thread per
// block, 128 blocks per CTA; the CTA stages its coefficient rows through
// shared memory (block_rows.cuh) for coalesced reads, writes its stream
// words into the same rows before the coalesced store, and keeps the one
// table set (3,200 B) in shared memory.  Serial emission per thread
// diverges across a warp, as in sample_pack.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_core.cuh"
#include "block_rows.cuh"

namespace {

constexpr int kThreads = sjpeg::kRowThreads;
constexpr int kStride = sjpeg::kRowStride;

__global__ void __launch_bounds__(kThreads)
quant_pack_kernel(const int32_t* __restrict__ coeffs,
                  const int32_t* __restrict__ dc_codes,
                  const int32_t* __restrict__ group,
                  const uint32_t* __restrict__ iquant,
                  const uint32_t* __restrict__ bias,
                  const uint32_t* __restrict__ dc_lut,
                  const uint32_t* __restrict__ ac_lut,
                  uint32_t* __restrict__ words, int32_t* __restrict__ bits,
                  int n) {
  __shared__ uint32_t buf[kThreads * kStride];
  __shared__ uint32_t s_iq[2 * 64], s_ib[2 * 64], s_dc[2 * 16],
      s_ac[2 * 256];
  const int tid = threadIdx.x;
  const int64_t n0 = (int64_t)blockIdx.x * kThreads;
  const int rows = (int)min((int64_t)kThreads, (int64_t)n - n0);

  for (int i = tid; i < 2 * 64; i += kThreads) {
    s_iq[i] = iquant[i];
    s_ib[i] = bias[i];
  }
  for (int i = tid; i < 2 * 16; i += kThreads) s_dc[i] = dc_lut[i];
  for (int i = tid; i < 2 * 256; i += kThreads) s_ac[i] = ac_lut[i];
  sjpeg::load_rows(coeffs + n0 * 64, rows, buf);
  __syncthreads();

  uint32_t x[64];
#pragma unroll
  for (int k = 0; k < 64; ++k) x[k] = buf[tid * kStride + k];

  if (tid < rows) {
    const int64_t b = n0 + tid;
    bits[b] = sjpeg::quant_emit_block(x, (uint32_t)dc_codes[b], group[b] & 1,
                                      s_iq, s_ib, s_dc, s_ac,
                                      buf + tid * kStride);
  }
  __syncthreads();

  sjpeg::store_rows(buf, rows, words + n0 * 64);
}

}  // namespace

// coeffs [n, 64] int32 raster coefficients; dc_codes, group [n] int32;
// iquant, bias [2, 64] and LUTs [2, 16], [2, 256] as uint32; words [n, 64]
// uint32 and bits [n] int32 are written.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int sjpeg_quant_pack(const void* coeffs, const void* dc_codes,
                                const void* group, const void* iquant,
                                const void* bias, const void* dc_lut,
                                const void* ac_lut, void* words, void* bits,
                                int n, void* stream) {
  if (n <= 0) return 0;
  const dim3 grid((n + kThreads - 1) / kThreads);
  quant_pack_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)coeffs, (const int32_t*)dc_codes,
      (const int32_t*)group, (const uint32_t*)iquant, (const uint32_t*)bias,
      (const uint32_t*)dc_lut, (const uint32_t*)ac_lut, (uint32_t*)words,
      (int32_t*)bits, n);
  return (int)cudaGetLastError();
}
