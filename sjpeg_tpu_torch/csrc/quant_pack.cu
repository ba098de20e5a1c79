// quant_pack: raster fDCT coefficient blocks -> each block's packed Huffman
// bit stream (words, MSB-first) and its exact bit count, with one shared
// set of quantizers and LUTs.
//
// Replaces the TPU kernel sjpeg_tpu/ops/pallas_quant_pack.py
// quant_vlc_pack_pallas (_quant_pack_kernel): reciprocal quantizer, zigzag
// run/size/code, Huffman lookup and packing, per block, from coefficients
// the caller computed once (the single-image passes whose tables are known
// before they quantize).  The TPU kernel zigzags with a permutation matrix
// on the MXU and packs with lane-parallel prefix sums; here the zigzag is
// the staging's and each thread walks its block's coded positions.
//
// Bound on the H100: bytes.  At 16 x 1024^2 4:2:0 (N = 393,216 blocks) it
// reads 100.7 MB of int32 coefficients plus 3.1 MB of DC codes and groups
// and writes 100.7 MB of words and 1.6 MB of counts, ~61 us at 3.35 TB/s;
// the integer work, ~7 operations a coefficient to quantize and test and
// ~20 a coded coefficient, is ~0.2 G operations.  Design: one thread per
// block, 128 blocks per CTA, and no register copy of a block.  The CTA
// stages its coefficient rows in zigzag order through shared memory
// (block_rows.cuh load_rows_zigzag: coalesced loads, each value to its
// zigzag slot), with the quantizer rows permuted to zigzag order beside
// them and the one LUT set (3,200 B).  Each thread quantizes its row's 63
// AC slots once for the 64-bit mask of coded positions
// (block_core.cuh quant_coded_mask), then runs quant_emit_coded: emit_coded
// over the set bits only, each coded slot quantized again for its run,
// size and code, the stream written into the same row.  Slot k holds zigzag
// coefficient k and the stream passes slot k only after it was read, so
// the rows go out with coalesced stores.  Emission lengths still differ
// across a warp, by each block's coded count.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_core.cuh"
#include "block_rows.cuh"

namespace {

constexpr int kThreads = sjpeg::kRowThreads;
constexpr int kStride = sjpeg::kRowStride;
constexpr int kQStride = 65;    // a group's zigzag quantizer row, padded

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
  __shared__ uint32_t s_iq[2 * kQStride], s_ib[2 * kQStride];
  __shared__ uint32_t s_dc[2 * 16], s_ac[2 * 256];
  const int tid = threadIdx.x;
  const int64_t n0 = (int64_t)blockIdx.x * kThreads;
  const int rows = (int)min((int64_t)kThreads, (int64_t)n - n0);

  for (int i = tid; i < 2 * 64; i += kThreads) {
    const int g = i >> 6, k = i & 63, p = sjpeg::zigzag_raster(k);
    s_iq[g * kQStride + k] = iquant[g * 64 + p];
    s_ib[g * kQStride + k] = bias[g * 64 + p];
  }
  for (int i = tid; i < 2 * 16; i += kThreads) s_dc[i] = dc_lut[i];
  for (int i = tid; i < 2 * 256; i += kThreads) s_ac[i] = ac_lut[i];
  sjpeg::load_rows_zigzag(coeffs + n0 * 64, rows, buf);
  __syncthreads();

  if (tid < rows) {
    const int64_t b = n0 + tid;
    const int g = group[b] & 1;
    uint32_t* row = buf + tid * kStride;
    const uint32_t* iq = s_iq + g * kQStride;
    const uint32_t* ib = s_ib + g * kQStride;
    bits[b] = sjpeg::quant_emit_coded(
        row, sjpeg::quant_coded_mask(row, iq, ib), (uint32_t)dc_codes[b], iq,
        ib, s_dc + 16 * g, s_ac + 256 * g);
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
