// sample_pack: centred 8x8 sample blocks -> each block's packed Huffman
// bit stream (words, MSB-first) and its exact bit count.
//
// Replaces the TPU kernels sjpeg_tpu/ops/pallas_quant_pack.py
// sample_vlc_pack_units_pallas (_sample_pack_units_kernel) and
// sample_vlc_pack_pallas (_sample_pack_kernel): exact fDCT, reciprocal
// quantizer, zigzag run/size/code, Huffman lookup and packing, per block.
// The TPU kernel's in-kernel 16-block fold is left to stream_concat.cu: it
// saved an HBM round trip the TPU could not afford, about 200 MB at 16 x
// 1024^2, some 60 us at 3.35 TB/s here.
//
// Bound on the H100: bytes.  At 16 x 1024^2 4:2:0 (N = 393,216 blocks) it
// reads 50 MB of int16 samples plus 3 MB of codes and groups and writes
// 100 MB of words, ~46 us at 3.35 TB/s; the integer work, ~2,000 32-bit
// operations per block, is ~0.8 G operations.  Design: one thread per
// block, 128 blocks per CTA.  The CTA stages its 128 x 64 samples through
// shared memory so that global reads and writes are coalesced (rows padded
// to 65 words: no bank conflicts when each thread walks its own row), runs
// the per-block core of block_core.cuh with the block in registers, and
// writes its stream words into the same shared rows before the coalesced
// store.  Serial emission per thread diverges across a warp; that is the
// first thing a faster version changes (a warp per block, ballot and scan).
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_core.cuh"

namespace {

constexpr int kThreads = 128;   // blocks per CTA, one per thread
constexpr int kStride = 65;     // padded shared-memory row, in words

template <typename T>
__global__ void __launch_bounds__(kThreads)
sample_pack_kernel(const T* __restrict__ samples,
                   const int32_t* __restrict__ dc_codes,
                   const int32_t* __restrict__ group,
                   const uint32_t* __restrict__ iquant,
                   const uint32_t* __restrict__ bias,
                   const uint32_t* __restrict__ dc_lut,
                   const uint32_t* __restrict__ ac_lut,
                   uint32_t* __restrict__ words, int32_t* __restrict__ bits,
                   int n) {
  __shared__ uint32_t buf[kThreads * kStride];
  __shared__ uint32_t s_iq[2 * 64], s_ib[2 * 64], s_dc[2 * 16], s_ac[2 * 256];
  const int tid = threadIdx.x;
  const int64_t n0 = (int64_t)blockIdx.x * kThreads;
  const int rows = (int)min((int64_t)kThreads, (int64_t)n - n0);

  for (int i = tid; i < 2 * 64; i += kThreads) {
    s_iq[i] = iquant[i];
    s_ib[i] = bias[i];
  }
  for (int i = tid; i < 2 * 16; i += kThreads) s_dc[i] = dc_lut[i];
  for (int i = tid; i < 2 * 256; i += kThreads) s_ac[i] = ac_lut[i];
  const T* src = samples + n0 * 64;
  for (int i = tid; i < rows * 64; i += kThreads)
    buf[(i >> 6) * kStride + (i & 63)] = (uint32_t)(int32_t)src[i];
  __syncthreads();

  uint32_t x[64];
#pragma unroll
  for (int k = 0; k < 64; ++k) x[k] = buf[tid * kStride + k];
  __syncthreads();

  if (tid < rows) {
    const int64_t b = n0 + tid;
    bits[b] = sjpeg::encode_block(x, (uint32_t)dc_codes[b], group[b] & 1,
                                  s_iq, s_ib, s_dc, s_ac,
                                  buf + tid * kStride);
  }
  __syncthreads();

  uint32_t* dst = words + n0 * 64;
  for (int i = tid; i < rows * 64; i += kThreads)
    dst[i] = buf[(i >> 6) * kStride + (i & 63)];
}

}  // namespace

// samples [n, 64] int16 (sample_bytes 2) or int32 (4); dc_codes, group [n]
// int32; iquant, bias [2, 64] and LUTs [2, 16], [2, 256] as uint32; words
// [n, 64] uint32 and bits [n] int32 are written.  Launches on `stream` and
// returns cudaGetLastError().
extern "C" int sjpeg_sample_pack(const void* samples, int sample_bytes,
                                 const void* dc_codes, const void* group,
                                 const void* iquant, const void* bias,
                                 const void* dc_lut, const void* ac_lut,
                                 void* words, void* bits, int n,
                                 void* stream) {
  if (n <= 0) return 0;
  const dim3 grid((n + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  const auto* dcc = (const int32_t*)dc_codes;
  const auto* grp = (const int32_t*)group;
  const auto* iq = (const uint32_t*)iquant;
  const auto* ib = (const uint32_t*)bias;
  const auto* dcl = (const uint32_t*)dc_lut;
  const auto* acl = (const uint32_t*)ac_lut;
  if (sample_bytes == 2) {
    sample_pack_kernel<int16_t><<<grid, kThreads, 0, s>>>(
        (const int16_t*)samples, dcc, grp, iq, ib, dcl, acl,
        (uint32_t*)words, (int32_t*)bits, n);
  } else if (sample_bytes == 4) {
    sample_pack_kernel<int32_t><<<grid, kThreads, 0, s>>>(
        (const int32_t*)samples, dcc, grp, iq, ib, dcl, acl,
        (uint32_t*)words, (int32_t*)bits, n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
