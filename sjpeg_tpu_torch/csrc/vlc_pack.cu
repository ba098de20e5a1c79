// vlc_pack: per-block zigzag run/size/code fields -> each block's packed
// Huffman bit stream (words, MSB-first) and its exact bit count.
//
// Replaces the TPU kernel sjpeg_tpu/ops/pallas_vlc_pack.py vlc_pack_pallas
// (_vlc_pack_kernel with shared LUTs, _vlc_pack_kernel_sets with one LUT
// set per image).  The TPU kernel needed each image's rows padded to whole
// tiles so that a BlockSpec index map could pick the image's LUT slice;
// here every row finds its own image (row / blocks_per_image), so nothing
// is padded.
//
// Bound on the H100: bytes.  At 16 x 1024^2 4:2:0 (N = 393,216 blocks) it
// reads three [N, 64] int32 fields (3 x 100.7 MB) plus 3.1 MB of DC codes
// and groups, and writes 100.7 MB of words and 1.6 MB of bit counts:
// ~407 MB, ~0.12 ms at 3.35 TB/s.  Design: as sample_pack, one thread per
// block, 128 blocks per CTA, emission through block_core.cuh's emit_block.
// The three fields are staged through shared memory with coalesced loads,
// packed into one word per position (run << 21 | size << 16 | code: run <
// 64, size <= 16 and code < 2^16 for any field vlc.run_levels derives), so
// the CTA needs 33 KB of static shared memory rather than ~100 KB.  Each
// thread copies its row into registers before the emission overwrites the
// same shared row with its stream words, which leave with coalesced stores.
// LUTs: the CTA stages the LUT sets of the (at most two) images its rows
// span in shared memory; a CTA spanning more images (images under 128
// blocks) reads its rows' LUTs from global memory through the read-only
// cache.  Gray has one table group, so the chroma LUT rows are never read.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_core.cuh"

namespace {

constexpr int kThreads = 128;   // blocks per CTA, one per thread
constexpr int kStride = 65;     // padded shared-memory row, in words
constexpr int kDcSet = 2 * 16;  // one image's DC LUT rows
constexpr int kAcSet = 2 * 256; // one image's AC LUT rows

__global__ void __launch_bounds__(kThreads)
vlc_pack_kernel(const int32_t* __restrict__ run,
                const int32_t* __restrict__ size,
                const int32_t* __restrict__ code,
                const int32_t* __restrict__ dc_codes,
                const int32_t* __restrict__ group,
                const uint32_t* __restrict__ dc_lut,
                const uint32_t* __restrict__ ac_lut,
                uint32_t* __restrict__ words, int32_t* __restrict__ bits,
                int n, int per_img, int n_sets) {
  __shared__ uint32_t buf[kThreads * kStride];
  __shared__ uint32_t s_dc[2 * kDcSet], s_ac[2 * kAcSet];
  const int tid = threadIdx.x;
  const int64_t n0 = (int64_t)blockIdx.x * kThreads;
  const int rows = (int)min((int64_t)kThreads, (int64_t)n - n0);

  // LUT sets: set of row r = r / per_img with per-image tables, else 0
  const int set_lo = n_sets > 1 ? (int)(n0 / per_img) : 0;
  const int set_hi = n_sets > 1 ? (int)((n0 + rows - 1) / per_img) : 0;
  const int staged = min(set_hi - set_lo + 1, 2);
  for (int i = tid; i < staged * kDcSet; i += kThreads)
    s_dc[i] = dc_lut[set_lo * kDcSet + i];
  for (int i = tid; i < staged * kAcSet; i += kThreads)
    s_ac[i] = ac_lut[(int64_t)set_lo * kAcSet + i];

  const int64_t off = n0 * 64;
  for (int i = tid; i < rows * 64; i += kThreads)
    buf[(i >> 6) * kStride + (i & 63)] =
        ((uint32_t)run[off + i] << 21) | ((uint32_t)size[off + i] << 16) |
        (uint32_t)code[off + i];
  __syncthreads();

  uint32_t f[64];
#pragma unroll
  for (int k = 0; k < 64; ++k) f[k] = buf[tid * kStride + k];
  __syncthreads();

  if (tid < rows) {
    const int64_t b = n0 + tid;
    const int g = group[b] & 1;
    const int set = n_sets > 1 ? (int)(b / per_img) : 0;
    const uint32_t* dcl;
    const uint32_t* acl;
    if (set - set_lo < staged) {
      dcl = s_dc + (set - set_lo) * kDcSet;
      acl = s_ac + (set - set_lo) * kAcSet;
    } else {
      dcl = dc_lut + (int64_t)set * kDcSet;
      acl = ac_lut + (int64_t)set * kAcSet;
    }
    auto fields = [&](int k, uint32_t& r, uint32_t& s, uint32_t& c) {
      r = f[k] >> 21;
      s = (f[k] >> 16) & 31u;
      c = f[k] & 0xFFFFu;
    };
    bits[b] = sjpeg::emit_block((uint32_t)dc_codes[b], dcl + 16 * g,
                                acl + 256 * g, fields, buf + tid * kStride);
  }
  __syncthreads();

  uint32_t* dst = words + off;
  for (int i = tid; i < rows * 64; i += kThreads)
    dst[i] = buf[(i >> 6) * kStride + (i & 63)];
}

}  // namespace

// run, size, code [n, 64] int32 zigzag fields (position 0 ignored);
// dc_codes, group [n] int32; dc_lut [n_sets, 2, 16] and ac_lut
// [n_sets, 2, 256] packed uint32 LUTs, n_sets 1 (shared) or the number of
// images, row r using set r / per_img; words [n, 64] uint32 and bits [n]
// int32 are written.  Launches on `stream` and returns cudaGetLastError().
extern "C" int sjpeg_vlc_pack(const void* run, const void* size,
                              const void* code, const void* dc_codes,
                              const void* group, const void* dc_lut,
                              const void* ac_lut, void* words, void* bits,
                              int n, int per_img, int n_sets, void* stream) {
  if (n <= 0) return 0;
  if (per_img <= 0 || n_sets < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kThreads - 1) / kThreads);
  vlc_pack_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)run, (const int32_t*)size, (const int32_t*)code,
      (const int32_t*)dc_codes, (const int32_t*)group,
      (const uint32_t*)dc_lut, (const uint32_t*)ac_lut, (uint32_t*)words,
      (int32_t*)bits, n, per_img, n_sets);
  return (int)cudaGetLastError();
}
