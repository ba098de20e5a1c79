// sample_pack: centred 8x8 sample blocks -> each block's packed Huffman
// bit stream (words, MSB-first) and its exact bit count, with shared or
// per-image quantizers and LUTs.
//
// Replaces the TPU kernels sjpeg_tpu/ops/pallas_quant_pack.py
// sample_vlc_pack_units_pallas (_sample_pack_units_kernel) and
// sample_vlc_pack_pallas (_sample_pack_kernel with shared tables,
// _sample_pack_kernel_sets with one table set per image): exact fDCT,
// reciprocal quantizer, zigzag run/size/code, Huffman lookup and packing,
// per block.  The TPU kernel's in-kernel 16-block fold is left to
// stream_concat.cu: it saved an HBM round trip the TPU could not afford,
// about 200 MB at 16 x 1024^2, some 60 us at 3.35 TB/s here.  Its per-image
// variant needed each image's rows padded to whole tiles (and int8 samples
// with a chroma wrap); here every row finds its image (row / per_img) and
// int16 samples hold chroma's +128, so nothing is padded.
//
// Bound on the H100: bytes.  At 16 x 1024^2 4:2:0 (N = 393,216 blocks) it
// reads 50 MB of int16 samples plus 3 MB of codes and groups and writes
// 100 MB of words, ~46 us at 3.35 TB/s; the integer work, ~2,000 32-bit
// operations per block, is ~0.8 G operations.  Design: one thread per
// block, 128 blocks per CTA.  The CTA stages its 128 x 64 samples through
// shared memory so that global reads and writes are coalesced (rows padded
// to 65 words, block_rows.cuh: no bank conflicts when each thread walks its
// own row), runs the per-block core of block_core.cuh with the block in
// registers, and writes its stream words into the same shared rows before
// the coalesced store.  Serial emission per thread diverges across a warp:
// emit_block steps over all 63 positions, zero or not.  Measured on the
// H100 (PERF.md), a warp per block (ballots, a scan and an atomicOr
// scatter) is no faster: it issues some 150 warp instructions a block,
// where 32 threads on 32 blocks share every instruction; a thread that
// walks only its block's coded positions takes about half the time and is
// the next design (ROADMAP S2).
// Tables: the shared-table instance stages the one set; the per-image
// instance stages the sets of the (at most two) images its 128 rows span,
// as vlc_pack.cu does, 39,680 B of static shared memory in all, and a CTA
// spanning more images (images under 128 blocks) reads its rows' sets from
// global memory through the read-only cache.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_core.cuh"
#include "block_rows.cuh"

namespace {

constexpr int kThreads = sjpeg::kRowThreads;   // blocks per CTA
constexpr int kStride = sjpeg::kRowStride;     // padded row, in words
constexpr int kQSet = 2 * 64;   // one set's iquant (or bias) rows
constexpr int kDcSet = 2 * 16;  // one set's DC LUT rows
constexpr int kAcSet = 2 * 256; // one set's AC LUT rows

// kSets: table sets staged in shared memory, 1 (shared tables) or 2 (per
// image: row r uses set r / per_img)
template <typename T, int kSets>
__global__ void __launch_bounds__(kThreads)
sample_pack_kernel(const T* __restrict__ samples,
                   const int32_t* __restrict__ dc_codes,
                   const int32_t* __restrict__ group,
                   const uint32_t* __restrict__ iquant,
                   const uint32_t* __restrict__ bias,
                   const uint32_t* __restrict__ dc_lut,
                   const uint32_t* __restrict__ ac_lut,
                   uint32_t* __restrict__ words, int32_t* __restrict__ bits,
                   int n, int per_img) {
  __shared__ uint32_t buf[kThreads * kStride];
  __shared__ uint32_t s_iq[kSets * kQSet], s_ib[kSets * kQSet];
  __shared__ uint32_t s_dc[kSets * kDcSet], s_ac[kSets * kAcSet];
  const int tid = threadIdx.x;
  const int64_t n0 = (int64_t)blockIdx.x * kThreads;
  const int rows = (int)min((int64_t)kThreads, (int64_t)n - n0);

  const int set_lo = kSets > 1 ? (int)(n0 / per_img) : 0;
  const int set_hi = kSets > 1 ? (int)((n0 + rows - 1) / per_img) : 0;
  const int staged = min(set_hi - set_lo + 1, kSets);
  for (int i = tid; i < staged * kQSet; i += kThreads) {
    s_iq[i] = iquant[(int64_t)set_lo * kQSet + i];
    s_ib[i] = bias[(int64_t)set_lo * kQSet + i];
  }
  for (int i = tid; i < staged * kDcSet; i += kThreads)
    s_dc[i] = dc_lut[(int64_t)set_lo * kDcSet + i];
  for (int i = tid; i < staged * kAcSet; i += kThreads)
    s_ac[i] = ac_lut[(int64_t)set_lo * kAcSet + i];
  sjpeg::load_rows(samples + n0 * 64, rows, buf);
  __syncthreads();

  uint32_t x[64];
#pragma unroll
  for (int k = 0; k < 64; ++k) x[k] = buf[tid * kStride + k];
  __syncthreads();

  if (tid < rows) {
    const int64_t b = n0 + tid;
    const int set = kSets > 1 ? (int)(b / per_img) : 0;
    const int k = set - set_lo;
    const uint32_t* iq = s_iq + k * kQSet;
    const uint32_t* ib = s_ib + k * kQSet;
    const uint32_t* dcl = s_dc + k * kDcSet;
    const uint32_t* acl = s_ac + k * kAcSet;
    if (k >= staged) {               // a third image in this CTA's rows
      iq = iquant + (int64_t)set * kQSet;
      ib = bias + (int64_t)set * kQSet;
      dcl = dc_lut + (int64_t)set * kDcSet;
      acl = ac_lut + (int64_t)set * kAcSet;
    }
    bits[b] = sjpeg::encode_block(x, (uint32_t)dc_codes[b], group[b] & 1, iq,
                                  ib, dcl, acl, buf + tid * kStride);
  }
  __syncthreads();

  sjpeg::store_rows(buf, rows, words + n0 * 64);
}

template <typename T>
void launch(const void* samples, const int32_t* dcc, const int32_t* grp,
            const uint32_t* iq, const uint32_t* ib, const uint32_t* dcl,
            const uint32_t* acl, void* words, void* bits, int n, int per_img,
            int n_sets, cudaStream_t s) {
  const dim3 grid((n + kThreads - 1) / kThreads);
  if (n_sets > 1) {
    sample_pack_kernel<T, 2><<<grid, kThreads, 0, s>>>(
        (const T*)samples, dcc, grp, iq, ib, dcl, acl, (uint32_t*)words,
        (int32_t*)bits, n, per_img);
  } else {
    sample_pack_kernel<T, 1><<<grid, kThreads, 0, s>>>(
        (const T*)samples, dcc, grp, iq, ib, dcl, acl, (uint32_t*)words,
        (int32_t*)bits, n, per_img);
  }
}

}  // namespace

// samples [n, 64] int16 (sample_bytes 2) or int32 (4); dc_codes, group [n]
// int32; iquant, bias [n_sets, 2, 64] and LUTs [n_sets, 2, 16],
// [n_sets, 2, 256] as uint32, n_sets 1 (shared) or the number of images,
// row r using set r / per_img; words [n, 64] uint32 and bits [n] int32 are
// written.  Launches on `stream` and returns cudaGetLastError().
extern "C" int sjpeg_sample_pack(const void* samples, int sample_bytes,
                                 const void* dc_codes, const void* group,
                                 const void* iquant, const void* bias,
                                 const void* dc_lut, const void* ac_lut,
                                 void* words, void* bits, int n, int per_img,
                                 int n_sets, void* stream) {
  if (n <= 0) return 0;
  if (per_img <= 0 || n_sets < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const auto* dcc = (const int32_t*)dc_codes;
  const auto* grp = (const int32_t*)group;
  const auto* iq = (const uint32_t*)iquant;
  const auto* ib = (const uint32_t*)bias;
  const auto* dcl = (const uint32_t*)dc_lut;
  const auto* acl = (const uint32_t*)ac_lut;
  if (sample_bytes == 2) {
    launch<int16_t>(samples, dcc, grp, iq, ib, dcl, acl, words, bits, n,
                    per_img, n_sets, s);
  } else if (sample_bytes == 4) {
    launch<int32_t>(samples, dcc, grp, iq, ib, dcl, acl, words, bits, n,
                    per_img, n_sets, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
