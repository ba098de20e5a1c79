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
// ~407 MB, ~0.12 ms at 3.35 TB/s.  Design: one thread per block, 128 blocks
// per CTA.  The three fields are staged through shared memory with
// coalesced int4 loads, packed into one word per position (run << 21 |
// size << 16 | code: run < 64, size <= 16 and code < 2^16 for any field
// vlc.run_levels derives), so the CTA needs 34 KB of shared memory for its
// rows rather than ~100 KB.  The same loop builds each row's 64-bit mask of
// coded positions from warp ballots of size != 0, with no extra pass.  Each
// thread then runs block_core.cuh's emit_coded over the set bits of its
// row's mask only (a block codes a fraction of its 63 positions): it
// reads each coded position's packed field from its shared row and writes
// the stream in place into words 0.. of the same row, and the rows leave
// with coalesced int4 stores.  After coded position k the stream holds at
// most 32 (k + 1) bits, so a field is read before its word is written;
// where runs longer than the positions they skip break that, emit_coded
// says so and the field is read again from global memory.  No register copy
// of the row, so no local memory.
// LUTs: the CTA stages the LUT sets of the (at most two) images its rows
// span in shared memory; a CTA spanning more images (images under 128
// blocks) reads its rows' LUTs from global memory through the read-only
// cache.  Gray has one table group, so the chroma LUT rows are never read.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_core.cuh"

namespace {

constexpr int kThreads = 128;   // blocks per CTA, one per thread
constexpr int kStride = 68;     // shared-memory row in words, 16-byte aligned
constexpr int kDcSet = 2 * 16;  // one image's DC LUT rows
constexpr int kAcSet = 2 * 256; // one image's AC LUT rows

// One position's fields in one word.
__device__ __forceinline__ uint32_t packed_field(int32_t run, int32_t size,
                                                 int32_t code) {
  return ((uint32_t)run << 21) | ((uint32_t)size << 16) | (uint32_t)code;
}

// Bit i of an 8-bit x to bit 4 i.
__device__ __forceinline__ uint32_t spread_nibbles(uint32_t x) {
  x = (x | (x << 12)) & 0x000F000Fu;
  x = (x | (x << 6)) & 0x03030303u;
  return (x | (x << 3)) & 0x11111111u;
}

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
  __shared__ uint32_t masks[2 * kThreads];   // coded positions, per half-row
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

  // The fields as int4 quads of 4 positions: a warp covers 32 consecutive
  // quads, two rows; one __ballot_sync of size != 0 per quad lane j gives
  // bit l for position 4 l + j, and lane 8 g of each half-row g spreads
  // bits 8 g.. of the four into that half-row's mask.  The bound is a
  // multiple of 32, so whole warps take each step.
  const int64_t off = n0 * 64;
  const int quads = rows * 16;
  const int4* run4 = reinterpret_cast<const int4*>(run + off);
  const int4* size4 = reinterpret_cast<const int4*>(size + off);
  const int4* code4 = reinterpret_cast<const int4*>(code + off);
  for (int q = tid; q < ((quads + 31) & ~31); q += kThreads) {
    int4 s = make_int4(0, 0, 0, 0);
    if (q < quads) {
      const int4 r = run4[q], c = code4[q];
      s = size4[q];
      *reinterpret_cast<uint4*>(buf + (q >> 4) * kStride + (q & 15) * 4) =
          make_uint4(packed_field(r.x, s.x, c.x), packed_field(r.y, s.y, c.y),
                     packed_field(r.z, s.z, c.z), packed_field(r.w, s.w, c.w));
    }
    const uint32_t coded[4] = {__ballot_sync(0xFFFFFFFFu, s.x != 0),
                               __ballot_sync(0xFFFFFFFFu, s.y != 0),
                               __ballot_sync(0xFFFFFFFFu, s.z != 0),
                               __ballot_sync(0xFFFFFFFFu, s.w != 0)};
    if ((q & 7) == 0 && q < quads) {
      const int g = (q & 31) >> 3;
      uint32_t half = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        half |= spread_nibbles((coded[j] >> (8 * g)) & 0xFFu) << j;
      masks[q >> 3] = (q & 8) ? half : half & ~1u;  // position 0 uncoded
    }
  }
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
    uint32_t* row = buf + tid * kStride;
    const uint64_t mask =
        masks[2 * tid] | ((uint64_t)masks[2 * tid + 1] << 32);
    auto field = [&](int k, bool in_place) {
      const int64_t i = b * 64 + k;
      return in_place ? row[k] : packed_field(run[i], size[i], code[i]);
    };
    bits[b] = sjpeg::emit_coded((uint32_t)dc_codes[b], dcl + 16 * g,
                                acl + 256 * g, mask, field, row);
  }
  __syncthreads();

  uint4* dst = reinterpret_cast<uint4*>(words + off);
  for (int q = tid; q < quads; q += kThreads)
    dst[q] = *reinterpret_cast<const uint4*>(buf + (q >> 4) * kStride +
                                             (q & 15) * 4);
}

}  // namespace

// run, size, code [n, 64] int32 zigzag fields (position 0 ignored);
// dc_codes, group [n] int32; dc_lut [n_sets, 2, 16] and ac_lut
// [n_sets, 2, 256] packed uint32 LUTs, n_sets 1 (shared) or the number of
// images, row r using set r / per_img; words [n, 64] uint32 and bits [n]
// int32 are written.  run, size, code and words 16-byte aligned.  Launches
// on `stream` and returns cudaGetLastError().
extern "C" int sjpeg_vlc_pack(const void* run, const void* size,
                              const void* code, const void* dc_codes,
                              const void* group, const void* dc_lut,
                              const void* ac_lut, void* words, void* bits,
                              int n, int per_img, int n_sets, void* stream) {
  if (n <= 0) return 0;
  if (per_img <= 0 || n_sets < 1 ||
      (((uintptr_t)run | (uintptr_t)size | (uintptr_t)code |
        (uintptr_t)words) & 15))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kThreads - 1) / kThreads);
  vlc_pack_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)run, (const int32_t*)size, (const int32_t*)code,
      (const int32_t*)dc_codes, (const int32_t*)group,
      (const uint32_t*)dc_lut, (const uint32_t*)ac_lut, (uint32_t*)words,
      (int32_t*)bits, n, per_img, n_sets);
  return (int)cudaGetLastError();
}
