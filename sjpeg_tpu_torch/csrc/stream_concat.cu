// stream_concat: per-block left-aligned bit streams -> one contiguous
// stream per image, placed at exact bit offsets, with each image's exact
// total.
//
// Replaces the TPU kernels of sjpeg_tpu/ops/pallas_tree_concat.py: the
// radix-4/2 merge levels _merge_level (_make_merge4_kernel,
// _make_merge2_kernel) and _merge_level_ll (_make_merge4_kernel_ll), and
// the finisher _finish_units_pallas (_make_finish_kernel).  On the TPU a
// log-depth tree of merges was needed because a grid step cannot scatter,
// and the merge levels computed the placement offsets from the lengths;
// here each block goes straight to its place, and the op's own two
// launches compute the offsets.
//
// Bound on the H100: bytes.  It reads only the used words (as many bytes
// as the batch's compressed streams) plus 4 bytes of count per block, and
// writes the [n_images, bucket] output once (8 MB at 16 x 1024^2; the
// caller zeroes it).  Design: reduce-then-scan over chunks of kChunk
// blocks that never cross an image boundary, grid n_images x chunks.
// Launch 1 writes each chunk's bit sum.  Launch 2 sums, in each CTA, the
// sums of its image's earlier chunks, scans its own chunk's counts (warp
// shuffles, then the warp totals) and places each block with one thread:
// concat_core.cuh's place_block walks the block's ceil(bits / 32) used
// words, joins neighbours with a funnel shift, stores the span's inner
// output words plainly and OR-s only its first and last word, the two a
// neighbour may share, with atomicOr.  Parts from different blocks never
// share a bit, so the order of the atomics does not change the result.
// The last chunk of each image writes its total.  Words past `bucket` are
// dropped; the caller sees that from the exact totals.
#include <cuda_runtime.h>
#include <stdint.h>

#include "concat_core.cuh"

namespace {

constexpr int kChunk = 256;            // blocks per chunk, one per thread
constexpr int kWarps = kChunk / 32;
constexpr int kWordsPerBlock = 64;

struct AtomicOr {
  __device__ void operator()(uint32_t* p, uint32_t v) const {
    atomicOr(p, v);
  }
};

// The sum of v over the CTA, returned to every thread.
template <typename T>
__device__ T cta_sum(T v, T* scratch) {
  for (int d = 16; d; d >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, d);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  T t = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += scratch[w];
  return t;
}

__global__ void __launch_bounds__(kChunk)
chunk_sums_kernel(const int32_t* __restrict__ bits, int32_t* __restrict__ sums,
                  int per_img, int chunks) {
  __shared__ int32_t scratch[kWarps];
  const int img = blockIdx.x / chunks;
  const int i = (blockIdx.x - img * chunks) * kChunk + threadIdx.x;
  const int v = i < per_img ? bits[(int64_t)img * per_img + i] : 0;
  const int t = cta_sum(v, scratch);
  if (threadIdx.x == 0) sums[blockIdx.x] = t;
}

__global__ void __launch_bounds__(kChunk)
place_kernel(const uint32_t* __restrict__ words,
             const int32_t* __restrict__ bits,
             const int32_t* __restrict__ sums, uint32_t* __restrict__ out,
             int32_t* __restrict__ totals, int per_img, int chunks,
             int bucket) {
  __shared__ int64_t scratch64[kWarps];
  __shared__ int32_t scratch32[kWarps];
  const int img = blockIdx.x / chunks;
  const int c = blockIdx.x - img * chunks;
  const int i = c * kChunk + threadIdx.x;
  const int64_t blk = (int64_t)img * per_img + i;
  const int nb = i < per_img ? bits[blk] : 0;

  // bits of the image's earlier chunks
  int64_t base = 0;
  for (int j = threadIdx.x; j < c; j += kChunk)
    base += sums[(int64_t)img * chunks + j];
  base = cta_sum(base, scratch64);

  // inclusive scan of the chunk's counts
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = nb;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) scratch32[warp] = incl;
  __syncthreads();
  for (int w = 0; w < warp; ++w) incl += scratch32[w];

  const int64_t end = base + incl;
  if (c == chunks - 1 && threadIdx.x == kChunk - 1)
    totals[img] = (int32_t)end;
  if (nb > 0)
    sjpeg::place_block(words + blk * kWordsPerBlock, nb, end - nb,
                       out + (int64_t)img * bucket, bucket, AtomicOr{});
}

}  // namespace

// words [n, 64] uint32 (each block's stream left-aligned, zero past its
// count), bits [n] int32, n = n_images * per_img, image-major; sums
// [n_sums] int32 scratch, n_sums >= n_images * ceil(per_img / 256); out
// [n_images, bucket] uint32, zeroed by the caller; totals [n_images] int32
// (each image's exact bit count, mod 2^32).  Two launches on `stream`;
// returns cudaGetLastError().
extern "C" int sjpeg_stream_concat_scan(const void* words, const void* bits,
                                        void* sums, void* out, void* totals,
                                        int n, int per_img, int bucket,
                                        int n_sums, void* stream) {
  if (n <= 0) return 0;
  if (per_img <= 0 || n % per_img || bucket <= 0)
    return (int)cudaErrorInvalidValue;
  const int chunks = (per_img + kChunk - 1) / kChunk;
  const int64_t grid = (int64_t)(n / per_img) * chunks;
  if (grid > n_sums) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  chunk_sums_kernel<<<(unsigned)grid, kChunk, 0, s>>>(
      (const int32_t*)bits, (int32_t*)sums, per_img, chunks);
  place_kernel<<<(unsigned)grid, kChunk, 0, s>>>(
      (const uint32_t*)words, (const int32_t*)bits, (const int32_t*)sums,
      (uint32_t*)out, (int32_t*)totals, per_img, chunks, bucket);
  return (int)cudaGetLastError();
}
