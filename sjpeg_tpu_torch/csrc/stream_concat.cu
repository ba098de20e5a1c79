// stream_concat: per-block left-aligned bit streams -> one contiguous
// stream per image, placed at exact bit offsets.
//
// Replaces the TPU kernels of sjpeg_tpu/ops/pallas_tree_concat.py: the
// radix-4/2 merge levels _merge_level (_make_merge4_kernel,
// _make_merge2_kernel) and _merge_level_ll (_make_merge4_kernel_ll), and
// the finisher _finish_units_pallas (_make_finish_kernel).  On the TPU a
// log-depth tree of merges was needed because a grid step cannot scatter;
// here every used word goes straight to its place.
//
// Bound on the H100: bytes.  It reads only the used words (as many bytes
// as the batch's compressed streams) plus 12 bytes of count and offset per
// block, and writes the [n_images, bucket] output once (8 MB at 16 x
// 1024^2).  Design: one thread per (block, word); a thread whose word lies
// past its block's bit count returns at once.  The block's exclusive bit offset within its image
// (a prefix sum, computed by the caller) splits each word into two parts,
// OR-ed with atomicOr into words off / 32 + j and the next one of the
// zero-initialised output row.  Parts from different blocks never share a
// bit, so the order of the atomics does not change the result.  Words past
// `bucket` are dropped; the caller sees that from the exact totals.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWordsPerBlock = 64;

__global__ void __launch_bounds__(kThreads)
stream_concat_kernel(const uint32_t* __restrict__ words,
                     const int32_t* __restrict__ bits,
                     const int64_t* __restrict__ offs,
                     uint32_t* __restrict__ out, int64_t n_words,
                     int per_img, int bucket) {
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= n_words) return;
  const int64_t blk = t / kWordsPerBlock;
  const int j = (int)(t % kWordsPerBlock);
  if (32 * j >= bits[blk]) return;                 // past the block's stream
  const int64_t off = offs[blk];
  const int s = (int)(off & 31);
  const int64_t w = (off >> 5) + j;
  const uint32_t v = words[t];
  uint32_t* row = out + (blk / per_img) * (int64_t)bucket;
  const uint32_t hi = v >> s;
  if (hi && w < bucket) atomicOr(row + w, hi);
  if (s) {
    const uint32_t lo = v << (32 - s);
    if (lo && w + 1 < bucket) atomicOr(row + w + 1, lo);
  }
}

}  // namespace

// words [n, 64] uint32, bits [n] int32, offs [n] int64 (bit offset of each
// block within its image); out [n / per_img, bucket] uint32, zeroed by the
// caller.  Launches on `stream` and returns cudaGetLastError().
extern "C" int sjpeg_stream_concat(const void* words, const void* bits,
                                   const void* offs, void* out, int n,
                                   int per_img, int bucket, void* stream) {
  if (n <= 0) return 0;
  const int64_t n_words = (int64_t)n * kWordsPerBlock;
  const dim3 grid((unsigned)((n_words + kThreads - 1) / kThreads));
  stream_concat_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const int32_t*)bits, (const int64_t*)offs,
      (uint32_t*)out, n_words, per_img, bucket);
  return (int)cudaGetLastError();
}
