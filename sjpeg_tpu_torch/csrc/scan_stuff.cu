// scan_stuff: each image's compacted stream (stream_concat's [B, bucket]
// words and exact totals) -> its finished entropy-coded segment: the last
// byte's '1' padding and a 0x00 after every 0xFF byte, bit-exact to
// native_host.cc's sjpeg_words_to_scan.
//
// Replaces no TPU kernel: the JAX package stuffs on the host in C++
// (sjpeg_tpu/native, words_to_scan), as the port did until this kernel.
// On the card the host waited for the fetch of the words and then walked
// each scan a byte at a time, with the card idle; here the host fetches
// finished bytes and only joins the headers to them.
//
// Bound on the H100: bytes, and little of them: the scan's words read once
// (~2.2 MB for a 12-MP photo, ~5.5 MB for 16 x 1024^2) and about as many
// bytes written (0xFF bytes are ~0.6-1% of a scan; at most every byte).
// The rows are each image's worst case (a photo's is 73 MB of words), so
// the design touches only the tiles that hold scan bytes.  A tile is
// kStuffTileWords words, four consecutive words a thread.  Two launches
// over a grid of about eight CTAs an SM, images on y and each image's
// tiles strided over x up to the last that holds its scan (a count each
// CTA reads from the image's total): (1) each tile's 0xFF count, a CTA sum
// of the threads' __popc counts; (2) each tile sums the counts of its
// image's earlier tiles, scans its threads' counts (warp shuffles, then
// the warp totals), each thread writes its bytes, a 0x00 after each 0xFF,
// into the stuffed tile in shared memory, and the CTA stores the tile in
// order, a byte a thread, at its byte offset plus the image's earlier
// 0xFF bytes (stores from each thread's own offset would touch each
// 32-byte sector 16 times over).  The last tile of an image writes its
// stuffed length; an empty scan's first CTA writes 0.  The output is
// allocated, never filled: only each row's first `lengths` bytes are set.
#include <cuda_runtime.h>
#include <stdint.h>

#include "stuff_core.cuh"

namespace {

using sjpeg::kStuffThreads;
using sjpeg::kStuffTileBytes;
constexpr int kWarps = kStuffThreads / 32;
constexpr int kCtasPerSm = 8;
constexpr int kMaxGridY = 65535;

// The sum of v over the CTA, returned to every thread; `scratch` is free
// again when it returns.
template <typename T>
__device__ T cta_sum(T v, T* scratch) {
  for (int d = 16; d; d >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, d);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  T t = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += scratch[w];
  __syncthreads();
  return t;
}

__global__ void __launch_bounds__(kStuffThreads)
stuff_counts_kernel(const uint32_t* __restrict__ words,
                    const int32_t* __restrict__ totals,
                    int32_t* __restrict__ counts, int64_t bucket,
                    int64_t tiles_max, int n_images) {
  __shared__ int32_t scratch[kWarps];
  for (int64_t img = blockIdx.y; img < n_images; img += gridDim.y) {
    const sjpeg::ScanRow r = sjpeg::scan_row(totals[img], bucket);
    for (int64_t t = blockIdx.x; t < sjpeg::scan_tiles(r); t += gridDim.x) {
      uint32_t w[sjpeg::kStuffWordsPerThread];
      const int ff = cta_sum(sjpeg::load_thread_words(
          words + img * bucket, t, threadIdx.x, r, w), scratch);
      if (threadIdx.x == 0) counts[img * tiles_max + t] = ff;
    }
  }
}

__global__ void __launch_bounds__(kStuffThreads)
stuff_place_kernel(const uint32_t* __restrict__ words,
                   const int32_t* __restrict__ totals,
                   const int32_t* __restrict__ counts,
                   uint8_t* __restrict__ out, int32_t* __restrict__ lengths,
                   int64_t bucket, int64_t tiles_max, int n_images) {
  __shared__ int64_t scratch64[kWarps];
  __shared__ int32_t scratch32[kWarps];
  __shared__ uint8_t stage[2 * kStuffTileBytes];   // the tile, stuffed
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int64_t img = blockIdx.y; img < n_images; img += gridDim.y) {
    const sjpeg::ScanRow r = sjpeg::scan_row(totals[img], bucket);
    const int64_t n_t = sjpeg::scan_tiles(r);
    if (n_t == 0 && blockIdx.x == 0 && threadIdx.x == 0) lengths[img] = 0;
    for (int64_t t = blockIdx.x; t < n_t; t += gridDim.x) {
      // 0xFF bytes of the image's earlier tiles
      int64_t base = 0;
      for (int64_t j = threadIdx.x; j < t; j += kStuffThreads)
        base += counts[img * tiles_max + j];
      base = cta_sum(base, scratch64);

      uint32_t w[sjpeg::kStuffWordsPerThread];
      const int ff = sjpeg::load_thread_words(words + img * bucket, t,
                                              threadIdx.x, r, w);
      // inclusive scan of the threads' counts
      int incl = ff;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xFFFFFFFFu, incl, d);
        if (lane >= d) incl += y;
      }
      if (lane == 31) scratch32[warp] = incl;
      __syncthreads();
      int tile_ff = 0;
#pragma unroll
      for (int v = 0; v < kWarps; ++v) {
        if (v < warp) incl += scratch32[v];
        tile_ff += scratch32[v];
      }
      // the tile stuffed in shared memory, then stored in order, a byte a
      // thread: a warp's stores cover 32 consecutive bytes
      sjpeg::emit_thread_words(w, t, threadIdx.x, r,
                               stage + 4 * sjpeg::kStuffWordsPerThread
                                           * threadIdx.x + (incl - ff));
      __syncthreads();
      const int n_out = sjpeg::tile_bytes(t, r) + tile_ff;
      uint8_t* dst = out + img * 8 * bucket + t * kStuffTileBytes + base;
      for (int i = threadIdx.x; i < n_out; i += kStuffThreads)
        dst[i] = stage[i];
      if (t == n_t - 1 && threadIdx.x == 0)
        lengths[img] = (int32_t)(r.n_bytes + base + tile_ff);
      __syncthreads();          // scratch32 and stage free for the next tile
    }
  }
}

}  // namespace

// words [n_images, bucket] uint32 (MSB-first streams, zero past each
// image's total bits); totals [n_images] int32; counts [n_images *
// tiles_max] int32 scratch, tiles_max = ceil(bucket / kStuffTileWords);
// out [n_images, 8 * bucket] uint8 (unfilled); lengths [n_images] int32.
// Two launches on `stream`; returns cudaGetLastError().
extern "C" int sjpeg_scan_stuff(const void* words, const void* totals,
                                void* counts, void* out, void* lengths,
                                int n_images, int bucket, void* stream) {
  if (n_images <= 0) return 0;
  if (bucket <= 0) return (int)cudaErrorInvalidValue;
  const int64_t tiles_max =
      ((int64_t)bucket + sjpeg::kStuffTileWords - 1) / sjpeg::kStuffTileWords;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  // images on y, each image's tiles over x: about kCtasPerSm CTAs an SM
  const int64_t gy = n_images < kMaxGridY ? n_images : kMaxGridY;
  const int64_t gx = (int64_t)sms * kCtasPerSm / gy;
  const dim3 grid((unsigned)(gx < 1 ? 1 : gx < tiles_max ? gx : tiles_max),
                  (unsigned)gy);
  const cudaStream_t s = (cudaStream_t)stream;
  stuff_counts_kernel<<<grid, kStuffThreads, 0, s>>>(
      (const uint32_t*)words, (const int32_t*)totals, (int32_t*)counts,
      bucket, tiles_max, n_images);
  stuff_place_kernel<<<grid, kStuffThreads, 0, s>>>(
      (const uint32_t*)words, (const int32_t*)totals,
      (const int32_t*)counts, (uint8_t*)out, (int32_t*)lengths, bucket,
      tiles_max, n_images);
  return (int)cudaGetLastError();
}
