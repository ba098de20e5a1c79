// sharp_yuv: the sharp RGB -> YUV 4:2:0 conversion's sweep loop, up to
// four Gauss-Seidel sweeps over the row pairs of each image with the
// per-image divergence exit, in place over int32 planes.
//
// Replaces sjpeg_tpu/sharp_yuv_device.py _sharp_core's lax.while_loop of
// _sharp_iteration's lax.scan (:135-204), which XLA compiles into one
// device loop; there is no Pallas kernel for it.  In eager PyTorch the
// same loop is ~100 launches a row pair, some 200,000 for a 1024^2 batch.
//
// Bound on the H100: the dependent chain, not bytes.  Each row pair reads
// the row above as updated by the previous pair, so an image is a chain of
// h/2 pairs x up to 4 sweeps (2,048 steps at 1024^2, 6,048 at 12 MP); a
// sweep reads and writes ~21 bytes a pixel, ~0.34 GB for 16 x 1024^2,
// ~0.1 ms a sweep at 3.35 TB/s.  Design: one CTA per image, its threads
// across the chroma columns (striding when the row is wider than the
// CTA), one __syncthreads() between row pairs; the gamma tables (1,024 +
// 34 entries, read with divergent indices) and the two-row ring of
// updated chroma in shared memory, the ring in the caller's scratch when
// the row is too wide for it; the exit test per CTA after a block sum of
// the |luma error|, so no host read.  The arithmetic is sharp_core.cuh's.
#include <cuda_runtime.h>
#include <stdint.h>

#define SJ_SHARP_FN __device__ __forceinline__
#include "sharp_core.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kTableWords =
    sjpeg::kGammaToLinearSize + sjpeg::kLinearToGammaSize;
constexpr int kMaxSharedBytes = 227 * 1024 - 1024;   // less `red`

struct DeviceCta {
  int64_t* red;     // [33] shared

  template <typename F>
  __device__ __forceinline__ void columns(int n, F&& f) {
    for (int j = threadIdx.x; j < n; j += blockDim.x) f(j);
  }
  __device__ __forceinline__ void sync() { __syncthreads(); }
  __device__ int64_t sum(int64_t v) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
    for (int o = 16; o; o >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, o);
    if (lane == 0) red[warp] = v;
    __syncthreads();
    if (warp == 0) {
      v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0;
#pragma unroll
      for (int o = 16; o; o >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, o);
      if (lane == 0) red[32] = v;
    }
    __syncthreads();
    const int64_t total = red[32];
    __syncthreads();                  // red is free for the next sum
    return total;
  }
};

__global__ void __launch_bounds__(kMaxThreads)
sharp_kernel(int32_t* y, int32_t* uv, const int32_t* ty,
             const int32_t* tuv, const int32_t* g2l, const int32_t* l2g,
             int32_t* scratch, int32_t* iters, int w, int h,
             int ring_in_shared) {
  extern __shared__ int32_t smem[];
  __shared__ int64_t red[33];
  for (int i = threadIdx.x; i < kTableWords; i += blockDim.x)
    smem[i] = i < sjpeg::kGammaToLinearSize
                  ? g2l[i]
                  : l2g[i - sjpeg::kGammaToLinearSize];
  __syncthreads();
  const int64_t b = blockIdx.x;
  const int64_t plane = (int64_t)w * h, ring = (int64_t)w * 3;   // 2 rows
  const sjpeg::SharpImage im{
      y + b * plane, uv + b * (plane / 4) * 3, ty + b * plane,
      tuv + b * (plane / 4) * 3,
      ring_in_shared ? smem + kTableWords : scratch + b * ring, w, h};
  DeviceCta cta{red};
  const int it = sjpeg::sharp_image(
      cta, sjpeg::SharpTables{smem, smem + sjpeg::kGammaToLinearSize}, im);
  if (threadIdx.x == 0) iters[b] = it;
}

}  // namespace

// y, ty [b, h, w]; uv, tuv [b, h/2, w/2, 3]; int32, w and h even and >= 6.
// y and uv are updated in place; iters [b] int32 gets each image's sweep
// count.  g2l [1024] and l2g [34] are the gamma tables; scratch [b, 2,
// w/2, 3] int32 holds the ring of updated rows when it does not fit in
// shared memory.  Launches on `stream` and returns cudaGetLastError().
extern "C" int sjpeg_sharp_yuv(void* y, void* uv, const void* ty,
                               const void* tuv, const void* g2l,
                               const void* l2g, void* scratch, void* iters,
                               int b, int w, int h, void* stream) {
  if (b <= 0) return 0;
  if (w < 6 || h < 6 || (w | h) & 1) return (int)cudaErrorInvalidValue;
  const int uv_w = w >> 1;
  const int threads =
      uv_w < kMaxThreads ? (uv_w + 31) / 32 * 32 : kMaxThreads;
  const size_t table_bytes = kTableWords * sizeof(int32_t);
  const size_t ring_bytes = (size_t)2 * uv_w * 3 * sizeof(int32_t);
  const int ring_in_shared = table_bytes + ring_bytes <= kMaxSharedBytes;
  const size_t shared = table_bytes + (ring_in_shared ? ring_bytes : 0);
  if (shared > 40 * 1024) {     // past the default 48 KB with `red`
    const cudaError_t e = cudaFuncSetAttribute(   // the same value always
        sharp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSharedBytes);
    if (e != cudaSuccess) return (int)e;
  }
  sharp_kernel<<<b, threads, shared, (cudaStream_t)stream>>>(
      (int32_t*)y, (int32_t*)uv, (const int32_t*)ty, (const int32_t*)tuv,
      (const int32_t*)g2l, (const int32_t*)l2g, (int32_t*)scratch,
      (int32_t*)iters, w, h, ring_in_shared);
  return (int)cudaGetLastError();
}
