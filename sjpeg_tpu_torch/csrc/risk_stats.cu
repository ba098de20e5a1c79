// risk_stats: the riskiness reduction behind YUV_AUTO, in one pass over
// [B, H, W, 3] uint8 RGB: per interior position (y < H-1, x < W-1) the
// three neighbour pairs (right, down, the two neighbours) are scored, and
// three per-image int64 sums are taken: the scores over the noise level,
// their count, and the gray pixels.
//
// Replaces sjpeg_tpu/ops/riskiness.py risk_stats (:86-105), which XLA
// fuses into one pass; there is no Pallas kernel for it.  In eager
// PyTorch the same function is ~30 element-wise passes over int32
// intermediates.
//
// Bound on the H100: the input, 3 bytes a pixel read once (50.3 MB at
// 16 x 1024^2, 0.015 ms at 3.35 TB/s), against ~100 integer operations a
// position for the closed-form scores; issue-bound in practice.  Design: a
// CTA first fills a shared table of the 2,401 pair scores (risk_core.cuh's
// risk_key_score, the exact closed form), so a pair costs two differences,
// a key and one shared load.  A thread walks one column down a strip of
// kRows rows, its loads kChunk rows ahead of their scoring, keeping the
// previous row's levels of its pixel and of its right neighbour in
// registers; each pixel's levels are computed once, by its own thread, and
// reach the thread on its left by a warp shuffle (the last lane of a warp
// computes its right neighbour's itself).  The sums are
// exact integers in any order: warp shuffles, one block sum, and one
// unsigned 64-bit atomicAdd a CTA for each of the three sums of its image.
#include <cuda_runtime.h>
#include <stdint.h>

#include "risk_core.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;
constexpr int kChunk = 8;          // rows loaded ahead of their scoring

__device__ __forceinline__ sjpeg::RiskLevel level_at(const uint8_t p[3]) {
  return sjpeg::risk_level(p[0], p[1], p[2]);
}

__device__ __forceinline__ int64_t warp_sum(int64_t v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, o);
  return v;
}

// The levels of this thread's pixel (own, if it is in the image) and of
// its right neighbour (if this pixel is interior): from the next lane, or,
// in the last lane of a warp, from the neighbour's bytes loaded here.
__device__ __forceinline__ void levels_of(const uint8_t own_px[3],
                                          const uint8_t right_px[3],
                                          bool in_image, bool inside,
                                          sjpeg::RiskLevel& own,
                                          sjpeg::RiskLevel& right) {
  own = in_image ? level_at(own_px) : sjpeg::RiskLevel{0, 0, 0};
  const int packed = own.y | own.u << 8 | own.v << 16;
  const int next = __shfl_down_sync(0xFFFFFFFFu, packed, 1);
  right = {next & 0xFF, next >> 8 & 0xFF, next >> 16};
  if ((threadIdx.x & 31) == 31 && inside) right = level_at(right_px);
}

__global__ void __launch_bounds__(kThreads)
risk_kernel(const uint8_t* rgb, unsigned long long* out, int h, int w) {
  __shared__ uint8_t table[sjpeg::kRiskKeys];
  __shared__ int64_t red[3][kThreads / 32];
  for (int i = threadIdx.x; i < sjpeg::kRiskKeys; i += kThreads)
    table[i] = (uint8_t)sjpeg::risk_key_score(i);
  __syncthreads();
  const int x = blockIdx.x * kThreads + threadIdx.x;
  const int y0 = blockIdx.y * kRows;
  const int y1 = min(y0 + kRows, h - 1);
  const int64_t b = blockIdx.z;
  // every lane runs the walk, so the shuffles have all 32; the lanes past
  // the last interior column add nothing
  const bool in_image = x < w, inside = x < w - 1;
  const bool edge_lane = (threadIdx.x & 31) == 31 && inside;
  const int64_t stride = (int64_t)w * 3;
  const uint8_t* px = rgb + (b * h + y0) * stride + (int64_t)x * 3;
  auto score = [&](const sjpeg::RiskLevel& a, const sjpeg::RiskLevel& c) {
    return (int32_t)table[sjpeg::risk_key(a, c)];
  };
  sjpeg::RiskSums s{0, 0, 0};
  sjpeg::RiskLevel l0, l1;
  {
    uint8_t own[3] = {0, 0, 0}, right[3] = {0, 0, 0};
    for (int c = 0; c < 3; ++c) {
      if (in_image) own[c] = px[c];
      if (edge_lane) right[c] = px[3 + c];
    }
    levels_of(own, right, in_image, inside, l0, l1);
  }
  for (int y = y0; y < y1; y += kChunk) {
    // the chunk's rows are loaded first, so kChunk loads are in flight
    uint8_t own[kChunk][3], right[kChunk][3];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const uint8_t* row = px + (y - y0 + 1 + i) * stride;
      const bool live = y + i < y1;
      for (int c = 0; c < 3; ++c) {
        own[i][c] = live && in_image ? row[c] : 0;
        right[i][c] = live && edge_lane ? row[3 + c] : 0;
      }
    }
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      if (y + i >= y1) break;                  // the same in every lane
      sjpeg::RiskLevel n0, n1;
      levels_of(own[i], right[i], in_image, inside, n0, n1);
      if (inside) sjpeg::risk_position(l0, l1, n0, score, s);
      l0 = n0;
      l1 = n1;
    }
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t v[3] = {warp_sum(s.score), warp_sum(s.count),
                        warp_sum(s.gray)};
  if (lane == 0)
    for (int i = 0; i < 3; ++i) red[i][warp] = v[i];
  __syncthreads();
  if (threadIdx.x < 3) {
    int64_t total = 0;
    for (int i = 0; i < kThreads / 32; ++i) total += red[threadIdx.x][i];
    if (total) atomicAdd(out + b * 3 + threadIdx.x, (unsigned long long)total);
  }
}

}  // namespace

// rgb [b, h, w, 3] uint8, contiguous; out [b, 3] int64, zeroed by the
// caller, gets (score sum, count, gray count) of each image.  Images with
// no interior position (h < 2 or w < 2) launch nothing.  Launches on
// `stream` and returns the CUDA error code.
extern "C" int sjpeg_risk_stats(const void* rgb, void* out, int b, int h,
                                int w, void* stream) {
  if (b <= 0 || h < 2 || w < 2) return 0;
  if (b > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((w - 1 + kThreads - 1) / kThreads,
                  (h - 1 + kRows - 1) / kRows, b);
  risk_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)rgb, (unsigned long long*)out, h, w);
  return (int)cudaGetLastError();
}
