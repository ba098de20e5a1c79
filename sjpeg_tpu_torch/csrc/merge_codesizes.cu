// merge_codesizes: the batched Huffman merge loop -> per-symbol code sizes.
//
// Replaces the TPU kernel sjpeg_tpu/ops/huffman_device.py
// _merge_codesizes_pallas (_merge_kernel).  Each of G independent rows
// holds a merge state over W slots (W = 16 for DC tables, 320 for AC):
// frequency, active flag, component id and code size, plus the row's count
// of active nodes.  One step of a row with more than one active node:
//   i2 = the active slot with the smallest (freq, slot),
//   i1 = the active slot with the next smallest (freq, slot),
//   freq[i1] += freq[i2]; slot i2 retires;
//   every slot whose component is i1 or i2 gets one more bit of code size
//   and joins component i1.
// Frequencies are int32 and add with wraparound, as in the JAX version.
//
// Bound on the H100: neither bytes nor operations.  At B = 16 the two
// launches (DC, AC) see G = 32 rows each and move ~0.2 MB; the AC launch
// does ~32 x 320 x 255 x 12 ~ 31 M operations (~0.5 us at 67 T/s).  What
// holds it is its chain of up to 255 dependent steps per row.  Design: one
// warp per row, the row's slots in registers (slot lane + 32 j, at most 10
// a lane).  Each step finds the two smallest 64-bit keys
// ((freq ^ 0x80000000) << 32 | slot: signed order on frequency, ties to the
// lower slot exactly as the JAX argmin) with one lane-local pass and one
// warp-shuffle reduction of (smallest, second smallest) pairs, then updates
// its slots.  A row stops once one node is left; the remaining steps of the
// JAX loop are no-ops for it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;          // rows per CTA, one warp each
constexpr int kMaxPerLane = 10;    // W <= 32 * 10
constexpr unsigned kFull = 0xFFFFFFFFu;
using u64 = unsigned long long;    // the type __shfl_xor_sync takes

__device__ __forceinline__ u64 key_of(int32_t freq, int slot) {
  return ((u64)((uint32_t)freq ^ 0x80000000u) << 32) | (uint32_t)slot;
}

__global__ void __launch_bounds__(kWarps * 32)
merge_codesizes_kernel(const int32_t* __restrict__ freqw,
                       const int32_t* __restrict__ active,
                       const int32_t* __restrict__ comp,
                       const int32_t* __restrict__ cs,
                       const int32_t* __restrict__ nleft,
                       int32_t* __restrict__ out, int G, int W, int steps) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= G) return;                      // the whole warp leaves
  const int64_t base = (int64_t)row * W;

  int32_t f[kMaxPerLane], c[kMaxPerLane], s[kMaxPerLane];
  uint32_t act = 0;                          // bit j: slot lane + 32 j
#pragma unroll
  for (int j = 0; j < kMaxPerLane; ++j) {
    const int slot = lane + 32 * j;
    f[j] = 0;
    c[j] = -1;
    s[j] = 0;
    if (slot < W) {
      f[j] = freqw[base + slot];
      c[j] = comp[base + slot];
      s[j] = cs[base + slot];
      if (active[base + slot]) act |= 1u << j;
    }
  }

  int left = nleft[row];
  for (int step = 0; step < steps && left > 1; ++step, --left) {
    u64 a = ~0ull, b = ~0ull;           // two smallest keys, a < b
#pragma unroll
    for (int j = 0; j < kMaxPerLane; ++j) {
      if (!((act >> j) & 1u)) continue;
      const u64 k = key_of(f[j], lane + 32 * j);
      if (k < a) {
        b = a;
        a = k;
      } else if (k < b) {
        b = k;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const u64 oa = __shfl_xor_sync(kFull, a, o);
      const u64 ob = __shfl_xor_sync(kFull, b, o);
      const u64 lo = a < oa ? a : oa, hi = a < oa ? oa : a;
      const u64 m = b < ob ? b : ob;
      b = hi < m ? hi : m;
      a = lo;
    }
    const int i2 = (int)(uint32_t)a, i1 = (int)(uint32_t)b;
    const uint32_t f1 = (uint32_t)(a >> 32) ^ 0x80000000u;
#pragma unroll
    for (int j = 0; j < kMaxPerLane; ++j) {
      const int slot = lane + 32 * j;
      if (slot == i1) f[j] = (int32_t)((uint32_t)f[j] + f1);
      if (slot == i2) act &= ~(1u << j);
      if (c[j] == i1 || c[j] == i2) {
        s[j] += 1;
        c[j] = i1;
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kMaxPerLane; ++j) {
    const int slot = lane + 32 * j;
    if (slot < W) out[base + slot] = s[j];
  }
}

}  // namespace

// freqw, active (0/1), comp, cs [G, W] int32 and nleft [G] int32 merge
// state; out [G, W] int32 receives the code sizes after `steps` steps.
// W <= 320.  Launches on `stream` and returns cudaGetLastError().
extern "C" int sjpeg_merge_codesizes(const void* freqw, const void* active,
                                     const void* comp, const void* cs,
                                     const void* nleft, void* out, int G,
                                     int W, int steps, void* stream) {
  if (G <= 0 || W <= 0) return 0;
  if (W > 32 * kMaxPerLane) return (int)cudaErrorInvalidValue;
  const dim3 grid((G + kWarps - 1) / kWarps);
  merge_codesizes_kernel<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const int32_t*)freqw, (const int32_t*)active, (const int32_t*)comp,
      (const int32_t*)cs, (const int32_t*)nleft, (int32_t*)out, G, W, steps);
  return (int)cudaGetLastError();
}
