// trellis: MCU-interleaved fDCT coefficients -> trellis-quantized levels
// (methods 7 and 8), with shared or per-image quantizers and rate tables.
//
// Replaces the TPU kernel sjpeg_tpu/ops/pallas_trellis.py
// trellis_quantize_pallas (_trellis_kernel with one [2, 256] rate table,
// _trellis_kernel_sets with one per image).  The TPU kernel ran the search
// as a dense 128-slot lattice, blocks on the lanes, with scores biased by
// 2^31 for signed compares and rate lookups as one-hot matmuls, and it
// took per-block [N, 64] quantizer rows expanded in device memory.  Here
// one thread runs one block's sparse node search (trellis_core.cuh) with
// native uint32 scores, and selects its image's and group's matrices and
// rate table itself, so nothing is expanded or padded.
//
// Bound on the H100: bytes, on paper.  At 16 x 1024^2 4:2:0 (N = 393,216
// blocks) it reads 100.7 MB of coefficients and 1.6 MB of groups and
// writes 100.7 MB of levels: ~203 MB, ~0.061 ms at 3.35 TB/s.  The search
// is serial within a block (each position searches every earlier node),
// about 15 32-bit operations per evaluated score, so the operations bound
// depends on the data; chip_smoke.py counts it.  Design, simple first:
// 128 blocks per CTA, one per thread; the rows are staged through shared
// memory with coalesced loads and the levels leave the same way; the
// quantizer and rate-table sets of the (at most two) images a CTA's rows
// span are staged in shared memory, and a CTA spanning more images (images
// under 128 blocks) reads its rows' sets from global memory.  Each thread
// keeps its <= 127 nodes (8 bytes each) in local memory.  Measured on the
// H100 (PERF.md): divergence leads, since the same rows sorted by search
// work take about half the time; a warp per block (lanes over nodes,
// shuffle reductions) issues more instructions than it saves and is no
// faster; a thread per block over its coded positions only, on rows
// ranked by work within the CTA, comes near half (ROADMAP S1).
#include <cuda_runtime.h>
#include <stdint.h>

#include "trellis_core.cuh"

namespace {

constexpr int kThreads = 128;   // blocks per CTA, one per thread
constexpr int kStride = 65;     // padded shared-memory row, in words
constexpr int kMatSet = 2 * 64; // one image's quantizer rows
constexpr int kLtSet = 2 * 256; // one image's AC code lengths

__device__ const int kZigzag[64] = SJPEG_ZIGZAG;

// First staged set and the number staged (<= 2) for rows [n0, n0 + rows).
__device__ void staged_sets(int64_t n0, int rows, int per_img, int sets,
                            int& lo, int& count) {
  lo = sets > 1 ? (int)(n0 / per_img) : 0;
  const int hi = sets > 1 ? (int)((n0 + rows - 1) / per_img) : 0;
  count = min(hi - lo + 1, 2);
}

__global__ void __launch_bounds__(kThreads)
trellis_kernel(const int32_t* __restrict__ coeffs,
               const int32_t* __restrict__ group,
               const int32_t* __restrict__ iquant,
               const int32_t* __restrict__ ibias,
               const int32_t* __restrict__ quant,
               const int32_t* __restrict__ lt_lens,
               int32_t* __restrict__ out, int n, int per_img, int mat_sets,
               int lt_sets) {
  __shared__ int32_t buf[kThreads * kStride];
  __shared__ int32_t s_iq[2 * kMatSet], s_ib[2 * kMatSet], s_qq[2 * kMatSet];
  __shared__ int32_t s_lt[2 * kLtSet];
  __shared__ int s_zz[64];
  const int tid = threadIdx.x;
  const int64_t n0 = (int64_t)blockIdx.x * kThreads;
  const int rows = (int)min((int64_t)kThreads, (int64_t)n - n0);

  int m_lo, m_count, l_lo, l_count;
  staged_sets(n0, rows, per_img, mat_sets, m_lo, m_count);
  staged_sets(n0, rows, per_img, lt_sets, l_lo, l_count);
  for (int i = tid; i < m_count * kMatSet; i += kThreads) {
    const int64_t src = (int64_t)m_lo * kMatSet + i;
    s_iq[i] = iquant[src];
    s_ib[i] = ibias[src];
    s_qq[i] = quant[src];
  }
  for (int i = tid; i < l_count * kLtSet; i += kThreads)
    s_lt[i] = lt_lens[(int64_t)l_lo * kLtSet + i];
  if (tid < 64) s_zz[tid] = kZigzag[tid];
  const int64_t off = n0 * 64;
  for (int i = tid; i < rows * 64; i += kThreads)
    buf[(i >> 6) * kStride + (i & 63)] = coeffs[off + i];
  __syncthreads();

  if (tid < rows) {
    const int64_t b = n0 + tid;
    const int g = group[b] & 1;
    const int ms = mat_sets > 1 ? (int)(b / per_img) : 0;
    const int ls = lt_sets > 1 ? (int)(b / per_img) : 0;
    const int32_t *iq, *ib, *qq, *lt;
    if (ms - m_lo < m_count) {
      const int o = (ms - m_lo) * kMatSet + 64 * g;
      iq = s_iq + o;
      ib = s_ib + o;
      qq = s_qq + o;
    } else {
      const int64_t o = (int64_t)ms * kMatSet + 64 * g;
      iq = iquant + o;
      ib = ibias + o;
      qq = quant + o;
    }
    lt = ls - l_lo < l_count ? s_lt + (ls - l_lo) * kLtSet + 256 * g
                             : lt_lens + (int64_t)ls * kLtSet + 256 * g;
    int32_t* row = buf + tid * kStride;
    sjpeg::trellis_block(row, s_zz, iq, ib, qq, lt, row);
  }
  __syncthreads();

  int32_t* dst = out + off;
  for (int i = tid; i < rows * 64; i += kThreads)
    dst[i] = buf[(i >> 6) * kStride + (i & 63)];
}

}  // namespace

// coeffs [n, 64] int32 raster coefficients (x16); group [n] int32;
// iquant, ibias, quant [mat_sets, 2, 64] int32 matrices and lt_lens
// [lt_sets, 2, 256] int32 AC code lengths, each set count 1 (shared) or the
// number of images, row r using set r / per_img; out [n, 64] int32 raster
// levels is written.  Launches on `stream` and returns cudaGetLastError().
extern "C" int sjpeg_trellis(const void* coeffs, const void* group,
                             const void* iquant, const void* ibias,
                             const void* quant, const void* lt_lens,
                             void* out, int n, int per_img, int mat_sets,
                             int lt_sets, void* stream) {
  if (n <= 0) return 0;
  if (per_img <= 0 || mat_sets < 1 || lt_sets < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kThreads - 1) / kThreads);
  trellis_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)coeffs, (const int32_t*)group, (const int32_t*)iquant,
      (const int32_t*)ibias, (const int32_t*)quant, (const int32_t*)lt_lens,
      (int32_t*)out, n, per_img, mat_sets, lt_sets);
  return (int)cudaGetLastError();
}
