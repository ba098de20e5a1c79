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
// depends on the data; chip_smoke.py counts it.
//
// Design: one op, four launches, no host read.  A block's search work
// grows with the square of its coded positions, and a warp of 32 blocks
// waits for its heaviest one: on the first kernel of this port (a thread
// a block in row order) the same rows sorted by work took about half the
// time.  So the op ranks its rows first:
// 1. work pass (trellis_work_kernel): a thread a block, a CTA a chunk of
//    256 rows, rows loaded 16 B at a time: its class (trellis_core.cuh
//    trellis_class: the count of nonzero bias-quantized AC values, 0..63),
//    its rank among the chunk's rows of that class (a warp match, then the
//    warps' prefix), both into a 16-bit key a row, and the chunk's class
//    histogram, class-major.  A class-0 block opens no node: the CTA's
//    threads write its levels (the DC alone) together, and no later step
//    reads its row;
// 2. class starts (trellis_scan_kernel, a CTA a class): each chunk's start
//    among the class's rows, an exclusive scan of the class's histogram
//    row, and the class's total;
// 3. scatter (trellis_scatter_kernel, a CTA a chunk, a thread a row): a
//    row of class c > 0 goes to `order` after every heavier class's rows,
//    the class's rows of the earlier chunks and its rank: a stable counting
//    sort, heaviest class first, deterministic.  Every step so far reads
//    or writes a fixed number of bytes a row or a chunk, so the ranking
//    grows with the rows, however they spread over the classes;
// 4. search (trellis_search_kernel): a CTA takes 128 consecutive entries
//    of `order` (the rows of classes above 0), one a thread.  Each thread
//    loads its row into registers, 16 B at a time, and runs its block's search
//    (trellis_core.cuh trellis_search): a first pass keeps the coded
//    positions, then the warp's threads step through their t-th coded
//    positions together, so that rows of one class run the same steps; the
//    candidates of a position scan the node keys and positions four at a
//    time, one scan shape a warp (a vote); the levels go straight out, 16 B
//    at a time.  No row is staged in shared memory: the CTA keeps 8,448 B,
//    so that most of the SM's 256 KB stays L1 for the threads' node arrays
//    in local memory (1,552 B a thread).  A CTA wholly past the rows
//    placed returns at once.
// The stable sort keeps row order within a class, and rows are image-major,
// so a CTA's rows mostly come from one or two images: the quantizer and
// rate-table sets of its first and last rows' images are staged in shared
// memory, and a row of any other image (at class boundaries, rare heavy
// classes, images under 128 blocks) reads its sets from global memory,
// through a second instance of the search.
// Measured on the H100 at 16 x 1024^2 (scripts/torch_kernel_probe.py,
// parent and change in one call; PERF.md section 6): the op ~0.8 ms
// against the first kernel's 1.98 (work pass ~66 us, class starts ~2.5,
// scatter ~6.7, search ~630); four times the rows, 0.37-0.38 x.  A
// ranking CTA a chunk that summed every chunk's histogram, the first
// ranking, took 29 us here and grew with the square of the rows.  Staging
// the rows in shared memory (41,728 B a CTA) and searching position by
// position, as the first kernel does, took 1.40-1.44 ms: the node arrays
// missed L1, and at each zigzag position only the threads coded there
// searched.  One search instance over generic pointers took 0.87 ms; the
// shared-memory instance takes 16% less in the search (134 registers:
// three CTAs an SM, whose node arrays L1 holds better).
#include <cuda_runtime.h>
#include <stdint.h>

#include "trellis_core.cuh"

namespace {

constexpr int kThreads = 128;   // search: blocks per CTA, one per thread
constexpr int kMatSet = 2 * 64; // one image's quantizer rows
constexpr int kLtSet = 2 * 256; // one image's AC code lengths
constexpr int kChunk = 256;     // rows a work and scatter CTA, one a thread
constexpr int kWarps = kChunk / 32;
constexpr int kScanThreads = 256;
constexpr int kClasses = sjpeg::kTrellisClasses;
static_assert(kChunk <= 256, "a row's rank in its chunk fits a byte");

__device__ const int kZigzag[64] = SJPEG_ZIGZAG;

// Each row's class and its rank among its chunk's rows of that class
// (key = class << 8 | rank), the chunk's histogram, and the levels of its
// class-0 rows.
__global__ void __launch_bounds__(kChunk)
trellis_work_kernel(const int32_t* __restrict__ coeffs,
                    const int32_t* __restrict__ group,
                    const int32_t* __restrict__ iquant,
                    const int32_t* __restrict__ ibias,
                    uint16_t* __restrict__ key, int32_t* __restrict__ hist,
                    int32_t* __restrict__ out, int n, int n_chunks,
                    int per_img, int mat_sets) {
  __shared__ int s_cnt[kWarps][kClasses];
  __shared__ int32_t s_iq[kMatSet], s_ib[kMatSet];
  __shared__ int32_t s_dc[kChunk];
  __shared__ int s_zero;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < kWarps * kClasses; i += kChunk)
    (&s_cnt[0][0])[i] = 0;
  if (mat_sets == 1)
    for (int i = tid; i < kMatSet; i += kChunk) {
      s_iq[i] = iquant[i];
      s_ib[i] = ibias[i];
    }
  __syncthreads();
  const int64_t r0 = (int64_t)blockIdx.x * kChunk, b = r0 + tid;
  int c = -1;
  if (b < n) {
    const int g = group[b] & 1;
    const int32_t *iq = s_iq + 64 * g, *ib = s_ib + 64 * g;
    if (mat_sets > 1) {
      const int64_t o = (b / per_img) * kMatSet + 64 * g;
      iq = iquant + o;
      ib = ibias + o;
    }
    int32_t x[64];
    const int4* src = reinterpret_cast<const int4*>(coeffs + b * 64);
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int4 v = __ldg(src + q);
      x[4 * q] = v.x;
      x[4 * q + 1] = v.y;
      x[4 * q + 2] = v.z;
      x[4 * q + 3] = v.w;
    }
    c = sjpeg::trellis_class(x, iq, ib);
    s_dc[tid] = c ? INT32_MIN
                  : sjpeg::quantize(x[0], (uint32_t)iq[0], (uint32_t)ib[0]);
  } else {
    s_dc[tid] = INT32_MIN;
  }
  // the row's rank among its warp's rows of its class; the warp's count
  const unsigned peers = __match_any_sync(0xFFFFFFFFu, c);
  const int below = __popc(peers & ((1u << lane) - 1u));
  if (c >= 0 && below == 0) s_cnt[warp][c] = __popc(peers);
  __syncthreads();
  if (tid < kClasses) {   // class tid: the warps' exclusive prefix, total
    int run = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int v = s_cnt[w][tid];
      s_cnt[w][tid] = run;
      run += v;
    }
    hist[(int64_t)tid * n_chunks + blockIdx.x] = run;
    if (tid == 0) s_zero = run;
  }
  __syncthreads();
  if (c >= 0) key[b] = (uint16_t)(c << 8 | (s_cnt[warp][c] + below));
  if (s_zero == 0) return;
  // class-0 rows (no coded AC position): the DC alone, the CTA's threads
  // writing them together, 16 B at a time
  int4* dst = reinterpret_cast<int4*>(out + r0 * 64);
  for (int i = tid; i < kChunk * 16; i += kChunk) {
    const int32_t dc = s_dc[i >> 4];
    if (dc != INT32_MIN) dst[i] = make_int4((i & 15) ? 0 : dc, 0, 0, 0);
  }
}

// Class c = blockIdx.x: each chunk's start among the class's rows (the
// exclusive prefix sums of its histogram row), and its total.
__global__ void __launch_bounds__(kScanThreads)
trellis_scan_kernel(const int32_t* __restrict__ hist,
                    int32_t* __restrict__ starts,
                    int32_t* __restrict__ totals, int n_chunks) {
  __shared__ int64_t s_warp[kScanThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t o = (int64_t)blockIdx.x * n_chunks;
  const int per = (n_chunks + kScanThreads - 1) / kScanThreads;
  const int j0 = min(n_chunks, tid * per), j1 = min(n_chunks, j0 + per);
  const int64_t sum = sjpeg::rank_total(hist + o, j0, j1);
  int64_t incl = sum;                     // the CTA's inclusive scan
  for (int d = 1; d < 32; d <<= 1) {
    const int64_t v = __shfl_up_sync(0xFFFFFFFFu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  for (int w = 0; w < warp; ++w) incl += s_warp[w];
  sjpeg::rank_starts(hist + o, j0, j1, incl - sum, starts + o);
  if (tid == kScanThreads - 1) totals[blockIdx.x] = (int32_t)incl;
}

// Chunk blockIdx.x: each row of class c > 0 to `order`, after the rows of
// every heavier class and the class's rows of the earlier chunks; CTA 0
// writes how many rows are placed (where class 0 would begin).
__global__ void __launch_bounds__(kChunk)
trellis_scatter_kernel(const uint16_t* __restrict__ key,
                       const int32_t* __restrict__ starts,
                       const int32_t* __restrict__ totals,
                       int32_t* __restrict__ order,
                       int32_t* __restrict__ placed, int n, int n_chunks) {
  __shared__ int64_t s_tot[kClasses], s_at[kClasses];
  const int tid = threadIdx.x;
  if (tid < kClasses) s_tot[tid] = totals[tid];
  __syncthreads();
  if (tid < kClasses) {
    int64_t at = 0;
    for (int h = tid + 1; h < kClasses; ++h) at += s_tot[h];
    if (blockIdx.x == 0 && tid == 0) *placed = (int32_t)at;
    s_at[tid] = at + starts[(int64_t)tid * n_chunks + blockIdx.x];
  }
  __syncthreads();
  const int64_t b = (int64_t)blockIdx.x * kChunk + tid;
  if (b >= n) return;
  const int k = key[b];
  if (k >> 8) order[s_at[k >> 8] + (k & 255)] = (int32_t)b;
}

__global__ void __launch_bounds__(kThreads)
trellis_search_kernel(const int32_t* __restrict__ coeffs,
                      const int32_t* __restrict__ group,
                      const int32_t* __restrict__ iquant,
                      const int32_t* __restrict__ ibias,
                      const int32_t* __restrict__ quant,
                      const int32_t* __restrict__ lt_lens,
                      const int32_t* __restrict__ order,
                      const int32_t* __restrict__ placed,
                      int32_t* __restrict__ out, int per_img, int mat_sets,
                      int lt_sets) {
  __shared__ int32_t s_iq[2 * kMatSet], s_ib[2 * kMatSet], s_qq[2 * kMatSet];
  __shared__ int32_t s_lt[2 * kLtSet];
  __shared__ int s_zz[64];
  __shared__ int32_t s_row[kThreads];
  const int tid = threadIdx.x;
  const int64_t n0 = (int64_t)blockIdx.x * kThreads;
  // the rows placed: class 0's, not placed, the work pass wrote
  const int rows = (int)min((int64_t)kThreads, (int64_t)*placed - n0);
  if (rows <= 0) return;
  if (tid < rows) s_row[tid] = order[n0 + tid];
  if (tid < 64) s_zz[tid] = kZigzag[tid];
  __syncthreads();
  const int64_t b = s_row[tid < rows ? tid : 0];
  const int g = group[b] & 1;
  const int img = (int)(b / per_img);
  const int ms = mat_sets > 1 ? img : 0, ls = lt_sets > 1 ? img : 0;

  const int first = (int)(s_row[0] / per_img);
  const int last = (int)(s_row[rows - 1] / per_img);
  const sjpeg::TrellisSlots m(mat_sets, first, last),
      l(lt_sets, first, last);
  for (int i = tid; i < m.count * kMatSet; i += kThreads) {
    const int64_t src = (int64_t)m.set[i / kMatSet] * kMatSet + i % kMatSet;
    s_iq[i] = iquant[src];
    s_ib[i] = ibias[src];
    s_qq[i] = quant[src];
  }
  for (int i = tid; i < l.count * kLtSet; i += kThreads)
    s_lt[i] = lt_lens[(int64_t)l.set[i / kLtSet] * kLtSet + i % kLtSet];
  __syncthreads();
  if (tid >= rows) return;

  const int mk = m.slot(ms), lk = l.slot(ls);
  // the row into registers, 16 B at a time; the levels straight out
  int32_t x[64];
  const int4* src = reinterpret_cast<const int4*>(coeffs + b * 64);
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const int4 v = __ldg(src + q);
    x[4 * q] = v.x;
    x[4 * q + 1] = v.y;
    x[4 * q + 2] = v.z;
    x[4 * q + 3] = v.w;
  }
  // Two instances of the search: with the staged sets, whose loads the
  // compiler knows to be shared-memory ones, and with sets read where they
  // lie.  The first is 16% faster than one instance over generic pointers.
  if (mk >= 0 && lk >= 0) {
    const int o = mk * kMatSet + 64 * g;
    sjpeg::trellis_search(x, s_zz, s_iq + o, s_ib + o, s_qq + o,
                          s_lt + lk * kLtSet + 256 * g, out + b * 64);
  } else {
    const int64_t o = (int64_t)ms * kMatSet + 64 * g;
    sjpeg::trellis_search(x, s_zz, iquant + o, ibias + o, quant + o,
                          lt_lens + (int64_t)ls * kLtSet + 256 * g,
                          out + b * 64);
  }
}

}  // namespace

// The op's scratch for n rows, in int32 words from its start: parts[0..5]
// the offsets of hist and starts ([classes, n_chunks] int32: the chunks'
// class histograms and their starts within each class), totals
// ([classes] int32), order ([n] int32: the rows of classes above 0,
// ranked), placed ([1] int32: how many) and key ([n_chunks * chunk]
// uint16: a row's class and its rank in its chunk); parts[6] the words in
// all; parts[7], parts[8] the chunk's rows and the classes.
extern "C" int sjpeg_trellis_scratch(int n, int64_t* parts) {
  const int64_t nc = (n + kChunk - 1) / kChunk, k = nc * kClasses;
  const int64_t size[6] = {k, k, kClasses, n, 1, nc * kChunk / 2};
  int64_t at = 0;
  for (int i = 0; i < 6; ++i) {
    parts[i] = at;
    at += size[i];
  }
  parts[6] = at;
  parts[7] = kChunk;
  parts[8] = kClasses;
  return 0;
}

// coeffs [n, 64] int32 raster coefficients (x16); group [n] int32;
// iquant, ibias, quant [mat_sets, 2, 64] int32 matrices and lt_lens
// [lt_sets, 2, 256] int32 AC code lengths, each set count 1 (shared) or the
// number of images, row r using set r / per_img; out [n, 64] int32 raster
// levels is written.  scratch: sjpeg_trellis_scratch(n)'s words, 4-byte
// aligned, from the caller.  Launches the four kernels on `stream` and
// returns cudaGetLastError().
extern "C" int sjpeg_trellis_ranked(const void* coeffs, const void* group,
                                    const void* iquant, const void* ibias,
                                    const void* quant, const void* lt_lens,
                                    void* out, void* scratch, int n,
                                    int per_img, int mat_sets, int lt_sets,
                                    void* stream) {
  if (n <= 0) return 0;
  if (per_img <= 0 || mat_sets < 1 || lt_sets < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int nc = (n + kChunk - 1) / kChunk;
  int64_t at[9];
  sjpeg_trellis_scratch(n, at);
  int32_t* w = (int32_t*)scratch;
  int32_t *hist = w + at[0], *starts = w + at[1], *totals = w + at[2];
  int32_t *order = w + at[3], *placed = w + at[4];
  uint16_t* key = (uint16_t*)(w + at[5]);
  const auto* c = (const int32_t*)coeffs;
  const auto* grp = (const int32_t*)group;
  const auto* iq = (const int32_t*)iquant;
  const auto* ib = (const int32_t*)ibias;
  auto* lv = (int32_t*)out;
  trellis_work_kernel<<<nc, kChunk, 0, s>>>(c, grp, iq, ib, key, hist, lv, n,
                                            nc, per_img, mat_sets);
  trellis_scan_kernel<<<kClasses, kScanThreads, 0, s>>>(hist, starts, totals,
                                                       nc);
  trellis_scatter_kernel<<<nc, kChunk, 0, s>>>(key, starts, totals, order,
                                               placed, n, nc);
  trellis_search_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      c, grp, iq, ib, (const int32_t*)quant, (const int32_t*)lt_lens, order,
      placed, lv, per_img, mat_sets, lt_sets);
  return (int)cudaGetLastError();
}
