// vlc_fields: MCU-interleaved block rows -> vlc_pack's zigzag run/size/code
// fields and, optionally, each (stats image, table group)'s DC and AC
// symbol counts, the frequencies the optimal Huffman tables are built
// from.
//
// Replaces no TPU kernel: the JAX package derives the fields and counts in
// XLA glue (sjpeg_tpu/engine.py's interleaved quantize and grouped stats),
// and so did the port, as about 100 torch launches a batch: a quantize in
// int64, a zigzag gather, a cumulative-max scan along each row for the zero
// runs and four scatter-adds, of which the AC one adds a zero for every
// uncoded position (about 78% of them) at one of two addresses.  The
// arithmetic is fields_core.cuh's, bit-exact to that chain.  Two forms, one
// template: raster fDCT coefficients with quantizer rows (methods 1, 3 and
// 4), or raster levels from the trellis (method 7), with no quantizer code.
//
// Bound on the H100: bytes.  A row reads 256 B of values and writes 768 B
// of int32 fields; the 12-MP photo's 285,768 rows move 293 MB, ~87 us at
// 3.35 TB/s (16 x 1024^2 at 4:2:0, 393,216 rows: 403 MB, ~120 us).  The
// counts add a few thousand bytes.  Design: a CTA of 256 threads owns 128
// consecutive rows and stages them in shared memory with coalesced int4
// loads, eight a thread in flight.  A warp then takes a row at a time, a
// lane zigzag positions l and l + 32: it reads their raster values from the
// staged row, quantizes them (form a; the quantizer pair through the
// read-only cache), and two ballots give the row's 64-bit mask of coded
// positions, from which a position's run is its distance to the highest
// set bit below it: no scan.  The packed field (run << 21 | size << 16 |
// code) goes back into the same row, which the warp has read in full, and
// the rows leave as three coalesced int4 stores a quad.  Counts: the CTA
// keeps the [2][12] and [2][256] tables of the first two stats images of
// its rows in shared memory (a CTA that spans more images, whose images
// have under 128 rows, counts the later rows in the global tables
// directly); a coded position adds its symbol once for all the lanes of the
// warp that hold the same symbol (__match_any_sync), the row's ZRLs go in
// as one warp sum, and lane 0 adds the EOB and the DC size.  No zero is
// ever added.  At the end each non-zero bin is flushed with one global
// atomicAdd: integer adds in any order give the same sums.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fields_core.cuh"

namespace {

constexpr int kRows = sjpeg::kFieldsRows;        // rows a CTA
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStride = 68;                      // a staged row, 16-byte aligned
constexpr int kQuads = kRows * 16;               // int4 quads of a CTA's rows
constexpr int kQuadsPerThread = kQuads / kThreads;
static_assert(kQuads % kThreads == 0, "whole quads a thread");

// Adds a coded position's symbol to the row's AC counts `ac`, once for the
// lanes of the warp that hold the same symbol.
__device__ __forceinline__ void count_symbol(int32_t* ac, bool coded,
                                             uint32_t f, int lane) {
  const int sym = coded ? sjpeg::ac_symbol(f) : -1;
  const uint32_t peers = __match_any_sync(0xFFFFFFFFu, sym);
  if (coded && lane == __ffs(peers) - 1) atomicAdd(ac + sym, __popc(peers));
}

template <bool kQuantize>
__global__ void __launch_bounds__(kThreads)
vlc_fields_kernel(const int32_t* __restrict__ rows,
                  const int32_t* __restrict__ dc_codes,
                  const int32_t* __restrict__ group,
                  const uint32_t* __restrict__ iquant,
                  const uint32_t* __restrict__ bias,
                  const uint8_t* __restrict__ valid,
                  int32_t* __restrict__ run, int32_t* __restrict__ size,
                  int32_t* __restrict__ code, int32_t* __restrict__ freq_dc,
                  int32_t* __restrict__ freq_ac, int n, int per_set,
                  int per_stats) {
  __shared__ __align__(16) uint32_t buf[kRows * kStride];
  __shared__ int32_t s_group[kRows], s_dc_code[kRows], s_count[kRows];
  __shared__ int32_t s_dc[sjpeg::kStagedImages * sjpeg::kDcTable];
  __shared__ int32_t s_ac[sjpeg::kStagedImages * sjpeg::kAcTable];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t n0 = (int64_t)blockIdx.x * kRows;
  const int n_rows = (int)min((int64_t)kRows, (int64_t)n - n0);
  const int quads = n_rows * 16;
  const bool stats = freq_ac != nullptr;
  const sjpeg::StagedImages staged =
      sjpeg::staged_images(n0, n_rows, per_stats);

  const int4* src = reinterpret_cast<const int4*>(rows + n0 * 64);
  int4 v[kQuadsPerThread];
#pragma unroll
  for (int j = 0; j < kQuadsPerThread; ++j) {
    const int q = tid + j * kThreads;
    if (q < quads) v[j] = src[q];
  }
  if (tid < n_rows) {
    const int64_t b = n0 + tid;
    s_group[tid] = group[b] & 1;
    s_dc_code[tid] = dc_codes[b];
    s_count[tid] = stats && (valid == nullptr || valid[b]);
  }
  for (int i = tid; i < sjpeg::kStagedImages * sjpeg::kDcTable; i += kThreads)
    s_dc[i] = 0;
  for (int i = tid; i < sjpeg::kStagedImages * sjpeg::kAcTable; i += kThreads)
    s_ac[i] = 0;
#pragma unroll
  for (int j = 0; j < kQuadsPerThread; ++j) {
    const int q = tid + j * kThreads;
    if (q < quads)
      *reinterpret_cast<int4*>(buf + (q >> 4) * kStride + (q & 15) * 4) = v[j];
  }
  __syncthreads();

  const int k0 = lane, k1 = lane + 32;
  const int p0 = sjpeg::zigzag_raster(k0), p1 = sjpeg::zigzag_raster(k1);
  for (int r = warp; r < n_rows; r += kWarps) {
    const int64_t b = n0 + r;
    const int g = s_group[r];
    uint32_t* row = buf + r * kStride;
    uint32_t iq0 = 0, ib0 = 0, iq1 = 0, ib1 = 0;
    if (kQuantize) {
      const int64_t set = (b / per_set * 2 + g) * 64;
      iq0 = __ldg(iquant + set + p0);
      ib0 = __ldg(bias + set + p0);
      iq1 = __ldg(iquant + set + p1);
      ib1 = __ldg(bias + set + p1);
    }
    const int32_t v0 = sjpeg::field_level<kQuantize>((int32_t)row[p0], iq0,
                                                     ib0);
    const int32_t v1 = sjpeg::field_level<kQuantize>((int32_t)row[p1], iq1,
                                                     ib1);
    const bool c0 = k0 > 0 && v0 != 0, c1 = v1 != 0;
    const uint64_t mask = __ballot_sync(0xFFFFFFFFu, c0) |
                          ((uint64_t)__ballot_sync(0xFFFFFFFFu, c1) << 32);
    const uint32_t f0 = c0 ? sjpeg::packed_field(v0, sjpeg::coded_run(mask, k0))
                           : 0u;
    const uint32_t f1 = c1 ? sjpeg::packed_field(v1, sjpeg::coded_run(mask, k1))
                           : 0u;
    __syncwarp();                  // every lane has read the row
    row[k0] = f0;
    row[k1] = f1;
    if (!s_count[r]) continue;     // the same for the whole warp

    const int64_t img = b / per_stats;
    const int slot = staged.slot(img);
    int32_t* dc = slot >= 0 ? s_dc + slot * sjpeg::kDcTable
                            : freq_dc + img * sjpeg::kDcTable;
    int32_t* ac = (slot >= 0 ? s_ac + slot * sjpeg::kAcTable
                             : freq_ac + img * sjpeg::kAcTable) +
                  g * sjpeg::kAcBins;
    count_symbol(ac, c0, f0, lane);
    count_symbol(ac, c1, f1, lane);
    const uint32_t zrl = __reduce_add_sync(
        0xFFFFFFFFu, (c0 ? sjpeg::zrl_count(f0) : 0u) +
                         (c1 ? sjpeg::zrl_count(f1) : 0u));
    if (lane == 0) {
      if (zrl) atomicAdd(ac + 0xF0, (int32_t)zrl);
      if (sjpeg::ends_early(mask)) atomicAdd(ac, 1);
      const int bin = sjpeg::dc_bin(g, (uint32_t)s_dc_code[r]);
      if (bin >= 0) atomicAdd(dc + bin, 1);
    }
  }
  __syncthreads();

  int4* run4 = reinterpret_cast<int4*>(run + n0 * 64);
  int4* size4 = reinterpret_cast<int4*>(size + n0 * 64);
  int4* code4 = reinterpret_cast<int4*>(code + n0 * 64);
  for (int q = tid; q < quads; q += kThreads) {
    const uint4 f = *reinterpret_cast<const uint4*>(buf + (q >> 4) * kStride +
                                                    (q & 15) * 4);
    run4[q] = make_int4(sjpeg::field_run(f.x), sjpeg::field_run(f.y),
                        sjpeg::field_run(f.z), sjpeg::field_run(f.w));
    size4[q] = make_int4(sjpeg::field_size(f.x), sjpeg::field_size(f.y),
                         sjpeg::field_size(f.z), sjpeg::field_size(f.w));
    code4[q] = make_int4(sjpeg::field_code(f.x), sjpeg::field_code(f.y),
                         sjpeg::field_code(f.z), sjpeg::field_code(f.w));
  }
  if (!stats) return;
  for (int i = tid; i < staged.count * sjpeg::kDcTable; i += kThreads)
    if (s_dc[i]) atomicAdd(freq_dc + staged.lo * sjpeg::kDcTable + i, s_dc[i]);
  for (int i = tid; i < staged.count * sjpeg::kAcTable; i += kThreads)
    if (s_ac[i]) atomicAdd(freq_ac + staged.lo * sjpeg::kAcTable + i, s_ac[i]);
}

}  // namespace

// rows [n, 64] int32 raster coefficients (with iquant, bias [q_sets, 2, 64]
// uint32 raster quantizer rows, row r using set r / (n / q_sets)) or raster
// levels (iquant and bias null); dc_codes, group [n] int32; valid [n] bytes
// or null (all count).  run, size, code [n, 64] int32 are written; with
// freq_dc [stats_sets, 2, 12] and freq_ac [stats_sets, 2, 256] int32,
// zeroed by the caller (or both null: no counts), row r counts in image
// r / (n / stats_sets).  rows, run, size and code 16-byte aligned.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int sjpeg_vlc_fields(const void* rows, const void* dc_codes,
                                const void* group, const void* iquant,
                                const void* bias, const void* valid,
                                void* run, void* size, void* code,
                                void* freq_dc, void* freq_ac, int n,
                                int q_sets, int stats_sets, void* stream) {
  if (n <= 0) return 0;
  if (q_sets < 1 || stats_sets < 1 || n % q_sets || n % stats_sets ||
      (iquant == nullptr) != (bias == nullptr) ||
      (freq_dc == nullptr) != (freq_ac == nullptr) ||
      (((uintptr_t)rows | (uintptr_t)run | (uintptr_t)size |
        (uintptr_t)code) & 15))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kRows - 1) / kRows);
  const auto launch = [&](auto kernel) {
    kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)rows, (const int32_t*)dc_codes, (const int32_t*)group,
        (const uint32_t*)iquant, (const uint32_t*)bias,
        (const uint8_t*)valid, (int32_t*)run, (int32_t*)size, (int32_t*)code,
        (int32_t*)freq_dc, (int32_t*)freq_ac, n, n / q_sets, n / stats_sets);
  };
  if (iquant != nullptr)
    launch(vlc_fields_kernel<true>);
  else
    launch(vlc_fields_kernel<false>);
  return (int)cudaGetLastError();
}
