// merge_codesizes: frequency rows -> each row's whole optimal Huffman table
// (packed LUT, code-length counts, symbol count, DHT order), one launch for
// every row of a table build.
//
// Replaces the TPU kernel sjpeg_tpu/ops/huffman_device.py
// _merge_codesizes_pallas (_merge_kernel), the merge loop of
// optimal_code_luts, and builds the rest of that function's table on the
// card too: the first merge of the fake symbol, the clamp and the length
// histogram, the rebalance to 16 bits, the (code size, symbol) ranks, the
// canonical codes and the DHT order.  On the TPU, XLA fuses that tail under
// jax.jit; in eager PyTorch it was some 70 small launches around the merge
// kernel, and the rebalance loop read a device flag on the host each turn.
// Here a table build is one launch and reads nothing back.
//
// Bound on the H100: neither bytes nor operations.  A method-4 batch of 16
// images builds 32 DC rows (16 frequencies) and 32 AC rows (320) and
// writes ~20 KB of tables: ~0.02 us at 3.35 TB/s.  Its operations, ~2 a
// live key and ~4 a slot each merge step for the argmin-2 and the
// code-size update, and ~40 a symbol for the ranks and codes, are ~40 M,
// ~0.6 us at 67 T/s.  What holds it is each row's chain of up to 255
// dependent merge steps (256 symbols and the fake): each step needs the
// row's two smallest keys of the step before.  Design: one warp per row,
// one row per CTA, so that the rows' chains run side by side on different
// SMs, DC and AC rows in one grid.  The row's algorithm is table_core.cuh's
// table_row over the warp policy below: every lane keeps its share of the
// live keys sorted in registers, so a step is two warp min-reductions
// (__reduce_min_sync on the 64-bit key's two halves, two redux each), a pop
// and a sorted insertion in the lanes that held the two winners, and the
// code-size update over the lane's nine slots, delayed a step so that it
// overlaps the next step's reductions.  The tail runs on
// the 32 lanes: shared-memory atomics for the length histogram, lanes as
// lengths for the rebalance and the first codes, __match_any_sync for the
// stable ranks, 32 symbols a round.
#include <cuda_runtime.h>
#include <stdint.h>

// table_row runs only here, on the device policy below
#define SJ_TABLE_FN __device__ __forceinline__
#include "table_core.cuh"

// One table build's rows: [rows, width] int32 frequencies -> lut
// [rows, lut_size], bits [rows, 16], nb_syms [rows], syms [rows, size].
struct TableJob {
  const int32_t* freq;
  int32_t* lut;
  int32_t* bits;
  int32_t* nb_syms;
  int32_t* syms;
  int rows, width, size, lut_size;
};

constexpr int kMaxTableJobs = 2;   // DC and AC rows in one grid

struct TableJobs {
  TableJob job[kMaxTableJobs];
  int n;
};

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ uint64_t warp_min(uint64_t v) {
  const uint32_t hi = __reduce_min_sync(kFull, (uint32_t)(v >> 32));
  const uint32_t lo = __reduce_min_sync(
      kFull, (uint32_t)(v >> 32) == hi ? (uint32_t)v : 0xFFFFFFFFu);
  return ((uint64_t)hi << 32) | lo;
}

// table_core.cuh's Warp policy on one warp, a lane a thread.
struct DeviceWarp {
  sjpeg::TableLane s;
  int lane;

  template <typename F>
  __device__ __forceinline__ void each(F&& f) { f(lane, s); }
  template <typename F>
  __device__ __forceinline__ uint32_t sum(F&& f) {
    return __reduce_add_sync(kFull, (uint32_t)f(lane, s));
  }
  template <typename F>
  __device__ __forceinline__ uint64_t min(F&& f) {
    return warp_min(f(lane, s));
  }
  template <typename F>
  __device__ __forceinline__ uint32_t ballot(F&& f) {
    return __ballot_sync(kFull, f(lane, s));
  }
  template <typename F>
  __device__ __forceinline__ int32_t shfl(F&& f, int src) {
    return __shfl_sync(kFull, (int32_t)f(lane, s), src);
  }
  template <typename F, typename G>
  __device__ __forceinline__ void scan(F&& f, G&& g) {
    int32_t v = f(lane, s);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t u = __shfl_up_sync(kFull, v, o);
      if (lane >= o) v += u;
    }
    g(lane, s, v);
  }
  template <typename F, typename G>
  __device__ __forceinline__ void match(F&& f, G&& g) {
    const unsigned m = __match_any_sync(kFull, (unsigned)f(lane, s));
    g(lane, s, __popc(m & ((1u << lane) - 1u)), __popc(m));
  }
  __device__ __forceinline__ void add(int32_t* p, int32_t v) {
    atomicAdd(p, v);
  }
  __device__ __forceinline__ void sync() { __syncwarp(); }
};

__global__ void __launch_bounds__(32) optimal_tables_kernel(TableJobs jobs) {
  __shared__ sjpeg::TableShared sh;
  int r = blockIdx.x;
  TableJob j = jobs.job[0];         // field by field, no local copy
  if (jobs.n > 1 && r >= jobs.job[0].rows) {
    r -= jobs.job[0].rows;
    j = jobs.job[1];
  }
  const int64_t r64 = r;
  const sjpeg::TableRow row{j.freq + r64 * j.width, j.lut + r64 * j.lut_size,
                            j.bits + r64 * sjpeg::kCodeBits,
                            j.nb_syms + r64, j.syms + r64 * j.size, j.size,
                            j.lut_size};
  DeviceWarp w;
  w.lane = threadIdx.x;
  sjpeg::table_row(w, sh, row);
}

}  // namespace

// jobs[n_jobs] (n_jobs 1 or 2), each [rows, width] int32 frequency rows
// with 1 <= size <= 256 symbols, width > size and 1 <= lut_size <= 256,
// and its int32 outputs: lut [rows, lut_size] packed (code << 16 | length)
// bit patterns, bits [rows, 16], nb_syms [rows], syms [rows, size].  One
// launch on `stream` for every row of every job; returns
// cudaGetLastError().
extern "C" int sjpeg_optimal_tables(const TableJob* jobs, int n_jobs,
                                    void* stream) {
  if (n_jobs < 1 || n_jobs > kMaxTableJobs) return (int)cudaErrorInvalidValue;
  TableJobs all{};
  all.n = n_jobs;
  int rows = 0;
  for (int i = 0; i < n_jobs; ++i) {
    const TableJob& j = jobs[i];
    if (j.rows < 0 || j.size < 1 || j.size > sjpeg::kMaxTableSize ||
        j.width <= j.size || j.lut_size < 1 ||
        j.lut_size > sjpeg::kMaxTableSize)
      return (int)cudaErrorInvalidValue;
    all.job[i] = j;
    rows += j.rows;
  }
  if (rows == 0) return 0;
  optimal_tables_kernel<<<rows, 32, 0, (cudaStream_t)stream>>>(all);
  return (int)cudaGetLastError();
}
