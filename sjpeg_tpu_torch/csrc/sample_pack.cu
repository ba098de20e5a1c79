// sample_pack: centred 8x8 sample blocks -> each block's packed Huffman
// bit stream (words, MSB-first) and its exact bit count, with shared or
// per-image quantizers and LUTs.
//
// Replaces the TPU kernels sjpeg_tpu/ops/pallas_quant_pack.py
// sample_vlc_pack_units_pallas (_sample_pack_units_kernel) and
// sample_vlc_pack_pallas (_sample_pack_kernel with shared tables,
// _sample_pack_kernel_sets with one table set per image): exact fDCT,
// reciprocal quantizer, zigzag run/size/code, Huffman lookup and packing,
// per block.  The TPU kernel's in-kernel 16-block fold is left to
// stream_concat.cu: it saved an HBM round trip the TPU could not afford,
// about 200 MB at 16 x 1024^2, some 60 us at 3.35 TB/s here.  Its per-image
// variant needed each image's rows padded to whole tiles (and int8 samples
// with a chroma wrap); here every row finds its image (row / per_img) and
// int16 samples hold chroma's +128, so nothing is padded.
//
// Bound on the H100: bytes.  At 16 x 1024^2 4:2:0 (N = 393,216 blocks) it
// reads 50 MB of int16 samples plus 3 MB of codes and groups and writes
// 100 MB of words, ~46 us at 3.35 TB/s; the integer work, ~2,000 32-bit
// operations per block, is ~0.8 G operations.  Design: one thread per
// block, 128 blocks per CTA.  The CTA stages its 128 x 64 samples through
// shared memory so that global reads and writes are coalesced (rows padded
// to 65 words, block_rows.cuh: no bank conflicts when each thread walks its
// own row).  Each thread takes its block into registers, runs fdct_block
// there and stores the coefficients back into its row in zigzag order
// (block_core.cuh fdct_zigzag); then, as quant_pack.cu does, it quantizes
// the row's 63 AC slots once for the mask of coded positions
// (quant_coded_mask) and walks only those (quant_emit_coded), the stream
// written into the same row before the coalesced store.  A warp thus waits
// for its block with the most coded positions, not for 63 steps of every
// block as the dense walk (emit_block) made it.  Measured on the H100 at
// 16 x 1024^2 (scripts/torch_kernel_probe.py, parent and change in one
// call; PERF.md section 6): 0.124-0.126 ms (shared tables) and
// 0.126-0.128 ms (16 per-image sets) against 0.244-0.246 ms for the dense
// walk, 80 and 96 registers, no spills.
// Tables: the quantizer rows are staged in zigzag order as (iquant, bias)
// pairs, the two groups of a position side by side (block_core.cuh
// PairRows: one 8-byte load a position, no bank conflict between groups).
// The shared-table instance stages the one set; the per-image instance
// stages the sets of the (at most two) images its 128 rows span, as
// vlc_pack.cu does, 39,680 B of static shared memory in all, and a row of a
// further image (images under 128 blocks) reads its set's raster rows from
// global memory through a zigzag table (RasterRows) and its LUTs there.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_core.cuh"
#include "block_rows.cuh"

namespace {

constexpr int kThreads = sjpeg::kRowThreads;   // blocks per CTA
constexpr int kStride = sjpeg::kRowStride;     // padded row, in words
constexpr int kQSet = 2 * 64;   // one set's iquant (or bias) rows
constexpr int kDcSet = 2 * 16;  // one set's DC LUT rows
constexpr int kAcSet = 2 * 256; // one set's AC LUT rows

__device__ const int kZigzag[64] = SJPEG_ZIGZAG;

// kSets: table sets staged in shared memory, 1 (shared tables) or 2 (per
// image: row r uses set r / per_img)
template <typename T, int kSets>
__global__ void __launch_bounds__(kThreads)
sample_pack_kernel(const T* __restrict__ samples,
                   const int32_t* __restrict__ dc_codes,
                   const int32_t* __restrict__ group,
                   const uint32_t* __restrict__ iquant,
                   const uint32_t* __restrict__ bias,
                   const uint32_t* __restrict__ dc_lut,
                   const uint32_t* __restrict__ ac_lut,
                   uint32_t* __restrict__ words, int32_t* __restrict__ bits,
                   int n, int per_img) {
  __shared__ uint32_t buf[kThreads * kStride];
  __shared__ sjpeg::QPair s_q[kSets * kQSet];   // [set][zigzag k][group]
  __shared__ uint32_t s_dc[kSets * kDcSet], s_ac[kSets * kAcSet];
  const int tid = threadIdx.x;
  const int64_t n0 = (int64_t)blockIdx.x * kThreads;
  const int rows = (int)min((int64_t)kThreads, (int64_t)n - n0);

  const int set_lo = kSets > 1 ? (int)(n0 / per_img) : 0;
  const int set_hi = kSets > 1 ? (int)((n0 + rows - 1) / per_img) : 0;
  const int staged = min(set_hi - set_lo + 1, kSets);
  for (int i = tid; i < staged * kQSet; i += kThreads) {
    const int s = i >> 7, k = (i >> 1) & 63, g = i & 1;
    const int64_t src =
        (int64_t)(set_lo + s) * kQSet + 64 * g + sjpeg::zigzag_raster(k);
    s_q[i] = sjpeg::QPair{iquant[src], bias[src]};
  }
  for (int i = tid; i < staged * kDcSet; i += kThreads)
    s_dc[i] = dc_lut[(int64_t)set_lo * kDcSet + i];
  for (int i = tid; i < staged * kAcSet; i += kThreads)
    s_ac[i] = ac_lut[(int64_t)set_lo * kAcSet + i];
  sjpeg::load_rows(samples + n0 * 64, rows, buf);
  __syncthreads();

  // from here on each thread reads and writes its own row only
  if (tid < rows) {
    const int64_t b = n0 + tid;
    const int g = group[b] & 1;
    uint32_t* row = buf + tid * kStride;
    uint32_t x[64];
#pragma unroll
    for (int k = 0; k < 64; ++k) x[k] = row[k];
    sjpeg::fdct_zigzag(x, row);
    const uint32_t dc = (uint32_t)dc_codes[b];
    const int set = kSets > 1 ? (int)(b / per_img) : 0;
    const int k = set - set_lo;
    if (kSets == 1 || k < staged) {
      const sjpeg::PairRows q{s_q + k * kQSet + g};
      bits[b] = sjpeg::quant_emit_coded(
          row, sjpeg::quant_coded_mask(row, q), dc, q,
          s_dc + k * kDcSet + 16 * g, s_ac + k * kAcSet + 256 * g);
    } else {                         // a third image in this CTA's rows
      const int64_t o = (int64_t)set * kQSet + 64 * g;
      const sjpeg::RasterRows q{iquant + o, bias + o, kZigzag};
      bits[b] = sjpeg::quant_emit_coded(
          row, sjpeg::quant_coded_mask(row, q), dc, q,
          dc_lut + (int64_t)set * kDcSet + 16 * g,
          ac_lut + (int64_t)set * kAcSet + 256 * g);
    }
  }
  __syncthreads();

  sjpeg::store_rows(buf, rows, words + n0 * 64);
}

template <typename T>
void launch(const void* samples, const int32_t* dcc, const int32_t* grp,
            const uint32_t* iq, const uint32_t* ib, const uint32_t* dcl,
            const uint32_t* acl, void* words, void* bits, int n, int per_img,
            int n_sets, cudaStream_t s) {
  const dim3 grid((n + kThreads - 1) / kThreads);
  if (n_sets > 1) {
    sample_pack_kernel<T, 2><<<grid, kThreads, 0, s>>>(
        (const T*)samples, dcc, grp, iq, ib, dcl, acl, (uint32_t*)words,
        (int32_t*)bits, n, per_img);
  } else {
    sample_pack_kernel<T, 1><<<grid, kThreads, 0, s>>>(
        (const T*)samples, dcc, grp, iq, ib, dcl, acl, (uint32_t*)words,
        (int32_t*)bits, n, per_img);
  }
}

}  // namespace

// samples [n, 64] int16 (sample_bytes 2) or int32 (4); dc_codes, group [n]
// int32; iquant, bias [n_sets, 2, 64] and LUTs [n_sets, 2, 16],
// [n_sets, 2, 256] as uint32, n_sets 1 (shared) or the number of images,
// row r using set r / per_img; words [n, 64] uint32 and bits [n] int32 are
// written.  Launches on `stream` and returns cudaGetLastError().
extern "C" int sjpeg_sample_pack(const void* samples, int sample_bytes,
                                 const void* dc_codes, const void* group,
                                 const void* iquant, const void* bias,
                                 const void* dc_lut, const void* ac_lut,
                                 void* words, void* bits, int n, int per_img,
                                 int n_sets, void* stream) {
  if (n <= 0) return 0;
  if (per_img <= 0 || n_sets < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const auto* dcc = (const int32_t*)dc_codes;
  const auto* grp = (const int32_t*)group;
  const auto* iq = (const uint32_t*)iquant;
  const auto* ib = (const uint32_t*)bias;
  const auto* dcl = (const uint32_t*)dc_lut;
  const auto* acl = (const uint32_t*)ac_lut;
  if (sample_bytes == 2) {
    launch<int16_t>(samples, dcc, grp, iq, ib, dcl, acl, words, bits, n,
                    per_img, n_sets, s);
  } else if (sample_bytes == 4) {
    launch<int32_t>(samples, dcc, grp, iq, ib, dcl, acl, words, bits, n,
                    per_img, n_sets, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
