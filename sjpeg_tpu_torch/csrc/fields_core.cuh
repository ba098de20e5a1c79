// The VLC fields and symbol counts of quantized blocks, one position or one
// row at a time: the level of a raster value (the bias quantizer of
// block_core.cuh, or the value itself where it is already a level), the
// zero run before a coded zigzag position read from the row's 64-bit mask
// of coded positions, the (run, size, code) field packed as vlc_pack reads
// it, the AC symbol and ZRLs it counts, the row's EOB and its DC size bin.
//
// Bit-exact contract: the results equal the port's plain PyTorch chain
// ops/quantize.quantize_values -> ops/vlc.run_levels -> ops/vlc.grouped_stats
// (ops/vlc_fields.vlc_fields_plain), itself held against the JAX package:
//   - a position k (1..63) is coded where its level is nonzero; position 0
//     never is, and its fields are 0, as are an uncoded position's;
//   - run = k - 1 - the previous coded position (0 before the first), which
//     is the cumulative maximum of the plain version without a scan;
//   - size = calc_log2(|level|) (at most 16 for any int32 level), code =
//     the level's low `size` bits, one's complement where it is negative;
//   - each coded position counts its (run & 15) << 4 | size symbol and
//     run >> 4 ZRLs (0xF0); a row whose position 63 is not coded counts an
//     EOB (0x00); its DC code counts its size in the plain version's 26
//     slots of an image, group * 13 + size, as [2][13] whose 13th column is
//     dropped: size 12 drops, and a luma size of 13-15 counts in the chroma
//     table's bins 0-2, as there.
// Counts are integer adds, exact in any order.
//
// __host__ __device__ for vlc_fields.cu and for the g++ build of the tests,
// which supply empty __host__/__device__ definitions.
#pragma once

#include <stdint.h>

#include "block_core.cuh"

namespace sjpeg {

constexpr int kFieldsRows = 128;     // rows a CTA of vlc_fields.cu
constexpr int kStagedImages = 2;     // stats images whose tables a CTA keeps
constexpr int kDcBins = 12;          // a table group's DC sizes
constexpr int kAcBins = 256;         // a table group's AC symbols
constexpr int kDcTable = 2 * kDcBins;  // an image's [2][12] DC counts
constexpr int kAcTable = 2 * kAcBins;  // an image's [2][256] AC counts

// Index of the highest set bit of a nonzero mask.
SJ_HD int highest_bit(uint64_t m) {
#ifdef __CUDA_ARCH__
  return 63 - __clzll((long long)m);
#else
  return 63 - __builtin_clzll(m);
#endif
}

// The level of raster value x: its bias-quantized value where the rows are
// coefficients, else x itself (the trellis's levels).
template <bool kQuantize>
SJ_HD int32_t field_level(int32_t x, uint32_t iquant, uint32_t bias) {
  return kQuantize ? quantize(x, iquant, bias) : x;
}

// The zero run before coded position k (1..63) of a row whose coded
// positions are the set bits of `mask` (bit 0 clear).
SJ_HD uint32_t coded_run(uint64_t mask, int k) {
  const uint64_t before = (mask | 1u) & ((((uint64_t)1) << k) - 1u);
  return (uint32_t)(k - 1 - highest_bit(before));
}

// The packed field of a coded level v with its run, as vlc_pack.cu reads a
// position: run << 21 | size << 16 | code.
SJ_HD uint32_t packed_field(int32_t v, uint32_t run) {
  const uint32_t mag = (uint32_t)(v < 0 ? -v : v);
  const uint32_t size = calc_log2(mag);
  const uint32_t code = (v < 0 ? ~mag : mag) & ((1u << size) - 1u);
  return (run << 21) | (size << 16) | code;
}

SJ_HD uint32_t field_run(uint32_t f) { return f >> 21; }
SJ_HD uint32_t field_size(uint32_t f) { return (f >> 16) & 31u; }
SJ_HD uint32_t field_code(uint32_t f) { return f & 0xFFFFu; }

// The AC symbol (1..255) and the ZRLs of a coded position's field.
SJ_HD int ac_symbol(uint32_t f) {
  return (int)(((field_run(f) & 15u) << 4) | field_size(f));
}
SJ_HD uint32_t zrl_count(uint32_t f) { return field_run(f) >> 4; }

// Whether the row codes an EOB: its position 63 is not coded.
SJ_HD bool ends_early(uint64_t mask) { return !(mask >> 63); }

// The DC code's bin in its image's [2][12] DC counts, or -1 where the plain
// version drops it.
SJ_HD int dc_bin(int g, uint32_t dc_code) {
  const int j = g * 13 + (int)(dc_code & 15u);
  return j < 26 && j % 13 < kDcBins ? j / 13 * kDcBins + j % 13 : -1;
}

// The stats images of a CTA's rows [n0, n0 + rows) (image = row /
// per_stats) whose tables it counts in shared memory: the first
// kStagedImages from its first row's; a row of a later image counts in
// the global tables.
struct StagedImages {
  int64_t lo;
  int count;
  SJ_HD int slot(int64_t img) const {
    return img - lo < count ? (int)(img - lo) : -1;
  }
};

SJ_HD StagedImages staged_images(int64_t n0, int rows, int64_t per_stats) {
  const int64_t lo = n0 / per_stats, hi = (n0 + rows - 1) / per_stats;
  return {lo, (int)(hi - lo + 1 < kStagedImages ? hi - lo + 1
                                                : kStagedImages)};
}

}  // namespace sjpeg
