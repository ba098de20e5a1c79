// Per-block arithmetic of the JPEG encode: exact fixed-point fDCT, the
// reciprocal quantizer, zigzag run/size/code derivation, Huffman lookup and
// MSB-first bit packing of one 8x8 block.
//
// Every function is __host__ __device__ so the same code builds with nvcc
// for the kernels (fdct.cu, quant_pack.cu, sample_pack.cu, vlc_pack.cu) and
// with a host compiler for tests, which supply their own empty
// __host__/__device__ definitions.  The emission half has two walks over
// one BitSink (DC piece, AC piece, flush): emit_block visits all 63
// positions, and quant_emit_block feeds it the fields it derives from
// quantized coefficients (quant_pack, and sample_pack after fdct_block);
// emit_coded visits only the coded positions of a mask, and vlc_pack feeds
// it the fields it is given, quant_pack (quant_emit_coded) the fields it
// derives from coefficients staged in zigzag order.  fdct runs fdct_block
// alone.
//
// Bit-exact contract: the result equals the port's plain PyTorch chain
// ops/fdct.fdct_blocks_plain -> ops/quantize ->
// ops/vlc.block_entries_grouped -> ops/pack.pack_block_entries, itself held
// against the JAX package.  The
// reference computes in int32 with wraparound; here wrapping arithmetic runs
// on uint32 (defined in C++) and values turn signed only for the arithmetic
// right shifts, the int16 store emulation and the sign tests.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define SJ_HD __host__ __device__ __forceinline__
#else
#define SJ_HD __host__ __device__ inline
#endif

namespace sjpeg {

// zigzag[i] = raster position of the i-th coefficient in zigzag order
#define SJPEG_ZIGZAG                                                         \
  {0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,            \
   12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,           \
   35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,           \
   58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63}

// zigzag[k], the raster position of zigzag position k, and its inverse,
// for indices known only at run time: unrolled selects over the constant
// table, so that a kernel keeps no table in local memory.
SJ_HD int zigzag_raster(int k) {
  const int zigzag[64] = SJPEG_ZIGZAG;
  int p = 0;
#pragma unroll
  for (int i = 0; i < 64; ++i) p = i == k ? zigzag[i] : p;
  return p;
}

SJ_HD int zigzag_slot(int p) {
  const int zigzag[64] = SJPEG_ZIGZAG;
  int k = 0;
#pragma unroll
  for (int i = 0; i < 64; ++i) k = zigzag[i] == p ? i : k;
  return k;
}

// fDCT constants (reference src/fdct.cc:28-43)
constexpr uint32_t kTan1 = 13036u;
constexpr uint32_t kTan2 = 27146u;
constexpr uint32_t kTan3m1 = (uint32_t)-21746;
constexpr uint32_t k2Sqrt2 = 23170u;

// row-pass cosine tables, one 7-entry table per output row
#define SJPEG_ROW_TABLES                                                     \
  {{22725, 21407, 19266, 16384, 12873, 8867, 4520},                          \
   {31521, 29692, 26722, 22725, 17855, 12299, 6270},                         \
   {29692, 27969, 25172, 21407, 16819, 11585, 5906},                         \
   {26722, 25172, 22654, 19266, 15137, 10426, 5315},                         \
   {22725, 21407, 19266, 16384, 12873, 8867, 4520},                          \
   {26722, 25172, 22654, 19266, 15137, 10426, 5315},                         \
   {29692, 27969, 25172, 21407, 16819, 11585, 5906},                         \
   {31521, 29692, 26722, 22725, 17855, 12299, 6270}}

constexpr int kFpBits = 16;   // reciprocal quantizer precision
constexpr int kAcBits = 4;    // fDCT output scale (x16)
constexpr int kWordsPerBlock = 64;

SJ_HD uint32_t asr(uint32_t v, int s) { return (uint32_t)((int32_t)v >> s); }

// (a * k) >> 16 with the int32 product wrapping
SJ_HD uint32_t mulshr16(uint32_t a, uint32_t k) { return asr(a * k, 16); }

// int16 store + int32 reload
SJ_HD uint32_t sext16(uint32_t v) { return ((v & 0xFFFFu) ^ 0x8000u) - 0x8000u; }

// In place: x[64] raster int32 samples -> x16-scaled raster coefficients,
// each the int32 bit pattern of an int16 value.
SJ_HD void fdct_block(uint32_t x[64]) {
  // column pass, one column c at a time over the 8 rows
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    uint32_t m0 = x[0 * 8 + c], m1 = x[1 * 8 + c], m2 = x[2 * 8 + c];
    uint32_t m3 = x[3 * 8 + c], m4 = x[4 * 8 + c], m5 = x[5 * 8 + c];
    uint32_t m6 = x[6 * 8 + c], m7 = x[7 * 8 + c];
    uint32_t t;
    t = m0 - m7; m7 = m0 + m7; m0 = t;
    t = m2 - m5; m5 = m2 + m5; m2 = t;
    t = m3 - m4; m4 = m3 + m4; m3 = t;
    t = m1 - m6; m6 = m1 + m6; m1 = t;
    t = m7 - m4; m4 = m7 + m4; m7 = t;
    t = m6 - m5; m5 = m6 + m5; m6 = t;
    m4 <<= 3;
    m5 <<= 3;
    const uint32_t col4 = m4 - m5, col0 = m4 + m5;
    m7 <<= 3; m6 <<= 3; m3 <<= 3; m0 <<= 3;
    const uint32_t col6 = mulshr16(m7, kTan2) - m6;
    const uint32_t col2 = mulshr16(m6, kTan2) + m7;
    m2 <<= 4; m1 <<= 4;
    t = m1 - m2; m2 = m1 + m2; m1 = t;
    m2 = mulshr16(m2, k2Sqrt2);
    m1 = mulshr16(m1, k2Sqrt2);
    t = m3 - m1; m1 = m3 + m1; m3 = t;
    t = m0 - m2; m2 = m0 + m2; m0 = t;
    const uint32_t t7 = m3, t6 = m1;
    m3 = mulshr16(m3, kTan3m1) + t7 + 1u;   // + CORRECT_LSB
    m1 = mulshr16(m1, kTan1) + m2 + 1u;
    const uint32_t t4b = mulshr16(m0, kTan3m1) + m0;
    const uint32_t t5b = mulshr16(m2, kTan1);
    x[0 * 8 + c] = sext16(col0);
    x[1 * 8 + c] = sext16(m1);
    x[2 * 8 + c] = sext16(col2);
    x[3 * 8 + c] = sext16(m0 - m3);
    x[4 * 8 + c] = sext16(col4);
    x[5 * 8 + c] = sext16(t7 + t4b);
    x[6 * 8 + c] = sext16(col6);
    x[7 * 8 + c] = sext16(t5b - t6);
  }
  // row pass
  const uint32_t tab[8][7] = SJPEG_ROW_TABLES;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    uint32_t* r = x + 8 * k;
    const uint32_t a0 = r[0] + r[7], b0 = r[0] - r[7];
    const uint32_t a1 = r[1] + r[6], b1 = r[1] - r[6];
    const uint32_t a2 = r[2] + r[5], b2 = r[2] - r[5];
    const uint32_t a3 = r[3] + r[4], b3 = r[3] - r[4];
    const uint32_t C1 = tab[k][0], C2 = tab[k][1], C3 = tab[k][2];
    const uint32_t C4 = tab[k][3], C5 = tab[k][4], C6 = tab[k][5];
    const uint32_t C7 = tab[k][6];
    const uint32_t c0 = a0 + a3, c1 = a0 - a3, c2 = a1 + a2, c3 = a1 - a2;
    r[0] = sext16(asr(C4 * (c0 + c2), 16));
    r[4] = sext16(asr(C4 * (c0 - c2), 16));
    r[2] = sext16(asr(C2 * c1 + C6 * c3, 16));
    r[6] = sext16(asr(C6 * c1 - C2 * c3, 16));
    r[1] = sext16(asr(C1 * b0 + C3 * b1 + C5 * b2 + C7 * b3, 16));
    r[3] = sext16(asr(C3 * b0 - C7 * b1 - C1 * b2 - C5 * b3, 16));
    r[5] = sext16(asr(C5 * b0 - C1 * b1 + C7 * b2 + C3 * b3, 16));
    r[7] = sext16(asr(C7 * b0 - C5 * b1 + C3 * b2 - C1 * b3, 16));
  }
}

// sign(c) * (((|c| + bias) * iquant mod 2^32) >> FP_BITS >> AC_BITS)
SJ_HD int32_t quantize(int32_t c, uint32_t iquant, uint32_t bias) {
  const uint32_t mag = (uint32_t)(c < 0 ? -c : c);
  const int32_t q = (int32_t)(((mag + bias) * iquant) >> kFpBits) >> kAcBits;
  return c < 0 ? -q : q;
}

// bit length of v for 1 <= v < 2^16, as the reference's CalcLog2
SJ_HD uint32_t calc_log2(uint32_t v) {
  uint32_t out = 0, x = v;
  if (x >= 256u) { out += 8; x >>= 8; }
  if (x >= 16u) { out += 4; x >>= 4; }
  if (x >= 4u) { out += 2; x >>= 2; }
  if (x >= 2u) { out += 1; x >>= 1; }
  return out + (v > 0 ? 1u : 0u);
}

// MSB-first writer of whole uint32 words into one block's word slot
struct BitSink {
  uint32_t* out;
  uint64_t acc;
  int nacc;    // pending bits in acc, < 32 between calls
  int nwords;  // whole words written

  SJ_HD void put(uint32_t val, uint32_t len) {
    if (len == 0) return;
    acc = (acc << len) | val;
    nacc += (int)len;
    if (nacc >= 32) {
      nacc -= 32;
      // a block's stream stays under 2048 bits with any table whose codes
      // are at most 16 bits long; the guard keeps other tables in bounds
      if (nwords < kWordsPerBlock) out[nwords] = (uint32_t)(acc >> nacc);
      ++nwords;
      acc &= (((uint64_t)1) << nacc) - 1;
    }
  }
  SJ_HD void put_packed(uint32_t packed) { put(packed >> 16, packed & 0xFFu); }

  // The DC piece: the code (n | suffix << 4) coded with the packed
  // (code << 16 | len) DC LUT row dc_lut[16], then the n suffix bits.
  SJ_HD void put_dc(uint32_t dc_code, const uint32_t* dc_lut) {
    const uint32_t dc_len = dc_code & 0x0Fu;
    const uint32_t dc_packed = dc_lut[dc_len];
    put(((dc_packed >> 16) << dc_len) | (dc_code >> 4),
        (dc_packed & 0xFFu) + dc_len);
  }

  // The AC piece of one coded position: ZRL escapes (esc = ac_lut[0xF0])
  // while run >= 16, then the (run, size) symbol of the AC LUT row
  // ac_lut[256] and the size suffix bits `code`.
  SJ_HD void put_ac(uint32_t esc, const uint32_t* ac_lut, uint32_t run,
                    uint32_t size, uint32_t code) {
    for (; run >= 16u; run -= 16u) put_packed(esc);
    const uint32_t sym = ac_lut[(run << 4) | size];
    put(((sym >> 16) << size) | code, (sym & 0xFFu) + size);
  }

  // Flushes the pending bits, zeroes the slot past the stream and returns
  // the exact bit count.
  SJ_HD int finish() {
    const int total = 32 * nwords + nacc;
    if (nacc > 0 && nwords < kWordsPerBlock)
      out[nwords++] = (uint32_t)(acc << (32 - nacc));
    for (int w = nwords; w < kWordsPerBlock; ++w) out[w] = 0u;
    return total;
  }
};

// Index of the lowest set bit of a nonzero mask.
SJ_HD int lowest_bit(uint64_t m) {
#ifdef __CUDA_ARCH__
  return __ffsll((long long)m) - 1;
#else
  return __builtin_ctzll(m);
#endif
}

// Emission half of one block: the DC code (n | suffix << 4) coded with the
// packed (code << 16 | len) DC LUT row dc_lut[16], then for zigzag positions
// k = 1..63 the fields that fields(k, run, size, code) returns (size 0: a
// zero coefficient, skipped) coded with the AC LUT row ac_lut[256]: ZRL
// escapes while run >= 16, the (run, size) symbol and the suffix bits, and
// EOB unless position 63 is coded.  `fields` is called once per position,
// in order.  Writes out[0..63] (zero past the stream) and returns the exact
// bit count.
template <typename Fields>
SJ_HD int emit_block(uint32_t dc_code, const uint32_t* dc_lut,
                     const uint32_t* ac_lut, Fields&& fields, uint32_t* out) {
  BitSink sink{out, 0, 0, 0};
  sink.put_dc(dc_code, dc_lut);
  const uint32_t esc = ac_lut[0xF0];
  int last = 0;
#pragma unroll
  for (int k = 1; k < 64; ++k) {
    uint32_t run = 0, size = 0, code = 0;
    fields(k, run, size, code);
    if (size == 0) continue;
    last = k;
    sink.put_ac(esc, ac_lut, run, size, code);
  }
  if (last < 63) sink.put_packed(ac_lut[0x00]);               // EOB
  return sink.finish();
}

// emit_block over the coded positions only: bit k of `mask` is set where
// position k (1..63; bit 0 is ignored) has a nonzero size.  For each set bit,
// in order, field(k, in_place) returns that position's packed field
// run << 21 | size << 16 | code, and its own run, size and code are coded as
// emit_block codes them, so both give the same words and count.  The stream
// may be written into the very row that holds the fields (out[k] = field
// k): `in_place` says whether out[k] still holds it, that is whether fewer
// than k + 1 words are written.  It always does when each run is at most
// the count of uncoded positions since the previous coded one, as
// vlc.run_levels gives them: the DC piece and each AC piece are at most 32
// bits and every ZRL covers 16 skipped positions, so after coded position k
// the stream holds at most 32 (k + 1) bits.  Otherwise the caller reads the
// field from its source.
template <typename Field>
SJ_HD int emit_coded(uint32_t dc_code, const uint32_t* dc_lut,
                     const uint32_t* ac_lut, uint64_t mask, Field&& field,
                     uint32_t* out) {
  BitSink sink{out, 0, 0, 0};
  sink.put_dc(dc_code, dc_lut);
  const uint32_t esc = ac_lut[0xF0];
  for (uint64_t m = mask & ~(uint64_t)1; m; m &= m - 1) {
    const int k = lowest_bit(m);
    const uint32_t f = field(k, k >= sink.nwords);
    sink.put_ac(esc, ac_lut, f >> 21, (f >> 16) & 31u, f & 0xFFFFu);
  }
  if (!(mask >> 63)) sink.put_packed(ac_lut[0x00]);           // EOB
  return sink.finish();
}

// Quantize-and-emit half of one block: raster coefficients x[64] (x16
// scale, as fdct_block leaves them), its DC diff code (n | suffix << 4), its
// table group g (0 luma, 1 chroma), quantizer rows iquant/bias [2 * 64]
// (raster), packed (code << 16 | len) LUTs dc_lut [2 * 16] and ac_lut
// [2 * 256].  Writes out[0..63] (zero past the stream) and returns the exact
// bit count.  quant_pack runs it on coefficients, sample_pack after
// fdct_block.
SJ_HD int quant_emit_block(const uint32_t x[64], uint32_t dc_code, int g,
                           const uint32_t* iquant, const uint32_t* bias,
                           const uint32_t* dc_lut, const uint32_t* ac_lut,
                           uint32_t* out) {
  const uint32_t* iq = iquant + 64 * g;
  const uint32_t* ib = bias + 64 * g;
  const int zigzag[64] = SJPEG_ZIGZAG;
  int last = 0;
  // zigzag run/size/code of the quantized coefficient at position k
  auto fields = [&](int k, uint32_t& run, uint32_t& size, uint32_t& code) {
    const int p = zigzag[k];
    const int32_t q = quantize((int32_t)x[p], iq[p], ib[p]);
    if (q == 0) {
      size = 0;
      return;
    }
    const uint32_t mag = (uint32_t)(q < 0 ? -q : q);
    size = calc_log2(mag);
    code = (q < 0 ? ~mag : mag) & ((1u << size) - 1u);
    run = (uint32_t)(k - last - 1);
    last = k;
  };
  return emit_block(dc_code, dc_lut + 16 * g, ac_lut + 256 * g, fields, out);
}

// The coded positions of one block staged in zigzag order: bit k (1..63)
// of the result is set where row[k], the coefficient at zigzag position k,
// quantizes to nonzero with its group's quantizer rows iq, ib [64] in
// zigzag order.
SJ_HD uint64_t quant_coded_mask(const uint32_t* row, const uint32_t* iq,
                                const uint32_t* ib) {
  uint64_t mask = 0;
#pragma unroll
  for (int k = 1; k < 64; ++k)
    mask |= (uint64_t)(quantize((int32_t)row[k], iq[k], ib[k]) != 0) << k;
  return mask;
}

// quant_emit_block over the coded positions only, in place: row[k] holds
// the block's coefficient at zigzag position k (x16 scale), iq, ib [64]
// its group's quantizer rows in zigzag order, mask = quant_coded_mask(row,
// iq, ib), dc_lut [16] and ac_lut [256] its group's LUT rows.  emit_coded
// writes the stream over row[0..63] (zero past it) and the exact bit count
// is returned, both as quant_emit_block gives them.  Runs are the gaps
// between coded positions, so the stream never reaches a slot still to be
// read: emit_coded's in_place always holds (a host build may check it by
// defining SJ_CHECK_IN_PLACE).
#ifndef SJ_CHECK_IN_PLACE
#define SJ_CHECK_IN_PLACE(in_place) ((void)0)
#endif
SJ_HD int quant_emit_coded(uint32_t* row, uint64_t mask, uint32_t dc_code,
                           const uint32_t* iq, const uint32_t* ib,
                           const uint32_t* dc_lut, const uint32_t* ac_lut) {
  int last = 0;
  auto field = [&](int k, bool in_place) {
    SJ_CHECK_IN_PLACE(in_place);
    const int32_t q = quantize((int32_t)row[k], iq[k], ib[k]);
    const uint32_t mag = (uint32_t)(q < 0 ? -q : q);
    const uint32_t size = calc_log2(mag);
    const uint32_t code = (q < 0 ? ~mag : mag) & ((1u << size) - 1u);
    const uint32_t run = (uint32_t)(k - last - 1);
    last = k;
    return (run << 21) | (size << 16) | code;
  };
  return emit_coded(dc_code, dc_lut, ac_lut, mask, field, row);
}

// One block from raster samples x[64] (destroyed): fdct_block, then
// quant_emit_block with the same arguments.
SJ_HD int encode_block(uint32_t x[64], uint32_t dc_code, int g,
                       const uint32_t* iquant, const uint32_t* bias,
                       const uint32_t* dc_lut, const uint32_t* ac_lut,
                       uint32_t* out) {
  fdct_block(x);
  return quant_emit_block(x, dc_code, g, iquant, bias, dc_lut, ac_lut, out);
}

}  // namespace sjpeg
