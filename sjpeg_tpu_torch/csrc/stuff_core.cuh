// The scan's '1' padding and 0xFF stuffing, word by word: the steps of
// scan_stuff.cu, bit-exact to native_host.cc's sjpeg_words_to_scan (and so
// to sjpeg's BitWriter: the last byte's free bits set, a 0x00 after every
// 0xFF byte, the padded last byte included).
//
// __host__ __device__ like block_core.cuh, so the same code builds with
// nvcc for the kernel and with a host compiler for the tests, which run it
// tile by tile as the kernel does and hold it against words_to_scan.
#pragma once

#include <stdint.h>

#ifndef SJ_HD
#ifdef __CUDACC__
#define SJ_HD __host__ __device__ __forceinline__
#else
#define SJ_HD __host__ __device__ inline
#endif
#endif

namespace sjpeg {

constexpr int kStuffThreads = 256;       // threads a tile
constexpr int kStuffWordsPerThread = 4;  // consecutive words a thread
constexpr int kStuffTileWords = kStuffThreads * kStuffWordsPerThread;
constexpr int kStuffTileBytes = 4 * kStuffTileWords;

// One image's scan as the stuffing reads it: its bytes in the word row
// and the '1' bits OR-ed into the last of them.
struct ScanRow {
  int64_t n_bytes;
  uint32_t pad;
};

// The scan of a row of `bucket` words holding `total` bits (stream_concat's
// exact total, mod 2^32).  A total past the row (a bucket overflow) is
// clamped to the row's bytes, unpadded, so every read stays in the row.
SJ_HD ScanRow scan_row(int32_t total, int64_t bucket) {
  const uint64_t bits = (uint32_t)total;
  if (bits > (uint64_t)bucket * 32) return {bucket * 4, 0u};
  return {(int64_t)((bits + 7) / 8), (1u << ((8 - bits % 8) % 8)) - 1u};
}

// Tiles of kStuffTileBytes that hold the row's scan.
SJ_HD int64_t scan_tiles(ScanRow r) {
  return (r.n_bytes + kStuffTileBytes - 1) / kStuffTileBytes;
}

// Bytes of the scan in tile t of the row: 0 to kStuffTileBytes.
SJ_HD int tile_bytes(int64_t t, ScanRow r) {
  const int64_t left = r.n_bytes - t * kStuffTileBytes;
  return left <= 0 ? 0 : left >= kStuffTileBytes ? kStuffTileBytes
                                                 : (int)left;
}

// Bytes of the scan in word k of the row: 0 to 4.
SJ_HD int word_bytes(int64_t k, ScanRow r) {
  const int64_t left = r.n_bytes - 4 * k;
  return left <= 0 ? 0 : left >= 4 ? 4 : (int)left;
}

// Byte j (0 first) of an MSB-first word.
SJ_HD uint32_t word_byte(uint32_t w, int j) {
  return (w >> (24 - 8 * j)) & 0xFFu;
}

// Word k of the row as it is stuffed: bytes past the scan cleared, the
// scan's last byte OR-ed with the padding, which can make it 0xFF.
SJ_HD uint32_t scan_word(uint32_t w, int64_t k, ScanRow r) {
  const int64_t left = r.n_bytes - 4 * k;
  if (left > 4) return w;
  if (left <= 0) return 0u;
  const int sh = 32 - 8 * (int)left;                   // 0, 8, 16 or 24
  return (w & (0xFFFFFFFFu << sh)) | (r.pad << sh);
}

// Bit 7 of each byte set where the byte of w is 0xFF, four bytes at once:
// the 0xFF bytes of w are the zero bytes of ~w, and (x & 0x7F) + 0x7F has
// bit 7 set for every byte x but 0 and 0x80, without a carry between bytes.
SJ_HD uint32_t ff_bytes(uint32_t w) {
  const uint32_t x = ~w;
  return ~(((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x) & 0x80808080u;
}

SJ_HD int count_ff(uint32_t w) {
#ifdef __CUDA_ARCH__
  return __popc(ff_bytes(w));
#else
  return __builtin_popcount(ff_bytes(w));
#endif
}

// Thread `lane`'s kStuffWordsPerThread consecutive words of tile t of a
// row, stuffed (scan_word) into w; returns their 0xFF bytes.  Reads only
// the words that hold the scan.
SJ_HD int load_thread_words(const uint32_t* row, int64_t t, int lane,
                            ScanRow r, uint32_t* w) {
  const int64_t k0 = t * kStuffTileWords + lane * kStuffWordsPerThread;
  int ff = 0;
#pragma unroll
  for (int j = 0; j < kStuffWordsPerThread; ++j) {
    const int64_t k = k0 + j;
    w[j] = 4 * k < r.n_bytes ? scan_word(row[k], k, r) : 0u;
    ff += count_ff(w[j]);
  }
  return ff;
}

// Writes the scan bytes of a thread's words (load_thread_words) from
// out[0] on, a 0x00 after each 0xFF.  `out` is where the first of them
// goes: its tile's stuffed bytes at 16 * lane plus the 0xFF bytes of the
// tile's earlier lanes.
SJ_HD void emit_thread_words(const uint32_t* w, int64_t t, int lane,
                             ScanRow r, uint8_t* out) {
  const int64_t k0 = t * kStuffTileWords + lane * kStuffWordsPerThread;
  int o = 0;
#pragma unroll
  for (int j = 0; j < kStuffWordsPerThread; ++j) {
    const int n = word_bytes(k0 + j, r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i < n) {
        const uint32_t b = word_byte(w[j], i);
        out[o++] = (uint8_t)b;
        if (b == 0xFFu) out[o++] = 0;
      }
    }
  }
}

}  // namespace sjpeg
