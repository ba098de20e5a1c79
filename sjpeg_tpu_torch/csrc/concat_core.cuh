// Placement of one block's bit stream at its exact bit offset in its
// image's stream: the per-block step of stream_concat.cu.
//
// __host__ __device__ like block_core.cuh, so the same code builds with
// nvcc for the kernel and with a host compiler for the tests, which hold it
// against the plain PyTorch version (ops/pack.concat_block_streams_batched).
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

// The low 32 bits of (hi:lo) >> s, 0 <= s < 32: an output word that takes
// the last s bits of the previous input word and the first 32 - s of the
// next one.
SJ_HD uint32_t join_words(uint32_t hi, uint32_t lo, int s) {
#ifdef __CUDA_ARCH__
  return __funnelshift_r(lo, hi, s);
#else
  return s ? (hi << (32 - s)) | (lo >> s) : lo;
#endif
}

// Places one block's stream, `bits` > 0 bits MSB-first in words[0 ..
// ceil(bits / 32) - 1] (zero past `bits`), at bit offset `off` of `row`, an
// image's zeroed output row of `bucket` words.  The span's output words
// between its first and its last hold bits of this block alone and take
// plain stores; the first and the last, which a neighbouring block may
// share, go through edge_or(word pointer, value) (atomicOr on the card, |=
// on the host) when the value is not zero.  Words at or past `bucket` are
// dropped.
template <typename EdgeOr>
SJ_HD void place_block(const uint32_t* words, int bits, int64_t off,
                       uint32_t* row, int64_t bucket, EdgeOr&& edge_or) {
  const int s = (int)(off & 31);
  const int64_t w0 = off >> 5;
  const int last = (int)(((off + bits - 1) >> 5) - w0);  // span: w0..w0+last
  const int used = (bits + 31) >> 5;                     // input words
  uint32_t prev = 0u;
  for (int i = 0; i <= last && w0 + i < bucket; ++i) {
    const uint32_t cur = i < used ? words[i] : 0u;
    const uint32_t v = join_words(prev, cur, s);
    prev = cur;
    if (i > 0 && i < last) {
      row[w0 + i] = v;
    } else if (v) {
      edge_or(row + w0 + i, v);
    }
  }
}

}  // namespace sjpeg
