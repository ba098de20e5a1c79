// Host helpers of the PyTorch/CUDA port (sjpeg_tpu_torch.native).
//
// The card hands back compacted entropy bit-streams (uint32 words,
// MSB-first) and exact bit counts; what follows is byte work on the host:
// the scan's '1' padding and 0xFF stuffing (every scan tail), the merge of
// stripe streams, the Huffman merge of the host table builds, and the
// search's adaptive-quantization node fit.  A copy of the JAX package's
// native helpers with the same C interface; the NumPy and torch versions
// in bitio.py, huffman.py and adaptive.py stay as their parity twins.
//
// Built with g++ at first use (sjpeg_tpu_torch/kernels.py, host_library):
// -O3 -fPIC -shared -std=c++17 -pthread -ffp-contract=off, no -march, so
// the node fit keeps its float64 bits on every host.

#include <cstddef>
#include <cstdint>
#include <cstring>

extern "C" {

// Expand a raw byte stream with JPEG 0xFF byte stuffing.  `out` must hold
// at least in_size * 2 bytes.  Returns the number of bytes written.
size_t sjpeg_stuff_bytes(const uint8_t* in, size_t in_size, uint8_t* out) {
  size_t o = 0;
  size_t i = 0;
  // fast path: scan for 0xFF in word-sized gulps, memcpy clean runs
  while (i < in_size) {
    size_t run = i;
    while (run + 8 <= in_size) {
      uint64_t w;
      memcpy(&w, in + run, 8);
      // detect any 0xFF byte: (w & 0x80...) of (w + 0x0101..) trick is for
      // zero bytes; for 0xFF test ~w for zero bytes.
      uint64_t x = ~w;
      if ((x - 0x0101010101010101ULL) & ~x & 0x8080808080808080ULL) break;
      run += 8;
    }
    while (run < in_size && in[run] != 0xFF) ++run;
    memcpy(out + o, in + i, run - i);
    o += run - i;
    i = run;
    if (i < in_size) {          // in[i] == 0xFF
      out[o++] = 0xFF;
      out[o++] = 0x00;
      ++i;
    }
  }
  return o;
}

// Convert big-endian uint32 words into a byte stream with final '1'-bit
// padding and 0xFF stuffing, all in one pass.  `total_bits` is the exact
// stream length; `out` must hold at least (total_bits / 8 + 2) * 2 bytes.
// Returns bytes written.
size_t sjpeg_words_to_scan(const uint32_t* words, size_t total_bits,
                           uint8_t* out) {
  const size_t n_bytes = (total_bits + 7) / 8;
  size_t o = 0;
  for (size_t b = 0; b < n_bytes; ++b) {
    uint32_t w = words[b / 4];
    uint8_t byte = (uint8_t)(w >> (24 - 8 * (b % 4)));
    if (b == n_bytes - 1) {
      const unsigned pad = (unsigned)(8 - (total_bits % 8)) % 8;
      byte |= (uint8_t)((1u << pad) - 1);
    }
    out[o++] = byte;
    if (byte == 0xFF) out[o++] = 0x00;
  }
  return o;
}

// Merge S bit streams (each: words[i] = big-endian uint32 chunk stream,
// bit_lens[i] bits long, stride `words_stride` uint32s apart) into `out`
// (uint32 words, caller-zeroed, large enough for the sum of lengths).
// Returns the total bit count.
uint64_t sjpeg_merge_streams(const uint32_t* words, size_t words_stride,
                             const int32_t* bit_lens, size_t n_streams,
                             uint32_t* out) {
  uint64_t pos = 0;
  for (size_t s = 0; s < n_streams; ++s) {
    const uint32_t* src = words + s * words_stride;
    const int64_t len = bit_lens[s];
    const unsigned shift = (unsigned)(pos & 31);
    size_t q = (size_t)(pos >> 5);
    const size_t n_words = (size_t)((len + 31) / 32);
    if (shift == 0) {
      for (size_t j = 0; j < n_words; ++j) out[q + j] |= src[j];
    } else {
      for (size_t j = 0; j < n_words; ++j) {
        const uint32_t w = src[j];
        out[q + j] |= w >> shift;
        out[q + j + 1] |= w << (32 - shift);
      }
    }
    pos += (uint64_t)len;
  }
  return pos;
}


// Huffman merge: code lengths from symbol frequencies, mirroring
// huffman.build_optimal_table's Python merge loop exactly
// (sorted-key list with tie-breaking indices, a fake lowest-frequency
// symbol at index `size` for the forbidden all-ones code, subtree-member
// traversal on every merge).  Only the O(n^2)-ish merge runs natively;
// the bits histogram / counting sort / <=16-bit rebalance stay in Python.
// freq: uint64[size]; codesizes: int32[size + 1] (zero-initialized here).
void sjpeg_huffman_codesizes(const uint64_t* freq, int size,
                             int32_t* codesizes) {
  // keys sorted decreasing; key = (freq << 9) | index
  uint64_t keys[258];
  int nb = 0;
  for (int i = 0; i < size; ++i) {
    if (freq[i] > 0) keys[nb++] = (freq[i] << 9) | (uint64_t)i;
  }
  // insertion sort, decreasing (n <= 257 — fine)
  for (int i = 1; i < nb; ++i) {
    uint64_t k = keys[i];
    int j = i - 1;
    while (j >= 0 && keys[j] < k) { keys[j + 1] = keys[j]; --j; }
    keys[j + 1] = k;
  }
  keys[nb++] = (1ULL << 9) | (uint64_t)size;   // fake all-ones symbol

  // subtree member lists as singly linked chains per slot index
  int head[257], tail[257], nxt[257];
  for (int i = 0; i <= size; ++i) {
    head[i] = tail[i] = i;
    nxt[i] = -1;
    codesizes[i] = 0;
  }

  while (nb > 1) {
    uint64_t s1 = keys[nb - 2];
    uint64_t s2 = keys[nb - 1];
    int i = (int)(s1 & 0x1FF);
    int j = (int)(s2 & 0x1FF);
    nxt[tail[i]] = head[j];
    tail[i] = tail[j];
    for (int leaf = head[i]; leaf != -1; leaf = nxt[leaf]) {
      codesizes[leaf] += 1;
    }
    uint64_t merged = s1 + (s2 & ~0x1FFULL);
    nb -= 1;
    int k = nb - 1;
    while (k > 0 && keys[k - 1] < merged) {
      keys[k] = keys[k - 1];
      --k;
    }
    keys[k] = merged;
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Adaptive-quantization node fit (adaptive.analyse_histo_nodes).
//
// The search tabulates the histogram-driven quant tuning for every node of
// the bisection tree up front: B images x K candidate matrices.  The fit's
// arithmetic is fit_core.cuh's, the core of the card's lambda_fit kernel,
// so one C++ definition serves both (bit-identical to analyse_histo and to
// the reference's scalar loops, src/enc.cc:993-1182); threaded over
// images.  Structure: one per-image (position, dq) bin-sum table feeds all
// K nodes (position and delta only enter the clouds through dq).
// ---------------------------------------------------------------------------

#include <atomic>
#include <thread>
#include <vector>

#include "fit_core.cuh"

namespace {

using sjpeg::kFitBins;
using sjpeg::kFitDeltaMin;
using sjpeg::kFitDeltas;

struct DqTables {
  // exact integer (bits, err) sums-per-bin lookups over dq in [0, 255]
  int64_t bits[256][kFitBins];
  int64_t err[256][kFitBins];
  DqTables() {
    for (int dqv = 0; dqv < 256; ++dqv) {
      const int64_t dq = dqv < 1 ? 1 : dqv;
      const int64_t idq = ((1LL << 16) + dq - 1) / dq;
      for (int b = 0; b < kFitBins; ++b) {
        const int64_t v = (int64_t(b) << 2) + 2;
        const int64_t qv = (v * idq + (1 << 15)) >> 16;
        bits[dqv][b] = qv > 0 ? 64 - __builtin_clzll((uint64_t)qv) : 0;
        const int64_t d = v - qv * dq;
        err[dqv][b] = qv > 0 ? d * d : v * v;
      }
    }
  }
};

void AnalyseImage(const int64_t* histo /*[64][kFitBins]*/,
                  const uint8_t* quants /*[K][64]*/, int K,
                  const uint8_t* min_quant, int delta_max,
                  const double* weight /*[kFitDeltas]*/,
                  const DqTables& t, uint8_t* out /*[K][64]*/) {
  // per-position integer bin sums over every dq value (shared by all K)
  static thread_local std::vector<int64_t> hb_v, hd_v;
  hb_v.assign(64 * 256, 0);
  hd_v.assign(64 * 256, 0);
  int64_t* hb = hb_v.data();
  int64_t* hd = hd_v.data();
  bool omit_img[64];
  for (int p = 0; p < 64; ++p) {
    const int64_t* h = histo + p * kFitBins;
    int last;
    int64_t total;
    sjpeg::fit_density(h, &last, &total);
    omit_img[p] = sjpeg::fit_omitted(p, last, total);
    for (int dq = 0; dq < 256; ++dq) {
      int64_t sb = 0, sd = 0;
      const int64_t* bt = t.bits[dq];
      const int64_t* et = t.err[dq];
      for (int b = 0; b < kFitBins; ++b) {
        sb += h[b] * bt[b];
        sd += h[b] * et[b];
      }
      hb[p * 256 + dq] = sb;
      hd[p * 256 + dq] = sd;
    }
  }

  for (int k = 0; k < K; ++k) {
    const uint8_t* q = quants + k * 64;
    int64_t bsum[64][kFitDeltas], dsum[64][kFitDeltas];
    double cov[64], den[64];
    bool omit[64];
    for (int p = 0; p < 64; ++p) {
      for (int d = 0; d < kFitDeltas; ++d) {   // invalid dq: never read
        const int dq = (int)q[p] + d + kFitDeltaMin;
        const int dqi = dq < 1 ? 1 : (dq > 255 ? 255 : dq);
        bsum[p][d] = hb[p * 256 + dqi];
        dsum[p][d] = hd[p * 256 + dqi];
      }
      const sjpeg::FitTerms ft = sjpeg::fit_terms(bsum[p], dsum[p], q[p],
                                                  min_quant[p], weight);
      cov[p] = ft.cov;
      den[p] = ft.den;
      omit[p] = omit_img[p] || ft.poor;
    }
    const double lam = sjpeg::fit_lambda(cov, den, omit);
    for (int p = 0; p < 64; ++p)
      out[k * 64 + p] = (uint8_t)sjpeg::fit_best_quant(
          bsum[p], dsum[p], q[p], min_quant[p], delta_max, lam, omit[p]);
  }
}

}  // namespace

extern "C" {

// histos: int64[B][64][128]; quants: uint8[K][64] (pre-clamped to
// min_quant); out: uint8[B][K][64].  Bit-identical per pair to
// adaptive.analyse_histo (the reference's AnalyseHisto integer+double
// semantics).
void sjpeg_analyse_histo_nodes(const int64_t* histos, int B,
                               const uint8_t* quants, int K,
                               const uint8_t* min_quant, int qdelta_max,
                               const double* weight, uint8_t* out,
                               int n_threads) {
  static const DqTables tables;
  const int delta_max = qdelta_max - kFitDeltaMin;
  if (n_threads < 1) n_threads = 1;
  if (n_threads > B) n_threads = B;
  std::vector<std::thread> threads;
  std::atomic<int> next{0};
  auto worker = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= B) return;
      AnalyseImage(histos + (size_t)i * 64 * kFitBins, quants, K, min_quant,
                   delta_max, weight, tables, out + (size_t)i * K * 64);
    }
  };
  if (n_threads == 1) {
    worker();
  } else {
    for (int n = 0; n < n_threads; ++n) threads.emplace_back(worker);
    for (auto& th : threads) th.join();
  }
}

}  // extern "C"
