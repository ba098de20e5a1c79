// Trellis (rate-distortion Viterbi) quantization of one 8x8 block: the
// reference's per-block node search (src/enc.cc:692-761, methods 7 and 8),
// as the JAX package's NumPy oracle spec.trellis_quantize_block runs it.
//
// Every function is __host__ __device__, like block_core.cuh, so the same
// code builds with nvcc for csrc/trellis.cu and with a host compiler for the
// tests, which hold it against the plain PyTorch lattice
// (ops/trellis.trellis_quantize_plain).
//
// Per zigzag position i with a nonzero bias-quantized value v0, two
// candidates open: v0, and (1 << (nbits - 1)) - 1 when nbits > 1.  Each
// searches every node that existed before position i, the latest appended
// first and the sink last, for the least
//   score = err^2 + disto0[i-1] - disto0[pos] + lambda * bits + S[pos]
// (mod 2^32, strict <), and becomes a node only if that score is below
// 0xFFFFFFFF.  Scores are native uint32, so the reference's wraparound
// needs no emulation.  A node keeps its key S - disto0[pos] rather than S:
// the sum is the same mod 2^32 and needs one add less per evaluation.
// Visiting the nodes latest first with a strict < is the reference's tie
// rule: of equal scores the latest node wins, the sink loses every tie.
//
// The kernel ranks its rows by work before it searches them, so that a
// warp's 32 blocks cost about the same: trellis_class is a block's work
// class, rank_total and rank_starts the counting sort's class starts,
// trellis_search the search.
#pragma once

#include <stdint.h>

#include "block_core.cuh"

namespace sjpeg {

constexpr uint32_t kScoreMax = 0xFFFFFFFFu;   // no path
constexpr int kTrellisNodes = 1 + 2 * 63;     // the sink and two a position
constexpr int kTrellisClasses = 64;           // work classes, below

// The work class of one block: how many of its AC positions have a nonzero
// bias-quantized value (0..63).  Each opens one or two nodes that search
// every earlier node, so the search grows with the square of the class;
// class 0 opens none.  x: raster coefficients (x16), iq, ib: its raster
// quantizer rows.
SJ_HD int trellis_class(const int32_t* x, const int32_t* iq,
                        const int32_t* ib) {
  int count = 0;
  for (int j = 1; j < 64; ++j) {
    const uint32_t v = (uint32_t)(x[j] < 0 ? -x[j] : x[j]);
    count += quantize((int32_t)v, (uint32_t)iq[j], (uint32_t)ib[j]) != 0;
  }
  return count;
}

// A class-0 block's levels: its DC from the plain bias quantizer (iq0, ib0:
// its quantizer rows' first entries), every AC level 0, into out[64]
// (16-byte aligned), 16 B at a time.
struct alignas(16) TrellisRow4 {
  int32_t v[4];
};
SJ_HD void trellis_dc_row(int32_t x0, int32_t iq0, int32_t ib0,
                          int32_t* out) {
  TrellisRow4* o = (TrellisRow4*)out;
  o[0] = TrellisRow4{{quantize(x0, (uint32_t)iq0, (uint32_t)ib0), 0, 0, 0}};
  for (int q = 1; q < 16; ++q) o[q] = TrellisRow4{{0, 0, 0, 0}};
}

// The ranking: a stable counting sort of the rows by class, heaviest
// first.  The work pass writes each chunk's class histogram, class-major
// (hist[c * n_chunks + j]), and each row's rank among its chunk's rows of
// its class.  Over a class's row h of chunk counts, rank_total sums chunks
// [j0, j1) and rank_starts writes their exclusive prefix sums from `start`
// into starts.  A row of class c > 0 in chunk j then goes to the rows of
// every heavier class, plus starts[c][j], plus its rank.  Class 0, whose
// levels the work pass writes, is not placed.
SJ_HD int64_t rank_total(const int32_t* h, int j0, int j1) {
  int64_t total = 0;
  for (int j = j0; j < j1; ++j) total += h[j];
  return total;
}
SJ_HD void rank_starts(const int32_t* h, int j0, int j1, int64_t start,
                       int32_t* starts) {
  for (int j = j0; j < j1; ++j) {
    starts[j] = (int32_t)start;
    start += h[j];
  }
}

// The table sets a search CTA stages: those of its first and last rows'
// images (one slot when they agree or the tables are shared, sets == 1).
// slot(s) is set s's slot, or -1 for a set read where it lies.
struct TrellisSlots {
  int set[2];
  int count;
  SJ_HD TrellisSlots(int sets, int first, int last) {
    set[0] = sets > 1 ? first : 0;
    set[1] = last;
    count = sets > 1 && last != first ? 2 : 1;
  }
  SJ_HD int slot(int s) const {
    return s == set[0] ? 0 : (count > 1 && s == set[1] ? 1 : -1);
  }
};

// A thread's search nodes, in local memory: node p's key (score less its
// disto0 at its position, as below) in keys[p / 4].k[p % 4] and its zigzag
// position in byte p % 4 of pos[p / 4], so that the search loads four of
// each at a time; its predecessor and level for the backtrace.  Node 0 is
// the sink.
struct alignas(16) Key4 {
  uint32_t k[4];
};
struct TrellisNodes {
  Key4 keys[(kTrellisNodes + 3) / 4];
  uint32_t pos[(kTrellisNodes + 3) / 4];
  uint8_t prev[kTrellisNodes];
  int16_t level[kTrellisNodes];
  SJ_HD void put(int p, uint32_t key, int at, int from, int32_t lvl) {
    // nodes are put in order: the first of four starts its word
    keys[p >> 2].k[p & 3] = key;
    const int sh = 8 * (p & 3);
    pos[p >> 2] = (sh ? pos[p >> 2] : 0u) | ((uint32_t)at << sh);
    prev[p] = (uint8_t)from;
    level[p] = (int16_t)lvl;
  }
};

// One position's search over nodes [0, before), its kCand candidates at
// once: candidate c scores node p as
//   lb[c] + (run >> 4) * lesc + lambda * len + key[p]
// (mod 2^32), the reference's base + lambda * (nb + (run >> 4) * esc + len)
// + key with lb[c] = base + lambda * nb[c] and lesc = lambda * esc, where
// run = i - 1 - pos[p] and len = rate[c][(run & 15) << 4] & keep[c]
// (rate[c] the rate table's size column nb[c], keep[c] zero past size 11),
// and keeps the least score, strict <, nodes visited latest first.
template <int kCand>
SJ_HD void trellis_scan(const TrellisNodes& nd, int before, int i,
                        const uint32_t* lb, uint32_t lambda, uint32_t lesc,
                        const int32_t* const* rate, const uint32_t* keep,
                        uint32_t* best, int* arg) {
  auto visit = [&](const Key4& k4, uint32_t p4, int g, int hi) {
#pragma unroll
    for (int u = 3; u >= 0; --u) {
      if (u > hi) continue;
      const int run = i - 1 - (int)((p4 >> (8 * u)) & 0xFFu);
      const int r = (run & 15) << 4;
      const uint32_t esc = (uint32_t)(run >> 4) * lesc;
#pragma unroll
      for (int c = 0; c < kCand; ++c) {
        const uint32_t len = (uint32_t)rate[c][r] & keep[c];
        const uint32_t score = lb[c] + esc + lambda * len + k4.k[u];
        if (score < best[c]) {
          best[c] = score;
          arg[c] = 4 * g + u;
        }
      }
    }
  };
  int g = (before - 1) >> 2;
  visit(nd.keys[g], nd.pos[g], g, (before - 1) & 3);   // the top, partial
  for (--g; g >= 0; --g) visit(nd.keys[g], nd.pos[g], g, 3);
}

// pred for any thread of the warp that runs this line (a warp vote on the
// card, so that a warp runs one scan for all its threads), else the
// thread's own.
SJ_HD bool warp_any(bool pred) {
#ifdef __CUDA_ARCH__
  return __any_sync(__activemask(), pred);
#else
  return pred;
#endif
}

// A coded position's coefficient and disto0 before it.
struct alignas(8) TrellisCoded {
  int32_t c;
  uint32_t d0;
};

// One block: raster coefficients x[64] (x16), zz[64] the zigzag table,
// its quantizer rows iq/ib/qq [64] (raster; qq the clamped quant matrix)
// and lt[256] the AC code lengths of its table, the rate model.  Writes
// out[64] (16-byte aligned), raster levels with the DC from the plain bias
// quantizer; out may be x itself.  A first pass over the 63 AC positions
// in zigzag order (compile-time indices: x may sit in registers) keeps the
// coded positions, those with a nonzero bias-quantized value, with their
// coefficient and disto0 before them; the search then steps through the
// t-th coded position of every thread of a warp together (rows ranked by
// their count of coded positions run the same steps), both candidates
// scanning the nodes together, four at a time (trellis_scan), with the
// position's constants hoisted.  Returns the number of (candidate,
// predecessor) scores evaluated.
SJ_HD int trellis_search(const int32_t* x, const int* zz, const int32_t* iq,
                         const int32_t* ib, const int32_t* qq,
                         const int32_t* lt, int32_t* out) {
  const int zigzag[64] = SJPEG_ZIGZAG;
  TrellisCoded coded[63];
  uint64_t mask = 0;
  uint32_t total = 0;                           // disto0[63] at the end
  int count = 0;
#pragma unroll
  for (int i = 1; i < 64; ++i) {
    const int j = zigzag[i];
    const uint32_t v = (uint32_t)(x[j] < 0 ? -x[j] : x[j]);
    if (quantize((int32_t)v, (uint32_t)iq[j], (uint32_t)ib[j]) != 0) {
      coded[count++] = TrellisCoded{x[j], total};
      mask |= (uint64_t)1 << i;
    }
    total += v * v;
  }
  const int32_t dc = quantize(x[0], (uint32_t)iq[0], (uint32_t)ib[0]);

  TrellisNodes nd;
  nd.put(0, 0u, 0, 0, 0);                       // the sink
  int n_nodes = 1, evaluated = 0;
  const uint32_t esc = (uint32_t)lt[0xF0];
  for (int t = 0; t < count; ++t) {
    const int i = lowest_bit(mask);
    mask &= mask - 1;
    const int j = zz[i];
    const TrellisCoded e = coded[t];
    const uint32_t V = (uint32_t)(e.c < 0 ? -e.c : e.c);
    const uint32_t d1 = e.d0 + V * V;           // disto0[i]
    const uint32_t v0 = (uint32_t)quantize((int32_t)V, (uint32_t)iq[j],
                                           (uint32_t)ib[j]);
    const uint32_t q16 = (uint32_t)qq[j] << kAcBits;
    const uint32_t lambda = (q16 * q16) >> 5;
    const int nb0 = (int)calc_log2(v0);
    const int n_cand = nb0 > 1 ? 2 : 1;
    uint32_t v[2], lb[2], keep[2], best[2] = {kScoreMax, kScoreMax};
    int arg[2] = {-1, -1};
    const int32_t* rate[2];
    for (int k = 0; k < 2; ++k) {               // k = 1 unused if n_cand 1
      const int nb = nb0 - k;
      v[k] = k ? (1u << nb) - 1u : v0;
      const uint32_t err = V - v[k] * q16;
      lb[k] = err * err + e.d0 + lambda * (uint32_t)nb;
      keep[k] = nb <= 11 ? 0xFFFFFFFFu : 0u;
      rate[k] = lt + (nb <= 11 && nb > 0 ? nb : 0);
    }
    if (warp_any(n_cand == 2))
      trellis_scan<2>(nd, n_nodes, i, lb, lambda, lambda * esc, rate, keep,
                      best, arg);
    else
      trellis_scan<1>(nd, n_nodes, i, lb, lambda, lambda * esc, rate, keep,
                      best, arg);
    evaluated += n_cand * n_nodes;
    for (int k = 0; k < n_cand; ++k)
      if (arg[k] >= 0)
        nd.put(n_nodes++, best[k] - d1, i, arg[k],
               e.c < 0 ? -(int32_t)v[k] : (int32_t)v[k]);
  }

  // best end node after the tail distortion disto0[63] - disto0[pos];
  // the sink when nothing beats 0xFFFFFFFF
  int cur = 0;
  uint32_t best = kScoreMax;
  for (int p = n_nodes - 1; p >= 0; --p) {
    const uint32_t fin = nd.keys[p >> 2].k[p & 3] + total;
    if (fin < best) {
      best = fin;
      cur = p;
    }
  }

  TrellisRow4* o = (TrellisRow4*)out;
  for (int q = 0; q < 16; ++q) o[q] = TrellisRow4{{0, 0, 0, 0}};
  out[0] = dc;
  for (; cur != 0; cur = nd.prev[cur])
    out[zz[(nd.pos[cur >> 2] >> (8 * (cur & 3))) & 0xFFu]] = nd.level[cur];
  return evaluated;
}

}  // namespace sjpeg
