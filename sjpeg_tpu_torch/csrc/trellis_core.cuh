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
#pragma once

#include <stdint.h>

#include "block_core.cuh"

namespace sjpeg {

constexpr uint32_t kScoreMax = 0xFFFFFFFFu;   // no path
constexpr int kTrellisNodes = 1 + 2 * 63;     // the sink and two a position

// A node in 64 bits: key (bits 0-31), zigzag position (32-37), index of its
// predecessor (38-44), level + 4096 (45-57; |level| < 4096 since the
// quantizer's (uint32 >> 16) >> 4 stays below 4096).
SJ_HD uint64_t trellis_node(uint32_t key, int pos, int prev, int32_t level) {
  return (uint64_t)key | ((uint64_t)pos << 32) | ((uint64_t)prev << 38) |
         ((uint64_t)(level + 4096) << 45);
}
SJ_HD int node_pos(uint64_t nd) { return (int)(nd >> 32) & 63; }
SJ_HD int node_prev(uint64_t nd) { return (int)(nd >> 38) & 127; }
SJ_HD int32_t node_level(uint64_t nd) {
  return (int32_t)((nd >> 45) & 8191) - 4096;
}

// One block: raster coefficients x[64] (x16), zz[64] the zigzag table,
// its quantizer rows iq/ib/qq [64] (raster; qq the clamped quant matrix)
// and lt[256] the AC code lengths of its table, the rate model.  Writes
// out[64], raster levels with the DC from the plain bias quantizer; out may
// be x itself.  Returns the number of (candidate, predecessor) scores it
// evaluated.
SJ_HD int trellis_block(const int32_t* x, const int* zz, const int32_t* iq,
                        const int32_t* ib, const int32_t* qq,
                        const int32_t* lt, int32_t* out) {
  // the block's whole AC energy disto0[63], and its last position with a
  // nonzero bias-quantized value: later positions open no node
  uint32_t total = 0;
  int last = 0;
  for (int i = 1; i < 64; ++i) {
    const int j = zz[i];
    const uint32_t v = (uint32_t)(x[j] < 0 ? -x[j] : x[j]);
    total += v * v;
    if (quantize((int32_t)v, (uint32_t)iq[j], (uint32_t)ib[j]) != 0) last = i;
  }

  uint64_t nodes[kTrellisNodes];
  nodes[0] = trellis_node(0u, 0, 0, 0);        // the sink
  int n_nodes = 1, evaluated = 0;
  const uint32_t esc = (uint32_t)lt[0xF0];
  uint32_t d0 = 0;                              // disto0[i - 1]
  for (int i = 1; i <= last; ++i) {
    const int j = zz[i];
    const int32_t c = x[j];
    const uint32_t V = (uint32_t)(c < 0 ? -c : c);
    const uint32_t d1 = d0 + V * V;             // disto0[i]
    uint32_t v = (uint32_t)quantize((int32_t)V, (uint32_t)iq[j],
                                    (uint32_t)ib[j]);
    if (v != 0) {
      const uint32_t q16 = (uint32_t)qq[j] << kAcBits;
      const uint32_t lambda = (q16 * q16) >> 5;
      int nb = (int)calc_log2(v);
      const int before = n_nodes;
      for (int cand = 0; cand < 2; ++cand) {
        const uint32_t err = V - v * q16;
        const uint32_t base = err * err + d0;
        uint32_t best = kScoreMax;
        int arg = -1;
        for (int p = before - 1; p >= 0; --p) {
          const uint64_t nd = nodes[p];
          const int run = i - 1 - node_pos(nd);
          const uint32_t len =
              nb <= 11 ? (uint32_t)lt[((run & 15) << 4) | nb] : 0u;
          const uint32_t bits =
              (uint32_t)nb + (uint32_t)(run >> 4) * esc + len;
          const uint32_t score = base + lambda * bits + (uint32_t)nd;
          if (score < best) {
            best = score;
            arg = p;
          }
        }
        evaluated += before;
        if (arg >= 0)
          nodes[n_nodes++] = trellis_node(best - d1, i, arg,
                                          c < 0 ? -(int32_t)v : (int32_t)v);
        if (--nb <= 0) break;
        v = (1u << nb) - 1u;
      }
    }
    d0 = d1;
  }

  // best end node after the tail distortion disto0[63] - disto0[pos];
  // the sink when nothing beats 0xFFFFFFFF
  int cur = 0;
  uint32_t best = kScoreMax;
  for (int p = n_nodes - 1; p >= 0; --p) {
    const uint32_t fin = (uint32_t)nodes[p] + total;
    if (fin < best) {
      best = fin;
      cur = p;
    }
  }

  const int32_t dc = quantize(x[0], (uint32_t)iq[0], (uint32_t)ib[0]);
  for (int k = 0; k < 64; ++k) out[k] = 0;
  out[0] = dc;
  for (; cur != 0; cur = node_prev(nodes[cur]))
    out[zz[node_pos(nodes[cur])]] = node_level(nodes[cur]);
  return evaluated;
}

}  // namespace sjpeg
