// The riskiness scoring behind YUV_AUTO, per pixel and per pixel pair:
// the 7-level (y, u, v) quantization of a pixel (reference
// src/colors_rgb.cc:625-667, riskiness.rgb_to_risk_index) and the exact
// sharpness-table value of two level triples (ops/riskiness._pair_score):
//
//   n = (146 |du| + 548 |dv|) (vis[y0] + vis[y1]) mask[|dy|]
//
// with vis and mask the model's two-decimal constants times 100, and the
// score n / 2e6 rounded half to even, clamped to 255.  n is at most
// 4,164 x 264 x 103 ~ 1.13e8, so int32 holds every intermediate.
//
// Bit-exact contract: equal to ops/riskiness.risk_stats_plain, itself held
// against the JAX package's risk_stats.  Written once, __host__
// __device__, for risk_stats.cu and for the g++ build of the tests.
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

constexpr int kRiskLevels = 7;                      // KRGB
constexpr int kRiskNoise = 4;                       // NOISE_LEVEL
constexpr int32_t kRiskWdu = 146, kRiskWdv = 548;   // w_du, w_dv x 100
constexpr int32_t kRiskDen = 2 * 100 * 100 * 100;
// |idx - gray| < KRGB counts a gray pixel; gray = (K/2)(1 + K) K
constexpr int32_t kRiskGray = (kRiskLevels / 2) * (1 + kRiskLevels) *
                              kRiskLevels;
// vis[y] and mask[dy] x 100, one byte each, entry i at bits 8i
constexpr uint64_t kRiskVis100 = 0x3A597484836747ull;   // 71 103 131 132 116 89 58
constexpr uint64_t kRiskMask100 = 0x4C585E62656764ull;  // 100 103 101 98 94 88 76

struct RiskLevel {
  int32_t y, u, v;
};

SJ_HD int32_t risk_byte(uint64_t table, int32_t i) {
  return (int32_t)((table >> (8 * i)) & 0xFF);
}

// One RGB pixel -> its (y, u, v) levels in 0..6.
SJ_HD RiskLevel risk_level(int32_t r, int32_t g, int32_t b) {
  const int32_t half = 1 << 15;
  const int32_t y = (19595 * r + 38469 * g + 7471 * b + half) >> 16;
  int32_t u = 128 + ((-11059 * r - 21709 * g + 32768 * b + half) >> 16);
  int32_t v = 128 + ((32768 * r - 27439 * g - 5329 * b + half) >> 16);
  u = u < 0 ? 0 : (u > 255 ? 255 : u);
  v = v < 0 ? 0 : (v > 255 ? 255 : v);
  const int32_t conv = 0x0101 * (kRiskLevels - 1);
  return {(y * conv) >> 16, (u * conv) >> 16, (v * conv) >> 16};
}

SJ_HD int32_t risk_abs(int32_t x) { return x < 0 ? -x : x; }

// n / 2e6 rounded half to even, clamped to 255 (n >= 0).  No two level
// triples give an exact tie (the nearest is 1,680 / 2e6 from one), but the
// rounding is the table's.
SJ_HD int32_t risk_round(int32_t n) {
  const int32_t t = n / kRiskDen;
  const int32_t r2 = 2 * (n - t * kRiskDen);
  const int32_t up = r2 > kRiskDen || (r2 == kRiskDen && (t & 1));
  const int32_t s = t + up;
  return s > 255 ? 255 : s;
}

// The sharpness-table value of two levels.
SJ_HD int32_t risk_pair(const RiskLevel& a, const RiskLevel& b) {
  return risk_round((kRiskWdu * risk_abs(a.u - b.u) +
                     kRiskWdv * risk_abs(a.v - b.v)) *
                    (risk_byte(kRiskVis100, a.y) +
                     risk_byte(kRiskVis100, b.y)) *
                    risk_byte(kRiskMask100, risk_abs(a.y - b.y)));
}

// The pair score depends on the two levels only through y0, y1, |du| and
// |dv|: risk_key folds those into 0..2400, risk_key_score gives that key's
// score, so a 2,401-entry table of risk_key_score equals risk_pair.
constexpr int kRiskKeys = kRiskLevels * kRiskLevels * kRiskLevels *
                          kRiskLevels;

SJ_HD int32_t risk_key(const RiskLevel& a, const RiskLevel& b) {
  return ((a.y * kRiskLevels + b.y) * kRiskLevels + risk_abs(a.u - b.u)) *
             kRiskLevels + risk_abs(a.v - b.v);
}

SJ_HD int32_t risk_key_score(int32_t key) {
  const int32_t dv = key % kRiskLevels, du = key / kRiskLevels % kRiskLevels;
  const int32_t y1 = key / (kRiskLevels * kRiskLevels) % kRiskLevels;
  const int32_t y0 = key / (kRiskLevels * kRiskLevels * kRiskLevels);
  return risk_pair({y0, 0, 0}, {y1, du, dv});
}

// The three sums of one interior position, whose pixel has level l0, its
// right neighbour l1 and the pixel below l2: the score over the noise
// level, whether it counts, and whether the pixel is gray.  `score(a, b)`
// is risk_pair or a lookup of risk_key in a table of risk_key_score.
struct RiskSums {
  int64_t score, count, gray;
};

template <class Score>
SJ_HD void risk_position(const RiskLevel& l0, const RiskLevel& l1,
                         const RiskLevel& l2, Score&& score, RiskSums& s) {
  const int32_t sum = score(l0, l1) + score(l0, l2) + score(l1, l2);
  if (sum > kRiskNoise) {
    s.score += sum;
    s.count += 1;
  }
  const int32_t idx = l0.y + kRiskLevels * l0.u +
                      kRiskLevels * kRiskLevels * l0.v;
  s.gray += risk_abs(idx - kRiskGray) < kRiskLevels;
}

}  // namespace sjpeg
