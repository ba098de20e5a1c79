// The adaptive quantizer's lambda fit of one (image, table group): from
// the group's [64, 128] histogram of |coefficient| >> 2 and its matrix,
// the tuned matrix and its quantizer rows (reference src/enc.cc:993-1182,
// then :327-330 and :598-630).
//
// Bit-exact contract: equal to adaptive.analyse_histo followed by
// spec.finalize_quant_matrix, as csrc/native_host.cc AnalyseImage (K = 1)
// already is.  In order:
//   - integer bin sums of the histogram with the bit lengths and squared
//     errors of each quantizer dq = quant + d - 12 (d = 0..24): exact
//     int64, so any order or split of the bins gives the same sums;
//   - the density filter and the positions the reference never tunes;
//   - eight float64 recurrences over d, in the reference's order and with
//     its expression shapes (w*x, (w*x)*x, (w*dsum)*dsum, ...), then the
//     correlation test;
//   - num and den summed over the 64 positions in order, then lambda;
//   - each position's first strict minimum of the float32 score;
//   - the clamp to min_quant, iquant and the AC-shifted bias.
// The float64 products and sums go through SJ_DMUL / SJ_DADD / SJ_DSUB:
// on the card the round-to-nearest intrinsics, which nvcc never contracts
// into an FMA (the kernels share one set of nvcc flags, so no
// -fmad=false); in a host build plain operators, compiled with
// -ffp-contract=off.  Double division is IEEE on the card.
//
// Written once, __host__ __device__, for lambda_fit.cu, for the host
// helpers' node fit (native_host.cc, which keeps its own table of bin sums
// over every quantizer and gathers a position's 25 from it) and for the
// g++ build of the tests.
#pragma once

#include <float.h>
#include <stdint.h>

#ifndef SJ_HD
#ifdef __CUDACC__
#define SJ_HD __host__ __device__ __forceinline__
#else
#define SJ_HD inline
#endif
#endif

#ifdef __CUDA_ARCH__
#define SJ_DMUL(a, b) __dmul_rn((a), (b))
#define SJ_DADD(a, b) __dadd_rn((a), (b))
#define SJ_DSUB(a, b) __dsub_rn((a), (b))
#define SJ_CLZ(x) __clz(x)
#else
#define SJ_DMUL(a, b) ((a) * (b))
#define SJ_DADD(a, b) ((a) + (b))
#define SJ_DSUB(a, b) ((a) - (b))
#define SJ_CLZ(x) __builtin_clz(x)
#endif

namespace sjpeg {

constexpr int kFitBins = 128;                   // MAX_HISTO_DCT_COEFF
constexpr int kFitDeltas = 25;                  // QSIZE
constexpr int kFitDeltaMin = -12;               // QDELTA_MIN
constexpr double kFitLambda = 128.0;            // HLAMBDA
constexpr double kFitDensity = 0.5;             // DENSITY_THRESHOLD
constexpr double kFitCorrelation = 0.5;         // CORRELATION_THRESHOLD
constexpr uint64_t kFitOmitted = 0x103;         // OMITTED_CHANNELS
constexpr int kFitBiasDc = 0x80;                // BIAS_DC

// Whether quantizer dq may replace a position's value.
SJ_HD bool fit_valid(int dq, int min_q) { return dq >= min_q && dq <= 255; }

// The exact sums over bins [0, last) of one position's histogram h for
// quantizer dq >= 1: the bit lengths of the quantized bin centroids
// (*bsum) and their squared reconstruction errors (*dsum).  Bins past the
// last non-empty one add nothing.
SJ_HD void fit_bin_sums(const int32_t* h, int last, int dq, int64_t* bsum,
                        int64_t* dsum) {
  const int32_t idq = ((1 << 16) + dq - 1) / dq;
  int64_t sb = 0, sd = 0;
  for (int b = 0; b < last; ++b) {
    const int32_t v = (b << 2) + 2;                 // the bin's centroid
    const int32_t qv = (v * idq + (1 << 15)) >> 16;
    const int32_t bits = qv > 0 ? 32 - SJ_CLZ((uint32_t)qv) : 0;
    const int32_t e = qv > 0 ? v - qv * dq : v;
    sb += (int64_t)h[b] * bits;
    sd += (int64_t)h[b] * (e * e);
  }
  *bsum = sb;
  *dsum = sd;
}

// A position's histogram statistics for the density filter: its
// non-empty bins end at *last, and it counts *total values (int32 counts
// on the card, int64 in the host helpers).
template <typename Count>
SJ_HD void fit_density(const Count* h, int* last, int64_t* total) {
  int l = 0;
  int64_t t = 0;
  for (int b = 0; b < kFitBins; ++b) {
    if (h[b] > 0) l = b + 1;
    t += h[b];
  }
  *last = l;
  *total = t;
}

// Whether position p stays out of lambda's fit and keeps its quantizer:
// one the reference never tunes, or one whose values are too sparse.
SJ_HD bool fit_omitted(int p, int last, int64_t total) {
  return ((kFitOmitted >> p) & 1) != 0 ||
         (double)total < kFitDensity * (double)last;
}

struct FitTerms {
  double cov;   // sw * sxy1 - sx * sy1
  double den;   // sw * sxy2 - sx * sy2
  bool poor;    // the distortion cloud correlates too weakly
};

// One position's weighted least-squares terms over its 25 deltas, from its
// bin sums (entries of invalid quantizers are never read: their weight is
// 0, so they add +0.0).
SJ_HD FitTerms fit_terms(const int64_t* bsum, const int64_t* dsum, int q,
                         int min_q, const double* weight) {
  double sw = 0, sx = 0, sxx = 0;
  double sy1 = 0, syy1 = 0, sy2 = 0, sxy1 = 0, sxy2 = 0;
  for (int d = 0; d < kFitDeltas; ++d) {
    const bool valid = fit_valid(q + d + kFitDeltaMin, min_q);
    const double w = (valid && weight[d] > 0.0) ? weight[d] : 0.0;
    if (w == 0.0) continue;        // every term is +0.0: the sums stay
    const double x = (double)(d + kFitDeltaMin);
    const double bs = (double)bsum[d];
    const double ds = (double)dsum[d];
    const double wd = SJ_DMUL(w, ds);
    const double wb = SJ_DMUL(w, bs);
    sw = SJ_DADD(sw, w);
    sx = SJ_DADD(sx, SJ_DMUL(w, x));
    sxx = SJ_DADD(sxx, SJ_DMUL(SJ_DMUL(w, x), x));
    sy1 = SJ_DADD(sy1, wd);
    syy1 = SJ_DADD(syy1, SJ_DMUL(wd, ds));
    sy2 = SJ_DADD(sy2, wb);
    sxy1 = SJ_DADD(sxy1, SJ_DMUL(wd, x));
    sxy2 = SJ_DADD(sxy2, SJ_DMUL(wb, x));
  }
  FitTerms t;
  t.cov = SJ_DSUB(SJ_DMUL(sw, sxy1), SJ_DMUL(sx, sy1));
  t.den = SJ_DSUB(SJ_DMUL(sw, sxy2), SJ_DMUL(sx, sy2));
  t.poor = SJ_DMUL(t.cov, t.cov) <
           SJ_DMUL(SJ_DMUL(kFitCorrelation,
                           SJ_DSUB(SJ_DMUL(sw, sxx), SJ_DMUL(sx, sx))),
                   SJ_DSUB(SJ_DMUL(sw, syy1), SJ_DMUL(sy1, sy1)));
  return t;
}

// Lambda from the 64 positions' terms: num and den summed in position
// order over the positions kept in the fit (an omitted one adds +0.0).
SJ_HD double fit_lambda(const double* cov, const double* den,
                        const bool* omit) {
  double num = 0, dsum = 0;
  for (int p = 0; p < 64; ++p) {
    num = SJ_DADD(num, omit[p] ? 0.0 : cov[p]);
    dsum = SJ_DADD(dsum, omit[p] ? 0.0 : den[p]);
  }
  if (num > 1000.0 && dsum < -10.0) {
    const double lam = -num / dsum;
    return lam < 1.0 ? 1.0 : lam;
  }
  return kFitLambda;
}

// A position's tuned quantizer: q plus the delta of the first strict
// minimum of the float32 score (float32 distortion + lambda x float32
// size, in float64, rounded to float32) over the valid deltas up to
// delta_max; q itself when the position is omitted or no score lies below
// FLT_MAX.  Skipping the invalid deltas, whose score the reference sets to
// infinity, picks the same first minimum.
SJ_HD int fit_best_quant(const int64_t* bsum, const int64_t* dsum, int q,
                         int min_q, int delta_max, double lam, bool omit) {
  if (omit) return q;
  float cur = 0.0f;
  int best = -1;
  for (int d = 0; d <= delta_max; ++d) {
    if (!fit_valid(q + d + kFitDeltaMin, min_q)) continue;
    const double dl = (double)(float)(double)dsum[d];
    if (!(dl < (double)FLT_MAX)) continue;
    const double sl = (double)(float)(double)bsum[d];
    const float sc = (float)SJ_DADD(dl, SJ_DMUL(lam, sl));
    if (best < 0 || sc < cur) {
      cur = sc;
      best = d;
    }
  }
  return (best >= 0 && cur < FLT_MAX) ? q + best + kFitDeltaMin : q;
}

struct FitRow {
  int32_t quant;    // clamped to min_quant
  int32_t iquant;   // 16-bit reciprocal; 0xFFFF where quant is 1
  int32_t bias;     // the AC-shifted bias
};

// spec.finalize_quant_matrix at raster position p.
SJ_HD FitRow fit_finalize(int q, int min_q, int p, int q_bias) {
  if (q < min_q) q = min_q;
  const bool one = q == 1;
  const int64_t bias = one ? 0x80 : (p == 0 ? kFitBiasDc : q_bias);
  FitRow r;
  r.quant = q;
  r.iquant = one ? 0xFFFF : ((1 << 16) + q / 2) / q;
  r.bias = (int32_t)(((((bias * q) << 4) + 128) >> 8) & 0xFFFF);
  return r;
}

}  // namespace sjpeg
