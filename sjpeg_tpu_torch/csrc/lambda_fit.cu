// lambda_fit: the adaptive quantizer's lambda fit of every (image, table
// group) of a batch, on the histograms the card already holds
// (ops/quantize.store_histo), writing the quantizer rows that the quantize
// stage and the trellis read next and the tuned matrices that the host
// reads for its DQT headers.
//
// Replaces no TPU kernel: the JAX package fits on the host in NumPy
// (sjpeg_tpu/adaptive.py analyse_histo), and so did the port, after a
// fetch of the histograms that waited for the card, with the card idle for
// the whole fit.  The arithmetic is fit_core.cuh's, bit-exact to
// adaptive.analyse_histo + spec.finalize_quant_matrix.
//
// Bound on the H100: 1,600 (position, delta) pairs of 128 bins an (image,
// group), two int64 multiply-adds a bin (26 M integer operations at
// 16 images x 2 groups, ~0.4 us at 67 T/s), against 1 MB of histograms
// read once (~0.3 us at 3.35 TB/s).  Neither binds: the fit is a chain of
// short dependent steps a CTA, so the design keeps each step on as many
// threads as it has independent work.  Design: a CTA an (image, group)
// stages the int32 [64, 128] histogram in shared memory; one thread a
// position finds its density statistics; the 1,600 bin sums spread over
// the CTA's 320 threads, five each, each summing only up to its position's
// last non-empty bin; they replace the histogram in shared memory; one
// thread a position runs its 25-step recurrences; one thread sums num and
// den over the positions in order and sets lambda; one thread a position
// picks its delta and writes its three rows.  A group past n_groups (the
// chroma of a gray image) writes the param's own matrix, finalized.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fit_core.cuh"

namespace {

constexpr int kThreads = 320;
constexpr int kPairs = 64 * sjpeg::kFitDeltas;          // 1,600
static_assert(kPairs % kThreads == 0, "whole pairs a thread");
constexpr int kPairsPerThread = kPairs / kThreads;

__global__ void __launch_bounds__(kThreads)
lambda_fit_kernel(const int32_t* __restrict__ histos_l,
                  const int32_t* __restrict__ histos_c,
                  const int32_t* __restrict__ mats,
                  const double* __restrict__ weight, int n_images,
                  int n_groups, int qdelta_l, int qdelta_c, int q_bias,
                  int32_t* __restrict__ out) {
  const int img = blockIdx.x, g = blockIdx.y, t = threadIdx.x;
  const int32_t* base = mats + g * 64;          // the param's matrix
  const int32_t* minq = mats + (2 + g) * 64;
  const size_t row = ((size_t)img * 2 + g) * 64;
  const size_t plane = (size_t)n_images * 2 * 64;
  int32_t* iquant = out;
  int32_t* bias = out + plane;
  int32_t* quant = out + 2 * plane;

  if (g >= n_groups) {
    if (t < 64) {
      const sjpeg::FitRow r = sjpeg::fit_finalize(base[t], minq[t], t, q_bias);
      iquant[row + t] = r.iquant;
      bias[row + t] = r.bias;
      quant[row + t] = r.quant;
    }
    return;
  }

  __shared__ union {
    int32_t histo[64][sjpeg::kFitBins];
    struct {
      int64_t bsum[64][sjpeg::kFitDeltas];
      int64_t dsum[64][sjpeg::kFitDeltas];
    } sums;
  } sh;
  __shared__ int last[64];
  __shared__ bool omit[64];
  __shared__ double cov[64], den[64];
  __shared__ double lam;

  const int32_t* h = (g == 0 ? histos_l : histos_c) +
                     (size_t)img * 64 * sjpeg::kFitBins;
  for (int i = t; i < 64 * sjpeg::kFitBins; i += kThreads)
    (&sh.histo[0][0])[i] = h[i];
  __syncthreads();
  if (t < 64) {
    int64_t total;
    sjpeg::fit_density(sh.histo[t], &last[t], &total);
    omit[t] = sjpeg::fit_omitted(t, last[t], total);
  }
  __syncthreads();

  // the bin sums, pair k = position * 25 + delta; invalid quantizers'
  // entries are never read
  int64_t bs[kPairsPerThread], ds[kPairsPerThread];
#pragma unroll
  for (int i = 0; i < kPairsPerThread; ++i) {
    const int k = i * kThreads + t;
    const int p = k / sjpeg::kFitDeltas, d = k % sjpeg::kFitDeltas;
    const int dq = base[p] + d + sjpeg::kFitDeltaMin;
    bs[i] = ds[i] = 0;
    if (sjpeg::fit_valid(dq, minq[p]))
      sjpeg::fit_bin_sums(sh.histo[p], last[p], dq, &bs[i], &ds[i]);
  }
  __syncthreads();                              // the histogram is read
#pragma unroll
  for (int i = 0; i < kPairsPerThread; ++i) {
    const int k = i * kThreads + t;
    (&sh.sums.bsum[0][0])[k] = bs[i];
    (&sh.sums.dsum[0][0])[k] = ds[i];
  }
  __syncthreads();

  if (t < 64) {
    const sjpeg::FitTerms ft = sjpeg::fit_terms(
        sh.sums.bsum[t], sh.sums.dsum[t], base[t], minq[t], weight);
    cov[t] = ft.cov;
    den[t] = ft.den;
    omit[t] = omit[t] || ft.poor;
  }
  __syncthreads();
  if (t == 0) lam = sjpeg::fit_lambda(cov, den, omit);
  __syncthreads();

  if (t < 64) {
    const int delta_max = (g == 0 ? qdelta_l : qdelta_c) - sjpeg::kFitDeltaMin;
    const int q = sjpeg::fit_best_quant(sh.sums.bsum[t], sh.sums.dsum[t],
                                        base[t], minq[t], delta_max, lam,
                                        omit[t]);
    const sjpeg::FitRow r = sjpeg::fit_finalize(q, minq[t], t, q_bias);
    iquant[row + t] = r.iquant;
    bias[row + t] = r.bias;
    quant[row + t] = r.quant;
  }
}

}  // namespace

// histos_l, histos_c: int32 [b, 64, 128], contiguous (the chroma one is
// not read when n_groups is 1); mats: int32 [4, 64], the param's finalized
// luma and chroma matrices, then their min_quant rows; weight: float64
// [25], HISTO_WEIGHT; qdelta_l, qdelta_c: 0..12; out: int32 [3, b, 2, 64],
// iquant, AC-shifted bias and tuned quant rows of each (image, group).
// Launches b x 2 CTAs on `stream` and returns the CUDA error code.
extern "C" int sjpeg_lambda_fit(const void* histos_l, const void* histos_c,
                                const void* mats, const void* weight, int b,
                                int n_groups, int qdelta_l, int qdelta_c,
                                int q_bias, void* out, void* stream) {
  if (b <= 0) return 0;
  lambda_fit_kernel<<<dim3(b, 2), kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)histos_l, (const int32_t*)histos_c,
      (const int32_t*)mats, (const double*)weight, b, n_groups, qdelta_l,
      qdelta_c, q_bias, (int32_t*)out);
  return (int)cudaGetLastError();
}
