// The sharp-YUV sweep loop of one image: up to four Gauss-Seidel sweeps
// over its row pairs, each pair upsampling the current chroma with the
// 9-3-3-1 half-pel filter, measuring the luma drift in linear light and
// feeding it back into Y and chroma, with the per-image divergence exit
// (reference src/yuv_convert.cc:581-668; the JAX package's
// sharp_yuv_device._sharp_core, a lax.scan inside a lax.while_loop).
//
// Bit-exact contract: the planes equal the port's plain PyTorch version,
// sharp_yuv.sharp_iterate_plain, itself held against the JAX package.  All
// arithmetic is int32 with the reference's shift order; right shifts of
// negative chroma residuals are arithmetic (floor), as in torch, on nvcc
// and g++ alike.  The |luma error| sum is int64.
//
// The image is written once, as `sharp_image`, over a Cta policy:
// `columns(n, f)` runs f(j) for the chroma columns j < n, `sync()` orders
// one row pair's writes before the next one's reads, and `sum(v)` adds a
// value over the policy's threads and hands every thread the total.
// sharp_yuv.cu supplies a policy of a CTA's threads striding over the
// columns; a host build supplies one that loops over them, so the same
// sweep runs with g++ in the tests.
//
// In place: row pair k reads chroma row k-1 as updated (row 0 as it was,
// for k = 0), and rows k and k+1 as they were at the start of the sweep
// (the last row reads itself).  Updated rows go to a two-row ring,
// `rows`, first: row k's update is copied into the plane during pair k+1,
// whose reads no longer need its old values, and the last row after the
// sweep.  One sync between row pairs suffices: pair k writes ring slot
// k & 1 while it reads slot (k - 1) & 1.
#pragma once

#include <stdint.h>

#ifndef SJ_HD
#ifdef __CUDACC__
#define SJ_HD __host__ __device__ __forceinline__
#else
#define SJ_HD __host__ __device__ inline
#endif
#endif
#ifndef SJ_SHARP_FN
#define SJ_SHARP_FN SJ_HD
#endif

namespace sjpeg {

constexpr int kSharpMaxYT = (256 << 2) - 1;        // SFIX = 2
constexpr int kSharpIterations = 4;
constexpr int kGammaToLinearSize = kSharpMaxYT + 1;
constexpr int kGammaTableSize = 32;
constexpr int kLinearToGammaSize = kGammaTableSize + 2;
constexpr int kGammaToLinearBits = 14;

// gamma_to_linear [1024] and linear_to_gamma [34] (sharp_yuv._gamma_tables)
struct SharpTables {
  const int32_t* g2l;
  const int32_t* l2g;
};

// One image's planes, int32, with w and h the even padded sizes.
struct SharpImage {
  int32_t* y;            // [h, w] best Y (W values), updated in place
  int32_t* uv;           // [h/2, w/2, 3] best chroma residuals, in place
  const int32_t* ty;     // [h, w] target Y
  const int32_t* tuv;    // [h/2, w/2, 3] target chroma
  int32_t* rows;         // [2, w/2, 3] ring of updated chroma rows
  int w, h;
};

SJ_HD int32_t sharp_clip_y(int32_t v) {
  return v < 0 ? 0 : (v > kSharpMaxYT ? kSharpMaxYT : v);
}

SJ_HD int32_t sharp_gray(int32_t r, int32_t g, int32_t b) {
  return (13933 * r + 46871 * g + 4732 * b + (1 << 15)) >> 16;
}

// interpolated linear -> gamma, Q14 in [0, 16384] -> the Y_T domain
SJ_HD int32_t sharp_l2g(const int32_t* l2g, int32_t value) {
  const int32_t v = value * kGammaTableSize;
  const int32_t pos = v >> kGammaToLinearBits;
  const int32_t x = v - (pos << kGammaToLinearBits);
  const int32_t v0 = l2g[pos];
  return v0 + (((l2g[pos + 1] - v0) * x) >> kGammaToLinearBits);
}

// The upsampled chroma at one pixel: the half-pel filter over its own row
// `a` and its vertical neighbour `b` at columns j-1, j, j+1 (index 0, 1,
// 2); `side` is -1 for the left pixel 2j, +1 for the right pixel 2j+1, and
// `edge` says that the image ends on that side.
SJ_HD int32_t sharp_up(const int32_t a[3], const int32_t b[3], int side,
                       bool edge) {
  if (edge) return (a[1] * 3 + b[1] + 2) >> 2;
  const int o = 1 + side;
  return (a[1] * 9 + a[o] * 3 + b[1] * 3 + b[o] + 8) >> 4;
}

// Chroma column j of row pair k: pixels (2k + r, 2j + x).  a, p, n: the
// row pair's own chroma row, the row above and the row below, [channel]
// [column j-1+d]; y, ty: best and target Y [r][x], y updated; tuv: the
// column's target chroma; uv_out: its updated chroma.  Returns the sum of
// |luma error| over the four pixels.
SJ_HD int32_t sharp_column(const SharpTables& t, const int32_t a[3][3],
                           const int32_t p[3][3], const int32_t n[3][3],
                           int32_t y[2][2], const int32_t ty[2][2],
                           const int32_t tuv[3], bool first, bool last,
                           int32_t uv_out[3]) {
  int32_t sum[3] = {2, 2, 2};
  int32_t diff = 0;
  for (int r = 0; r < 2; ++r) {
    for (int x = 0; x < 2; ++x) {
      int32_t lin[3];
      for (int c = 0; c < 3; ++c) {
        const int32_t up = sharp_up(a[c], r ? n[c] : p[c], x ? 1 : -1,
                                    x ? last : first);
        lin[c] = t.g2l[sharp_clip_y(y[r][x] + up)];
        sum[c] += lin[c];
      }
      const int32_t d =
          ty[r][x] - sharp_l2g(t.l2g, sharp_gray(lin[0], lin[1], lin[2]));
      y[r][x] = sharp_clip_y(y[r][x] + d);
      diff += d < 0 ? -d : d;
    }
  }
  int32_t g[3];
  for (int c = 0; c < 3; ++c) g[c] = sharp_l2g(t.l2g, sum[c] >> 2);
  const int32_t w = sharp_gray(g[0], g[1], g[2]);
  for (int c = 0; c < 3; ++c) uv_out[c] = a[c][1] + (tuv[c] - (g[c] - w));
  return diff;
}

// Loads, runs and stores chroma column j of row pair k (see the top).
SJ_HD int32_t sharp_step(const SharpTables& t, const SharpImage& im, int k,
                         int j) {
  const int uv_w = im.w >> 1, uv_h = im.h >> 1;
  const bool first = j == 0, last = j == uv_w - 1;
  const int32_t* own = im.uv + (int64_t)k * uv_w * 3;
  const int32_t* above =
      k ? im.rows + ((k - 1) & 1) * uv_w * 3 : own;
  const int32_t* below = k + 1 < uv_h ? own + uv_w * 3 : own;
  int32_t a[3][3], p[3][3], n[3][3];
  for (int d = 0; d < 3; ++d) {
    const int col = j - 1 + d;
    if ((d == 0 && first) || (d == 2 && last)) continue;   // never read
    for (int c = 0; c < 3; ++c) {
      a[c][d] = own[col * 3 + c];
      p[c][d] = above[col * 3 + c];
      n[c][d] = below[col * 3 + c];
    }
  }
  int32_t* y = im.y + (int64_t)2 * k * im.w + 2 * j;
  const int32_t* ty = im.ty + (int64_t)2 * k * im.w + 2 * j;
  int32_t yy[2][2] = {{y[0], y[1]}, {y[im.w], y[im.w + 1]}};
  const int32_t tt[2][2] = {{ty[0], ty[1]}, {ty[im.w], ty[im.w + 1]}};
  const int32_t* tuv = im.tuv + ((int64_t)k * uv_w + j) * 3;
  int32_t* ring = im.rows + (k & 1) * uv_w * 3 + j * 3;
  const int32_t d =
      sharp_column(t, a, p, n, yy, tt, tuv, first, last, ring);
  y[0] = yy[0][0];
  y[1] = yy[0][1];
  y[im.w] = yy[1][0];
  y[im.w + 1] = yy[1][1];
  if (k) {       // row k-1's update: pair k no longer reads its old values
    const int32_t* done = im.rows + ((k - 1) & 1) * uv_w * 3 + j * 3;
    int32_t* dst = im.uv + ((int64_t)(k - 1) * uv_w + j) * 3;
    for (int c = 0; c < 3; ++c) dst[c] = done[c];
  }
  return d;
}

// Up to kSharpIterations sweeps of one image; returns the sweeps it ran.
// An image stops after a sweep (whose update it keeps) that is not its
// first and whose |luma error| sum is under 3 w h or above the previous
// sweep's.
template <class Cta>
SJ_SHARP_FN int sharp_image(Cta& cta, const SharpTables& t,
                            const SharpImage& im) {
  const int uv_w = im.w >> 1, uv_h = im.h >> 1;
  const int64_t thr = 3 * (int64_t)im.w * im.h;
  int64_t prev = 0;
  int it = 0;
  while (it < kSharpIterations) {
    int64_t part = 0;
    for (int k = 0; k < uv_h; ++k) {
      cta.columns(uv_w, [&](int j) { part += sharp_step(t, im, k, j); });
      cta.sync();
    }
    cta.columns(uv_w, [&](int j) {
      const int32_t* done = im.rows + ((uv_h - 1) & 1) * uv_w * 3 + j * 3;
      int32_t* dst = im.uv + ((int64_t)(uv_h - 1) * uv_w + j) * 3;
      for (int c = 0; c < 3; ++c) dst[c] = done[c];
    });
    const int64_t diff = cta.sum(part);       // orders the copy, too
    ++it;
    if (it > 1 && (diff < thr || diff > prev)) break;
    prev = diff;
  }
  return it;
}

}  // namespace sjpeg
