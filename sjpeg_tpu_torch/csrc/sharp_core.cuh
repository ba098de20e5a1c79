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
// and g++ alike.  The |luma error| sum is int64.  Integer sums are exact
// in any order, so any schedule that keeps the data dependences below
// gives the same planes.
//
// Dependences.  Row pair k (chroma row k, luma rows 2k and 2k+1) reads
// chroma row k-1 as pair k-1 updated it (row 0 as it was, for k = 0), and
// rows k and k+1 as the sweep found them (the last row reads itself).
// Only the pair's upper luma row reads row k-1; its lower row, and
// everything it needs of rows k and k+1, is free of the chain.  So a
// column of pair k runs in three stages:
// - sharp_load: its chain-free inputs from the planes (chroma rows k and
//   k+1 at columns j-1..j+1, its 2 x 2 Y and target Y, target chroma);
// - sharp_lower: the lower luma row, whose Y it stores, and the parts of
//   the upper row's filter that do not involve row k-1 (SharpPre);
// - sharp_upper: the upper row from the row above, and the chroma update.
//
// The image is written once, as `sharp_image`, over a Cta policy that
// stands for one CTA of the image's cluster on the card, each CTA owning a
// contiguous range of chroma columns:
// - `columns(f)` runs f(j, state) for the policy's columns j, with that
//   column's SharpColumn (registers on the card);
// - `arrive()` / `wait()` split a barrier over the policy's own threads
//   (release / acquire); `sync()` is both;
// - `put(slot, j, v)` writes column j's updated chroma into the policy's
//   two-row ring and, for the first and last column of its range, into the
//   halo cell of the neighbouring CTA's ring; `halo(slot, j)` reads the
//   cell of column j, own or halo, a halo cell once its neighbour has
//   written it;
// - `sum(v)` adds a value over all CTAs of the image, orders every memory
//   access of the sweep before every later one, and hands every thread the
//   total.
// sharp_yuv.cu supplies the cluster policy (the halo cells filled by
// asynchronous remote stores that complete on the receiver's mbarrier, so
// no CTA waits for any but its two neighbours between sweeps); a host build
// supplies one that runs every column of every "CTA" in a scrambled CTA
// order, so the same sweep runs with g++ in the tests.
//
// Schedule of pair k (after the wait that ended pair k-1): the upper stage
// of pair k, putting chroma row k into ring slot k & 1 (not for the last
// pair, whose row no pair reads);  arrive;  pair k+1's lower stage (from
// loads made one pair earlier), the loads of pair k+2, and the stores of
// pair k-1's upper Y and chroma row k-1;  wait.
// Why it is safe:
// - A row's old values are read only by the loads of the two pairs that
//   need them (as own row and as row below), two pairs ahead, and consumed
//   by those pairs' lower stages one pair later.  Chroma row r reaches the
//   plane in pair r+1's window, after pair r+1's upper stage, which needs
//   the neighbours' row r, which they computed from their own loads of
//   row r.  So every read of a row's old value, in this CTA or a
//   neighbour's, precedes its overwrite; the host build runs each stage
//   over every column before the next, so a pair's loads run before the
//   previous pair's upper stage everywhere.
// - Ring slot k & 1 is written in pair k and read in pair k+1; a neighbour
//   writes the halo cell again in pair k+2, which needs this CTA's row
//   k+1, computed after the read, so two slots suffice.
// - The first pair of a sweep is loaded after the sum that ended the last
//   sweep, and its row above (row 0 as it was) goes to ring slot 1 before
//   one more barrier.
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
  int w, h;
};

// A column's chain-free inputs of one row pair, as loaded: chroma rows k
// (a) and k+1 (n; row k again for the last pair) at columns j-1, j, j+1
// [channel][d], Y and target Y [row][x], target chroma.
struct SharpLoad {
  int32_t a[3][3], n[3][3], y[2][2], ty[2][2], tuv[3];
};

// What the upper stage needs of a column besides the row above.
struct SharpPre {
  int32_t top[3][2];     // upper-row filter sums without row k-1's terms
  int32_t base[3];       // own chroma + target chroma
  int32_t y[2], ty[2];   // upper row's best Y (updated in place) and target
  int32_t lin[3];        // 2 + the lower row's linear-light values
  int32_t diff;          // the lower row's |luma error|
};

// A column's state across stages: the loads of the pair after next, the
// next pair's SharpPre, its latest updated chroma (the row above's own
// column for the next pair), and the previous pair's upper Y and chroma,
// stored a pair late.
struct SharpColumn {
  SharpLoad in;
  SharpPre pre;
  int32_t cur[3];
  int32_t done_uv[3], done_y[2];
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

// The filter sum of one pixel without its vertical neighbour's terms: a is
// the pixel's own chroma row at columns j-1, j, j+1; x = 0 is the left
// pixel 2j, x = 1 the right one 2j+1; `edge` says the image ends on that
// side.  sharp_up_from adds the neighbour row b and rounds.
SJ_HD int32_t sharp_up_own(const int32_t a[3], int x, bool edge) {
  return edge ? a[1] * 3 + 2 : a[1] * 9 + a[2 * x] * 3 + 8;
}

SJ_HD int32_t sharp_up_from(int32_t own, const int32_t b[3], int x,
                            bool edge) {
  return edge ? (own + b[1]) >> 2 : (own + b[1] * 3 + b[2 * x]) >> 4;
}

// Loads column j of row pair k (see SharpLoad).  Columns beyond the image
// read its edge column; their values are never used.
SJ_HD void sharp_load(const SharpImage& im, int k, int j, SharpLoad& in) {
  const int uv_w = im.w >> 1, uv_h = im.h >> 1;
  const int32_t* own = im.uv + (int64_t)k * uv_w * 3;
  const int32_t* below = k + 1 < uv_h ? own + uv_w * 3 : own;
  for (int d = 0; d < 3; ++d) {
    int col = j - 1 + d;
    col = col < 0 ? 0 : (col >= uv_w ? uv_w - 1 : col);
    for (int c = 0; c < 3; ++c) {
      in.a[c][d] = own[col * 3 + c];
      in.n[c][d] = below[col * 3 + c];
    }
  }
  const int64_t at = (int64_t)2 * k * im.w + 2 * j;
  for (int r = 0; r < 2; ++r)
    for (int x = 0; x < 2; ++x) {
      in.y[r][x] = im.y[at + r * im.w + x];
      in.ty[r][x] = im.ty[at + r * im.w + x];
    }
  const int32_t* tuv = im.tuv + ((int64_t)k * uv_w + j) * 3;
  for (int c = 0; c < 3; ++c) in.tuv[c] = tuv[c];
}

// Column j of pair k: the lower luma row (its Y stored) and SharpPre.
SJ_HD void sharp_lower(const SharpTables& t, const SharpImage& im, int k,
                       int j, const SharpLoad& in, SharpPre& pre) {
  const bool edge[2] = {j == 0, j == (im.w >> 1) - 1};
  int32_t* y = im.y + (int64_t)(2 * k + 1) * im.w + 2 * j;
  pre.diff = 0;
  for (int c = 0; c < 3; ++c) pre.lin[c] = 2;
  for (int x = 0; x < 2; ++x) {
    int32_t lin[3];
    for (int c = 0; c < 3; ++c) {
      const int32_t up = sharp_up_from(sharp_up_own(in.a[c], x, edge[x]),
                                       in.n[c], x, edge[x]);
      lin[c] = t.g2l[sharp_clip_y(in.y[1][x] + up)];
      pre.lin[c] += lin[c];
    }
    const int32_t d =
        in.ty[1][x] - sharp_l2g(t.l2g, sharp_gray(lin[0], lin[1], lin[2]));
    y[x] = sharp_clip_y(in.y[1][x] + d);
    pre.diff += d < 0 ? -d : d;
  }
  for (int c = 0; c < 3; ++c) {
    for (int x = 0; x < 2; ++x)
      pre.top[c][x] = sharp_up_own(in.a[c], x, edge[x]);
    pre.base[c] = in.a[c][1] + in.tuv[c];
  }
  for (int x = 0; x < 2; ++x) {
    pre.y[x] = in.y[0][x];
    pre.ty[x] = in.ty[0][x];
  }
}

// Column j's upper luma row from the row above p [channel][column j-1+d]
// and the chroma update into uv_out; the row's new Y stays in pre.y.
// Returns the column's |luma error| over its four pixels.
SJ_HD int32_t sharp_upper(const SharpTables& t, int j, int uv_w,
                          SharpPre& pre, const int32_t p[3][3],
                          int32_t uv_out[3]) {
  const bool edge[2] = {j == 0, j == uv_w - 1};
  int32_t sum[3] = {pre.lin[0], pre.lin[1], pre.lin[2]};
  int32_t diff = pre.diff;
  for (int x = 0; x < 2; ++x) {
    int32_t lin[3];
    for (int c = 0; c < 3; ++c) {
      const int32_t up = sharp_up_from(pre.top[c][x], p[c], x, edge[x]);
      lin[c] = t.g2l[sharp_clip_y(pre.y[x] + up)];
      sum[c] += lin[c];
    }
    const int32_t d =
        pre.ty[x] - sharp_l2g(t.l2g, sharp_gray(lin[0], lin[1], lin[2]));
    pre.y[x] = sharp_clip_y(pre.y[x] + d);
    diff += d < 0 ? -d : d;
  }
  int32_t g[3];
  for (int c = 0; c < 3; ++c) g[c] = sharp_l2g(t.l2g, sum[c] >> 2);
  const int32_t w = sharp_gray(g[0], g[1], g[2]);
  for (int c = 0; c < 3; ++c) uv_out[c] = pre.base[c] - (g[c] - w);
  return diff;
}

// Stores column j's upper Y of pair k and its chroma of row k.
SJ_HD void sharp_store(const SharpImage& im, int k, int j, const int32_t y[2],
                       const int32_t uv[3]) {
  int32_t* dy = im.y + (int64_t)2 * k * im.w + 2 * j;
  dy[0] = y[0];
  dy[1] = y[1];
  int32_t* duv = im.uv + ((int64_t)k * (im.w >> 1) + j) * 3;
  for (int c = 0; c < 3; ++c) duv[c] = uv[c];
}

// Up to kSharpIterations sweeps of one image; returns the sweeps it ran.
// An image stops after a sweep (whose update it keeps) that is not its
// first and whose |luma error| sum is under 3 w h or above the previous
// sweep's.  The schedule is the one described at the top.
template <class Cta>
SJ_SHARP_FN int sharp_image(Cta& cta, const SharpTables& t,
                            const SharpImage& im) {
  const int uv_w = im.w >> 1, uv_h = im.h >> 1;
  const int64_t thr = 3 * (int64_t)im.w * im.h;
  int64_t prev = 0;
  int it = 0;
  while (it < kSharpIterations) {
    int64_t part = 0;
    cta.columns([&](int j, SharpColumn& s) {      // pair 0; row "-1"
      sharp_load(im, 0, j, s.in);
      sharp_lower(t, im, 0, j, s.in, s.pre);
      for (int c = 0; c < 3; ++c) s.cur[c] = s.in.a[c][1];
      cta.put(1, j, s.cur);
      if (uv_h > 1) sharp_load(im, 1, j, s.in);
    });
    cta.sync();
    for (int k = 0; k < uv_h; ++k) {
      const bool more = k + 1 < uv_h;
      const int above = (k + 1) & 1;
      cta.columns([&](int j, SharpColumn& s) {
        int32_t p[3][3];                  // an edge reads its own cell
        const int32_t* left = cta.halo(above, j > 0 ? j - 1 : j);
        const int32_t* right = cta.halo(above, j + 1 < uv_w ? j + 1 : j);
        for (int c = 0; c < 3; ++c) {
          p[c][0] = left[c];
          p[c][1] = s.cur[c];
          p[c][2] = right[c];
        }
        part += sharp_upper(t, j, uv_w, s.pre, p, s.cur);
        if (more) cta.put(k & 1, j, s.cur);
      });
      cta.arrive();
      cta.columns([&](int j, SharpColumn& s) {
        const int32_t uv_k[3] = {s.cur[0], s.cur[1], s.cur[2]};
        const int32_t y_k[2] = {s.pre.y[0], s.pre.y[1]};
        if (more) sharp_lower(t, im, k + 1, j, s.in, s.pre);
        if (k + 2 < uv_h) sharp_load(im, k + 2, j, s.in);
        if (k) sharp_store(im, k - 1, j, s.done_y, s.done_uv);
        for (int c = 0; c < 3; ++c) s.done_uv[c] = uv_k[c];
        s.done_y[0] = y_k[0];
        s.done_y[1] = y_k[1];
      });
      cta.wait();
    }
    cta.columns([&](int j, SharpColumn& s) {      // the last pair's
      sharp_store(im, uv_h - 1, j, s.done_y, s.done_uv);
    });
    const int64_t diff = cta.sum(part);
    ++it;
    if (it > 1 && (diff < thr || diff > prev)) break;
    prev = diff;
  }
  return it;
}

}  // namespace sjpeg
