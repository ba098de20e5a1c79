"""Adaptive quantization: histogram-driven quant-matrix tuning, on the host.

Given per-position histograms of |DCT coefficient| >> HSHIFT, pick a per
position quantizer delta that optimizes distortion + lambda * rate, where
lambda is estimated by a Gaussian-weighted least-squares fit of the
(delta, distortion) and (delta, size) clouds around the current matrix
(reference: src/enc.cc:993-1182).  A copy of the JAX package's float64
NumPy fit, in the reference's summation order:

- the (pos, delta, bin) quantization tables depend only on the quant
  matrix, not the image, so they are LRU-cached across the images of a
  batch;
- the per-(pos, delta) bin sums are integer-valued, hence exact and
  order-independent (int64 matmul);
- the reference's *sequential* float accumulations over deltas and
  positions (whose rounding order is observable) vectorize exactly with
  np.add.accumulate, which is defined as the sequential scan.

The histograms come from the card (ops/quantize.store_histo); the fit is a
tiny per-image problem that releases the GIL, so the engine threads it
over the images of a batch.
"""

import functools

import numpy as np

from . import constants as C
from .spec import calc_log2

_FLT_MAX = float(np.finfo(np.float32).max)


@functools.lru_cache(maxsize=32)
def _delta_tables(quant_b: bytes, min_quant_b: bytes):
    """(valid [64,25], bits [64,25,128] i64, err [64,25,128] i64) for one
    quant/min_quant matrix pair — image-independent, cached."""
    quant = np.frombuffer(quant_b, dtype=np.uint8)
    min_quant = np.frombuffer(min_quant_b, dtype=np.uint8)
    bias = 1 << C.FP_BITS >> 1
    bins = np.arange(C.MAX_HISTO_DCT_COEFF, dtype=np.int64)
    v = (bins << C.HSHIFT) + C.HHALF         # [128] bin centroids

    dq = (quant.astype(np.int64)[:, None]
          + np.arange(C.QSIZE, dtype=np.int64)[None, :]
          + C.QDELTA_MIN)                                    # [64, 25]
    valid = (dq >= min_quant.astype(np.int64)[:, None]) & (dq <= 255)
    dq_safe = np.maximum(dq, 1)
    idq = ((1 << C.FP_BITS) + dq_safe - 1) // dq_safe
    qv = (v[None, None, :] * idq[:, :, None] + bias) >> C.FP_BITS
    bits = np.where(qv > 0, calc_log2(np.maximum(qv, 1)), 0)
    dqv = qv * dq_safe[:, :, None]
    err = np.where(qv > 0, (v[None, None, :] - dqv) ** 2,
                   (v * v)[None, None, :])
    return valid, bits.astype(np.int64), err


def _seq_sum(terms, axis):
    """Sum with the sequential (left-to-right) rounding order the
    reference's accumulation loops use."""
    return np.take(np.add.accumulate(terms, axis=axis), -1, axis=axis)


def analyse_histo(histo: np.ndarray, quant: np.ndarray, min_quant: np.ndarray,
                  qdelta_max: int) -> np.ndarray:
    """Return the tuned quant matrix for one channel.

    `histo`: [64, MAX_HISTO_DCT_COEFF] counts; `quant`/`min_quant`: uint8[64]
    (quant already clamped to min_quant); `qdelta_max`: max positive delta
    (12 for luma, 1 for chroma by default).
    """
    assert C.QDELTA_MAX >= qdelta_max
    delta_max = qdelta_max - C.QDELTA_MIN
    assert delta_max < C.QSIZE

    h = histo.astype(np.int64)                               # [64, 128]
    valid, bits, err = _delta_tables(
        np.ascontiguousarray(quant.astype(np.uint8)).tobytes(),
        np.ascontiguousarray(min_quant.astype(np.uint8)).tobytes())
    # integer bin sums: exact, order-free                      [64, 25]
    bsum = np.matmul(bits, h[:, :, None])[:, :, 0].astype(np.float64)
    dsum = np.matmul(err, h[:, :, None])[:, :, 0].astype(np.float64)

    # density filter
    hist_nz = h > 0
    last_all = np.where(hist_nz.any(axis=1),
                        C.MAX_HISTO_DCT_COEFF - np.argmax(hist_nz[:, ::-1],
                                                          axis=1), 0)
    total_all = h.sum(axis=1)
    omit = np.zeros(64, dtype=bool)
    omit |= (C.OMITTED_CHANNELS >> np.arange(64)) & 1 == 1
    omit |= ~omit & (total_all < C.DENSITY_THRESHOLD * last_all)

    # float32 rounding of the stored clouds
    distortions = np.full((64, C.QSIZE), np.float32(_FLT_MAX),
                          dtype=np.float32)
    sizes = np.zeros((64, C.QSIZE), dtype=np.float32)
    distortions[valid] = dsum[valid].astype(np.float32)
    sizes[valid] = bsum[valid].astype(np.float32)

    # Gaussian-weighted least-squares fit; per-delta terms match the
    # reference's expression order (w*x, (w*x)*x, (w*ds)*x, ...)
    xs = np.arange(C.QSIZE, dtype=np.float64) + C.QDELTA_MIN
    w = np.where(valid & (C.HISTO_WEIGHT > 0.0)[None, :],
                 C.HISTO_WEIGHT[None, :], 0.0)               # [64, 25]
    sw = _seq_sum(w, 1)
    sx = _seq_sum(w * xs, 1)
    sxx = _seq_sum(w * xs * xs, 1)
    sy1 = _seq_sum(w * dsum, 1)
    syy1 = _seq_sum(w * dsum * dsum, 1)
    sy2 = _seq_sum(w * bsum, 1)
    sxy1 = _seq_sum(w * dsum * xs, 1)
    sxy2 = _seq_sum(w * bsum * xs, 1)

    cov_xy1 = sw * sxy1 - sx * sy1
    poor = (cov_xy1 * cov_xy1
            < C.CORRELATION_THRESHOLD * (sw * sxx - sx * sx)
            * (sw * syy1 - sy1 * sy1))
    omit |= ~omit & poor
    num = _seq_sum(np.where(omit, 0.0, cov_xy1), 0)
    den = _seq_sum(np.where(omit, 0.0, sw * sxy2 - sx * sy2), 0)

    lam = float(C.HLAMBDA)
    if num > 1000.0 and den < -10.0:
        lam = max(-num / den, 1.0)

    # best delta per position: first strict minimum of the float32 score
    dl = distortions[:, : delta_max + 1].astype(np.float64)
    sl = sizes[:, : delta_max + 1].astype(np.float64)
    score = (dl + lam * sl).astype(np.float32)
    score = np.where(dl < _FLT_MAX, score, np.float32(np.inf))
    best = np.argmin(score, axis=1)
    has_best = score[np.arange(64), best] < np.float32(_FLT_MAX)
    best_dq = np.where(~omit & has_best, best + C.QDELTA_MIN, 0)

    new_quant = quant.astype(np.int64) + best_dq
    assert (new_quant >= 1).all()
    return new_quant.astype(np.uint8)
