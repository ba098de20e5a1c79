"""sjpeg's adaptive quantization (src/enc.cc:993-1182): from an image's
histograms of |coefficient| >> 2, a Gaussian-weighted least-squares fit of
distortion and size against the quantizer delta gives lambda, and each
position takes the delta of least distortion + lambda * size.  The clouds
are stored in float32 and the fit runs in float64, with the reference's
sequential order of summation (np.add.accumulate is that scan)."""

import functools

import numpy as np

from . import constants as C
from .spec import bit_length

_FLT_MAX = float(np.finfo(np.float32).max)


@functools.lru_cache(maxsize=16)
def _delta_tables(quant_b: bytes, min_quant_b: bytes):
    """(valid [64, 25], bits [64, 25, 128], err [64, 25, 128]) of one
    matrix pair."""
    quant = np.frombuffer(quant_b, dtype=np.uint8)
    min_quant = np.frombuffer(min_quant_b, dtype=np.uint8)
    bias = 1 << C.FP_BITS >> 1
    v = (np.arange(C.MAX_HISTO_DCT_COEFF, dtype=np.int64) << C.HSHIFT) \
        + C.HHALF
    dq = (quant.astype(np.int64)[:, None]
          + np.arange(C.QSIZE, dtype=np.int64)[None, :] + C.QDELTA_MIN)
    valid = (dq >= min_quant.astype(np.int64)[:, None]) & (dq <= 255)
    dq_safe = np.maximum(dq, 1)
    idq = ((1 << C.FP_BITS) + dq_safe - 1) // dq_safe
    qv = (v[None, None, :] * idq[:, :, None] + bias) >> C.FP_BITS
    bits = np.where(qv > 0, bit_length(np.maximum(qv, 1)), 0)
    err = np.where(qv > 0, (v[None, None, :] - qv * dq_safe[:, :, None]) ** 2,
                   (v * v)[None, None, :])
    return valid, bits.astype(np.int64), err


def _seq_sum(terms, axis):
    return np.take(np.add.accumulate(terms, axis=axis), -1, axis=axis)


def analyse_histo(histo, quant, min_quant, qdelta_max: int) -> np.ndarray:
    """The tuned uint8[64] matrix of one table group."""
    delta_max = qdelta_max - C.QDELTA_MIN
    h = histo.astype(np.int64)
    valid, bits, err = _delta_tables(
        np.ascontiguousarray(quant.astype(np.uint8)).tobytes(),
        np.ascontiguousarray(min_quant.astype(np.uint8)).tobytes())
    bsum = np.matmul(bits, h[:, :, None])[:, :, 0].astype(np.float64)
    dsum = np.matmul(err, h[:, :, None])[:, :, 0].astype(np.float64)

    hist_nz = h > 0
    last_all = np.where(hist_nz.any(axis=1),
                        C.MAX_HISTO_DCT_COEFF
                        - np.argmax(hist_nz[:, ::-1], axis=1), 0)
    omit = (C.OMITTED_CHANNELS >> np.arange(64)) & 1 == 1
    omit |= ~omit & (h.sum(axis=1) < C.DENSITY_THRESHOLD * last_all)

    distortions = np.full((64, C.QSIZE), np.float32(_FLT_MAX),
                          dtype=np.float32)
    sizes = np.zeros((64, C.QSIZE), dtype=np.float32)
    distortions[valid] = dsum[valid].astype(np.float32)
    sizes[valid] = bsum[valid].astype(np.float32)

    xs = (np.arange(C.QSIZE) + C.QDELTA_MIN).astype(np.float64)
    w = np.where(valid & (C.HISTO_WEIGHT > 0.0)[None, :],
                 C.HISTO_WEIGHT[None, :], 0.0).astype(np.float64)
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
        lam = max(float(-num / den), 1.0)

    dl = distortions[:, :delta_max + 1].astype(np.float64)
    sl = sizes[:, :delta_max + 1].astype(np.float64)
    score = (dl + lam * sl).astype(np.float32)
    score = np.where(dl < _FLT_MAX, score, np.float32(np.inf))
    best = np.argmin(score, axis=1)
    has_best = score[np.arange(64), best] < np.float32(_FLT_MAX)
    best_dq = np.where(~omit & has_best, best + C.QDELTA_MIN, 0)
    return (quant.astype(np.int64) + best_dq).astype(np.uint8)
