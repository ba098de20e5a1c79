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

`analyse_histo_nodes` is the search's form: one fit for every (image,
candidate matrix) pair of a bisection tree, bit-identical to
`analyse_histo` per pair: the threaded C++ fit (native.analyse_histo_nodes)
by default, its float64 torch twin with SJPEG_ADAPTIVE_IMPL=torch (the JAX
package's switch; the port has no NumPy node twin, so any other value runs
the C++ fit).
"""

import functools
import os

import numpy as np
import torch

from . import constants as C
from . import native
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


@functools.lru_cache(maxsize=1)
def _dq_tables():
    """(bits [256, 128] f64, err [256, 128] f64) over (quantizer value dq,
    histogram bin): `_delta_tables`' entries depend on position and delta
    only through dq = quant[pos] + delta, so one table over every dq turns
    the per-node bin sums into one matmul and a gather.  The values are
    integers below 2^53, so the sums are exact in float64.  Row dq = 0 is
    never read (a valid dq is >= min_quant >= 1)."""
    bias = 1 << C.FP_BITS >> 1
    bins = np.arange(C.MAX_HISTO_DCT_COEFF, dtype=np.int64)
    v = (bins << C.HSHIFT) + C.HHALF                       # [128]
    dq = np.maximum(np.arange(256, dtype=np.int64), 1)     # [256]
    idq = ((1 << C.FP_BITS) + dq - 1) // dq
    qv = (v[None, :] * idq[:, None] + bias) >> C.FP_BITS   # [256, 128]
    bits = np.where(qv > 0, calc_log2(np.maximum(qv, 1)), 0)
    dqv = qv * dq[:, None]
    err = np.where(qv > 0, (v[None, :] - dqv) ** 2, (v * v)[None, :])
    return bits.astype(np.float64), err.astype(np.float64)


def analyse_histo_nodes(histos: np.ndarray, quants: np.ndarray,
                        min_quant: np.ndarray, qdelta_max: int) -> np.ndarray:
    """[B, 64, bins] histograms x [K, 64] candidate matrices (uint8,
    already clamped to min_quant) -> [B, K, 64] uint8 tuned matrices, each
    bit-identical to analyse_histo(histos[i], quants[k], min_quant,
    qdelta_max).  Duplicate candidates (deep trees converge on equal
    matrices) are fitted once."""
    K = quants.shape[0]
    if K > 2:
        uq, inv = np.unique(quants, axis=0, return_inverse=True)
        if uq.shape[0] < K:
            r = analyse_histo_nodes(histos, uq, min_quant, qdelta_max)
            return np.ascontiguousarray(r[:, inv.reshape(-1)])
    if os.environ.get("SJPEG_ADAPTIVE_IMPL", "").strip().lower() == "torch":
        return _analyse_histo_nodes_torch(histos, quants, min_quant,
                                          qdelta_max)
    return native.analyse_histo_nodes(histos, quants, min_quant, qdelta_max,
                                      C.HISTO_WEIGHT)


def _analyse_histo_nodes_torch(histos, quants, min_quant,
                               qdelta_max: int) -> np.ndarray:
    """The fit over every (image, node) pair in float64 torch on the host.
    Bit-identical to `analyse_histo`: the bin-sum matmuls give exact
    integers in float64 in any summation order, the sequential sums are
    explicit left-to-right loops, and every elementwise float64/float32
    operation is IEEE-defined."""
    delta_max = qdelta_max - C.QDELTA_MIN
    B = histos.shape[0]
    K = quants.shape[0]

    h = histos.astype(np.int64)
    q64 = quants.astype(np.int64)
    dq = (q64[:, :, None]
          + np.arange(C.QSIZE, dtype=np.int64)[None, None, :]
          + C.QDELTA_MIN)                                  # [K, 64, 25]
    valid = (dq >= min_quant.astype(np.int64)[None, :, None]) & (dq <= 255)
    dqi = np.clip(dq, 1, 255)

    bits_t, err_t = _dq_tables()
    ht = torch.from_numpy(
        np.ascontiguousarray(h.astype(np.float64).reshape(B * 64, -1)))
    hb = (ht @ torch.from_numpy(np.ascontiguousarray(bits_t.T))) \
        .reshape(B, 1, 64, 256).expand(B, K, 64, 256)
    hd = (ht @ torch.from_numpy(np.ascontiguousarray(err_t.T))) \
        .reshape(B, 1, 64, 256).expand(B, K, 64, 256)
    idxt = torch.from_numpy(dqi)[None].expand(B, K, 64, C.QSIZE)
    bsum = torch.gather(hb, 3, idxt)                       # [B, K, 64, 25]
    dsum = torch.gather(hd, 3, idxt)

    # density filter: a property of the image alone
    hist_nz = h > 0
    last_all = np.where(hist_nz.any(axis=2),
                        C.MAX_HISTO_DCT_COEFF
                        - np.argmax(hist_nz[:, :, ::-1], axis=2), 0)
    total_all = h.sum(axis=2)
    omit0 = ((C.OMITTED_CHANNELS >> np.arange(64)) & 1 == 1)[None, :]
    omit_img = omit0 | (~omit0
                        & (total_all < C.DENSITY_THRESHOLD * last_all))
    omit_t = torch.from_numpy(omit_img)[:, None, :].expand(B, K, 64)

    # float32 clouds
    validt = torch.from_numpy(valid)[None]                 # [1, K, 64, 25]
    fmax32 = torch.tensor(np.float32(_FLT_MAX))
    dist32 = torch.where(validt, dsum.to(torch.float32), fmax32)
    size32 = torch.where(validt, bsum.to(torch.float32),
                         torch.tensor(np.float32(0.0)))

    xs = np.arange(C.QSIZE, dtype=np.float64) + C.QDELTA_MIN
    w = np.where(valid & (C.HISTO_WEIGHT > 0.0)[None, None, :],
                 C.HISTO_WEIGHT[None, None, :], 0.0)       # [K, 64, 25]
    sw = torch.from_numpy(_seq_sum(w, 2))[None]            # [1, K, 64]
    sx = torch.from_numpy(_seq_sum(w * xs, 2))[None]
    sxx = torch.from_numpy(_seq_sum(w * xs * xs, 2))[None]
    wt = torch.from_numpy(w)

    sy1 = syy1 = sy2 = sxy1 = sxy2 = None
    for d in range(C.QSIZE):                # exact sequential order
        wd = wt[:, :, d]                                   # [K, 64]
        dd = dsum[:, :, :, d]                              # [B, K, 64]
        bd = bsum[:, :, :, d]
        t1 = wd * dd
        t2 = wd * bd
        x = float(xs[d])
        if d == 0:
            sy1, syy1, sy2 = t1, t1 * dd, t2
            sxy1, sxy2 = t1 * x, t2 * x
        else:
            sy1 = sy1 + t1
            syy1 = syy1 + t1 * dd
            sy2 = sy2 + t2
            sxy1 = sxy1 + t1 * x
            sxy2 = sxy2 + t2 * x

    cov_xy1 = sw * sxy1 - sx * sy1
    poor = (cov_xy1 * cov_xy1
            < C.CORRELATION_THRESHOLD * (sw * sxx - sx * sx)
            * (sw * syy1 - sy1 * sy1))
    omit = omit_t | poor                                   # [B, K, 64]
    den_t = sw * sxy2 - sx * sy2
    zero = torch.tensor(0.0, dtype=torch.float64)
    num = den = None
    for p in range(64):                     # exact sequential order
        tn = torch.where(omit[:, :, p], zero, cov_xy1[:, :, p])
        td = torch.where(omit[:, :, p], zero, den_t[:, :, p])
        num = tn if p == 0 else num + tn
        den = td if p == 0 else den + td

    lam = torch.full((B, K), float(C.HLAMBDA), dtype=torch.float64)
    fit = (num > 1000.0) & (den < -10.0)
    lam = torch.where(fit, torch.clamp(-num / den, min=1.0), lam)

    # first strict minimum of the float32 score over deltas <= delta_max
    inf32 = torch.tensor(np.float32(np.inf))
    cur = None
    best = torch.zeros((B, K, 64), dtype=torch.int64)
    lam3 = lam[:, :, None]
    for d in range(delta_max + 1):
        dl_d = dist32[:, :, :, d].to(torch.float64)
        sl_d = size32[:, :, :, d].to(torch.float64)
        sc = (dl_d + lam3 * sl_d).to(torch.float32)
        sc = torch.where(dl_d < _FLT_MAX, sc, inf32)
        if d == 0:
            cur = sc
        else:
            better = sc < cur
            best = torch.where(better, torch.tensor(d, dtype=torch.int64),
                               best)
            cur = torch.where(better, sc, cur)
    has_best = cur < fmax32
    best_dq = torch.where(~omit & has_best, best + C.QDELTA_MIN,
                          torch.tensor(0, dtype=torch.int64))

    new_quant = q64[None] + best_dq.numpy()
    assert (new_quant >= 1).all()
    return new_quant.astype(np.uint8)
