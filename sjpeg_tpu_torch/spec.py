"""Quantizer finalization, bit lengths and the YUV 4:4:4 conversion,
copied from the JAX package's NumPy oracle.

`finalize_quant_matrix` turns a [64] quantization matrix into the
reciprocal multipliers and biases the device quantizer uses (reference
src/enc.cc:327-330, 598-630); `calc_log2` is the bit length the adaptive
quantizer's fit needs; `rgb_to_yuv444` is the fixed-point conversion the
block riskiness map reads.
"""

import numpy as np

from . import constants as C


def calc_log2(v: np.ndarray) -> np.ndarray:
    """Bit length of v (v >= 1): floor(log2(v)) + 1.

    Implemented with frexp (exact for integers below 2^53): the returned
    binary exponent of v is exactly its bit length.
    """
    v = np.asarray(v)
    return np.frexp(v.astype(np.float64))[1].astype(np.int64)


def finalize_quant_matrix(quant: np.ndarray, min_quant: np.ndarray,
                          q_bias: int):
    """Derive reciprocal multipliers / biases / thresholds from a matrix.

    Returns dict with uint8[64] `quant` (clamped), uint16[64] `iquant`,
    `bias`, `qthresh`.  quant==1 uses a saturated multiplier 0xFFFF with a
    re-tuned bias 0x80, which is bit-exact over the working range.
    """
    q = np.maximum(quant.astype(np.int64), min_quant.astype(np.int64))
    is_one = q == 1
    iquant = np.where(is_one, 0xFFFF, ((1 << C.FP_BITS) + q // 2) // q)
    pos = np.arange(64)
    bias = np.where(is_one, 0x80, np.where(pos == 0, C.BIAS_DC, q_bias))
    ibias = (((bias * q) << C.AC_BITS) + 128) >> 8
    qthresh = ((1 << (C.FP_BITS + C.AC_BITS)) + iquant - 1) // iquant - ibias
    return {
        "quant": q.astype(np.uint8),
        "iquant": iquant.astype(np.uint16),
        "bias": ibias.astype(np.uint16),
        "qthresh": qthresh.astype(np.uint16),
    }


def rgb_to_yuv444(rgb: np.ndarray):
    """[H, W, 3] uint8 -> three [H, W] int32 planes, centered on 0."""
    r = rgb[..., 0].astype(np.int64)
    g = rgb[..., 1].astype(np.int64)
    b = rgb[..., 2].astype(np.int64)
    y = (19595 * r + 38469 * g + 7471 * b + C.ROUND_Y) >> C.YUV_FRAC
    u = (-11059 * r - 21709 * g + 32768 * b + C.YUV_HALF) >> C.YUV_FRAC
    v = (32768 * r - 27439 * g - 5329 * b + C.YUV_HALF) >> C.YUV_FRAC
    return (y.astype(np.int32), u.astype(np.int32), v.astype(np.int32))
