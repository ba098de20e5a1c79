"""YUV_AUTO's choice of mode: sjpeg's riskiness decision (src/jpeg_tools.cc:
166-223) over sjpeg's own pair-score table (kSharpnessScore, the 7^6 bytes
of src/score_7.cc:23-24, kept beside this file as sharpness_score.npz):
pixels map to a 7x7x7 YUV index, each interior position sums the scores of
three neighbouring pairs, sums above a noise floor average into a 0..100
risk, and 0.995 gray / 40 / 70 pick 4:0:0, 4:2:0, sharp 4:2:0 or 4:4:4."""

import functools
from pathlib import Path

import numpy as np

from . import constants as C

KRGB = 7
KRGB3 = KRGB ** 3
NOISE_LEVEL = 4
THRESH_GRAY = 0.995
THRESH_YUV420 = 40.0
THRESH_SHARP = 70.0


@functools.lru_cache(maxsize=1)
def sharpness_table() -> np.ndarray:
    """[343 * 343] uint8: sjpeg's kSharpnessScore, indexed idx0 + 343 idx1."""
    table = np.load(Path(__file__).with_name("sharpness_score.npz"))["table"]
    assert table.shape == (KRGB3 * KRGB3,) and table.dtype == np.uint8
    return table


def rgb_to_risk_index(rgb: np.ndarray) -> np.ndarray:
    """[..., 3] uint8 -> the 7-level YUV index (src/colors_rgb.cc:625-667)."""
    r, g, b = (rgb[..., k].astype(np.int32) for k in range(3))
    half = C.YUV_HALF
    y = (19595 * r + 38469 * g + 7471 * b + half) >> C.YUV_FRAC
    u = np.clip(128 + ((-11059 * r - 21709 * g + 32768 * b + half)
                       >> C.YUV_FRAC), 0, 255)
    v = np.clip(128 + ((32768 * r - 27439 * g - 5329 * b + half)
                       >> C.YUV_FRAC), 0, 255)

    def conv(x):
        return (x * (0x0101 * (KRGB - 1))) >> 16

    return conv(y) + conv(u) * KRGB + conv(v) * KRGB * KRGB


def riskiness(rgb: np.ndarray):
    """(mode, risk percent) of one RGB uint8 image."""
    h, w = rgb.shape[:2]
    table = sharpness_table()
    idx = rgb_to_risk_index(rgb)
    idx0, idx1, idx2 = idx[:-1, :-1], idx[:-1, 1:], idx[1:, :-1]
    score = (table[idx0 + KRGB3 * idx1].astype(np.int64)
             + table[idx0 + KRGB3 * idx2] + table[idx1 + KRGB3 * idx2])
    mask = score > NOISE_LEVEL
    count = int(mask.sum())
    total = float(score[mask].sum()) / count if count else 0.0
    gray = (KRGB // 2) * (1 + KRGB) * KRGB
    gray_share = float((np.abs(idx0 - gray) < KRGB).sum()) / (w * h)
    if 100.0 * count / (w * h) < 1.0:
        total = 0.0
    total = 100.0 if total > 25.0 else total * 100.0 / 25.0
    if gray_share > THRESH_GRAY:
        mode = C.YUV_400
    elif total < THRESH_YUV420:
        mode = C.YUV_420
    elif total < THRESH_SHARP:
        mode = C.YUV_SHARP
    else:
        mode = C.YUV_444
    return mode, total
