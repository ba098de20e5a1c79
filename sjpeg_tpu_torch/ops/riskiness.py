"""Riskiness scoring on the card: the reduction behind YUV_AUTO.

Twin of sjpeg_tpu/ops/riskiness.py.  Instead of gathering pair scores from
the 343 x 343 sharpness table, the table's generating model is evaluated
closed-form per pixel pair (riskiness.sharpness_table):

    f = (w_du * |du| + w_dv * |dv|) * (vis[y1] + vis[y2]) / 2 * mask[|dy|]

With two-decimal model constants, scaling by 100 makes every factor an
integer, so each score is the exact rational n / 2e6 rounded half to even:
the host table's value for every pair.  The largest n is
4,164 x 264 x 103 ~ 1.13e8, so int32 holds every intermediate.  The sums run
in int64, as the host scorer's do (the JAX twin sums in int32 and wraps
above 2^31).

`risk_stats` launches the one-pass CUDA kernel csrc/risk_stats.cu (over
csrc/risk_core.cuh, which holds the same levels and pair score) for CUDA
tensors, and runs `risk_stats_plain`, element-wise tensor code and three
reductions, for CPU tensors.
"""

import ctypes
import math

import numpy as np
import torch

from .. import constants as C
from .. import kernels
from ..riskiness import (KRGB, NOISE_LEVEL, THRESH_GRAY, THRESH_SHARP,
                         THRESH_YUV420, _MASK_DY, _VIS_Y, _W_DU, _W_DV)
from ..utils.profiling import span

_VIS100 = tuple(int(v) for v in np.round(_VIS_Y * 100).astype(np.int64))
_MASK100 = tuple(int(v) for v in np.round(_MASK_DY * 100).astype(np.int64))
_W_DU100 = int(round(_W_DU * 100))
_W_DV100 = int(round(_W_DV * 100))
_DEN = 2 * 100 * 100 * 100      # pair-average 2 x weight, vis, mask scales


def _risk_levels(rgb: torch.Tensor):
    """[..., 3] uint8 RGB -> (y, u, v) int32 7-quantized levels.

    Exact arithmetic of the reference row converter
    (src/colors_rgb.cc:625-667); matches riskiness.rgb_to_risk_index.  The
    channels are cast to int32 first: a uint8 tensor times a Python int
    stays uint8 in torch."""
    r, g, b = (rgb[..., c].to(torch.int32) for c in range(3))
    half = C.YUV_HALF
    y = (19595 * r + 38469 * g + 7471 * b + half) >> C.YUV_FRAC
    u = torch.clamp(128 + ((-11059 * r - 21709 * g + 32768 * b + half)
                           >> C.YUV_FRAC), 0, 255)
    v = torch.clamp(128 + ((32768 * r - 27439 * g - 5329 * b + half)
                           >> C.YUV_FRAC), 0, 255)

    def conv(x):
        return (x * (0x0101 * (KRGB - 1))) >> 16

    return conv(y), conv(u), conv(v)


def _pair_score(l0, l1) -> torch.Tensor:
    """Exact uint8 sharpness-table value (as int32) for two (y, u, v) level
    triples."""
    y0, u0, v0 = l0
    y1, u1, v1 = l1
    vis = torch.tensor(_VIS100, dtype=torch.int32, device=y0.device)
    mask = torch.tensor(_MASK100, dtype=torch.int32, device=y0.device)
    n = ((_W_DU100 * (u0 - u1).abs() + _W_DV100 * (v0 - v1).abs())
         * (vis[y0] + vis[y1]) * mask[(y0 - y1).abs()])
    return _round_score(n)


def _round_score(n: torch.Tensor) -> torch.Tensor:
    """n / 2e6 rounded half to even, clamped to 0..255 (int32 n >= 0)."""
    t = n // _DEN
    r2 = 2 * (n - t * _DEN)
    up = (r2 > _DEN) | ((r2 == _DEN) & (t % 2 == 1))
    return torch.clamp(t + up.to(torch.int32), 0, 255)


_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def risk_stats(rgb: torch.Tensor):
    """[..., H, W, 3] uint8 -> (score_sum, count, gray_count) int64
    reductions over each image (tensors of the leading batch shape).

    Per interior position the three neighbour pairs (right, down,
    diagonal) are scored; sums and counts ignore scores <= the noise
    level.  Launches the CUDA kernel for a CUDA tensor (which must be
    contiguous), and runs risk_stats_plain for a CPU one; raises on any
    other type, shape or device."""
    if rgb.dtype != torch.uint8:
        raise TypeError(f"risk_stats takes uint8 RGB, got {rgb.dtype}")
    if rgb.dim() < 3 or rgb.shape[-1] != 3:
        raise ValueError("risk_stats takes [..., H, W, 3] RGB, got shape "
                         f"{tuple(rgb.shape)}")
    if rgb.device.type == "cpu":
        return risk_stats_plain(rgb)
    if rgb.device.type != "cuda":
        raise ValueError(f"risk_stats: no kernel for {rgb.device}")
    if not rgb.is_contiguous():
        raise ValueError("risk_stats takes a contiguous CUDA tensor")
    lead = rgb.shape[:-3]
    h, w = rgb.shape[-3:-1]
    b = math.prod(lead)
    out = torch.zeros((b, 3), dtype=torch.int64, device=rgb.device)
    if b and h > 1 and w > 1:
        fn = kernels.function("risk_stats", "sjpeg_risk_stats", _ARGTYPES)
        with torch.cuda.device(rgb.device):
            rc = fn(rgb.data_ptr(), out.data_ptr(), b, h, w,
                    torch.cuda.current_stream().cuda_stream)
        kernels.check(rc, "risk_stats")
        risk_stats.launches += 1
    return tuple(out[:, i].reshape(lead) for i in range(3))


risk_stats.launches = 0


def risk_stats_plain(rgb: torch.Tensor):
    """risk_stats in plain tensor code, on any device."""
    levels = _risk_levels(rgb)
    l0 = tuple(x[..., :-1, :-1] for x in levels)
    l1 = tuple(x[..., :-1, 1:] for x in levels)
    l2 = tuple(x[..., 1:, :-1] for x in levels)
    score = _pair_score(l0, l1) + _pair_score(l0, l2) + _pair_score(l1, l2)
    mask = score > NOISE_LEVEL
    count = mask.sum(dim=(-1, -2), dtype=torch.int64)
    ssum = torch.where(mask, score, 0).sum(dim=(-1, -2), dtype=torch.int64)
    idx0 = l0[0] + KRGB * l0[1] + KRGB * KRGB * l0[2]
    gray = (KRGB // 2) * (1 + KRGB) * KRGB
    gray_count = ((idx0 - gray).abs() < KRGB).sum(dim=(-1, -2),
                                                  dtype=torch.int64)
    return ssum, count, gray_count


def finish_riskiness(ssum, count, gray_count, width: int, height: int):
    """Host epilogue: fold the three reductions into (mode, risk%), with the
    decision logic of riskiness.riskiness (reference
    src/jpeg_tools.cc:212-222)."""
    count = int(count)
    total_score = float(ssum) / count if count else 0.0
    frac = 100.0 * count / (width * height)
    if frac < 1.0:
        total_score = 0.0
    total_score = (100.0 if total_score > 25.0
                   else total_score * 100.0 / 25.0)
    if float(gray_count) / (width * height) > THRESH_GRAY:
        mode = C.YUV_400
    elif total_score < THRESH_YUV420:
        mode = C.YUV_420
    elif total_score < THRESH_SHARP:
        mode = C.YUV_SHARP
    else:
        mode = C.YUV_444
    return mode, total_score


def batch_riskiness(rgb: torch.Tensor) -> list:
    """[B, H, W, 3] uint8 on any device -> [(mode, risk%)] per image, with
    one fetch of the 3 x B reductions."""
    h, w = rgb.shape[-3:-1]
    stats = torch.stack(risk_stats(rgb), dim=-1).reshape(-1, 3)
    with span("fetch"):
        stats = stats.cpu()
    return [finish_riskiness(*row.tolist(), w, h) for row in stats]


def riskiness_device(rgb: torch.Tensor):
    """(recommended_mode, risk_percent) of one [H, W, 3] uint8 image,
    computed where the tensor lies; only three scalars come back."""
    return batch_riskiness(rgb[None])[0]
