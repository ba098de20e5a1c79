"""Sharp (iterative, gamma-aware) RGB -> YUV 4:2:0 conversion, copied for
the PyTorch port from sjpeg_tpu/sharp_yuv.py and sharp_yuv_device.py.

Minimizes the luma reconstruction error of the subsampled image: RGB is
held as W (gray) plus chroma residuals in SFIX = 2 fixed point; each
iteration upsamples the current chroma with a 9-3-3-1 half-pel filter,
measures the luma drift in linear light (gamma <-> linear through
interpolated tables), and feeds the error back into Y and chroma.
Behavioural contract: reference src/yuv_convert.cc (SFIX/TFIX precision
:32-37, gamma tables :113-153, 9-3-3-1 interpolation :513-542, linear-light
W :468-476, 2x2 gamma-correct chroma downscale :449-466, 4-iteration loop
with divergence exit :581-668, final NN-chroma reconstruction :544-576,
small-image fallback :675-696).

Batched over [B, H, W, 3] uint8 tensors.  The set-up (odd-size padding,
W, the targets) and the final reconstruction are element-wise tensor code;
the Gauss-Seidel sweep, serial over row pairs, runs through
ops/sharp_yuv.sharp_iterate: the CUDA kernel for tensors on the card, and
`sharp_iterate_plain`, a loop over row pairs vectorised across the batch
and the width, for tensors on the CPU.  Each image keeps its own iteration
count, as a vmapped while_loop does in the JAX package.  Gathers replace
the JAX package's one-hot matmuls, a TPU device.
"""

import functools

import numpy as np
import torch

SFIX = 2
SHALF = 1 << SFIX >> 1
MAX_Y_T = (256 << SFIX) - 1
YUV_FIX = 16
TFIX = YUV_FIX + SFIX
TROUNDER = 1 << TFIX >> 1
GAMMA_TABLE_SIZE = 32
GAMMA_TO_LINEAR_BITS = 14
NUM_ITERATIONS = 4
MIN_DIMENSION = 4


@functools.lru_cache(maxsize=1)
def _gamma_tables():
    """(gamma_to_linear [1024], linear_to_gamma [34]) uint32, built in
    NumPy float64 by the JAX package's code: torch's pow may differ in the
    last ulp, which floor(x + 0.5) would carry into a table."""
    a = 0.099
    thresh = 0.018
    gamma = 1.0 / 0.45
    final_scale = 1 << GAMMA_TO_LINEAR_BITS

    v = np.arange(MAX_Y_T + 1, dtype=np.float64)
    g = v / MAX_Y_T
    lin = np.where(g <= thresh * 4.5, g / 4.5,
                   ((g + a) / (1.0 + a)) ** gamma)
    gamma_to_linear = np.floor(lin * final_scale + 0.5).astype(np.uint32)

    v = np.arange(GAMMA_TABLE_SIZE + 1, dtype=np.float64)
    g = v / GAMMA_TABLE_SIZE
    gam = np.where(g <= thresh, 4.5 * g,
                   (1.0 + a) * g ** (1.0 / gamma) - a)
    lin_to_gamma = (np.floor(MAX_Y_T * gam).astype(np.uint32)
                    + (1 << GAMMA_TO_LINEAR_BITS >> 1))
    lin_to_gamma = np.concatenate([lin_to_gamma, lin_to_gamma[-1:]])
    return gamma_to_linear, lin_to_gamma


@functools.lru_cache(maxsize=None)
def gamma_tensors(device) -> tuple:
    """The two gamma tables as int32 tensors on `device` (made once a
    device)."""
    return tuple(torch.from_numpy(t.astype(np.int32)).to(device)
                 for t in _gamma_tables())


def _l2g(tabs, value: torch.Tensor) -> torch.Tensor:
    """Interpolated linear -> gamma: Q14 in [0, 16384] -> the Y_T domain."""
    v = value * GAMMA_TABLE_SIZE
    pos = v >> GAMMA_TO_LINEAR_BITS
    x = v - (pos << GAMMA_TO_LINEAR_BITS)
    v0 = tabs[1][pos]
    v1 = tabs[1][pos + 1]
    return v0 + (((v1 - v0) * x) >> GAMMA_TO_LINEAR_BITS)


def _rgb_to_gray(r, g, b):
    return (13933 * r + 46871 * g + 4732 * b + (1 << YUV_FIX >> 1)) \
        >> YUV_FIX


def _clip_y(v: torch.Tensor) -> torch.Tensor:
    return torch.clamp(v, 0, MAX_Y_T)


def _clip8(v: torch.Tensor) -> torch.Tensor:
    return torch.clamp(v, 0, 255).to(torch.uint8)


def _update_w(tabs, lin: torch.Tensor) -> torch.Tensor:
    """[..., 3] linear-light rgb -> gamma-domain gray of their mean."""
    return _l2g(tabs, _rgb_to_gray(lin[..., 0], lin[..., 1], lin[..., 2]))


def _update_chroma(tabs, lin: torch.Tensor) -> torch.Tensor:
    """[..., 2, W, 3] linear-light rgb row pairs -> [..., W/2, 3] chroma
    residuals of their gamma-correct 2x2 means."""
    s = (lin[..., 0, 0::2, :] + lin[..., 0, 1::2, :] + lin[..., 1, 0::2, :]
         + lin[..., 1, 1::2, :] + 2) >> 2
    g = _l2g(tabs, s)
    return g - _rgb_to_gray(g[..., 0], g[..., 1], g[..., 2])[..., None]


def _upsample_row(a: torch.Tensor, b: torch.Tensor,
                  y_row: torch.Tensor) -> torch.Tensor:
    """One full-resolution row of an even width from chroma rows `a` (its
    own) and `b` (its vertical neighbour), [..., uv_w, 3], through the
    9-3-3-1 half-pel filter, added to the row's W values y_row [..., w]."""
    first = (a[..., :1, :] * 3 + b[..., :1, :] + 2) >> 2          # x = 0
    last = (a[..., -1:, :] * 3 + b[..., -1:, :] + 2) >> 2         # x = w-1
    ai, ai1, bi, bi1 = a[..., :-1, :], a[..., 1:, :], b[..., :-1, :], \
        b[..., 1:, :]
    odd = (ai * 9 + ai1 * 3 + bi * 3 + bi1 + 8) >> 4             # x = 2i+1
    even = (ai1 * 9 + ai * 3 + bi1 * 3 + bi + 8) >> 4            # x = 2i+2
    inter = torch.stack([odd, even], dim=-2).flatten(-3, -2)
    return _clip_y(y_row[..., None] + torch.cat([first, inter, last], -2))


def sharp_setup(rgb: torch.Tensor):
    """[B, H, W, 3] uint8 -> (best_y [B, h, w], best_uv [B, h/2, w/2, 3],
    target_y, target_uv) int32, with h, w the sizes rounded up to even by
    edge replication."""
    b, height, width = rgb.shape[:3]
    tabs = gamma_tensors(rgb.device)
    src = (rgb.to(torch.int32) << SFIX) | SHALF
    if width % 2:
        src = torch.cat([src, src[:, :, -1:]], dim=2)
    if height % 2:
        src = torch.cat([src, src[:, -1:]], dim=1)
    h, w = src.shape[1:3]
    best_y = _rgb_to_gray(src[..., 0], src[..., 1], src[..., 2])
    lin = tabs[0][src]
    target_y = _update_w(tabs, lin)
    target_uv = _update_chroma(tabs, lin.reshape(b, h // 2, 2, w, 3))
    return best_y, target_uv.clone(), target_y, target_uv


def _sweep_plain(tabs, y, uv, ty, tuv) -> torch.Tensor:
    """One Gauss-Seidel sweep over the row pairs of y [A, h, w] and uv
    [A, h/2, w/2, 3], in place -> [A] int64 sums of |luma error|.  Row pair
    k reads row k-1's updated chroma (row 0's own for k = 0) and rows k and
    k+1 as they were (the last row reads itself)."""
    uv_h = uv.shape[1]
    diff = torch.zeros(y.shape[0], dtype=torch.int64, device=y.device)
    for k in range(uv_h):
        prev, cur = uv[:, max(k - 1, 0)], uv[:, k]
        nxt = uv[:, min(k + 1, uv_h - 1)]
        rows = slice(2 * k, 2 * k + 2)
        est = torch.stack([_upsample_row(cur, prev, y[:, 2 * k]),
                           _upsample_row(cur, nxt, y[:, 2 * k + 1])], dim=1)
        lin = tabs[0][est]                                   # [A, 2, w, 3]
        diff_y = ty[:, rows] - _update_w(tabs, lin)
        y[:, rows] = _clip_y(y[:, rows] + diff_y)
        uv[:, k] = cur + (tuv[:, k] - _update_chroma(tabs, lin))
        diff += diff_y.abs().sum(dim=(1, 2))
    return diff


def sharp_iterate_plain(y, uv, ty, tuv) -> torch.Tensor:
    """The plain version of the sweep loop: up to NUM_ITERATIONS sweeps of
    each image, in place over y [B, h, w] and uv [B, h/2, w/2, 3] int32;
    an image stops after a sweep (whose update it keeps) that is not its
    first and whose |luma error| sum is under 3 w h or above the sum of
    its previous sweep.  Returns the [B] int32 sweeps each image ran."""
    b, h, w = y.shape
    tabs = gamma_tensors(y.device)
    iters = torch.zeros(b, dtype=torch.int32, device=y.device)
    prev = torch.zeros(b, dtype=torch.int64, device=y.device)
    active = torch.arange(b, device=y.device)
    for it in range(NUM_ITERATIONS):
        ya, uva = y[active], uv[active]
        diff = _sweep_plain(tabs, ya, uva, ty[active], tuv[active])
        y[active], uv[active] = ya, uva
        iters[active] += 1
        stop = ((diff < 3 * w * h) | (diff > prev[active])) if it else \
            torch.zeros_like(diff, dtype=torch.bool)
        prev[active] = diff
        active = active[~stop]
        if active.numel() == 0:
            break
    return iters


def sharp_finish(y, uv, width: int, height: int):
    """The final reconstruction: nearest-neighbour chroma and the
    fixed-point YUV conversion -> uint8 planes (y [B, height, width], u, v
    [B, ceil(height/2), ceil(width/2)])."""
    uvr = uv.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    r, g, b = (uvr[..., c] + y for c in range(3))
    y_plane = _clip8((19595 * r + 38469 * g + 7471 * b + TROUNDER) >> TFIX)
    ur, ug, ub = uv[..., 0], uv[..., 1], uv[..., 2]
    u_plane = _clip8(128 + ((-11058 * ur - 21709 * ug + 32768 * ub
                             + TROUNDER) >> TFIX))
    v_plane = _clip8(128 + ((32768 * ur - 27439 * ug - 5328 * ub
                             + TROUNDER) >> TFIX))
    uv_ho, uv_wo = (height + 1) >> 1, (width + 1) >> 1
    return (y_plane[:, :height, :width].contiguous(),
            u_plane[:, :uv_ho, :uv_wo].contiguous(),
            v_plane[:, :uv_ho, :uv_wo].contiguous())


def simple_yuv420(rgb: torch.Tensor):
    """Small-image fallback: plain row-pair averaging, [B, H, W, 3] uint8 ->
    uint8 planes."""
    x = rgb.to(torch.int32)
    y_plane = _clip8((19595 * x[..., 0] + 38469 * x[..., 1]
                      + 7471 * x[..., 2] + (1 << YUV_FIX >> 1)) >> YUV_FIX)
    # pad to even sizes by replication
    if x.shape[2] % 2:
        x = torch.cat([x, x[:, :, -1:]], dim=2)
    if x.shape[1] % 2:
        x = torch.cat([x, x[:, -1:]], dim=1)
    b, h, w = x.shape[:3]
    q = x.reshape(b, h // 2, 2, w // 2, 2, 3).sum(dim=(2, 4))
    r, g, bl = q[..., 0], q[..., 1], q[..., 2]
    u = _clip8(128 + ((-11058 * r - 21709 * g + 32768 * bl + TROUNDER)
                      >> TFIX))
    v = _clip8(128 + ((32768 * r - 27439 * g - 5328 * bl + TROUNDER)
                      >> TFIX))
    return y_plane, u, v


def sharp_rgb_to_yuv420(rgb: torch.Tensor):
    """[B, H, W, 3] uint8 -> (y [B, H, W], u, v [B, ceil(H/2), ceil(W/2)])
    uint8 planes on rgb's device, plane-exact against the JAX package's
    sharp_rgb_to_yuv420_device.  Images of a side <= MIN_DIMENSION take
    the plain averaging conversion."""
    height, width = rgb.shape[1:3]
    if width <= MIN_DIMENSION or height <= MIN_DIMENSION:
        return simple_yuv420(rgb)
    from .ops import sharp_yuv as kernel
    y, uv, ty, tuv = sharp_setup(rgb)
    kernel.sharp_iterate(y, uv, ty, tuv)
    return sharp_finish(y, uv, width, height)
