"""Sharp (iterative, gamma-aware) RGB -> YUV 4:2:0, as sjpeg's
src/yuv_convert.cc: RGB in SFIX=2 fixed point as gray W plus chroma
residuals; each sweep upsamples the chroma with the 9-3-3-1 filter, measures
the luma drift in linear light and feeds it back, row pair after row pair
(Gauss-Seidel: pair k sees pair k-1 already updated); at most four sweeps,
stopping after a sweep whose drift is small or grew; then nearest-chroma
reconstruction.  Runs over a stack of same-sized images at once, each
stopping on its own."""

import functools

import numpy as np

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
    a, thresh, gamma = 0.099, 0.018, 1.0 / 0.45
    g = np.arange(MAX_Y_T + 1, dtype=np.float64) / MAX_Y_T
    lin = np.where(g <= thresh * 4.5, g / 4.5, ((g + a) / (1.0 + a)) ** gamma)
    to_linear = np.floor(lin * (1 << GAMMA_TO_LINEAR_BITS) + 0.5).astype(
        np.int64)
    g = np.arange(GAMMA_TABLE_SIZE + 1, dtype=np.float64) / GAMMA_TABLE_SIZE
    gam = np.where(g <= thresh, 4.5 * g, (1.0 + a) * g ** (1.0 / gamma) - a)
    to_gamma = (np.floor(MAX_Y_T * gam).astype(np.int64)
                + (1 << GAMMA_TO_LINEAR_BITS >> 1))
    return to_linear, np.concatenate([to_gamma, to_gamma[-1:]])


def _to_linear(v):
    return _gamma_tables()[0][v]


def _to_gamma(value):
    tab = _gamma_tables()[1]
    v = value * GAMMA_TABLE_SIZE
    pos = v >> GAMMA_TO_LINEAR_BITS
    x = v - (pos << GAMMA_TO_LINEAR_BITS)
    v0 = tab[pos]
    return v0 + (((tab[pos + 1] - v0) * x) >> GAMMA_TO_LINEAR_BITS)


def _gray(r, g, b):
    return (13933 * r + 46871 * g + 4732 * b + (1 << YUV_FIX >> 1)) >> YUV_FIX


def _update_w(rgb):
    return _to_gamma(_gray(_to_linear(rgb[..., 0]), _to_linear(rgb[..., 1]),
                           _to_linear(rgb[..., 2])))


def _update_chroma(top, bottom):
    """Row(s) above and below -> the chroma residuals of their 2x2 quads."""
    def down(k):
        s = (_to_linear(top[..., ::2, k]) + _to_linear(top[..., 1::2, k])
             + _to_linear(bottom[..., ::2, k])
             + _to_linear(bottom[..., 1::2, k]) + 2) >> 2
        return _to_gamma(s)
    r, g, b = down(0), down(1), down(2)
    w = _gray(r, g, b)
    return np.stack([r - w, g - w, b - w], axis=-1)


def _upsample_row(a, b, best_y_row, w):
    """A full-resolution row from chroma rows a (own) and b (neighbour):
    the 9-3-3-1 filter, plus the row's W."""
    uv_w = a.shape[-2]
    out = np.empty(best_y_row.shape + (3,), dtype=np.int64)
    out[..., 0, :] = (a[..., 0, :] * 3 + b[..., 0, :] + 2) >> 2
    length = (w - 1) >> 1
    i = np.arange(length)
    out[..., 1:1 + 2 * length:2, :] = (
        a[..., i, :] * 9 + a[..., i + 1, :] * 3 + b[..., i, :] * 3
        + b[..., i + 1, :] + 8) >> 4
    xe = 2 * i + 2
    xe = xe[xe < w]
    ie = (xe - 2) // 2
    out[..., xe, :] = (a[..., ie + 1, :] * 9 + a[..., ie, :] * 3
                       + b[..., ie + 1, :] * 3 + b[..., ie, :] + 8) >> 4
    if w % 2 == 0:
        out[..., w - 1, :] = (a[..., uv_w - 1, :] * 3 + b[..., uv_w - 1, :]
                              + 2) >> 2
    return np.clip(best_y_row[..., None] + out, 0, MAX_Y_T)


def _clip8(v):
    return np.clip(v, 0, 255).astype(np.uint8)


def sharp_rgb_to_yuv420(rgbs: np.ndarray):
    """[N, H, W, 3] uint8 -> (y [N, H, W], u, v [N, ceil(H/2), ceil(W/2)])."""
    rgbs = np.asarray(rgbs, dtype=np.uint8)
    n, height, width = rgbs.shape[:3]
    if width <= MIN_DIMENSION or height <= MIN_DIMENSION:
        raise ValueError("sharp conversion of an image of 4 pixels or less")
    w, h = (width + 1) & ~1, (height + 1) & ~1
    src = (rgbs.astype(np.int64) << SFIX) | SHALF
    if w != width:
        src = np.concatenate([src, src[:, :, -1:]], axis=2)
    if h != height:
        src = np.concatenate([src, src[:, -1:]], axis=1)

    best_y = _gray(src[..., 0], src[..., 1], src[..., 2])
    target_y = _update_w(src)
    target_uv = _update_chroma(src[:, 0::2], src[:, 1::2])  # [N, h/2, w/2, 3]
    best_uv = target_uv.copy()
    uv_h = h // 2
    threshold = int(3.0 * w * h)
    prev_diff = np.full(n, np.iinfo(np.int64).max)
    active = np.ones(n, dtype=bool)
    for it in range(NUM_ITERATIONS):
        on = np.flatnonzero(active)
        by, buv = best_y[on], best_uv[on]
        diff_sum = np.zeros(on.size, dtype=np.int64)
        for k in range(uv_h):
            prev_row = buv[:, k - 1] if k > 0 else buv[:, 0]
            next_row = buv[:, k + 1] if k < uv_h - 1 else buv[:, k]
            cur = buv[:, k]
            est1 = _upsample_row(cur, prev_row, by[:, 2 * k], w)
            est2 = _upsample_row(cur, next_row, by[:, 2 * k + 1], w)
            new_y = _update_w(np.stack([est1, est2], axis=1))   # [m, 2, w]
            new_uv = _update_chroma(est1, est2)                 # [m, w/2, 3]
            diff_y = target_y[on, 2 * k:2 * k + 2] - new_y
            by[:, 2 * k:2 * k + 2] = np.clip(by[:, 2 * k:2 * k + 2] + diff_y,
                                             0, MAX_Y_T)
            buv[:, k] = cur + (target_uv[on, k] - new_uv)
            diff_sum += np.abs(diff_y).sum(axis=(1, 2))
        best_y[on], best_uv[on] = by, buv
        if it > 0:
            stop = (diff_sum < threshold) | (diff_sum > prev_diff[on])
            active[on[stop]] = False
        prev_diff[on] = diff_sum
        if not active.any():
            break

    uvr = np.repeat(np.repeat(best_uv, 2, axis=1), 2, axis=2)[:, :h, :w]
    r, g, b = (uvr[..., k] + best_y for k in range(3))
    y_plane = _clip8((19595 * r + 38469 * g + 7471 * b + TROUNDER)
                     >> TFIX)[:, :height, :width]
    ur, ug, ub = best_uv[..., 0], best_uv[..., 1], best_uv[..., 2]
    u_plane = _clip8(128 + ((-11058 * ur - 21709 * ug + 32768 * ub
                             + TROUNDER) >> TFIX))
    v_plane = _clip8(128 + ((32768 * ur - 27439 * ug - 5328 * ub
                             + TROUNDER) >> TFIX))
    uv_wo, uv_ho = (width + 1) >> 1, (height + 1) >> 1
    return y_plane, u_plane[:, :uv_ho, :uv_wo], v_plane[:, :uv_ho, :uv_wo]
