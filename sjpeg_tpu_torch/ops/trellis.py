"""Kernel 5, trellis: rate-distortion (Viterbi) quantization of methods 7
and 8, over [N, 64] blocks with shared or per-image quantizers and rate
tables.

Replaces sjpeg_tpu/ops/pallas_trellis.py trellis_quantize_pallas (source
and design notes in csrc/trellis.cu, whose per-block search lives in
csrc/trellis_core.cuh).  `trellis_quantize` launches the CUDA kernel for
CUDA tensors and runs `trellis_quantize_plain` for CPU tensors.  The kernel
runs each block's search on one thread; `row_evaluations` counts each
block's share of the search, by which rows can be sorted to measure the
warp divergence.

The plain version is the torch twin of sjpeg_tpu/ops/trellis.py
trellis_quantize_blocks_jax: the reference's per-block node search
(src/enc.cc:692-761) as a dense 128-slot lattice over all blocks at once.
Slot k = 127 - 2i - c holds candidate c (0: the bias-quantized value, 1:
the largest value one bit shorter) of zigzag position i; slot 126 is the
sink.  Ascending k is the reference's `for cur in reversed(nodes)` order,
so a first-occurrence argmin reproduces its strict-< ties (the latest
appended node wins, the sink loses every tie).  Scores are uint32 with
wraparound, carried in int64 and masked to 32 bits after every add and
multiply.  Rows run in chunks so that the [rows, 2, 128] int64
temporaries stay near 70 MB each at 16 x 1024^2.
"""

import ctypes

import torch

from .. import constants as C
from .. import kernels
from .quantize import quantize_values

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_M32 = 0xFFFFFFFF        # uint32 mask, and KMAX: the score of no path
_SINK = 126
_CHUNK = 32768


def _bit_length(v: torch.Tensor) -> torch.Tensor:
    """Bit length of v (0 -> 0), 0 <= v < 4096."""
    n = torch.zeros_like(v)
    for k in range(12):
        n = n + (v > ((1 << k) - 1)).to(v.dtype)
    return n


def _images(start: int, stop: int, per_img: int, device) -> torch.Tensor:
    """The image of each row in [start, stop), rows image-major."""
    return torch.arange(start, stop, device=device) // per_img


def rows_from_mats(m: torch.Tensor, group: torch.Tensor,
                   img: torch.Tensor) -> torch.Tensor:
    """[2, W] shared or [B, 2, W] per-image tables (quantizer matrices,
    W = 64, or AC code lengths, W = 256), each row's [R] table group and
    [R] image -> per-row [R, W] int64 rows."""
    t = m.to(torch.int64)
    g = group.to(torch.int64)
    if t.dim() == 2:
        return t[g]
    return t.reshape(-1, t.shape[-1])[img * 2 + g]


def ac_len_table(lt_lens: torch.Tensor, group: torch.Tensor,
                 img: torch.Tensor) -> torch.Tensor:
    """[2, 256] or [B, 2, 256] AC code lengths -> [R, 16, 16] int64
    LT[n, run & 15, size] of each row's table."""
    return rows_from_mats(lt_lens, group, img).reshape(-1, 16, 16)


def _bias_quantized(V, iquant, ibias) -> torch.Tensor:
    """|c| -> ((|c| + bias) * iquant mod 2^32) >> FP_BITS >> AC_BITS."""
    return ((((V + ibias) & _M32) * iquant) & _M32) >> C.FP_BITS >> C.AC_BITS


def _lattice(coeffs, iquant, ibias, quant, lt) -> torch.Tensor:
    """[R, 64] int64 raster coefficients (x16) and quantizer rows, [R, 16,
    16] rate table -> [R, 64] int32 raster levels; the DC comes from the
    plain bias quantizer (src/enc.cc:763-766)."""
    r = coeffs.shape[0]
    dev = coeffs.device
    zz = torch.as_tensor(C.ZIGZAG, dtype=torch.int64, device=dev)
    cz = coeffs[:, zz]
    V = cz.abs()
    v0 = _bias_quantized(V, iquant[:, zz], ibias[:, zz])
    q16 = quant[:, zz] << C.AC_BITS
    lam = ((q16 * q16) & _M32) // 32
    vv = (V * V) & _M32
    vv[:, 0] = 0
    disto0 = torch.cumsum(vv, dim=1) & _M32      # wrapping prefix sums
    nb0 = _bit_length(v0)
    sign = torch.where(cz < 0, -1, 1)
    esc_len = lt[:, 15, 0]                       # sym 0xF0

    ks = torch.arange(128, device=dev)
    pos_k = torch.where(ks <= 125, (127 - ks) // 2, 0)
    D = disto0[:, pos_k]                         # [R, 128]
    S = torch.zeros((r, 128), dtype=torch.int64, device=dev)
    valid = torch.zeros((r, 128), dtype=torch.bool, device=dev)
    valid[:, _SINK] = True
    prev = torch.zeros_like(S)
    level = torch.zeros_like(S)

    # positions past every row's last nonzero value open no node
    nzp = torch.where(v0[:, 1:] > 0, torch.arange(1, 64, device=dev), 0)
    last = int(nzp.max()) if r else 0
    for i in range(1, last + 1):
        v0_i, nb0_i = v0[:, i], nb0[:, i]
        nb1 = nb0_i - 1
        v1 = (1 << nb1.clamp(min=0)) - 1
        vc = torch.stack([v0_i, v1], dim=1)      # [R, 2]
        nbc = torch.stack([nb0_i, nb1], dim=1)
        exist = torch.stack([v0_i > 0, (v0_i > 0) & (nb0_i > 1)], dim=1)
        err = V[:, i, None] - vc * q16[:, i, None]
        base = (((err * err) & _M32) + disto0[:, i - 1, None]) & _M32

        # aclen[n, c, r15] = LT[n, r15, nbc] for sizes 1..11, else 0
        aclen = torch.gather(lt, 2, nbc.clamp(0, 15)[:, None, :].expand(
            r, 16, 2)).transpose(1, 2)
        aclen = torch.where(((nbc >= 1) & (nbc <= 11))[:, :, None], aclen,
                            0)
        run = (i - 1) - pos_k                    # [128]
        bits = (torch.gather(aclen, 2, (run & 15).expand(r, 2, 128))
                + nbc[:, :, None] + (run >> 4) * esc_len[:, None, None])
        score = (base[:, :, None] - D[:, None, :]
                 + lam[:, i, None, None] * bits + S[:, None, :]) & _M32
        ok = valid[:, None, :] & (ks >= 128 - 2 * i)
        score = torch.where(ok, score, _M32)
        best = score.amin(dim=2)                 # [R, 2]
        arg = torch.where(score == best[:, :, None], ks, 128).amin(dim=2)
        newv = exist & (best < _M32)
        lvl = sign[:, i, None] * vc
        for c, k in ((0, 127 - 2 * i), (1, 126 - 2 * i)):
            S[:, k] = best[:, c]
            valid[:, k] = newv[:, c]
            prev[:, k] = arg[:, c]
            level[:, k] = lvl[:, c]

    # best end node after the tail distortion, then the backtrace
    fin = torch.where(valid, (S + disto0[:, 63:64] - D) & _M32, _M32)
    minv = fin.amin(dim=1)
    cur = torch.where(fin == minv[:, None], ks, 128).amin(dim=1)
    cur = torch.where(minv < _M32, cur, _SINK)
    rows = torch.arange(r, device=dev)
    out_z = torch.zeros((r, 64), dtype=torch.int64, device=dev)
    for _ in range(last):                        # positions strictly fall
        p = torch.where(cur >= _SINK, 0, (127 - cur) // 2)
        act = p > 0
        out_z[rows, p] = torch.where(act, level[rows, cur], 0)
        cur = torch.where(act, prev[rows, cur], cur)
    out_z[:, 0] = quantize_values(coeffs[:, 0], iquant[:, 0], ibias[:, 0])
    return out_z[:, torch.argsort(zz)].to(torch.int32)


def trellis_quantize_plain(cinter, iquant, ibias, quant, group, lt_lens,
                           n_images: int = 1) -> torch.Tensor:
    """The plain PyTorch version; same arguments and result as
    `trellis_quantize`."""
    n = cinter.shape[0]
    dev = cinter.device
    per_img = max(n // n_images, 1)
    out = torch.empty((n, 64), dtype=torch.int32, device=dev)
    for s in range(0, n, _CHUNK):
        e = min(n, s + _CHUNK)
        g, img = group[s:e], _images(s, e, per_img, dev)
        rows = [rows_from_mats(m, g, img) for m in (iquant, ibias, quant)]
        out[s:e] = _lattice(cinter[s:e].to(torch.int64), *rows,
                            ac_len_table(lt_lens, g, img))
    return out


def row_evaluations(cinter, iquant, ibias, group,
                    n_images: int = 1) -> torch.Tensor:
    """[N] int64: the (candidate, predecessor) scores the node search
    evaluates on each block: at zigzag position i each opened candidate
    searches the sink and every candidate opened before i.  Exact when
    every candidate finds a score below 0xFFFFFFFF, which is what makes it
    a node."""
    n = cinter.shape[0]
    dev = cinter.device
    zz = torch.as_tensor(C.ZIGZAG[1:], dtype=torch.int64, device=dev)
    out = torch.empty((n,), dtype=torch.int64, device=dev)
    for s in range(0, n, _CHUNK):
        e = min(n, s + _CHUNK)
        g, img = group[s:e], _images(s, e, max(n // n_images, 1), dev)
        iq, ib = (rows_from_mats(m, g, img)[:, zz] for m in (iquant, ibias))
        v0 = _bias_quantized(cinter[s:e, zz].to(torch.int64).abs(), iq, ib)
        opened = (v0 > 0).to(torch.int64) + (v0 > 1).to(torch.int64)
        before = 1 + torch.cumsum(opened, dim=1) - opened
        out[s:e] = (before * opened).sum(1)
    return out


def search_evaluations(cinter, iquant, ibias, group,
                       n_images: int = 1) -> int:
    """The scores the node search evaluates on these blocks, summed over
    `row_evaluations`.  Sets the operation count of the kernel's bound."""
    return int(row_evaluations(cinter, iquant, ibias, group, n_images).sum())


def _sets(t: torch.Tensor, tail) -> int:
    """Sets of a [*tail] shared or [S, *tail] per-image table; raises on
    another shape."""
    if tuple(t.shape) == tail:
        return 1
    if t.dim() == len(tail) + 1 and tuple(t.shape[1:]) == tail:
        return t.shape[0]
    raise ValueError(f"trellis_quantize: table shape {tuple(t.shape)}")


def trellis_quantize(cinter, iquant, ibias, quant, group, lt_lens,
                     n_images: int = 1) -> torch.Tensor:
    """Trellis-quantize MCU-interleaved blocks.

    cinter: [N, 64] int32 raster fDCT coefficients (x16); group: [N] int32
    table group (0 luma, 1 chroma); iquant, ibias, quant: [2, 64] shared
    or [B, 2, 64] per-image int32 matrices (raster; quant is the clamped
    matrix); lt_lens: [2, 256] shared or [B, 2, 256] per-image int32 AC
    code lengths, the rate model.  Rows are image-major, N / n_images
    blocks an image; row n uses set n // (N / B).  Returns [N, 64] int32
    levels in raster order, the DC from the plain bias quantizer.
    """
    if cinter.device.type == "cpu":
        return trellis_quantize_plain(cinter, iquant, ibias, quant, group,
                                      lt_lens, n_images)
    n = cinter.shape[0]
    tensors = (cinter, group, iquant, ibias, quant, lt_lens)
    for t in tensors:
        if (t.dtype != torch.int32 or t.device != cinter.device
                or not t.is_contiguous()):
            raise ValueError("trellis_quantize takes contiguous int32 "
                             "tensors on one device")
    mat_sets = _sets(iquant, (2, 64))
    lt_sets = _sets(lt_lens, (2, 256))
    if (tuple(cinter.shape) != (n, 64) or tuple(group.shape) != (n,)
            or tuple(ibias.shape) != tuple(iquant.shape)
            or tuple(quant.shape) != tuple(iquant.shape)
            or n_images < 1 or n % n_images
            or any(s not in (1, n_images) for s in (mat_sets, lt_sets))):
        raise ValueError("trellis_quantize: shape mismatch")
    out = torch.empty((n, 64), dtype=torch.int32, device=cinter.device)
    fn = kernels.function("trellis", "sjpeg_trellis", _ARGTYPES)
    with torch.cuda.device(cinter.device):
        rc = fn(*(t.data_ptr() for t in tensors), out.data_ptr(), n,
                max(n // n_images, 1), mat_sets, lt_sets,
                torch.cuda.current_stream().cuda_stream)
    kernels.check(rc, "trellis")
    trellis_quantize.launches += 1
    if lt_sets > 1:
        trellis_quantize.per_image_rate_launches += 1
    return out


trellis_quantize.launches = 0
trellis_quantize.per_image_rate_launches = 0
