"""Bias quantizer with the 16-bit reciprocal multiply (src/enc.cc:510-548),
the quantization error of the PSNR search, and the coefficient histograms
of adaptive quantization.

|c| + bias is multiplied by the reciprocal as a uint32 product (carried in
int64 and masked to 32 bits), shifted down by FP_BITS, then by AC_BITS, and
the sign restored.
"""

import torch

from .. import constants as C


def quantize_values(coeffs: torch.Tensor, iquant, bias) -> torch.Tensor:
    """Quantize int coefficients with broadcastable iquant/bias -> int64."""
    c = coeffs.to(torch.int64)
    t = (c.abs() + bias) & 0xFFFFFFFF
    q = (((t * iquant) & 0xFFFFFFFF) >> C.FP_BITS) >> C.AC_BITS
    return torch.where(c < 0, -q, q)


def quantize_error(coeffs: torch.Tensor, iquant, bias,
                   quant) -> torch.Tensor:
    """Per-block sum of squared reconstruction error in (|c| >> AC_BITS)
    units (reference src/enc.cc:851-863): [..., 64] coefficients with
    broadcastable iquant/bias/quant rows -> [...] int64.  A block's sum is
    below 64 x 2^22 and int64 holds any batch's total exactly, where the
    JAX package carries a (hi, lo) uint32 pair."""
    c = coeffs.to(torch.int64).abs()
    err = (c >> C.AC_BITS) - quant * quantize_values(c, iquant, bias)
    return (err * err).sum(dim=-1)


def store_histo(coeffs: torch.Tensor, n_images: int = 1,
                valid=None) -> torch.Tensor:
    """[N, 64] coefficients -> [64, MAX_HISTO_DCT_COEFF] int32 histogram of
    |c| >> HSHIFT per position, or [B, 64, bins] segmented per image when
    n_images > 1 (rows image-major with equal block counts).  Magnitudes
    past the last bin are dropped (the C reference semantics).  `valid`:
    optional [N] bool; blocks with False count nothing (the padding
    blocks of a ragged stripe).  An integer scatter-add is exact, so no
    matmul trick is needed."""
    nbins = C.MAX_HISTO_DCT_COEFF
    mag = coeffs.to(torch.int32).abs() >> C.HSHIFT
    per = mag.shape[0] // n_images
    dev = mag.device
    img = torch.arange(n_images, device=dev).repeat_interleave(per)
    pos = torch.arange(64, device=dev)
    idx = (img[:, None] * 64 + pos[None, :]) * nbins + mag
    dump = n_images * 64 * nbins                  # slot for dropped values
    keep = mag < nbins
    if valid is not None:
        keep = keep & valid[:, None]
    idx = torch.where(keep, idx, dump)
    hist = torch.zeros(dump + 1, dtype=torch.int32, device=dev)
    hist.scatter_add_(0, idx.reshape(-1),
                      torch.ones_like(idx, dtype=torch.int32).reshape(-1))
    hist = hist[:dump].reshape(n_images, 64, nbins)
    return hist if n_images > 1 else hist[0]
