"""Bias quantizer with the 16-bit reciprocal multiply (src/enc.cc:510-548).

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


def quantize_blocks(coeffs: torch.Tensor, iquant: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """[N, 64] coefficients -> [N, 64] int32 signed quantized values.

    `iquant`, `bias`: [64] int (uint16 ranges) from finalize_quant_matrix.
    """
    return quantize_values(coeffs, iquant.to(torch.int64)[None, :],
                           bias.to(torch.int64)[None, :]).to(torch.int32)
