"""Kernel 7, quant_pack: raster fDCT coefficients -> packed per-block
streams, with one shared set of quantizers and Huffman LUTs.

Replaces sjpeg_tpu/ops/pallas_quant_pack.py quant_vlc_pack_pallas (source
and design notes in csrc/quant_pack.cu).  `quant_pack` launches the CUDA
kernel for CUDA tensors and runs `quant_pack_plain`, the composition of the
port's quantize, vlc and pack modules, for CPU tensors.
"""

import ctypes

import torch

from .. import kernels
from . import pack, quantize, vlc

_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_void_p]
_TAILS = ((2, 64), (2, 64), (2, 16), (2, 256))


def quant_pack_plain(coeffs, dc_codes, group, iquant, ibias, dc_luts,
                     ac_luts):
    """The plain PyTorch version; same arguments and results as
    `quant_pack`.  It also takes one table set per image ([B, 2, 64],
    [B, 2, 16], [B, 2, 256]; row n uses set n // (N / B)), which
    sample_pack's plain version passes on."""
    n = coeffs.shape[0]
    tab = group.to(torch.int64)
    if iquant.dim() == 3 and iquant.shape[0] > 1:
        img = torch.arange(n, device=coeffs.device) // (n // iquant.shape[0])
        tab = img * 2 + tab
    q = quantize.quantize_values(coeffs,
                                 iquant.reshape(-1, 64).to(torch.int64)[tab],
                                 ibias.reshape(-1, 64).to(torch.int64)[tab])
    rl = vlc.run_levels(q)
    vals, lens = vlc.block_entries_grouped(
        rl, dc_codes, dc_luts.reshape(-1, 16), ac_luts.reshape(-1, 256), tab)
    words, bits = pack.pack_block_entries(vals, lens)
    return pack.to_bits32(words), bits


def quant_pack(coeffs, dc_codes, group, iquant, ibias, dc_luts, ac_luts):
    """Fused quantize + zigzag + run/level + Huffman + pack.

    coeffs: [N, 64] int32 raster-order fDCT coefficients (x16),
    MCU-interleaved; dc_codes: [N] int32 DC diff codes (n | suffix << 4)
    from the quantized DC lane; group: [N] int32 table group (0 luma, 1
    chroma); iquant, ibias: [2, 64] int32 raster quantizer rows; dc_luts
    [2, 16], ac_luts [2, 256]: packed (code << 16) | len entries as int32
    bit patterns.
    Returns ([N, 64] int32 words holding uint32 MSB-first bit patterns,
    [N] int32 bit counts).
    """
    if coeffs.device.type == "cpu":
        return quant_pack_plain(coeffs, dc_codes, group, iquant, ibias,
                                dc_luts, ac_luts)
    n = coeffs.shape[0]
    tables = (iquant, ibias, dc_luts, ac_luts)
    tensors = (coeffs, dc_codes, group) + tables
    for t in tensors:
        if (t.dtype != torch.int32 or t.device != coeffs.device
                or not t.is_contiguous()):
            raise ValueError("quant_pack takes contiguous int32 tensors on "
                             "one device")
    if (coeffs.shape != (n, 64) or dc_codes.shape != (n,)
            or group.shape != (n,)
            or tuple(tuple(t.shape) for t in tables) != _TAILS):
        raise ValueError("quant_pack: shape mismatch")
    words = torch.empty((n, 64), dtype=torch.int32, device=coeffs.device)
    bits = torch.empty((n,), dtype=torch.int32, device=coeffs.device)
    fn = kernels.function("quant_pack", "sjpeg_quant_pack", _ARGTYPES)
    with torch.cuda.device(coeffs.device):
        rc = fn(*(t.data_ptr() for t in tensors), words.data_ptr(),
                bits.data_ptr(), n, torch.cuda.current_stream().cuda_stream)
    kernels.check(rc, "quant_pack")
    quant_pack.launches += 1
    return words, bits


quant_pack.launches = 0
