"""Kernel 1, sample_pack: centred sample blocks -> packed per-block streams,
with shared or per-image quantizers and Huffman LUTs.

Replaces sjpeg_tpu/ops/pallas_quant_pack.py sample_vlc_pack_units_pallas
and sample_vlc_pack_pallas, shared tables and per-image tables
(`tiles_per_img`; source and design notes in csrc/sample_pack.cu).
`sample_pack` launches the CUDA kernel for CUDA tensors and runs
`sample_pack_plain`, the plain fDCT followed by quant_pack's plain version,
for CPU tensors.  The kernel runs each block on one thread: its fDCT in
registers, the coefficients stored in zigzag order, then the walk over
the block's coded positions only (quant_pack's).
"""

import ctypes

import torch

from .. import kernels
from . import fdct, quant_pack

_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 8
             + [ctypes.c_int] * 3 + [ctypes.c_void_p])
_TAILS = ((2, 64), (2, 64), (2, 16), (2, 256))


def _table_sets(iquant) -> int:
    """[2, 64] (shared) or [B, 2, 64] (per image) -> the number of sets."""
    return 1 if iquant.dim() == 2 else iquant.shape[0]


def sample_pack_plain(samples, dc_codes, group, iquant, ibias, dc_luts,
                      ac_luts):
    """The plain PyTorch version; same arguments and results as
    `sample_pack`."""
    return quant_pack.quant_pack_plain(fdct.fdct_blocks_plain(samples),
                                       dc_codes, group, iquant, ibias,
                                       dc_luts, ac_luts)


def sample_pack(samples, dc_codes, group, iquant, ibias, dc_luts, ac_luts):
    """Fused fDCT + quantize + zigzag + run/level + Huffman + pack.

    samples: [N, 64] int16 or int32 raster-order centred samples,
    MCU-interleaved; dc_codes: [N] int32 DC diff codes (n | suffix << 4);
    group: [N] int32 table group (0 luma, 1 chroma); iquant, ibias: [2, 64]
    int32 raster quantizer rows, dc_luts [2, 16], ac_luts [2, 256]: packed
    (code << 16) | len entries as int32 bit patterns; or all four with a
    leading image axis B ([B, 2, 64], [B, 2, 16], [B, 2, 256]), one set per
    image, rows image-major (row n uses set n // (N / B)).
    Returns ([N, 64] int32 words holding uint32 MSB-first bit patterns,
    [N] int32 bit counts).
    """
    if samples.device.type == "cpu":
        return sample_pack_plain(samples, dc_codes, group, iquant, ibias,
                                 dc_luts, ac_luts)
    n = samples.shape[0]
    n_sets = _table_sets(iquant)
    if samples.dtype not in (torch.int16, torch.int32):
        raise TypeError(f"samples must be int16 or int32, not {samples.dtype}")
    tables = (iquant, ibias, dc_luts, ac_luts)
    for t in (samples, dc_codes, group) + tables:
        if t.device != samples.device or not t.is_contiguous():
            raise ValueError("sample_pack takes contiguous tensors on one "
                             "device")
    for t in (dc_codes, group) + tables:
        if t.dtype != torch.int32:
            raise TypeError(f"expected int32, got {t.dtype}")
    lead = () if iquant.dim() == 2 else (n_sets,)
    if (samples.shape != (n, 64) or dc_codes.shape != (n,)
            or group.shape != (n,) or n % n_sets
            or tuple(tuple(t.shape) for t in tables)
            != tuple(lead + s for s in _TAILS)):
        raise ValueError("sample_pack: shape mismatch")
    words = torch.empty((n, 64), dtype=torch.int32, device=samples.device)
    bits = torch.empty((n,), dtype=torch.int32, device=samples.device)
    fn = kernels.function("sample_pack", "sjpeg_sample_pack", _ARGTYPES)
    with torch.cuda.device(samples.device):
        rc = fn(samples.data_ptr(), samples.element_size(),
                dc_codes.data_ptr(), group.data_ptr(), iquant.data_ptr(),
                ibias.data_ptr(), dc_luts.data_ptr(), ac_luts.data_ptr(),
                words.data_ptr(), bits.data_ptr(), n, max(n // n_sets, 1),
                n_sets, torch.cuda.current_stream().cuda_stream)
    kernels.check(rc, "sample_pack")
    sample_pack.launches += 1
    if n_sets > 1:
        sample_pack.per_image_launches += 1
    return words, bits


sample_pack.launches = 0
sample_pack.per_image_launches = 0
