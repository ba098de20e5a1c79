"""Kernel 3, vlc_pack: zigzag run/size/code fields -> packed per-block
streams, with shared or per-image Huffman LUTs.

Replaces sjpeg_tpu/ops/pallas_vlc_pack.py vlc_pack_pallas (source and
design notes in csrc/vlc_pack.cu).  `vlc_pack` launches the CUDA kernel for
CUDA tensors and runs `vlc_pack_plain` (ops/vlc.block_entries_grouped over
the flattened LUT sets, then ops/pack.pack_block_entries) for CPU tensors.
"""

import ctypes

import torch

from .. import kernels
from . import pack, vlc

_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _lut_sets(dc_luts) -> int:
    """[2, 16] (shared) or [B, 2, 16] (per image) -> the number of LUT
    sets."""
    return 1 if dc_luts.dim() == 2 else dc_luts.shape[0]


def vlc_pack_plain(run, size, code, dc_codes, group, dc_luts, ac_luts):
    """The plain PyTorch version; same arguments and results as
    `vlc_pack`."""
    n = run.shape[0]
    n_sets = _lut_sets(dc_luts)
    pos = torch.arange(64, device=run.device)[None, :]
    nz = (size > 0) & (pos > 0)
    rl = {"nz": nz, "run": run, "size": size, "code": code,
          "last": torch.where(nz, pos, 0).amax(dim=1)}
    g = group
    if n_sets > 1:                       # row n uses set n // per_img
        img = torch.arange(n, device=run.device) // (n // n_sets)
        g = (img * 2 + group).to(torch.int32)
    vals, lens = vlc.block_entries_grouped(
        rl, dc_codes, dc_luts.reshape(-1, 16), ac_luts.reshape(-1, 256), g)
    words, bits = pack.pack_block_entries(vals, lens)
    return pack.to_bits32(words), bits


def vlc_pack(run, size, code, dc_codes, group, dc_luts, ac_luts):
    """Fused Huffman lookup + pack of VLC fields.

    run/size/code: [N, 64] int32 zigzag-order fields (position 0 ignored;
    size 0 marks an uncoded position; run < 64, size <= 16, code < 2^16,
    as vlc.run_levels gives them); dc_codes: [N] int32 DC diff codes
    (n | suffix << 4); group: [N] int32 table group (0 luma, 1 chroma);
    dc_luts [2, 16] / ac_luts [2, 256] shared, or [B, 2, 16] / [B, 2, 256]
    one set per image with rows image-major (row n uses set n // (N / B)):
    packed (code << 16) | len entries as int32 bit patterns.
    Returns ([N, 64] int32 words holding uint32 MSB-first bit patterns,
    [N] int32 bit counts).
    """
    if run.device.type == "cpu":
        return vlc_pack_plain(run, size, code, dc_codes, group, dc_luts,
                              ac_luts)
    n = run.shape[0]
    n_sets = _lut_sets(dc_luts)
    tensors = (run, size, code, dc_codes, group, dc_luts, ac_luts)
    for t in tensors:
        if (t.dtype != torch.int32 or t.device != run.device
                or not t.is_contiguous()):
            raise ValueError("vlc_pack takes contiguous int32 tensors on "
                             "one device")
    if any(t.data_ptr() % 16 for t in (run, size, code)):
        raise ValueError("vlc_pack reads run, size and code as int4: they "
                         "must start 16-byte aligned")
    sets = tuple(dc_luts.shape[:-1])          # (2,) or (B, 2)
    if (any(tuple(t.shape) != (n, 64) for t in (run, size, code))
            or tuple(dc_codes.shape) != (n,) or tuple(group.shape) != (n,)
            or sets[-1] != 2 or dc_luts.shape[-1] != 16
            or tuple(ac_luts.shape) != sets + (256,) or n % n_sets):
        raise ValueError("vlc_pack: shape mismatch")
    words = torch.empty((n, 64), dtype=torch.int32, device=run.device)
    bits = torch.empty((n,), dtype=torch.int32, device=run.device)
    fn = kernels.function("vlc_pack", "sjpeg_vlc_pack", _ARGTYPES)
    with torch.cuda.device(run.device):
        rc = fn(*(t.data_ptr() for t in tensors), words.data_ptr(),
                bits.data_ptr(), n, max(n // n_sets, 1), n_sets,
                torch.cuda.current_stream().cuda_stream)
    kernels.check(rc, "vlc_pack")
    vlc_pack.launches += 1
    return words, bits


vlc_pack.launches = 0
