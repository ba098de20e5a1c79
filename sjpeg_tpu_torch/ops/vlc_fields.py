"""VLC fields and symbol frequencies on the card: MCU-interleaved block
rows -> vlc_pack's zigzag run/size/code and each table's DC and AC counts,
one launch of csrc/vlc_fields.cu.

Replaces no TPU kernel (the JAX package derives them in XLA glue); the
arithmetic is csrc/fields_core.cuh's, bit-exact to the plain twin
`vlc_fields_plain`: the bias quantizer (ops/quantize), vlc.run_levels and
vlc.grouped_stats.  `vlc_fields` launches the kernel for CUDA tensors and
runs the plain twin for CPU ones; the engine's quantize stage
(`engine._stage_batch_quantize`) calls it on every device.
"""

import ctypes

import torch

from .. import kernels
from . import quantize, vlc

_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _sets(iquant) -> int:
    """[2, 64] (shared) or [B, 2, 64] (per image) -> the number of sets."""
    return 1 if iquant.dim() == 2 else iquant.shape[0]


def vlc_fields_plain(rows, dc_codes, group, iquant=None, ibias=None, *,
                     stats_images: int = 1, valid=None,
                     with_stats: bool = True):
    """The plain PyTorch version; same arguments and results as
    `vlc_fields`, whose fields dict also holds vlc.run_levels' `nz` and
    `last`."""
    if iquant is not None:              # row n uses set n // (N / B)
        n = rows.shape[0]
        tab = (torch.arange(n, device=rows.device) // (n // _sets(iquant))
               * 2 + group)
        rows = quantize.quantize_values(
            rows, iquant.reshape(-1, 64).to(torch.int64)[tab],
            ibias.reshape(-1, 64).to(torch.int64)[tab]).to(torch.int32)
    rl = vlc.run_levels(rows, torch.int32)
    if not with_stats:
        return rl, None
    return rl, vlc.grouped_stats(rl, dc_codes, group, stats_images, valid)


def _check(rows, dc_codes, group, iquant, ibias, stats_images, valid):
    n = rows.shape[0]
    tensors = [rows, dc_codes, group]
    if (iquant is None) != (ibias is None):
        raise ValueError("vlc_fields takes iquant and ibias together")
    if iquant is not None:
        tensors += [iquant, ibias]
        if (iquant.dim() not in (2, 3) or tuple(iquant.shape[-2:]) != (2, 64)
                or ibias.shape != iquant.shape or n % _sets(iquant)):
            raise ValueError("vlc_fields takes [2, 64] or [B, 2, 64] "
                             "quantizer rows, B dividing the rows")
    for t in tensors:
        if (t.dtype != torch.int32 or t.device != rows.device
                or not t.is_contiguous()):
            raise ValueError("vlc_fields takes contiguous int32 tensors on "
                             "one device")
    if (rows.dim() != 2 or rows.shape[1] != 64
            or tuple(dc_codes.shape) != (n,) or tuple(group.shape) != (n,)):
        raise ValueError("vlc_fields: shape mismatch")
    if stats_images < 1 or n % stats_images:
        raise ValueError(f"vlc_fields: {stats_images} stats images do not "
                         f"divide {n} rows")
    if valid is not None and (valid.dtype != torch.bool
                              or tuple(valid.shape) != (n,)
                              or valid.device != rows.device
                              or not valid.is_contiguous()):
        raise ValueError("vlc_fields takes a contiguous [N] bool `valid` on "
                         "the rows' device")


def vlc_fields(rows, dc_codes, group, iquant=None, ibias=None, *,
               stats_images: int = 1, valid=None, with_stats: bool = True):
    """Quantize (where given quantizer rows) + zigzag run/size/code + the
    symbol frequencies, in one launch.

    rows: [N, 64] int32 MCU-interleaved raster blocks: fDCT coefficients
    (x16) with iquant, ibias [2, 64] shared or [B, 2, 64] per image (row n
    uses set n // (N / B)), or levels (the trellis's) without them;
    dc_codes: [N] int32 DC diff codes (n | suffix << 4); group: [N] int32
    table group (0 luma, 1 chroma); stats_images: rows n // (N / S) count
    in image S's tables; valid: optional [N] bool, blocks with False count
    nothing (the padding blocks of a ragged stripe).
    Returns ({"run", "size", "code": [N, 64] int32 zigzag fields, zero at
    position 0 and at uncoded positions, each 16-byte aligned}, and with
    `with_stats` (int32 [S, 2, 12] DC, [S, 2, 256] AC counts, unbatched
    [2, 12], [2, 256] when S == 1, as vlc.grouped_stats gives them), else
    None).  Launches one kernel (and one zero fill for the counts) on the
    current stream, no wait.
    """
    if rows.device.type == "cpu":
        return vlc_fields_plain(rows, dc_codes, group, iquant, ibias,
                                stats_images=stats_images, valid=valid,
                                with_stats=with_stats)
    _check(rows, dc_codes, group, iquant, ibias, stats_images, valid)
    n, dev = rows.shape[0], rows.device
    if rows.data_ptr() % 16:
        raise ValueError("vlc_fields reads rows as int4: they must start "
                         "16-byte aligned")
    fields = torch.empty((3, n, 64), dtype=torch.int32, device=dev)
    freqs = (None, None)
    if with_stats:                     # one zero fill for both tables
        counts = torch.zeros(stats_images * 2 * (12 + 256),
                             dtype=torch.int32, device=dev)
        shape = (stats_images, 2) if stats_images > 1 else (2,)
        freqs = (counts[:stats_images * 24].view(*shape, 12),
                 counts[stats_images * 24:].view(*shape, 256))
    ptrs = [None if t is None else t.data_ptr()
            for t in (rows, dc_codes, group, iquant, ibias, valid, *fields,
                      *freqs)]
    fn = kernels.function("vlc_fields", "sjpeg_vlc_fields", _ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(*ptrs, n, 1 if iquant is None else _sets(iquant),
                stats_images, torch.cuda.current_stream().cuda_stream)
    kernels.check(rc, "vlc_fields")
    vlc_fields.launches += 1
    return ({"run": fields[0], "size": fields[1], "code": fields[2]},
            freqs if with_stats else None)


vlc_fields.launches = 0
