"""Kernel 6, fdct: the 8x8 forward DCT on tensors, integer-exact, output
scaled x16.

Replaces sjpeg_tpu/ops/pallas_fdct.py fdct_blocks_pallas (source and design
notes in csrc/fdct.cu).  `fdct_blocks` launches the CUDA kernel for CUDA
tensors and runs `fdct_blocks_plain` for CPU tensors; every plain version of
the port calls `fdct_blocks_plain`.  `fdct_dc`, the DC lane alone, stays
tensor code, as it is XLA in the JAX package.

The plain version is the reference's fixed-point butterfly network (column pass,
src/fdct.cc:67-144) and cosine-table row pass (src/fdct.cc:174-209) with
the same shift order and LSB correction.  The reference computes in int32
and wraps; here every value is carried in int64 as its residue mod 2^32,
and `_wrap32` restores the int32 value just before each arithmetic right
shift, the only operation whose result depends on more than the residue.
int16 stores are emulated by sign extension.
"""

import ctypes

import torch

from .. import constants as C
from .. import kernels

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p]


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """The int32 value of an int64 residue mod 2^32."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _mult(a: torch.Tensor, k: int) -> torch.Tensor:
    """Q15-ish fixed multiply: (a * k) >> 16 in int32."""
    return _wrap32(a * k) >> 16


def _butterfly(a, b):
    """{a, b} <- {a - b, a + b}."""
    return a - b, a + b


def _sext16(x: torch.Tensor) -> torch.Tensor:
    """Emulate an int16 store and reload (sign extension)."""
    return ((x & 0xFFFF) ^ 0x8000) - 0x8000


def fdct_blocks_plain(blocks: torch.Tensor) -> torch.Tensor:
    """[N, 64] centred samples -> [N, 64] int32 coefficients (x16)."""
    x = blocks.reshape(-1, 8, 8).to(torch.int64)

    # ---- column pass: along the row axis, vectorised over (N, column) ----
    m0, m1, m2, m3 = x[:, 0], x[:, 1], x[:, 2], x[:, 3]
    m4, m5, m6, m7 = x[:, 4], x[:, 5], x[:, 6], x[:, 7]

    m0, m7 = _butterfly(m0, m7)
    m2, m5 = _butterfly(m2, m5)
    m3, m4 = _butterfly(m3, m4)
    m1, m6 = _butterfly(m1, m6)
    m7, m4 = _butterfly(m7, m4)
    m6, m5 = _butterfly(m6, m5)

    m4, m5 = _butterfly(m4 << 3, m5 << 3)
    col0, col4 = m5, m4

    m7, m6, m3, m0 = m7 << 3, m6 << 3, m3 << 3, m0 << 3

    col6 = _mult(m7, C.FDCT_K_TAN2) - m6
    col2 = _mult(m6, C.FDCT_K_TAN2) + m7

    m1, m2 = _butterfly(m1 << 4, m2 << 4)
    m2 = _mult(m2, C.FDCT_K_2SQRT2)
    m1 = _mult(m1, C.FDCT_K_2SQRT2)
    m3, m1 = _butterfly(m3, m1)
    m0, m2 = _butterfly(m0, m2)

    t7, t6 = m3, m1
    m3 = _mult(m3, C.FDCT_K_TAN3M1) + t7 + 1      # + CORRECT_LSB
    m1 = _mult(m1, C.FDCT_K_TAN1) + m2 + 1
    t4b = _mult(m0, C.FDCT_K_TAN3M1) + m0
    t5b = _mult(m2, C.FDCT_K_TAN1)

    cols = torch.stack([col0, m1, col2, m0 - m3, col4, t7 + t4b, col6,
                        t5b - t6], dim=1)
    r = _sext16(cols)       # [N, 8 (row), 8 (column)] after the int16 store

    # ---- row pass ----
    a0, b0 = r[:, :, 0] + r[:, :, 7], r[:, :, 0] - r[:, :, 7]
    a1, b1 = r[:, :, 1] + r[:, :, 6], r[:, :, 1] - r[:, :, 6]
    a2, b2 = r[:, :, 2] + r[:, :, 5], r[:, :, 2] - r[:, :, 5]
    a3, b3 = r[:, :, 3] + r[:, :, 4], r[:, :, 3] - r[:, :, 4]

    tab = torch.as_tensor(C.FDCT_ROW_TABLES, dtype=torch.int64,
                          device=x.device)                     # [8, 7]
    C1, C2, C3, C4, C5, C6, C7 = (tab[None, :, k] for k in range(7))

    c0, c1 = a0 + a3, a0 - a3
    c2, c3 = a1 + a2, a1 - a2

    def shr16(v):
        return _wrap32(v) >> 16

    out = torch.stack([
        shr16(C4 * (c0 + c2)),
        shr16(C1 * b0 + C3 * b1 + C5 * b2 + C7 * b3),
        shr16(C2 * c1 + C6 * c3),
        shr16(C3 * b0 - C7 * b1 - C1 * b2 - C5 * b3),
        shr16(C4 * (c0 - c2)),
        shr16(C5 * b0 - C1 * b1 + C7 * b2 + C3 * b3),
        shr16(C6 * c1 - C2 * c3),
        shr16(C7 * b0 - C5 * b1 + C3 * b2 - C1 * b3),
    ], dim=2)
    return _sext16(out).reshape(-1, 64).to(torch.int32)


def fdct_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """[N, 64] centred samples -> [N, 64] int32 coefficients (x16).  On the
    card `blocks` is a contiguous int16 or int32 tensor."""
    if blocks.device.type == "cpu":
        return fdct_blocks_plain(blocks)
    n = blocks.shape[0]
    if blocks.dtype not in (torch.int16, torch.int32):
        raise TypeError(f"blocks must be int16 or int32, not {blocks.dtype}")
    if blocks.shape != (n, 64) or not blocks.is_contiguous():
        raise ValueError("fdct_blocks takes a contiguous [N, 64] tensor")
    coeffs = torch.empty((n, 64), dtype=torch.int32, device=blocks.device)
    fn = kernels.function("fdct", "sjpeg_fdct", _ARGTYPES)
    with torch.cuda.device(blocks.device):
        rc = fn(blocks.data_ptr(), blocks.element_size(), coeffs.data_ptr(),
                n, torch.cuda.current_stream().cuda_stream)
    kernels.check(rc, "fdct")
    fdct_blocks.launches += 1
    return coeffs


fdct_blocks.launches = 0


def fdct_dc(blocks: torch.Tensor) -> torch.Tensor:
    """Exact DC lane of the fDCT, [N, 64] -> [N] int32, through the
    collapsed butterfly chain: col0(c) = (sum_r x[r, c]) << 3, then
    dc = sext16((C4_row0 * sum_c sext16(col0(c))) >> 16)."""
    x = blocks.reshape(-1, 8, 8).to(torch.int64)
    col0 = _sext16(x.sum(dim=1) << 3)                       # [N, 8]
    c4 = int(C.FDCT_ROW_TABLES[0][3])
    return _sext16(_wrap32(c4 * col0.sum(dim=1)) >> 16).to(torch.int32)
