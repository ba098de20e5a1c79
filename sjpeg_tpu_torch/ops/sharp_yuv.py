"""Kernel 8, sharp_yuv: the sharp RGB -> YUV 4:2:0 conversion's sweep loop.

Replaces the lax.while_loop over lax.scan sweeps of
sjpeg_tpu/sharp_yuv_device.py _sharp_core (source and design notes in
csrc/sharp_yuv.cu).  `sharp_iterate` launches the CUDA kernel for CUDA
tensors and runs sharp_yuv.sharp_iterate_plain for CPU tensors.
"""

import ctypes

import torch

from .. import kernels
from ..sharp_yuv import gamma_tensors, sharp_iterate_plain

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_PLAN_ARGTYPES = [ctypes.c_int] * 3 + [ctypes.c_void_p]
PLAN_KEYS = ("cluster", "threads", "cols", "cols_per_thread", "smem_bytes")


def plan(b: int, h: int, w: int) -> dict:
    """The kernel's launch plan for b images of h x w on the current CUDA
    device: cluster size (CTAs an image), threads a CTA, chroma columns a
    CTA, columns a thread, and the dynamic shared memory a CTA (gamma
    tables and ring slice).  Raises if the card refuses every cluster
    size the slices need."""
    out = (ctypes.c_int * len(PLAN_KEYS))()
    fn = kernels.function("sharp_yuv", "sjpeg_sharp_yuv_plan",
                          _PLAN_ARGTYPES)
    kernels.check(fn(b, w, h, ctypes.addressof(out)), "sharp_yuv plan")
    return dict(zip(PLAN_KEYS, out))


def sharp_iterate(y, uv, ty, tuv) -> torch.Tensor:
    """Up to four sweeps of each image, in place over y [B, h, w] and uv
    [B, h/2, w/2, 3] (best Y and chroma residuals) towards ty and tuv (the
    targets), all contiguous int32 with h and w even and at least 6.
    Returns the [B] int32 sweeps each image ran; nothing is read back to
    the host."""
    if y.device.type == "cpu":
        return sharp_iterate_plain(y, uv, ty, tuv)
    b, h, w = y.shape
    for t in (y, uv, ty, tuv):
        if (t.dtype != torch.int32 or t.device != y.device
                or not t.is_contiguous()):
            raise ValueError("sharp_iterate takes contiguous int32 tensors "
                             "on one device")
    if (ty.shape != y.shape or uv.shape != (b, h // 2, w // 2, 3)
            or tuv.shape != uv.shape or h % 2 or w % 2 or min(h, w) < 6):
        raise ValueError("sharp_iterate: shape mismatch")
    g2l, l2g = gamma_tensors(y.device)
    iters = torch.empty((b,), dtype=torch.int32, device=y.device)
    fn = kernels.function("sharp_yuv", "sjpeg_sharp_yuv_cluster", _ARGTYPES)
    with torch.cuda.device(y.device):
        rc = fn(y.data_ptr(), uv.data_ptr(), ty.data_ptr(), tuv.data_ptr(),
                g2l.data_ptr(), l2g.data_ptr(), iters.data_ptr(), b, w, h,
                torch.cuda.current_stream().cuda_stream)
    kernels.check(rc, "sharp_yuv")
    sharp_iterate.launches += 1
    return iters


sharp_iterate.launches = 0
