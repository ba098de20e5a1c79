"""Kernel 4, merge_codesizes: the batched Huffman merge loop.

Replaces sjpeg_tpu/ops/huffman_device.py _merge_codesizes_pallas
(source and design notes in csrc/merge_codesizes.cu).  `merge_codesizes`
launches the CUDA kernel for CUDA tensors and runs
`merge_codesizes_plain`, the same step in torch looped `steps` times, for
CPU tensors.
"""

import ctypes

import torch

from .. import kernels

BIG = 0x7FFFFFFF          # an inactive slot's frequency in the argmin
MAX_WIDTH = 320           # slots a row may hold (the kernel's 10 a lane)

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def merge_codesizes_plain(freqw, active, comp, cs, nleft, steps: int):
    """The plain PyTorch version; same arguments and results as
    `merge_codesizes`."""
    W = freqw.shape[1]
    slots = torch.arange(W, dtype=torch.int32, device=freqw.device)[None, :]
    active = active.to(torch.bool)
    for _ in range(steps):
        do = (nleft > 1)[:, None]
        fm = torch.where(active, freqw, BIG)
        f1 = fm.min(dim=1, keepdim=True).values
        i2 = torch.where(active & (fm == f1), slots, W).min(
            dim=1, keepdim=True).values                     # smallest key
        not2 = slots != i2
        fm2 = torch.where(active & not2, freqw, BIG)
        f2 = fm2.min(dim=1, keepdim=True).values
        i1 = torch.where(active & not2 & (fm2 == f2), slots, W).min(
            dim=1, keepdim=True).values                     # second smallest
        freqw = torch.where(do & (slots == i1), freqw + f1, freqw)
        active = active & ~(do & (slots == i2))
        m = do & ((comp == i1) | (comp == i2))
        cs = cs + m.to(torch.int32)
        comp = torch.where(m, i1, comp)
        nleft = nleft - do[:, 0].to(torch.int32)
    return cs


def merge_codesizes(freqw, active, comp, cs, nleft, steps: int):
    """[G, W] int32 merge state (frequencies, bool active flags, component
    ids, code sizes) and [G] int32 active-node counts -> [G, W] int32 code
    sizes after `steps` merge steps.  W <= 320."""
    if freqw.device.type == "cpu":
        return merge_codesizes_plain(freqw, active, comp, cs, nleft, steps)
    G, W = freqw.shape
    if W > MAX_WIDTH:
        raise ValueError(f"merge_codesizes takes at most {MAX_WIDTH} slots, "
                         f"not {W}")
    act = active.to(torch.int32).contiguous()
    for t in (freqw, comp, cs, nleft):
        if (t.dtype != torch.int32 or t.device != freqw.device
                or not t.is_contiguous()):
            raise ValueError("merge_codesizes takes contiguous int32 "
                             "tensors on one device")
    if (tuple(comp.shape) != (G, W) or tuple(cs.shape) != (G, W)
            or tuple(act.shape) != (G, W) or tuple(nleft.shape) != (G,)):
        raise ValueError("merge_codesizes: shape mismatch")
    out = torch.empty((G, W), dtype=torch.int32, device=freqw.device)
    fn = kernels.function("merge_codesizes", "sjpeg_merge_codesizes",
                          _ARGTYPES)
    with torch.cuda.device(freqw.device):
        rc = fn(freqw.data_ptr(), act.data_ptr(), comp.data_ptr(),
                cs.data_ptr(), nleft.data_ptr(), out.data_ptr(), G, W, steps,
                torch.cuda.current_stream().cuda_stream)
    kernels.check(rc, "merge_codesizes")
    merge_codesizes.launches += 1
    return out


merge_codesizes.launches = 0
