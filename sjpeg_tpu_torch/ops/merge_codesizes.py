"""Kernel 4, merge_codesizes: frequency rows -> whole optimal Huffman
tables, every row of a table build in one launch.

Replaces sjpeg_tpu/ops/huffman_device.py _merge_codesizes_pallas, the merge
loop, and builds the rest of optimal_code_luts' table around it on the card
too (source and design notes in csrc/merge_codesizes.cu and
csrc/table_core.cuh).  `optimal_tables` launches the CUDA kernel for CUDA
tensors; ops/huffman_device.py runs the plain version,
`huffman_device.optimal_code_luts_plain`, for CPU tensors.
`merge_codesizes_plain` is that plain version's merge loop.
"""

import ctypes

import torch

from .. import kernels

BIG = 0x7FFFFFFF          # an inactive slot's frequency in the argmin
MAX_SIZE = 256            # symbols a row may have (the kernel's 9 a lane)


class _Job(ctypes.Structure):
    """merge_codesizes.cu's TableJob."""
    _fields_ = [("freq", ctypes.c_void_p), ("lut", ctypes.c_void_p),
                ("bits", ctypes.c_void_p), ("nb_syms", ctypes.c_void_p),
                ("syms", ctypes.c_void_p), ("rows", ctypes.c_int),
                ("width", ctypes.c_int), ("size", ctypes.c_int),
                ("lut_size", ctypes.c_int)]


_ARGTYPES = [ctypes.POINTER(_Job), ctypes.c_int, ctypes.c_void_p]


def merge_codesizes_plain(freqw, active, comp, cs, nleft, steps: int):
    """The merge loop of the plain table build: [G, W] int32 merge state
    (frequencies, bool active flags, component ids, code sizes) and [G]
    int32 active-node counts -> [G, W] int32 code sizes after `steps`
    merge steps."""
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


def outputs(jobs) -> list:
    """Empty output tensors of each (freq, size, lut_size) job: (lut
    [G, lut_size], bits [G, 16], nb_syms [G], syms [G, size]), int32."""
    outs = []
    for freq, size, lut_size in jobs:
        g = freq.shape[0]
        outs.append(tuple(torch.empty(shape, dtype=torch.int32,
                                      device=freq.device)
                          for shape in ((g, lut_size), (g, 16), (g,),
                                        (g, size))))
    return outs


def launch(fn, jobs, outs) -> None:
    """One call of the C entry `fn` (sjpeg_optimal_tables) over every job,
    writing `outs`, on the current stream of the jobs' device."""
    structs = [_Job(freq.data_ptr(), *(t.data_ptr() for t in out),
                    freq.shape[0], freq.shape[1], size, lut_size)
               for (freq, size, lut_size), out in zip(jobs, outs)]
    dev = jobs[0][0].device
    with torch.cuda.device(dev):
        rc = fn((_Job * len(structs))(*structs), len(structs),
                torch.cuda.current_stream().cuda_stream)
    kernels.check(rc, "merge_codesizes")


def optimal_tables(jobs):
    """[(freq [G, W] int32 CUDA tensor, size, lut_size), ...] (at most two
    jobs, on one device) -> for each job (lut [G, lut_size] int32 bit
    patterns, bits [G, 16], nb_syms [G], syms [G, size], all int32), from
    one launch.  1 <= size <= 256 symbols, W > size (slot `size` is the
    fake symbol's), 1 <= lut_size <= 256.  Raises for tensors off CUDA."""
    if not 1 <= len(jobs) <= 2:
        raise ValueError("optimal_tables takes one or two jobs")
    dev = jobs[0][0].device
    for freq, size, lut_size in jobs:
        if (freq.device != dev or dev.type != "cuda"
                or freq.dtype != torch.int32 or freq.dim() != 2
                or not freq.is_contiguous()):
            raise ValueError("optimal_tables takes contiguous [G, W] int32 "
                             "CUDA tensors on one device")
        if not (1 <= size <= MAX_SIZE and freq.shape[1] > size
                and 1 <= lut_size <= MAX_SIZE):
            raise ValueError(f"optimal_tables: size {size}, width "
                             f"{freq.shape[1]}, lut_size {lut_size}")
    outs = outputs(jobs)
    launch(kernels.function("merge_codesizes", "sjpeg_optimal_tables",
                            _ARGTYPES), jobs, outs)
    optimal_tables.launches += 1
    return outs


optimal_tables.launches = 0
