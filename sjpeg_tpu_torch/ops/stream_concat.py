"""Kernel 2, stream_concat: per-block streams -> one stream per image.

Replaces the merge levels and finisher of sjpeg_tpu/ops/pallas_tree_concat.py
(source and design notes in csrc/stream_concat.cu).  `stream_concat`
launches the CUDA kernels for CUDA tensors and runs `stream_concat_plain`
(ops/pack.concat_block_streams_batched) for CPU tensors.  On the card the
blocks' bit offsets and the images' totals come from the op's own two
launches (chunk sums, then a scan and the placement), not from torch; the
op adds only the zeroed output and its scratch.  Totals are exact and
nothing is truncated except words past the bucket, so an image whose
total exceeds bucket * 32 bits is known to have lost words.
"""

import ctypes

import torch

from .. import kernels
from . import pack

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
CHUNK = 256      # blocks per chunk of the scan, kChunk in the CUDA source


def stream_concat_plain(words, bits, n_images: int, bucket: int):
    """The plain PyTorch version; same arguments and results as
    `stream_concat`."""
    out, totals = pack.concat_block_streams_batched(
        pack.to_u32(words), bits, n_images, bucket)
    return pack.to_bits32(out), totals


def stream_concat(words, bits, n_images: int, bucket: int):
    """words: [N, 64] int32 (uint32 bit patterns, left-aligned per block,
    zero past each block's count); bits: [N] int32, N = n_images *
    blocks per image, image-major.  Returns ([n_images, bucket] int32
    words, [n_images] int32 total bits)."""
    if words.device.type == "cpu":
        return stream_concat_plain(words, bits, n_images, bucket)
    n = words.shape[0]
    if (words.dtype != torch.int32 or bits.dtype != torch.int32
            or words.shape != (n, pack.WORDS_PER_BLOCK)
            or bits.shape != (n,) or n % n_images
            or bits.device != words.device
            or not (words.is_contiguous() and bits.is_contiguous())):
        raise ValueError("stream_concat takes contiguous int32 [N, 64] "
                         "words and [N] bits on one device, N a multiple "
                         "of n_images")
    out, sums, totals = scratch(n_images, n // n_images, bucket,
                                words.device)
    if n == 0:
        return out, totals.zero_()
    launch(kernels.function("stream_concat", "sjpeg_stream_concat_scan",
                            _ARGTYPES), words, bits, out, sums, totals)
    stream_concat.launches += 1
    return out, totals


def scratch(n_images: int, per_img: int, bucket: int, device):
    """The op's buffers on `device`: the zeroed [n_images, bucket] int32
    output, the scan's chunk sums (one int32 per CHUNK blocks of an image)
    and the [n_images] int32 totals."""
    n_sums = n_images * -(-per_img // CHUNK)
    return (torch.zeros((n_images, bucket), dtype=torch.int32, device=device),
            torch.empty(n_sums, dtype=torch.int32, device=device),
            torch.empty(n_images, dtype=torch.int32, device=device))


def launch(fn, words, bits, out, sums, totals) -> None:
    """The op's two launches on the current stream, into `scratch`'s
    buffers; fn is the C entry sjpeg_stream_concat_scan of a built library,
    its argtypes _ARGTYPES.  Counts nothing."""
    n_images, bucket = out.shape
    n = words.shape[0]
    with torch.cuda.device(words.device):
        rc = fn(words.data_ptr(), bits.data_ptr(), sums.data_ptr(),
                out.data_ptr(), totals.data_ptr(), n, n // n_images, bucket,
                sums.numel(), torch.cuda.current_stream().cuda_stream)
    kernels.check(rc, "stream_concat")


stream_concat.launches = 0
