"""Scan stuffing on the card: each image's compacted stream -> its finished
entropy-coded segment, the '1' padding and the 0xFF stuffing done where
the stream lies (csrc/scan_stuff.cu over csrc/stuff_core.cuh).

Replaces no TPU kernel: the JAX package stuffs on the host
(`native.words_to_scan`).  `scan_stuff` launches the kernel for CUDA
tensors and runs `scan_stuff_plain`, `native.words_to_scan` a row, for CPU
tensors.  The engine runs it right after stream_concat, so the host
fetches finished bytes and its tail only joins the headers to them.
`scan_stuff.launches` counts the ops run on the card.
"""

import ctypes

import numpy as np
import torch

from .. import kernels, native

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
TILE_WORDS = 1024      # kStuffTileWords in csrc/stuff_core.cuh


def scan_bits(total: int, bucket: int) -> int:
    """The bits of a row's scan: its total, read as uint32 (stream_concat's
    totals are exact mod 2^32), clamped to the row's `bucket` words."""
    return min(int(total) & 0xFFFFFFFF, 32 * bucket)


def scan_stuff_plain(words, totals):
    """The host version; same arguments and results as `scan_stuff`, with
    as many columns as the longest scan."""
    w = words.contiguous().numpy().view(np.uint32)
    bucket = w.shape[1]
    rows = [native.words_to_scan(w[i], scan_bits(t, bucket))
            for i, t in enumerate(totals.tolist())]
    scan = np.zeros((len(rows), max(map(len, rows), default=0)), np.uint8)
    for i, row in enumerate(rows):
        scan[i, :len(row)] = np.frombuffer(row, np.uint8)
    return (torch.from_numpy(scan),
            torch.tensor([len(r) for r in rows], dtype=torch.int32))


def scan_stuff(words, totals):
    """words: [B, bucket] int32 (uint32 MSB-first streams, zero past each
    image's bits: stream_concat's output); totals: [B] int32 exact total
    bits.  Returns ([B, C] uint8 stuffed scans, [B] int32 lengths): row i's
    first lengths[i] bytes are image i's entropy-coded segment, bit-exact
    to `native.words_to_scan`; nothing past them is set.  On the card C is
    8 * bucket, which holds any row, even one of 0xFF bytes.  A total past
    32 * bucket bits (a bucket overflow) is clamped to the row, as
    `scan_bits` does; those rows are for no JPEG."""
    if words.device.type == "cpu":
        return scan_stuff_plain(words, totals)
    if (words.dtype != torch.int32 or totals.dtype != torch.int32
            or words.dim() != 2 or totals.shape != (words.shape[0],)
            or words.shape[1] == 0 or totals.device != words.device
            or not (words.is_contiguous() and totals.is_contiguous())):
        raise ValueError("scan_stuff takes contiguous int32 [B, bucket] "
                         "words (bucket > 0) and [B] totals on one device")
    b, bucket = words.shape
    scan = torch.empty((b, 8 * bucket), dtype=torch.uint8,
                       device=words.device)
    lengths = torch.empty(b, dtype=torch.int32, device=words.device)
    if b == 0:
        return scan, lengths
    counts = torch.empty(b * -(-bucket // TILE_WORDS), dtype=torch.int32,
                         device=words.device)
    fn = kernels.function("scan_stuff", "sjpeg_scan_stuff", _ARGTYPES)
    with torch.cuda.device(words.device):
        rc = fn(words.data_ptr(), totals.data_ptr(), counts.data_ptr(),
                scan.data_ptr(), lengths.data_ptr(), b, bucket,
                torch.cuda.current_stream().cuda_stream)
    kernels.check(rc, "scan_stuff")
    scan_stuff.launches += 1
    return scan, lengths


scan_stuff.launches = 0
