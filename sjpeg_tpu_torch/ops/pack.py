"""Bitstream packing on tensors: per-block entry packing and per-image
stream concatenation, the plain versions of the two CUDA kernels' work.

Bits are MSB-first: a stream's first bit is bit 31 of word 0.  Each entry
(or block word) is split at its bit offset into a part for word
`off >> 5` and a spill into the next word; the parts of different entries
never share a bit, so adding them is OR-ing them, and a scatter-add builds
the words.  Words are uint32 values carried in int64.
"""

import torch

# 2048 bits per block covers the worst-case stream of one 8x8 block
# (DC <= 27 + 63 * <= 27 + escapes <= 128 + EOB <= 16 < 1984).
WORDS_PER_BLOCK = 64

_MASK32 = 0xFFFFFFFF


def to_u32(t: torch.Tensor) -> torch.Tensor:
    """uint32 bit patterns held in an int32 tensor -> int64 values."""
    return t.to(torch.int64) & _MASK32


def to_bits32(t: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor of the same bit patterns
    (the layout the CUDA kernels read and write as uint32)."""
    return torch.where(t >= (1 << 31), t - (1 << 32), t).to(torch.int32)


def _shift_parts(vals: torch.Tensor, offs: torch.Tensor,
                 lens: torch.Tensor):
    """Right-aligned (vals, lens) entries at bit offsets `offs` -> (hi, lo)
    parts for words offs >> 5 and offs >> 5 + 1."""
    end = (offs & 31) + lens                         # <= 63
    hi = torch.where(end <= 32, (vals << (32 - end).clamp(min=0)) & _MASK32,
                     vals >> (end - 32).clamp(min=0))
    hi = torch.where(lens > 0, hi, 0)
    lo = torch.where(end > 32, (vals << (64 - end).clamp(0, 31)) & _MASK32,
                     0)
    return hi, lo


def pack_block_entries(vals: torch.Tensor, lens: torch.Tensor):
    """[N, E] entries -> ([N, WORDS_PER_BLOCK] int64 words, [N] int32 bit
    counts); bits past a block's count are zero."""
    N = vals.shape[0]
    offs = torch.cumsum(lens, dim=1) - lens          # exclusive prefix sum
    total = offs[:, -1] + lens[:, -1]
    hi, lo = _shift_parts(vals, offs, lens)
    # column WORDS_PER_BLOCK collects the zero parts of empty entries at
    # the block's end
    w = (offs >> 5).clamp(max=WORDS_PER_BLOCK)
    out = torch.zeros((N, WORDS_PER_BLOCK + 2), dtype=torch.int64,
                      device=vals.device)
    out.scatter_add_(1, w, hi)
    out.scatter_add_(1, w + 1, lo)
    return out[:, :WORDS_PER_BLOCK], total.to(torch.int32)


def concat_block_streams_batched(words: torch.Tensor, bit_lens: torch.Tensor,
                                 n_images: int, bucket: int):
    """Per-image stream concatenation for a batched encode.

    `words`: [N, W] uint32 values (int64) with N = n_images *
    blocks_per_image, image-major; `bit_lens`: [N].  Each image's blocks
    merge into its own `bucket`-word row; words past the bucket are dropped
    (the exact totals show it).  Returns ([n_images, bucket] int64 words,
    [n_images] int32 total bits).
    """
    N, W = words.shape
    lens = bit_lens.to(torch.int64).reshape(n_images, -1)
    offs = (torch.cumsum(lens, dim=1) - lens).reshape(-1, 1)
    totals = lens.sum(dim=1).to(torch.int32)
    s = offs & 31
    hi = words >> s
    lo = torch.where(s > 0, (words << (32 - s)) & _MASK32, 0)
    w = (offs >> 5) + torch.arange(W, device=words.device)[None, :]
    img = torch.arange(N, device=words.device)[:, None] // (N // n_images)
    dump = n_images * bucket                     # slot for dropped words
    flat = torch.zeros(dump + 1, dtype=torch.int64, device=words.device)
    for part, wi in ((hi, w), (lo, w + 1)):
        idx = torch.where(wi < bucket, img * bucket + wi, dump)
        flat.scatter_add_(0, idx.reshape(-1), part.reshape(-1))
    return flat[:dump].reshape(n_images, bucket), totals
