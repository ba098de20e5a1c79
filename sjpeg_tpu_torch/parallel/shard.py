"""Sharded encode pieces: batch data-parallel x intra-image MCU-row stripes.

The reference is strictly serial; the only cross-MCU state in baseline
JPEG is (a) the DC predictors and (b) the bitstream position.  Both have
exact parallel decompositions (sjpeg_tpu.parallel.shard), so an image
splits into stripes of whole MCU rows:

- colour conversion, fDCT, quantization, run/levels and per-block packing
  are local to a stripe (stripes are MCU-aligned, so no halo);
- each stripe's DC chain starts from the previous stripe's last quantized
  DC of the same component and image (0 for stripe 0): a shifted
  subtraction with the same bits as the serial chain;
- histograms and symbol frequencies are sums over the stripes;
- each stripe emits a compacted (words, bit count) stream, and the
  stripes of an image are stitched by one more stream_concat launch.

The scan order of the image equals the concatenation of the stripes' scan
orders, so the stitched stream is bit-identical to the one-device encode.
"""

import torch

from .. import constants as C
from .. import engine
from ..ops import colorspace, fdct, pack, stream_concat, vlc


def _local_blocks(src, src_kind: str, yuv_mode: int, width: int,
                  stripe_h: int, rows: int, mb_w: int, sub_h_partial: int,
                  clip_row: int):
    """A stripe [B, stripe_h, W, 3] (or a plane tuple with src_kind
    "planes"), MCU-aligned and edge-padded, -> per-component [N_c, 64]
    sample blocks.  A height-clipped 4:2:0 image gets its partial MCU row's
    AverageExtraLuma flatten at stripe-local row `clip_row` (outside
    0..rows-1: not in this stripe)."""
    if src_kind == "planes":
        blocks = colorspace.planes_to_blocks(src, yuv_mode, width, stripe_h)
    else:
        blocks = colorspace.rgb_to_blocks(src, yuv_mode, width, stripe_h)
    blocks = list(blocks)
    if yuv_mode == C.YUV_420 and sub_h_partial:
        blocks[0] = colorspace.average_extra_luma_dynamic_row(
            blocks[0], rows, mb_w, width, sub_h_partial, clip_row)
    return blocks


def _dc_codes_sharded(dc_local: torch.Tensor, prev=None) -> torch.Tensor:
    """DC differencing of one component of a stripe: [B, n] quantized DCs
    and the [B] predictors carried in from the previous stripe (None: 0,
    stripe 0) -> [B * n] int32 codes."""
    return vlc.dc_diff_codes(dc_local.reshape(-1), dc_local.shape[0], prev)


def stitch_shard_streams(words: torch.Tensor, totals: torch.Tensor):
    """Stitch the stripe streams of each image into one stream.

    `words`: [B, S, bucket] int32 stripe streams (left-aligned, zero past
    each stripe's total), bucket a multiple of 64; `totals`: [B, S] int32.
    Each stripe stream is read as bucket / 64 pieces of 64 words, piece j
    carrying clamp(total - 2048 j, 0, 2048) bits, and one stream_concat
    launch places every piece of the batch.  -> ([B, S * bucket] int32
    words, [B] int32 totals)."""
    b, s, bucket = words.shape
    if bucket % pack.WORDS_PER_BLOCK:
        raise ValueError("stitch_shard_streams needs a bucket that is a "
                         "multiple of 64 words")
    k = bucket // pack.WORDS_PER_BLOCK
    start = torch.arange(k, dtype=torch.int64, device=words.device) * (
        32 * pack.WORDS_PER_BLOCK)
    bits = (totals.to(torch.int64)[..., None] - start).clamp(
        0, 32 * pack.WORDS_PER_BLOCK).to(torch.int32).reshape(-1)
    return stream_concat.stream_concat(
        words.reshape(-1, pack.WORDS_PER_BLOCK), bits, b, s * bucket)


def encode_shard(rgb_stripe, iquant, ibias, dc_luts, ac_luts, prev_dc=None,
                 *, yuv_mode: int, nb_blocks):
    """Encode one MCU-aligned stripe [sub_h, W, 3] of one image with fixed
    quantizers ([2, 64] iquant / bias) and LUTs ([2, 16] / [2, 256]); the
    single-stripe reference of the sharded path.  `prev_dc`: per-component
    [1] DC predictors carried in from the stripe above (None: stripe 0).

    Returns (words [n_blocks * 64] int32, total bits [] int32, luma and
    chroma histograms [64, bins], freq_dc [2, 12], freq_ac [2, 256], each
    component's last quantized DC [1] for the stripe below).  The
    histograms and frequencies are this stripe's own: a mesh sums them
    over sp."""
    sub_h, width = rgb_stripe.shape[:2]
    blocks = colorspace.rgb_to_blocks(rgb_stripe[None], yuv_mode, width,
                                      sub_h)
    coeffs = [fdct.fdct_blocks(b.contiguous()) for b in blocks]
    histo_l, histo_c = engine._coeff_histos(coeffs, 1)
    dcq = engine._dc_quantized(coeffs, iquant, ibias)
    prev_dc = prev_dc if prev_dc is not None else [None] * len(dcq)
    dc_codes = engine._interleave_dc(
        [_dc_codes_sharded(d, p) for d, p in zip(dcq, prev_dc)], nb_blocks)
    vlc_state, (freq_dc, freq_ac) = engine._stage_batch_quantize(
        coeffs, iquant, ibias, True, nb_blocks, 1, 1, dc_codes=dc_codes)
    n = dc_codes.shape[0]
    words, totals = engine._stage_batch_pack(vlc_state, dc_luts, ac_luts, 1,
                                             n * pack.WORDS_PER_BLOCK)
    return (words[0], totals[0], histo_l, histo_c, freq_dc, freq_ac,
            [d[:, -1] for d in dcq])
