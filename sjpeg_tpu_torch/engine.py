"""JPEG encode on the GPU: the port's engine.

Batched paths, with the JAX engine's bucket formula and the same output
bytes.  Method 0 (K.3 tables, no adaptive quantization), fused:

  colour conversion + blockize            ops/colorspace   [torch]
  DC predictor chain                      ops/fdct.fdct_dc, ops/vlc
  fDCT + quantize + VLC + per-block pack  ops/sample_pack  [CUDA kernel 1]
  per-image stream concatenation          ops/stream_concat [CUDA kernel 2]
  '1' padding + 0xFF stuffing            ops/scan_stuff   [CUDA kernel 11]
  fetch of the scans, markers            headers          [host]

Methods 1, 3, 4 and 7 (two-pass optimal Huffman and/or adaptive
quantization, method 7 with trellis quantization; per-image statistics, or
one set from the whole batch with share_statistics=True), staged as the
JAX engine stages them off the relay (`_encode_batch_optimized`):

  colour + fDCT + coefficient histograms  _stage_batch_coeffs, ops/fdct
                                                           [CUDA kernel 6]
  lambda fit per image and table group    ops/lambda_fit   [CUDA kernel 9]
  MCU interleave + DC chain               _interleave_coeffs [torch]
  quantize + VLC fields + symbol
    frequencies                           ops/vlc_fields   [CUDA kernel 10]
  or, method 7:
    MCU interleave + DC chain             _interleave_coeffs [torch]
    trellis quantization                  ops/trellis      [CUDA kernel 5]
    VLC fields + symbol frequencies       ops/vlc_fields   [CUDA kernel 10]
  optimal tables, one launch a build      ops/huffman_device,
                                          ops/merge_codesizes [CUDA kernel 4]
  Huffman lookup + per-block pack         ops/vlc_pack     [CUDA kernel 3]
  per-image stream concatenation          ops/stream_concat [CUDA kernel 2]
  '1' padding + 0xFF stuffing            ops/scan_stuff   [CUDA kernel 11]
  fetch of the scans, markers            headers          [host]

With passes > 1 and a target size or PSNR, every method runs the batched
search of engine_search, which packs its passes through sample_pack with
per-image tables (or, pass by pass, through the staged path above); with a
custom `param.search_hook`, each image runs the single-image search.

Single image (`encode_rgb`, `encode_gray`, `encode_yuv`), as the JAX
engine's one-image API: method 0 from RGB is the method-0 batch path with
one image; everything else is staged (`_encode_blocks_device`) over the
batched stages with one image.  A pass whose Huffman tables are fixed
before it quantizes (methods 0 and 3, and the size passes of their
searches) packs straight from the coefficients:

  MCU interleave + DC chain               _interleave_coeffs [torch]
  quantize + VLC + per-block pack         ops/quant_pack   [CUDA kernel 7]
  stream concatenation                    ops/stream_concat [CUDA kernel 2]

passes > 1 runs the single-image search (engine_search.encode_search_one,
the hook on the host).  `_encode_coeffs` runs these stages from an image's
coefficients, which host_encoder.encode_components computes from given
blocks.  `encode_core` is `encode_batch_core` for one image with its
worst-case bucket, and `fetch_stream` copies its used words to the host.
`encode_pipelined` and `encode_many` are the serving wrappers over
`encode_batch`.

From RGB, YUV_AUTO picks each image's mode from its riskiness
(ops/riskiness.risk_stats on the uploaded batch, one fetch of three values
an image; the host scorer when the exact table is active), and a batch
runs as one sub-batch per mode.  YUV_SHARP converts on the card first:

  sharp set-up and reconstruction         sharp_yuv        [torch]
  Gauss-Seidel sweeps, per-image exit     ops/sharp_yuv    [CUDA kernel 8]

and encodes the planes as 4:2:0.

The sharded API (parallel/api.encode_batch_sharded) runs these staged
stages once an MCU-row stripe over a (dp, sp) mesh of devices, with the
same bytes, and delegates to `encode_batch` where the JAX package does.

Every entry point takes `device`: None means "cuda", and it raises when
CUDA is missing.  With device="cpu" the kernels' plain PyTorch versions
run instead, which is how the tests hold the port against the JAX package.
"""

import collections
import dataclasses
import functools
import math
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from . import constants as C
from . import headers, pipeline, riskiness, sharp_yuv, spec, state
from .huffman import (build_code_lut, k3_default_tables,
                      optimal_tables_from_freqs, trellis_cost_lens)
from .ops import colorspace, fdct, huffman_device, lambda_fit, pack, \
    quant_pack, quantize, sample_pack, scan_stuff, stream_concat, trellis, \
    vlc, vlc_fields, vlc_pack
from .ops import riskiness as risk_device
from .params import TARGET_NONE, EncoderParam, method_flags
from .utils.profiling import span


def resolve_device(device=None) -> torch.device:
    """None -> "cuda"; raises if CUDA is asked for and missing."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; the port runs on the GPU "
                           "unless the caller passes device='cpu'")
    return dev


def _request(entry):
    """A public entry point inside the span `sjpeg.request`; one that
    another calls (encode_rgb -> encode_yuv) opens none of its own."""
    @functools.wraps(entry)
    def run(*args, **kwargs):
        with span("request"):
            return entry(*args, **kwargs)
    return run


def _is_search(param: EncoderParam) -> bool:
    """A target-size / target-PSNR search runs when passes > 1 and a target
    is set; passes > 1 alone encodes once, as the JAX engine does."""
    return param.passes > 1 and param.target_mode != TARGET_NONE


def auto_modes(src: torch.Tensor) -> list:
    """The YUV mode that YUV_AUTO picks for each image of a [B, H, W, 3]
    uint8 batch on any device: the riskiness reduction where the batch
    lies, or, with the exact table active, the host scorer."""
    if riskiness.exact_table_active():
        with span("fetch"):
            rgb = src.cpu().numpy()
        with span("analysis"):
            return [riskiness.riskiness(im)[0] for im in rgb]
    return [mode for mode, _ in risk_device.batch_riskiness(src)]


def _check_size(w: int, h: int) -> None:
    if not (0 < w <= C.MAX_DIMENSION and 0 < h <= C.MAX_DIMENSION):
        raise ValueError(f"image size {w} x {h} is outside 1..."
                         f"{C.MAX_DIMENSION}")


def _to_device(x, device: torch.device) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))
    if t.dtype != torch.uint8:
        raise TypeError(f"expected uint8 samples, got {t.dtype}")
    with span("upload"):
        return t.to(device)


def _slot_groups(nb_blocks, n_mcu: int, device) -> torch.Tensor:
    """[n_mcu * blocks per MCU] int32 table group of each interleaved
    block: 0 for luma, 1 for chroma."""
    slot_group = torch.zeros(sum(nb_blocks), dtype=torch.int32,
                             device=device)
    slot_group[nb_blocks[0]:] = 1
    return slot_group.repeat(n_mcu)


def _interleave_samples(blocks, iquant, ibias, nb_blocks, n_images: int = 1):
    """MCU-interleave the component sample blocks for sample_pack, with
    each block's DC diff code and table group.

    The DC predictor (src/enc.cc:482-499) chains across blocks, so the
    quantized DC of every block is computed here, ahead of the per-block
    kernel, through the collapsed fDCT chain (ops/fdct.fdct_dc).  Samples
    travel as int16, which holds RGB chroma's +128 exactly."""
    n_mcu = blocks[0].shape[0] // nb_blocks[0]
    sinter = torch.cat([b.to(torch.int16).reshape(n_mcu, nb, 64)
                        for b, nb in zip(blocks, nb_blocks)],
                       dim=1).reshape(-1, 64)
    dc_cols = []
    for c, (b, nb) in enumerate(zip(blocks, nb_blocks)):
        g = 0 if c == 0 else 1
        dcq = quantize.quantize_values(fdct.fdct_dc(b), iquant[g, 0],
                                       ibias[g, 0])
        dc_cols.append(vlc.dc_diff_codes(dcq, n_images).reshape(n_mcu, nb))
    dc_codes = torch.cat(dc_cols, dim=1).reshape(-1)
    return sinter, dc_codes, _slot_groups(nb_blocks, n_mcu, sinter.device)


def encode_batch_core(src, iquant, ibias, dc_luts, ac_luts, *,
                      yuv_mode: int, width: int, height: int, nb_blocks,
                      bucket: int, src_kind: str = "rgb",
                      n_images: Optional[int] = None):
    """[B, H, W, 3] uint8 (or a (y, u, v) / (y,) plane tuple with
    src_kind="planes") -> ([B, bucket] int32 words holding uint32 stream
    bits, [B] int32 exact total bits).  Words past the bucket are dropped;
    the totals show which images lost some."""
    if n_images is None:
        n_images = src.shape[0] if src_kind == "rgb" else src[0].shape[0]
    if src_kind == "planes":
        blocks = colorspace.planes_to_blocks(src, yuv_mode, width, height)
    else:
        blocks = colorspace.rgb_to_blocks(src, yuv_mode, width, height)
    sinter, dc_codes, group = _interleave_samples(blocks, iquant, ibias,
                                                  nb_blocks, n_images)
    words, bits = sample_pack.sample_pack(sinter, dc_codes, group, iquant,
                                          ibias, dc_luts, ac_luts)
    return stream_concat.stream_concat(words, bits, n_images, bucket)


@_request
def encode_batch(rgbs, param: Optional[EncoderParam] = None,
                 bits_per_pixel_budget: float = 4.0,
                 share_statistics: bool = False, device=None):
    """Encode a uint8 batch [B, H, W, 3] (numpy or torch) with any YUV mode
    and method 0, 1, 3, 4 or 7.  Returns a list of complete JPEG byte
    strings, byte-identical to sjpeg_tpu.engine.encode_batch.

    With YUV_AUTO (the default) each image picks its own mode and the batch
    runs as one sub-batch per mode, in the order the modes first appear;
    the results come back in input order.  Methods 1, 3, 4 and 7 optimize
    per image by default (per-image adaptive matrices and per-image optimal
    Huffman tables, as the reference does); share_statistics=True derives
    one table set / tuned matrix pair from each (sub-)batch's statistics
    instead.  With passes > 1 and set_target_size / set_target_psnr, each
    image runs its own search (share_statistics does not apply)."""
    param = param or EncoderParam()
    src = _to_device(rgbs, resolve_device(device))
    return _encode_rgb_batch(src, param, bits_per_pixel_budget,
                             share_statistics)


def _encode_rgb_batch(src: torch.Tensor, param: EncoderParam,
                      bits_per_pixel_budget: float, share_statistics: bool):
    """encode_batch over a device batch: the AUTO split (each sub-batch
    indexed on the device, no second upload) and the sharp conversion."""
    b, h, w = src.shape[:3]
    _check_size(w, h)
    yuv_mode = param.yuv_mode
    if yuv_mode == C.YUV_AUTO:
        groups = {}
        for i, m in enumerate(auto_modes(src)):
            groups.setdefault(m, []).append(i)
        if len(groups) > 1:
            out = [None] * b
            for m, idxs in groups.items():
                sub = src[torch.tensor(idxs, device=src.device)]
                res = _encode_rgb_batch(
                    sub, dataclasses.replace(param, yuv_mode=m),
                    bits_per_pixel_budget, share_statistics)
                for i, jpeg in zip(idxs, res):
                    out[i] = jpeg
            return out
        yuv_mode = next(iter(groups))
    if yuv_mode == C.YUV_SHARP:
        return _encode_batch_src(sharp_yuv.sharp_rgb_to_yuv420(src),
                                 "planes", C.YUV_420, w, h, param,
                                 bits_per_pixel_budget, share_statistics)
    return _encode_batch_src(src, "rgb", yuv_mode, w, h, param,
                             bits_per_pixel_budget, share_statistics)


@_request
def encode_batch_yuv(y, u, v, is_420: bool,
                     param: Optional[EncoderParam] = None,
                     bits_per_pixel_budget: float = 4.0,
                     share_statistics: bool = False, device=None):
    """Batched planar-YUV encode: y [B, H, W] uint8 plus chroma planes
    ([B, ceil(H/2), ceil(W/2)] when `is_420`, else full size)."""
    param = param or EncoderParam()
    dev = resolve_device(device)
    h, w = y.shape[1:3]
    src = tuple(_to_device(p, dev) for p in (y, u, v))
    return _encode_batch_src(src, "planes",
                             C.YUV_420 if is_420 else C.YUV_444, w, h,
                             param, bits_per_pixel_budget, share_statistics)


@_request
def encode_batch_gray(y, param: Optional[EncoderParam] = None,
                      bits_per_pixel_budget: float = 4.0,
                      share_statistics: bool = False, device=None):
    """Batched grayscale encode: y [B, H, W] uint8 (YUV 4:0:0)."""
    param = param or EncoderParam()
    dev = resolve_device(device)
    h, w = y.shape[1:3]
    return _encode_batch_src((_to_device(y, dev),), "planes", C.YUV_400,
                             w, h, param, bits_per_pixel_budget,
                             share_statistics)


@_request
def encode_batch_nv12(y, uv, param: Optional[EncoderParam] = None,
                      bits_per_pixel_budget: float = 4.0,
                      share_statistics: bool = False, device=None):
    """Batched semi-planar NV12 encode: y [B, H, W], uv
    [B, ceil(H/2), ceil(W/2), 2] interleaved U/V; the split is a device
    slice."""
    uv = _to_device(uv, resolve_device(device))
    return encode_batch_yuv(y, uv[..., 0], uv[..., 1], True, param,
                            bits_per_pixel_budget, share_statistics, device)


@_request
def encode_batch_nv21(y, vu, param: Optional[EncoderParam] = None,
                      bits_per_pixel_budget: float = 4.0,
                      share_statistics: bool = False, device=None):
    """Batched semi-planar NV21 encode (V/U interleaved chroma)."""
    vu = _to_device(vu, resolve_device(device))
    return encode_batch_yuv(y, vu[..., 1], vu[..., 0], True, param,
                            bits_per_pixel_budget, share_statistics, device)


def _quant_matrices(param: EncoderParam):
    qmats = param.resolved_quant_matrices()
    min_qmats = param.resolved_min_quant_matrices()
    return [spec.finalize_quant_matrix(qmats[i], min_qmats[i],
                                       param.quantization_bias)
            for i in range(2)]


def _quant_arrays(qms):
    """[2, 64] int32 iquant and bias rows (luma, chroma)."""
    iq = np.stack([qms[0]["iquant"], qms[1]["iquant"]]).astype(np.int32)
    ib = np.stack([qms[0]["bias"], qms[1]["bias"]]).astype(np.int32)
    return iq, ib


def _host_luts(tables):
    """HuffmanTable[4] -> ([2, 16], [2, 256]) uint32 LUTs."""
    with span("analysis"):
        dc = np.stack([build_code_lut(tables[g], 16) for g in range(2)])
        ac = np.stack([build_code_lut(tables[2 + g], 256) for g in range(2)])
    return dc, ac


def _encode_batch_src(src, src_kind: str, yuv_mode: int, w: int, h: int,
                      param: EncoderParam,
                      bits_per_pixel_budget: float = 4.0,
                      share_statistics: bool = False):
    """Shared batched encode over a device source (RGB batch or
    component plane tuple) with a resolved YUV mode."""
    _check_size(w, h)
    if _is_search(param) and param.search_hook is not None:
        return _encode_each_with_hook(src, src_kind, yuv_mode, param)
    if _is_search(param):              # share_statistics does not apply
        from .engine_search import encode_batch_search
        return encode_batch_search(src, src_kind, yuv_mode, w, h, param,
                                   bits_per_pixel_budget)
    flags = method_flags(param.method)
    if flags["use_adaptive_quant"] or flags["optimize_size"]:
        return _encode_batch_optimized(src, src_kind, yuv_mode, w, h, param,
                                       bits_per_pixel_budget,
                                       share_statistics)
    b = src.shape[0] if src_kind == "rgb" else src[0].shape[0]
    device = src.device if src_kind == "rgb" else src[0].device
    layout = pipeline.component_layout(yuv_mode, w, h)
    qms = _quant_matrices(param)
    tables = k3_default_tables()
    iq, ib, dc_luts, ac_luts = state.tables_from_numpy(
        *_quant_arrays(qms), *_host_luts(tables), device)

    bucket = _bucket(layout, w, h, bits_per_pixel_budget)
    words, totals = encode_batch_core(
        src, iq, ib, dc_luts, ac_luts, yuv_mode=yuv_mode, width=w,
        height=h, nb_blocks=tuple(layout.nb_blocks), bucket=bucket,
        src_kind=src_kind, n_images=b)
    totals_np, scans = fetch_scans(words, totals)

    with span("tail"):
        head = _jpeg_headers(layout, param, qms, tables)
        return [_host_fallback_one(src, src_kind, i, yuv_mode, w, h, param)
                if totals_np[i] > bucket * 32     # bucket overflow
                else b"".join((head, scans[i], headers.EOI))
                for i in range(b)]


def _bucket(layout, w: int, h: int, bits_per_pixel_budget: float) -> int:
    """Words of each image's output row: the budget, at least 4,096 words
    and at most the image's worst case of 64 words a block."""
    n_blocks = _blocks_per_image(layout)
    return int(min(n_blocks * pack.WORDS_PER_BLOCK,
                   max(4096, w * h * bits_per_pixel_budget / 32)))


def _blocks_per_image(layout) -> int:
    return layout.mb_w * layout.mb_h * sum(layout.nb_blocks)


def _host_fallback_one(src, src_kind: str, i: int, yuv_mode: int, w: int,
                       h: int, param: EncoderParam) -> bytes:
    """Re-encode image `i` after a bucket overflow.  The JAX engine sends it
    to its host encoder; the port runs its own path again for that one
    image with the bucket at the image's worst case (64 words a block),
    which cannot overflow and gives the same bytes."""
    one = src[i:i + 1] if src_kind == "rgb" else tuple(p[i:i + 1]
                                                       for p in src)
    return _encode_batch_src(one, src_kind, yuv_mode, w, h, param,
                             bits_per_pixel_budget=math.inf)[0]


# ---------------------------------------------------------------------------
# Methods 1, 3, 4 and 7: the staged optimized path
# ---------------------------------------------------------------------------

def _stage_batch_coeffs(src, src_kind: str, yuv_mode: int, width: int,
                        height: int, with_histo: bool, n_images: int = 1):
    """Batched RGB (or planar tuple) -> per-component [N_c, 64] int32 fDCT
    coefficients (+ (luma, chroma) |c| >> HSHIFT histograms, [B, 64, bins]
    per image when n_images > 1, else summed over the batch [64, bins];
    chroma sums U and V, and is zero for gray)."""
    if src_kind == "planes":
        blocks = colorspace.planes_to_blocks(src, yuv_mode, width, height)
    else:
        blocks = colorspace.rgb_to_blocks(src, yuv_mode, width, height)
    return _block_coeffs(blocks, with_histo, n_images)


def _block_coeffs(blocks, with_histo: bool, n_images: int = 1):
    """Per-component [N_c, 64] int32 sample blocks -> their fDCT
    coefficients (+ the histograms of `_coeff_histos`)."""
    coeffs = [fdct.fdct_blocks(b.contiguous()) for b in blocks]
    return coeffs, _coeff_histos(coeffs, n_images) if with_histo else None


def _coeff_histos(coeffs, n_images: int):
    """(luma, chroma) |c| >> HSHIFT histograms of per-component
    coefficients: [B, 64, bins] per image when n_images > 1, else [64,
    bins]; chroma sums U and V and is zero for gray."""
    histo_l = quantize.store_histo(coeffs[0], n_images)
    if len(coeffs) > 1:
        histo_c = (quantize.store_histo(coeffs[1], n_images)
                   + quantize.store_histo(coeffs[2], n_images))
    else:
        histo_c = torch.zeros_like(histo_l)
    return histo_l, histo_c


def _stage_batch_quantize(coeffs, iquant, ibias, with_stats: bool,
                          nb_blocks, n_images: int, stats_images: int,
                          dc_codes=None, valid=None):
    """-> ((VLC fields, DC codes, groups), frequencies or None).
    `dc_codes`: MCU-interleaved DC codes to use instead of the per-image
    chain; `valid`: the blocks the frequencies count (all when None).  One
    vlc_fields call quantizes the interleaved coefficients and derives
    both."""
    cinter, dc_codes, group = _interleave_coeffs(coeffs, iquant, ibias,
                                                 nb_blocks, n_images,
                                                 dc_codes)
    rl, freqs = vlc_fields.vlc_fields(
        cinter, dc_codes, group, iquant, ibias, stats_images=stats_images,
        valid=valid, with_stats=with_stats)
    return (rl, dc_codes, group), freqs


def _interleave_coeffs(coeffs, iquant, ibias, nb_blocks, n_images: int = 1,
                       dc_codes=None):
    """MCU-interleave the per-component coefficients (for quant_pack and
    the trellis, which quantize per block), with each block's DC diff code
    from the plain bias quantizer of the DC lane alone (the predictor
    resets per image; the trellis's own DC rule, src/enc.cc:763-766; or
    the given MCU-interleaved `dc_codes`) and its table group.
    iquant/ibias: [2, 64] shared or [B, 2, 64] per image -> ([N, 64]
    int32, [N] int32 DC codes, [N] int32 groups)."""
    n_mcu = coeffs[0].shape[0] // nb_blocks[0]
    cinter = torch.cat([co.reshape(n_mcu, nb, 64)
                        for co, nb in zip(coeffs, nb_blocks)],
                       dim=1).reshape(-1, 64)
    if dc_codes is None:
        dc_codes = _dc_codes(coeffs, iquant, ibias, nb_blocks, n_images)
    return (cinter, dc_codes, _slot_groups(nb_blocks, n_mcu, cinter.device))


def _dc_quantized(coeffs, iquant, ibias, n_images: int = 1) -> list:
    """Each component's DC under the plain bias quantizer, [n_images,
    blocks per image] int64.  iquant/ibias: [2, 64] shared or [B, 2, 64]
    per image."""
    out = []
    for c, co in enumerate(coeffs):
        g = 0 if c == 0 else 1
        if iquant.dim() == 3:
            dcq = quantize.quantize_values(co[:, 0].reshape(n_images, -1),
                                           iquant[:, g, 0, None],
                                           ibias[:, g, 0, None])
        else:
            dcq = quantize.quantize_values(co[:, 0], iquant[g, 0],
                                           ibias[g, 0])
        out.append(dcq.reshape(n_images, -1))
    return out


def _dc_codes(coeffs, iquant, ibias, nb_blocks, n_images: int = 1):
    """MCU-interleaved [N] int32 DC diff codes of per-component
    coefficients under the plain bias quantizer (src/enc.cc:482-499; the
    predictor resets per image).  iquant/ibias: [2, 64] shared or
    [B, 2, 64] per image."""
    return _interleave_dc([vlc.dc_diff_codes(dcq.reshape(-1), n_images)
                           for dcq in _dc_quantized(coeffs, iquant, ibias,
                                                    n_images)], nb_blocks)


def _interleave_dc(codes, nb_blocks) -> torch.Tensor:
    """Per-component [N_c] DC codes -> MCU-interleaved [N] int32."""
    n_mcu = codes[0].shape[0] // nb_blocks[0]
    return torch.cat([c.reshape(n_mcu, nb) for c, nb in zip(codes,
                                                            nb_blocks)],
                     dim=1).reshape(-1)


def _stage_trellis_post(qinter, dc_codes, group, with_stats: bool,
                        stats_images: int, valid=None):
    """Trellis levels -> ((int32 VLC fields, DC codes, groups),
    frequencies of the `valid` blocks (all when None), or None): one
    vlc_fields launch on the card, its plain twin elsewhere."""
    rl, freqs = vlc_fields.vlc_fields(qinter, dc_codes, group,
                                      stats_images=stats_images, valid=valid,
                                      with_stats=with_stats)
    return (rl, dc_codes, group), freqs


def _stage_quantize_trellis(coeffs, iquant, ibias, quant, lt_lens,
                            with_stats: bool, nb_blocks, n_images: int,
                            stats_images: int, dc_codes=None, valid=None):
    """Trellis quantize + interleave + VLC fields (+ frequencies): the
    method-7 counterpart of `_stage_batch_quantize` (src/enc.cc:692-761),
    with the same `dc_codes` and `valid`.  iquant/ibias/quant: [2, 64]
    shared or [B, 2, 64] per image; lt_lens: [2, 256] or [B, 2, 256] AC
    code lengths, the rate model.  One span `sjpeg.trellis` a call."""
    with span("trellis"):
        cinter, dc_codes, group = _interleave_coeffs(coeffs, iquant, ibias,
                                                     nb_blocks, n_images,
                                                     dc_codes)
        qinter = trellis.trellis_quantize(cinter, iquant, ibias, quant,
                                          group, lt_lens, n_images)
        del cinter
        return _stage_trellis_post(qinter, dc_codes, group, with_stats,
                                   stats_images, valid)


@functools.lru_cache(maxsize=None)
def _cost_lens(device: torch.device) -> torch.Tensor:
    """The trellis's [2, 256] K.3 rate lengths (`trellis_cost_lens`) on
    `device`, uploaded once a device and held read-only: no request waits
    for an upload queued behind its stream's work.  The uploading stream
    is synchronised once here, so that a launch on any stream reads them
    complete."""
    (lens,) = state.arrays_to_device(trellis_cost_lens(), device=device)
    if lens.is_cuda:
        torch.cuda.current_stream(lens.device).synchronize()
    return lens


def _stage_tables(freqs, flags, n_groups: int, b: int,
                  share_statistics: bool, device):
    """Huffman LUTs for the pack -> (dc_luts, ac_luts, per-image host
    tables or None, [B, 604] DHT description or None).  Per-image optimal
    tables are built on the card and described by one flat tensor; a
    shared optimal set is built on the host from one fetch of the batch's
    frequencies; methods without Huffman optimization use K.3."""
    if flags["optimize_size"] and not share_statistics:
        dc_luts, ac_luts, nbs, desc = huffman_device.luts_and_desc_from_freqs(
            freqs[0].reshape(b, 2, -1), freqs[1].reshape(b, 2, -1),
            n_groups)
        return dc_luts, ac_luts, None, huffman_device.desc_to_flat(nbs, desc)
    if flags["optimize_size"]:
        with span("fetch"):
            freqs_np = [f.cpu().numpy().astype(np.int64) for f in freqs]
        with span("analysis"):
            tables = optimal_tables_from_freqs(*freqs_np, n_groups)
        if n_groups == 1:
            defaults = k3_default_tables()
            tables[1], tables[3] = defaults[1], defaults[3]
    else:
        tables = k3_default_tables()
    dc_luts, ac_luts = state.arrays_to_device(*_host_luts(tables),
                                              device=device)
    return dc_luts, ac_luts, [tables] * b, None


def _stage_batch_pack(vlc_state, dc_luts, ac_luts, n_images: int,
                      bucket: int, block_valid=None):
    """VLC fields + LUTs ([2, ...] shared or [B, 2, ...] per image) ->
    ([n_images, bucket] int32 words, [n_images] int32 exact totals).
    `block_valid`: optional [N] bool; blocks with False emit no bits (the
    padding blocks of a ragged stripe; every block otherwise emits at
    least its DC and EOB codes)."""
    rl, dc_codes, group = vlc_state
    words, bits = vlc_pack.vlc_pack(rl["run"], rl["size"], rl["code"],
                                    dc_codes, group, dc_luts, ac_luts)
    if block_valid is not None:
        bits = torch.where(block_valid, bits, 0)
        words = torch.where(block_valid[:, None], words, 0)
    return stream_concat.stream_concat(words, bits, n_images, bucket)


def _state_rows(vlc_state, rows: slice):
    """The blocks `rows` of a VLC state (fields, DC codes, groups)."""
    rl, dc_codes, group = vlc_state
    return ({k: v[rows] for k, v in rl.items()}, dc_codes[rows],
            group[rows])


def _repack_one(vlc_state, dc_luts, ac_luts, i: int, per_img: int) -> bytes:
    """Scan bytes of image i after a bucket overflow: its rows of the
    already chosen VLC state, packed again by `_repack_image`."""
    return _repack_image(
        _state_rows(vlc_state, slice(i * per_img, (i + 1) * per_img)),
        dc_luts, ac_luts, i)


def _repack_image(state_i, dc_luts, ac_luts, i: int):
    """Scan bytes of image i from its own VLC state, packed again with its
    own LUTs (and its batch's, when shared) into a bucket of 64 words a
    block, which cannot overflow.  A fresh single-image encode would derive
    other tables when they came from the whole batch."""
    if dc_luts.dim() == 3:
        dc_luts, ac_luts = dc_luts[i], ac_luts[i]
    n = state_i[1].shape[0]
    return _scan_bytes(*_stage_batch_pack(state_i, dc_luts, ac_luts, 1,
                                          n * pack.WORDS_PER_BLOCK))


def _fit_on_device(histos, param: EncoderParam, flags, n_groups: int,
                   shared: bool, device, qms=None):
    """A batch's quantizer rows on `device`, int32 [2, 64] shared or
    [B, 2, 64] per image: (iquant, bias, quant), the finalized rows of
    `qms` (the param's matrices by default), with adaptive quantization
    after the lambda fit of each image (or of the batch) and table group.
    The fit runs where the histograms are (ops/lambda_fit.lambda_fit: one
    launch on a CUDA device, whose rows stay there).  The quant rows are
    the trellis's clamped matrices, and `_host_matrices` reads them for
    the headers."""
    qms = _quant_matrices(param) if qms is None else qms
    quant = np.stack([qms[0]["quant"], qms[1]["quant"]]).astype(np.int32)
    if not flags["use_adaptive_quant"]:
        return state.arrays_to_device(*_quant_arrays(qms), quant,
                                      device=device)
    args = (quant, param.resolved_min_quant_matrices(),
            (param.qdelta_max_luma, param.qdelta_max_chroma),
            param.quantization_bias, n_groups)
    rows = lambda_fit.lambda_fit(*histos, *args)
    return tuple((r[0] if shared else r).to(device) for r in rows)


def _host_matrices(quant, param: EncoderParam, b: int) -> list:
    """The per-image finalized matrices [B][2] for the headers, from the
    quant rows of `_fit_on_device` ([B, 2, 64], or [2, 64] shared by the
    b images): one fetch and the same finalize.  Read after a fetch that
    waited for the card, so that this one waits for nothing."""
    with span("fetch"):
        rows = quant.cpu().numpy()
    fin = spec.finalize_quant_matrix(rows,
                                     param.resolved_min_quant_matrices(),
                                     param.quantization_bias)
    if rows.ndim == 2:                              # shared
        return [[{k: v[g] for k, v in fin.items()} for g in range(2)]] * b
    return [[{k: v[i, g] for k, v in fin.items()} for g in range(2)]
            for i in range(rows.shape[0])]


def _jpegs(layout, param, per_qms, per_tables, scans, overflow,
           repack) -> list:
    """The host tail of a batch: image i's scan (its fetched stuffed bytes,
    or `repack(i)` where `overflow[i]`, a bucket overflow) in a JPEG with
    its matrices and tables."""
    with span("tail"):
        return [_assemble_jpeg(layout, param, qms, tables,
                               repack(i) if overflow[i] else scans[i])
                for i, (qms, tables) in enumerate(zip(per_qms, per_tables))]


def _encode_batch_optimized(src, src_kind: str, yuv_mode: int, w: int,
                            h: int, param: EncoderParam,
                            bits_per_pixel_budget: float,
                            share_statistics: bool = False):
    """Batched two-pass Huffman / adaptive-quant encode (methods 1, 3, 4;
    7 adds trellis quantization with the K.3 rate model).

    Per-image by default: per-image adaptive matrices and per-image
    optimal Huffman tables, byte-identical to per-image encodes
    (src/enc.cc:1517-1580).  share_statistics=True derives one table set
    and one tuned matrix pair from the whole batch's statistics.  Host
    traffic: one fetch of the frequencies (shared optimal tables), of the
    totals, of the used word columns, of the [B, 604] DHT description
    (per-image tables) and of the quant rows for the headers (the lambda
    fit runs on the card, or, for host histograms, on the host after one
    fetch of them)."""
    flags = method_flags(param.method)
    b = src.shape[0] if src_kind == "rgb" else src[0].shape[0]
    device = src.device if src_kind == "rgb" else src[0].device
    layout = pipeline.component_layout(yuv_mode, w, h)
    nb_blocks = tuple(layout.nb_blocks)
    n_groups = 2 if layout.nb_comps > 1 else 1
    stats_images = 1 if share_statistics else b

    coeffs, histos = _stage_batch_coeffs(
        src, src_kind, yuv_mode, w, h, flags["use_adaptive_quant"],
        stats_images)
    iq, ib, quant = _fit_on_device(histos, param, flags, n_groups,
                                   share_statistics, device)
    if flags["use_trellis"]:
        vlc_state, freqs = _stage_quantize_trellis(
            coeffs, iq, ib, quant, _cost_lens(device),
            flags["optimize_size"], nb_blocks, b, stats_images)
    else:
        vlc_state, freqs = _stage_batch_quantize(
            coeffs, iq, ib, flags["optimize_size"], nb_blocks, b,
            stats_images)
    del coeffs
    dc_luts, ac_luts, per_tables, desc_flat = _stage_tables(
        freqs, flags, n_groups, b, share_statistics, device)

    bucket = _bucket(layout, w, h, bits_per_pixel_budget)
    words, totals = _stage_batch_pack(vlc_state, dc_luts, ac_luts, b, bucket)
    totals_np, scans = fetch_scans(words, totals)
    if per_tables is None:
        with span("fetch"):
            flat_np = desc_flat.cpu().numpy()
        with span("tail"):
            per_tables = [huffman_device.tables_from_flat(flat_np, i,
                                                          n_groups)
                          for i in range(b)]

    per_img = _blocks_per_image(layout)
    return _jpegs(layout, param, _host_matrices(quant, param, b),
                  per_tables, scans, totals_np > bucket * 32,
                  lambda i: _repack_one(vlc_state, dc_luts, ac_luts, i,
                                        per_img))


def encode_core(src, iquant, ibias, dc_luts, ac_luts, *, yuv_mode: int,
                width: int, height: int, nb_blocks, src_kind: str = "rgb"):
    """The one-image form of `encode_batch_core`: RGB [H, W, 3] uint8 (or a
    (y, u, v) / (y,) tuple of [H, W] planes with src_kind="planes") ->
    ([bucket] int32 words holding uint32 stream bits, int32 exact total
    bits), with the bucket at the image's worst case of 64 words a block,
    so nothing is dropped."""
    if src_kind == "planes":
        src = tuple(p[None] for p in src)
    else:
        src = src[None]
    layout = pipeline.component_layout(yuv_mode, width, height)
    words, totals = encode_batch_core(
        src, iquant, ibias, dc_luts, ac_luts, yuv_mode=yuv_mode,
        width=width, height=height, nb_blocks=nb_blocks,
        bucket=_blocks_per_image(layout) * pack.WORDS_PER_BLOCK,
        src_kind=src_kind, n_images=1)
    return words[0], totals[0]


def fetch_stream(words: torch.Tensor, total_bits: int) -> np.ndarray:
    """Copy to the host only the meaningful prefix of one image's stream:
    [bucket] int32 device words -> [ceil(total_bits / 32)] uint32."""
    n_words = (int(total_bits) + 31) // 32
    with span("fetch"):
        return words[:n_words].contiguous().cpu().numpy().view(np.uint32)


def fetch_scans(words: torch.Tensor, totals: torch.Tensor):
    """[B, bucket] stream words and int32 totals, [B] (stream_concat's) or
    [B, k] with each image's total in the last column and other counts
    before it -> (the totals on the host, same shape, B stuffed scans as
    uint8 rows): `scan_stuff` where the words lie, one fetch of the totals
    and lengths, one of the used byte columns."""
    cols = totals.reshape(totals.shape[0], -1)
    scan, lengths = scan_stuff.scan_stuff(words, cols[:, -1].contiguous())
    with span("fetch"):
        host = torch.cat([cols, lengths[:, None]], dim=1).cpu().numpy()
    totals_np = host[:, :-1].reshape(totals.shape)
    return totals_np, fetch_scan_rows(scan, host[:, -1])


def fetch_scan_rows(scan: torch.Tensor, lengths_np) -> list:
    """`scan_stuff`'s [B, C] scans -> B host uint8 rows of lengths_np[i]
    bytes, from one fetch of the used columns."""
    n = int(lengths_np.max()) if lengths_np.size else 0
    with span("fetch"):
        host = scan[:, :n].contiguous().cpu().numpy()
    return [host[i, :k] for i, k in enumerate(lengths_np)]


def _scan_bytes(words: torch.Tensor, totals: torch.Tensor):
    """One image's [1, bucket] words and [1] total (within the bucket) ->
    its stuffed scan, a host uint8 row (`fetch_scans`)."""
    return fetch_scans(words, totals)[1][0]


def _jpeg_headers(layout, param, qms, tables) -> bytearray:
    """Every marker segment before the scan, SOS included."""
    out = bytearray()
    out += headers.write_app0()
    out += headers.write_app_markers(param.app_markers)
    out += headers.write_exif(param.exif)
    out += headers.write_iccp(param.iccp)
    out += headers.write_xmp(param.xmp, param.xmp_split_point)
    out += headers.write_dqt([qms[0]["quant"], qms[1]["quant"]],
                             layout.yuv_mode)
    out += headers.write_sof0(layout.width, layout.height, layout.nb_comps,
                              layout.block_dims, layout.quant_idx)
    out += headers.write_dht(tables, layout.nb_comps)
    out += headers.write_sos(layout.nb_comps, layout.quant_idx)
    return out


def _assemble_jpeg(layout, param, qms, tables, scan) -> bytes:
    """The JPEG of a stuffed scan (any bytes-like object), copied once."""
    return b"".join((_jpeg_headers(layout, param, qms, tables), scan,
                     headers.EOI))


# ---------------------------------------------------------------------------
# Single image: the staged one-image path and the entry points
# ---------------------------------------------------------------------------

def _encode_each_with_hook(src, src_kind: str, yuv_mode: int,
                           param: EncoderParam) -> list:
    """A custom search hook keeps its own state, so it cannot share the
    batched passes: each image runs the single-image search, with the same
    param and so the same hook object, as the JAX engine does."""
    dev = src.device if src_kind == "rgb" else src[0].device
    if src_kind == "rgb":
        return [encode_rgb(img, param, dev) for img in src]
    if len(src) == 1:
        return [encode_gray(y, param, dev) for y in src[0]]
    return [encode_yuv(y, u, v, yuv_mode == C.YUV_420, param, dev)
            for y, u, v in zip(*src)]


def _stage_pack(vlc_state, dc_luts, ac_luts):
    """One image's VLC fields + [2, ...] LUTs -> ([1, bucket] words, [1]
    total): vlc_pack, then stream_concat with the bucket at the image's
    worst case of 64 words a block."""
    n = vlc_state[1].shape[0]
    return _stage_batch_pack(vlc_state, dc_luts, ac_luts, 1,
                             n * pack.WORDS_PER_BLOCK)


def _stage_quant_pack(coeffs, iquant, ibias, dc_luts, ac_luts, nb_blocks):
    """One image's pass with tables fixed before it quantizes: the
    coefficients interleaved, then quant_pack and stream_concat with the
    bucket at the worst case -> ([1, bucket] words, [1] total)."""
    cinter, dc_codes, group = _interleave_coeffs(coeffs, iquant, ibias,
                                                 nb_blocks)
    words, bits = quant_pack.quant_pack(cinter, dc_codes, group, iquant,
                                        ibias, dc_luts, ac_luts)
    return stream_concat.stream_concat(words, bits, 1,
                                       cinter.shape[0] * pack.WORDS_PER_BLOCK)


def _stage_one_pass(coeffs, rows, flags, nb_blocks, n_groups: int,
                    lt_lens):
    """One image at the quantizer rows of `_fit_on_device` (iquant, bias,
    quant: [2, 64] int32 on its device), with K.3 tables or the optimal
    tables of its own statistics; method 7 quantizes through the trellis
    with the [2, 256] rate lengths lt_lens.  -> ([1, bucket] words, [1]
    total, the four HuffmanTables)."""
    device = coeffs[0].device
    iq, ib, quant = rows
    if not flags["optimize_size"]:           # methods 0 and 3
        tables = k3_default_tables()
        dcl, acl = state.arrays_to_device(*_host_luts(tables), device=device)
        return (*_stage_quant_pack(coeffs, iq, ib, dcl, acl, nb_blocks),
                tables)
    if flags["use_trellis"]:
        vlc_state, freqs = _stage_quantize_trellis(
            coeffs, iq, ib, quant, lt_lens, True, nb_blocks, 1, 1)
    else:
        vlc_state, freqs = _stage_batch_quantize(coeffs, iq, ib, True,
                                                 nb_blocks, 1, 1)
    dcl, acl, per_tables, _ = _stage_tables(freqs, flags, n_groups, 1, True,
                                            device)
    return (*_stage_pack(vlc_state, dcl, acl), per_tables[0])


def _encode_blocks_device(src, src_kind: str, yuv_mode: int, w: int, h: int,
                          param: EncoderParam) -> bytes:
    """The staged one-image encode (method 0 from planes, methods 1, 3, 4
    and 7) of a source on its device: `_encode_coeffs` over its
    coefficients."""
    flags = method_flags(param.method)
    coeffs, histos = _stage_batch_coeffs(src, src_kind, yuv_mode, w, h,
                                         flags["use_adaptive_quant"])
    return _encode_coeffs(coeffs, histos,
                          pipeline.component_layout(yuv_mode, w, h), param)


def _encode_coeffs(coeffs, histos, layout, param: EncoderParam) -> bytes:
    """One image's per-component coefficients (and, with adaptive
    quantization, its (luma, chroma) [64, bins] histograms, where the
    coefficients are) -> JPEG: one pass (`_stage_one_pass`: quant_pack for
    methods 0 and 3, vlc_pack after the quantize or the trellis for 1, 4
    and 7) at the rows of `_fit_on_device`, fitted on the card for a CUDA
    device; passes > 1 runs the single-image search, whether or not a
    target is set, as the JAX engine's `_encode_blocks_device` does."""
    flags = method_flags(param.method)
    nb_blocks = tuple(layout.nb_blocks)
    n_groups = 2 if layout.nb_comps > 1 else 1
    if param.passes > 1:
        from .engine_search import encode_search_one
        return encode_search_one(coeffs, histos, layout, param)
    device = coeffs[0].device
    rows = _fit_on_device(histos, param, flags, n_groups, True, device)
    lt_lens = _cost_lens(device) if flags["use_trellis"] else None
    words, totals, tables = _stage_one_pass(coeffs, rows, flags, nb_blocks,
                                            n_groups, lt_lens)
    with span("tail"):
        scan = _scan_bytes(words, totals)
        return _assemble_jpeg(layout, param,
                              _host_matrices(rows[2], param, 1)[0], tables,
                              scan)


@_request
def encode_rgb(rgb, param: Optional[EncoderParam] = None,
               device=None) -> bytes:
    """Encode one RGB uint8 image [H, W, 3] (numpy or torch) with any YUV
    mode; byte-identical to sjpeg_tpu.engine.encode_rgb.  YUV_AUTO picks
    the mode from the riskiness of the device copy; YUV_SHARP converts on
    the card and encodes the planes through encode_yuv.  Method 0 without
    a search runs the method-0 batch path with one image; the rest is
    staged."""
    param = param or EncoderParam()
    dev = resolve_device(device)
    h, w = rgb.shape[:2]
    _check_size(w, h)
    src = _to_device(rgb, dev)[None]
    yuv_mode = param.yuv_mode
    if yuv_mode == C.YUV_AUTO:
        yuv_mode = auto_modes(src)[0]
    if yuv_mode == C.YUV_SHARP:
        y, u, v = sharp_yuv.sharp_rgb_to_yuv420(src)
        return encode_yuv(y[0], u[0], v[0], True, param, dev)
    flags = method_flags(param.method)
    if not (flags["use_adaptive_quant"] or flags["optimize_size"]
            or _is_search(param)):
        return _encode_batch_src(src, "rgb", yuv_mode, w, h, param,
                                 bits_per_pixel_budget=math.inf)[0]
    return _encode_blocks_device(src, "rgb", yuv_mode, w, h, param)


@_request
def encode_gray(gray, param: Optional[EncoderParam] = None,
                device=None) -> bytes:
    """Encode one grayscale uint8 image [H, W] (YUV 4:0:0)."""
    param = param or EncoderParam()
    dev = resolve_device(device)
    h, w = gray.shape
    _check_size(w, h)
    return _encode_blocks_device((_to_device(gray, dev)[None],), "planes",
                                 C.YUV_400, w, h, param)


@_request
def encode_yuv(y, u, v, is_420: bool, param: Optional[EncoderParam] = None,
               device=None) -> bytes:
    """Encode one planar YUV image: y [H, W] uint8 plus chroma planes
    ([ceil(H/2), ceil(W/2)] when `is_420`, else full size)."""
    param = param or EncoderParam()
    dev = resolve_device(device)
    h, w = y.shape
    _check_size(w, h)
    src = tuple(_to_device(p, dev)[None] for p in (y, u, v))
    return _encode_blocks_device(src, "planes",
                                 C.YUV_420 if is_420 else C.YUV_444, w, h,
                                 param)


# ---------------------------------------------------------------------------
# Serving wrappers
# ---------------------------------------------------------------------------

def _upload(batch, device: torch.device) -> torch.Tensor:
    """A host batch -> the device through pinned memory, without waiting:
    the copy is queued on the current stream."""
    t = batch if isinstance(batch, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(batch))
    with span("upload"):
        if t.device.type == "cpu":
            t = t.pin_memory()
        return t.to(device, non_blocking=True)


def encode_pipelined(batches, param: Optional[EncoderParam] = None,
                     depth: int = 2, device=None, **kw):
    """Pipelined batched encoding for sustained throughput.

    Runs up to `depth` `encode_batch` calls at once on worker threads, each
    worker on its own CUDA stream: a batch's upload (through pinned host
    memory), kernels, result fetches and host assembly overlap another
    batch's, and each fetch waits on its own stream only.
    `batches` is an iterable of [B, H, W, 3] uint8 arrays (or whatever
    `encode_batch` takes); yields each batch's list of JPEG byte strings,
    in order.  Keyword arguments go to `encode_batch`."""
    dev = resolve_device(device)
    local = threading.local()

    def work(batch):
        with span("request"):
            if dev.type != "cuda":
                return encode_batch(batch, param, device=dev, **kw)
            if not hasattr(local, "stream"):
                local.stream = torch.cuda.Stream(dev)
            with torch.cuda.stream(local.stream):
                return encode_batch(_upload(batch, dev), param, device=dev,
                                    **kw)

    pend = collections.deque()
    with ThreadPoolExecutor(max_workers=max(depth, 1)) as pool:
        for batch in batches:
            pend.append(pool.submit(work, batch))
            if len(pend) > depth:
                yield pend.popleft().result()
        while pend:
            yield pend.popleft().result()


def encode_many(images, param: Optional[EncoderParam] = None, device=None,
                **kw) -> list:
    """Encode a sequence of RGB uint8 images [H, W, 3] whose shapes may
    differ.  Images are grouped by shape and each group runs as one
    `encode_batch` (JPEG geometry fixes every stage's shapes); results come
    back in input order.  Keyword arguments go to `encode_batch`."""
    groups = {}
    for i, img in enumerate(images):
        groups.setdefault(tuple(img.shape), []).append(i)
    out = [None] * len(images)
    for idxs in groups.values():
        with span("request"):
            sub = torch.stack([torch.as_tensor(images[i]) for i in idxs])
            jpegs = encode_batch(sub, param, device=device, **kw)
        for i, jpeg in zip(idxs, jpegs):
            out[i] = jpeg
    return out
