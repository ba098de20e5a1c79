"""JPEG encode on the GPU: the port's engine.

Batched paths, with the JAX engine's bucket formula and the same output
bytes.  Method 0 (K.3 tables, no adaptive quantization), fused:

  colour conversion + blockize            ops/colorspace   [torch]
  DC predictor chain                      ops/fdct.fdct_dc, ops/vlc
  fDCT + quantize + VLC + per-block pack  ops/sample_pack  [CUDA kernel 1]
  per-image stream concatenation          ops/stream_concat [CUDA kernel 2]
  fetch, stuffing, markers                bitio, headers   [host]

Methods 1, 3, 4 and 7 (two-pass optimal Huffman and/or adaptive
quantization, method 7 with trellis quantization; per-image statistics, or
one set from the whole batch with share_statistics=True), staged as the
JAX engine stages them off the relay (`_encode_batch_optimized`):

  colour + fDCT + coefficient histograms  _stage_batch_coeffs, ops/fdct
                                                           [CUDA kernel 6]
  lambda fit per image and table group    adaptive.analyse_histo [host]
  quantize + MCU interleave + VLC fields
    + DC chain + symbol frequencies       _stage_batch_quantize [torch]
  or, method 7:
    MCU interleave + DC chain             _interleave_coeffs [torch]
    trellis quantization                  ops/trellis      [CUDA kernel 5]
    VLC fields + symbol frequencies       _stage_trellis_post [torch]
  optimal tables, one launch a build      ops/huffman_device,
                                          ops/merge_codesizes [CUDA kernel 4]
  Huffman lookup + per-block pack         ops/vlc_pack     [CUDA kernel 3]
  per-image stream concatenation          ops/stream_concat [CUDA kernel 2]
  fetch, stuffing, markers                bitio, headers   [host]

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
the hook on the host).  `encode_pipelined` and `encode_many` are the
serving wrappers over `encode_batch`.

Every entry point takes `device`: None means "cuda", and it raises when
CUDA is missing.  With device="cpu" the kernels' plain PyTorch versions
run instead, which is how the tests hold the port against the JAX package.
Configurations the port does not run yet raise NotImplementedError naming
their ROADMAP item.
"""

import collections
import math
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from . import constants as C
from . import headers, pipeline, spec, state
from .adaptive import analyse_histo
from .bitio import words_to_scan
from .huffman import (build_code_lut, k3_default_tables,
                      optimal_tables_from_freqs, trellis_cost_lens)
from .ops import colorspace, fdct, huffman_device, pack, quant_pack, \
    quantize, sample_pack, stream_concat, trellis, vlc, vlc_pack
from .params import TARGET_NONE, EncoderParam, method_flags


def resolve_device(device=None) -> torch.device:
    """None -> "cuda"; raises if CUDA is asked for and missing."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; the port runs on the GPU "
                           "unless the caller passes device='cpu'")
    return dev


def _is_search(param: EncoderParam) -> bool:
    """A target-size / target-PSNR search runs when passes > 1 and a target
    is set; passes > 1 alone encodes once, as the JAX engine does."""
    return param.passes > 1 and param.target_mode != TARGET_NONE


def _check_supported(param: EncoderParam, yuv_mode: int) -> None:
    if yuv_mode in (C.YUV_AUTO, C.YUV_SHARP):
        raise NotImplementedError(
            "YUV_AUTO and YUV_SHARP are not ported yet (ROADMAP A8); pin "
            "YUV_420, YUV_444 or YUV_400")


def _check_size(w: int, h: int) -> None:
    if not (0 < w <= C.MAX_DIMENSION and 0 < h <= C.MAX_DIMENSION):
        raise ValueError(f"image size {w} x {h} is outside 1..."
                         f"{C.MAX_DIMENSION}")


def _to_device(x, device: torch.device) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))
    if t.dtype != torch.uint8:
        raise TypeError(f"expected uint8 samples, got {t.dtype}")
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


def encode_batch(rgbs, param: Optional[EncoderParam] = None,
                 bits_per_pixel_budget: float = 4.0,
                 share_statistics: bool = False, device=None):
    """Encode a uint8 batch [B, H, W, 3] (numpy or torch) with pinned
    YUV_420, YUV_444 or YUV_400 and method 0, 1, 3, 4 or 7.  Returns a list
    of complete JPEG byte strings, byte-identical to
    sjpeg_tpu.engine.encode_batch.

    Methods 1, 3, 4 and 7 optimize per image by default (per-image adaptive
    matrices and per-image optimal Huffman tables, as the reference
    does); share_statistics=True derives one table set / tuned matrix
    pair from the whole batch's statistics instead.  With passes > 1 and
    set_target_size / set_target_psnr, each image runs its own search
    (share_statistics does not apply)."""
    param = param or EncoderParam()
    dev = resolve_device(device)
    h, w = rgbs.shape[1:3]
    return _encode_batch_src(_to_device(rgbs, dev), "rgb", param.yuv_mode,
                             w, h, param, bits_per_pixel_budget,
                             share_statistics)


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


def encode_batch_nv12(y, uv, param: Optional[EncoderParam] = None,
                      bits_per_pixel_budget: float = 4.0,
                      share_statistics: bool = False, device=None):
    """Batched semi-planar NV12 encode: y [B, H, W], uv
    [B, ceil(H/2), ceil(W/2), 2] interleaved U/V; the split is a device
    slice."""
    uv = _to_device(uv, resolve_device(device))
    return encode_batch_yuv(y, uv[..., 0], uv[..., 1], True, param,
                            bits_per_pixel_budget, share_statistics, device)


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
    dc = np.stack([build_code_lut(tables[g], 16) for g in range(2)])
    ac = np.stack([build_code_lut(tables[2 + g], 256) for g in range(2)])
    return dc, ac


def _encode_batch_src(src, src_kind: str, yuv_mode: int, w: int, h: int,
                      param: EncoderParam,
                      bits_per_pixel_budget: float = 4.0,
                      share_statistics: bool = False):
    """Shared batched encode over a device source (RGB batch or
    component plane tuple)."""
    _check_supported(param, yuv_mode)
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
    totals_np = totals.cpu().numpy()
    words_np = fetch_streams_batch(words, totals_np)

    out = []
    for i in range(b):
        total_bits = int(totals_np[i])
        if total_bits > bucket * 32:      # bucket overflow
            out.append(_host_fallback_one(src, src_kind, i, yuv_mode, w, h,
                                          param))
            continue
        scan = _finalize_scan_bytes(words_np[i], total_bits)
        out.append(_assemble_jpeg(layout, param, qms, tables, scan))
    return out


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


def _fit_quantizers(histos, param: EncoderParam, n_groups: int, b: int,
                    share_statistics: bool):
    """One fetch of the histograms, then the host lambda fit per image (or
    once for the batch) and table group -> (per-image finalized quant
    matrices [B][2], iquant and bias rows: [2, 64] shared or [B, 2, 64]
    per image)."""
    base_qms = _quant_matrices(param)
    hh = torch.stack(histos).cpu().numpy().astype(np.int64)

    def tune(histo_pair):
        return _tuned_qms(base_qms, histo_pair, param, n_groups)

    if share_statistics:
        qms = tune(hh.reshape(2, 64, -1))
        return [qms] * b, _quant_arrays(qms)
    hh = hh.reshape(2, b, 64, -1)
    # the NumPy fit releases the GIL: thread it over the images
    with ThreadPoolExecutor(max_workers=min(8, b)) as pool:
        per_qms = list(pool.map(lambda i: tune(hh[:, i]), range(b)))
    arrays = [_quant_arrays(qms) for qms in per_qms]
    return per_qms, tuple(np.stack(a) for a in zip(*arrays))


def _tuned_qms(qms, histo_pair, param: EncoderParam, n_groups: int):
    """Finalized (luma, chroma) matrices -> the same after the host lambda
    fit of each table group, chroma first as the reference runs it, over
    the group's [64, bins] histogram."""
    min_qmats = param.resolved_min_quant_matrices()
    qms = list(qms)
    for g in range(n_groups - 1, -1, -1):
        qdelta_max = (param.qdelta_max_luma if g == 0
                      else param.qdelta_max_chroma)
        tuned = analyse_histo(histo_pair[g], qms[g]["quant"], min_qmats[g],
                              qdelta_max)
        qms[g] = spec.finalize_quant_matrix(tuned, min_qmats[g],
                                            param.quantization_bias)
    return qms


def _interleave_quantized(coeffs, iquant, ibias, nb_blocks,
                          n_images: int = 1):
    """Quantize per component, interleave into MCU order, and derive the
    zigzag VLC fields (int32 [N, 64] run/size/code, bool nz, [N] last),
    the DC codes (the predictor resets per image) and each row's table
    group.  iquant/ibias: [2, 64] shared, or [B, 2, 64] per image."""
    qbs = []
    for c, coef in enumerate(coeffs):
        g = 0 if c == 0 else 1
        if iquant.dim() == 3:
            qbs.append(quantize.per_image_quantize(
                coef, iquant[:, g], ibias[:, g], n_images))
        else:
            qbs.append(quantize.quantize_blocks(coef, iquant[g], ibias[g]))
    n_mcu = qbs[0].shape[0] // nb_blocks[0]
    qinter = torch.cat([qb.reshape(n_mcu, nb, 64)
                        for qb, nb in zip(qbs, nb_blocks)],
                       dim=1).reshape(-1, 64)
    rl = vlc.run_levels(qinter, torch.int32)

    dcv = qinter[:, 0].reshape(n_mcu, sum(nb_blocks))
    dc_cols, col = [], 0
    for nb in nb_blocks:
        codes = vlc.dc_diff_codes(dcv[:, col:col + nb].reshape(-1), n_images)
        dc_cols.append(codes.reshape(n_mcu, nb))
        col += nb
    dc_codes = torch.cat(dc_cols, dim=1).reshape(-1)
    return rl, dc_codes, _slot_groups(nb_blocks, n_mcu, qinter.device)


def _grouped_stats(rl, dc_codes, group, n_images: int = 1):
    """Per-table-group symbol frequencies from interleaved VLC fields:
    int32 ([B, 2, 12] DC, [B, 2, 256] AC) per image (rows image-major,
    equal blocks per image), unbatched ([2, 12], [2, 256]) when
    n_images == 1.  AC counts include a ZRL at 0xF0 for every 16 zeros
    of a run and an EOB at 0x00 for each block not ending at position 63.
    Integer scatter-adds are exact: no one-hot matmul."""
    nz = rl["nz"]
    n = nz.shape[0]
    dev = nz.device
    img = torch.arange(n_images, device=dev).repeat_interleave(n // n_images)
    tab = img * 2 + group                                  # [N] table
    sym = ((rl["run"] & 15) << 4) | rl["size"]             # 0 where not nz
    freq_ac = torch.zeros(n_images * 512, dtype=torch.int32, device=dev)
    freq_ac.scatter_add_(0, (tab[:, None] * 256 + sym).reshape(-1),
                         nz.to(torch.int32).reshape(-1))
    esc = torch.where(nz, rl["run"] >> 4, 0).sum(dim=1, dtype=torch.int32)
    freq_ac.scatter_add_(0, tab * 256 + 0xF0, esc)
    freq_ac.scatter_add_(0, tab * 256, (rl["last"] < 63).to(torch.int32))

    # DC: the JAX one-hot over 26 = 2 x 13 size bins drops larger indices
    dci = group * 13 + (dc_codes & 0x0F)
    dump = n_images * 26
    idx = torch.where(dci < 26, img * 26 + dci, dump)
    freq_dc = torch.zeros(dump + 1, dtype=torch.int32, device=dev)
    freq_dc.scatter_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
    freq_dc = freq_dc[:dump].reshape(n_images, 2, 13)[:, :, :12]
    freq_ac = freq_ac.reshape(n_images, 2, 256)
    if n_images == 1:
        return freq_dc[0], freq_ac[0]
    return freq_dc, freq_ac


def _stage_batch_quantize(coeffs, iquant, ibias, with_stats: bool,
                          nb_blocks, n_images: int, stats_images: int):
    """-> ((VLC fields, DC codes, groups), frequencies or None)."""
    rl, dc_codes, group = _interleave_quantized(coeffs, iquant, ibias,
                                                nb_blocks, n_images)
    if not with_stats:
        return (rl, dc_codes, group), None
    return (rl, dc_codes, group), _grouped_stats(rl, dc_codes, group,
                                                 stats_images)


def _clamped_quant(per_qms, shared: bool) -> np.ndarray:
    """The clamped quant matrices the trellis's lambda and distortion read:
    [2, 64] shared, or [B, 2, 64] per image."""
    if shared:
        return np.stack([per_qms[0][0]["quant"], per_qms[0][1]["quant"]])
    return np.stack([[q["quant"] for q in qms] for qms in per_qms])


def _interleave_coeffs(coeffs, iquant, ibias, nb_blocks, n_images: int = 1):
    """MCU-interleave the per-component coefficients (for quant_pack and
    the trellis, which quantize per block), with each block's DC diff code
    from the plain bias quantizer of the DC lane alone (the predictor
    resets per image; the trellis's own DC rule, src/enc.cc:763-766) and
    its table group.  iquant/ibias: [2, 64] shared or [B, 2, 64] per image
    -> ([N, 64] int32, [N] int32 DC codes, [N] int32 groups)."""
    n_mcu = coeffs[0].shape[0] // nb_blocks[0]
    cinter = torch.cat([co.reshape(n_mcu, nb, 64)
                        for co, nb in zip(coeffs, nb_blocks)],
                       dim=1).reshape(-1, 64)
    return (cinter, _dc_codes(coeffs, iquant, ibias, nb_blocks, n_images),
            _slot_groups(nb_blocks, n_mcu, cinter.device))


def _dc_codes(coeffs, iquant, ibias, nb_blocks, n_images: int = 1):
    """MCU-interleaved [N] int32 DC diff codes of per-component
    coefficients under the plain bias quantizer (src/enc.cc:482-499; the
    predictor resets per image).  iquant/ibias: [2, 64] shared or
    [B, 2, 64] per image."""
    n_mcu = coeffs[0].shape[0] // nb_blocks[0]
    dc_cols = []
    for c, (co, nb) in enumerate(zip(coeffs, nb_blocks)):
        g = 0 if c == 0 else 1
        if iquant.dim() == 3:
            dcq = quantize.quantize_values(co[:, 0].reshape(n_images, -1),
                                           iquant[:, g, 0, None],
                                           ibias[:, g, 0, None])
        else:
            dcq = quantize.quantize_values(co[:, 0], iquant[g, 0],
                                           ibias[g, 0])
        codes = vlc.dc_diff_codes(dcq.reshape(-1), n_images)
        dc_cols.append(codes.reshape(n_mcu, nb))
    return torch.cat(dc_cols, dim=1).reshape(-1)


def _stage_trellis_post(qinter, dc_codes, group, with_stats: bool,
                        stats_images: int):
    """Trellis levels -> ((int32 VLC fields, DC codes, groups),
    frequencies or None)."""
    rl = vlc.run_levels(qinter, torch.int32)
    if not with_stats:
        return (rl, dc_codes, group), None
    return (rl, dc_codes, group), _grouped_stats(rl, dc_codes, group,
                                                 stats_images)


def _stage_quantize_trellis(coeffs, iquant, ibias, quant, lt_lens,
                            with_stats: bool, nb_blocks, n_images: int,
                            stats_images: int):
    """Trellis quantize + interleave + VLC fields (+ frequencies): the
    method-7 counterpart of `_stage_batch_quantize` (src/enc.cc:692-761).
    iquant/ibias/quant: [2, 64] shared or [B, 2, 64] per image; lt_lens:
    [2, 256] or [B, 2, 256] AC code lengths, the rate model."""
    cinter, dc_codes, group = _interleave_coeffs(coeffs, iquant, ibias,
                                                 nb_blocks, n_images)
    qinter = trellis.trellis_quantize(cinter, iquant, ibias, quant, group,
                                      lt_lens, n_images)
    del cinter
    return _stage_trellis_post(qinter, dc_codes, group, with_stats,
                               stats_images)


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
        tables = optimal_tables_from_freqs(
            *(f.cpu().numpy().astype(np.int64) for f in freqs), n_groups)
        if n_groups == 1:
            defaults = k3_default_tables()
            tables[1], tables[3] = defaults[1], defaults[3]
    else:
        tables = k3_default_tables()
    dc_luts, ac_luts = state.arrays_to_device(*_host_luts(tables),
                                              device=device)
    return dc_luts, ac_luts, [tables] * b, None


def _stage_batch_pack(vlc_state, dc_luts, ac_luts, n_images: int,
                      bucket: int):
    """VLC fields + LUTs ([2, ...] shared or [B, 2, ...] per image) ->
    ([n_images, bucket] int32 words, [n_images] int32 exact totals)."""
    rl, dc_codes, group = vlc_state
    words, bits = vlc_pack.vlc_pack(rl["run"], rl["size"], rl["code"],
                                    dc_codes, group, dc_luts, ac_luts)
    return stream_concat.stream_concat(words, bits, n_images, bucket)


def _repack_one(vlc_state, dc_luts, ac_luts, i: int, per_img: int) -> bytes:
    """Scan bytes of image i after a bucket overflow: its rows of the
    already chosen VLC state, packed again with its own LUTs (and its
    batch's, when shared) into a bucket of 64 words a block, which cannot
    overflow.  A fresh single-image encode would derive other tables when
    they came from the whole batch."""
    rows = slice(i * per_img, (i + 1) * per_img)
    rl, dc_codes, group = vlc_state
    state_i = ({k: v[rows] for k, v in rl.items()}, dc_codes[rows],
               group[rows])
    if dc_luts.dim() == 3:
        dc_luts, ac_luts = dc_luts[i], ac_luts[i]
    return _scan_bytes(*_stage_batch_pack(state_i, dc_luts, ac_luts, 1,
                                          per_img * pack.WORDS_PER_BLOCK))


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
    traffic: one fetch of the histograms (adaptive), of the frequencies
    (shared optimal tables), of the totals, of the used word columns and
    of the [B, 604] DHT description (per-image tables)."""
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
    if flags["use_adaptive_quant"]:
        per_qms, quant = _fit_quantizers(histos, param, n_groups, b,
                                         share_statistics)
    else:
        per_qms = [_quant_matrices(param)] * b
        quant = _quant_arrays(per_qms[0])
    iq, ib = state.arrays_to_device(*quant, device=device)
    if flags["use_trellis"]:          # methods 7 and 8 fit adaptively
        qq, lt_lens = state.arrays_to_device(
            _clamped_quant(per_qms, share_statistics), trellis_cost_lens(),
            device=device)
        vlc_state, freqs = _stage_quantize_trellis(
            coeffs, iq, ib, qq, lt_lens, flags["optimize_size"], nb_blocks,
            b, stats_images)
    else:
        vlc_state, freqs = _stage_batch_quantize(
            coeffs, iq, ib, flags["optimize_size"], nb_blocks, b,
            stats_images)
    del coeffs
    dc_luts, ac_luts, per_tables, desc_flat = _stage_tables(
        freqs, flags, n_groups, b, share_statistics, device)

    bucket = _bucket(layout, w, h, bits_per_pixel_budget)
    words, totals = _stage_batch_pack(vlc_state, dc_luts, ac_luts, b, bucket)
    totals_np = totals.cpu().numpy()
    words_np = fetch_streams_batch(words, totals_np)
    if per_tables is None:
        flat_np = desc_flat.cpu().numpy()
        per_tables = [huffman_device.tables_from_flat(flat_np, i, n_groups)
                      for i in range(b)]

    out = []
    for i in range(b):
        total_bits = int(totals_np[i])
        if total_bits > bucket * 32:      # bucket overflow: re-pack alone
            scan = _repack_one(vlc_state, dc_luts, ac_luts, i,
                               _blocks_per_image(layout))
        else:
            scan = _finalize_scan_bytes(words_np[i], total_bits)
        out.append(_assemble_jpeg(layout, param, per_qms[i], per_tables[i],
                                  scan))
    return out


def fetch_streams_batch(words: torch.Tensor, totals_np) -> np.ndarray:
    """Copy to the host only the word columns that some image uses:
    [B, bucket] int32 device words -> [B, ncols] uint32."""
    nmax = -(-int(totals_np.max()) // 32) if totals_np.size else 0
    ncols = max(1, min(nmax, words.shape[1]))
    return words[:, :ncols].contiguous().cpu().numpy().view(np.uint32)


def _finalize_scan_bytes(words: np.ndarray, total_bits: int) -> bytes:
    """Host word stream -> stuffed entropy-coded byte segment."""
    return words_to_scan(words[: (total_bits + 31) // 32], total_bits)


def _scan_bytes(words: torch.Tensor, totals: torch.Tensor) -> bytes:
    """One image's [1, bucket] device words and [1] total (within the
    bucket) -> its stuffed scan: a fetch of the total, then of the used
    words."""
    total_bits = int(totals[0])
    return _finalize_scan_bytes(fetch_streams_batch(
        words, np.array([total_bits]))[0], total_bits)


def _assemble_jpeg(layout, param, qms, tables, scan: bytes) -> bytes:
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
    out += scan
    out += headers.EOI
    return bytes(out)


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


def _stage_coeffs(src, src_kind: str, yuv_mode: int, width: int,
                  height: int, with_histo: bool):
    """One image (a batch of one) -> per-component [N_c, 64] coefficients
    and, with_histo, one fetch of its (luma, chroma) histograms as a
    [2, 64, bins] int64 array."""
    coeffs, histos = _stage_batch_coeffs(src, src_kind, yuv_mode, width,
                                         height, with_histo, 1)
    if histos is not None:
        histos = torch.stack(histos).cpu().numpy().astype(np.int64)
    return coeffs, histos


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


def _stage_one_pass(coeffs, qms, flags, nb_blocks, n_groups: int, lt_lens):
    """One image at fixed finalized matrices `qms`, with K.3 tables or the
    optimal tables of its own statistics; method 7 quantizes through the
    trellis with the [2, 256] rate lengths lt_lens.  -> ([1, bucket] words,
    [1] total, the four HuffmanTables)."""
    device = coeffs[0].device
    iq, ib = state.arrays_to_device(*_quant_arrays(qms), device=device)
    if not flags["optimize_size"]:           # methods 0 and 3
        tables = k3_default_tables()
        dcl, acl = state.arrays_to_device(*_host_luts(tables), device=device)
        return (*_stage_quant_pack(coeffs, iq, ib, dcl, acl, nb_blocks),
                tables)
    if flags["use_trellis"]:
        (qq,) = state.arrays_to_device(_clamped_quant([qms], True),
                                       device=device)
        vlc_state, freqs = _stage_quantize_trellis(
            coeffs, iq, ib, qq, lt_lens, True, nb_blocks, 1, 1)
    else:
        vlc_state, freqs = _stage_batch_quantize(coeffs, iq, ib, True,
                                                 nb_blocks, 1, 1)
    dcl, acl, per_tables, _ = _stage_tables(freqs, flags, n_groups, 1, True,
                                            device)
    return (*_stage_pack(vlc_state, dcl, acl), per_tables[0])


def _encode_blocks_device(src, src_kind: str, yuv_mode: int, w: int, h: int,
                          param: EncoderParam) -> bytes:
    """The staged one-image encode (method 0 from planes, methods 1, 3, 4
    and 7); passes > 1 runs the single-image search, whether or not a
    target is set, as the JAX engine's `_encode_blocks_device` does."""
    flags = method_flags(param.method)
    layout = pipeline.component_layout(yuv_mode, w, h)
    nb_blocks = tuple(layout.nb_blocks)
    n_groups = 2 if layout.nb_comps > 1 else 1
    coeffs, histos = _stage_coeffs(src, src_kind, yuv_mode, w, h,
                                   flags["use_adaptive_quant"])
    if param.passes > 1:
        from .engine_search import encode_search_one
        return encode_search_one(coeffs, histos, layout, param)
    qms = _quant_matrices(param)
    if flags["use_adaptive_quant"]:
        qms = _tuned_qms(qms, histos, param, n_groups)
    lt_lens = (state.arrays_to_device(trellis_cost_lens(),
                                      device=coeffs[0].device)[0]
               if flags["use_trellis"] else None)
    words, totals, tables = _stage_one_pass(coeffs, qms, flags, nb_blocks,
                                            n_groups, lt_lens)
    return _assemble_jpeg(layout, param, qms, tables,
                          _scan_bytes(words, totals))


def encode_rgb(rgb, param: Optional[EncoderParam] = None,
               device=None) -> bytes:
    """Encode one RGB uint8 image [H, W, 3] (numpy or torch) with pinned
    YUV_420, YUV_444 or YUV_400; byte-identical to
    sjpeg_tpu.engine.encode_rgb.  Method 0 without a search runs the
    method-0 batch path with one image; the rest is staged."""
    param = param or EncoderParam()
    dev = resolve_device(device)
    h, w = rgb.shape[:2]
    _check_supported(param, param.yuv_mode)
    _check_size(w, h)
    src = _to_device(rgb, dev)[None]
    flags = method_flags(param.method)
    if not (flags["use_adaptive_quant"] or flags["optimize_size"]
            or _is_search(param)):
        return _encode_batch_src(src, "rgb", param.yuv_mode, w, h, param,
                                 bits_per_pixel_budget=math.inf)[0]
    return _encode_blocks_device(src, "rgb", param.yuv_mode, w, h, param)


def encode_gray(gray, param: Optional[EncoderParam] = None,
                device=None) -> bytes:
    """Encode one grayscale uint8 image [H, W] (YUV 4:0:0)."""
    param = param or EncoderParam()
    dev = resolve_device(device)
    h, w = gray.shape
    _check_size(w, h)
    return _encode_blocks_device((_to_device(gray, dev)[None],), "planes",
                                 C.YUV_400, w, h, param)


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
        sub = torch.stack([torch.as_tensor(images[i]) for i in idxs])
        for i, jpeg in zip(idxs, encode_batch(sub, param, device=device,
                                              **kw)):
            out[i] = jpeg
    return out
