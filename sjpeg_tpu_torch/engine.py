"""Batched method-0 JPEG encode on the GPU: the port's main path.

The fixed-table path of the JAX engine (no adaptive quantization, no
two-pass Huffman, K.3 default tables), with the same bucket formula and
the same output bytes:

  colour conversion + blockize            ops/colorspace   [torch]
  DC predictor chain                      ops/fdct.fdct_dc, ops/vlc
  fDCT + quantize + VLC + per-block pack  ops/sample_pack  [CUDA kernel 1]
  per-image stream concatenation          ops/stream_concat [CUDA kernel 2]
  fetch, stuffing, markers                bitio, headers   [host]

Every entry point takes `device`: None means "cuda", and it raises when
CUDA is missing.  With device="cpu" the kernels' plain PyTorch versions
run instead, which is how the tests hold the port against the JAX package.
Configurations the port does not run yet raise NotImplementedError naming
their ROADMAP item.
"""

import math
from typing import Optional

import numpy as np
import torch

from . import constants as C
from . import headers, pipeline, spec, state
from .bitio import words_to_scan
from .huffman import build_code_lut, k3_default_tables
from .ops import colorspace, fdct, pack, quantize, sample_pack, \
    stream_concat, vlc
from .params import EncoderParam


def resolve_device(device=None) -> torch.device:
    """None -> "cuda"; raises if CUDA is asked for and missing."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; the port runs on the GPU "
                           "unless the caller passes device='cpu'")
    return dev


def _check_supported(param: EncoderParam, yuv_mode: int) -> None:
    if param.method != 0:
        raise NotImplementedError(
            f"method {param.method} is not ported yet (ROADMAP A5: methods "
            "1-6, A6: methods 7/8); the port runs method 0: "
            "huffman_compress=False, adaptive_quantization=False")
    if param.passes > 1:
        raise NotImplementedError(
            "target-size / target-PSNR search (passes > 1) is not ported "
            "yet (ROADMAP A7)")
    if yuv_mode in (C.YUV_AUTO, C.YUV_SHARP):
        raise NotImplementedError(
            "YUV_AUTO and YUV_SHARP are not ported yet (ROADMAP A8); pin "
            "YUV_420, YUV_444 or YUV_400")


def _to_device(x, device: torch.device) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))
    if t.dtype != torch.uint8:
        raise TypeError(f"expected uint8 samples, got {t.dtype}")
    return t.to(device)


def _interleave_samples(blocks, iquant, ibias, nb_blocks, n_images: int = 1):
    """MCU-interleave the component sample blocks for sample_pack, with
    each block's DC diff code and table group.

    The DC predictor (src/enc.cc:482-499) chains across blocks, so the
    quantized DC of every block is computed here, ahead of the per-block
    kernel, through the collapsed fDCT chain (ops/fdct.fdct_dc).  Samples
    travel as int16, which holds RGB chroma's +128 exactly."""
    mcu_blocks = sum(nb_blocks)
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
    slot_group = torch.zeros(mcu_blocks, dtype=torch.int32,
                             device=sinter.device)
    slot_group[nb_blocks[0]:] = 1
    return sinter, dc_codes, slot_group.repeat(n_mcu)


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
                 bits_per_pixel_budget: float = 4.0, device=None):
    """Encode a uint8 batch [B, H, W, 3] (numpy or torch) with pinned
    YUV_420, YUV_444 or YUV_400 and method 0.  Returns a list of complete
    JPEG byte strings, byte-identical to sjpeg_tpu.engine.encode_batch."""
    param = param or EncoderParam()
    dev = resolve_device(device)
    h, w = rgbs.shape[1:3]
    return _encode_batch_src(_to_device(rgbs, dev), "rgb", param.yuv_mode,
                             w, h, param, bits_per_pixel_budget)


def encode_batch_yuv(y, u, v, is_420: bool,
                     param: Optional[EncoderParam] = None,
                     bits_per_pixel_budget: float = 4.0, device=None):
    """Batched planar-YUV encode: y [B, H, W] uint8 plus chroma planes
    ([B, ceil(H/2), ceil(W/2)] when `is_420`, else full size)."""
    param = param or EncoderParam()
    dev = resolve_device(device)
    h, w = y.shape[1:3]
    src = tuple(_to_device(p, dev) for p in (y, u, v))
    return _encode_batch_src(src, "planes",
                             C.YUV_420 if is_420 else C.YUV_444, w, h,
                             param, bits_per_pixel_budget)


def encode_batch_gray(y, param: Optional[EncoderParam] = None,
                      bits_per_pixel_budget: float = 4.0, device=None):
    """Batched grayscale encode: y [B, H, W] uint8 (YUV 4:0:0)."""
    param = param or EncoderParam()
    dev = resolve_device(device)
    h, w = y.shape[1:3]
    return _encode_batch_src((_to_device(y, dev),), "planes", C.YUV_400,
                             w, h, param, bits_per_pixel_budget)


def encode_batch_nv12(y, uv, param: Optional[EncoderParam] = None,
                      bits_per_pixel_budget: float = 4.0, device=None):
    """Batched semi-planar NV12 encode: y [B, H, W], uv
    [B, ceil(H/2), ceil(W/2), 2] interleaved U/V; the split is a device
    slice."""
    uv = _to_device(uv, resolve_device(device))
    return encode_batch_yuv(y, uv[..., 0], uv[..., 1], True, param,
                            bits_per_pixel_budget, device)


def encode_batch_nv21(y, vu, param: Optional[EncoderParam] = None,
                      bits_per_pixel_budget: float = 4.0, device=None):
    """Batched semi-planar NV21 encode (V/U interleaved chroma)."""
    vu = _to_device(vu, resolve_device(device))
    return encode_batch_yuv(y, vu[..., 1], vu[..., 0], True, param,
                            bits_per_pixel_budget, device)


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
                      bits_per_pixel_budget: float = 4.0):
    """Shared batched encode over a device source (RGB batch or
    component plane tuple)."""
    _check_supported(param, yuv_mode)
    if not (0 < w <= C.MAX_DIMENSION and 0 < h <= C.MAX_DIMENSION):
        raise ValueError(f"image size {w} x {h} is outside 1..."
                         f"{C.MAX_DIMENSION}")
    b = src.shape[0] if src_kind == "rgb" else src[0].shape[0]
    device = src.device if src_kind == "rgb" else src[0].device
    layout = pipeline.component_layout(yuv_mode, w, h)
    qms = _quant_matrices(param)
    tables = k3_default_tables()
    iq, ib, dc_luts, ac_luts = state.tables_from_numpy(
        *_quant_arrays(qms), *_host_luts(tables), device)

    n_blocks = layout.mb_w * layout.mb_h * sum(layout.nb_blocks)
    max_words = n_blocks * pack.WORDS_PER_BLOCK
    bucket = int(min(max_words,
                     max(4096, w * h * bits_per_pixel_budget / 32)))

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


def fetch_streams_batch(words: torch.Tensor, totals_np) -> np.ndarray:
    """Copy to the host only the word columns that some image uses:
    [B, bucket] int32 device words -> [B, ncols] uint32."""
    nmax = -(-int(totals_np.max()) // 32) if totals_np.size else 0
    ncols = max(1, min(nmax, words.shape[1]))
    return words[:, :ncols].contiguous().cpu().numpy().view(np.uint32)


def _finalize_scan_bytes(words: np.ndarray, total_bits: int) -> bytes:
    """Host word stream -> stuffed entropy-coded byte segment."""
    return words_to_scan(words[: (total_bits + 31) // 32], total_bits)


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
