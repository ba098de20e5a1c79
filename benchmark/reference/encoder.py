"""sjpeg's baseline encode of RGB images, end to end in NumPy: the mode
(YUV_AUTO's riskiness pick, or the configured one), colour conversion or
the sharp conversion, the fDCT, adaptive quantization, quantization, K.3 or
optimal Huffman tables, the MCU-interleaved scan and the markers
(src/enc.cc:1585-1641 for the order of the stages)."""

import dataclasses

import numpy as np

from . import adaptive, headers, huffman, riskiness, sharp_yuv, spec
from . import constants as C

MODES = {"auto": C.YUV_AUTO, "420": C.YUV_420, "sharp": C.YUV_SHARP,
         "444": C.YUV_444, "400": C.YUV_400}
MODE_NAMES = {v: k for k, v in MODES.items()}


@dataclasses.dataclass(frozen=True)
class Settings:
    """What an encode depends on, as sjpeg's EncoderParam states it."""
    quality: float = 75.0
    yuv_mode: str = "auto"
    optimize_huffman: bool = True      # two-pass optimal tables
    adaptive_quantization: bool = True
    quantization_bias: int = C.DEFAULT_BIAS
    qdelta_max_luma: int = C.DEFAULT_DELTA_MAX_LUMA
    qdelta_max_chroma: int = C.DEFAULT_DELTA_MAX_CHROMA


@dataclasses.dataclass
class Layout:
    mode: int
    width: int
    height: int
    mb_w: int
    mb_h: int
    quant_idx: list
    nb_blocks: list
    block_dims: list
    block: int


def layout_for(mode: int, width: int, height: int) -> Layout:
    if mode == C.YUV_444:
        geo = ([0, 1, 1], [1, 1, 1], [0x11] * 3, 8)
    elif mode in (C.YUV_420, C.YUV_SHARP):
        geo = ([0, 1, 1], [4, 1, 1], [0x22, 0x11, 0x11], 16)
    elif mode == C.YUV_400:
        geo = ([0], [1], [0x11], 8)
    else:
        raise ValueError(f"unresolved YUV mode {mode}")
    blk = geo[3]
    return Layout(mode, width, height, -(-width // blk), -(-height // blk),
                  *geo)


def quant_matrices(quality: float) -> np.ndarray:
    """Annex K.1 matrices at a quality, jpeg-6b's mapping -> [2, 64]."""
    q = quality
    q = 5000.0 if q <= 0 else (5000.0 / q if q < 50 else
                               (2 * (100 - q) if q < 100 else 0.0))
    v = np.floor(C.DEFAULT_QUANT_MATRICES.astype(np.float32)
                 * (np.float32(np.floor(q)) / 100.0) + 0.5)
    return np.clip(v, 1, 255).astype(np.uint8)


def rgb_blocks(rgb: np.ndarray, lay: Layout) -> list:
    img = spec.pad_edge(rgb, lay.block, lay.block)
    if lay.mode == C.YUV_444:
        return [spec.blockize(p) for p in spec.rgb_to_yuv444(img)]
    if lay.mode == C.YUV_420:
        y, u, v = spec.rgb_to_yuv420(img)
        yb = spec.average_extra_luma(spec.blockize_420_luma(y), lay.mb_w,
                                     lay.mb_h, lay.width, lay.height)
        return [yb, spec.blockize(u), spec.blockize(v)]
    return [spec.blockize(spec.rgb_to_y(img))]


def plane_blocks(y, u, v, lay: Layout) -> list:
    """4:2:0 planes (uint8) -> centred component blocks."""
    yp = spec.pad_edge(y, 16, 16).astype(np.int32) - 128
    yb = spec.average_extra_luma(spec.blockize_420_luma(yp), lay.mb_w,
                                 lay.mb_h, lay.width, lay.height)
    return [yb] + [spec.blockize(spec.pad_edge(p, 8, 8).astype(np.int32)
                                 - 128) for p in (u, v)]


def _interleave(per_comp: list, nb: list) -> np.ndarray:
    """Component arrays -> one array in MCU-interleaved scan order."""
    parts = [a.reshape((-1, n) + a.shape[1:]) for a, n in zip(per_comp, nb)]
    joined = np.concatenate(parts, axis=1)
    return joined.reshape((-1,) + joined.shape[2:])


def encode_blocks(blocks: list, lay: Layout, s: Settings,
                  fdct=spec.fdct_blocks):
    """Component blocks -> (JPEG bytes, coded AC positions, blocks)."""
    n_groups = 1 if lay.mode == C.YUV_400 else 2
    coeffs = [fdct(b) for b in blocks]
    base = quant_matrices(s.quality)
    ones = np.ones(64, dtype=np.uint8)
    qms = [spec.finalize_quant_matrix(base[g], ones, s.quantization_bias)
           for g in range(2)]
    if s.adaptive_quantization:
        histos = [np.zeros((64, C.MAX_HISTO_DCT_COEFF), dtype=np.int64)
                  for _ in range(2)]
        for c, co in enumerate(coeffs):
            histos[lay.quant_idx[c]] += spec.store_histo(co)
        deltas = (s.qdelta_max_luma, s.qdelta_max_chroma)
        for g in range(n_groups - 1, -1, -1):
            tuned = adaptive.analyse_histo(histos[g], qms[g]["quant"], ones,
                                           deltas[g])
            qms[g] = spec.finalize_quant_matrix(tuned, ones,
                                                s.quantization_bias)
    qblocks = [spec.quantize_blocks(co, qms[lay.quant_idx[c]])
               for c, co in enumerate(coeffs)]
    rls = [spec.run_levels(qb) for qb in qblocks]
    dcs = [spec.dc_diff_codes(qb[:, 0]) for qb in qblocks]
    if s.optimize_huffman:
        freq_dc = np.zeros((2, 12), dtype=np.int64)
        freq_ac = np.zeros((2, 256), dtype=np.int64)
        for c in range(len(blocks)):
            fdc, fac = spec.entropy_stats(rls[c], dcs[c])
            freq_dc[lay.quant_idx[c]] += fdc
            freq_ac[lay.quant_idx[c]] += fac
        tables = huffman.optimal_tables(freq_dc, freq_ac, n_groups)
    else:
        tables = huffman.k3_default_tables()

    nb = lay.nb_blocks
    scan_rl = {k: _interleave([rl[k] for rl in rls], nb) for k in rls[0]}
    scan_dc = _interleave(dcs, nb)
    scan_tab = _interleave([np.full(len(b), lay.quant_idx[c])
                            for c, b in enumerate(blocks)], nb)
    dc_luts = [huffman.build_code_lut(t, 16) for t in tables[:2]]
    ac_luts = [huffman.build_code_lut(t, 256) for t in tables[2:]]
    scan = spec.code_scan(scan_rl, scan_dc, scan_tab, dc_luts, ac_luts)
    nb_comps = len(blocks)
    jpeg = b"".join([
        headers.APP0_JFIF,
        headers.dqt([qms[0]["quant"], qms[1]["quant"]], lay.mode),
        headers.sof0(lay.width, lay.height, nb_comps, lay.block_dims,
                     lay.quant_idx),
        headers.dht(tables, nb_comps),
        headers.sos(nb_comps, lay.quant_idx),
        scan, headers.EOI])
    coded = int(sum(rl["nz"].sum() for rl in rls))
    return jpeg, coded, int(sum(len(b) for b in blocks))


@dataclasses.dataclass
class Encoded:
    jpeg: bytes
    mode: str           # the mode encoded: 420, sharp, 444 or 400
    coded_ac: int       # AC positions coded
    blocks: int


def encode_images(rgbs: np.ndarray, s: Settings,
                  fdct=spec.fdct_blocks) -> list:
    """[N, H, W, 3] uint8 RGB -> [Encoded] in input order.  Images whose
    mode is sharp 4:2:0 convert together."""
    rgbs = np.asarray(rgbs, dtype=np.uint8)
    n, h, w = rgbs.shape[:3]
    mode = MODES[s.yuv_mode]
    modes = ([riskiness.riskiness(im)[0] for im in rgbs]
             if mode == C.YUV_AUTO else [mode] * n)
    out = [None] * n
    sharp = [i for i, m in enumerate(modes) if m == C.YUV_SHARP]
    if sharp:
        ys, us, vs = sharp_yuv.sharp_rgb_to_yuv420(rgbs[sharp])
        lay = layout_for(C.YUV_SHARP, w, h)
        for k, i in enumerate(sharp):
            out[i] = _encoded(encode_blocks(
                plane_blocks(ys[k], us[k], vs[k], lay), lay, s, fdct),
                "sharp")
    for i, m in enumerate(modes):
        if m != C.YUV_SHARP:
            lay = layout_for(m, w, h)
            out[i] = _encoded(encode_blocks(rgb_blocks(rgbs[i], lay), lay, s,
                                            fdct), MODE_NAMES[m])
    return out


def _encoded(result, mode: str) -> Encoded:
    jpeg, coded, blocks = result
    return Encoded(jpeg=jpeg, mode=mode, coded_ac=coded, blocks=blocks)
