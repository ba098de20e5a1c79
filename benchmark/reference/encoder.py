"""sjpeg's baseline encode of RGB images, end to end in NumPy: the mode
(YUV_AUTO's riskiness pick, or the configured one), colour conversion or
the sharp conversion, the fDCT, adaptive quantization, quantization (the
bias quantizer, or method 7's trellis), K.3 or optimal Huffman tables, the
MCU-interleaved scan and the markers (src/enc.cc:1585-1641 for the order of
the stages).

An image is prepared once (`prepare`: coefficients, histograms) and then
encoded in passes (`pass_matrices`, `quantize`, `tables_for`, `scan_raw`,
`assemble`): one at the configured quality, or as many as sjpeg's search
for a target size or PSNR takes (`search.loop_scan`)."""

import dataclasses

import numpy as np

from . import adaptive, headers, huffman, riskiness, sharp_yuv, spec, trellis
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
    use_trellis: bool = False
    # sjpeg's search (-size / -psnr, -pass, -tolerance, -qmin, -qmax):
    # "size" in bytes an image or "psnr" in dB; "none" encodes once
    target_mode: str = "none"
    target_value: float = 0.0
    passes: int = 1
    tolerance: float = 1.0             # percent of the target
    qmin: float = 0.0
    qmax: float = 100.0

    @property
    def trellis(self) -> bool:
        """Method 7: the trellis runs only on top of adaptive quantization
        and optimal tables (src/enc.cc:2282-2288)."""
        return (self.use_trellis and self.optimize_huffman
                and self.adaptive_quantization)

    @property
    def searches(self) -> bool:
        """A target with more than one pass runs the search; otherwise one
        pass at `quality`."""
        return self.target_mode != "none" and self.passes > 1


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


@dataclasses.dataclass
class Prepared:
    """What an image's encode computes once, however many passes follow:
    its layout, the fDCT coefficients of each component and, with
    adaptive quantization, the (luma, chroma) histograms."""
    lay: Layout
    coeffs: list
    histos: list


@dataclasses.dataclass
class Quantized:
    """One pass's levels: the finalized matrices, each component's
    run/levels and DC codes."""
    qms: list
    rls: list
    dcs: list


def prepare(blocks: list, lay: Layout, s: Settings,
            fdct=spec.fdct_blocks) -> Prepared:
    coeffs = [fdct(b) for b in blocks]
    histos = None
    if s.adaptive_quantization:
        histos = [np.zeros((64, C.MAX_HISTO_DCT_COEFF), dtype=np.int64)
                  for _ in range(2)]
        for c, co in enumerate(coeffs):
            histos[lay.quant_idx[c]] += spec.store_histo(co)
    return Prepared(lay, coeffs, histos)


def pass_matrices(prep: Prepared, s: Settings, quality: float) -> list:
    """The finalized (luma, chroma) matrices of a pass at `quality`, tuned
    by the image's histograms with adaptive quantization."""
    n_groups = 1 if prep.lay.mode == C.YUV_400 else 2
    base = quant_matrices(quality)
    ones = np.ones(64, dtype=np.uint8)
    qms = [spec.finalize_quant_matrix(base[g], ones, s.quantization_bias)
           for g in range(2)]
    if s.adaptive_quantization:
        deltas = (s.qdelta_max_luma, s.qdelta_max_chroma)
        for g in range(n_groups - 1, -1, -1):
            tuned = adaptive.analyse_histo(prep.histos[g], qms[g]["quant"],
                                           ones, deltas[g])
            qms[g] = spec.finalize_quant_matrix(tuned, ones,
                                                s.quantization_bias)
    return qms


def quantize(prep: Prepared, qms: list, s: Settings,
             ac_lens=None) -> Quantized:
    """Every component's levels: the trellis over the [2, 256] AC code
    lengths `ac_lens` (the K.3 tables' by default) in method 7, the bias
    quantizer otherwise."""
    idx = prep.lay.quant_idx
    if s.trellis:
        lens = trellis.k3_ac_lens() if ac_lens is None else ac_lens
        qblocks = [trellis.trellis_blocks(co, qms[idx[c]], lens[idx[c]])
                   for c, co in enumerate(prep.coeffs)]
    else:
        qblocks = [spec.quantize_blocks(co, qms[idx[c]])
                   for c, co in enumerate(prep.coeffs)]
    return Quantized(qms, [spec.run_levels(qb) for qb in qblocks],
                     [spec.dc_diff_codes(qb[:, 0]) for qb in qblocks])


def quant_error(prep: Prepared, qms: list) -> int:
    """The image's squared error of the bias quantizer in (|c| >> 4)
    units (src/enc.cc:851-863), what the PSNR search measures."""
    err = 0
    for c, co in enumerate(prep.coeffs):
        qm = qms[prep.lay.quant_idx[c]]
        d = ((np.abs(co.astype(np.int64)) >> C.AC_BITS)
             - qm["quant"].astype(np.int64)
             * np.abs(spec.quantize_blocks(co, qm)))
        err += int((d * d).sum())
    return err


def tables_for(qz: Quantized, lay: Layout, s: Settings) -> list:
    """The pass's Huffman tables: optimal from its statistics, or K.3."""
    if not s.optimize_huffman:
        return huffman.k3_default_tables()
    freq_dc = np.zeros((2, 12), dtype=np.int64)
    freq_ac = np.zeros((2, 256), dtype=np.int64)
    for c in range(len(qz.rls)):
        fdc, fac = spec.entropy_stats(qz.rls[c], qz.dcs[c])
        freq_dc[lay.quant_idx[c]] += fdc
        freq_ac[lay.quant_idx[c]] += fac
    n_groups = 1 if lay.mode == C.YUV_400 else 2
    return huffman.optimal_tables(freq_dc, freq_ac, n_groups)


def scan_raw(qz: Quantized, lay: Layout, tables: list) -> tuple:
    """The MCU-interleaved scan before stuffing: (padded bytes, bits)."""
    nb = lay.nb_blocks
    rls = qz.rls
    scan_rl = {k: _interleave([rl[k] for rl in rls], nb) for k in rls[0]}
    scan_dc = _interleave(qz.dcs, nb)
    scan_tab = _interleave([np.full(len(d), lay.quant_idx[c])
                            for c, d in enumerate(qz.dcs)], nb)
    dc_luts = [huffman.build_code_lut(t, 16) for t in tables[:2]]
    ac_luts = [huffman.build_code_lut(t, 256) for t in tables[2:]]
    return spec.code_scan(scan_rl, scan_dc, scan_tab, dc_luts, ac_luts)


def assemble(qz: Quantized, lay: Layout, tables: list, raw) -> bytes:
    nb_comps = len(qz.rls)
    return b"".join([
        headers.APP0_JFIF,
        headers.dqt([qz.qms[0]["quant"], qz.qms[1]["quant"]], lay.mode),
        headers.sof0(lay.width, lay.height, nb_comps, lay.block_dims,
                     lay.quant_idx),
        headers.dht(tables, nb_comps),
        headers.sos(nb_comps, lay.quant_idx),
        spec.stuff_bytes(raw), headers.EOI])


def encode_blocks(blocks: list, lay: Layout, s: Settings,
                  fdct=spec.fdct_blocks):
    """Component blocks -> (JPEG bytes, coded AC positions, blocks): one
    pass at the configured quality, or sjpeg's search for a target."""
    prep = prepare(blocks, lay, s, fdct)
    if s.searches:
        from . import search
        qz, tables, raw = search.loop_scan(prep, s)
    else:
        qz = quantize(prep, pass_matrices(prep, s, s.quality), s)
        tables = tables_for(qz, lay, s)
        raw = scan_raw(qz, lay, tables)[0]
    coded = int(sum(rl["nz"].sum() for rl in qz.rls))
    return (assemble(qz, lay, tables, raw), coded,
            int(sum(len(b) for b in blocks)))


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
