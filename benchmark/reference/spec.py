"""The baseline-JPEG stages in plain NumPy, integer-exact: colour
conversion, edge padding and blockization, the extra-luma flattening of
clipped 4:2:0 MCUs, sjpeg's fixed-point fDCT (output x16), the bias
quantizer, coefficient histograms, run/level extraction, DC prediction and
a vectorised Huffman scan writer.

Behaviour follows sjpeg (src/colors_rgb.cc:17-31, 505-603; src/enc.cc:
327-361, 466-499, 598-630, 882-911, 945-975, 1703-1754; src/fdct.cc:67-209).
`fdct_blocks_float32` is the benchmark's control: a float32 DCT-II at the
same x16 scale, rounded, standing in for the integer transform.
"""

import numpy as np

from . import constants as C

# fDCT work is done in slices of this many blocks, to bound the int64
# temporaries of a 12-MP image
_FDCT_SLICE = 1 << 15


def blockize(plane: np.ndarray) -> np.ndarray:
    """[H, W] -> [H//8 * W//8, 64] in raster block order."""
    h, w = plane.shape
    return (plane.reshape(h // 8, 8, w // 8, 8)
            .transpose(0, 2, 1, 3)
            .reshape(-1, 64))


def blockize_420_luma(plane: np.ndarray) -> np.ndarray:
    """[H, W] -> [n_mcu * 4, 64]: per MCU the four luma blocks in 2x2
    row-major order."""
    h, w = plane.shape
    return (plane.reshape(h // 16, 2, 8, w // 16, 2, 8)
            .transpose(0, 3, 1, 4, 2, 5)
            .reshape(-1, 64))


def pad_edge(img: np.ndarray, block_w: int, block_h: int) -> np.ndarray:
    """Replicate the last row and column up to a multiple of the MCU."""
    h, w = img.shape[:2]
    ph, pw = (-h) % block_h, (-w) % block_w
    if ph == 0 and pw == 0:
        return img
    pad = [(0, ph), (0, pw)] + [(0, 0)] * (img.ndim - 2)
    return np.pad(img, pad, mode="edge")


def rgb_to_y(rgb: np.ndarray) -> np.ndarray:
    r, g, b = (rgb[..., k].astype(np.int64) for k in range(3))
    y = (19595 * r + 38469 * g + 7471 * b + C.ROUND_Y) >> C.YUV_FRAC
    return y.astype(np.int32)


def rgb_to_yuv444(rgb: np.ndarray):
    """[H, W, 3] uint8 -> three [H, W] int32 planes centred on 0."""
    r, g, b = (rgb[..., k].astype(np.int64) for k in range(3))
    u = (-11059 * r - 21709 * g + 32768 * b + C.YUV_HALF) >> C.YUV_FRAC
    v = (32768 * r - 27439 * g - 5329 * b + C.YUV_HALF) >> C.YUV_FRAC
    return rgb_to_y(rgb), u.astype(np.int32), v.astype(np.int32)


def rgb_to_yuv420(rgb: np.ndarray):
    """Chroma from the sum of each 2x2 RGB quad, FRAC+2 shift."""
    q = rgb.astype(np.int64).reshape(rgb.shape[0] // 2, 2,
                                     rgb.shape[1] // 2, 2, 3)
    s = q.sum(axis=(1, 3))
    r, g, b = s[..., 0], s[..., 1], s[..., 2]
    u = (-11059 * r - 21709 * g + 32768 * b + C.ROUND_UV) >> (C.YUV_FRAC + 2)
    v = (32768 * r - 27439 * g - 5329 * b + C.ROUND_UV) >> (C.YUV_FRAC + 2)
    return rgb_to_y(rgb), u.astype(np.int32), v.astype(np.int32)


def _block_average(block64: np.ndarray) -> np.ndarray:
    return (block64.sum(axis=-1) + 32) >> 6


def average_extra_luma(y_blocks: np.ndarray, mb_w: int, mb_h: int,
                       width: int, height: int) -> np.ndarray:
    """Flatten the luma blocks of clipped 4:2:0 MCUs that lie wholly
    outside the image to the mean of the block before them."""
    y_blocks = y_blocks.reshape(mb_h, mb_w, 4, 64).copy()
    mb_x_max, mb_y_max = width // 16, height // 16
    clipped = []
    if mb_x_max < mb_w:
        clipped += [(my, mb_x_max) for my in range(mb_h)]
    if mb_y_max < mb_h:
        clipped += [(mb_y_max, mx) for mx in range(mb_w) if mx != mb_x_max]
    for my, mx in clipped:
        sub_w, sub_h = width - mx * 16, height - my * 16
        blk = y_blocks[my, mx]
        dc = _block_average(blk[0])
        if sub_w <= 8:
            blk[1, :] = dc
        if sub_h <= 8:
            if sub_w > 8:
                dc = _block_average(blk[1])
            blk[2, :] = dc
            blk[3, :] = dc
        elif sub_w <= 8:
            blk[3, :] = _block_average(blk[2])
    return y_blocks.reshape(-1, 64)


def _fdct_slice(blocks: np.ndarray) -> np.ndarray:
    x = blocks.reshape(-1, 8, 8).astype(np.int64)

    def mult(a, b):
        return (a * b) >> 16

    m0, m1, m2, m3, m4, m5, m6, m7 = (x[:, k, :] for k in range(8))
    m0, m7 = m0 - m7, m0 + m7
    m2, m5 = m2 - m5, m2 + m5
    m3, m4 = m3 - m4, m3 + m4
    m1, m6 = m1 - m6, m1 + m6
    m7, m4 = m7 - m4, m7 + m4
    m6, m5 = m6 - m5, m6 + m5
    m4, m5 = m4 << 3, m5 << 3
    m4, m5 = m4 - m5, m4 + m5
    col0, col4 = m5, m4
    m7, m6, m3, m0 = m7 << 3, m6 << 3, m3 << 3, m0 << 3
    t4 = mult(C.FDCT_K_TAN2, m7) - m6
    t5 = mult(C.FDCT_K_TAN2, m6) + m7
    col2, col6 = t5, t4
    m2, m1 = m2 << 4, m1 << 4
    m1, m2 = m1 - m2, m1 + m2
    m2 = mult(m2, C.FDCT_K_2SQRT2)
    m1 = mult(m1, C.FDCT_K_2SQRT2)
    m3, m1 = m3 - m1, m3 + m1
    m0, m2 = m0 - m2, m0 + m2
    t7, t6 = m3, m1
    m3 = mult(m3, C.FDCT_K_TAN3M1) + t7 + 1
    m1 = mult(m1, C.FDCT_K_TAN1) + m2 + 1
    t4b = mult(C.FDCT_K_TAN3M1, m0) + m0
    t5b = mult(C.FDCT_K_TAN1, m2)
    col1, col3 = m1, m0 - m3
    col5, col7 = t7 + t4b, t5b - t6
    cols = np.stack([col0, col1, col2, col3, col4, col5, col6, col7], axis=1)
    r = cols.astype(np.int16).astype(np.int64)      # STORE16

    tab = C.FDCT_ROW_TABLES
    c1, c2, c3, c4, c5, c6, c7 = (tab[None, :, k] for k in range(7))
    a0, b0 = r[:, :, 0] + r[:, :, 7], r[:, :, 0] - r[:, :, 7]
    a1, b1 = r[:, :, 1] + r[:, :, 6], r[:, :, 1] - r[:, :, 6]
    a2, b2 = r[:, :, 2] + r[:, :, 5], r[:, :, 2] - r[:, :, 5]
    a3, b3 = r[:, :, 3] + r[:, :, 4], r[:, :, 3] - r[:, :, 4]
    e0, e1, e2, e3 = a0 + a3, a0 - a3, a1 + a2, a1 - a2
    out = np.empty((x.shape[0], 8, 8), dtype=np.int64)
    out[:, :, 0] = (c4 * (e0 + e2)) >> 16
    out[:, :, 4] = (c4 * (e0 - e2)) >> 16
    out[:, :, 2] = (c2 * e1 + c6 * e3) >> 16
    out[:, :, 6] = (c6 * e1 - c2 * e3) >> 16
    out[:, :, 1] = (c1 * b0 + c3 * b1 + c5 * b2 + c7 * b3) >> 16
    out[:, :, 3] = (c3 * b0 - c7 * b1 - c1 * b2 - c5 * b3) >> 16
    out[:, :, 5] = (c5 * b0 - c1 * b1 + c7 * b2 + c3 * b3) >> 16
    out[:, :, 7] = (c7 * b0 - c5 * b1 + c3 * b2 - c1 * b3) >> 16
    return out.astype(np.int16).reshape(-1, 64)


def fdct_blocks(blocks: np.ndarray) -> np.ndarray:
    """sjpeg's integer 8x8 fDCT over [N, 64] blocks, output x16, int16."""
    return np.concatenate(
        [_fdct_slice(blocks[i:i + _FDCT_SLICE])
         for i in range(0, max(len(blocks), 1), _FDCT_SLICE)])


def _dct_matrix() -> np.ndarray:
    k = np.arange(8)
    m = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) / 2
    m[0] /= np.sqrt(2.0)
    return m


def fdct_blocks_float32(blocks: np.ndarray) -> np.ndarray:
    """The control: an orthonormal DCT-II computed in float32, scaled x16
    as sjpeg's and rounded to the nearest integer."""
    d = _dct_matrix().astype(np.float32)
    x = blocks.reshape(-1, 8, 8).astype(np.float32)
    f = np.matmul(np.matmul(d, x), d.T) * np.float32(16.0)
    return np.rint(f).astype(np.int16).reshape(-1, 64)


def finalize_quant_matrix(quant, min_quant, q_bias: int) -> dict:
    """Reciprocal multipliers, biases and thresholds of a matrix."""
    q = np.maximum(quant.astype(np.int64), min_quant.astype(np.int64))
    is_one = q == 1
    iquant = np.where(is_one, 0xFFFF, ((1 << C.FP_BITS) + q // 2) // q)
    pos = np.arange(64)
    bias = np.where(is_one, 0x80, np.where(pos == 0, C.BIAS_DC, q_bias))
    ibias = (((bias * q) << C.AC_BITS) + 128) >> 8
    return {"quant": q.astype(np.uint8), "iquant": iquant.astype(np.int64),
            "bias": ibias.astype(np.int64)}


def quantize_blocks(coeffs: np.ndarray, qm: dict) -> np.ndarray:
    """sign(c) * ((|c| + bias) * iquant >> 16) >> 4, raster order."""
    c = coeffs.astype(np.int64)
    q = ((np.abs(c) + qm["bias"]) * qm["iquant"] >> C.FP_BITS) >> C.AC_BITS
    return np.where(c < 0, -q, q).astype(np.int32)


def store_histo(coeffs: np.ndarray) -> np.ndarray:
    """[N, 64] -> [64, MAX_HISTO_DCT_COEFF] histogram of |c| >> HSHIFT."""
    nb = C.MAX_HISTO_DCT_COEFF
    mag = np.abs(coeffs.astype(np.int64)) >> C.HSHIFT
    pos = np.broadcast_to(np.arange(64), mag.shape)
    keep = mag < nb
    flat = pos[keep] * nb + mag[keep]
    return np.bincount(flat, minlength=64 * nb).reshape(64, nb)


def bit_length(v: np.ndarray) -> np.ndarray:
    """floor(log2(v)) + 1 for v >= 1 (exact below 2**53)."""
    return np.frexp(np.asarray(v).astype(np.float64))[1].astype(np.int64)


def dc_diff_codes(dc: np.ndarray) -> np.ndarray:
    """DC differences of one component in scan order, coded as
    n | (suffix << 4); the predictor starts at 0."""
    diff = dc.astype(np.int64).copy()
    diff[1:] -= dc[:-1].astype(np.int64)
    n = np.where(diff == 0, 0, bit_length(np.maximum(np.abs(diff), 1)))
    suff = np.where(diff < 0, (diff - 1) & ((1 << n) - 1), diff)
    return np.where(diff == 0, 0, n | (suff << 4)).astype(np.int64)


def run_levels(qblocks: np.ndarray) -> dict:
    """[N, 64] quantized blocks (raster) -> zigzag-layout run/levels:
    nz (AC coded), run, size, code (suffix bits) and last coded position."""
    v = qblocks[:, C.ZIGZAG].astype(np.int64)
    nz = np.zeros(v.shape, dtype=bool)
    nz[:, 1:] = v[:, 1:] != 0
    mag = np.abs(v)
    size = np.where(nz, bit_length(np.maximum(mag, 1)), 0)
    code = (mag ^ np.where(v < 0, -1, 0)) & ((1 << size) - 1)
    idx = np.broadcast_to(np.arange(64), v.shape)
    prev_nz = np.maximum.accumulate(np.where(nz, idx, 0), axis=1)
    prev_before = np.zeros_like(prev_nz)
    prev_before[:, 1:] = prev_nz[:, :-1]
    run = np.where(nz, idx - prev_before - 1, 0)
    return {"nz": nz, "run": run, "size": size, "code": code,
            "last": prev_nz[:, -1]}


def entropy_stats(rl: dict, dc_codes: np.ndarray):
    """(freq_dc [12], freq_ac [256]) of one component."""
    run = rl["run"][rl["nz"]]
    size = rl["size"][rl["nz"]]
    freq_ac = np.bincount(((run & 15) << 4) | size,
                          minlength=256).astype(np.int64)[:256]
    freq_ac[0xF0] += int((run >> 4).sum())
    freq_ac[0x00] += int((rl["last"] < 63).sum())
    freq_dc = np.bincount(dc_codes & 0x0F, minlength=12).astype(np.int64)
    return freq_dc[:12], freq_ac


def _or_into(words: np.ndarray, idx: np.ndarray, vals: np.ndarray) -> None:
    """words[idx] |= vals for sorted idx; fields never share a bit, so the
    sum of a word's fields is their union."""
    if idx.size:
        first = np.flatnonzero(np.r_[True, idx[1:] != idx[:-1]])
        words[idx[first]] |= np.add.reduceat(vals, first)


def pack_fields(start: np.ndarray, value: np.ndarray, length: np.ndarray,
                total: int) -> np.ndarray:
    """The big-endian bytes of `total` bits (rounded up to a byte) holding
    each value's low `length` (<= 64) bits MSB-first at bit `start`;
    starts increase and fields do not overlap."""
    keep = length > 0
    start, length = start[keep], length[keep]
    value = value[keep].astype(np.uint64)
    word, end = start >> 6, (start & 63) + length
    spill = end > 64
    head = ((value >> np.where(spill, end - 64, 0).astype(np.uint64))
            << np.where(spill, 0, 64 - end).astype(np.uint64))
    words = np.zeros((total + 63) // 64 + 1, dtype=np.uint64)
    _or_into(words, word, head)
    _or_into(words, word[spill] + 1,
             value[spill] << (128 - end[spill]).astype(np.uint64))
    return words.astype(">u8").view(np.uint8)[:(total + 7) // 8]


def code_scan(blocks_rl: dict, dc_codes: np.ndarray, table: np.ndarray,
              dc_luts, ac_luts) -> bytes:
    """The entropy-coded scan of blocks already in MCU-interleaved order:
    per block its DC code and suffix, for each coded AC position its ZRL
    escapes, code and suffix, and an EOB unless position 63 is coded;
    '1' padding to a byte and 0xFF stuffing.  `table` picks the luma (0)
    or chroma (1) LUTs of each block; a LUT entry is code << 16 | length."""
    nblk = dc_codes.shape[0]
    dc_lut = np.stack([np.asarray(t, dtype=np.int64) for t in dc_luts])
    ac_lut = np.stack([np.asarray(t, dtype=np.int64) for t in ac_luts])

    dn = dc_codes & 0x0F
    dpacked = dc_lut[table, dn]
    dc_len = (dpacked & 0xFF) + dn
    dc_val = ((dpacked >> 16) << dn) | (dc_codes >> 4)

    blk, pos = np.nonzero(blocks_rl["nz"])
    t = table[blk]
    run = blocks_rl["run"][blk, pos]
    size = blocks_rl["size"][blk, pos]
    apacked = ac_lut[t, ((run & 15) << 4) | size]
    ac_len = (apacked & 0xFF) + size
    ac_val = ((apacked >> 16) << size) | blocks_rl["code"][blk, pos]
    esc = ac_lut[t, 0xF0]
    esc_len, esc_code = esc & 0xFF, esc >> 16
    zrl = run >> 4
    zrl_len = zrl * esc_len
    zrl_val = np.zeros_like(zrl)
    for k in range(1, 4):
        zrl_val = np.where(zrl >= k, (zrl_val << esc_len) | esc_code, zrl_val)

    eob = blocks_rl["last"] < 63
    eob_len = np.where(eob, ac_lut[table, 0x00] & 0xFF, 0)
    eob_val = ac_lut[table, 0x00] >> 16

    # events per block: DC, then (ZRL, AC) per coded position, then EOB
    nnz = np.bincount(blk, minlength=nblk)
    first = np.zeros(nblk + 1, dtype=np.int64)
    np.cumsum(1 + 2 * nnz + 1, out=first[1:])
    n_ev = int(first[-1])
    val = np.zeros(n_ev, dtype=np.int64)
    ln = np.zeros(n_ev, dtype=np.int64)
    val[first[:-1]] = dc_val
    ln[first[:-1]] = dc_len
    # rank of each coded position within its block
    csum = np.zeros(nblk + 1, dtype=np.int64)
    np.cumsum(nnz, out=csum[1:])
    rank = np.arange(blk.size) - csum[blk]
    slot = first[blk] + 1 + 2 * rank
    val[slot], ln[slot] = zrl_val, zrl_len
    val[slot + 1], ln[slot + 1] = ac_val, ac_len
    last = first[1:] - 1
    val[last], ln[last] = eob_val, eob_len

    ends = np.cumsum(ln)
    total = int(ends[-1]) if n_ev else 0
    pad = (-total) & 7                              # '1' padding
    starts = np.append(ends - ln, total)
    raw = pack_fields(starts, np.append(val, (1 << pad) - 1),
                      np.append(ln, pad), total + pad)
    return stuff_bytes(raw)


def stuff_bytes(raw: np.ndarray) -> bytes:
    """Insert a 0x00 after every 0xFF byte."""
    raw = np.asarray(raw, dtype=np.uint8)
    ff = raw == 0xFF
    n_ff = int(np.count_nonzero(ff))
    if n_ff == 0:
        return raw.tobytes()
    out = np.zeros(raw.size + n_ff, dtype=np.uint8)
    out[np.arange(raw.size) + np.cumsum(ff) - ff] = raw
    return out.tobytes()
