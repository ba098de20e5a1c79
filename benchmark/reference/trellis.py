"""sjpeg's trellis quantization (TrellisQuantizeBlock, src/enc.cc:692-761)
over all the blocks of a component at once.

In each block every zigzag position i whose bias-quantized level v is not
0 opens up to two nodes: v itself and the largest level one bit shorter,
(1 << (bits(v) - 1)) - 1.  A node takes the predecessor, among the sink
and the nodes of earlier positions, of least score = distortion + lambda *
bits, with lambda = (quant << 4)^2 / 32, the bits those of the symbol
(run & 15) << 4 | size from the rate table plus the size and a ZRL a 16
zeros, and the distortion the squared error of the new level plus the
energy of the zeros skipped.  Scores are uint32 and wrap, as in sjpeg.  At
the end each node adds the energy of the positions after it and the least
wins; ties go to the node appended last (sjpeg walks its nodes backwards
with a strict <), the sink last of all.  The DC takes the plain bias
quantizer (src/enc.cc:763-766).

The blocks of a chunk are sorted by how many positions open nodes, so that
the blocks that reach the r-th such position are a prefix: node r of every
block is placed in one step, with no loop a block.
"""

import numpy as np

from . import constants as C
from .huffman import build_code_lut, k3_default_tables
from .spec import bit_length, quantize_blocks

_M32 = 0xFFFFFFFF           # uint32 wrap, and the score of no path
_CHUNK = 8192               # blocks a chunk: bounds the [n, 127] tables


def k3_ac_lens() -> np.ndarray:
    """[2, 256] int64 code lengths of the K.3 AC tables (luma, chroma):
    the rate model of a single pass of method 7 (src/enc.cc:1528)."""
    t = k3_default_tables()
    return np.stack([build_code_lut(t[2], 256) & 0xFF,
                     build_code_lut(t[3], 256) & 0xFF])


def overlay_lens(lens: np.ndarray, tables) -> np.ndarray:
    """The rate model after a pass's optimal tables: sjpeg rebuilds its
    code arrays in place (InitCodes, src/enc.cc:451-463), so a symbol
    absent from the new AC table keeps the length it had."""
    out = lens.copy()
    for g in range(2):
        new = build_code_lut(tables[2 + g], 256) & 0xFF
        out[g] = np.where(new > 0, new, lens[g])
    return out


def trellis_blocks(coeffs: np.ndarray, qm: dict,
                   ac_lens: np.ndarray) -> np.ndarray:
    """[N, 64] raster coefficients (x16), a finalized matrix and its
    group's [256] AC code lengths -> [N, 64] int32 raster levels."""
    coeffs = np.asarray(coeffs)
    out = np.empty(coeffs.shape, dtype=np.int32)
    for s in range(0, coeffs.shape[0], _CHUNK):
        out[s:s + _CHUNK] = _chunk(coeffs[s:s + _CHUNK], qm, ac_lens)
    return out


def _chunk(coeffs, qm, ac_lens):
    zz = C.ZIGZAG
    cz = coeffs.astype(np.int64)[:, zz]
    n = cz.shape[0]
    V = np.abs(cz)
    level0 = np.abs(quantize_blocks(coeffs, qm)[:, zz]).astype(np.int64)
    q16 = qm["quant"].astype(np.int64)[zz] << C.AC_BITS
    lam = q16 * q16 // 32
    energy = V * V
    energy[:, 0] = 0
    disto0 = np.cumsum(energy, axis=1)          # exact; wrapped where used
    lens = np.asarray(ac_lens, dtype=np.int64)
    esc = int(lens[0xF0])

    opens = level0 > 0
    opens[:, 0] = False
    count = opens.sum(axis=1)
    order = np.argsort(-count, kind="stable")
    cz, V, level0, disto0, count = (a[order] for a in
                                    (cz, V, level0, disto0, count))
    opens = opens[order]
    m_max = int(count[0]) if n else 0
    # the positions that open nodes, in order, per block
    where = np.argsort(~opens, axis=1, kind="stable")[:, :m_max]

    k = 2 * m_max + 1                           # slot 0 is the sink
    score = np.zeros((n, k), dtype=np.int64)
    valid = np.zeros((n, k), dtype=bool)
    valid[:, 0] = True
    pos = np.zeros((n, k), dtype=np.int64)
    prev = np.zeros((n, k), dtype=np.int64)
    level = np.zeros((n, k), dtype=np.int64)
    dpos = np.zeros((n, k), dtype=np.int64)     # disto0 at each slot's pos
    for r in range(1, m_max + 1):
        a = int(np.searchsorted(-count, -r, side="right"))
        rows = np.arange(a)
        i = where[:a, r - 1]
        v = level0[rows, i]
        nb = bit_length(v)
        vc = np.stack([v, (1 << (nb - 1)) - 1], axis=1)
        nbc = np.stack([nb, nb - 1], axis=1)
        exist = np.stack([np.ones(a, dtype=bool), nb > 1], axis=1)
        err = V[rows, i][:, None] - vc * q16[i][:, None]
        base = (err * err & _M32) + disto0[rows, i - 1][:, None]
        ks = 2 * r - 1                          # slots before this position
        run = (i - 1)[:, None] - pos[:a, :ks]
        esc_bits = (run >> 4) * esc
        sign = np.where(cz[rows, i] < 0, -1, 1)
        for c in range(2):
            sym = ((run & 15) << 4) | nbc[:, c:c + 1]
            bits = lens[sym] + nbc[:, c:c + 1] + esc_bits
            s = (base[:, c:c + 1] - dpos[:a, :ks] + lam[i][:, None] * bits
                 + score[:a, :ks]) & _M32
            s = np.where(valid[:a, :ks], s, _M32)
            back = np.argmin(s[:, ::-1], axis=1)    # the latest of ties
            best = s[rows, ks - 1 - back]
            slot = ks + c
            score[:a, slot] = best
            valid[:a, slot] = exist[:, c] & (best < _M32)
            prev[:a, slot] = ks - 1 - back
            pos[:a, slot] = i
            level[:a, slot] = sign * vc[:, c]
            dpos[:a, slot] = disto0[rows, i]

    rows = np.arange(n)
    end = np.where(valid, (score + disto0[:, 63:64] - dpos) & _M32, _M32)
    back = np.argmin(end[:, ::-1], axis=1)
    cur = k - 1 - back
    cur = np.where(end[rows, cur] < _M32, cur, 0)
    out_z = np.zeros((n, 64), dtype=np.int64)
    for _ in range(m_max):                      # positions strictly fall
        live = np.flatnonzero(cur > 0)
        if live.size == 0:
            break
        out_z[live, pos[live, cur[live]]] = level[live, cur[live]]
        cur[live] = prev[live, cur[live]]
    out_z[:, 0] = np.where(cz[:, 0] < 0, -level0[:, 0], level0[:, 0])
    out = np.empty_like(out_z)
    out[order] = out_z[:, C.UNZIGZAG]
    return out.astype(np.int32)
