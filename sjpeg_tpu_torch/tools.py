"""JPEG recompression tools, copied for the PyTorch port: header-only
parsing and quality estimation.

Host-side scanners over existing JPEG bitstreams; no entropy decoding.
Behavioral contract follows the reference tools (src/jpeg_tools.cc:34-164):
`dimensions` finds SOF0/SOF1 and reports 4:2:0-ness from sampling factors;
`find_quantizer` walks DQT chunks before the first SOS, de-zigzags and clamps
16-bit matrices; `quant_matrix` is the jpeg-6b quality->matrix mapping;
`estimate_quality` brute-forces the best-L2 quality in [0, 100].
"""

from typing import Optional, Tuple

import numpy as np

from . import constants as C
from .params import quant_matrices_for_quality

_M_SOF0 = 0xFFC0
_M_SOF1 = 0xFFC1
_M_DQT = 0xFFDB
_M_SOS = 0xFFDA


def _find_sof(data: bytes) -> int:
    """Offset of the first SOF0/SOF1 marker, or -1."""
    if len(data) < 10 or data[0] != 0xFF or data[1] != 0xD8:
        return -1
    pos = 2
    end = len(data) - 8
    while pos < end and data[pos] != 0xFF:
        pos += 1
    while pos < end:
        marker = (data[pos] << 8) | data[pos + 1]
        if marker in (_M_SOF0, _M_SOF1):
            return pos
        pos += 2 + ((data[pos + 2] << 8) | data[pos + 3])
    return -1


def dimensions(data: bytes) -> Optional[Tuple[int, int, bool]]:
    """(width, height, is_yuv420) of a baseline/extended-sequential JPEG."""
    pos = _find_sof(data)
    if pos < 0 or len(data) - pos < 11:
        return None
    height = (data[pos + 5] << 8) | data[pos + 6]
    width = (data[pos + 7] << 8) | data[pos + 8]
    nb_comps = data[pos + 9]
    is_420 = nb_comps == 3
    if is_420 and len(data) - pos >= 11 + 3 * nb_comps:
        for c in range(3):
            expected = 0x22 if c == 0 else 0x11
            is_420 &= data[pos + 11 + c * 3] == expected
    else:
        is_420 = False
    return width, height, bool(is_420)


def find_quantizer(data: bytes):
    """Extract the (up to 2) quant matrices from DQT chunks before SOS.

    Returns (count, matrices [2, 64] uint8 in raster order); matrices not
    present stay zero.  16-bit precision entries are clamped to 8 bits.
    """
    quant = np.zeros((2, 64), dtype=np.uint8)
    if len(data) < 69 or data[0] != 0xFF or data[1] != 0xD8:
        return 0, quant
    pos = 2
    end = len(data) - 8
    while pos < end and data[pos] != 0xFF:
        pos += 1
    nb_comp = 0
    while pos < end:
        marker = (data[pos] << 8) | data[pos + 1]
        chunk_size = 2 + ((data[pos + 2] << 8) | data[pos + 3])
        if pos + chunk_size > end or marker == _M_SOS:
            break
        if marker == _M_DQT:
            i = 4
            while i + 1 < chunk_size:
                pq = data[pos + i] >> 4
                tq = data[pos + i] & 0x0F
                if pq > 1 or tq > 3:
                    return 0, np.zeros((2, 64), dtype=np.uint8)
                m_size = 64 * pq + 65
                if i + m_size > chunk_size:
                    return 0, np.zeros((2, 64), dtype=np.uint8)
                if tq < 2:
                    for j in range(64):
                        if pq == 0:
                            v = data[pos + i + 1 + j]
                        else:
                            v = ((data[pos + i + 1 + 2 * j] << 8)
                                 | data[pos + i + 1 + 2 * j + 1])
                            v = min(v, 255)
                        quant[tq][C.ZIGZAG[j]] = max(v, 1)
                nb_comp |= 1 << tq
                i += m_size
        pos += chunk_size
    count = bin(nb_comp & 0x0F).count("1")
    return count, quant


def quant_matrix(quality: float, for_chroma: bool) -> np.ndarray:
    """jpeg-6b style quality -> quant matrix (raster order, uint8[64])."""
    return quant_matrices_for_quality(quality)[1 if for_chroma else 0]


def estimate_quality(matrix: np.ndarray, for_chroma: bool = False) -> float:
    """Best-L2 quality in [0, 100] whose jpeg-6b matrix matches `matrix`."""
    matrix = np.asarray(matrix, dtype=np.float32).reshape(64)
    best_quality = 0
    best_score = 256.0 * 256 * 64 + 1
    for quality in range(101):
        m = quant_matrix(quality, for_chroma).astype(np.float32)
        score = float(((m - matrix) ** 2).sum())
        if score < best_score:
            best_score = score
            best_quality = quality
    return float(best_quality)
