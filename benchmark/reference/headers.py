"""The markers of a baseline JPEG without metadata, as sjpeg writes them
(src/headers.cc): SOI + JFIF APP0, DQT, SOF0, DHT, SOS and EOI."""

import numpy as np

from .constants import YUV_400, ZIGZAG

APP0_JFIF = bytes([0xFF, 0xD8, 0xFF, 0xE0, 0x00, 0x10,
                   0x4A, 0x46, 0x49, 0x46, 0x00, 0x01, 0x01,
                   0x00, 0x00, 0x01, 0x00, 0x01, 0x00, 0x00])
EOI = bytes([0xFF, 0xD9])


def _u16(v: int) -> bytes:
    return bytes([(v >> 8) & 0xFF, v & 0xFF])


def dqt(quant_matrices, yuv_mode: int) -> bytes:
    num = 1 if yuv_mode == YUV_400 else 2
    out = bytearray([0xFF, 0xDB, 0x00, num * 65 + 2])
    for n in range(num):
        out.append(n)
        out += np.asarray(quant_matrices[n], dtype=np.uint8)[ZIGZAG].tobytes()
    return bytes(out)


def sof0(width: int, height: int, nb_comps: int, block_dims, quant_idx):
    out = bytearray([0xFF, 0xC0]) + _u16(3 * nb_comps + 8) + bytes([8])
    out += _u16(height) + _u16(width) + bytes([nb_comps])
    for c in range(nb_comps):
        out += bytes([c + 1, block_dims[c], quant_idx[c]])
    return bytes(out)


def dht(tables, nb_comps: int) -> bytes:
    out = bytearray()
    for c in range(1 if nb_comps == 1 else 2):
        for kind in range(2):                   # 0 = DC, 1 = AC
            t = tables[kind * 2 + c]
            out += _u16(0xFFC4) + _u16(3 + 16 + t.nb_syms)
            out.append((kind << 4) | c)
            out += np.asarray(t.bits, dtype=np.uint8)[:16].tobytes()
            out += np.asarray(t.syms, dtype=np.uint8)[:t.nb_syms].tobytes()
    return bytes(out)


def sos(nb_comps: int, quant_idx) -> bytes:
    out = bytearray([0xFF, 0xDA]) + _u16(6 + nb_comps * 2) + bytes([nb_comps])
    for c in range(nb_comps):
        out += bytes([c + 1, quant_idx[c] * 0x11])
    return bytes(out + bytes([0x00, 0x3F, 0x00]))
