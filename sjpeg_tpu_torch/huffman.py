"""Huffman tables for the fixed-table path, copied for the PyTorch port.

The method-0 path codes with the JPEG Annex K.3 tables only; optimal-table
construction (methods 1-8) is not ported yet.
"""

from dataclasses import dataclass, field

import numpy as np

from . import constants as C


@dataclass
class HuffmanTable:
    """A JPEG Huffman table: `bits[i]` = number of codes of length i+1."""
    bits: np.ndarray          # uint8[16]
    syms: np.ndarray          # uint8[nb_syms], in increasing code-length order
    nb_syms: int = field(default=0)

    def __post_init__(self):
        if self.nb_syms == 0:
            self.nb_syms = len(self.syms)


def k3_default_tables():
    """The four Annex-K.3 tables: [dc_luma, dc_chroma, ac_luma, ac_chroma]."""
    return [
        HuffmanTable(C.K3_DC_BITS_LUMA, C.K3_DC_SYMS),
        HuffmanTable(C.K3_DC_BITS_CHROMA, C.K3_DC_SYMS),
        HuffmanTable(C.K3_AC_BITS_LUMA, C.K3_AC_SYMS_LUMA),
        HuffmanTable(C.K3_AC_BITS_CHROMA, C.K3_AC_SYMS_CHROMA),
    ]


def build_code_lut(table: HuffmanTable, lut_size: int = 256) -> np.ndarray:
    """Expand a (bits, syms) table into a packed per-symbol LUT.

    Returns uint32[lut_size] with entry `(code << 16) | code_length`; unused
    symbols stay 0.  Codes are assigned canonically: counting up within a bit
    length, shifting left by one when the length increases.
    """
    bits = np.asarray(table.bits, dtype=np.int64)[:16]
    nb_syms = int(bits.sum())
    syms = np.asarray(table.syms, dtype=np.int64)[:nb_syms]
    lengths = np.repeat(np.arange(1, 17), bits)              # [nb_syms]
    # first code of each length: c(l) = (c(l-1) + bits[l-1]) << 1
    first = np.zeros(17, dtype=np.int64)   # first[l] = first code of length l
    for l in range(1, 16):
        first[l + 1] = (first[l] + bits[l - 1]) << 1
    rank = np.arange(nb_syms) - np.repeat(np.cumsum(bits) - bits, bits)
    codes = first[lengths] + rank
    lut = np.zeros(lut_size, dtype=np.uint32)
    lut[syms] = ((codes << 16) | lengths).astype(np.uint32)
    return lut
