"""Huffman tables as sjpeg builds them: the Annex K.3 defaults, canonical
code LUTs (src/enc.cc:433-463) and the optimal length-limited tables
(src/enc.cc:1311-1487): (freq << 9 | symbol) keys merged from the
smallest, a fake lowest symbol that takes the all-ones code and is dropped,
lengths rebalanced to 16 bits."""

from dataclasses import dataclass

import numpy as np

from . import constants as C


@dataclass
class HuffmanTable:
    bits: np.ndarray          # uint8[16]: codes of each length
    syms: np.ndarray          # uint8[nb_syms] by increasing length

    @property
    def nb_syms(self) -> int:
        return len(self.syms)


def k3_default_tables():
    """[dc_luma, dc_chroma, ac_luma, ac_chroma]."""
    return [HuffmanTable(C.K3_DC_BITS_LUMA, C.K3_DC_SYMS),
            HuffmanTable(C.K3_DC_BITS_CHROMA, C.K3_DC_SYMS),
            HuffmanTable(C.K3_AC_BITS_LUMA, C.K3_AC_SYMS_LUMA),
            HuffmanTable(C.K3_AC_BITS_CHROMA, C.K3_AC_SYMS_CHROMA)]


def build_code_lut(table: HuffmanTable, lut_size: int) -> np.ndarray:
    """int64[lut_size]: code << 16 | length for each symbol, 0 if absent."""
    bits = np.asarray(table.bits, dtype=np.int64)[:16]
    nb = int(bits.sum())
    syms = np.asarray(table.syms, dtype=np.int64)[:nb]
    lengths = np.repeat(np.arange(1, 17), bits)
    first = np.zeros(17, dtype=np.int64)
    for n in range(1, 16):
        first[n + 1] = (first[n] + bits[n - 1]) << 1
    rank = np.arange(nb) - np.repeat(np.cumsum(bits) - bits, bits)
    lut = np.zeros(lut_size, dtype=np.int64)
    lut[syms] = ((first[lengths] + rank) << 16) | lengths
    return lut


def build_optimal_table(freq: np.ndarray, size: int) -> HuffmanTable:
    """The length-limited table sjpeg builds from symbol frequencies."""
    max_bits, max_code = 32, 16
    keys = sorted(((int(freq[i]) << 9) | i for i in range(size)
                   if freq[i] > 0), reverse=True)
    nb_syms = len(keys)
    codesizes = [0] * (size + 1)
    members = {i: [i] for i in range(size + 1)}
    keys.append((1 << 9) | size)              # the fake all-ones symbol
    nb = len(keys)
    while nb > 1:
        s1, s2 = keys[nb - 2], keys[nb - 1]
        i, j = s1 & 0x1FF, s2 & 0x1FF
        members[i] = members[i] + members[j]
        for leaf in members[i]:
            codesizes[leaf] += 1
        merged = s1 + (s2 & ~0x1FF)
        nb -= 1
        k = nb - 1
        while k > 0 and keys[k - 1] < merged:
            keys[k] = keys[k - 1]
            k -= 1
        keys[k] = merged
        del keys[nb]

    cs = np.minimum(np.asarray(codesizes, dtype=np.int64), max_bits)
    nzmask = cs > 0
    bits = np.bincount(cs[nzmask], minlength=max_bits + 1)[1:].tolist()
    max_bit_size = int(cs.max())
    real = nzmask[:size]
    lens_real = cs[:size][real]
    sorted_syms = np.arange(size)[real][np.argsort(lens_real, kind="stable")]
    fake_pos = int((lens_real <= cs[size]).sum())
    syms = np.insert(sorted_syms, fake_pos, 0).astype(np.uint8)
    for n in range(max_bit_size - 1, max_code - 1, -1):
        while bits[n] > 0:
            k = n - 2
            while bits[k] == 0:
                k -= 1
            bits[n] -= 2
            bits[n - 1] += 1
            bits[k] -= 1
            bits[k + 1] += 2
    top = max_code
    while bits[top - 1] == 0:
        top -= 1
    bits[top - 1] -= 1
    return HuffmanTable(bits=np.array(bits[:max_code], dtype=np.uint8),
                        syms=syms[:nb_syms])


def optimal_tables(freq_dc: np.ndarray, freq_ac: np.ndarray, n_groups: int):
    """[dc_luma, dc_chroma, ac_luma, ac_chroma]; with one group (4:0:0)
    the chroma pair stays the K.3 defaults."""
    tables = k3_default_tables()
    for g in range(n_groups):
        tables[g] = build_optimal_table(freq_dc[g], 12)
        tables[2 + g] = build_optimal_table(freq_ac[g], 256)
    return tables
