"""Huffman code books on the host, copied for the PyTorch port.

The K.3 default tables (method 0 and the DC/AC tables of method 3), the
canonical LUT expansion, and the optimal-table construction
(`build_optimal_table`, the reference's BuildOptimalTable,
src/enc.cc:1311-1487) that the shared-statistics path runs on the batch's
frequencies, its merge loop in C++ (native.huffman_codesizes; the Python
loop, `_codesizes_python`, is its parity twin).  The per-image path
builds the same tables on the card (ops/huffman_device); the tests hold
the two against each other.

Optimal-table semantics, as in the reference:
- a fake lowest-frequency symbol occupies the all-ones code, which is then
  dropped, so no real symbol ever codes as all '1' bits,
- code lengths are rebalanced to <= 16 bits by moving leaf pairs up the tree,
- ties during the merge are broken by symbol index (larger index wins),
  reproduced here via the same (freq << 9 | index) packed sort keys.
"""

import functools
from dataclasses import dataclass, field

import numpy as np

from . import constants as C
from . import native


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


def _codesizes_python(freq: np.ndarray, size: int) -> list:
    """The Huffman merge of `build_optimal_table` in Python: code lengths
    of `freq[:size]` and of the fake symbol at index `size`.  The parity
    twin of native.huffman_codesizes, which the table build runs."""
    # Pack (freq, index) so sorting breaks frequency ties by index,
    # matching the reference's uint64 keys.
    keys = [(int(freq[i]) << 9) | i for i in range(size) if freq[i] > 0]
    keys.sort(reverse=True)

    codesizes = [0] * (size + 1)
    # members[i]: indices of all leaves currently inside the subtree
    # rooted at slot i (the reference keeps an intrusive linked list).
    members = {i: [i] for i in range(size + 1)}

    # Fake lowest-frequency symbol -> owns the all-ones code, dropped.
    keys.append((1 << 9) | size)

    nb = len(keys)
    while nb > 1:
        s1 = keys[nb - 2]
        s2 = keys[nb - 1]
        i = s1 & 0x1FF
        j = s2 & 0x1FF
        members[i] = members[i] + members[j]
        for leaf in members[i]:
            codesizes[leaf] += 1
        merged = s1 + (s2 & ~0x1FF)
        # insertion into the sorted (decreasing) prefix keys[0:nb-1]
        nb -= 1
        k = nb - 1
        while k > 0 and keys[k - 1] < merged:
            keys[k] = keys[k - 1]
            k -= 1
        keys[k] = merged
        del keys[nb]
    return codesizes


def build_optimal_table(freq: np.ndarray, size: int) -> HuffmanTable:
    """Build a length-limited Huffman table from symbol frequencies.

    `freq` is an integer array of at least `size` entries; `size` is 12
    for DC tables and 256 for AC tables.  Returns the (bits, syms)
    description ready for DHT emission and `build_code_lut`.
    """
    assert size <= 256
    MAX_BITS = 32
    MAX_CODE_SIZE = 16

    nb_syms = int((np.asarray(freq[:size]) > 0).sum())

    codesizes = native.huffman_codesizes(freq, size)

    # Histogram of code lengths (clamping ultra-rare symbols at MAX_BITS).
    cs = np.minimum(np.asarray(codesizes, dtype=np.int64), MAX_BITS)
    nzmask = cs > 0
    bits = np.bincount(cs[nzmask], minlength=MAX_BITS + 1)[1:].tolist()
    max_bit_size = int(cs.max())
    assert int(nzmask.sum()) == nb_syms + 1

    # Sort symbols into increasing-code-length slices; symbols of equal
    # length stay in increasing symbol order.  The fake symbol (#size)
    # reserves the LAST slot of its own length slice, left as 0.
    real = nzmask[:size]
    lens_real = cs[:size][real]
    order = np.argsort(lens_real, kind="stable")
    sorted_syms = np.arange(size)[real][order]
    fake_pos = int((lens_real <= cs[size]).sum())
    syms = np.insert(sorted_syms, fake_pos, 0).astype(np.uint8)

    # Rebalance code lengths to <= 16 bits: move leaf pairs up, sink one leaf.
    for l in range(max_bit_size - 1, MAX_CODE_SIZE - 1, -1):
        while bits[l] > 0:
            k = l - 2
            while bits[k] == 0:
                k -= 1
            bits[l] -= 2
            bits[l - 1] += 1
            bits[k] -= 1
            bits[k + 1] += 2

    # Drop the fake all-ones symbol (always one of the longest codes).
    max_bit_size = MAX_CODE_SIZE
    while bits[max_bit_size - 1] == 0:
        max_bit_size -= 1
        assert max_bit_size > 0
    bits[max_bit_size - 1] -= 1

    return HuffmanTable(
        bits=np.array(bits[:MAX_CODE_SIZE], dtype=np.uint8),
        syms=syms[:nb_syms],
        nb_syms=nb_syms,
    )


@functools.lru_cache(maxsize=1)
def trellis_cost_lens() -> np.ndarray:
    """[2, 256] int32 K.3-default AC code lengths (luma, chroma): the
    pre-optimization rate model the trellis uses on a single pass
    (src/enc.cc:1528).  Read-only, cached."""
    defaults = k3_default_tables()
    lens = np.stack([build_code_lut(defaults[2], 256) & 0xFF,
                     build_code_lut(defaults[3], 256) & 0xFF]).astype(np.int32)
    lens.flags.writeable = False
    return lens


def optimal_tables_from_freqs(freq_dc: np.ndarray, freq_ac: np.ndarray,
                              nb_tables: int = 2):
    """Build [dc_luma, dc_chroma, ac_luma, ac_chroma] from frequency arrays.

    `freq_dc`: [2, 12+] counts of DC size categories; `freq_ac`: [2, 256+]
    counts of AC (run<<4|size) symbols (with 0xF0 escapes and 0x00 EOBs
    already accumulated).  With `nb_tables == 1` (grayscale) only the luma
    pair is built and chroma entries are None.
    """
    tables = [None] * 4
    for c in range(nb_tables):
        tables[c] = build_optimal_table(freq_dc[c], 12)
        tables[2 + c] = build_optimal_table(freq_ac[c], 256)
    return tables
