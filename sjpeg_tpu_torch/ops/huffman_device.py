"""Optimal Huffman tables built on the device, for a batch of tables.

A torch twin of sjpeg_tpu/ops/huffman_device.py: byte-exact with
huffman.build_optimal_table + build_code_lut (the reference's
BuildOptimalTable / BuildHuffmanTable, src/enc.cc:1311-1487 and
:433-463), vectorized over rows so that per-image tables never leave the
card until the DHT description is fetched with the streams.  On CUDA
tensors the merge_codesizes kernel builds every table of a call in one
launch and nothing is read back; on CPU tensors `optimal_code_luts_plain`
builds them in torch, its merge loop being
`merge_codesizes.merge_codesizes_plain`:

- a fake lowest-frequency symbol (slot `size`, freq 1) owns the all-ones
  code and is dropped at the end; its first merge absorbs it into the
  smallest-key real symbol, because the host appends it to the sorted key
  list without re-sorting;
- code lengths clamp at 32, rebalance to <= 16 by the pair-up/leaf-down
  moves (a loop on a device `any`, one host read per iteration, counted in
  `optimal_code_luts.any_reads`), then the fake's slot leaves the longest
  length;
- symbols sort by (codesize, symbol) with the fake INSERTED at position
  #(real codesizes <= fake codesize) and the list truncated to nb_syms;
  canonical codes assign first-code-per-length running counters; the LUT
  entry is (code << 16) | length, 0 for absent symbols, symbol 0's
  duplicate write resolved last-position-wins like numpy's fancy
  assignment in the host version.

Frequencies are int32 and add with wraparound, as in the JAX version.
LUTs come back as int32 tensors holding the uint32 bit patterns.
"""

import numpy as np
import torch

from ..huffman import HuffmanTable, k3_default_tables
from . import merge_codesizes
from .merge_codesizes import BIG


def _first_codes(bits16: torch.Tensor):
    """[G, 16] codes per length -> (first code of each length, exclusive
    count of codes before it), both [G, 16]."""
    first = torch.zeros_like(bits16[:, 0])
    cum = torch.zeros_like(first)
    firsts, cume = [], []
    for l in range(16):
        firsts.append(first)
        cume.append(cum)
        first = (first + bits16[:, l]) << 1
        cum = cum + bits16[:, l]
    return torch.stack(firsts, dim=1), torch.stack(cume, dim=1)


def optimal_code_luts_plain(freq: torch.Tensor, size: int,
                            lut_size: int = 0, with_syms: bool = False):
    """The plain PyTorch version of `optimal_code_luts`, on any device;
    same arguments and results.  Its rebalance reads a device flag on the
    host each turn (`optimal_code_luts.any_reads`).

    [G, W] int32 frequencies -> (lut [G, lut_size] int32 bit patterns,
    bits [G, 16] int32, nb_syms [G] int32[, syms [G, size] int32]).

    `size` = symbol count (12 for DC, 256 for AC); W must be >= size+1
    (slot `size` holds the fake symbol).  Rows with all-zero frequencies
    give all-zero LUTs.  with_syms also returns the symbol at each code
    position (the DHT emission order; the first nb_syms entries count,
    including the host's inserted-0 artifact at the fake position)."""
    if lut_size == 0:
        lut_size = size if size > 16 else 16
    G, W = freq.shape
    assert W >= size + 1
    dev = freq.device
    i32 = torch.int32
    slots = torch.arange(W, dtype=i32, device=dev)[None, :]
    freq = freq.to(i32)

    real0 = (freq > 0) & (slots < size)
    nb_syms = real0.sum(dim=1, dtype=i32)                  # [G]
    freqw = torch.where(slots == size, 1, torch.where(real0, freq, 0)).to(i32)
    active0 = real0 | (slots == size)
    empty = nb_syms == 0

    # ---- first merge: the fake into the smallest-key real symbol ------
    do0 = (~empty)[:, None]
    fm0 = torch.where(real0, freqw, BIG)
    f1r = fm0.min(dim=1, keepdim=True).values
    i1f = torch.where(real0 & (fm0 == f1r), slots, W).min(
        dim=1, keepdim=True).values
    freqw = torch.where(do0 & (slots == i1f), freqw + 1, freqw)
    active = active0 & ~(do0 & (slots == size))
    cs = (do0 & ((slots == i1f) | (slots == size))).to(i32)
    comp = torch.where(do0 & (slots == size), i1f, slots).to(i32)
    nleft = nb_syms + 1 - do0[:, 0].to(i32)

    # ---- merge loop: nb_active-1 steps ------------------------------
    cs = merge_codesizes.merge_codesizes_plain(freqw, active, comp, cs,
                                               nleft, max(size - 1, 1))
    cs = torch.where(active0, cs.clamp(max=32), 0)        # MAX_BITS clamp

    # ---- length histogram + rebalance to <= 16 ----------------------
    li = torch.arange(32, dtype=i32, device=dev)[None, :]
    ls = li + 1
    bits32 = ((cs[:, :, None] == ls[:, None, :]) & active0[:, :, None]).sum(
        dim=1, dtype=i32)                                  # [G, 32]
    optimal_code_luts.any_reads += 1
    # no code longer than 16 bits: every loop below would stop at once
    rebalance = bool((bits32[:, 16:] != 0).any())
    for l in range(31, 15, -1) if rebalance else ():
        # move pairs of length l+1 up while any row still has them
        while True:
            act = bits32[:, l] > 0                         # [G]
            optimal_code_luts.any_reads += 1
            if not bool(act.any()):
                break
            # the host's downward walk stops at the first NONZERO count
            # (which can transiently be negative), not the first positive
            k = torch.where((li <= l - 2) & (bits32 != 0), li, -1).amax(
                dim=1, keepdim=True)                       # [G, 1]
            delta = (2 * (li == k + 1).to(i32) - (li == k).to(i32)
                     + (li == l - 1).to(i32) - 2 * (li == l).to(i32))
            bits32 = torch.where(act[:, None], bits32 + delta, bits32)

    # drop the fake all-ones symbol from the longest populated length
    li16 = li[:, :16]
    mx = torch.where(bits32[:, :16] != 0, li16, 0).amax(dim=1)
    bits16 = bits32[:, :16] - (li16 == mx[:, None]).to(i32)
    bits16 = torch.where(empty[:, None], 0, bits16)        # [G, 16]

    # ---- symbol ranks (stable (codesize, symbol) order) -------------
    real = real0[:, :size]
    csx = torch.where(real, cs[:, :size], 99)              # inactive last
    # rank = #(j: cs_j < cs_s) + #(j < s: cs_j == cs_s), real only
    sym = torch.arange(size, device=dev)
    lt = (csx[:, :, None] > csx[:, None, :]) & real[:, None, :]
    eq = ((csx[:, :, None] == csx[:, None, :]) & real[:, None, :]
          & (sym[None, None, :] < sym[None, :, None]))
    rank = (lt | eq).sum(dim=2, dtype=i32)                 # [G, size]
    fake_pos = (real & (csx <= cs[:, size:size + 1])).sum(
        dim=1, keepdim=True, dtype=i32)
    pos = rank + (rank >= fake_pos).to(i32)                # final position

    # ---- canonical codes from the final bits ------------------------
    firsts, cume = _first_codes(bits16)
    cums = cume + bits16
    p_ok = real & (pos < nb_syms[:, None])
    len_p = (cums[:, None, :] <= pos[:, :, None]).sum(dim=2, dtype=i32) + 1
    lidx = (len_p - 1).clamp(0, 15).long()
    code_p = (firsts.gather(1, lidx) + pos - cume.gather(1, lidx)).long()
    packed = torch.where(p_ok, (code_p << 16) | len_p.long(), 0)

    # symbol 0: the fake inserts a 0 at fake_pos when fake_pos < nb_syms,
    # and numpy's fancy assignment gives the LAST write (the higher
    # position) to the duplicated symbol
    fp = fake_pos[:, 0]
    fake_in = fp < nb_syms
    f_lidx = (cums <= fp[:, None]).sum(dim=1).clamp(0, 15)[:, None]
    f_code = (firsts.gather(1, f_lidx) + fp[:, None]
              - cume.gather(1, f_lidx))[:, 0].long()
    f_packed = (f_code << 16) | (f_lidx[:, 0] + 1)
    sym0_use_fake = fake_in & (~p_ok[:, 0] | (fp > pos[:, 0]))
    packed[:, 0] = torch.where(sym0_use_fake, f_packed, packed[:, 0])
    if lut_size > size:
        packed = torch.nn.functional.pad(packed, (0, lut_size - size))
    else:
        packed = packed[:, :lut_size]
    lut = torch.where(packed >= 1 << 31, packed - (1 << 32), packed).to(i32)
    if not with_syms:
        return lut, bits16, nb_syms
    # symbol at each position (DHT order); the fake position keeps the
    # initial 0, exactly the host's np.insert(..., fake_pos, 0) artifact
    pos_c = torch.where(p_ok, pos, size).long()            # out of range
    syms = torch.zeros((G, size + 1), dtype=i32, device=dev).scatter_(
        1, pos_c, sym[None, :].expand(G, size).to(i32))[:, :size]
    return lut, bits16, nb_syms, syms


def _tables(jobs):
    """[(freq [G, W] int32, size, lut_size), ...] on one device -> for
    each, (lut, bits, nb_syms, syms): one kernel launch for all of them on
    CUDA tensors, the plain version on CPU tensors."""
    if jobs[0][0].device.type == "cpu":
        return [optimal_code_luts_plain(f, size, lut, with_syms=True)
                for f, size, lut in jobs]
    return merge_codesizes.optimal_tables(
        [(f.to(torch.int32).contiguous(), size, lut)
         for f, size, lut in jobs])


def optimal_code_luts(freq: torch.Tensor, size: int, lut_size: int = 0,
                      with_syms: bool = False):
    """[G, W] int32 frequencies -> (lut [G, lut_size] int32 bit patterns,
    bits [G, 16] int32, nb_syms [G] int32[, syms [G, size] int32]), as
    `optimal_code_luts_plain` gives them: from one merge_codesizes launch
    on a CUDA tensor, with no host read, and from the plain version on a
    CPU tensor.  `size` = symbol count (12 for DC, 256 for AC); W must be
    >= size+1 (slot `size` holds the fake symbol); lut_size 0 means
    max(size, 16)."""
    if lut_size == 0:
        lut_size = size if size > 16 else 16
    out = _tables([(freq, size, lut_size)])[0]
    return out if with_syms else out[:3]


optimal_code_luts.any_reads = 0


def table_jobs(freq_dc, freq_ac, nb_tables: int = 2):
    """[B, 2, 12+] DC and [B, 2, 256+] AC frequencies -> the two jobs of
    one table build, [(DC rows [B * 2, 16], 12, 16), (AC rows [B * 2,
    320], 256, 256)] as (int32 frequencies, size, lut_size), slot `size`
    being the fake symbol's.  With nb_tables == 1 (gray) the chroma rows
    get zero frequencies."""
    B = freq_dc.shape[0]
    fdc = freq_dc.reshape(B * 2, -1)[:, :12].to(torch.int32)
    fac = freq_ac.reshape(B * 2, -1)[:, :256].to(torch.int32)
    if nb_tables == 1:
        keep = (torch.arange(B * 2, device=fdc.device) % 2 == 0)[:, None]
        fdc = torch.where(keep, fdc, 0)
        fac = torch.where(keep, fac, 0)
    fdc = torch.nn.functional.pad(fdc, (0, 16 - 12))
    fac = torch.nn.functional.pad(fac, (0, 257 + 63 - 256))
    return [(fdc, 12, 16), (fac, 256, 256)]


def luts_and_desc_from_freqs(freq_dc, freq_ac, nb_tables: int = 2):
    """[B, 2, 12+] DC and [B, 2, 256+] AC frequencies -> (dc_luts
    [B, 2, 16], ac_luts [B, 2, 256] int32 bit patterns, nb_syms [B, 4],
    desc = (dc_bits [B, 2, 16], ac_bits [B, 2, 16], dc_syms [B, 2, 12],
    ac_syms [B, 2, 256])), all on the frequencies' device, from one
    merge_codesizes launch on CUDA tensors.  With nb_tables == 1 (gray)
    the chroma rows get zero frequencies and zero LUTs, never read by the
    pack."""
    B = freq_dc.shape[0]
    (dc_luts, dc_bits, nb_dc, dc_syms), (ac_luts, ac_bits, nb_ac,
                                         ac_syms) = _tables(
        table_jobs(freq_dc, freq_ac, nb_tables))
    nb = torch.cat([nb_dc.reshape(B, 2), nb_ac.reshape(B, 2)], dim=1)
    desc = (dc_bits.reshape(B, 2, 16), ac_bits.reshape(B, 2, 16),
            dc_syms.reshape(B, 2, 12), ac_syms.reshape(B, 2, 256))
    return dc_luts.reshape(B, 2, 16), ac_luts.reshape(B, 2, 256), nb, desc


def desc_to_flat(nbs, desc):
    """(nb_syms [B, 4], desc tensors) -> one [B, 604] int32 tensor, so the
    whole DHT description rides a single fetch."""
    B = nbs.shape[0]
    return torch.cat([nbs.to(torch.int32)]
                     + [d.reshape(B, -1).to(torch.int32) for d in desc],
                     dim=1)


def tables_from_flat(flat_np, i: int, nb_tables: int = 2):
    """Fetched [B, 604] desc_to_flat array -> image i's HuffmanTables."""
    nbs = flat_np[:, 0:4]
    desc = (flat_np[:, 4:36].reshape(-1, 2, 16),
            flat_np[:, 36:68].reshape(-1, 2, 16),
            flat_np[:, 68:92].reshape(-1, 2, 12),
            flat_np[:, 92:604].reshape(-1, 2, 256))
    return tables_from_desc(nbs, desc, i, nb_tables)


def tables_from_desc(nbs_np, desc_np, i: int, nb_tables: int = 2):
    """Fetched nb_syms [B, 4] + desc arrays -> image i's four HuffmanTables
    ([dc_l, dc_c, ac_l, ac_c]; chroma entries are the K.3 defaults when
    nb_tables == 1), identical to huffman.optimal_tables_from_freqs for
    the same frequencies."""
    dc_bits, ac_bits, dc_syms, ac_syms = desc_np
    tables = [None] * 4
    for c in range(nb_tables):
        ndc = int(nbs_np[i, c])
        nac = int(nbs_np[i, 2 + c])
        tables[c] = HuffmanTable(
            bits=dc_bits[i, c].astype(np.uint8),
            syms=dc_syms[i, c, :ndc].astype(np.uint8), nb_syms=ndc)
        tables[2 + c] = HuffmanTable(
            bits=ac_bits[i, c].astype(np.uint8),
            syms=ac_syms[i, c, :nac].astype(np.uint8), nb_syms=nac)
    if nb_tables == 1:
        defaults = k3_default_tables()
        tables[1], tables[3] = defaults[1], defaults[3]
    return tables
