"""The method-1/3/4 units of the port against the JAX package: coefficient
histograms, the per-image quantizer and MCU interleave, symbol
frequencies, the adaptive-quantization fit, the optimal Huffman tables (on
the device and on the host), and the plain versions of the two kernels of
this path (vlc_pack, merge_codesizes) against the TPU kernels run in
interpret mode.  Inputs come from numpy seeds; every comparison is exact:
the codec is integer code and the fit runs in float64 NumPy on both
sides."""

from unittest import mock

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

from sjpeg_tpu import adaptive as jadaptive
from sjpeg_tpu import engine as jengine
from sjpeg_tpu import huffman as jhuff
from sjpeg_tpu import spec as jspec
from sjpeg_tpu.ops import huffman_device as jhd
from sjpeg_tpu.ops import pallas_vlc_pack as jpv
from sjpeg_tpu.ops import quantize as jquant
from sjpeg_tpu.params import quant_matrices_for_quality as j_qmq

from chip_smoke import adversarial_freq_rows
from sjpeg_tpu_torch import adaptive, engine, huffman, state
from sjpeg_tpu_torch import constants as C
from sjpeg_tpu_torch.ops import huffman_device as hd
from sjpeg_tpu_torch.ops import merge_codesizes as mc
from sjpeg_tpu_torch.ops import quantize, vlc, vlc_pack
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

NB = {C.YUV_420: (4, 1, 1), C.YUV_444: (1, 1, 1), C.YUV_400: (1,)}


def _interpret():
    """Run every pallas_call in interpret mode, as the JAX package's own
    CPU tests do."""
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    return mock.patch.object(pl, "pallas_call", patched)


def _fib_row(n):
    f = [1, 1]
    while len(f) < n:
        f.append(f[-1] + f[-2])
    return f


def _freq_rows(size: int, width: int) -> np.ndarray:
    """[G, width] int32 frequency rows (symbols in the first `size`
    columns): ties, all-zero, single-symbol, Fibonacci-like rows whose
    codes pass 16 bits (the rebalance) and frequencies near 2^30."""
    rng = np.random.RandomState(31 + size)
    rows = []
    rows.append(rng.randint(0, 50, size))                       # random
    rows.append(np.where(rng.rand(size) < 0.5, 7, 0))           # all ties
    rows.append(np.zeros(size, np.int64))                       # empty
    one = np.zeros(size, np.int64)
    one[size // 3] = 12345                                      # one symbol
    rows.append(one)
    two = np.zeros(size, np.int64)
    two[[0, size - 1]] = 3                                      # two, tied
    rows.append(two)
    for n in (24, 40):            # codes past 16 bits; past 32 (clamped)
        fib = np.zeros(size, np.int64)
        n = min(size, n)
        fib[rng.permutation(size)[:n]] = _fib_row(n)
        rows.append(fib)
    big = rng.randint(0, 4, size)
    big[rng.permutation(size)[:3]] = [(1 << 30) - 1, 1 << 29, (1 << 28) + 5]
    rows.append(big)                                            # near 2^30
    skew = (rng.pareto(1.2, size) * 40).astype(np.int64) * (
        rng.rand(size) < 0.7)
    rows.append(skew)
    out = np.zeros((len(rows), width), np.int32)
    out[:, :size] = np.stack(rows)
    return out


@pytest.mark.parametrize("size,width", [(12, 16), (256, 320)])
def test_optimal_code_luts_matches_jax(size, width):
    """LUTs, code-length counts, symbol counts and DHT order of the torch
    twin == sjpeg_tpu.ops.huffman_device.optimal_code_luts (the lax.scan
    merge on the CPU backend), including the rebalance and empty rows."""
    freq = _freq_rows(size, width)
    want = jhd.optimal_code_luts(jnp.asarray(freq), size, with_syms=True)
    got = hd.optimal_code_luts(torch.from_numpy(freq), size, with_syms=True)
    np.testing.assert_array_equal(got[0].numpy().view(np.uint32),
                                  np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert bool((got[1][:, 15] > 0).any()) == (size > 16)   # rebalanced


@pytest.mark.parametrize("size,width", [(12, 16), (256, 320)])
def test_optimal_code_luts_plain_matches_jax_on_edge_rows(size, width):
    """optimal_code_luts_plain == sjpeg_tpu.ops.huffman_device.
    optimal_code_luts on the row kinds the table kernel must meet that
    _freq_rows lacks (chip_smoke.adversarial_freq_rows): ties everywhere,
    an empty row, one symbol at either end, Fibonacci rows past 32 bits
    (the rebalance and the clamp), and sums that wrap past 2^31, where the
    fake symbol lands before symbol 0; 9 rows, the shape _freq_rows gives,
    so that the JAX function compiles once."""
    freq = adversarial_freq_rows(size, width, 52)[
        [0, 2, 3, 4, 10, 11, 13, 14, 15]]
    want = jhd.optimal_code_luts(jnp.asarray(freq), size, with_syms=True)
    merged = []                  # the merge's code sizes, slot `size` the fake
    plain = mc.merge_codesizes_plain

    def record(*args):
        merged.append(plain(*args))
        return merged[-1]

    with mock.patch.object(mc, "merge_codesizes_plain", record):
        got = hd.optimal_code_luts_plain(torch.from_numpy(freq), size,
                                         with_syms=True)
    np.testing.assert_array_equal(got[0].numpy().view(np.uint32),
                                  np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    cs = merged[0].clamp(max=32).numpy()
    assert ((freq[:, 0] > 0) & (cs[:, 0] > cs[:, size])).any()  # fake first
    assert (cs[:, :size] > 16).any() == (size > 16)        # rebalanced


@pytest.mark.parametrize("nb_tables", [1, 2])
def test_device_tables_match_host_tables(nb_tables):
    """luts_and_desc_from_freqs -> desc_to_flat -> tables_from_flat ==
    the host build (the port's and the JAX package's
    optimal_tables_from_freqs) and the JAX device description, for each
    image of a batch of adversarial frequency rows; the LUTs equal
    build_code_lut of those tables."""
    dc = _freq_rows(12, 12)
    ac = _freq_rows(256, 256)
    live = [i for i in range(len(dc)) if dc[i].any() and ac[i].any()]
    dc, ac = dc[live], ac[live]
    b = len(dc) // 2
    fdc, fac = dc[:2 * b].reshape(b, 2, 12), ac[:2 * b].reshape(b, 2, 256)

    dcl, acl, nbs, desc = hd.luts_and_desc_from_freqs(
        torch.from_numpy(fdc), torch.from_numpy(fac), nb_tables)
    flat = hd.desc_to_flat(nbs, desc).numpy()
    jdcl, jacl, jnbs, jdesc = jhd.luts_and_desc_from_freqs(
        jnp.asarray(fdc), jnp.asarray(fac), nb_tables)
    np.testing.assert_array_equal(flat,
                                  np.asarray(jhd.desc_to_flat(jnbs, jdesc)))
    np.testing.assert_array_equal(dcl.numpy().view(np.uint32),
                                  np.asarray(jdcl))
    np.testing.assert_array_equal(acl.numpy().view(np.uint32),
                                  np.asarray(jacl))
    for i in range(b):
        got = hd.tables_from_flat(flat, i, nb_tables)
        host = huffman.optimal_tables_from_freqs(fdc[i], fac[i], nb_tables)
        jhost = jhuff.optimal_tables_from_freqs(fdc[i], fac[i], nb_tables)
        for t in range(4):
            hosts = (host[t], jhost[t])
            if host[t] is None:          # gray: chroma tables are K.3
                hosts = (huffman.k3_default_tables()[t],)
            for h in hosts:
                assert got[t].nb_syms == h.nb_syms
                np.testing.assert_array_equal(got[t].bits, h.bits)
                np.testing.assert_array_equal(got[t].syms, h.syms)
        for c in range(nb_tables):
            if sum(int(host[t].bits.sum()) != host[t].nb_syms
                   for t in (c, 2 + c)):
                continue      # clamped past 32 bits: no canonical code
            np.testing.assert_array_equal(
                dcl[i, c].numpy().view(np.uint32),
                huffman.build_code_lut(host[c], 16))
            np.testing.assert_array_equal(
                acl[i, c].numpy().view(np.uint32),
                huffman.build_code_lut(host[2 + c], 256))


def test_merge_codesizes_plain_matches_pallas_interpret():
    """merge_codesizes_plain == the TPU kernel _merge_codesizes_pallas in
    interpret mode, on the merge states that optimal_code_luts hands the
    kernel for the adversarial rows (DC W = 16, AC W = 320)."""
    states = []
    plain = mc.merge_codesizes_plain

    def record(*args):
        states.append(args)
        return plain(*args)

    with mock.patch.object(mc, "merge_codesizes_plain", record):
        for size, width in [(12, 16), (256, 320)]:
            hd.optimal_code_luts(torch.from_numpy(_freq_rows(size, width)),
                                 size)
    assert len(states) == 2
    with _interpret():
        for freqw, act, comp, cs, nleft, steps in states:
            want = jhd._merge_codesizes_pallas(
                *(jnp.asarray(t.numpy()) for t in (freqw, act, comp, cs,
                                                   nleft)), steps)
            got = mc.merge_codesizes_plain(freqw, act, comp, cs, nleft,
                                           steps)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _quantized_blocks(rng, n):
    """[n, 64] int32 quantized blocks with long zero runs (ZRLs), dense
    rows, empty rows and a coded last position."""
    q = rng.randint(-300, 301, (n, 64)) * (rng.rand(n, 64) < 0.15)
    q[::7] = rng.randint(-3, 4, (len(q[::7]), 64))              # dense
    q[1::7, 1:] = 0                                             # DC only
    q[2::7, 1:63] = 0                                           # long run
    q[2::7, 63] = 5
    return q.astype(np.int32)


@pytest.mark.parametrize("per_image", [False, True])
def test_vlc_pack_plain_matches_pallas_interpret(per_image):
    """vlc_pack_plain == the TPU kernel vlc_pack_pallas in interpret mode,
    with shared LUTs and with one LUT set per image; 3 images of 48 blocks
    (not a multiple of 128), each with its own optimal tables."""
    b, per_img = 3, 48
    n = b * per_img
    rng = np.random.RandomState(33)
    q = _quantized_blocks(rng, n)
    rl = vlc.run_levels(torch.from_numpy(q), torch.int32)
    dc = vlc.dc_diff_codes(torch.from_numpy(rng.randint(-1023, 1024, n)), b)
    group = torch.from_numpy((np.arange(n) % 6 >= 4).astype(np.int32))
    freq_dc, freq_ac = vlc.grouped_stats(rl, dc, group, b)
    dcl, acl, _, _ = hd.luts_and_desc_from_freqs(freq_dc, freq_ac)
    if not per_image:
        dcl, acl = dcl[1], acl[1]

    got_w, got_b = vlc_pack.vlc_pack(rl["run"], rl["size"], rl["code"], dc,
                                     group, dcl, acl)
    with _interpret():
        want_w, want_b = jpv.vlc_pack_pallas.__wrapped__(
            *(jnp.asarray(rl[k].numpy()) for k in ("run", "size", "code")),
            jnp.asarray(dc.numpy()), jnp.asarray(group.numpy()),
            jnp.asarray(dcl.numpy().view(np.uint32)),
            jnp.asarray(acl.numpy().view(np.uint32)), tile=16,
            tiles_per_img=per_img // 16 if per_image else 0)
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    got_w = got_w.numpy().view(np.uint32)
    want_w = np.asarray(want_w)
    for i in range(n):
        nw = (int(want_b[i]) + 31) // 32
        np.testing.assert_array_equal(got_w[i, :nw], want_w[i, :nw])
        assert not got_w[i, nw:].any()


@pytest.mark.parametrize("n_images", [1, 3])
def test_store_histo_matches_jax(n_images):
    """Per-image segmented [B, 64, bins] (or summed [64, bins]) histograms
    of |c| >> HSHIFT; magnitudes past the last bin are dropped."""
    rng = np.random.RandomState(34)
    c = rng.randint(-700, 701, (n_images * 40, 64)).astype(np.int32)
    c[::3] //= 9
    got = quantize.store_histo(torch.from_numpy(c), n_images)
    want = jquant.store_histo(jnp.asarray(c), n_images)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _coeffs(rng, mode, b, mcu):
    """Per-component [N_c, 64] int32 fDCT-like coefficients, image-major,
    with `mcu` MCUs per image."""
    scale = 96 * np.exp(-np.arange(64) / 10.0)
    return [np.round(rng.laplace(0, 1, (b * mcu * nb, 64))
                     * scale).astype(np.int32) for nb in NB[mode]]


def _quant_rows(b):
    """Shared [2, 64] and per-image [b, 2, 64] iquant/bias rows."""
    rows = []
    for q in [75, 40, 92][:b]:
        qms = [jspec.finalize_quant_matrix(j_qmq(q)[i], np.ones(64, np.uint8),
                                           C.DEFAULT_BIAS) for i in range(2)]
        rows.append([np.stack([m[k] for m in qms]).astype(np.int32)
                     for k in ("iquant", "bias")])
    return rows[0], [np.stack(a) for a in zip(*rows)]


@pytest.mark.parametrize("mode", [C.YUV_420, C.YUV_400])
@pytest.mark.parametrize("per_image", [False, True])
def test_interleave_and_grouped_stats_match_jax(mode, per_image):
    """The engine's quantize stage on the CPU (`_stage_batch_quantize`:
    _interleave_coeffs, then vlc_fields' plain twin; int32 fields,
    per-image DC reset, groups, and per-image [B, 2, 12] / [B, 2, 256]
    frequencies with ZRL and EOB counts, or unbatched for the whole batch)
    == the JAX engine's _interleave_quantized + _grouped_stats."""
    b, mcu = 3, 6
    cs = _coeffs(np.random.RandomState(35), mode, b, mcu)
    shared, per = _quant_rows(b)
    iq, ib = per if per_image else shared
    jrl, jdc, jgroup = jengine._interleave_quantized(
        [jnp.asarray(c) for c in cs], jnp.asarray(iq), jnp.asarray(ib),
        NB[mode], b)
    for stats_images in (1, b):
        (rl, dc, group), got = engine._stage_batch_quantize(
            [torch.from_numpy(c) for c in cs], *state.arrays_to_device(
                iq, ib, device="cpu"), True, NB[mode], b, stats_images)
        for k in ("nz", "run", "size", "code", "last"):
            assert rl[k].dtype in (torch.bool, torch.int32, torch.int64)
            np.testing.assert_array_equal(rl[k].numpy(), np.asarray(jrl[k]))
        assert rl["run"].dtype == torch.int32
        np.testing.assert_array_equal(dc.numpy(), np.asarray(jdc))
        np.testing.assert_array_equal(group.numpy(), np.asarray(jgroup))
        want = jengine._grouped_stats(jrl, jdc, jgroup, stats_images)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("qdelta_max,quality", [(12, 75), (1, 75), (6, 30)])
def test_analyse_histo_matches_jax(qdelta_max, quality):
    """The host lambda fit == sjpeg_tpu.adaptive.analyse_histo (luma and
    chroma qdelta_max) on histograms of three images' coefficients."""
    changed = []
    for seed in range(3):
        cs = _coeffs(np.random.RandomState(36 + seed), C.YUV_420, 1, 24)
        histo = quantize.store_histo(torch.from_numpy(
            np.concatenate(cs)), 1).numpy().astype(np.int64)
        quant = j_qmq(quality)[0 if qdelta_max > 1 else 1]
        min_quant = np.ones(64, np.uint8)
        got = adaptive.analyse_histo(histo, quant, min_quant, qdelta_max)
        want = jadaptive.analyse_histo(histo, quant, min_quant, qdelta_max)
        np.testing.assert_array_equal(got, want)
        changed.append((got != quant).any())
    assert any(changed)                  # the fit moved some quantizer


def test_build_optimal_table_matches_jax_host():
    """The port's host table build == the JAX package's, row by row."""
    for size, width in [(12, 16), (256, 320)]:
        for row in _freq_rows(size, width):
            if not row[:size].any():
                continue
            got = huffman.build_optimal_table(row.astype(np.int64), size)
            want = jhuff.build_optimal_table(row.astype(np.int64), size)
            assert got.nb_syms == want.nb_syms
            np.testing.assert_array_equal(got.bits, want.bits)
            np.testing.assert_array_equal(got.syms, want.syms)
