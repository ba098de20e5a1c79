"""The port's method-0 kernels: their plain PyTorch versions against the
JAX package (XLA chain and the Pallas kernel in interpret mode), and the
shared CUDA arithmetic compiled for the host (block_core.cuh: sample_pack's
per-block encode, the serial quantize and emit, quant_pack's coded walk
over zigzag-staged coefficients, the dense and the coded-position emission
walks, the zigzag lookups; concat_core.cuh: stream_concat's per-block
placement).  Comparisons are exact.
The CUDA launches themselves are tested in test_torch_cuda.py."""

import ast
import ctypes
import functools
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sjpeg_tpu import constants as JC
from sjpeg_tpu import engine as jengine
from sjpeg_tpu import spec as jspec
from sjpeg_tpu.huffman import k3_default_tables as j_k3
from sjpeg_tpu.ops import colorspace as jcs
from sjpeg_tpu.ops import fdct as jfdct
from sjpeg_tpu.ops import pack as jpack
from sjpeg_tpu.ops import vlc as jvlc
from sjpeg_tpu.params import quant_matrices_for_quality as j_qmq

from chip_smoke import random_streams
from sjpeg_tpu_torch import constants as C
from sjpeg_tpu_torch import engine, state
from sjpeg_tpu_torch.ops import (colorspace, quantize, sample_pack,
                                 stream_concat, vlc)
from sjpeg_tpu_torch.params import TARGET_SIZE, EncoderParam, SearchHook

REPO = Path(__file__).resolve().parents[1]
NB = {C.YUV_420: (4, 1, 1), C.YUV_444: (1, 1, 1), C.YUV_400: (1,)}


def _rgb(rng, b, h, w):
    rgb = rng.randint(0, 256, (b, h, w, 3)).astype(np.uint8)
    rgb[0, :16, :16] = [0, 0, 255]       # U = +128
    rgb[-1, 16:, 16:] = [255, 0, 0]      # V = +128
    return rgb


def _tables(q):
    """(JAX qms, numpy iq, ib, dc LUTs, AC LUTs) for quality q."""
    qms = [jspec.finalize_quant_matrix(j_qmq(q)[i], np.ones(64, np.uint8),
                                       JC.DEFAULT_BIAS) for i in range(2)]
    iq, ib = jengine._quant_device_arrays(qms)
    dcl, acl = jengine._device_luts(j_k3())
    return qms, [np.asarray(a) for a in (iq, ib, dcl, acl)]


def _port_inputs(rgb, mode, tables, device="cpu"):
    """The port's interleaved samples, DC codes and groups for `rgb`."""
    b, h, w = rgb.shape[:3]
    t = state.tables_from_numpy(*tables, device)
    blocks = colorspace.rgb_to_blocks(torch.from_numpy(rgb).to(device),
                                      mode, w, h)
    return engine._interleave_samples(blocks, t[0], t[1], NB[mode], b), t


@pytest.mark.parametrize("mode", [C.YUV_420, C.YUV_444, C.YUV_400])
def test_sample_pack_plain_matches_jax_chain(mode):
    """Port interleave + sample_pack_plain == the JAX CPU chain
    fdct -> _interleave_quantized -> block_entries_grouped ->
    pack_block_entries, over a two-image batch (DC chain reset)."""
    b, h, w = 2, 40, 24
    rgb = _rgb(np.random.RandomState(11), b, h, w)
    _, arrays = _tables(75)
    iq, ib, dcl, acl = (jnp.asarray(a) for a in arrays)
    jblocks = jcs.rgb_to_blocks(jnp.asarray(rgb), mode, w, h)
    rl, jdc, jgroup = jengine._interleave_quantized(
        [jfdct.fdct_blocks(x) for x in jblocks], iq, ib, NB[mode], b)
    want_w, want_b = jpack.pack_block_entries(
        *jvlc.block_entries_grouped(rl, jdc, dcl, acl, jgroup))

    (sinter, dc, group), t = _port_inputs(rgb, mode, arrays)
    np.testing.assert_array_equal(dc.numpy(), np.asarray(jdc))
    np.testing.assert_array_equal(group.numpy(), np.asarray(jgroup))
    words, bits = sample_pack.sample_pack(sinter, dc, group, *t)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(want_b))
    np.testing.assert_array_equal(words.numpy().view(np.uint32),
                                  np.asarray(want_w))


def test_sample_pack_plain_matches_pallas_interpret():
    """sample_pack_plain == the TPU kernel sample_vlc_pack_pallas run in
    interpret mode on the same batch, with saturated chroma (+128, which
    the TPU's int8 transport wraps and the kernel decodes)."""
    from jax.experimental import pallas as pl
    from sjpeg_tpu.ops import pallas_quant_pack as pqp

    b, h, w = 2, 48, 64
    rgb = _rgb(np.random.RandomState(12), b, h, w)
    _, arrays = _tables(75)
    iq, ib, dcl, acl = (jnp.asarray(a) for a in arrays)
    b8 = jcs.rgb_to_blocks(jnp.asarray(rgb), C.YUV_420, w, h,
                           out_dtype=jnp.int8)
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    pl.pallas_call = patched
    try:
        s8, jdc, jgroup = jengine._interleave_samples(
            b8, iq, ib, NB[C.YUV_420], n_images=b, chroma_wrap=True)
        want_w, want_b = pqp.sample_vlc_pack_pallas.__wrapped__(
            s8, jdc, jgroup, iq, ib, dcl, acl, tile=16, chroma_wrap=True)
    finally:
        pl.pallas_call = orig

    (sinter, dc, group), t = _port_inputs(rgb, C.YUV_420, arrays)
    assert (sinter == 128).any()
    np.testing.assert_array_equal(dc.numpy(), np.asarray(jdc))
    words, bits = sample_pack.sample_pack_plain(sinter, dc, group, *t)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(want_b))
    np.testing.assert_array_equal(words.numpy().view(np.uint32),
                                  np.asarray(want_w))


_HOST_SHIM = """
#define __host__
#define __device__
// quant_emit_coded's emission never overtakes a coefficient still to be
// read: count the reads it would have to make from the raster source
static int source_reads = 0;
#define SJ_CHECK_IN_PLACE(in_place) (source_reads += !(in_place))
#include "block_core.cuh"
#include "concat_core.cuh"
extern "C" void quant_emit_blocks(const int32_t* coeffs, const int32_t* dc,
                                  const int32_t* group, const uint32_t* iq,
                                  const uint32_t* ib, const uint32_t* dcl,
                                  const uint32_t* acl, uint32_t* words,
                                  int32_t* bits, int n) {
  for (int b = 0; b < n; ++b)
    bits[b] = sjpeg::quant_emit_block((const uint32_t*)coeffs + 64 * b,
                                      (uint32_t)dc[b], group[b], iq, ib,
                                      dcl, acl, words + 64 * b);
}
extern "C" void encode_blocks(const int32_t* samples, const int32_t* dc,
                              const int32_t* group, const uint32_t* iq,
                              const uint32_t* ib, const uint32_t* dcl,
                              const uint32_t* acl, uint32_t* words,
                              int32_t* bits, int n) {
  for (int b = 0; b < n; ++b) {
    uint32_t x[64];
    for (int k = 0; k < 64; ++k) x[k] = (uint32_t)samples[64 * b + k];
    bits[b] = sjpeg::encode_block(x, (uint32_t)dc[b], group[b], iq, ib,
                                  dcl, acl, words + 64 * b);
  }
}
extern "C" void emit_blocks(const int32_t* run, const int32_t* size,
                            const int32_t* code, const int32_t* dc,
                            const int32_t* group, const uint32_t* dcl,
                            const uint32_t* acl, uint32_t* words,
                            int32_t* bits, int n, int per_img, int n_sets) {
  for (int b = 0; b < n; ++b) {
    const int set = n_sets > 1 ? b / per_img : 0;
    const int g = group[b] & 1;
    const int64_t row = 64 * (int64_t)b;
    auto fields = [&](int k, uint32_t& r, uint32_t& s, uint32_t& c) {
      r = (uint32_t)run[row + k];
      s = (uint32_t)size[row + k];
      c = (uint32_t)code[row + k];
    };
    bits[b] = sjpeg::emit_block((uint32_t)dc[b], dcl + 32 * set + 16 * g,
                                acl + 512 * set + 256 * g, fields,
                                words + row);
  }
}
// As vlc_pack's kernel: each row of `words` first holds the packed fields
// (run << 21 | size << 16 | code), and emit_coded writes the stream over
// them.  Returns how many fields were read out of place.
extern "C" int emit_coded_blocks(const int32_t* run, const int32_t* size,
                                 const int32_t* code, const int32_t* dc,
                                 const int32_t* group, const uint32_t* dcl,
                                 const uint32_t* acl, uint32_t* words,
                                 int32_t* bits, int n, int per_img,
                                 int n_sets) {
  int out_of_place = 0;
  for (int b = 0; b < n; ++b) {
    const int set = n_sets > 1 ? b / per_img : 0;
    const int g = group[b] & 1;
    const int64_t row = 64 * (int64_t)b;
    uint32_t* w = words + row;
    auto packed = [&](int k) {
      return ((uint32_t)run[row + k] << 21) |
             ((uint32_t)size[row + k] << 16) | (uint32_t)code[row + k];
    };
    uint64_t mask = 0;
    for (int k = 0; k < 64; ++k) {
      w[k] = packed(k);
      if (k > 0 && size[row + k] != 0) mask |= (uint64_t)1 << k;
    }
    auto field = [&](int k, bool in_place) {
      out_of_place += !in_place;
      return in_place ? w[k] : packed(k);
    };
    bits[b] = sjpeg::emit_coded((uint32_t)dc[b], dcl + 32 * set + 16 * g,
                                acl + 512 * set + 256 * g, mask, field, w);
  }
  return out_of_place;
}
// As quant_pack's kernel: each block's coefficients staged in zigzag order
// into its word row, the quantizer rows permuted to zigzag order, then
// quant_emit_coded in place.  Returns how many coefficients it found
// overtaken by the stream, each of which would have to be read again from
// its raster source.
extern "C" int quant_emit_coded_blocks(const int32_t* coeffs,
                                       const int32_t* dc,
                                       const int32_t* group,
                                       const uint32_t* iq,
                                       const uint32_t* ib,
                                       const uint32_t* dcl,
                                       const uint32_t* acl, uint32_t* words,
                                       int32_t* bits, int n) {
  uint32_t iqz[2][64], ibz[2][64];
  for (int g = 0; g < 2; ++g)
    for (int k = 0; k < 64; ++k) {
      iqz[g][k] = iq[64 * g + sjpeg::zigzag_raster(k)];
      ibz[g][k] = ib[64 * g + sjpeg::zigzag_raster(k)];
    }
  source_reads = 0;
  for (int b = 0; b < n; ++b) {
    const int32_t* src = coeffs + 64 * (int64_t)b;
    uint32_t* row = words + 64 * (int64_t)b;
    for (int p = 0; p < 64; ++p)
      row[sjpeg::zigzag_slot(p)] = (uint32_t)src[p];
    const int g = group[b] & 1;
    bits[b] = sjpeg::quant_emit_coded(
        row, sjpeg::quant_coded_mask(row, iqz[g], ibz[g]), (uint32_t)dc[b],
        iqz[g], ibz[g], dcl + 16 * g, acl + 256 * g);
  }
  return source_reads;
}
extern "C" void zigzag_tables(int32_t* raster, int32_t* slot) {
  for (int k = 0; k < 64; ++k) {
    raster[k] = sjpeg::zigzag_raster(k);
    slot[k] = sjpeg::zigzag_slot(k);
  }
}
// stream_concat's placement, block by block in the given direction.
extern "C" void place_blocks(const uint32_t* words, const int32_t* bits,
                             const int64_t* offs, uint32_t* out, int n,
                             int per_img, int bucket, int reverse) {
  for (int j = 0; j < n; ++j) {
    const int b = reverse ? n - 1 - j : j;
    if (bits[b] > 0)
      sjpeg::place_block(words + 64 * (int64_t)b, bits[b], offs[b],
                         out + (int64_t)(b / per_img) * bucket, bucket,
                         [](uint32_t* p, uint32_t v) { *p |= v; });
  }
}
"""


@pytest.fixture(scope="module")
def host_core(tmp_path_factory):
    """csrc/block_core.cuh built by the host C++ compiler."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("core")
    (d / "core.cpp").write_text(_HOST_SHIM)
    lib = d / "libcore.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    f"-I{REPO / 'sjpeg_tpu_torch' / 'csrc'}", "-o", str(lib),
                    str(d / "core.cpp")], check=True)
    so = ctypes.CDLL(str(lib))
    so.encode_blocks.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int]
    so.emit_blocks.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3
    so.quant_emit_blocks.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int]
    so.emit_coded_blocks.argtypes = so.emit_blocks.argtypes
    so.place_blocks.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
    so.quant_emit_coded_blocks.argtypes = so.quant_emit_blocks.argtypes
    so.quant_emit_coded_blocks.restype = ctypes.c_int
    so.zigzag_tables.argtypes = [ctypes.c_void_p] * 2
    so.zigzag_tables.restype = None
    so.encode_blocks.restype = so.emit_blocks.restype = None
    so.quant_emit_blocks.restype = so.place_blocks.restype = None
    so.emit_coded_blocks.restype = ctypes.c_int
    return so


def _emit(host_core, walk, fields, luts, n, per_img, n_sets,
          in_place=True):
    """Words and counts of the dense walk (emit_block) or of the coded
    walk in place (emit_coded) on int32 run, size, code, DC codes and
    groups with [n_sets, 2, 16] / [n_sets, 2, 256] LUTs; with `in_place`
    the coded walk must read no field out of place, else it must read
    some."""
    words = np.zeros((n, 64), np.uint32)
    bits = np.zeros(n, np.int32)
    host = [np.ascontiguousarray(np.asarray(t), np.int32) for t in fields]
    host += [np.ascontiguousarray(np.asarray(t).astype(np.int64)
                                  .astype(np.uint32)) for t in luts]
    fn = host_core.emit_coded_blocks if walk == "coded" else \
        host_core.emit_blocks
    out_of_place = fn(*(a.ctypes.data for a in host), words.ctypes.data,
                      bits.ctypes.data, n, per_img, n_sets)
    assert walk == "dense" or (out_of_place == 0) == in_place
    return words, bits


@pytest.mark.parametrize("q,lo,hi", [(75, -128, 129), (100, -128, 129),
                                     (100, -32768, 32768)])
def test_block_core_host_build_matches_plain(host_core, q, lo, hi):
    """The CUDA kernels' per-block arithmetic == sample_pack_plain on 2k
    random blocks: 8-bit samples at q75 and q100, and the full int16
    range, where the fDCT's int32 products wrap."""
    n = 2048
    rng = np.random.RandomState(13)
    samples = rng.randint(lo, hi, (n, 64)).astype(np.int32)
    samples[:n // 4] //= 16                  # smoother blocks: zero runs
    samples[n // 4:n // 2, 1:] = samples[n // 4:n // 2, :1]     # flat
    group = rng.randint(0, 2, n).astype(np.int32)
    dcq = rng.randint(-2047, 2048, n)
    dc = engine.vlc.dc_diff_codes(torch.from_numpy(dcq), 4).numpy()
    _, arrays = _tables(q)
    t = state.tables_from_numpy(*arrays, "cpu")
    want_w, want_b = sample_pack.sample_pack_plain(
        torch.from_numpy(samples), torch.from_numpy(dc),
        torch.from_numpy(group), *t)

    words = np.zeros((n, 64), np.uint32)
    bits = np.zeros(n, np.int32)
    host = [np.ascontiguousarray(x.numpy()) for x in t]
    host_core.encode_blocks(samples.ctypes.data, dc.ctypes.data,
                            group.ctypes.data,
                            *(a.ctypes.data for a in host),
                            words.ctypes.data, bits.ctypes.data, n)
    np.testing.assert_array_equal(bits, want_b.numpy())
    np.testing.assert_array_equal(words, want_w.numpy().view(np.uint32))


@functools.lru_cache(maxsize=None)
def _vlc_case(n_sets):
    """3 x 700 random blocks (700 is not a multiple of 128) with long zero
    runs, their fields, shared or per-image LUTs, and vlc_pack_plain's
    words and counts; computed once for both walks."""
    n, per_img = 2100, 700
    rng = np.random.RandomState(16)
    q = rng.randint(-1500, 1501, (n, 64)) * (rng.rand(n, 64) < 0.2)
    q[::5, 1:63] = 0                                  # one long run, ZRLs
    q[1::5, 1:] = rng.randint(-2, 3, (len(q[1::5]), 63))        # dense
    rl = engine.vlc.run_levels(torch.from_numpy(q), torch.int32)
    dc = engine.vlc.dc_diff_codes(torch.from_numpy(
        rng.randint(-1023, 1024, n)), n // per_img)
    group = torch.from_numpy((np.arange(n) % 6 >= 4).astype(np.int32))
    freq_dc, freq_ac = engine._grouped_stats(rl, dc, group, n // per_img)
    dcl, acl, _, _ = engine.huffman_device.luts_and_desc_from_freqs(
        freq_dc, freq_ac)
    if n_sets == 1:
        dcl, acl = dcl[0], acl[0]
    fields = (rl["run"], rl["size"], rl["code"], dc, group)
    want_w, want_b = engine.vlc_pack.vlc_pack_plain(*fields, dcl, acl)
    return fields, (dcl, acl), want_w, want_b


@pytest.mark.parametrize("walk", ["dense", "coded"])
@pytest.mark.parametrize("n_sets", [1, 3])
def test_emit_block_host_build_matches_vlc_pack_plain(host_core, n_sets,
                                                      walk):
    """block_core.cuh's emission walks == vlc_pack_plain on 3 x 700 random
    blocks (700 is not a multiple of 128) with long zero runs, shared or
    per-image LUTs: emit_block over all 63 positions, as sample_pack and
    quant_pack run it, and emit_coded over the coded positions only,
    writing the stream over the packed fields as vlc_pack does."""
    fields, luts, want_w, want_b = _vlc_case(n_sets)
    words, bits = _emit(host_core, walk, fields, luts, 2100, 700, n_sets)
    np.testing.assert_array_equal(bits, want_b.numpy())
    np.testing.assert_array_equal(words, want_w.numpy().view(np.uint32))


def _optimal_luts():
    """DC and AC LUTs of an optimal table whose skewed (Fibonacci)
    frequencies push the longest codes to the 16-bit limit; every symbol
    the blocks can use has a code."""
    fib = [1, 1]
    while len(fib) < 40:
        fib.append(fib[-1] + fib[-2])
    freq_dc = torch.ones((1, 2, 12), dtype=torch.int32)
    freq_ac = torch.zeros((1, 2, 256), dtype=torch.int32)
    syms = [0x00, 0xF0] + [(r << 4) | s for r in range(16)
                           for s in range(1, 12)]
    for i, sym in enumerate(syms):
        freq_ac[0, :, sym] = fib[min(i, 39)] if i < 40 else 1
    dcl, acl, _, _ = engine.huffman_device.luts_and_desc_from_freqs(freq_dc,
                                                                    freq_ac)
    assert int((acl[0] & 0xFF).max()) == 16
    return dcl[0].numpy(), acl[0].numpy()


def _full_luts():
    """DC and AC LUTs whose every piece is 32 bits (code lengths 32 - size,
    past the JPEG limit of 16): a block with every position coded, or 62
    and the EOB, fills all 64 words.  No stream is longer: a block has at
    most 64 pieces (DC, ZRLs, symbols, EOB) of at most 32 bits."""
    rng = np.random.RandomState(19)
    size = np.arange(256) & 15
    acl = (rng.randint(0, 1 << 16, 256) << 16) | (32 - size)
    dcl = (rng.randint(0, 1 << 16, 16) << 16) | (32 - np.arange(16))
    return (np.stack([dcl, dcl]).astype(np.int64),
            np.stack([acl, acl]).astype(np.int64))


@functools.lru_cache(maxsize=None)
def _quant_case(table, q):
    """1,200 coefficient blocks (zero runs of 16 and more, position 63
    coded, full int16 range rows), DC codes, groups, the tables, and the
    plain quant_pack's words and counts; computed once for both walks."""
    n = 1200
    rng = np.random.RandomState(18)
    c = rng.randint(-400, 401, (n, 64)) * (rng.rand(n, 64) < 0.3)
    k = n // 6
    c[:k] = rng.randint(-32768, 32768, (k, 64))              # full range
    far = rng.randint(17, 64, k)
    c[k:2 * k] = 0
    c[k + np.arange(k), np.asarray(C.ZIGZAG)[far]] = 4000     # runs >= 16
    c[2 * k:3 * k, 63] = rng.choice([-3000, 3000], k)         # 63 coded
    c[3 * k:4 * k] = 0                                        # DC only
    c[3 * k:4 * k, 0] = rng.randint(-900, 900, k)
    c = c.astype(np.int32)
    group = rng.randint(0, 2, n).astype(np.int32)
    dc = engine.vlc.dc_diff_codes(torch.from_numpy(
        rng.randint(-2047, 2048, n)), 4).numpy()
    _, (iq, ib, dcl, acl) = _tables(q)
    if table == "optimal":
        dcl, acl = _optimal_luts()
    elif table == "full":
        dcl, acl = _full_luts()
    t = state.tables_from_numpy(iq, ib, dcl, acl, "cpu")
    want_w, want_b = engine.quant_pack.quant_pack_plain(
        *(torch.from_numpy(a) for a in (c, dc, group)), *t)
    return c, dc, group, t, want_w, want_b


def _quant_emit_coded(host_core, c, dc, group, tabs):
    """quant_emit_coded_blocks' words and counts; it must read no
    coefficient out of place."""
    n = c.shape[0]
    words = np.zeros((n, 64), np.uint32)
    bits = np.zeros(n, np.int32)
    source_reads = host_core.quant_emit_coded_blocks(
        c.ctypes.data, dc.ctypes.data, group.ctypes.data,
        *(a.ctypes.data for a in tabs), words.ctypes.data, bits.ctypes.data,
        n)
    assert source_reads == 0
    return words, bits


@pytest.mark.parametrize("walk", ["dense", "coded", "zigzag"])
@pytest.mark.parametrize("table", ["k3", "optimal", "full"])
@pytest.mark.parametrize("q", [75, 100])
def test_quant_emit_block_long_streams_match_quant_pack_plain(host_core,
                                                              table, q,
                                                              walk):
    """The emission walks == the plain quant_pack on 1,200 coefficient
    blocks: zero runs of 16 and more, position 63 coded, and full int16
    range rows, the longest streams at q100; with K.3 tables, an optimal
    table with 16-bit codes, or a table of 32-bit pieces whose streams fill
    all 2,048 bits of the word row.  The dense walk is quant_emit_block
    (emit_block over all 63 positions, as sample_pack runs it); the coded
    walk is emit_coded in place on the quantized blocks' run/size/code
    fields, where a row of 64 pieces of 32 bits overwrites every field
    word, each only after it was read; the zigzag walk is quant_pack's
    quant_emit_coded on coefficients staged in zigzag order, where the
    stream likewise passes each coefficient's slot only after reading it,
    runs of 16 and more and 32-bit pieces included."""
    c, dc, group, t, want_w, want_b = _quant_case(table, q)
    n = c.shape[0]
    tabs = [np.ascontiguousarray(a.numpy()) for a in t]
    if walk == "zigzag":
        words, bits = _quant_emit_coded(host_core, c, dc, group, tabs)
    elif walk == "coded":
        g = torch.from_numpy(group).long()
        rl = vlc.run_levels(quantize.quantize_values(
            torch.from_numpy(c), t[0].long()[g], t[1].long()[g]),
            torch.int32)
        words, bits = _emit(host_core, walk, (rl["run"], rl["size"],
                                              rl["code"], dc, group),
                            t[2:], n, n, 1)
    else:
        words = np.zeros((n, 64), np.uint32)
        bits = np.zeros(n, np.int32)
        host_core.quant_emit_blocks(
            c.ctypes.data, dc.ctypes.data, group.ctypes.data,
            *(a.ctypes.data for a in tabs), words.ctypes.data,
            bits.ctypes.data, n)
    np.testing.assert_array_equal(bits, want_b.numpy())
    np.testing.assert_array_equal(words, want_w.numpy().view(np.uint32))
    if table == "full" and q == 100:
        assert bits.max() == 2048 and (words[:, 63] != 0).any()


@pytest.mark.parametrize("q", [30, 75, 100])
def test_quant_emit_coded_host_build_matches_plain(host_core, q):
    """quant_pack.cu's per-block core (coefficients staged in zigzag order,
    the coded mask, emit_coded in place) == quant_pack_plain on 512
    coefficient blocks from real samples and from the int16 range, with
    both table groups (512 x 64 values keep the plain version's torch
    operations on one thread of a loaded test worker)."""
    n = 512
    rng = np.random.RandomState(75 + q)
    samples = rng.randint(-128, 129, (n, 64)).astype(np.int32)
    samples[: n // 4] //= 8                              # smooth: zero runs
    samples[n // 4:n // 2, 1:] = samples[n // 4:n // 2, :1]        # flat
    c = engine.fdct.fdct_blocks_plain(torch.from_numpy(samples)).numpy()
    c[n // 2:] = rng.randint(-32768, 32768, (n // 2, 64)) * (
        rng.rand(n // 2, 64) < 0.3)
    c = np.ascontiguousarray(c, np.int32)
    group = rng.randint(0, 2, n).astype(np.int32)
    dc = engine.vlc.dc_diff_codes(torch.from_numpy(
        rng.randint(-2047, 2048, n)), 4).numpy()
    t = state.tables_from_numpy(*_tables(q)[1], "cpu")
    want_w, want_b = engine.quant_pack.quant_pack_plain(
        *(torch.from_numpy(a) for a in (c, dc, group)), *t)
    words, bits = _quant_emit_coded(
        host_core, c, dc, group, [np.ascontiguousarray(a.numpy()) for a in t])
    np.testing.assert_array_equal(bits, want_b.numpy())
    np.testing.assert_array_equal(words, want_w.numpy().view(np.uint32))


def test_zigzag_lookups_match_the_zigzag_order(host_core):
    """block_core.cuh's run-time zigzag lookups: zigzag_raster(k) is the
    raster position of zigzag position k (quant_pack's permutation of the
    quantizer rows), zigzag_slot its inverse (the staging slot of raster
    position p)."""
    raster = np.zeros(64, np.int32)
    slot = np.zeros(64, np.int32)
    host_core.zigzag_tables(raster.ctypes.data, slot.ctypes.data)
    np.testing.assert_array_equal(raster, np.asarray(C.ZIGZAG))
    np.testing.assert_array_equal(raster[slot], np.arange(64))


def test_emit_coded_reads_overtaken_fields_from_their_source(host_core):
    """Runs longer than the positions skipped (which vlc.run_levels never
    gives) with 32-bit pieces: up to three ZRLs a coded position carry the
    stream past fields still to be read, which emit_coded then reads from
    their source; both walks still equal vlc_pack_plain."""
    n = 600
    rng = np.random.RandomState(22)
    q = rng.randint(-300, 301, (n, 64)) * (rng.rand(n, 64) < 0.7)
    rl = vlc.run_levels(torch.from_numpy(q), torch.int32)
    run = torch.where(rl["size"] > 0, torch.from_numpy(
        rng.randint(0, 64, (n, 64)).astype(np.int32)), 0)
    dc = vlc.dc_diff_codes(torch.from_numpy(rng.randint(-900, 900, n)))
    group = torch.from_numpy(rng.randint(0, 2, n).astype(np.int32))
    dcl, acl = (torch.from_numpy(a) for a in _full_luts())
    fields = (run, rl["size"], rl["code"], dc, group)
    want_w, want_b = engine.vlc_pack.vlc_pack_plain(*fields, dcl, acl)
    for walk in ("dense", "coded"):
        words, bits = _emit(host_core, walk, fields, (dcl, acl), n, n, 1,
                            in_place=False)
        np.testing.assert_array_equal(bits, want_b.numpy())
        np.testing.assert_array_equal(words,
                                      want_w.numpy().view(np.uint32))


@pytest.mark.parametrize("bucket", [64, 4096])
def test_place_block_host_build_matches_stream_concat_plain(host_core,
                                                            bucket):
    """concat_core.cuh's place_block, looped over numpy-scanned offsets in
    either direction, == stream_concat_plain on 3 images of 700 blocks:
    empty blocks, 2,048-bit blocks, offsets at every residue mod 32, and
    images whose totals pass the bucket (words past it dropped)."""
    n_img, per_img = 3, 700
    n = n_img * per_img
    rng = np.random.RandomState(21)
    lens = rng.randint(0, 200, n)
    lens[rng.rand(n) < 0.2] = 0                                 # empty
    lens[rng.rand(n) < 0.02] = 2048                             # full rows
    lens[:per_img:7] = 2048          # image 0 passes a 4,096-word bucket
    lens[per_img:per_img + 40] = rng.randint(1, 33, 40)     # short pieces
    words = random_streams(rng, lens).view(np.uint32)
    bits = lens.astype(np.int32)
    offs = (np.cumsum(lens.reshape(n_img, -1), 1)
            - lens.reshape(n_img, -1)).reshape(-1).astype(np.int64)
    assert len(np.unique(offs[lens > 0] % 32)) == 32
    totals = lens.reshape(n_img, -1).sum(1)
    assert totals.max() > bucket * 32 > totals.min() or bucket == 64
    want_w, want_t = stream_concat.stream_concat_plain(
        torch.from_numpy(words.view(np.int32)), torch.from_numpy(bits),
        n_img, bucket)
    np.testing.assert_array_equal(want_t.numpy(), totals)
    for reverse in (0, 1):
        out = np.zeros((n_img, bucket), np.uint32)
        host_core.place_blocks(words.ctypes.data, bits.ctypes.data,
                               offs.ctypes.data,
                               out.ctypes.data, n, per_img, bucket, reverse)
        np.testing.assert_array_equal(out, want_w.numpy().view(np.uint32))


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_sjpeg_tpu():
    files = sorted((REPO / "sjpeg_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    bad = [(f.name, m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "sjpeg_tpu")]
    assert len(files) > 10 and not bad, bad


@pytest.mark.parametrize("kw", [
    dict(),                                             # method 4, AUTO
    dict(huffman_compress=False, yuv_mode=C.YUV_AUTO),
    dict(huffman_compress=False, adaptive_quantization=False,
         yuv_mode=C.YUV_SHARP),
    dict(yuv_mode=C.YUV_420, search_hook=SearchHook(),      # A4
         target_mode=TARGET_SIZE, target_value=900.0, passes=3,
         huffman_compress=False, adaptive_quantization=False),
    dict(yuv_mode=C.YUV_AUTO, target_mode=TARGET_SIZE,      # A8
         target_value=900.0, passes=3),
])
def test_unported_configurations_raise(kw):
    """Configurations that once raised, each now ported (the name predates
    the ports): AUTO, SHARP (A8) and a custom search hook (A4) through
    encode_batch give the JAX engine's bytes."""
    from sjpeg_tpu.params import EncoderParam as JaxParam
    from sjpeg_tpu.params import SearchHook as JHook
    rgb = np.zeros((1, 16, 16, 3), np.uint8)
    jkw = dict(kw, search_hook=JHook()) if "search_hook" in kw else kw
    assert (engine.encode_batch(rgb, EncoderParam(**kw), device="cpu")
            == jengine.encode_batch(rgb, JaxParam(**jkw)))


def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    param = EncoderParam(huffman_compress=False, adaptive_quantization=False,
                         yuv_mode=C.YUV_420)
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.encode_batch(np.zeros((1, 16, 16, 3), np.uint8), param)


def test_empty_image_is_rejected():
    param = EncoderParam(huffman_compress=False, adaptive_quantization=False,
                         yuv_mode=C.YUV_420)
    with pytest.raises(ValueError, match="image size"):
        engine.encode_batch(np.zeros((1, 0, 16, 3), np.uint8), param,
                            device="cpu")
