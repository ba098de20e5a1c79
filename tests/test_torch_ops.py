"""The PyTorch port's tensor modules against the JAX package, bit for bit.

Inputs come from a seeded numpy RandomState and go through the JAX function
(CPU backend) and its counterpart in sjpeg_tpu_torch (device="cpu");
every comparison is exact, since the code is integer code.
"""

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
from sjpeg_tpu.ops import pallas_fdct as jpfdct
from sjpeg_tpu.ops import quantize as jquant
from sjpeg_tpu.ops import vlc as jvlc
from sjpeg_tpu.params import quant_matrices_for_quality as j_qmq

from sjpeg_tpu_torch import engine, spec, state
from sjpeg_tpu_torch import constants as C
from sjpeg_tpu_torch.ops import colorspace, fdct, pack, quantize, vlc
from sjpeg_tpu_torch.ops.stream_concat import stream_concat
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

SHAPES = [(2, 40, 24), (2, 64, 48)]      # (batch, height, width)


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _rgb(rng, b, h, w):
    """Noise over a gradient, with pure blue (U = +128) and pure red
    (V = +128) patches in the first image."""
    rgb = rng.randint(0, 256, (b, h, w, 3)).astype(np.uint8)
    rgb[0, :16, :16] = [0, 0, 255]
    rgb[0, 16:, 16:] = [255, 0, 0]
    return rgb


def _quant(q):
    return [jspec.finalize_quant_matrix(j_qmq(q)[i], np.ones(64, np.uint8),
                                        JC.DEFAULT_BIAS) for i in range(2)]


@pytest.mark.parametrize("mode", [C.YUV_420, C.YUV_444, C.YUV_400])
@pytest.mark.parametrize("shape", SHAPES)
def test_rgb_to_blocks_matches_jax(mode, shape):
    b, h, w = shape
    rgb = _rgb(np.random.RandomState(1), b, h, w)
    want = jcs.rgb_to_blocks(jnp.asarray(rgb), mode, w, h)
    got = colorspace.rgb_to_blocks(torch.from_numpy(rgb), mode, w, h)
    assert len(got) == len(want)
    for g, wnt in zip(got, want):
        _eq(g, wnt)
    if mode != C.YUV_400:
        assert (got[1] == 128).any() and (got[2] == 128).any()


@pytest.mark.parametrize("mode", [C.YUV_420, C.YUV_444, C.YUV_400])
@pytest.mark.parametrize("shape", SHAPES)
def test_planes_to_blocks_matches_jax(mode, shape):
    b, h, w = shape
    rng = np.random.RandomState(2)
    ch, cw = ((h + 1) // 2, (w + 1) // 2) if mode == C.YUV_420 else (h, w)
    planes = [rng.randint(0, 256, (b, h, w)).astype(np.uint8)]
    if mode != C.YUV_400:
        planes += [rng.randint(0, 256, (b, ch, cw)).astype(np.uint8)
                   for _ in range(2)]
    want = jcs.planes_to_blocks(tuple(jnp.asarray(p) for p in planes),
                                mode, w, h)
    got = colorspace.planes_to_blocks(
        tuple(torch.from_numpy(p) for p in planes), mode, w, h)
    for g, wnt in zip(got, want):
        _eq(g, wnt)


@pytest.mark.parametrize("lo,hi", [(-128, 129), (-32768, 32768)])
def test_fdct_matches_jax(lo, hi):
    """8-bit samples, and the full int16 range, where the int32 products
    of the row pass wrap."""
    blocks = np.random.RandomState(3).randint(lo, hi, (512, 64)).astype(
        np.int32)
    blocks[0] = lo
    blocks[1] = hi - 1
    got = fdct.fdct_blocks(torch.from_numpy(blocks))
    _eq(got, jfdct.fdct_blocks(jnp.asarray(blocks)))
    _eq(fdct.fdct_dc(torch.from_numpy(blocks)),
        jpfdct.fdct_dc(jnp.asarray(blocks)))


@pytest.mark.parametrize("q", [100, 75, 30])
def test_quantize_matches_jax(q):
    """quantize_values with broadcast [1, 64] rows == the JAX
    quantize_blocks."""
    coeffs = np.random.RandomState(4).randint(-32768, 32768, (256, 64))
    coeffs = coeffs.astype(np.int32)
    qm = _quant(q)[0]
    iq = qm["iquant"].astype(np.int32)
    ib = qm["bias"].astype(np.int32)
    got = quantize.quantize_values(torch.from_numpy(coeffs),
                                   torch.from_numpy(iq).long()[None, :],
                                   torch.from_numpy(ib).long()[None, :])
    _eq(got, jquant.quantize_blocks(jnp.asarray(coeffs), jnp.asarray(iq),
                                    jnp.asarray(ib)))


def _levels(rng, n=300):
    """Quantized blocks with long zero runs (ZRL escapes) and large
    levels."""
    q = rng.randint(-40, 41, (n, 64)) * (rng.rand(n, 64) < 0.15)
    q[::7, 1:] = 0                                # DC-only blocks
    q[1::7, 1:40] = 0
    q[1::7, 63] = -2047                           # run of 38 -> 2 ZRLs
    q[2::7, :] = rng.randint(-1023, 1024, (len(q[2::7]), 64))
    return q.astype(np.int32)


def test_run_levels_matches_jax():
    q = _levels(np.random.RandomState(5))
    got = vlc.run_levels(torch.from_numpy(q))
    want = jvlc.run_levels(jnp.asarray(q))
    for key in ("nz", "run", "size", "code", "last"):
        _eq(got[key], want[key])


def test_dc_diff_codes_across_images():
    """The predictor resets at each of the three image boundaries."""
    dc = np.random.RandomState(6).randint(-2047, 2048, 3 * 40).astype(
        np.int32)
    dc[40] = dc[39]                  # equal across a boundary: not a zero
    got = vlc.dc_diff_codes(torch.from_numpy(dc), 3)
    _eq(got, jvlc.dc_diff_codes(jnp.asarray(dc), 3))


def _entries(rng):
    q = _levels(rng)
    n = q.shape[0]
    group = (np.arange(n) % 6 >= 4).astype(np.int32)
    dc = np.random.RandomState(7).randint(-500, 500, n).astype(np.int32)
    dc_codes = np.array(jvlc.dc_diff_codes(jnp.asarray(dc), 2))
    dcl, acl = jengine._host_luts(j_k3())
    return q, group, dc_codes, dcl, acl


def test_block_entries_and_pack_match_jax():
    q, group, dc_codes, dcl, acl = _entries(np.random.RandomState(8))
    jrl = jvlc.run_levels(jnp.asarray(q))
    jvals, jlens = jvlc.block_entries_grouped(
        jrl, jnp.asarray(dc_codes), jnp.asarray(dcl), jnp.asarray(acl),
        jnp.asarray(group))
    _, _, tdcl, tacl = state.tables_from_numpy(
        np.zeros((2, 64)), np.zeros((2, 64)), dcl, acl, "cpu")
    vals, lens = vlc.block_entries_grouped(
        vlc.run_levels(torch.from_numpy(q)), torch.from_numpy(dc_codes),
        tdcl, tacl, torch.from_numpy(group))
    _eq(vals, np.asarray(jvals).astype(np.int64))
    _eq(lens, jlens)
    jwords, jbits = jpack.pack_block_entries(jvals, jlens)
    words, bits = pack.pack_block_entries(vals, lens)
    _eq(words, np.asarray(jwords).astype(np.int64))
    _eq(bits, jbits)


@pytest.mark.parametrize("bucket", [64, 4096])
def test_stream_concat_plain_matches_jax(bucket):
    """Per-image concatenation, including words dropped past the bucket
    (a 64-word bucket is far below these streams)."""
    q, group, dc_codes, dcl, acl = _entries(np.random.RandomState(9))
    jrl = jvlc.run_levels(jnp.asarray(q))
    jwords, jbits = jpack.pack_block_entries(*jvlc.block_entries_grouped(
        jrl, jnp.asarray(dc_codes), jnp.asarray(dcl), jnp.asarray(acl),
        jnp.asarray(group)))
    n_images = 3
    want_w, want_t = jpack.concat_block_streams_batched(
        jwords, jbits, n_images, bucket)
    words = torch.from_numpy(np.array(jwords).view(np.int32))
    got_w, got_t = stream_concat(words, torch.from_numpy(np.array(jbits)),
                                 n_images, bucket)
    _eq(got_t, want_t)
    _eq(got_w.numpy().view(np.uint32), want_w)
    if bucket == 64:
        assert (np.asarray(want_t) > bucket * 32).all()


@pytest.mark.parametrize("q", [50, 75, 95])
def test_tables_from_numpy_round_trip(q):
    """The engine's quantizer and LUT arrays carry over unchanged, and the
    port's own derivation of them agrees."""
    qms = _quant(q)
    iq, ib = jengine._quant_device_arrays(qms)
    dcl, acl = jengine._device_luts(j_k3())
    arrays = [np.asarray(a) for a in (iq, ib, dcl, acl)]
    tensors = state.tables_from_numpy(*arrays, "cpu")
    for t, a in zip(tensors, arrays):
        assert t.dtype == torch.int32 and tuple(t.shape) == a.shape
        _eq(t.numpy().view(np.uint32), a.astype(np.uint32))
    from sjpeg_tpu_torch.huffman import k3_default_tables
    from sjpeg_tpu_torch.params import quant_matrices_for_quality
    own_qms = [spec.finalize_quant_matrix(quant_matrices_for_quality(q)[i],
                                          np.ones(64, np.uint8),
                                          C.DEFAULT_BIAS) for i in range(2)]
    own = engine._quant_arrays(own_qms) + engine._host_luts(
        k3_default_tables())
    for o, a in zip(own, arrays):
        _eq(o, a)


def test_method_flags_match_jax():
    from sjpeg_tpu.params import method_flags as j_flags
    from sjpeg_tpu_torch.params import method_flags
    for m in range(9):
        assert method_flags(m) == j_flags(m)


@pytest.mark.parametrize("setup", ["quality30", "quality100", "explicit",
                                   "limit", "bias"])
def test_quant_arrays_match_jax(setup):
    """The port's EncoderParam -> finalized quantizer rows == the JAX
    package's, for quality, explicit matrices (with reduction), limited
    quantization and a custom bias."""
    from sjpeg_tpu.params import EncoderParam as JaxParam
    from sjpeg_tpu_torch.params import EncoderParam
    m = np.random.RandomState(10).randint(1, 256, (2, 64)).astype(np.uint8)
    params = []
    for cls in (JaxParam, EncoderParam):
        p = cls(huffman_compress=False, adaptive_quantization=False)
        if setup == "quality30":
            p.set_quality(30)
        elif setup == "quality100":
            p.set_quality(100)
        elif setup == "explicit":
            p.set_quantization(m, reduction=70)
        elif setup == "limit":
            p.set_quantization(m, reduction=130)
            p.set_limit_quantization(True, tolerance=40)
        else:
            p.quantization_bias = 0x50
        params.append(p)
    jp, tp = params
    assert tp.method == jp.method == 0
    jqms = [jspec.finalize_quant_matrix(jp.resolved_quant_matrices()[i],
                                        jp.resolved_min_quant_matrices()[i],
                                        jp.quantization_bias)
            for i in range(2)]
    qms = engine._quant_matrices(tp)
    for got, want in zip(engine._quant_arrays(qms),
                         jengine._quant_device_arrays(jqms)):
        _eq(got, want)
    for q, jq in zip(qms, jqms):          # the DQT tables
        _eq(q["quant"], jq["quant"])
