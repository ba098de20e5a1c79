"""The port's batched target-size / target-PSNR search against the JAX
package: the dichotomy arithmetic, the node fit, the per-image sample_pack
(plain version vs the Pallas kernel in interpret mode), the error sum, the
stuffing count, and encode_batch's bytes on device="cpu" against
sjpeg_tpu.engine.encode_batch for every route (size and PSNR device loops,
pass by pass, trellis), gray, NV12 and the bucket-overflow fallback.  The
batch and parameters are tests/test_batch_search.py's, so that the JAX side
compiles the shapes it already compiles there."""

import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sjpeg_tpu import adaptive as jadaptive
from sjpeg_tpu import dichotomy as jdich
from sjpeg_tpu import engine as jengine
from sjpeg_tpu import spec as jspec
from sjpeg_tpu.huffman import HuffmanTable as JTable
from sjpeg_tpu.huffman import k3_default_tables as j_k3
from sjpeg_tpu.ops import colorspace as jcs
from sjpeg_tpu.ops import fdct as jfdct
from sjpeg_tpu.params import EncoderParam as JaxParam
from sjpeg_tpu.params import SearchHook as JHook
from sjpeg_tpu.params import quant_matrices_for_quality as j_qmq
from sjpeg_tpu.tools import estimate_quality as j_estimate

from sjpeg_tpu_torch import adaptive, dichotomy, engine, engine_search, state
from sjpeg_tpu_torch import constants as C
from sjpeg_tpu_torch.ops import colorspace, fdct, sample_pack
from sjpeg_tpu_torch.params import (TARGET_PSNR, TARGET_SIZE, EncoderParam,
                                    SearchHook)
from sjpeg_tpu_torch.tools import estimate_quality

from conftest import make_test_image
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

NB = {C.YUV_420: (4, 1, 1), C.YUV_444: (1, 1, 1), C.YUV_400: (1,)}


def _batch(n=3, w=48, h=40):
    """tests/test_batch_search.py's batch: a test image and noisy copies."""
    rng = np.random.RandomState(21)
    base = make_test_image(w, h)
    imgs = [base]
    for _ in range(n - 1):
        v = base.astype(np.int32) + rng.randint(-40, 40, base.shape)
        imgs.append(np.clip(v, 0, 255).astype(np.uint8))
    return np.stack(imgs)


def _params(**kw):
    return JaxParam(**kw), EncoderParam(**kw)


# ---- the dichotomy arithmetic ---------------------------------------------

GRID = [  # target_mode, target_value, tolerance, qmin, qmax, passes
    (TARGET_SIZE, 900.0, 2.0, 0.0, 100.0, 5),
    (TARGET_SIZE, 200_000.0, 1.0, 0.0, 100.0, 8),
    (TARGET_SIZE, 1234.5, 0.1, 20.0, 95.0, 6),
    (TARGET_SIZE, 3e8, 5.0, 40.0, 30.0, 3),          # qmax < qmin
    (TARGET_PSNR, 33.0, 1.0, 0.0, 100.0, 6),
    (TARGET_PSNR, 35.0, 1.0, 10.0, 120.0, 8),         # qmax > 100
    (TARGET_PSNR, 99.5, 0.5, 0.0, 100.0, 4),          # above err=0's 99
]


@pytest.mark.parametrize("mode,value,tol,qmin,qmax,passes", GRID)
def test_dichotomy_matches_jax(mode, value, tol, qmin, qmax, passes):
    """Tree, convergence table, tolerance ranges, thresholds, header model
    and the hook itself, exactly as the JAX package computes them."""
    kw = dict(target_mode=mode, target_value=value, tolerance=tol,
              qmin=qmin, qmax=qmax, passes=passes, exif=b"x" * 40,
              xmp=b"y" * 70000)
    jp, tp = _params(**kw)
    q0 = estimate_quality(tp.resolved_quant_matrices()[0])
    assert q0 == j_estimate(jp.resolved_quant_matrices()[0])
    np.testing.assert_array_equal(dichotomy.build_q_tree(tp, q0, passes),
                                  jdich.build_q_tree(jp, q0, passes))
    np.testing.assert_array_equal(
        dichotomy.build_q_conv_table(tp, q0, passes),
        jdich.build_q_conv_table(jp, q0, passes))
    size = 64 * 54
    if mode == TARGET_SIZE:
        assert (dichotomy.size_tolerance_range(tp)
                == jdich.size_tolerance_range(jp))
    else:
        assert (dichotomy.psnr_tolerance_range(tp, size)
                == jdich.psnr_tolerance_range(jp, size))
        assert (dichotomy.psnr_err_threshold(value, size)
                == jdich.psnr_err_threshold(value, size))
    for err in (0, 1, 977, 1 << 40):
        assert dichotomy.get_psnr(err, size) == jdich.get_psnr(err, size)
    for nbs in ([0, 0, 0, 0], [12, 11, 162, 97]):
        for nc in (1, 3):
            assert (dichotomy.header_size_bits_nbsyms(tp, nc, nbs)
                    == jdich.header_size_bits_nbsyms(jp, nc, nbs))
    tables = [JTable(t.bits, t.syms) for t in j_k3()]
    assert (dichotomy.header_size_bits(tp, 3, engine.k3_default_tables())
            == jdich.header_size_bits(jp, 3, tables))

    # the hooks and the replay over traces with both decisions and a lie
    rng = np.random.RandomState(int(value) % 1000)
    for trial in range(6):
        vals = list(value * rng.uniform(0.5, 1.5, passes))
        decs = [int(v > value) for v in vals]
        if trial == 5:
            decs = [1 - d for d in decs]
        got_hook, want_hook = SearchHook(), JHook()
        got_hook.setup(tp, q0)
        want_hook.setup(jp, q0)
        got = dichotomy.replay_search_trace(vals, decs, tp, got_hook)
        want = jdich.replay_search_trace(vals, decs, jp, want_hook)
        assert got == want
        assert vars(got_hook) == vars(want_hook)
        np.testing.assert_array_equal(got_hook.next_matrices(),
                                      want_hook.next_matrices())


@pytest.mark.parametrize("seed,qdelta_max", [(31, 12), (32, 1)])
def test_analyse_histo_nodes_matches_jax(seed, qdelta_max):
    """The node fit == the JAX package's, over a tree with duplicate
    candidate matrices (collapsed before the fit) and a min-quant floor."""
    rng = np.random.RandomState(seed)
    b, bins = 3, C.MAX_HISTO_DCT_COEFF
    scale = np.exp(-np.arange(bins) / rng.uniform(3, 20, (b, 64, 1)))
    histos = rng.poisson(400 * scale).astype(np.int64)
    histos[0, 5:] = 0                             # sparse positions
    tree = jdich.build_q_tree(JaxParam(), 75.0, 4)
    quants = np.stack([j_qmq(q)[1] for q in tree]).astype(np.uint8)
    quants = np.concatenate([quants, quants[:3]])     # duplicates
    minq = np.full(64, 4, np.uint8)
    quants = np.maximum(quants, minq)
    got = adaptive.analyse_histo_nodes(histos, quants, minq, qdelta_max)
    want = jadaptive.analyse_histo_nodes(histos, quants, minq, qdelta_max)
    np.testing.assert_array_equal(got, want)
    # and each pair equals the single fit
    np.testing.assert_array_equal(
        got[1, 2], adaptive.analyse_histo(histos[1], quants[2], minq,
                                          qdelta_max))


# ---- the per-image sample_pack ---------------------------------------------

def test_sample_pack_per_image_plain_matches_pallas_interpret():
    """sample_pack_plain with per-image quantizers and LUTs == the TPU
    kernel sample_vlc_pack_pallas(..., tiles_per_img) in interpret mode,
    with saturated chroma (the TPU's int8 transport wraps it)."""
    from jax.experimental import pallas as pl
    from sjpeg_tpu.ops import pallas_quant_pack as pqp

    b, h, w = 2, 48, 64
    rng = np.random.RandomState(33)
    rgb = rng.randint(0, 256, (b, h, w, 3)).astype(np.uint8)
    rgb[0, :16, :16] = [0, 0, 255]       # U = +128
    rgb[1, 16:, 16:] = [255, 0, 0]       # V = +128
    sets = []
    for q, shuffle in ((70.0, False), (88.0, True)):
        qms = [jspec.finalize_quant_matrix(j_qmq(q)[i], np.ones(64, np.uint8),
                                           C.DEFAULT_BIAS) for i in range(2)]
        tabs = [JTable(t.bits, t.syms[::-1] if shuffle else t.syms)
                for t in j_k3()]
        sets.append([np.asarray(a) for a in (
            *jengine._quant_device_arrays(qms), *jengine._device_luts(tabs))])
    iq3, ib3, dcl3, acl3 = (np.stack(a) for a in zip(*sets))
    b8 = jcs.rgb_to_blocks(jnp.asarray(rgb), C.YUV_420, w, h,
                           out_dtype=jnp.int8)
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    pl.pallas_call = patched
    try:
        s8, jdc, jgroup = jengine._interleave_samples(
            b8, jnp.asarray(iq3), jnp.asarray(ib3), NB[C.YUV_420],
            n_images=b, chroma_wrap=True)
        per_img = s8.shape[0] // b                      # 72 blocks
        want_w, want_b = pqp.sample_vlc_pack_pallas.__wrapped__(
            s8, jdc, jgroup, *(jnp.asarray(a) for a in (iq3, ib3, dcl3,
                                                        acl3)),
            tile=12, tiles_per_img=per_img // 12, chroma_wrap=True)
    finally:
        pl.pallas_call = orig

    t = state.tables_from_numpy(iq3, ib3, dcl3, acl3, "cpu")
    blocks = colorspace.rgb_to_blocks(torch.from_numpy(rgb), C.YUV_420, w, h)
    prep = engine_search._stage_search_prep(
        torch.from_numpy(rgb), "rgb", C.YUV_420, w, h, NB[C.YUV_420], b,
        False, True)
    assert (prep["sinter"] == 128).any()
    dc = engine._dc_codes([fdct.fdct_blocks(x) for x in blocks], t[0], t[1],
                          NB[C.YUV_420], b)
    np.testing.assert_array_equal(dc.numpy(), np.asarray(jdc))
    np.testing.assert_array_equal(prep["group"].numpy(), np.asarray(jgroup))
    words, bits = sample_pack.sample_pack(prep["sinter"], dc, prep["group"],
                                          *t)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(want_b))
    np.testing.assert_array_equal(words.numpy().view(np.uint32),
                                  np.asarray(want_w))
    # each image's rows == the shared-table version at that image's set
    for i in range(b):
        rows = slice(i * per_img, (i + 1) * per_img)
        w1, b1 = sample_pack.sample_pack_plain(
            prep["sinter"][rows], dc[rows], prep["group"][rows],
            *(x[i] for x in t))
        assert torch.equal(b1, bits[rows]) and torch.equal(w1, words[rows])


# ---- the error sum and the stuffing count -----------------------------------

def _qerr_case(name):
    """(JAX coefficients, port coefficients, n_images, quant matrices):
    a 4:2:0 batch at q40 and q47, or two gray images of 8,192 blocks whose
    coefficients all sit just below quant 255's rounding point (16,129 a
    coefficient, some 8.5e9 an image: past 2^32)."""
    if name == "rgb420":
        b, h, w = 3, 40, 48
        rgb = np.random.RandomState(34).randint(0, 256, (b, h, w, 3)).astype(
            np.uint8)
        jco = [jfdct.fdct_blocks(x) for x in jcs.rgb_to_blocks(
            jnp.asarray(rgb), C.YUV_420, w, h)]
        co = [fdct.fdct_blocks(x) for x in colorspace.rgb_to_blocks(
            torch.from_numpy(rgb), C.YUV_420, w, h)]
        quants = [j_qmq(40.0 + 7 * i) for i in range(b)]
    else:
        b = 2
        sign = np.random.RandomState(34).choice([-1, 1], (b * 8192, 64))
        c = (sign * 16 * 127).astype(np.int32)
        jco, co = [jnp.asarray(c)], [torch.from_numpy(c)]
        quants = [np.full((2, 64), 255, np.uint8)] * b
    per_qms = [[jspec.finalize_quant_matrix(q[g], np.ones(64, np.uint8),
                                            C.DEFAULT_BIAS)
                for g in range(2)] for q in quants]
    arrays = [np.stack([[q[k] for q in qms] for qms in per_qms]).astype(
        np.int32) for k in ("iquant", "bias", "quant")]
    return jco, co, b, arrays


@pytest.mark.parametrize("name", ["rgb420", "gray_past_2_32"])
def test_batch_qerr_matches_jax(name):
    """The per-image int64 error == JAX's exact (hi, lo) uint32 pair."""
    jco, co, b, arrays = _qerr_case(name)
    hi, lo = jengine._batch_qerr(jco, *(jnp.asarray(a) for a in arrays), b)
    want = (np.asarray(hi).astype(np.int64) << 32) | np.asarray(lo)
    got = engine_search._batch_qerr(
        co, *state.arrays_to_device(*arrays, device="cpu"), b)
    np.testing.assert_array_equal(got.numpy(), want)
    if name == "gray_past_2_32":
        assert (want > 1 << 32).all()


def test_count_stuffing_matches_jax():
    rng = np.random.RandomState(35)
    b, n = 5, 300
    words = rng.randint(0, 1 << 32, (b, n), dtype=np.uint64).astype(
        np.uint32)
    words[:, ::3] |= 0xFF00FF00
    words[1] = 0xFFFFFFFF
    totals = np.array([0, 7, 8 * 401, 32 * n, 32 * n - 9], np.int32)
    want = jengine._stage_count_stuffing_batch(jnp.asarray(words),
                                               jnp.asarray(totals))
    got = engine_search._stage_count_stuffing_batch(
        torch.from_numpy(words.view(np.int32)), torch.from_numpy(totals))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---- encode_batch bytes ---------------------------------------------------

SIZE = dict(quality=90, yuv_mode=C.YUV_420, target_mode=TARGET_SIZE,
            target_value=900.0, passes=5, tolerance=2.0)
PSNR = dict(quality=40, yuv_mode=C.YUV_420, target_mode=TARGET_PSNR,
            target_value=33.0, passes=6, tolerance=1.0)
M0 = dict(huffman_compress=False, adaptive_quantization=False)
M1 = dict(adaptive_quantization=False)
CASES = {
    "size_m0": dict(SIZE, **M0),
    "size_m1": dict(SIZE, **M1),
    "size_m4": SIZE,
    "psnr_m4": PSNR,
    "gray_planar": dict(quality=85, yuv_mode=C.YUV_400,
                        target_mode=TARGET_SIZE, target_value=700.0,
                        passes=4, tolerance=2.0),
    "passes10": dict(SIZE, passes=10),
    "size_m7": dict(SIZE, use_trellis=True),
    "psnr_m7": dict(PSNR, use_trellis=True),
    "nv12": dict(SIZE, passes=4, target_value=1000.0),
    "overflow": dict(SIZE, **M0, target_value=4000.0, passes=3),
}


def _run(eng, name, imgs, param, **kw):
    if name == "gray_planar":
        return eng.encode_batch_gray(imgs[..., 0].copy(), param, **kw)
    if name == "nv12":
        uv = np.stack([imgs[:, ::2, ::2, 1], imgs[:, ::2, ::2, 2]], -1)
        return eng.encode_batch_nv12(imgs[..., 0].copy(), uv, param, **kw)
    if name == "overflow":
        return eng.encode_batch(imgs, param, 0.0001, **kw)
    return eng.encode_batch(imgs, param, **kw)


# cases run by test_torch_search_bytes.py, so that --dist loadfile gives
# the batched search's byte cases two workers
BYTES_FILE_CASES = ("passes10", "size_m7", "psnr_m4", "psnr_m7",
                    "gray_planar", "nv12", "overflow")


def check_search_bytes(name):
    """encode_batch (and the planar entry points) with passes > 1 and a
    target == sjpeg_tpu.engine.encode_batch, byte for byte."""
    imgs = _batch()
    if name == "overflow":
        # a noise image (~33 KB at q90) overflows the target-sized bucket
        # of 6,096 words
        imgs = np.stack([np.random.RandomState(36).randint(
            0, 256, (192, 192, 3)), make_test_image(192, 192)]).astype(
                np.uint8)
    jp, tp = _params(**CASES[name])
    with mock.patch.object(engine_search._Search, "fallback", autospec=True,
                           side_effect=engine_search._Search.fallback) as fb:
        got = _run(engine, name, imgs, tp, device="cpu")
    assert fb.call_count == (1 if name == "overflow" else 0)
    want = _run(jengine, name, imgs, jp)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[:2] == b"\xff\xd8" and g[-2:] == b"\xff\xd9"
        assert g == w


@pytest.mark.parametrize("name", [n for n in CASES
                                  if n not in BYTES_FILE_CASES])
def test_search_bytes_match_jax(name):
    """encode_batch (and the planar entry points) with passes > 1 and a
    target == sjpeg_tpu.engine.encode_batch, byte for byte."""
    check_search_bytes(name)


def test_passes_without_target_encode_once():
    """passes > 1 with no target runs the one-pass encode, as in JAX."""
    jp, tp = _params(quality=80, yuv_mode=C.YUV_420, passes=3)
    imgs = _batch(n=2)
    assert (engine.encode_batch(imgs, tp, device="cpu")
            == jengine.encode_batch(imgs, jp))


def test_search_hook_raises_naming_a4():
    """A custom search_hook (ROADMAP A4, ported) no longer raises: each
    image runs the single-image search with it, with the JAX engine's
    bytes; passes == 1 ignores the hook and encodes once."""
    kw = dict(M0, yuv_mode=C.YUV_420)
    tp = EncoderParam(search_hook=SearchHook(), **kw)
    tp.set_target_size(900, passes=3)
    jp = JaxParam(search_hook=JHook(), **kw)
    jp.set_target_size(900, passes=3)
    assert (engine.encode_batch(_batch(n=1), tp, device="cpu")
            == jengine.encode_batch(_batch(n=1), jp))
    one = dataclasses.replace(tp, passes=1)
    assert len(engine.encode_batch(_batch(n=1), one, device="cpu")) == 1
