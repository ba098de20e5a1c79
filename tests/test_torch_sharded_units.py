"""Units of the port's sharded API against their JAX counterparts, bit for
bit on seeded inputs: the DC chain across stripes (against
sjpeg_tpu.parallel.shard under shard_map over the virtual CPU devices), the
dynamic-row AverageExtraLuma flatten, the masked histograms and symbol
frequencies, the stitch (pieces through stream_concat_plain), the
single-stripe encode; then the stages' intermediates, a mixed AUTO batch
and SHARP.  The sharded search is in test_torch_sharded_search.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

from sjpeg_tpu import engine as jengine
from sjpeg_tpu import spec as jspec
from sjpeg_tpu.engine import _device_luts, _quant_device_arrays
from sjpeg_tpu.huffman import k3_default_tables as j_k3
from sjpeg_tpu.ops import colorspace as jcs
from sjpeg_tpu.ops import pack as jpack
from sjpeg_tpu.ops import quantize as jquantize
from sjpeg_tpu.ops import vlc as jvlc
from sjpeg_tpu.params import EncoderParam as JaxParam
from sjpeg_tpu.parallel import shard as jshard

from sjpeg_tpu_torch import constants as C
from sjpeg_tpu_torch import engine
from sjpeg_tpu_torch.ops import colorspace, quantize, vlc
from sjpeg_tpu_torch.params import EncoderParam
from sjpeg_tpu_torch.parallel import api, shard

from chip_smoke import random_streams
from conftest import make_test_image
from test_torch_sharded import _imgs, _mesh, _params, _same
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)


def _jmesh(dp, sp):
    return JMesh(np.array(jax.devices()[:dp * sp]).reshape(dp, sp),
                 ("dp", "sp"))


def test_dc_codes_sharded_matches_jax_shard_map():
    """Four stripes of three images' DCs: each stripe's codes start from
    the stripe above's last DC, as the JAX ppermute hands it down; equal
    neighbours across a boundary give code 0."""
    rng = np.random.RandomState(5)
    b, sp, n = 3, 4, 6
    dc = rng.randint(-2047, 2048, (b, sp * n)).astype(np.int32)
    dc[0, n] = dc[0, n - 1]                      # a zero diff at a boundary
    dc[1, 2 * n:3 * n] = 0
    f = jax.jit(jshard._shard_map(
        lambda d: jax.vmap(lambda v: jshard._dc_codes_sharded(v, "sp"))(d),
        _jmesh(1, sp), in_specs=(P(None, "sp"),), out_specs=P(None, "sp")))
    want = np.asarray(f(jnp.asarray(dc)))
    parts, prev = [], None
    for s in range(sp):
        d = torch.from_numpy(dc[:, s * n:(s + 1) * n])
        parts.append(shard._dc_codes_sharded(d, prev).reshape(b, n))
        prev = d[:, -1]
    np.testing.assert_array_equal(torch.cat(parts, 1).numpy(), want)


@pytest.mark.parametrize("width,sub_h,clip_row", [
    (72, 8, 1), (72, 3, 0), (64, 12, 1), (70, 6, 0), (72, 8, -1),
    (72, 8, 2)])
def test_average_extra_luma_dynamic_row_matches_jax(width, sub_h, clip_row):
    """The partial-row flatten at a stripe-local row (x-clipped or not;
    -1 and rows: not in the stripe) == the JAX dynamic-slice version."""
    rows, b = 2, 2
    mb_w = -(-width // 16)
    yb = np.random.RandomState(width + sub_h).randint(
        -128, 128, (b * rows * mb_w * 4, 64)).astype(np.int32)
    want = jcs.average_extra_luma_dynamic_row(
        jnp.asarray(yb), rows, mb_w, width, sub_h, jnp.int32(clip_row))
    got = colorspace.average_extra_luma_dynamic_row(
        torch.from_numpy(yb), rows, mb_w, width, sub_h, clip_row)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n_images", [1, 2])
def test_masked_statistics_match_jax(n_images):
    """store_histo(valid=) and vlc.grouped_stats(valid=) == the JAX masked
    versions: padding blocks count nothing, DC and EOB included."""
    rng = np.random.RandomState(7 + n_images)
    per = 48
    n = n_images * per
    coef = (rng.laplace(0, 40, (n, 64)) * (rng.rand(n, 64) < 0.4)).astype(
        np.int32)
    coef[:, 0] = rng.randint(-900, 900, n)
    coef[3, 5:] = 0                               # an early EOB
    coef[4, 1:40] = 0                             # a ZRL run
    valid = np.tile(np.arange(per) < 30, n_images)
    np.testing.assert_array_equal(
        quantize.store_histo(torch.from_numpy(coef), n_images,
                             torch.from_numpy(valid)).numpy(),
        np.asarray(jax.jit(jquantize.store_histo, static_argnums=1)(
            jnp.asarray(coef), n_images, jnp.asarray(valid))))
    q = coef // 8
    group = (np.arange(n) % 6 >= 4).astype(np.int32)
    dc = jax.jit(jvlc.dc_diff_codes, static_argnums=1)(
        jnp.asarray(q[:, 0]), n_images)
    want = jax.jit(lambda q, dc, g, v: jengine._grouped_stats(
        jvlc.run_levels(q), dc, g, n_images, v))(
            jnp.asarray(q), dc, jnp.asarray(group), jnp.asarray(valid))
    got = vlc.grouped_stats(
        vlc.run_levels(torch.from_numpy(q), torch.int32),
        torch.from_numpy(np.array(dc)), torch.from_numpy(group),
        n_images, torch.from_numpy(valid))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_stitch_matches_jax():
    """Stripe streams of 0, 1, 31, 32, 2047, 2048 and 2049 bits, read as
    64-word pieces through stream_concat_plain == the JAX batched concat of
    whole stripe streams."""
    rng = np.random.RandomState(11)
    lens = np.array([0, 1, 31, 32, 2047, 2048, 2049])
    b, s, bucket = 3, len(lens), 128
    totals = np.stack([rng.permutation(lens) for _ in range(b)])
    pieces = np.clip(totals.reshape(-1, 1) - 2048 * np.arange(2), 0, 2048)
    words = random_streams(rng, pieces.reshape(-1)).view(np.uint32)
    got_w, got_t = shard.stitch_shard_streams(
        torch.from_numpy(words.view(np.int32).reshape(b, s, bucket)),
        torch.from_numpy(totals.astype(np.int32)))
    want_w, want_t = jpack.concat_block_streams_batched(
        jnp.asarray(words.reshape(b * s, bucket)),
        jnp.asarray(totals.reshape(-1), jnp.int32),
        n_images=b, bucket=s * bucket)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(got_w.numpy().view(np.uint32),
                                  np.asarray(want_w))


def test_encode_shard_chain_matches_jax():
    """encode_shard over four stripes, each handing its last DCs down ==
    the JAX make_sharded_encode on a (1, 4) mesh: each stripe's words and
    exact total, the summed histograms and frequencies, and the stitch."""
    x = _imgs(2, 64, 64, seed0=20)
    p = JaxParam(quality=75)
    qms = [jspec.finalize_quant_matrix(
        p.resolved_quant_matrices()[i], p.resolved_min_quant_matrices()[i],
        p.quantization_bias) for i in range(2)]
    jiq, jib = _quant_device_arrays(qms)
    jdcl, jacl = _device_luts(j_k3())
    enc = jshard.make_sharded_encode(_jmesh(1, 4), C.YUV_420, 64, 64,
                                     (4, 1, 1))
    s, t, hl, hc, fd, fa = (np.asarray(a) for a in enc(
        jnp.asarray(x), jiq, jib, jdcl, jacl))
    tq = [torch.from_numpy(np.asarray(a).astype(np.int64).astype(
        np.uint32).view(np.int32)) for a in (jiq, jib, jdcl, jacl)]
    for b in range(2):
        prev, sums, words, totals = None, None, [], []
        for st in range(4):
            out = shard.encode_shard(torch.from_numpy(x[b, 16 * st:16 * st
                                                         + 16]),
                                     *tq, prev, yuv_mode=C.YUV_420,
                                     nb_blocks=(4, 1, 1))
            np.testing.assert_array_equal(out[0].numpy().view(np.uint32),
                                          s[b, st])
            assert int(out[1]) == t[b, st]
            words.append(out[0])
            totals.append(out[1])
            sums = out[2:6] if sums is None else [a + o for a, o in
                                                  zip(sums, out[2:6])]
            prev = out[6]
        for got, want in zip(sums, (hl[b], hc[b], fd[b], fa[b])):
            np.testing.assert_array_equal(got.numpy(), want)
        gw, gt = shard.stitch_shard_streams(torch.stack(words)[None],
                                            torch.stack(totals)[None])
        jw, jt = jshard.stitch_shard_streams(jnp.asarray(s[b]),
                                             jnp.asarray(t[b]))
        assert int(gt[0]) == int(jt)
        n = -(-int(jt) // 32)
        np.testing.assert_array_equal(gw[0, :n].numpy().view(np.uint32),
                                      np.asarray(jw)[:n])


def test_sharded_auto_and_sharp_match_jax():
    """A mixed AUTO batch (4:4:4 and sharp picks at 64 x 64) runs one
    sharded sub-batch per mode; SHARP pinned on the sharp picks (the JAX
    side reuses that sub-batch's compile) converts per dp row."""
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[0:64, 0:64]
    grad = np.stack([xx * 4 % 256, yy * 4 % 256, (xx + yy) % 256], -1)
    x = np.stack([rng.randint(0, 256, (64, 64, 3)), grad,
                  make_test_image(64, 64)]).astype(np.uint8)
    modes = engine.auto_modes(torch.from_numpy(x))
    assert modes == [C.YUV_444, C.YUV_SHARP, C.YUV_SHARP]
    mesh = _mesh(2, 2)
    _same(api.encode_batch_sharded(x, EncoderParam(), mesh),
          jengine.encode_batch(x, JaxParam()))
    sharp = dict(yuv_mode=C.YUV_SHARP)
    _same(api.encode_batch_sharded(x[1:], EncoderParam(**sharp), mesh),
          jengine.encode_batch(x[1:], JaxParam(**sharp)))


@pytest.mark.parametrize("trellis", [False, True])
def test_stage_intermediates_match_jax(trellis):
    """On (1, 4) at 56 rows (4 MCU rows, the last partial, one a stripe)
    with per-image matrices: the summed histograms, each image's DC codes
    and VLC fields over the stripes' real blocks, the summed frequencies,
    and the stitched words and totals == the JAX unsharded stages'."""
    x = _imgs(2, 56)
    tp = _params("m7_420" if trellis else "m4_420")[1]
    run = api._Sharded(x, tp, _mesh(1, 4), C.YUV_420, 4.0, False)
    run.coeffs()
    hl, hc = run.histos[0]
    jco, (jhl, jhc) = jengine._stage_batch_coeffs(
        jnp.asarray(x), C.YUV_420, 72, 56, True, 2)
    np.testing.assert_array_equal(hl.numpy(), np.asarray(jhl).reshape(
        2, 64, -1))
    np.testing.assert_array_equal(hc.numpy(), np.asarray(jhc).reshape(
        2, 64, -1))
    run.fit()
    run.quantize()
    quant = [jnp.asarray(a.numpy()) for a in run.row_arrays[0]]
    iq, ib = quant[:2]
    if trellis:
        (jrl, jdc, jgrp), (jfdc, jfac) = jengine._stage_quantize_trellis(
            jco, iq, ib, quant[2],
            jengine._trellis_cost_lens(), True, (4, 1, 1), 2,
            per_image_stats=True)
    else:
        (jrl, jdc, jgrp), (jfdc, jfac) = jengine._stage_batch_quantize(
            jco, iq, ib, True, (4, 1, 1), 2, per_image_stats=True)
    per_row = run.geo.layout.mb_w * 6
    for field in ("run", "size", "code", "dc"):
        parts = []
        for j in range(2):
            for s, (rl, dc, _) in enumerate(run.state[0]):
                per_l = dc.shape[0] // 2
                sel = slice(j * per_l, j * per_l + run.geo.vrows[s] * per_row)
                parts.append((dc if field == "dc" else rl[field])[sel])
        want = jdc if field == "dc" else jrl[field]
        np.testing.assert_array_equal(torch.cat(parts).numpy(),
                                      np.asarray(want), err_msg=field)
    fdc, fac = run.freqs[0]
    np.testing.assert_array_equal(fdc.numpy(), np.asarray(jfdc))
    np.testing.assert_array_equal(fac.numpy(), np.asarray(jfac))
    run.tables()
    run.pack()
    run.stitch()
    words, totals = run.stitched[0]
    dcl, acl = (jnp.asarray(t.numpy().view(np.uint32)) for t in run.luts[0])
    jwords, jtotals = jengine._stage_batch_pack(
        (jrl, jdc, jgrp), dcl, acl, n_images=2, bucket=words.shape[1],
        per_image_tables=True)
    np.testing.assert_array_equal(totals[:, -1].numpy(), np.asarray(jtotals))
    np.testing.assert_array_equal(words.numpy().view(np.uint32),
                                  np.asarray(jwords))
