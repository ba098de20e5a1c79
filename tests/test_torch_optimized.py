"""The port's method-1/3/4 batched encode, end to end, against the JAX
package: sjpeg_tpu_torch.engine on device="cpu" must give the same bytes as
sjpeg_tpu.engine (CPU backend, the staged optimized path) for per-image and
shared statistics, every entry point, pinned modes and the bucket-overflow
re-pack.  Shapes are reused so that the JAX side compiles few programs."""

from unittest import mock

import numpy as np
import pytest
import torch

from sjpeg_tpu import engine as jengine
from sjpeg_tpu.params import EncoderParam as JaxParam

from sjpeg_tpu_torch import constants as C
from sjpeg_tpu_torch import engine
from sjpeg_tpu_torch.ops import huffman_device
from sjpeg_tpu_torch.params import EncoderParam

SHAPE = (2, 40, 24)          # (batch, height, width): not a multiple of 16
METHODS = {1: dict(adaptive_quantization=False),
           3: dict(huffman_compress=False),
           4: dict()}


def _params(method=4, **kw):
    kw = dict(METHODS[method], **kw)
    return JaxParam(**kw), EncoderParam(**kw)


def _rgb(seed, b, h, w):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    grad = np.stack([xx * 255 // w, yy * 255 // h, (xx + yy) % 256], -1)
    rgb = np.clip(grad + rng.randint(-40, 40, (b, h, w, 3)), 0, 255)
    rgb = rgb.astype(np.uint8)
    rgb[0, :16, :16] = [0, 0, 255]       # U = +128
    rgb[-1, 16:, 16:] = [255, 0, 0]      # V = +128
    return rgb


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[:2] == b"\xff\xd8" and g[-2:] == b"\xff\xd9"
        assert g == w


@pytest.mark.parametrize("share", [False, True])
@pytest.mark.parametrize("method", [1, 3, 4])
def test_methods_match_jax(method, share):
    """Methods 1, 3 and 4 at 4:2:0, per-image and shared statistics."""
    jp, tp = _params(method, yuv_mode=C.YUV_420)
    rgb = _rgb(41, *SHAPE)
    _same(engine.encode_batch(rgb, tp, share_statistics=share, device="cpu"),
          jengine.encode_batch(rgb, jp, share_statistics=share))


@pytest.mark.parametrize("mode", [C.YUV_444, C.YUV_400])
def test_method4_modes_match_jax(mode):
    jp, tp = _params(yuv_mode=mode)
    rgb = _rgb(42, *SHAPE)
    _same(engine.encode_batch(rgb, tp, device="cpu"),
          jengine.encode_batch(rgb, jp))


@pytest.mark.parametrize("is_420", [True, False])
def test_method4_yuv_matches_jax(is_420):
    b, h, w = SHAPE
    rng = np.random.RandomState(43)
    ch, cw = ((h + 1) // 2, (w + 1) // 2) if is_420 else (h, w)
    y = rng.randint(0, 256, (b, h, w)).astype(np.uint8)
    u, v = (rng.randint(0, 256, (b, ch, cw)).astype(np.uint8)
            for _ in range(2))
    jp, tp = _params(quality=90)
    _same(engine.encode_batch_yuv(y, u, v, is_420, tp, device="cpu"),
          jengine.encode_batch_yuv(y, u, v, is_420, jp))


def test_method4_gray_matches_jax():
    y = np.random.RandomState(44).randint(0, 256, SHAPE).astype(np.uint8)
    jp, tp = _params(quality=60)
    _same(engine.encode_batch_gray(torch.from_numpy(y), tp, device="cpu"),
          jengine.encode_batch_gray(y, jp))


@pytest.mark.parametrize("fn", ["encode_batch_nv12", "encode_batch_nv21"])
def test_method4_semiplanar_matches_jax(fn):
    b, h, w = SHAPE
    rng = np.random.RandomState(45)
    y = rng.randint(0, 256, (b, h, w)).astype(np.uint8)
    uv = rng.randint(0, 256, (b, (h + 1) // 2, (w + 1) // 2, 2)).astype(
        np.uint8)
    jp, tp = _params()
    _same(getattr(engine, fn)(y, uv, tp, device="cpu"),
          getattr(jengine, fn)(y, uv, jp))


@pytest.mark.parametrize("share", [False, True])
def test_bucket_overflow_repacks_byte_identical(share):
    """A uniform-noise 256 x 256 image at q95 overflows the 4,096-word
    minimum bucket; the port re-packs that image's chosen VLC state with
    its chosen tables (with shared tables the batch's, which a lone
    re-encode would not derive) and must match the JAX engine."""
    b, h, w = 2, 256, 256
    rgb = np.empty((b, h, w, 3), np.uint8)
    rgb[0] = np.random.RandomState(46).randint(0, 256, (h, w, 3))
    rgb[1] = _rgb(47, 1, h, w)[0]
    jp, tp = _params(quality=95, yuv_mode=C.YUV_420)
    with mock.patch.object(engine, "_repack_one",
                           wraps=engine._repack_one) as spy:
        got = engine.encode_batch(rgb, tp, 0.0, share_statistics=share,
                                  device="cpu")
    assert [c.args[3] for c in spy.call_args_list] == [0]   # image 0 only
    _same(got, jengine.encode_batch(rgb, jp, bits_per_pixel_budget=0.0,
                                    share_statistics=share))


def test_method4_batch_matches_per_image_encode_rgb():
    """Per-image statistics make each image of a batch byte-equal to its
    own single-image encode (the reference's semantics)."""
    jp, tp = _params(yuv_mode=C.YUV_420)
    rgb = _rgb(48, *SHAPE)
    huffman_device.optimal_code_luts.any_reads = 0
    got = engine.encode_batch(rgb, tp, device="cpu")
    assert huffman_device.optimal_code_luts.any_reads >= 2
    _same(got, [jengine.encode_rgb(img, jp) for img in rgb])
