"""The port's method-0 batched encode, end to end, against the JAX package:
sjpeg_tpu_torch.engine on device="cpu" must give the same bytes as
sjpeg_tpu.engine (CPU backend) for every entry point, geometry and the
bucket-overflow fallback."""

import numpy as np
import pytest
import torch

from sjpeg_tpu import engine as jengine
from sjpeg_tpu import host_encoder
from sjpeg_tpu.params import EncoderParam as JaxParam

from sjpeg_tpu_torch import constants as C
from sjpeg_tpu_torch import engine
from sjpeg_tpu_torch.params import EncoderParam
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

SHAPES = [(2, 40, 24), (2, 64, 48)]      # (batch, height, width)


def _params(**kw):
    kw = dict(huffman_compress=False, adaptive_quantization=False, **kw)
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


@pytest.mark.parametrize("mode", [C.YUV_420, C.YUV_444, C.YUV_400])
@pytest.mark.parametrize("shape", SHAPES)
def test_encode_batch_matches_jax(mode, shape):
    """Pinned modes; 40 x 24 is not a multiple of 16 either way."""
    jp, tp = _params(yuv_mode=mode)
    rgb = _rgb(21, *shape)
    _same(engine.encode_batch(rgb, tp, device="cpu"),
          jengine.encode_batch(rgb, jp))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("is_420", [True, False])
def test_encode_batch_yuv_matches_jax(shape, is_420):
    b, h, w = shape
    rng = np.random.RandomState(22)
    ch, cw = ((h + 1) // 2, (w + 1) // 2) if is_420 else (h, w)
    y = rng.randint(0, 256, (b, h, w)).astype(np.uint8)
    u, v = (rng.randint(0, 256, (b, ch, cw)).astype(np.uint8)
            for _ in range(2))
    jp, tp = _params(quality=90)
    _same(engine.encode_batch_yuv(y, u, v, is_420, tp, device="cpu"),
          jengine.encode_batch_yuv(y, u, v, is_420, jp))


@pytest.mark.parametrize("shape", SHAPES)
def test_encode_batch_gray_matches_jax(shape):
    y = np.random.RandomState(23).randint(0, 256, shape).astype(np.uint8)
    jp, tp = _params(quality=60)
    _same(engine.encode_batch_gray(torch.from_numpy(y), tp, device="cpu"),
          jengine.encode_batch_gray(y, jp))


@pytest.mark.parametrize("fn", ["encode_batch_nv12", "encode_batch_nv21"])
def test_encode_batch_semiplanar_matches_jax(fn):
    b, h, w = SHAPES[0]
    rng = np.random.RandomState(24)
    y = rng.randint(0, 256, (b, h, w)).astype(np.uint8)
    uv = rng.randint(0, 256, (b, (h + 1) // 2, (w + 1) // 2, 2)).astype(
        np.uint8)
    jp, tp = _params()
    _same(getattr(engine, fn)(y, uv, tp, device="cpu"),
          getattr(jengine, fn)(y, uv, jp))


def test_bucket_overflow_falls_back_byte_identical():
    """A uniform-noise 256 x 256 image at q95 needs more than the 4096-word
    minimum bucket; the port re-encodes it with a worst-case bucket and
    must match the JAX engine, which sends it to its host encoder."""
    b, h, w = 2, 256, 256
    rng = np.random.RandomState(25)
    rgb = np.empty((b, h, w, 3), np.uint8)
    rgb[0] = rng.randint(0, 256, (h, w, 3))
    rgb[1] = _rgb(26, 1, h, w)[0]
    jp, tp = _params(quality=95, yuv_mode=C.YUV_420)

    got = engine.encode_batch(rgb, tp, bits_per_pixel_budget=0.0,
                              device="cpu")
    _same(got, jengine.encode_batch(rgb, jp, bits_per_pixel_budget=0.0))

    # the overflow really happened: exact totals past the 4096-word bucket
    qms = engine._quant_matrices(tp)
    tables = engine.state.tables_from_numpy(
        *engine._quant_arrays(qms),
        *engine._host_luts(engine.k3_default_tables()), "cpu")
    _, totals = engine.encode_batch_core(
        torch.from_numpy(rgb), *tables, yuv_mode=C.YUV_420, width=w,
        height=h, nb_blocks=(4, 1, 1), bucket=4096)
    assert totals[0] > 4096 * 32 >= totals[1]


def test_noisy_mcu_at_q100_matches_host_encoder():
    """One MCU of binary RGB noise at q100 inside a smooth image, the
    densest stream a block gets here.  On the TPU path the tree concat
    truncates 4-block groups to 4096 bits and checks only the 16-block
    total; the port never truncates below the bucket, and its bytes must
    equal the host encoder's."""
    h, w = 64, 64
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([xx * 4, yy * 4, np.full_like(xx, 128)], -1).astype(
        np.uint8)
    img[16:32, 16:32] = np.random.RandomState(27).randint(
        0, 2, (16, 16, 3)) * 255
    jp, tp = _params(quality=100, yuv_mode=C.YUV_420)
    got = engine.encode_batch(img[None], tp, device="cpu")
    assert got[0] == host_encoder.encode_rgb(img, jp)


def test_explicit_limited_quantization_matches_jax():
    """Explicit matrices with a reduction and limited quantization reach
    the DQT segment and the quantizer the same way in both packages."""
    m = np.random.RandomState(28).randint(1, 100, (2, 64)).astype(np.uint8)
    jp, tp = _params(yuv_mode=C.YUV_420)
    for p in (jp, tp):
        p.set_quantization(m, reduction=80)
        p.set_limit_quantization(True, tolerance=20)
    rgb = _rgb(29, *SHAPES[0])
    _same(engine.encode_batch(rgb, tp, device="cpu"),
          jengine.encode_batch(rgb, jp))
