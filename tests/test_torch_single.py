"""The port's single-image API against the JAX package's, byte for byte:
encode_rgb, encode_gray, encode_yuv and encode for methods 0, 1, 3, 4 and
7 at pinned 4:2:0, 4:4:4 and 4:0:0 (and AUTO and SHARP once each), and
the single-image target-size and
target-PSNR searches, on device="cpu" (the kernels' plain versions).  The
JAX side compiles its one-image stages once per geometry, so three tiny
geometries serve every case: RGB 40 x 24, RGB 33 x 17 and gray 16 x 16."""

import numpy as np
import pytest

import sjpeg_tpu
from sjpeg_tpu import engine as jengine
from sjpeg_tpu.params import EncoderParam as JaxParam

import sjpeg_tpu_torch
from sjpeg_tpu_torch import constants as C
from sjpeg_tpu_torch import engine
from sjpeg_tpu_torch.params import EncoderParam
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

METHODS = {0: dict(huffman_compress=False, adaptive_quantization=False),
           1: dict(adaptive_quantization=False),
           3: dict(huffman_compress=False),
           4: dict(),
           7: dict(use_trellis=True)}


def _rgb(h: int, w: int, seed: int) -> np.ndarray:
    """Noise over a gradient with pure blue (U = +128) and pure red
    (V = +128) corners."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    grad = np.stack([xx * 255 // w, yy * 255 // h, (xx + yy) * 4 % 256], -1)
    rgb = np.clip(grad + rng.randint(-40, 40, (h, w, 3)), 0, 255)
    rgb[:8, :8] = [0, 0, 255]
    rgb[-8:, -8:] = [255, 0, 0]
    return rgb.astype(np.uint8)


RGB = _rgb(24, 40, 71)            # 40 x 24
ODD = _rgb(17, 33, 72)            # 33 x 17
GRAY = _rgb(16, 16, 73)[..., 1].copy()


def _params(method: int, **kw):
    kw = dict(METHODS[method], **kw)
    return JaxParam(**kw), EncoderParam(**kw)


def _planes(rgb: np.ndarray, is_420: bool):
    y = rgb[..., 0].copy()
    if is_420:
        return y, rgb[::2, ::2, 1].copy(), rgb[::2, ::2, 2].copy()
    return y, rgb[..., 1].copy(), rgb[..., 2].copy()


def _same(got: bytes, want: bytes) -> None:
    assert got[:2] == b"\xff\xd8" and got[-2:] == b"\xff\xd9"
    assert got == want


@pytest.mark.parametrize("mode", [C.YUV_420, C.YUV_444, C.YUV_400])
@pytest.mark.parametrize("method", list(METHODS))
def test_encode_rgb_matches_jax(method, mode):
    jp, tp = _params(method, yuv_mode=mode)
    _same(engine.encode_rgb(RGB, tp, device="cpu"),
          jengine.encode_rgb(RGB, jp))


@pytest.mark.parametrize("method", [0, 4, 7])
def test_encode_rgb_odd_size_matches_jax(method):
    """Width and height not multiples of 16 (edge padding, extra luma)."""
    jp, tp = _params(method, yuv_mode=C.YUV_420, quality=60)
    _same(engine.encode_rgb(ODD, tp, device="cpu"),
          jengine.encode_rgb(ODD, jp))


@pytest.mark.parametrize("method", list(METHODS))
def test_encode_gray_matches_jax(method):
    jp, tp = _params(method, quality=85)
    _same(engine.encode_gray(GRAY, tp, device="cpu"),
          jengine.encode_gray(GRAY, jp))


@pytest.mark.parametrize("is_420", [True, False])
@pytest.mark.parametrize("method", [0, 3, 4, 7])
def test_encode_yuv_matches_jax(method, is_420):
    jp, tp = _params(method)
    planes = _planes(ODD, is_420)
    _same(engine.encode_yuv(*planes, is_420, tp, device="cpu"),
          jengine.encode_yuv(*planes, is_420, jp))


SEARCHES = {"size": dict(target_mode=1, target_value=700.0, passes=6),
            "psnr": dict(target_mode=2, target_value=33.0, passes=6)}


@pytest.mark.parametrize("target", list(SEARCHES))
@pytest.mark.parametrize("method", [0, 3, 4, 7])
def test_single_search_matches_jax(method, target):
    """encode_rgb's target-size / target-PSNR dichotomy: every pass's
    decision and the final pass's bytes."""
    jp, tp = _params(method, yuv_mode=C.YUV_420, quality=90,
                     **SEARCHES[target])
    _same(engine.encode_rgb(RGB, tp, device="cpu"),
          jengine.encode_rgb(RGB, jp))


@pytest.mark.parametrize("source", ["gray", "yuv444"])
def test_planar_search_matches_jax(source):
    """The planar entry points' searches (method 4, size; method 7,
    PSNR)."""
    if source == "gray":
        jp, tp = _params(4, target_mode=1, target_value=300.0, passes=5)
        _same(engine.encode_gray(GRAY, tp, device="cpu"),
              jengine.encode_gray(GRAY, jp))
    else:
        jp, tp = _params(7, target_mode=2, target_value=35.0, passes=5)
        planes = _planes(ODD, False)
        _same(engine.encode_yuv(*planes, False, tp, device="cpu"),
              jengine.encode_yuv(*planes, False, jp))


@pytest.mark.parametrize("method", [0, 3])
def test_passes_without_target_match_jax(method):
    """passes > 1 with no target: method 0 from RGB encodes once, and
    every staged encode runs the search loop anyway, as in JAX."""
    jp, tp = _params(method, yuv_mode=C.YUV_420, passes=3)
    _same(engine.encode_rgb(RGB, tp, device="cpu"),
          jengine.encode_rgb(RGB, jp))


def test_encode_matches_jax():
    """The top-level encode() is encode_rgb (JAX: its device backend)."""
    jp, tp = _params(4, yuv_mode=C.YUV_420)
    _same(sjpeg_tpu_torch.encode(RGB, tp, device="cpu"),
          sjpeg_tpu.encode(RGB, jp))


def test_top_level_names_cover_jax():
    """`from sjpeg_tpu_torch import *` gives every name of sjpeg_tpu's
    __all__, with the same constants."""
    assert set(sjpeg_tpu.__all__) <= set(sjpeg_tpu_torch.__all__)
    ns = {}
    exec("from sjpeg_tpu_torch import *", ns)
    assert set(sjpeg_tpu.__all__) <= set(ns)
    for name in sjpeg_tpu.__all__:
        if name.startswith(("YUV_", "TARGET_")):
            assert ns[name] == getattr(sjpeg_tpu, name), name


@pytest.mark.parametrize("entry", ["encode_host", "rgb", "gray", "yuv"])
def test_host_backend_matches_jax(entry):
    """encode(rgb, p, "host") and host_encode_rgb / _gray / _yuv (the
    plain path on the CPU) == sjpeg_tpu's host encoder."""
    jp, tp = _params(4, yuv_mode=C.YUV_420)
    if entry == "encode_host":
        got = sjpeg_tpu_torch.encode(RGB, tp, "host")
        want = sjpeg_tpu.encode(RGB, jp, "host")
    elif entry == "rgb":
        got = sjpeg_tpu_torch.host_encode_rgb(ODD, tp)
        want = sjpeg_tpu.host_encode_rgb(ODD, jp)
    elif entry == "gray":
        got = sjpeg_tpu_torch.host_encode_gray(GRAY, tp)
        want = sjpeg_tpu.host_encode_gray(GRAY, jp)
    else:
        planes = _planes(RGB, True)
        got = sjpeg_tpu_torch.host_encode_yuv(*planes, True, tp)
        want = sjpeg_tpu.host_encode_yuv(*planes, True, jp)
    _same(got, want)


def test_encode_backend_names():
    """"auto" and "tpu" run the device path (here on device="cpu"); an
    unknown backend raises."""
    tp = _params(0, yuv_mode=C.YUV_420)[1]
    want = sjpeg_tpu_torch.encode(RGB, tp, "host")
    assert sjpeg_tpu_torch.encode(RGB, tp, "auto", device="cpu") == want
    assert sjpeg_tpu_torch.encode(RGB, tp, "tpu", device="cpu") == want
    with pytest.raises(ValueError, match="backend"):
        sjpeg_tpu_torch.encode(RGB, tp, "bogus")


@pytest.mark.parametrize("mode", [C.YUV_AUTO, C.YUV_SHARP])
def test_auto_and_sharp_raise_naming_a8(mode):
    """AUTO and SHARP (ROADMAP A8, ported; the name predates the port):
    encode_rgb with method 4 gives the JAX engine's bytes."""
    jp, tp = _params(4, yuv_mode=mode)
    _same(engine.encode_rgb(RGB, tp, device="cpu"),
          jengine.encode_rgb(RGB, jp))
