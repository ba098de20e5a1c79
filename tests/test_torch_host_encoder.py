"""The port's host encoder by name (sjpeg_tpu_torch.host_encoder, the engine
on the CPU through the kernels' plain versions), its pipeline block
helpers, and the engine's one-image core (`encode_core`, `fetch_stream`)
against the JAX package's: bytes, blocks and stream words exact.  Tiny
geometries shared with the single-image tests: RGB 40 x 24, RGB 33 x 17
and gray 16 x 16."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sjpeg_tpu
from sjpeg_tpu import engine as jengine
from sjpeg_tpu import host_encoder as jhost
from sjpeg_tpu import pipeline as jpipeline
from sjpeg_tpu.params import EncoderParam as JaxParam

import sjpeg_tpu_torch
from sjpeg_tpu_torch import constants as C
from sjpeg_tpu_torch import engine, host_encoder, pipeline, state
from sjpeg_tpu_torch.huffman import k3_default_tables
from sjpeg_tpu_torch.params import EncoderParam
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

METHODS = {0: dict(huffman_compress=False, adaptive_quantization=False),
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
MODES = [C.YUV_420, C.YUV_444, C.YUV_400, C.YUV_SHARP, C.YUV_AUTO]


def _params(method: int = 4, **kw):
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


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("method", list(METHODS))
def test_encode_rgb_matches_jax_host_encoder(method, mode):
    jp, tp = _params(method, yuv_mode=mode)
    _same(host_encoder.encode_rgb(RGB, tp), jhost.encode_rgb(RGB, jp))


@pytest.mark.parametrize("method", [0, 4])
def test_encode_gray_matches_jax_host_encoder(method):
    jp, tp = _params(method)
    _same(host_encoder.encode_gray(GRAY, tp), jhost.encode_gray(GRAY, jp))


@pytest.mark.parametrize("is_420", [True, False])
@pytest.mark.parametrize("method", [0, 4])
def test_encode_yuv_matches_jax_host_encoder(method, is_420):
    jp, tp = _params(method, quality=60)
    planes = _planes(ODD, is_420)
    _same(host_encoder.encode_yuv(*planes, is_420, tp),
          jhost.encode_yuv(*planes, is_420, jp))


@pytest.mark.parametrize("name", ["encode_nv12", "encode_nv21"])
def test_encode_semi_planar_matches_jax_host_encoder(name):
    y, u, v = _planes(ODD, True)
    uv = np.ascontiguousarray(np.stack([u, v], -1))
    jp, tp = _params(4, quality=80)
    _same(getattr(host_encoder, name)(y, uv, tp),
          getattr(jhost, name)(y, uv, jp))


def _blocks(src: str, module, layout):
    if src == "rgb":
        return module.rgb_to_component_blocks(ODD, layout)
    if src == "gray":
        return module.gray_to_component_blocks(GRAY, layout)
    if src == "nv12":
        y, u, v = _planes(ODD, True)
        return module.nv12_to_component_blocks(
            y, np.ascontiguousarray(np.stack([v, u], -1)), layout,
            is_nv12=False)
    return module.yuv_planes_to_component_blocks(
        *_planes(ODD, layout.yuv_mode != C.YUV_444), layout)


BLOCK_CASES = [("rgb", C.YUV_420), ("rgb", C.YUV_444), ("rgb", C.YUV_400),
               ("gray", C.YUV_400), ("planes", C.YUV_420),
               ("planes", C.YUV_444), ("planes", C.YUV_SHARP),
               ("nv12", C.YUV_420)]


@pytest.mark.parametrize("src,mode", BLOCK_CASES)
def test_pipeline_blocks_match_jax(src, mode):
    """Every block helper's [N_c, 64] int32 arrays (scan order, the -128
    shift of planar input, the extra-luma flatten of clipped 4:2:0 MCUs
    at 33 x 17) equal sjpeg_tpu.pipeline's; so does scan_order."""
    h, w = GRAY.shape if src == "gray" else ODD.shape[:2]
    layout = pipeline.component_layout(mode, w, h)
    jlayout = jpipeline.component_layout(mode, w, h)
    got = _blocks(src, pipeline, layout)
    want = _blocks(src, jpipeline, jlayout)
    assert len(got) == len(want) == layout.nb_comps
    for g, wnt in zip(got, want):
        assert g.dtype == np.int32 and g.shape == wnt.shape
        np.testing.assert_array_equal(g, wnt)
    assert pipeline.scan_order(layout) == jpipeline.scan_order(jlayout)


def test_planar_blocks_reject_gray_layout():
    layout = pipeline.component_layout(C.YUV_400, 16, 16)
    with pytest.raises(ValueError):
        pipeline.yuv_planes_to_component_blocks(GRAY, GRAY, GRAY, layout)


@pytest.mark.parametrize("blocks_from", ["port", "jax"])
@pytest.mark.parametrize("method,mode,search", [
    (0, C.YUV_420, False), (3, C.YUV_444, False), (4, C.YUV_420, False),
    (7, C.YUV_400, False), (4, C.YUV_420, True)])
def test_encode_components_matches_jax(method, mode, search, blocks_from):
    """encode_components from the port's own blocks and from
    sjpeg_tpu.pipeline's == sjpeg_tpu.host_encoder.encode_components;
    search: a passes=3 target-size search."""
    jp, tp = _params(method, yuv_mode=mode, quality=70)
    if search:
        jp.set_target_size(500, passes=3)
        tp.set_target_size(500, passes=3)
    h, w = ODD.shape[:2]
    mod = pipeline if blocks_from == "port" else jpipeline
    blocks = mod.rgb_to_component_blocks(ODD, mod.component_layout(mode, w,
                                                                   h))
    got = host_encoder.encode_components(
        blocks, pipeline.component_layout(mode, w, h), tp)
    want = jhost.encode_components(
        jpipeline.rgb_to_component_blocks(
            ODD, jpipeline.component_layout(mode, w, h)),
        jpipeline.component_layout(mode, w, h), jp)
    _same(got, want)


@pytest.mark.parametrize("entry", ["rgb", "gray", "yuv"])
def test_top_level_host_encode_matches_jax(entry):
    """sjpeg_tpu_torch.host_encode_* are host_encoder's names and give
    sjpeg_tpu.host_encode_*'s bytes."""
    jp, tp = _params(7, yuv_mode=C.YUV_444)
    assert (getattr(sjpeg_tpu_torch, f"host_encode_{entry}")
            is getattr(host_encoder, f"encode_{entry}"))
    if entry == "rgb":
        got, want = (sjpeg_tpu_torch.host_encode_rgb(RGB, tp),
                     sjpeg_tpu.host_encode_rgb(RGB, jp))
    elif entry == "gray":
        got, want = (sjpeg_tpu_torch.host_encode_gray(GRAY, tp),
                     sjpeg_tpu.host_encode_gray(GRAY, jp))
    else:
        planes = _planes(RGB, False)
        got, want = (sjpeg_tpu_torch.host_encode_yuv(*planes, False, tp),
                     sjpeg_tpu.host_encode_yuv(*planes, False, jp))
    _same(got, want)


@pytest.mark.parametrize("mode,src_kind", [(C.YUV_420, "rgb"),
                                           (C.YUV_444, "planes"),
                                           (C.YUV_400, "planes")])
def test_encode_core_and_fetch_stream_match_jax(mode, src_kind):
    """engine.encode_core's total and the first ceil(total / 32) words,
    fetched by fetch_stream, equal sjpeg_tpu.engine's (XLA on the CPU)."""
    h, w = ODD.shape[:2]
    layout = pipeline.component_layout(mode, w, h)
    param = EncoderParam(quality=75, yuv_mode=mode, **METHODS[0])
    host = (*engine._quant_arrays(engine._quant_matrices(param)),
            *engine._host_luts(k3_default_tables()))
    if src_kind == "rgb":
        src = ODD
    else:
        src = (ODD[..., 0].copy(),) if mode == C.YUV_400 else _planes(ODD,
                                                                      False)
    kw = dict(yuv_mode=mode, width=w, height=h,
              nb_blocks=tuple(layout.nb_blocks), src_kind=src_kind)
    words, total = engine.encode_core(
        torch.from_numpy(src) if src_kind == "rgb"
        else tuple(torch.from_numpy(p) for p in src),
        *state.tables_from_numpy(*host, "cpu"), **kw)
    jsrc = (jnp.asarray(src) if src_kind == "rgb"
            else tuple(jnp.asarray(p) for p in src))
    jwords, jtotal = jengine.encode_core(
        jsrc, *(jnp.asarray(a) for a in host), **kw)
    assert int(total) == int(jtotal) > 0
    n_words = (int(total) + 31) // 32
    got = engine.fetch_stream(words, int(total))
    want = jengine.fetch_stream(jwords, int(jtotal))
    assert got.dtype == np.uint32 and got.shape == (n_words,)
    np.testing.assert_array_equal(got, want)
    assert words.shape[0] == sum(layout.nb_blocks) * layout.mb_w * \
        layout.mb_h * 64
