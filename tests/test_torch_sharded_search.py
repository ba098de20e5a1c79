"""The port's sharded target-size / target-PSNR search
(sjpeg_tpu_torch.parallel.api._ShardedSearch) against the JAX package, in
one process on meshes of repeated CPU devices: bytes equal to
sjpeg_tpu.engine.encode_batch (the JAX CPU backend) for size and PSNR
targets, methods 0, 1, 3, 4 and 7, 4:2:0, 4:4:4 and 4:0:0, passes 3-5, on
(1, 2), (2, 2), (1, 4) (a stripe of padding rows only) and (2, 1); a batch
not divisible by dp; a forced stripe overflow (the image searched again
alone); a mixed AUTO search; the delegations (a custom hook, SHARP); and
the per-image squared error summed over the stripes.  No tolerance
anywhere.  The geometry is test_torch_sharded.py's 4 x 40 x 72 (3 MCU rows
at 4:2:0, the last partial, so every sp > 1 is ragged), and each JAX
search is computed once per configuration."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from sjpeg_tpu import engine as jengine
from sjpeg_tpu.params import EncoderParam as JaxParam

from sjpeg_tpu_torch import constants as C
from sjpeg_tpu_torch import engine, engine_search
from sjpeg_tpu_torch.params import TARGET_PSNR, TARGET_SIZE, EncoderParam
from sjpeg_tpu_torch.params import SearchHook
from sjpeg_tpu_torch.parallel import api

from test_torch_sharded import M0, _imgs, _mesh, _same
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

SIZE = dict(target_mode=TARGET_SIZE, target_value=900.0)
PSNR = dict(target_mode=TARGET_PSNR, target_value=33.0)
CONFIGS = {
    "m4_420_size3": dict(yuv_mode=C.YUV_420, passes=3, **SIZE),
    "m4_420_psnr4": dict(yuv_mode=C.YUV_420, passes=4, **PSNR),
    "m0_420_size5": dict(M0, yuv_mode=C.YUV_420, passes=5, **SIZE),
    "m0_420_psnr3": dict(M0, yuv_mode=C.YUV_420, passes=3, **PSNR),
    "m7_420_size3": dict(use_trellis=True, yuv_mode=C.YUV_420, passes=3,
                         **SIZE),
    "m7_420_psnr3": dict(use_trellis=True, yuv_mode=C.YUV_420, passes=3,
                         **PSNR),
    "m1_400_size4": dict(adaptive_quantization=False, yuv_mode=C.YUV_400,
                         passes=4, **dict(SIZE, target_value=700.0)),
    "m3_444_psnr3": dict(huffman_compress=False, yuv_mode=C.YUV_444,
                         passes=3, **dict(PSNR, target_value=35.0)),
}


def _params(name, **kw):
    kw = dict(CONFIGS[name], quality=78, **kw)
    return JaxParam(**kw), EncoderParam(**kw)


@functools.lru_cache(maxsize=None)
def _jax_bytes(name):
    """sjpeg_tpu.engine.encode_batch of _imgs(4) under CONFIGS[name], once
    per configuration."""
    return jengine.encode_batch(_imgs(4), _params(name)[0])


# (config, mesh): every route of the reference's sharded search
BYTE_CASES = [
    ("m4_420_size3", (1, 2)), ("m4_420_size3", (2, 2)),
    ("m4_420_size3", (1, 4)), ("m4_420_psnr4", (2, 2)),
    ("m4_420_psnr4", (1, 4)), ("m0_420_size5", (1, 4)),
    ("m0_420_size5", (2, 2)), ("m0_420_psnr3", (1, 2)),
    ("m7_420_size3", (2, 2)), ("m7_420_size3", (1, 4)),
    ("m7_420_psnr3", (1, 2)), ("m1_400_size4", (2, 1)),
    ("m3_444_psnr3", (1, 4)),
]


@pytest.mark.parametrize("name,mesh", BYTE_CASES,
                         ids=[f"{n}-{d}x{s}" for n, (d, s) in BYTE_CASES])
def test_sharded_search_bytes_match_jax(name, mesh):
    """4 x 40 x 72: bytes == the JAX unsharded search.  (1, 4) at 4:2:0
    leaves the last stripe without a real MCU row; method 7's size search
    evolves per-image rate tables on each dp row's lead device; 4:4:4
    and 4:0:0 have 5 MCU rows.  The run reaches the sharded search, not a
    delegation, and runs the hooks' passes."""
    seen = []
    real = api._ShardedSearch.passes

    def spy(run):
        real(run)
        seen.append(run.passes_run)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(api._ShardedSearch, "passes", spy)
        got = api.encode_batch_sharded(_imgs(4), _params(name)[1],
                                       _mesh(*mesh))
    assert len(seen) == 1 and 1 <= seen[0] <= CONFIGS[name]["passes"]
    _same(got, _jax_bytes(name))


@pytest.mark.parametrize("name", ["m4_420_size3", "m7_420_size3",
                                  "m4_420_psnr4"])
def test_sharded_search_odd_batch_matches_jax(name):
    """3 images on dp = 2: the padding image takes image 0's matrices,
    never reaches a hook, never counts and never holds the loop.  Each
    image's search is independent of its batch, so the reference is the
    cached search of the first images of the same geometry."""
    got = api.encode_batch_sharded(_imgs(3), _params(name)[1], _mesh(2, 2))
    _same(got, _jax_bytes(name)[:3])


def test_sharded_search_overflow_searches_alone():
    """A stripe bucket of 64 words overflows for the noise image (image 0)
    in the early passes, never for the flat ones: only image 0 is searched
    again alone (engine_search.search_alone, on its dp row's lead device),
    and every image's bytes equal the JAX search."""
    x = _imgs(4)
    x[0] = np.random.RandomState(3).randint(0, 256, x[0].shape)
    x[1:] = 128
    jp, tp = _params("m4_420_size3")
    alone = []
    real_alone = engine_search.search_alone
    real_of = api._Geometry.of

    def spy(one, *a):
        alone.append(one.clone())
        return real_alone(one, *a)

    def small(*a, **k):
        return dataclasses.replace(real_of(*a, **k), bucket=64)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(engine_search, "search_alone", spy)
        mp.setattr(api._Geometry, "of", small)
        got = api.encode_batch_sharded(x, tp, _mesh(2, 2))
    assert len(alone) == 1 and torch.equal(alone[0][0],
                                           torch.from_numpy(x[0]))
    _same(got, jengine.encode_batch(x, jp))


def _auto_batch():
    """40 x 72 images YUV_AUTO resolves to 4:4:4 (noise, 8 x 8 colour
    blocks) and 4:2:0 (luma noise, a gray gradient)."""
    h, w = 40, 72
    yy, xx = np.mgrid[0:h, 0:w]
    rng = np.random.RandomState(5)
    return np.stack([
        rng.randint(0, 256, (h, w, 3)),
        np.clip(np.repeat(rng.randint(0, 256, (h, w, 1)), 3, -1)
                + np.array([10, 0, -10]), 0, 255),
        np.kron(rng.randint(0, 256, (5, 9, 3)), np.ones((8, 8, 1))),
        np.repeat(((xx * 3 + yy) % 256)[..., None], 3, -1),
    ]).astype(np.uint8)


def test_sharded_auto_search_matches_jax():
    """A mixed YUV_AUTO PSNR search splits per mode first and runs each
    group's search sharded (no delegation to engine.encode_batch)."""
    x = _auto_batch()
    assert engine.auto_modes(torch.from_numpy(x)) == [
        C.YUV_444, C.YUV_420, C.YUV_444, C.YUV_420]
    jp, tp = _params("m4_420_psnr4", yuv_mode=C.YUV_AUTO)
    ran = []
    real = api._ShardedSearch.__init__

    def spy(run, *a, **k):
        real(run, *a, **k)
        ran.append(run.yuv_mode)

    def no_delegation(*a, **k):
        raise AssertionError("delegated to engine.encode_batch")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(api._ShardedSearch, "__init__", spy)
        mp.setattr(engine, "encode_batch", no_delegation)
        got = api.encode_batch_sharded(x, tp, _mesh(2, 2))
    assert sorted(ran) == [C.YUV_420, C.YUV_444]
    _same(got, jengine.encode_batch(x, jp))


@pytest.mark.parametrize("kw", [dict(search_hook=SearchHook()),
                                dict(yuv_mode=C.YUV_SHARP)],
                         ids=["search_hook", "sharp"])
def test_sharded_search_delegates_as_jax(kw):
    """A custom search hook and a sharp search run on the one-device
    engine (the JAX sharded API's delegations), on the mesh's first
    device, with its bytes."""
    p = EncoderParam(**dict(CONFIGS["m4_420_size3"], quality=78, **kw))
    calls = []
    real = engine.encode_batch

    def spy(*a, **k):
        calls.append(k.get("device"))
        return real(*a, **k)

    def no_search(*a, **k):
        raise AssertionError("ran the sharded search")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(engine, "encode_batch", spy)
        mp.setattr(api, "_ShardedSearch", no_search)
        got = api.encode_batch_sharded(_imgs(2), p, _mesh(2, 1))
    assert calls == [torch.device("cpu")]
    _same(got, engine.encode_batch(_imgs(2), p, device="cpu"))


@pytest.mark.parametrize("b,mesh", [(4, (1, 4)), (3, (2, 2))])
def test_stripe_errors_match_unsharded(b, mesh):
    """The PSNR pass's per-image int64 squared error, summed over the
    stripes' real blocks (padding rows and the empty stripe masked out),
    == engine_search._batch_qerr on the unsharded coefficients, with a
    different matrix pair per image."""
    x = _imgs(b)
    p = _params("m4_420_psnr4")[1]
    run = api._ShardedSearch(x, p, _mesh(*mesh), C.YUV_420, 4.0)
    run.coeffs()
    run.fit()
    per_qms = [engine._quant_matrices(dataclasses.replace(p, quality=q))
               for q in (30, 55, 80, 95)[:b]]
    run._upload(per_qms)
    got = run.stripe_errors()[:b]
    coeffs, _ = engine._stage_batch_coeffs(torch.from_numpy(x), "rgb",
                                           C.YUV_420, 72, 40, False, b)
    iq, ib, qq = (torch.from_numpy(np.stack(
        [[q[k] for q in qms] for qms in per_qms]).astype(np.int32))
        for k in ("iquant", "bias", "quant"))
    want = engine_search._batch_qerr(coeffs, iq, ib, qq, b).numpy()
    assert got.dtype == np.int64 and (got > 0).all()
    np.testing.assert_array_equal(got, want)
