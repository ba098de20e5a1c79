"""The port's sharded API (sjpeg_tpu_torch.parallel) against the JAX
package, in one process on meshes of repeated CPU devices: bytes equal to
sjpeg_tpu.engine.encode_batch (the JAX CPU backend) for every (dp, sp)
mesh, method and mode, ragged heights and batches, shared statistics and
the per-stripe bucket overflow.  No tolerance anywhere: everything is
integer.  One geometry (4 x 40 x 72: 3 MCU rows at 4:2:0, the last
partial, so every mesh with sp > 1 is ragged) serves the byte matrix and
the ragged and odd batches, so the JAX side compiles each configuration
once; the JAX compiles, not the port, take this file's time.  AUTO, sharp, the stage intermediates and the units
are in test_torch_sharded_units.py, the processes in
test_torch_sharded_multiproc.py."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh

from sjpeg_tpu import engine as jengine
from sjpeg_tpu.params import EncoderParam as JaxParam
from sjpeg_tpu.parallel.api import encode_batch_sharded as jax_sharded

from sjpeg_tpu_torch import constants as C
from sjpeg_tpu_torch import engine
from sjpeg_tpu_torch.params import EncoderParam
from sjpeg_tpu_torch.parallel import api
from sjpeg_tpu_torch.parallel.mesh import make_mesh

from conftest import make_test_image
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")
M0 = dict(huffman_compress=False, adaptive_quantization=False)
CONFIGS = {
    "m0_420": dict(M0, yuv_mode=C.YUV_420),
    "m4_420": dict(yuv_mode=C.YUV_420),
    "m4_444": dict(yuv_mode=C.YUV_444),
    "m1_400": dict(adaptive_quantization=False, yuv_mode=C.YUV_400),
    "m7_420": dict(use_trellis=True, yuv_mode=C.YUV_420),
}


def _mesh(dp, sp):
    return make_mesh(dp, sp, [CPU] * (dp * sp))


def _imgs(b, h=40, w=72, seed0=0):
    return np.stack([make_test_image(w, h, seed=seed0 + i)
                     for i in range(b)])


def _params(name, **kw):
    kw = dict(CONFIGS[name], quality=78, **kw)
    return JaxParam(**kw), EncoderParam(**kw)


@functools.lru_cache(maxsize=None)
def _jax_bytes(name, b=4, h=40, share=False):
    """sjpeg_tpu.engine.encode_batch of _imgs(b, h) under CONFIGS[name],
    once per configuration."""
    return jengine.encode_batch(_imgs(b, h), _params(name)[0],
                                share_statistics=share)


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[:2] == b"\xff\xd8" and g[-2:] == b"\xff\xd9"
        assert g == w


# (config, mesh, also against the JAX sharded API on the same mesh)
BYTE_CASES = [
    ("m0_420", (1, 2), True), ("m0_420", (2, 4), False),
    ("m4_420", (2, 2), True), ("m4_420", (1, 4), True),
    ("m4_444", (1, 4), False), ("m4_444", (2, 1), True),
    ("m1_400", (2, 1), False), ("m1_400", (1, 2), False),
    ("m7_420", (1, 2), False), ("m7_420", (2, 2), False),
]


@pytest.mark.parametrize("name,mesh,vs_jax_sharded", BYTE_CASES,
                         ids=[f"{n}-{d}x{s}" for n, (d, s), _ in BYTE_CASES])
def test_sharded_bytes_match_jax(name, mesh, vs_jax_sharded):
    """4 x 40 x 72: bytes == the JAX unsharded encode (and, once a mesh
    shape, == sjpeg_tpu.parallel.api.encode_batch_sharded on the JAX CPU
    mesh of the same shape).  At 4:2:0, sp = 2 puts the partial MCU row
    (8 of 16 rows, x-clipped too) inside stripe 1 and sp = 4 leaves a
    stripe all padding; 4:4:4 and 4:0:0 have 5 MCU rows.  (1, 4) at 4:2:0
    method 4 holds the DC chain across stripes, three components and
    per-image matrices."""
    dp, sp = mesh
    x = _imgs(4)
    jp, tp = _params(name)
    got = api.encode_batch_sharded(x, tp, _mesh(dp, sp))
    _same(got, _jax_bytes(name))
    if vs_jax_sharded:
        jmesh = JMesh(np.array(jax.devices()[:dp * sp]).reshape(dp, sp),
                      ("dp", "sp"))
        _same(got, jax_sharded(x, jp, jmesh))


@pytest.mark.parametrize("name,b,mesh", [
    ("m4_420", 3, (2, 2)),        # 3 images on dp = 2: one padding image
    ("m7_420", 3, (2, 2)),        # the same, trellis
    ("m4_444", 3, (2, 4)),        # 5 MCU rows on 4 stripes, 8 devices
    ("m0_420", 1, (1, 4)),        # one image
    ("m1_400", 1, (4, 1)),        # one image on 4 dp rows: 3 padding
])
def test_sharded_ragged_bytes_match_jax(name, b, mesh):
    """Batches not divisible by the dp rows.  Per-image statistics make
    each image's bytes independent of its batch, so the JAX reference is
    the cached encode of the first images of the same geometry."""
    got = api.encode_batch_sharded(_imgs(b), _params(name)[1], _mesh(*mesh))
    _same(got, _jax_bytes(name)[:b])


@pytest.mark.parametrize("mesh", [(2, 2), (2, 1)])
def test_sharded_share_statistics_match_jax(mesh):
    """share_statistics=True == the unsharded shared encode of 3 x 64 x 72
    (whole stripes): the padding image on dp = 2 must not count (the JAX
    sharded API counts it: ROADMAP C)."""
    got = api.encode_batch_sharded(_imgs(3, 64), _params("m4_420")[1],
                                   _mesh(*mesh), share_statistics=True)
    _same(got, _jax_bytes("m4_420", 3, 64, True))


@pytest.mark.parametrize("share,trellis", [(False, True), (True, False)])
def test_sharded_overflow_matches_jax(share, trellis):
    """A noise image at q100 with a tiny budget overflows a stripe's
    bucket: it is packed again from its own VLC state and tables, which
    gives the unsharded bytes also with shared tables (the JAX sharded
    API re-encodes it on the host with its own tables: ROADMAP C)."""
    x = np.stack([np.random.RandomState(3).randint(0, 256, (96, 96, 3)),
                  make_test_image(96, 96)]).astype(np.uint8)
    kw = dict(quality=100, yuv_mode=C.YUV_420, use_trellis=trellis)
    repacked = []
    real = api._Sharded._repack

    def spy(run, r, j):
        repacked.append((r, j))
        return real(run, r, j)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(api._Sharded, "_repack", spy)
        got = api.encode_batch_sharded(x, EncoderParam(**kw), _mesh(2, 2),
                                       0.0001, share)
    assert repacked == [(0, 0)]
    _same(got, jengine.encode_batch(x, JaxParam(**kw), 0.0001, share))
