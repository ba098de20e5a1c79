"""The port's last two kernels, fdct and quant_pack: their plain PyTorch
versions against the TPU kernels fdct_blocks_pallas and
quant_vlc_pack_pallas run in interpret mode, the port's _interleave_coeffs
against the JAX package's, and block_core.cuh's fdct_block and its
quantize-and-emit half (quant_emit_block) built with g++ against the plain
versions.  Comparisons are exact.  The CUDA launches themselves are tested
in test_torch_cuda.py."""

import contextlib
import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sjpeg_tpu import engine as jengine
from sjpeg_tpu import spec as jspec
from sjpeg_tpu.huffman import k3_default_tables as j_k3
from sjpeg_tpu.ops import colorspace as jcs
from sjpeg_tpu.ops import fdct as jfdct
from sjpeg_tpu.params import quant_matrices_for_quality as j_qmq

from sjpeg_tpu_torch import constants as C
from sjpeg_tpu_torch import engine, state
from sjpeg_tpu_torch.ops import fdct, quant_pack

REPO = Path(__file__).resolve().parents[1]
NB = (4, 1, 1)


@contextlib.contextmanager
def _interpret():
    """Run every pl.pallas_call in interpret mode, as
    tests/test_device_kernels.py does."""
    from jax.experimental import pallas as pl
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    pl.pallas_call = patched
    try:
        yield
    finally:
        pl.pallas_call = orig


def _tables(q):
    """numpy iquant, bias, DC LUTs, AC LUTs at quality q (K.3 tables)."""
    qms = [jspec.finalize_quant_matrix(j_qmq(q)[i], np.ones(64, np.uint8),
                                       C.DEFAULT_BIAS) for i in range(2)]
    return [np.asarray(a) for a in (*jengine._quant_device_arrays(qms),
                                    *jengine._device_luts(j_k3()))]


def _samples(seed: int, n: int) -> np.ndarray:
    """[n, 64] centred samples over the whole range an 8-bit source gives,
    RGB chroma's +128 included, with flat and extreme blocks."""
    rng = np.random.RandomState(seed)
    blocks = rng.randint(-128, 129, (n, 64)).astype(np.int32)
    blocks[0] = 128
    blocks[1] = -128
    blocks[2::7] //= 8                             # smooth: zero runs
    blocks[3::7, 1:] = blocks[3::7, :1]            # flat
    return blocks


def test_fdct_plain_matches_pallas_interpret():
    """fdct_blocks_plain == fdct_blocks_pallas in interpret mode on 300
    blocks (not a multiple of the tile), and the wrapper takes the plain
    version for CPU tensors, from int16 as from int32."""
    from sjpeg_tpu.ops import pallas_fdct
    blocks = _samples(61, 300)
    with _interpret():
        want = np.asarray(pallas_fdct.fdct_blocks_pallas.__wrapped__(
            jnp.asarray(blocks), tile=64))
    got = fdct.fdct_blocks_plain(torch.from_numpy(blocks))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    for dtype in (torch.int16, torch.int32):
        via = fdct.fdct_blocks(torch.from_numpy(blocks).to(dtype))
        assert torch.equal(via, got)


def _image_coeffs(seed: int):
    """(JAX, port) per-component fDCT coefficients of a 4:2:0 48 x 40 RGB
    image with saturated chroma."""
    rng = np.random.RandomState(seed)
    rgb = rng.randint(0, 256, (40, 48, 3)).astype(np.uint8)
    rgb[:16, :16] = [0, 0, 255]
    rgb[16:32, 16:32] = [255, 0, 0]
    jco = [jfdct.fdct_blocks(b) for b in jcs.rgb_to_blocks(
        jnp.asarray(rgb), C.YUV_420, 48, 40)]
    return jco, [torch.from_numpy(np.array(c)) for c in jco]


def _extreme_coeffs(seed: int):
    """(JAX, port) coefficients of 12 MCUs with most positions zero and
    int16 extremes (32767, -32768): long zero runs and the largest sizes."""
    rng = np.random.RandomState(seed)
    jco, co = [], []
    for n in NB:
        c = rng.randint(-32768, 32768, (12 * n, 64))
        c[rng.rand(*c.shape) < 0.7] = 0
        c[0, :] = 32767
        c[-1, 1] = -32768
        c = c.astype(np.int32)
        jco.append(jnp.asarray(c))
        co.append(torch.from_numpy(c))
    return jco, co


@pytest.mark.parametrize("source,q", [("image", 75), ("image", 100),
                                      ("extreme", 50)])
def test_quant_pack_plain_matches_pallas_interpret(source, q):
    """Port _interleave_coeffs + quant_pack_plain == JAX _interleave_coeffs
    + quant_vlc_pack_pallas in interpret mode (tile 16), bit for bit."""
    from sjpeg_tpu.ops import pallas_quant_pack as pqp
    jco, co = (_image_coeffs(62) if source == "image"
               else _extreme_coeffs(63))
    arrays = _tables(q)
    iq, ib, dcl, acl = (jnp.asarray(a) for a in arrays)
    with _interpret():
        jinter, jdc, jgroup = jengine._interleave_coeffs(jco, iq, ib, NB)
        want_w, want_b = pqp.quant_vlc_pack_pallas.__wrapped__(
            jinter, jdc, jgroup, iq, ib, dcl, acl, tile=16)

    t = state.tables_from_numpy(*arrays, "cpu")
    cinter, dc, group = engine._interleave_coeffs(co, t[0], t[1], NB)
    np.testing.assert_array_equal(cinter.numpy(), np.asarray(jinter))
    np.testing.assert_array_equal(dc.numpy(), np.asarray(jdc))
    np.testing.assert_array_equal(group.numpy(), np.asarray(jgroup))
    words, bits = quant_pack.quant_pack(cinter, dc, group, *t)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(want_b))
    np.testing.assert_array_equal(words.numpy().view(np.uint32),
                                  np.asarray(want_w))


_HOST_SHIM = """
#define __host__
#define __device__
#include "block_core.cuh"
extern "C" void fdct_blocks(const int32_t* samples, int32_t* coeffs, int n) {
  for (int b = 0; b < n; ++b) {
    uint32_t x[64];
    for (int k = 0; k < 64; ++k) x[k] = (uint32_t)samples[64 * b + k];
    sjpeg::fdct_block(x);
    for (int k = 0; k < 64; ++k) coeffs[64 * b + k] = (int32_t)x[k];
  }
}
extern "C" void quant_emit_blocks(const int32_t* coeffs, const int32_t* dc,
                                  const int32_t* group, const uint32_t* iq,
                                  const uint32_t* ib, const uint32_t* dcl,
                                  const uint32_t* acl, uint32_t* words,
                                  int32_t* bits, int n) {
  for (int b = 0; b < n; ++b) {
    uint32_t x[64];
    for (int k = 0; k < 64; ++k) x[k] = (uint32_t)coeffs[64 * b + k];
    bits[b] = sjpeg::quant_emit_block(x, (uint32_t)dc[b], group[b] & 1, iq,
                                      ib, dcl, acl, words + 64 * b);
  }
}
"""


@pytest.fixture(scope="module")
def host_core(tmp_path_factory):
    """csrc/block_core.cuh's fdct_block and quant_emit_block built by the
    host C++ compiler."""
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
    so.fdct_blocks.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int]
    so.quant_emit_blocks.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int]
    so.fdct_blocks.restype = so.quant_emit_blocks.restype = None
    return so


@pytest.mark.parametrize("lo,hi", [(-128, 129), (-32768, 32768)])
def test_fdct_block_host_build_matches_plain(host_core, lo, hi):
    """fdct.cu's per-block core == fdct_blocks_plain on 2k random blocks:
    8-bit samples, and the full int16 range, where the int32 products
    wrap."""
    n = 2048
    blocks = np.random.RandomState(64).randint(lo, hi, (n, 64)).astype(
        np.int32)
    blocks[:n // 4] //= 16
    got = np.zeros((n, 64), np.int32)
    host_core.fdct_blocks(blocks.ctypes.data, got.ctypes.data, n)
    np.testing.assert_array_equal(
        got, fdct.fdct_blocks_plain(torch.from_numpy(blocks)).numpy())


@pytest.mark.parametrize("q", [30, 75, 100])
def test_quant_emit_block_host_build_matches_plain(host_core, q):
    """quant_pack.cu's per-block core (the quantize-and-emit half that
    sample_pack shares) == quant_pack_plain on 2k coefficient blocks from
    real samples and from the int16 range, with both table groups."""
    n = 2048
    rng = np.random.RandomState(65 + q)
    coeffs = fdct.fdct_blocks_plain(torch.from_numpy(
        _samples(66, n))).numpy()
    coeffs[n // 2:] = rng.randint(-32768, 32768, (n // 2, 64)) * (
        rng.rand(n // 2, 64) < 0.3)
    group = rng.randint(0, 2, n).astype(np.int32)
    dc = engine.vlc.dc_diff_codes(torch.from_numpy(
        rng.randint(-2047, 2048, n)), 4).numpy()
    t = state.tables_from_numpy(*_tables(q), "cpu")
    want_w, want_b = quant_pack.quant_pack_plain(
        torch.from_numpy(coeffs), torch.from_numpy(dc),
        torch.from_numpy(group), *t)

    words = np.zeros((n, 64), np.uint32)
    bits = np.zeros(n, np.int32)
    host = [np.ascontiguousarray(x.numpy()) for x in t]
    host_core.quant_emit_blocks(coeffs.ctypes.data, dc.ctypes.data,
                                group.ctypes.data,
                                *(a.ctypes.data for a in host),
                                words.ctypes.data, bits.ctypes.data, n)
    np.testing.assert_array_equal(bits, want_b.numpy())
    np.testing.assert_array_equal(words, want_w.numpy().view(np.uint32))
