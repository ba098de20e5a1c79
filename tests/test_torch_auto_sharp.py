"""YUV_AUTO and sharp YUV in the port against the JAX package, on the CPU:
the riskiness scorers (ops/riskiness on tensors, the host scorer, the
block map, the exact table), the sharp conversion's planes and per-image
sweep counts (sharp_yuv's plain version, and the kernel's core,
csrc/sharp_core.cuh, built with g++), and the bytes of a mixed batch in
which AUTO picks all four modes.  4:0:0 needs (w-1)(h-1)/(wh) > 0.995, so
that batch is 408 x 408; everything else uses the tiny geometries of the
other port tests."""

import ctypes
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sjpeg_tpu
from sjpeg_tpu import engine as jengine
from sjpeg_tpu import riskiness as jrisk
from sjpeg_tpu import sharp_yuv_device as jsharp
from sjpeg_tpu.ops import riskiness as jrisk_dev
from sjpeg_tpu.params import EncoderParam as JaxParam

import sjpeg_tpu_torch
from sjpeg_tpu_torch import constants as C
from sjpeg_tpu_torch import engine, riskiness, sharp_yuv
from sjpeg_tpu_torch.ops import riskiness as risk_dev
from sjpeg_tpu_torch.params import EncoderParam

REPO = Path(__file__).resolve().parents[1]


def _rgb(h: int, w: int, seed: int) -> np.ndarray:
    """Noise over a gradient with pure blue and pure red corners."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    grad = np.stack([xx * 255 // w, yy * 255 // h, (xx + yy) * 4 % 256], -1)
    rgb = np.clip(grad + rng.randint(-40, 40, (h, w, 3)), 0, 255)
    rgb[:8, :8] = [0, 0, 255]
    rgb[-8:, -8:] = [255, 0, 0]
    return rgb.astype(np.uint8)


def _sweep_batch(h: int, w: int) -> np.ndarray:
    """Three images whose sharp conversions stop after 2, 3 and 4 sweeps at
    33 x 17: flat gray, a one-pixel checkerboard of colours, and red/blue
    stripes."""
    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack([
        np.full((h, w, 3), 128),
        np.stack([(xx % 2) * 255, (yy % 2) * 255, ((xx + yy) % 2) * 255], -1),
        np.stack([(xx // 3 % 2) * 255, 0 * xx, (yy // 2 % 2) * 255], -1),
    ]).astype(np.uint8)


def _four_modes(n: int = 408) -> np.ndarray:
    """One image for each mode AUTO picks: gray (4:0:0), a gently tinted
    gradient (4:2:0), a full-range colour gradient (sharp 4:2:0) and
    noise (4:4:4)."""
    yy, xx = np.mgrid[0:n, 0:n]
    rng = np.random.RandomState(5)
    return np.stack([
        np.repeat(((xx + yy) % 256)[..., None], 3, -1),
        np.stack([xx * 64 // n + 96, yy * 64 // n + 96,
                  np.full_like(xx, 128)], -1),
        np.stack([xx * 255 // n, yy * 255 // n, np.full_like(xx, 128)], -1),
        rng.randint(0, 256, (n, n, 3)),
    ]).astype(np.uint8)


RISK_BATCH = np.stack([_rgb(24, 40, 81), _rgb(24, 40, 82)[::-1],
                       np.repeat(_rgb(24, 40, 83)[..., :1], 3, -1)])
FOUR = _four_modes()
FOUR_MODES = [C.YUV_400, C.YUV_420, C.YUV_SHARP, C.YUV_444]
METHOD0 = dict(huffman_compress=False, adaptive_quantization=False)


@pytest.fixture
def exact_table():
    """Both packages' exact sharpness tables on, restored afterwards."""
    before = (riskiness.exact_table_active(), jrisk.exact_table_active())
    riskiness.use_exact_table(True)
    jrisk.use_exact_table(True)
    yield
    riskiness.use_exact_table(before[0])
    jrisk.use_exact_table(before[1])


def test_risk_stats_match_jax():
    got = risk_dev.risk_stats(torch.from_numpy(RISK_BATCH))
    want = jax.device_get(jrisk_dev.risk_stats(jnp.asarray(RISK_BATCH)))
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), wnt)
    modes = risk_dev.batch_riskiness(torch.from_numpy(RISK_BATCH))
    assert modes == [jrisk_dev.finish_riskiness(*(x[i] for x in want), 40, 24)
                     for i in range(3)]
    assert modes == [jrisk.riskiness(im) for im in RISK_BATCH]
    assert (risk_dev.riskiness_device(torch.from_numpy(RISK_BATCH[0]))
            == jrisk_dev.riskiness_device(RISK_BATCH[0]))


def test_host_riskiness_matches_jax():
    for im in RISK_BATCH:
        assert riskiness.riskiness(im) == jrisk.riskiness(im)
        np.testing.assert_array_equal(riskiness.rgb_to_risk_index(im),
                                      jrisk.rgb_to_risk_index(im))
        for y0, x0 in ((0, 0), (16, 32), (8, 13)):
            block = im[y0:y0 + 8, x0:x0 + 8]
            got, want = riskiness.block_riskiness(block), \
                jrisk.block_riskiness(block)
            assert got[0] == want[0]
            np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(riskiness.sharpness_table(),
                                  jrisk.sharpness_table())


def test_exact_table_matches_jax(exact_table):
    np.testing.assert_array_equal(riskiness.sharpness_table(),
                                  jrisk.sharpness_table())
    want = [jrisk.riskiness(im) for im in RISK_BATCH]
    assert [riskiness.riskiness(im) for im in RISK_BATCH] == want
    # AUTO takes its modes from the host scorer while the table is active
    assert engine.auto_modes(torch.from_numpy(RISK_BATCH)) == [
        m for m, _ in want]


@pytest.mark.parametrize("w, h", [(33, 17), (4, 10)])
def test_sharp_planes_match_jax(w, h):
    """33 x 17 runs the sweeps (odd sizes padded); 4 x 10, a side <=
    MIN_DIMENSION, the plain averaging conversion."""
    rgb = _rgb(h, w, 84)
    got = sharp_yuv.sharp_rgb_to_yuv420(torch.from_numpy(rgb)[None])
    want = jsharp.sharp_rgb_to_yuv420_device(rgb)
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(wnt))


def test_sharp_batch_keeps_each_images_sweeps():
    """A batch whose images stop after 2, 3 and 4 sweeps against
    jax.vmap(_sharp_core), whose while_loop freezes each image once its
    own exit test fires."""
    rgb = _sweep_batch(17, 33)
    y, uv, ty, tuv = sharp_yuv.sharp_setup(torch.from_numpy(rgb))
    iters = sharp_yuv.sharp_iterate_plain(y, uv, ty, tuv)
    assert iters.tolist() == [2, 3, 4]
    got = sharp_yuv.sharp_finish(y, uv, 33, 17)
    want = jax.vmap(lambda r: jsharp._sharp_core(r, width=33, height=17))(
        jnp.asarray(rgb))
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))


_HOST_SHIM = """
#define __host__
#define __device__
#include <vector>
#include "sharp_core.cuh"
namespace {
// sharp_core.cuh's Cta policy: the columns one after another, forwards or
// backwards; a row pair's results must not depend on the order.
struct HostCta {
  bool reverse;
  template <class F> void columns(int n, F&& f) {
    for (int i = 0; i < n; ++i) f(reverse ? n - 1 - i : i);
  }
  void sync() {}
  int64_t sum(int64_t v) { return v; }
};
}  // namespace
extern "C" void sharp_images(int32_t* y, int32_t* uv, const int32_t* ty,
                             const int32_t* tuv, const int32_t* g2l,
                             const int32_t* l2g, int32_t* iters, int b,
                             int w, int h, int reverse) {
  std::vector<int32_t> ring(3 * w);
  const int64_t plane = (int64_t)w * h;
  for (int i = 0; i < b; ++i) {
    const sjpeg::SharpImage im{y + i * plane, uv + i * plane / 4 * 3,
                               ty + i * plane, tuv + i * plane / 4 * 3,
                               ring.data(), w, h};
    HostCta cta{reverse != 0};
    iters[i] = sjpeg::sharp_image(cta, sjpeg::SharpTables{g2l, l2g}, im);
  }
}
"""


@pytest.fixture(scope="module")
def sharp_core(tmp_path_factory):
    """csrc/sharp_core.cuh built by the host C++ compiler."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("sharp_core")
    (d / "core.cpp").write_text(_HOST_SHIM)
    lib = d / "libsharp.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    f"-I{REPO / 'sjpeg_tpu_torch' / 'csrc'}", "-o", str(lib),
                    str(d / "core.cpp")], check=True)
    so = ctypes.CDLL(str(lib))
    so.sharp_images.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
    so.sharp_images.restype = None
    return so


@pytest.mark.parametrize("reverse", [0, 1])
@pytest.mark.parametrize("w, h", [(33, 17), (40, 24), (6, 6)])
def test_sharp_core_host_build_matches_plain(sharp_core, w, h, reverse):
    """The kernel's sweep loop, columns in either order: planes and sweep
    counts equal the plain version's."""
    rgb = np.concatenate([_sweep_batch(h, w), _rgb(h, w, 85)[None]])
    y, uv, ty, tuv = sharp_yuv.sharp_setup(torch.from_numpy(rgb))
    want_y, want_uv = y.clone(), uv.clone()
    want_it = sharp_yuv.sharp_iterate_plain(want_y, want_uv, ty, tuv)
    g2l, l2g = sharp_yuv.gamma_tensors(torch.device("cpu"))
    y, uv, it = y.numpy(), uv.numpy(), np.zeros(len(rgb), np.int32)
    sharp_core.sharp_images(
        y.ctypes.data, uv.ctypes.data, ty.numpy().ctypes.data,
        tuv.numpy().ctypes.data, g2l.numpy().ctypes.data,
        l2g.numpy().ctypes.data, it.ctypes.data, len(rgb), y.shape[2],
        y.shape[1], reverse)
    np.testing.assert_array_equal(it, want_it.numpy())
    np.testing.assert_array_equal(y, want_y.numpy())
    np.testing.assert_array_equal(uv, want_uv.numpy())


@pytest.mark.parametrize("method", [4, 0])
def test_auto_batch_matches_jax(method):
    """A batch in which AUTO picks 4:0:0, 4:2:0, sharp and 4:4:4: split per
    mode, results in input order, the JAX engine's bytes."""
    assert engine.auto_modes(torch.from_numpy(FOUR)) == FOUR_MODES
    kw = METHOD0 if method == 0 else {}
    got = engine.encode_batch(FOUR, EncoderParam(**kw), device="cpu")
    assert got == jengine.encode_batch(FOUR, JaxParam(**kw))


@pytest.mark.parametrize("i", range(4))
def test_encode_with_no_param_matches_jax(i):
    """Each image alone through encode_rgb with the default param (AUTO,
    method 4), and through encode(rgb) with no param."""
    want = sjpeg_tpu.encode(FOUR[i])
    assert sjpeg_tpu_torch.encode(FOUR[i], device="cpu") == want
    assert engine.encode_rgb(FOUR[i], EncoderParam(), device="cpu") == \
        jengine.encode_rgb(FOUR[i], JaxParam()) == want
