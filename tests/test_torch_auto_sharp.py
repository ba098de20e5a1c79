"""YUV_AUTO and sharp YUV in the port against the JAX package, on the CPU:
the riskiness scorers (ops/riskiness on tensors, the host scorer, the
block map, the exact table), the sharp conversion's planes and per-image
sweep counts (sharp_yuv's plain version, and the kernel's core,
csrc/sharp_core.cuh, built with g++), and the bytes of a mixed batch in
which AUTO picks all four modes.  4:0:0 needs (w-1)(h-1)/(wh) > 0.995, so
that batch is 408 x 408; everything else uses the tiny geometries of the
other port tests."""

import ctypes
import functools
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
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

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
#include <algorithm>
#include <vector>
#include "sharp_core.cuh"
namespace {
// sharp_core.cuh's Cta policy for all n CTAs of one image at once.  Each
// columns() call runs every CTA's columns, the CTAs in an order that a
// seeded generator scrambles call by call, each CTA's columns forwards or
// backwards.  The barriers are no-ops: each stage of a row pair runs for
// every column before the next stage starts, so a pair's loads run before
// the previous pair's upper stage in every CTA, the earliest the card may
// run them.  Each CTA has its own ring slice, [2][cols + 2][3] with a halo
// cell at either end; put() writes a CTA's first and last columns into
// its neighbours' halo cells, as the card's remote stores do.
struct HostCluster {
  int n, uv_w, cols;
  bool reverse;
  unsigned seed;
  std::vector<std::vector<int32_t>> slices;
  std::vector<sjpeg::SharpColumn> state;
  std::vector<int> order;
  int cta = 0;                              // the CTA whose columns run

  HostCluster(int n_, int uv_w_, bool rev, unsigned s)
      : n(n_), uv_w(uv_w_), cols((uv_w_ + n_ - 1) / n_), reverse(rev),
        seed(s), slices(n_, std::vector<int32_t>(6 * (cols + 2))),
        state(uv_w_), order(n_) {
    for (int i = 0; i < n; ++i) order[i] = i;
  }
  int j0(int r) const { return r * cols; }
  int j1(int r) const { return std::min(uv_w, (r + 1) * cols); }
  int32_t* cell(int r, int slot, int idx) {
    return slices[r].data() + (slot * (cols + 2) + idx) * 3;
  }
  template <class F> void columns(F&& f) {
    for (int i = n - 1; i > 0; --i) {       // Fisher-Yates over an LCG
      seed = seed * 1664525u + 1013904223u;
      std::swap(order[i], order[(seed >> 8) % (i + 1)]);
    }
    for (int r : order) {
      cta = r;
      for (int i = 0; i < j1(r) - j0(r); ++i) {
        const int j = reverse ? j1(r) - 1 - i : j0(r) + i;
        f(j, state[j]);
      }
    }
  }
  void arrive() {}
  void wait() {}
  void sync() {}
  void put(int slot, int j, const int32_t v[3]) {
    std::copy(v, v + 3, cell(cta, slot, j - j0(cta) + 1));
    if (j == j0(cta) && cta > 0) std::copy(v, v + 3, cell(cta - 1, slot,
                                                          cols + 1));
    if (j == j1(cta) - 1 && j + 1 < uv_w)
      std::copy(v, v + 3, cell(cta + 1, slot, 0));
  }
  const int32_t* halo(int slot, int j) {
    return cell(cta, slot, j - j0(cta) + 1);
  }
  int64_t sum(int64_t v) { return v; }
};
}  // namespace
extern "C" void sharp_images(int32_t* y, int32_t* uv, const int32_t* ty,
                             const int32_t* tuv, const int32_t* g2l,
                             const int32_t* l2g, int32_t* iters, int b,
                             int w, int h, int n_ctas, int reverse,
                             unsigned seed) {
  const int64_t plane = (int64_t)w * h;
  for (int i = 0; i < b; ++i) {
    const sjpeg::SharpImage im{y + i * plane, uv + i * plane / 4 * 3,
                               ty + i * plane, tuv + i * plane / 4 * 3, w,
                               h};
    HostCluster cta(n_ctas, w / 2, reverse != 0, seed + i);
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
    so.sharp_images.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                                + [ctypes.c_uint])
    so.sharp_images.restype = None
    return so


# (CTAs, columns backwards): the ids 0 and 1 are one CTA, columns forwards
# and backwards; three CTAs run in a scrambled order, each reading its
# halos from the cells that its neighbours wrote into its ring slice
SCHEDULES = [pytest.param((1, 0), id="0"), pytest.param((1, 1), id="1"),
             pytest.param((3, 0), id="3ctas-scrambled"),
             pytest.param((3, 1), id="3ctas-scrambled-backwards")]


@functools.lru_cache(maxsize=None)
def _sharp_case(w: int, h: int):
    """The set-up planes of four w x h images and the plain version's
    planes and sweep counts, once a size for every schedule."""
    rgb = np.concatenate([_sweep_batch(h, w), _rgb(h, w, 85)[None]])
    y, uv, ty, tuv = sharp_yuv.sharp_setup(torch.from_numpy(rgb))
    want_y, want_uv = y.clone(), uv.clone()
    want_it = sharp_yuv.sharp_iterate_plain(want_y, want_uv, ty, tuv)
    return ((y.numpy(), uv.numpy(), ty.numpy(), tuv.numpy()),
            (want_y.numpy(), want_uv.numpy(), want_it.numpy()))


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("w, h", [(33, 17), (40, 24), (6, 6)])
def test_sharp_core_host_build_matches_plain(sharp_core, w, h, schedule):
    """The kernel's sweep loop over one or three CTAs, in sharp_core.cuh's
    schedule with every pair's loads before the previous pair's upper
    stage: planes and sweep counts equal the plain version's."""
    n_ctas, backwards = schedule
    (y, uv, ty, tuv), (want_y, want_uv, want_it) = _sharp_case(w, h)
    g2l, l2g = sharp_yuv.gamma_tensors(torch.device("cpu"))
    y, uv, it = y.copy(), uv.copy(), np.zeros(len(y), np.int32)
    sharp_core.sharp_images(
        y.ctypes.data, uv.ctypes.data, ty.ctypes.data, tuv.ctypes.data,
        g2l.numpy().ctypes.data, l2g.numpy().ctypes.data, it.ctypes.data,
        len(y), y.shape[2], y.shape[1], n_ctas, backwards, 7 * w + h)
    np.testing.assert_array_equal(it, want_it)
    np.testing.assert_array_equal(y, want_y)
    np.testing.assert_array_equal(uv, want_uv)


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
