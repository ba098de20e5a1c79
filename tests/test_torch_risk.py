"""The riskiness reduction behind YUV_AUTO, on the CPU: the kernel's core,
csrc/risk_core.cuh, built with g++, against the port's plain version
(ops/riskiness.risk_stats_plain) and both against the JAX package's
risk_stats, exactly.  The images stay far under the int32 wrap of the JAX
twin's sums; they hold strong chroma edges, the pixel pairs whose score
lies nearest a .5 tie on either side (no two level triples give an exact
one: the nearest is 1,680 / 2e6 away; of the pairs of the 126 triples that
RGB pixels reach, 15,826 under and 6,780 over), and rows and columns of 1,
2 and odd sizes.  The rounding itself is held on exact ties.  Also the
wrapper's checks, which raise."""

import ctypes
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sjpeg_tpu.ops import riskiness as jrisk_dev

from sjpeg_tpu_torch.ops import riskiness as risk_dev
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
DEN = 2 * 100 * 100 * 100

_HOST_SHIM = """
#define __host__
#define __device__
#include "risk_core.cuh"
#include <vector>
// The kernel's table of pair scores, by key.
static const std::vector<int32_t>& table() {
  static std::vector<int32_t> t = [] {
    std::vector<int32_t> v(sjpeg::kRiskKeys);
    for (int k = 0; k < sjpeg::kRiskKeys; ++k) v[k] = sjpeg::risk_key_score(k);
    return v;
  }();
  return t;
}
static int32_t table_score(const sjpeg::RiskLevel& a,
                           const sjpeg::RiskLevel& b) {
  return table()[sjpeg::risk_key(a, b)];
}
// risk_stats over every interior position, the pair scores from the table
// as the kernel looks them up.
extern "C" void risk_images(const uint8_t* rgb, int64_t* out, int b, int h,
                            int w) {
  for (int i = 0; i < b; ++i) {
    const uint8_t* img = rgb + (int64_t)i * h * w * 3;
    auto level = [&](int y, int x) {
      const uint8_t* p = img + ((int64_t)y * w + x) * 3;
      return sjpeg::risk_level(p[0], p[1], p[2]);
    };
    sjpeg::RiskSums s{0, 0, 0};
    for (int y = 0; y + 1 < h; ++y)
      for (int x = 0; x + 1 < w; ++x)
        sjpeg::risk_position(level(y, x), level(y, x + 1), level(y + 1, x),
                             table_score, s);
    out[i * 3] = s.score;
    out[i * 3 + 1] = s.count;
    out[i * 3 + 2] = s.gray;
  }
}
extern "C" void risk_levels(const int32_t* rgb, int32_t* out, int n) {
  for (int i = 0; i < n; ++i) {
    const sjpeg::RiskLevel l =
        sjpeg::risk_level(rgb[3 * i], rgb[3 * i + 1], rgb[3 * i + 2]);
    out[3 * i] = l.y;
    out[3 * i + 1] = l.u;
    out[3 * i + 2] = l.v;
  }
}
extern "C" void risk_rounds(const int32_t* n, int32_t* out, int count) {
  for (int i = 0; i < count; ++i) out[i] = sjpeg::risk_round(n[i]);
}
// The score of each level pair, closed form (table = 0) or by table.
extern "C" void risk_pairs(const int32_t* a, const int32_t* b, int32_t* out,
                           int n, int by_table) {
  for (int i = 0; i < n; ++i) {
    const sjpeg::RiskLevel la{a[3 * i], a[3 * i + 1], a[3 * i + 2]};
    const sjpeg::RiskLevel lb{b[3 * i], b[3 * i + 1], b[3 * i + 2]};
    out[i] = by_table ? table_score(la, lb) : sjpeg::risk_pair(la, lb);
  }
}
"""


@pytest.fixture(scope="module")
def risk_core(tmp_path_factory):
    """csrc/risk_core.cuh built by the host C++ compiler."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("risk_core")
    (d / "core.cpp").write_text(_HOST_SHIM)
    lib = d / "librisk.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    f"-I{REPO / 'sjpeg_tpu_torch' / 'csrc'}", "-o", str(lib),
                    str(d / "core.cpp")], check=True)
    so = ctypes.CDLL(str(lib))
    so.risk_images.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
    so.risk_levels.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int]
    so.risk_pairs.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    so.risk_rounds.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int]
    for fn in (so.risk_images, so.risk_levels, so.risk_pairs,
               so.risk_rounds):
        fn.restype = None
    return so


def _levels_plain(rgb: np.ndarray) -> np.ndarray:
    """[n, 3] RGB -> [n, 3] (y, u, v) levels by the plain version."""
    t = torch.from_numpy(rgb.astype(np.uint8))
    return torch.stack(risk_dev._risk_levels(t), -1).numpy()


def _rgb_of_levels() -> dict:
    """{(y, u, v) level triple: one RGB pixel that has it}, over a grid of
    the RGB cube."""
    grid = np.stack(np.meshgrid(*[np.arange(0, 256, 5)] * 3,
                                indexing="ij"), -1).reshape(-1, 3)
    out = {}
    for px, lv in zip(grid, _levels_plain(grid)):
        out.setdefault(tuple(lv), px)
    return out


def _pair_n(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The score numerator n of level triples a and b, [n, 3] each."""
    vis = np.array(risk_dev._VIS100)
    mask = np.array(risk_dev._MASK100)
    return ((risk_dev._W_DU100 * np.abs(a[:, 1] - b[:, 1])
             + risk_dev._W_DV100 * np.abs(a[:, 2] - b[:, 2]))
            * (vis[a[:, 0]] + vis[b[:, 0]]) * mask[np.abs(a[:, 0] - b[:, 0])])


def _tie_pixels() -> np.ndarray:
    """[n, 2, 3] RGB pixel pairs whose score lies nearest a .5 tie, just
    under it and just over it."""
    px = _rgb_of_levels()
    keys = list(px)
    a = np.array([k for k in keys for _ in keys], np.int64)
    b = np.array([k for _ in keys for k in keys], np.int64)
    off = _pair_n(a, b) % DEN - DEN // 2
    under = np.flatnonzero(off == off[off < 0].max())[:8]
    over = np.flatnonzero(off == off[off > 0].min())[:8]
    pick = np.concatenate([under, over])
    return np.stack([[px[tuple(a[i])], px[tuple(b[i])]] for i in pick])


def _edges(h: int, w: int) -> np.ndarray:
    """Saturated red, green and blue in two-pixel stripes across, and
    white / black rows: strong chroma and luma edges everywhere."""
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.zeros((h, w, 3), np.uint8)
    img[..., 0] = np.where(xx % 6 < 2, 255, 0)
    img[..., 1] = np.where((xx % 6 >= 2) & (xx % 6 < 4), 255, 0)
    img[..., 2] = np.where(xx % 6 >= 4, 255, 0)
    img[yy % 5 == 4] = 255 * (yy[yy % 5 == 4] % 2)[:, None]
    return img


def _ties(h: int, w: int) -> np.ndarray:
    """Tie pairs laid side by side and one above the other."""
    pairs = _tie_pixels()
    img = np.full((h, w, 3), 128, np.uint8)
    for i, (p, q) in enumerate(pairs):
        y, x = (3 * i) // w % (h - 1), (3 * i) % (w - 1)
        img[y, x], img[y, x + 1] = p, q
        img[(y + 1) % h, x] = q
    return img


def _noise(h: int, w: int, seed: int) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(
        np.uint8)


IMAGE_SETS = {
    "edges_ties_noise_13x9": lambda: np.stack(
        [_edges(13, 9), _ties(13, 9), _noise(13, 9, 1)]),
    "ties_24x40": lambda: np.stack([_ties(24, 40), _edges(24, 40)]),
    "one_row_1x7": lambda: np.stack([_edges(1, 7), _noise(1, 7, 2)]),
    "one_column_9x1": lambda: _noise(9, 1, 3)[None],
    "two_by_two": lambda: np.stack([_edges(2, 2), _noise(2, 2, 4)]),
    "two_rows_2x7": lambda: np.stack([_edges(2, 7), _ties(2, 7)]),
    "two_columns_7x2": lambda: np.stack([_noise(7, 2, 5), _edges(7, 2)]),
}


@pytest.mark.parametrize("name", IMAGE_SETS)
def test_risk_core_host_build_matches_plain_and_jax(risk_core, name):
    """risk_core.cuh's walk of every interior position, the pair scores
    from the kernel's table, == risk_stats_plain == the JAX package's
    risk_stats, the three sums of every image."""
    rgb = np.ascontiguousarray(IMAGE_SETS[name]())
    b, h, w = rgb.shape[:3]
    got = np.zeros((b, 3), np.int64)
    risk_core.risk_images(rgb.ctypes.data, got.ctypes.data, b, h, w)
    plain = np.stack([t.numpy() for t in risk_dev.risk_stats_plain(
        torch.from_numpy(rgb))], -1)
    want = np.stack([np.asarray(t) for t in jax.device_get(
        jrisk_dev.risk_stats(jnp.asarray(rgb)))], -1)
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(plain, want)
    wrapped = risk_dev.risk_stats(torch.from_numpy(rgb))
    np.testing.assert_array_equal(np.stack([t.numpy() for t in wrapped], -1),
                                  plain)


def test_near_tie_pairs_sit_on_both_sides_of_half():
    """The image sets' near-tie pairs score 15,826 / 2e6 under and 6,780
    over a .5, and the plain score rounds them down and up."""
    pairs = _tie_pixels()
    la, lb = _levels_plain(pairs[:, 0]), _levels_plain(pairs[:, 1])
    n = _pair_n(la.astype(np.int64), lb.astype(np.int64))
    assert set(n % DEN - DEN // 2) == {-15_826, 6_780}
    score = risk_dev._pair_score(torch.from_numpy(la).unbind(-1),
                                 torch.from_numpy(lb).unbind(-1)).numpy()
    np.testing.assert_array_equal(score, n // DEN + (n % DEN > DEN // 2))


def test_risk_round_core_matches_plain_on_exact_ties(risk_core):
    """The half-to-even rounding on exact ties of odd and even quotients,
    one either side of each, and past the clamp at 255."""
    t = np.arange(0, 300, dtype=np.int64)
    n = np.concatenate([t * DEN + DEN // 2, t * DEN + DEN // 2 - 1,
                        t * DEN + DEN // 2 + 1, t * DEN,
                        [112_798_596, 2**31 - 1]]).astype(np.int32)
    got = np.zeros_like(n)
    risk_core.risk_rounds(n.ctypes.data, got.ctypes.data, len(n))
    want = risk_dev._round_score(torch.from_numpy(n)).numpy()
    np.testing.assert_array_equal(got, want)
    ties = want[:300]
    assert (ties[:255] % 2 == 0).all() and (ties[255:] == 255).all()


def test_risk_levels_core_matches_plain(risk_core):
    """The per-pixel levels of a 32^3 grid over the RGB cube, corners
    included."""
    axis = np.concatenate([np.arange(0, 248, 8), [255]])[:32]
    axis[-1] = 255
    rgb = np.stack(np.meshgrid(axis, axis, axis, indexing="ij"),
                   -1).reshape(-1, 3).astype(np.int32)
    got = np.zeros_like(rgb)
    risk_core.risk_levels(rgb.ctypes.data, got.ctypes.data, len(rgb))
    np.testing.assert_array_equal(got, _levels_plain(rgb))


@pytest.mark.parametrize("by_table", [0, 1])
def test_risk_pair_core_matches_plain_every_level_pair(risk_core, by_table):
    """The pair score of every two level triples (343^2 pairs), closed form
    and from the kernel's 2,401-entry table by risk_key, == the plain
    version's exact rounding."""
    lv = np.stack(np.meshgrid(*[np.arange(7)] * 3, indexing="ij"),
                  -1).reshape(-1, 3).astype(np.int32)
    a = np.ascontiguousarray(np.repeat(lv, len(lv), 0))
    b = np.ascontiguousarray(np.tile(lv, (len(lv), 1)))
    got = np.zeros(len(a), np.int32)
    risk_core.risk_pairs(a.ctypes.data, b.ctypes.data, got.ctypes.data,
                         len(a), by_table)
    want = risk_dev._pair_score(torch.from_numpy(a).unbind(-1),
                                torch.from_numpy(b).unbind(-1)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bad, error", [
    (torch.zeros((2, 4, 4, 3), dtype=torch.int32), TypeError),
    (torch.zeros((2, 4, 4, 4), dtype=torch.uint8), ValueError),
    (torch.zeros((4, 3), dtype=torch.uint8), ValueError),
    (torch.zeros((2, 4, 4, 3), dtype=torch.uint8, device="meta"),
     ValueError),
])
def test_risk_stats_wrapper_checks_raise(bad, error):
    """Wrong dtype, channel count, rank or device raise before any
    kernel or plain version runs."""
    with pytest.raises(error):
        risk_dev.risk_stats(bad)
