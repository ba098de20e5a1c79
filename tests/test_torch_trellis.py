"""The port's method-7 (trellis) slice against the JAX package, exactly
(tolerance 0: integer codec): the plain lattice against
trellis_quantize_blocks_jax, the wrapper against trellis_quantize_matrices
(shared and per-image matrices and rate tables), csrc/trellis_core.cuh
built with the host compiler against the plain version on blocks built to
tie, the engine's trellis stage, and encode_batch's bytes.  The CUDA
launches themselves are tested in test_torch_cuda.py."""

import ctypes
import shutil
import subprocess
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sjpeg_tpu import engine as jengine
from sjpeg_tpu import spec as jspec
from sjpeg_tpu.ops import trellis as jtr
from sjpeg_tpu.params import EncoderParam as JaxParam

from sjpeg_tpu_torch import constants as C
from sjpeg_tpu_torch import engine, huffman
from sjpeg_tpu_torch.ops import trellis
from sjpeg_tpu_torch.params import EncoderParam
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
SHAPE = (2, 40, 24)          # (batch, height, width): not a multiple of 16
NB = {C.YUV_420: (4, 1, 1), C.YUV_444: (1, 1, 1), C.YUV_400: (1,)}


def _qms(quality):
    p = JaxParam(quality=quality)
    qm, mq = p.resolved_quant_matrices(), p.resolved_min_quant_matrices()
    return [jspec.finalize_quant_matrix(qm[g], mq[g], p.quantization_bias)
            for g in range(2)]


def _mats(qualities):
    """(iquant, bias, quant) int32 matrices: [2, 64] for one quality,
    [B, 2, 64] for a list."""
    sets = [_qms(q) for q in qualities]
    out = [np.stack([[qms[g][k] for g in range(2)] for qms in sets])
           .astype(np.int32) for k in ("iquant", "bias", "quant")]
    return [m[0] for m in out] if len(qualities) == 1 else out


def _rates(n_sets):
    """[2, 256] K.3 AC code lengths, or [3, 2, 256] per-image lengths: the
    K.3 set, its groups swapped, and every length one longer."""
    lens = np.array(huffman.trellis_cost_lens())         # writable copy
    if n_sets == 1:
        return lens
    return np.stack([lens, lens[::-1], np.minimum(lens + 1, 16)]).astype(
        np.int32)


def _blocks(rng, n):
    """[n, 64] int32 coefficients (x16) with rows built to tie: random
    sparse rows, full-range rows (+-16384), zero rows, flat rows, equal
    magnitudes with random signs, lone far coefficients (runs past 16) and
    DC-only rows."""
    c = (rng.randint(-40, 40, (n, 64))
         * rng.choice([0, 1, 1, 1, 16, 64], (n, 64))).astype(np.int32)
    k = n // 8
    c[:k] = rng.randint(-16384, 16385, (k, 64))
    c[k] = 16384
    c[k + 1] = -16384
    c[k + 2:k + 4] = 0
    flat = np.repeat(rng.choice([8, 16, 40, 100, 160, 400], k)[:, None], 64,
                     axis=1)
    c[2 * k:3 * k] = flat
    c[3 * k:4 * k] = flat * rng.choice([-1, 1], (k, 64))
    c[4 * k:5 * k] = 0
    far = rng.randint(20, 64, k)
    c[4 * k + np.arange(k), far] = rng.choice([-900, -90, 90, 900], k)
    c[5 * k:5 * k + k // 4, 1:] = 0
    return c


def _port(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def test_trellis_cost_lens_match_jax():
    np.testing.assert_array_equal(huffman.trellis_cost_lens(),
                                  np.asarray(jengine._trellis_cost_lens()))


def test_rows_and_rate_table_match_jax():
    rng = np.random.RandomState(30)
    group = rng.randint(0, 2, 96).astype(np.int32)
    img = torch.arange(96) // 32
    for m in (_mats([75])[2], _mats([30, 75, 95])[2]):
        np.testing.assert_array_equal(
            trellis.rows_from_mats(*_port(m, group), img).numpy(),
            np.asarray(jtr._rows_from_mats(jnp.asarray(m),
                                           jnp.asarray(group), 3)))
    lens = _rates(1)
    np.testing.assert_array_equal(
        trellis.ac_len_table(*_port(lens, group), img).numpy(),
        np.asarray(jtr.ac_len_table(jnp.asarray(lens), jnp.asarray(group))))


@pytest.mark.parametrize("quality", [25, 75, 92, 100])
def test_plain_matches_jax_lattice(quality):
    """trellis_quantize_plain == trellis_quantize_blocks_jax on 96 blocks
    of both groups; q100 (quant 1) puts the +-16384 rows at 11-bit
    levels, the largest the rate table's sizes cover."""
    rng = np.random.RandomState(31)
    n = 96
    coeffs = _blocks(rng, n)
    group = rng.randint(0, 2, n).astype(np.int32)
    iq, ib, qq = _mats([quality])
    rows = [np.where(group[:, None] == 0, m[0], m[1]) for m in (iq, ib, qq)]
    want = np.asarray(jtr.trellis_quantize_blocks_jax(
        jnp.asarray(coeffs), *(jnp.asarray(r) for r in rows),
        jtr.ac_len_table(jnp.asarray(_rates(1)), jnp.asarray(group))))
    got = trellis.trellis_quantize_plain(*_port(coeffs, iq, ib, qq, group,
                                                _rates(1)))
    np.testing.assert_array_equal(got.numpy(), want)
    if quality == 100:
        assert np.abs(want[:, 1:]).max() >= 1024


@pytest.mark.parametrize("per_image_rates", [False, True])
@pytest.mark.parametrize("per_image_mats", [False, True])
def test_wrapper_matches_jax_matrices(per_image_mats, per_image_rates):
    """trellis_quantize on CPU tensors == trellis_quantize_matrices (CPU
    backend) over 3 images of 32 blocks, with [2, 64] or [3, 2, 64]
    matrices and [2, 256] or [3, 2, 256] rate tables."""
    rng = np.random.RandomState(32)
    n, b = 96, 3
    coeffs = _blocks(rng, n)
    group = (np.arange(n) % 6 >= 4).astype(np.int32)
    mats = _mats([30, 75, 95] if per_image_mats else [75])
    lens = _rates(b if per_image_rates else 1)
    want = np.asarray(jtr.trellis_quantize_matrices(
        jnp.asarray(coeffs), *(jnp.asarray(m) for m in mats),
        jnp.asarray(group), jnp.asarray(lens), b))
    got = trellis.trellis_quantize(*_port(coeffs, *mats, group, lens),
                                   n_images=b)
    np.testing.assert_array_equal(got.numpy(), want)


_HOST_SHIM = """
#define __host__
#define __device__
#include <algorithm>
#include <vector>
#include "trellis_core.cuh"
extern "C" long long trellis_blocks(
    const int32_t* x, const int32_t* group, const int32_t* iq,
    const int32_t* ib, const int32_t* qq, const int32_t* lt, int32_t* out,
    int n, int per_img, int mat_sets, int lt_sets) {
  const int zz[64] = SJPEG_ZIGZAG;
  long long evaluated = 0;
  for (int b = 0; b < n; ++b) {
    const int g = group[b] & 1;
    const int m = (mat_sets > 1 ? b / per_img : 0) * 128 + 64 * g;
    const int l = (lt_sets > 1 ? b / per_img : 0) * 512 + 256 * g;
    evaluated += sjpeg::trellis_search(x + 64 * b, zz, iq + m, ib + m,
                                       qq + m, lt + l, out + 64 * b);
  }
  return evaluated;
}
// As csrc/trellis.cu's op: the work pass over chunks of `chunk` rows
// (each row's class and rank among its chunk's rows of that class, which
// the kernel gets from a warp match and the warps' prefix; the chunks'
// class histograms, class-major; the DC-only rows of class 0 written), the
// class starts (a class's chunks split among `threads` threads as the
// scan kernel splits them: rank_total over each thread's chunks, then
// rank_starts from the earlier threads' sum), the scatter of each row of
// class c > 0 after every heavier class's rows, then the search of those
// rows in ranked order, CTAs of 128 rows: the sets of each CTA's first and
// last rows' images copied as the kernel stages them, other images' read
// in place.  info: [rows placed (class > 0), rows that read a set in
// place, rows the work pass wrote].
extern "C" void trellis_ranked(
    const int32_t* x, const int32_t* group, const int32_t* iq,
    const int32_t* ib, const int32_t* qq, const int32_t* lt, int32_t* out,
    uint8_t* cls, int32_t* order, int* info, int n, int per_img,
    int mat_sets, int lt_sets, int chunk, int threads) {
  const int zz[64] = SJPEG_ZIGZAG;
  const int nc = (n + chunk - 1) / chunk, nk = sjpeg::kTrellisClasses;
  std::vector<int32_t> hist(nk * nc, 0), starts(nk * nc, -1), rank(n);
  info[2] = 0;
  for (int b = 0; b < n; ++b) {
    const int m = (mat_sets > 1 ? b / per_img : 0) * 128 + 64 * (group[b] & 1);
    cls[b] = (uint8_t)sjpeg::trellis_class(x + 64 * b, iq + m, ib + m);
    rank[b] = hist[cls[b] * nc + b / chunk]++;
    if (cls[b] == 0) {
      alignas(16) int32_t row[64];
      sjpeg::trellis_dc_row(x[64 * b], iq[m], ib[m], row);
      for (int k = 0; k < 64; ++k) out[64 * b + k] = row[k];
      ++info[2];
    }
  }
  const int per = (nc + threads - 1) / threads;
  std::vector<int64_t> total(nk, 0);
  for (int c = 0; c < nk; ++c) {
    const int32_t* h = hist.data() + c * nc;
    for (int t = 0; t < threads; ++t) {
      const int j0 = std::min(nc, t * per), j1 = std::min(nc, j0 + per);
      const int64_t sum = sjpeg::rank_total(h, j0, j1);
      sjpeg::rank_starts(h, j0, j1, total[c], starts.data() + c * nc);
      total[c] += sum;
    }
  }
  std::vector<int64_t> at(nk, 0);
  for (int c = 0; c < nk; ++c)
    for (int h = c + 1; h < nk; ++h) at[c] += total[h];
  info[0] = (int)at[0];
  for (int b = 0; b < n; ++b)
    if (cls[b])
      order[at[cls[b]] + starts[cls[b] * nc + b / chunk] + rank[b]] = b;
  info[1] = 0;
  for (int n0 = 0; n0 < info[0]; n0 += 128) {
    const int rows = info[0] - n0 < 128 ? info[0] - n0 : 128;
    const int first = order[n0] / per_img;
    const int last = order[n0 + rows - 1] / per_img;
    const sjpeg::TrellisSlots ms(mat_sets, first, last);
    const sjpeg::TrellisSlots ls(lt_sets, first, last);
    std::vector<int32_t> s_iq(256), s_ib(256), s_qq(256), s_lt(1024);
    for (int i = 0; i < ms.count * 128; ++i) {
      const int src = ms.set[i / 128] * 128 + i % 128;
      s_iq[i] = iq[src];
      s_ib[i] = ib[src];
      s_qq[i] = qq[src];
    }
    for (int i = 0; i < ls.count * 512; ++i)
      s_lt[i] = lt[ls.set[i / 512] * 512 + i % 512];
    for (int t = 0; t < rows; ++t) {
      const int b = order[n0 + t], g = group[b] & 1;
      const int mset = mat_sets > 1 ? b / per_img : 0;
      const int lset = lt_sets > 1 ? b / per_img : 0;
      const int mk = ms.slot(mset), lk = ls.slot(lset);
      info[1] += mk < 0 || lk < 0;
      const int32_t* m_iq = mk >= 0 ? &s_iq[mk * 128] : iq + mset * 128;
      const int32_t* m_ib = mk >= 0 ? &s_ib[mk * 128] : ib + mset * 128;
      const int32_t* m_qq = mk >= 0 ? &s_qq[mk * 128] : qq + mset * 128;
      const int32_t* l_lt = lk >= 0 ? &s_lt[lk * 512] : lt + lset * 512;
      alignas(16) int32_t row[64];
      for (int k = 0; k < 64; ++k) row[k] = x[64 * b + k];
      sjpeg::trellis_search(row, zz, m_iq + 64 * g, m_ib + 64 * g,
                            m_qq + 64 * g, l_lt + 256 * g, row);
      for (int k = 0; k < 64; ++k) out[64 * b + k] = row[k];
    }
  }
}
"""


@pytest.fixture(scope="module")
def host_trellis(tmp_path_factory):
    """csrc/trellis_core.cuh built by the host C++ compiler."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("trellis")
    (d / "core.cpp").write_text(_HOST_SHIM)
    lib = d / "libtrellis.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    f"-I{REPO / 'sjpeg_tpu_torch' / 'csrc'}", "-o", str(lib),
                    str(d / "core.cpp")], check=True)
    so = ctypes.CDLL(str(lib))
    so.trellis_blocks.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
    so.trellis_blocks.restype = ctypes.c_longlong
    so.trellis_ranked.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
    so.trellis_ranked.restype = None
    return so


@pytest.mark.parametrize("mat_sets,lt_sets", [(1, 1), (3, 1), (1, 3),
                                              (3, 3)])
def test_trellis_core_host_build_matches_plain(host_trellis, mat_sets,
                                               lt_sets):
    """The kernel's per-block node search == the plain lattice on 3 x 700
    blocks built to tie, with shared or per-image matrices and rate
    tables; its count of evaluated scores == search_evaluations'."""
    rng = np.random.RandomState(33)
    b, per_img = 3, 700
    n = b * per_img
    coeffs = _blocks(rng, n)
    group = (np.arange(n) % 6 >= 4).astype(np.int32)
    mats = _mats([30, 75, 100] if mat_sets > 1 else [75])
    lens = _rates(lt_sets)
    args = _port(coeffs, *mats, group, lens)
    want = trellis.trellis_quantize_plain(*args, n_images=b)

    out = np.zeros((n, 64), np.int32)
    host = [np.ascontiguousarray(a) for a in (coeffs, group, *mats, lens)]
    evaluated = host_trellis.trellis_blocks(
        *(a.ctypes.data for a in host), out.ctypes.data, n, per_img,
        mat_sets, lt_sets)
    np.testing.assert_array_equal(out, want.numpy())
    cinter, iq, ib, _, grp, _ = args
    assert evaluated == trellis.search_evaluations(cinter, iq, ib, grp, b)


def _ranked(host_trellis, coeffs, group, mats, lens, per_img, chunk=256,
            threads=256):
    """The host build of the op, in chunks of `chunk` rows, `threads` scan
    threads a class (the kernels' 256 and 256 by default): levels, classes,
    order (-1 past the rows placed) and info."""
    n = coeffs.shape[0]
    out = np.zeros((n, 64), np.int32)
    cls = np.zeros(n, np.uint8)
    order = np.full(n, -1, np.int32)
    info = np.zeros(3, np.int32)
    host = [np.ascontiguousarray(a) for a in (coeffs, group, *mats, lens)]
    host_trellis.trellis_ranked(
        *(a.ctypes.data for a in host), out.ctypes.data, cls.ctypes.data,
        order.ctypes.data, info.ctypes.data, n, per_img,
        1 if mats[0].ndim == 2 else mats[0].shape[0],
        1 if lens.ndim == 2 else lens.shape[0], chunk, threads)
    return out, cls, order, info


def _ranked_case(rng, b, per_img):
    """b images of per_img blocks built to tie (_blocks), a fifth of them
    all-zero and a tenth DC-only, in runs long enough to fill whole search
    CTAs with class-0 rows."""
    n = b * per_img
    coeffs = _blocks(rng, n)
    zero = rng.rand(n) < 0.2
    zero[n // 3:n // 3 + 300] = True
    coeffs[zero] = 0
    coeffs[rng.rand(n) < 0.1, 1:] = 0
    group = (np.arange(n) % 6 >= 4).astype(np.int32)
    return coeffs, group


@pytest.mark.parametrize("per_image", [False, True])
@pytest.mark.parametrize("chunk,threads", [(256, 256), (16, 8)])
def test_trellis_ranking_host_build_is_stable_heaviest_first(
        host_trellis, chunk, threads, per_image):
    """The op's work pass, class starts and scatter (trellis_class,
    rank_total, rank_starts) on 3 x 700 blocks, in the kernels' chunks of
    256 rows with 256 scan threads, or in chunks of 16 with 8 (132
    chunks: 17 a thread, the last thread's short): each block's class is
    its count of nonzero bias-quantized AC values (the plain quantizer's,
    with shared or per-image matrices), and the order holds the rows of
    classes above 0 by class, heaviest first, row order kept within a
    class (stable, so deterministic), as many as the op says; class 0's
    rows are not placed."""
    rng = np.random.RandomState(36)
    b, per_img = 3, 700
    coeffs, group = _ranked_case(rng, b, per_img)
    mats = _mats([30, 75, 100] if per_image else [75])
    _, cls, order, info = _ranked(host_trellis, coeffs, group, mats,
                                  _rates(1), per_img, chunk, threads)
    cinter, iq, ib, _, grp = _port(coeffs, *mats, group)
    img = torch.arange(len(coeffs)) // per_img
    iqr, ibr = (trellis.rows_from_mats(m, grp, img) for m in (iq, ib))
    v0 = trellis._bias_quantized(cinter.to(torch.int64).abs(), iqr, ibr)
    want = (v0[:, 1:] > 0).sum(1).numpy()
    np.testing.assert_array_equal(cls, want)
    placed = int((want > 0).sum())
    assert info[0] == placed and (want == 0).sum() >= 128
    np.testing.assert_array_equal(
        order[:placed], np.lexsort((np.arange(len(cls)), -want))[:placed])
    assert (order[placed:] == -1).all()
    assert len(set(want)) > 10


@pytest.mark.parametrize("per_img", [700, 20])
@pytest.mark.parametrize("mat_sets,lt_sets", [(1, 1), (3, 1), (1, 3),
                                              (3, 3)])
def test_trellis_ranked_search_host_build_matches_plain(host_trellis,
                                                       mat_sets, lt_sets,
                                                       per_img):
    """The op as the kernels run it, built with the host compiler (work
    pass, class starts, ranking, then trellis_search over CTAs of 128
    ranked rows with the sets of each CTA's first and last rows' images
    staged), scattered back to row order == trellis_quantize_plain: shared
    or per-image matrices and rate tables, images of 700 blocks or of 20
    (under 128, so that CTAs read sets in place), and all-zero and DC-only
    blocks written by the work pass without a search."""
    rng = np.random.RandomState(37)
    b = 2100 // per_img
    coeffs, group = _ranked_case(rng, b, per_img)
    qual = [30, 75, 100] * (b // 3)
    mats = _mats(qual if mat_sets > 1 else [75])
    lens = _rates(1)
    if lt_sets > 1:
        lens = np.stack([_rates(3)[i % 3] for i in range(b)])
    want = trellis.trellis_quantize_plain(
        *_port(coeffs, *mats, group, lens), n_images=b)
    out, _, _, info = _ranked(host_trellis, coeffs, group, mats, lens,
                              per_img)
    np.testing.assert_array_equal(out, want.numpy())
    assert info[2] == len(coeffs) - info[0] >= 128   # the work pass's rows
    if per_img == 20 and (mat_sets > 1 or lt_sets > 1):
        assert info[1] > 0                    # sets read in place
    if mat_sets == 1 and lt_sets == 1:
        assert info[1] == 0


def _coeffs(rng, mode, b, n_mcu):
    """Per-component [B * n_mcu * nb, 64] int32 coefficients, image-major
    and in MCU order."""
    return [_blocks(rng, b * n_mcu * nb) for nb in NB[mode]]


@pytest.mark.parametrize("share", [False, True])
def test_stage_quantize_trellis_matches_jax(share):
    """_stage_quantize_trellis == the JAX stage: VLC fields, DC codes,
    groups, and per-image or shared frequencies, over 3 images of 20
    MCUs at 4:2:0."""
    rng = np.random.RandomState(34)
    b, n_mcu = 3, 20
    coeffs = _coeffs(rng, C.YUV_420, b, n_mcu)
    iq, ib, qq = _mats([75] if share else [30, 75, 95])
    lens = _rates(1)
    (jrl, jdc, jgroup), jfreqs = jengine._stage_quantize_trellis(
        [jnp.asarray(c) for c in coeffs], *(jnp.asarray(m)
                                            for m in (iq, ib, qq)),
        jnp.asarray(lens), with_stats=True, nb_blocks=NB[C.YUV_420],
        n_images=b, per_image_stats=not share)
    (rl, dc, group), freqs = engine._stage_quantize_trellis(
        _port(*coeffs), *_port(iq, ib, qq, lens), True, NB[C.YUV_420], b,
        1 if share else b)
    np.testing.assert_array_equal(dc.numpy(), np.asarray(jdc))
    np.testing.assert_array_equal(group.numpy(), np.asarray(jgroup))
    for k in ("nz", "run", "size", "code", "last"):
        np.testing.assert_array_equal(rl[k].numpy(), np.asarray(jrl[k]),
                                      err_msg=k)
    for f, jf in zip(freqs, jfreqs):
        np.testing.assert_array_equal(f.numpy(), np.asarray(jf))


def _params(**kw):
    kw = dict(use_trellis=True, **kw)
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
def test_method7_matches_jax(share):
    """Method 7 at 4:2:0, per-image and shared statistics."""
    jp, tp = _params(yuv_mode=C.YUV_420)
    assert tp.method == 7
    rgb = _rgb(51, *SHAPE)
    with mock.patch.object(trellis, "trellis_quantize",
                           wraps=trellis.trellis_quantize) as spy:
        got = engine.encode_batch(rgb, tp, share_statistics=share,
                                  device="cpu")
    assert spy.call_count == 1
    _same(got, jengine.encode_batch(rgb, jp, share_statistics=share))


@pytest.mark.parametrize("mode", [C.YUV_444, C.YUV_400])
def test_method7_modes_match_jax(mode):
    jp, tp = _params(yuv_mode=mode)
    rgb = _rgb(52, *SHAPE)
    _same(engine.encode_batch(rgb, tp, device="cpu"),
          jengine.encode_batch(rgb, jp))


def test_method7_yuv_matches_jax():
    b, h, w = SHAPE
    rng = np.random.RandomState(53)
    y = rng.randint(0, 256, (b, h, w)).astype(np.uint8)
    u, v = (rng.randint(0, 256, (b, (h + 1) // 2, (w + 1) // 2)).astype(
        np.uint8) for _ in range(2))
    jp, tp = _params(quality=90)
    _same(engine.encode_batch_yuv(y, u, v, True, tp, device="cpu"),
          jengine.encode_batch_yuv(y, u, v, True, jp))


def test_method7_gray_matches_jax():
    y = np.random.RandomState(54).randint(0, 256, SHAPE).astype(np.uint8)
    jp, tp = _params(quality=60)
    _same(engine.encode_batch_gray(torch.from_numpy(y), tp, device="cpu"),
          jengine.encode_batch_gray(y, jp))


def test_method7_nv12_matches_jax():
    b, h, w = SHAPE
    rng = np.random.RandomState(55)
    y = rng.randint(0, 256, (b, h, w)).astype(np.uint8)
    uv = rng.randint(0, 256, (b, (h + 1) // 2, (w + 1) // 2, 2)).astype(
        np.uint8)
    jp, tp = _params(quality=40)
    _same(engine.encode_batch_nv12(y, uv, tp, device="cpu"),
          jengine.encode_batch_nv12(y, uv, jp))


def test_method7_bucket_overflow_repacks_byte_identical():
    """A uniform-noise 256 x 256 image at q95 overflows the 4,096-word
    minimum bucket; the port re-packs that image's trellis fields with its
    own tables and must match the JAX engine."""
    b, h, w = 2, 256, 256
    rgb = np.empty((b, h, w, 3), np.uint8)
    rgb[0] = np.random.RandomState(56).randint(0, 256, (h, w, 3))
    rgb[1] = _rgb(57, 1, h, w)[0]
    jp, tp = _params(quality=95, yuv_mode=C.YUV_420)
    with mock.patch.object(engine, "_repack_one",
                           wraps=engine._repack_one) as spy:
        got = engine.encode_batch(rgb, tp, 0.0, device="cpu")
    assert [c.args[3] for c in spy.call_args_list] == [0]   # image 0 only
    _same(got, jengine.encode_batch(rgb, jp, bits_per_pixel_budget=0.0))
