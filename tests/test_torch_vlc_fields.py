"""VLC fields and symbol frequencies on the card (csrc/vlc_fields.cu over
csrc/fields_core.cuh).

On the CPU: the kernel's core built with g++ and run as the kernel runs it
(CTAs of 128 rows in turn, each row's levels, coded mask, runs, fields and
counts, the tables of a CTA's first two stats images kept aside and
flushed at its end), bit for bit against the plain chain: the bias
quantizer, vlc.run_levels and vlc.grouped_stats, on edge cases (all-zero
and dense rows, runs of 16, 17, 32 and 47 zeros, position 63 coded, every
DC size, shared and per-image quantizer sets, one and B stats images, a
`valid` mask, images under a CTA's rows) in both of the kernel's forms:
coefficients with quantizer rows, and levels.  On the card (`cuda`): the
kernel against its plain twin in both forms; encode_batch and encode_rgb
bytes against the CPU path's for methods 1, 3, 4 and 7 with the op's
launches; a traced method-4 and method-7 encode_rgb that runs no scan and
no scatter but the histograms'.

Imports no JAX, so the `cuda` tests run where only the port is installed:
    python -m pytest tests/test_torch_vlc_fields.py -m cuda -q
"""

import ctypes
import json
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from sjpeg_tpu_torch import engine, spec
from sjpeg_tpu_torch import constants as C
from sjpeg_tpu_torch.ops import quantize, vlc, vlc_fields
from sjpeg_tpu_torch.params import EncoderParam
from sjpeg_tpu_torch.utils import profiling
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
CTA_ROWS = 128                       # fields_core.cuh kFieldsRows

_HOST_SHIM = """
#define __host__
#define __device__
#include <algorithm>
#include "fields_core.cuh"
// vlc_fields.cu's CTAs in turn, each row as its warp runs it: the levels
// of its 64 zigzag positions, its coded mask, each position's field and
// counts, the EOB and the DC size; the CTA's first kStagedImages stats
// images count aside and are flushed at its end, later rows count in the
// global tables.
extern "C" void fields_rows(const int32_t* rows, const int32_t* dc_codes,
                            const int32_t* group, const uint32_t* iquant,
                            const uint32_t* bias, int q_sets,
                            const uint8_t* valid, int32_t* run,
                            int32_t* size, int32_t* code, int32_t* freq_dc,
                            int32_t* freq_ac, int n, int stats_sets) {
  using namespace sjpeg;
  const int64_t per_set = n / q_sets, per_stats = n / stats_sets;
  for (int64_t n0 = 0; n0 < n; n0 += kFieldsRows) {
    const int n_rows = (int)std::min<int64_t>(kFieldsRows, n - n0);
    const StagedImages staged = staged_images(n0, n_rows, per_stats);
    int32_t s_dc[kStagedImages * kDcTable] = {0};
    int32_t s_ac[kStagedImages * kAcTable] = {0};
    for (int r = 0; r < n_rows; ++r) {
      const int64_t b = n0 + r;
      const int g = group[b] & 1;
      int32_t lv[64];
      uint64_t mask = 0;
      for (int k = 0; k < 64; ++k) {
        const int p = zigzag_raster(k);
        const int64_t q = (b / per_set * 2 + g) * 64 + p;
        lv[k] = iquant ? field_level<true>(rows[b * 64 + p], iquant[q],
                                           bias[q])
                       : field_level<false>(rows[b * 64 + p], 0, 0);
        if (k > 0 && lv[k] != 0) mask |= (uint64_t)1 << k;
      }
      const bool count = freq_ac && (!valid || valid[b]);
      const int64_t img = b / per_stats;
      const int slot = staged.slot(img);
      int32_t* dc = slot >= 0 ? s_dc + slot * kDcTable
                              : freq_dc + img * kDcTable;
      int32_t* ac = (slot >= 0 ? s_ac + slot * kAcTable
                               : freq_ac + img * kAcTable) + g * kAcBins;
      for (int k = 0; k < 64; ++k) {
        const bool coded = (mask >> k) & 1;
        const uint32_t f = coded ? packed_field(lv[k], coded_run(mask, k))
                                 : 0u;
        run[b * 64 + k] = (int32_t)field_run(f);
        size[b * 64 + k] = (int32_t)field_size(f);
        code[b * 64 + k] = (int32_t)field_code(f);
        if (coded && count) {
          ac[ac_symbol(f)] += 1;
          ac[0xF0] += (int32_t)zrl_count(f);
        }
      }
      if (!count) continue;
      if (ends_early(mask)) ac[0] += 1;
      const int bin = dc_bin(g, (uint32_t)dc_codes[b]);
      if (bin >= 0) dc[bin] += 1;
    }
    if (!freq_ac) continue;
    for (int i = 0; i < staged.count * kDcTable; ++i)
      freq_dc[staged.lo * kDcTable + i] += s_dc[i];
    for (int i = 0; i < staged.count * kAcTable; ++i)
      freq_ac[staged.lo * kAcTable + i] += s_ac[i];
  }
}
"""


@pytest.fixture(scope="module")
def fields_core(tmp_path_factory):
    """csrc/fields_core.cuh built by the host C++ compiler."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("fields")
    (d / "fields.cpp").write_text(_HOST_SHIM)
    lib = d / "libfields.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    f"-I{REPO / 'sjpeg_tpu_torch' / 'csrc'}", "-o", str(lib),
                    str(d / "fields.cpp")], check=True)
    so = ctypes.CDLL(str(lib))
    so.fields_rows.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int]
                               + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2)
    so.fields_rows.restype = None
    return so


def run_core(so, rows, dc, group, quant, stats_images, valid):
    """The g++ build's fields and counts, shaped as vlc_fields returns
    them."""
    n = rows.shape[0]
    keep = []

    def ptr(a, dtype):
        if a is None:
            return None
        a = np.ascontiguousarray(a, dtype=dtype)
        keep.append(a)
        return a.ctypes.data

    iq, ib = quant if quant is not None else (None, None)
    fields = np.zeros((3, n, 64), dtype=np.int32)
    fdc = np.zeros((stats_images, 2, 12), dtype=np.int32)
    fac = np.zeros((stats_images, 2, 256), dtype=np.int32)
    q_sets = 1 if iq is None or iq.ndim == 2 else iq.shape[0]
    so.fields_rows(ptr(rows, np.int32), ptr(dc, np.int32),
                   ptr(group, np.int32), ptr(iq, np.uint32),
                   ptr(ib, np.uint32), q_sets, ptr(valid, np.uint8),
                   fields[0].ctypes.data, fields[1].ctypes.data,
                   fields[2].ctypes.data, fdc.ctypes.data, fac.ctypes.data,
                   n, stats_images)
    if stats_images == 1:
        fdc, fac = fdc[0], fac[0]
    return fields, (fdc, fac)


def plain_chain(rows, dc, group, quant, stats_images, valid):
    """The bias quantizer of each row's set, vlc.run_levels and
    vlc.grouped_stats."""
    n = rows.shape[0]
    t = torch.from_numpy(rows)
    if quant is not None:
        iq, ib = (np.asarray(a, np.int64).reshape(-1, 2, 64) for a in quant)
        sets = np.arange(n) // (n // iq.shape[0])
        t = quantize.quantize_values(
            t, torch.from_numpy(iq[sets, group]),
            torch.from_numpy(ib[sets, group])).to(torch.int32)
    rl = vlc.run_levels(t, torch.int32)
    return rl, vlc.grouped_stats(
        rl, torch.from_numpy(dc), torch.from_numpy(group), stats_images,
        None if valid is None else torch.from_numpy(valid))


def _groups(n: int) -> np.ndarray:
    """4:2:0's MCU order: four luma blocks, then Cb and Cr."""
    return (np.arange(n) % 6 >= 4).astype(np.int32)


def _dc_codes(rng, n: int) -> np.ndarray:
    """DC codes (size | suffix << 4) of every size 0-15 with in-range
    suffixes."""
    sizes = rng.randint(0, 16, n)
    suffix = rng.randint(0, 1 << 15, n) & ((1 << sizes) - 1)
    return (sizes | (suffix << 4)).astype(np.int32)


def _matrices(rng, b: int) -> tuple:
    """iquant and bias rows of random finalized matrices (quant 1-255, the
    default bias): [B, 2, 64], or [2, 64] for b == 0."""
    fin = spec.finalize_quant_matrix(
        rng.randint(1, 256, (max(b, 1), 2, 64)), np.ones(64, np.uint8),
        C.DEFAULT_BIAS)
    iq, ib = (fin[k].astype(np.int64) for k in ("iquant", "bias"))
    return (iq[0], ib[0]) if b == 0 else (iq, ib)


def _identity(b: int) -> tuple:
    """Quantizer rows under which a coefficient 16 v + e (0 <= e < 16, the
    sign of v) is the level v: iquant 2^16, bias 0."""
    shape = (2, 64) if b == 0 else (b, 2, 64)
    return np.full(shape, 1 << 16, np.int64), np.zeros(shape, np.int64)


def _as_coeffs(rng, levels: np.ndarray) -> np.ndarray:
    """Coefficients that `_identity` quantizes to `levels`."""
    e = rng.randint(0, 16, levels.shape)
    return np.where(levels < 0, 16 * levels - e, 16 * levels + e)


def _laplace_coeffs(rng, n: int) -> np.ndarray:
    """[n, 64] x16 fDCT-like coefficients in the int16 range, that
    `_matrices`' quantizers code at 0 to ~60% of positions."""
    return np.clip(rng.laplace(0, 1500, (n, 64)), -32767,
                   32767).astype(np.int64)


def _zrl_levels(rng, n: int) -> np.ndarray:
    """Rows whose coded positions follow runs of 16, 17, 32 and 47 zeros,
    from position 1 or from a coded position."""
    lv = np.zeros((n, 64), np.int64)
    zz = np.asarray(C.ZIGZAG)
    for i in range(n):
        run = (16, 17, 32, 47)[i % 4]
        if i // 4 % 2:
            first = rng.randint(1, 63 - run)
            ks = [first, first + run + 1]
        else:
            ks = [run + 1]
        for k in ks:
            lv[i, zz[k]] = rng.choice([-1, 1]) * rng.randint(1, 2048)
    return lv


def _case(name: str):
    """(levels or coefficients [N, 64] raster, dc codes, groups, quantizer
    rows or None, stats images, valid, and for a case of levels the
    generator that `_as_coeffs` draws from, else None)."""
    rng = np.random.RandomState(sum(map(ord, name)))
    b, stats, valid, quant = 1, 1, None, None
    n = 600
    if name == "all_zero":
        lv = np.zeros((n, 64), np.int64)
    elif name == "dense":
        lv = rng.choice([-1, 1], (n, 64)) * rng.randint(1, 2048, (n, 64))
    elif name == "zrl_runs":
        lv = _zrl_levels(rng, n)
    elif name == "last_63":
        lv = rng.randint(-3, 4, (n, 64)) * (rng.rand(n, 64) < 0.1)
        lv[::2, 63] = rng.choice([-5, 5], len(lv[::2]))     # no EOB
        lv[1::2, 63] = 0
        lv[1::4, 62] = 7                                    # EOB after 62
    elif name == "dc_sizes":
        lv = rng.randint(-40, 41, (n, 64)) * (rng.rand(n, 64) < 0.2)
    elif name == "per_image_sets":
        b, n = 3, 3 * 600
        coef = _laplace_coeffs(rng, n)
        return (coef, _dc_codes(rng, n), _groups(n), _matrices(rng, b), 1,
                None, None)
    elif name == "shared_sets_stats_b":
        b, n = 4, 4 * 300
        coef = _laplace_coeffs(rng, n)
        return (coef, _dc_codes(rng, n), _groups(n), _matrices(rng, 0), b,
                None, None)
    elif name == "valid_mask":
        b, stats, n = 2, 2, 2 * 330
        lv = rng.randint(-300, 301, (n, 64)) * (rng.rand(n, 64) < 0.25)
        valid = rng.rand(n) < 0.7
        quant = _identity(b)
    elif name == "tiny_images":            # 11 images of 24 rows a CTA
        b, stats, n = 11, 11, 11 * 24
        lv = rng.randint(-9, 10, (n, 64)) * (rng.rand(n, 64) < 0.3)
        lv[::7, 1:] = 0
        quant = _identity(b)
    else:
        raise KeyError(name)
    return lv.astype(np.int64), _dc_codes(rng, n), _groups(n), quant, \
        stats, valid, rng


CASES = ["all_zero", "dense", "zrl_runs", "last_63", "dc_sizes",
         "per_image_sets", "shared_sets_stats_b", "valid_mask",
         "tiny_images"]


def _forms(name: str) -> list:
    """[(rows, dc, group, quantizer rows or None, stats, valid)]: a case of
    levels in both forms (the levels; coefficients that `_identity`
    quantizes to them), a case of coefficients as it is."""
    rows, dc, group, quant, stats, valid, rng = _case(name)
    if rng is None:
        return [(rows, dc, group, quant, stats, valid)]
    return [(rows, dc, group, None, stats, valid),
            (_as_coeffs(rng, rows), dc, group,
             _identity(0) if quant is None else quant, stats, valid)]


@pytest.mark.parametrize("name", CASES)
def test_fields_core_host_build_matches_plain_chain(fields_core, name):
    """The g++ build of fields_core.cuh, run CTA by CTA as vlc_fields.cu
    runs it, == quantize + vlc.run_levels + vlc.grouped_stats: the fields
    and the counts; and the op's plain twin == the same chain."""
    for rows, dc, group, quant, stats, valid in _forms(name):
        rows = rows.astype(np.int32)
        rl, (wdc, wac) = plain_chain(rows, dc, group, quant, stats, valid)
        fields, (gdc, gac) = run_core(fields_core, rows, dc, group, quant,
                                      stats, valid)
        for i, key in enumerate(("run", "size", "code")):
            np.testing.assert_array_equal(fields[i], rl[key].numpy(),
                                          err_msg=f"{name} {key}")
        np.testing.assert_array_equal(gdc, wdc.numpy(), err_msg=name)
        np.testing.assert_array_equal(gac, wac.numpy(), err_msg=name)
        q = None if quant is None else [torch.from_numpy(
            np.asarray(a, np.int32)) for a in quant]
        twin, freqs = vlc_fields.vlc_fields(
            torch.from_numpy(rows), torch.from_numpy(dc),
            torch.from_numpy(group), *(q or ()), stats_images=stats,
            valid=None if valid is None else torch.from_numpy(valid))
        for key in ("run", "size", "code"):
            assert torch.equal(twin[key], rl[key]), (name, key)
        assert torch.equal(freqs[0], wdc) and torch.equal(freqs[1], wac)


def test_cases_cover_the_edges():
    """The cases hold what their names say: runs of 16, 17, 32 and 47
    zeros, a coded position 63 beside EOB rows, every DC size of both
    groups (the dropped ones included), and images under a CTA's rows,
    more than two of them a CTA."""
    rl, (fdc, fac) = plain_chain(*_case("zrl_runs")[:6])
    assert {16, 17, 32, 47} <= set(rl["run"][rl["size"] > 0].tolist())
    assert int(fac[:, 0xF0].sum()) > 0
    rl, _ = plain_chain(*_case("last_63")[:6])
    assert (rl["last"] == 63).any() and (rl["last"] < 63).any()
    _, dc, group, *_ = _case("dc_sizes")
    assert set(zip(group.tolist(), (dc & 15).tolist())) == {
        (g, s) for g in (0, 1) for s in range(16)}
    lv, *_ = _case("tiny_images")
    per_img = lv.shape[0] // 11
    assert per_img < CTA_ROWS and CTA_ROWS // per_img > 2


def test_vlc_fields_checks_its_inputs():
    """The wrapper refuses what the kernel does not take."""
    n = 12
    rows = torch.zeros((n, 64), dtype=torch.int32)
    dc = torch.zeros(n, dtype=torch.int32)
    g = torch.zeros(n, dtype=torch.int32)
    iq = torch.ones((2, 64), dtype=torch.int32)
    check = vlc_fields._check
    check(rows, dc, g, iq, iq, 3, None)
    with pytest.raises(ValueError, match="together"):
        check(rows, dc, g, iq, None, 1, None)
    with pytest.raises(ValueError, match="quantizer rows"):
        check(rows, dc, g, torch.ones((5, 2, 64), dtype=torch.int32),
              torch.ones((5, 2, 64), dtype=torch.int32), 1, None)
    with pytest.raises(ValueError, match="int32"):
        check(rows.long(), dc, g, None, None, 1, None)
    with pytest.raises(ValueError, match="shape"):
        check(rows, dc[:5], g, None, None, 1, None)
    with pytest.raises(ValueError, match="divide"):
        check(rows, dc, g, None, None, 5, None)
    with pytest.raises(ValueError, match="valid"):
        check(rows, dc, g, None, None, 1, torch.ones(n, dtype=torch.int32))


# ---- on the card -----------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")


def _card_args(rows, dc, group, quant, valid):
    dev = torch.device("cuda")
    q = () if quant is None else tuple(
        torch.from_numpy(np.asarray(a, np.int32)).to(dev) for a in quant)
    return ((torch.from_numpy(rows.astype(np.int32)).to(dev),
             torch.from_numpy(dc).to(dev), torch.from_numpy(group).to(dev))
            + q, None if valid is None else torch.from_numpy(valid).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", ["straddle", "tiny", "aligned"])
@pytest.mark.parametrize("sets", ["shared", "per_image"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("form", ["coefficients", "levels"])
def test_vlc_fields_matches_plain_on_gpu(form, masked, sets, geometry):
    """The kernel == its plain twin: fields and counts, with and without
    counts, where a CTA's 128 rows straddle two images (700 a image), many
    (images of 24 rows) or none (1024), with shared or per-image quantizer
    sets (form a) and stats images, with and without a `valid` mask."""
    _need_cuda()
    b, per = {"straddle": (3, 700), "tiny": (11, 24),
              "aligned": (2, 1024)}[geometry]
    n = b * per
    rng = np.random.RandomState(len(geometry) + 10 * masked)
    lv = rng.randint(-2047, 2048, (n, 64)) * (rng.rand(n, 64) < 0.2)
    lv[::5, 1:] = 0
    lv[1::5, 1:40] = 0
    lv[2::5] = rng.choice([-1, 1], (len(lv[2::5]), 64))
    if form == "coefficients":
        rows = _laplace_coeffs(rng, n)
        rows[::5, 1:] //= 64                    # sparse rows
        quant = _matrices(rng, b if sets == "per_image" else 0)
    else:
        rows, quant = lv, None
    dc = _dc_codes(rng, n)
    group = _groups(n)
    valid = rng.rand(n) < 0.6 if masked else None
    stats = b if sets == "per_image" else 1
    args, v = _card_args(rows, dc, group, quant, valid)
    for with_stats in (True, False):
        got, gf = vlc_fields.vlc_fields(*args, stats_images=stats, valid=v,
                                        with_stats=with_stats)
        want, wf = vlc_fields.vlc_fields_plain(*args, stats_images=stats,
                                               valid=v, with_stats=with_stats)
        for key in ("run", "size", "code"):
            assert torch.equal(got[key], want[key]), key
            assert got[key].data_ptr() % 16 == 0
        if with_stats:
            assert torch.equal(gf[0], wf[0]) and torch.equal(gf[1], wf[1])
        else:
            assert gf is None and wf is None
    torch.cuda.synchronize()


def _photo(h: int, w: int, seed: int) -> np.ndarray:
    yy, xx = np.mgrid[0:h, 0:w]
    noise = np.random.RandomState(seed).randint(-12, 13, (h, w, 3))
    return np.clip(noise + np.stack([xx * 255 // w, yy * 255 // h,
                                     (xx + yy) % 256], -1), 0,
                   255).astype(np.uint8)


@pytest.mark.cuda
@pytest.mark.parametrize("method", [1, 3, 4, 7])
def test_encode_bytes_on_gpu_match_cpu(method):
    """encode_batch (per image and shared statistics) and encode_rgb on
    the card == the CPU path's bytes, with one vlc_fields launch a batch
    and a staged image (none for method 3's single image, which packs
    from the coefficients)."""
    _need_cuda()
    rgb = np.stack([_photo(72, 64, s) for s in range(3)])
    param = EncoderParam(quality=70, huffman_compress=method != 3,
                         adaptive_quantization=method >= 3,
                         use_trellis=method == 7, yuv_mode=C.YUV_420)
    assert param.method == method
    for share in (False, True):
        vlc_fields.vlc_fields.launches = 0
        got = engine.encode_batch(rgb, param, share_statistics=share)
        assert vlc_fields.vlc_fields.launches == 1
        assert got == engine.encode_batch(rgb, param, share_statistics=share,
                                          device="cpu")
    for img in rgb:
        vlc_fields.vlc_fields.launches = 0
        got = engine.encode_rgb(img, param)
        assert vlc_fields.vlc_fields.launches == (0 if method == 3 else 1)
        assert got == engine.encode_rgb(img, param, device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("method", [4, 7])
def test_encode_rgb_runs_no_scan_and_no_stats_scatter(tmp_path, method):
    """A traced method-4 or method-7 encode_rgb: one vlc_fields kernel, no
    torch scan (the cumulative maximum of vlc.run_levels), and no scatter
    kernel but the coefficient histograms' (one a store_histo call).  The
    trace opens with prime_trace: late in a process the profiler can lose
    a session's first device records."""
    _need_cuda()
    from unittest import mock
    from benchmark import tracing
    dev = torch.device("cuda")
    img = _photo(256, 320, 5)
    param = EncoderParam(yuv_mode=C.YUV_420, use_trellis=method == 7)
    assert param.method == method
    engine.encode_rgb(img, param, device=dev)
    with mock.patch.object(quantize, "store_histo",
                           wraps=quantize.store_histo) as histos, \
            profiling.device_trace(str(tmp_path)):
        tracing.prime_trace(dev)
        engine.encode_rgb(img, param, device=dev)
        torch.cuda.synchronize()
    events = json.loads(next(tmp_path.glob("*.pt.trace.json")).read_text())[
        "traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    assert sum("vlc_fields_kernel" in k for k in kernels) == 1
    assert not [k for k in kernels if "at::native" in k and "scan" in k]
    assert (sum("_scatter_gather_elementwise" in k for k in kernels)
            == histos.call_count > 0)
