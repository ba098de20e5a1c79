"""The lambda fit on the card (csrc/lambda_fit.cu over csrc/fit_core.cuh).

On the CPU: the kernel's core built with g++ and run as the kernel runs it
(a host loop over a CTA's steps), bit for bit against the host route,
adaptive.analyse_histo + spec.finalize_quant_matrix, on edge cases (empty
and one-bin histograms, counts whose error sums round in float32, the
density and correlation tests at their edges, lambda clamped and left at
its default, matrices of 1 and 255, min_quant clamps, qdelta_max 1 and
12) and seeded random histograms; the wrapper's checks; the host route
(`lambda_fit` on CPU histograms, `lambda_fit_plain`, the search's
per-image fit) against analyse_histo; the engine's matrices rebuilt from
card-shaped rows.  On the card (`cuda`): the kernel
against the host route, per image and shared, with one and two groups;
encode_batch's bytes against the CPU path's for methods 1, 3, 4 and 7 under
AUTO; one launch a sub-batch; no histogram fetch ahead of the quantizer.

Imports no JAX, so the `cuda` tests run where only the port is installed:
    python -m pytest tests/test_torch_lambda_fit.py -m cuda -q
"""

import ctypes
import json
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import tracing
from sjpeg_tpu_torch import adaptive, engine, spec
from sjpeg_tpu_torch import constants as C
from sjpeg_tpu_torch.ops import lambda_fit
from sjpeg_tpu_torch.params import EncoderParam
from sjpeg_tpu_torch.utils import profiling
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
BINS = C.MAX_HISTO_DCT_COEFF

_HOST_SHIM = """
#include "fit_core.cuh"
// One (image, group) as lambda_fit.cu's CTA runs it, step by step: the
// density statistics, the bin sums of every (position, delta) pair up to
// the position's last non-empty bin, the recurrences, num and den in
// position order, lambda, each position's delta and its rows.  A group
// that is not tuned finalizes its matrix.  out: [3][64] iquant, bias,
// quant; *lam_out: lambda (0 when not tuned).
extern "C" void fit_rows(const int32_t* histo, const int32_t* quant,
                         const int32_t* min_quant, const double* weight,
                         int qdelta_max, int q_bias, int tuned,
                         int32_t* out, double* lam_out) {
  int q[64];
  for (int p = 0; p < 64; ++p) q[p] = quant[p];
  *lam_out = 0.0;
  if (tuned) {
    int last[64];
    bool omit[64];
    int64_t bsum[64][sjpeg::kFitDeltas], dsum[64][sjpeg::kFitDeltas];
    for (int p = 0; p < 64; ++p) {
      int64_t total;
      sjpeg::fit_density(histo + p * sjpeg::kFitBins, &last[p], &total);
      omit[p] = sjpeg::fit_omitted(p, last[p], total);
    }
    for (int k = 0; k < 64 * sjpeg::kFitDeltas; ++k) {
      const int p = k / sjpeg::kFitDeltas, d = k % sjpeg::kFitDeltas;
      const int dq = quant[p] + d + sjpeg::kFitDeltaMin;
      bsum[p][d] = dsum[p][d] = 0;
      if (sjpeg::fit_valid(dq, min_quant[p]))
        sjpeg::fit_bin_sums(histo + p * sjpeg::kFitBins, last[p], dq,
                            &bsum[p][d], &dsum[p][d]);
    }
    double cov[64], den[64];
    for (int p = 0; p < 64; ++p) {
      const sjpeg::FitTerms t = sjpeg::fit_terms(bsum[p], dsum[p], quant[p],
                                                 min_quant[p], weight);
      cov[p] = t.cov;
      den[p] = t.den;
      omit[p] = omit[p] || t.poor;
    }
    const double lam = sjpeg::fit_lambda(cov, den, omit);
    *lam_out = lam;
    const int delta_max = qdelta_max - sjpeg::kFitDeltaMin;
    for (int p = 0; p < 64; ++p)
      q[p] = sjpeg::fit_best_quant(bsum[p], dsum[p], quant[p], min_quant[p],
                                   delta_max, lam, omit[p]);
  }
  for (int p = 0; p < 64; ++p) {
    const sjpeg::FitRow r = sjpeg::fit_finalize(q[p], min_quant[p], p, q_bias);
    out[p] = r.iquant;
    out[64 + p] = r.bias;
    out[128 + p] = r.quant;
  }
}
"""


@pytest.fixture(scope="module")
def fit_core(tmp_path_factory):
    """csrc/fit_core.cuh built by the host C++ compiler, with no
    contraction of float64 products into FMAs."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("fit")
    (d / "fit.cpp").write_text(_HOST_SHIM)
    lib = d / "libfit.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC",
                    "-ffp-contract=off",
                    f"-I{REPO / 'sjpeg_tpu_torch' / 'csrc'}", "-o", str(lib),
                    str(d / "fit.cpp")], check=True)
    so = ctypes.CDLL(str(lib))
    so.fit_rows.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p] * 2
    so.fit_rows.restype = None
    return so


def run_core(so, histo, quant, min_quant, qdelta_max, q_bias, tuned=True):
    """The g++ build's (iquant, bias, quant) rows and lambda."""
    h = np.ascontiguousarray(histo, dtype=np.int32)
    q = np.ascontiguousarray(quant, dtype=np.int32)
    m = np.ascontiguousarray(min_quant, dtype=np.int32)
    w = np.ascontiguousarray(C.HISTO_WEIGHT, dtype=np.float64)
    out = np.zeros((3, 64), dtype=np.int32)
    lam = ctypes.c_double()
    so.fit_rows(h.ctypes.data, q.ctypes.data, m.ctypes.data, w.ctypes.data,
                qdelta_max, q_bias, int(tuned), out.ctypes.data,
                ctypes.byref(lam))
    return out, lam.value


def host_route(histo, quant, min_quant, qdelta_max, q_bias, tuned=True,
               modules=(adaptive, spec)):
    """analyse_histo (when tuned) + finalize_quant_matrix of `modules`
    (the port's adaptive and spec by default) -> [3, 64] iquant, bias,
    quant."""
    fit, fin_mod = modules
    q = np.asarray(quant, dtype=np.uint8)
    if tuned:
        q = fit.analyse_histo(np.asarray(histo), q,
                              np.asarray(min_quant, dtype=np.uint8),
                              qdelta_max)
    fin = fin_mod.finalize_quant_matrix(q, np.asarray(min_quant), q_bias)
    return np.stack([fin["iquant"], fin["bias"], fin["quant"]]).astype(
        np.int32)


def _base(quality=75, group=0):
    """The finalized matrix of a quality, as the engine hands it over."""
    return engine._quant_matrices(EncoderParam(quality=quality))[group][
        "quant"]


def _photo_histo(rng, scale=1.0, decay=0.35):
    """A photo-like histogram: per position, counts falling off with the
    bin, faster at higher frequencies."""
    p = np.arange(64)[:, None]
    b = np.arange(BINS)[None, :]
    lam = decay * (1 + (p % 8 + p // 8) / 3)
    mean = scale * 4000 * np.exp(-lam * b)
    return rng.poisson(mean).astype(np.int32)


def _case(name):
    """(histogram [64, bins], quant [64], min_quant [64], qdelta_max,
    q_bias, what the case must show or None)."""
    rng = np.random.RandomState(sum(map(ord, name)))
    ones = np.ones(64, dtype=np.uint8)
    q75 = _base()
    if name == "zeros":
        return np.zeros((64, BINS), np.int32), q75, ones, 12, 0x78, None
    if name == "spikes":                 # one bin a position
        h = np.zeros((64, BINS), np.int32)
        h[np.arange(64), rng.randint(0, BINS, 64)] = rng.randint(1, 5000, 64)
        return h, q75, ones, 12, 0x78, None
    if name == "large_counts":           # error sums far above 2^24
        h = _photo_histo(rng, scale=3000.0)
        return h, q75, ones, 12, 0x78, "large"
    if name == "density_edge":           # total == 0.5 x last, and below
        h = np.zeros((64, BINS), np.int32)
        for p in range(64):
            last = 2 * (p % 30) + 2
            h[p, last - 1] = 1
            h[p, 0] = last // 2 - 1 - (p % 2)    # odd p: one short
        return h, q75, ones, 12, 0x78, "density"
    if name == "correlation_edge":
        return _correlation_rows(q75), q75, ones, 12, 0x78, "correlation"
    if name == "lambda_clamped":         # -num / den below 1
        h = np.zeros((64, BINS), np.int32)
        h[:, 33] = 1000                  # distortion slope ~1.09 x size's
        q = ones.copy()
        h[63], q[63] = 0, 35             # a falling distortion cloud
        h[63, 10] = 100
        return h, q, ones, 12, 0x78, "clamped"
    if name == "lambda_default":         # num too small to fit
        h = np.zeros((64, BINS), np.int32)
        h[:, 2] = h[:, 5] = 1
        return h, q75, ones, 12, 0x78, "default"
    if name == "quant_1":
        q = q75.copy()
        q[::3] = 1
        return _photo_histo(rng), q, ones, 12, 0x78, None
    if name == "quant_255":
        q = q75.copy()
        q[1::2] = 255
        q[::7] = 250
        return _photo_histo(rng), q, ones, 12, 0x78, None
    if name == "min_quant":              # the fit's range and the finalize
        m = rng.randint(1, 60, 64).astype(np.uint8)
        q = np.maximum(_base(90), m)
        return _photo_histo(rng), q, m, 12, 0x60, None
    if name == "qdelta_1":
        return _photo_histo(rng), _base(50, 1), ones, 1, 0x78, None
    if name == "qdelta_12":
        return _photo_histo(rng, 0.2, 0.2), _base(30), ones, 12, 0x78, None
    seed = int(name.split("_")[1])       # random_<seed>
    rng = np.random.RandomState(seed)
    h = (rng.rand(64, BINS) < rng.rand()) * rng.randint(
        0, 10 ** rng.randint(1, 7), (64, BINS))
    q = rng.randint(1, 256, 64).astype(np.uint8)
    m = np.minimum(rng.randint(1, 40, 64), q).astype(np.uint8)
    return (h.astype(np.int32), q, m, int(rng.randint(0, 13)),
            int(rng.randint(0, 256)), None)


def _correlation_margins(h, quant):
    """analyse_histo's correlation terms, as it computes them: per position
    cov^2 and the right-hand side of the test."""
    valid, bits, err = adaptive._delta_tables(quant.tobytes(),
                                             np.ones(64, np.uint8).tobytes())
    h = h.astype(np.int64)
    bsum = np.matmul(bits, h[:, :, None])[:, :, 0].astype(np.float64)
    dsum = np.matmul(err, h[:, :, None])[:, :, 0].astype(np.float64)
    xs = np.arange(C.QSIZE, dtype=np.float64) + C.QDELTA_MIN
    w = np.where(valid & (C.HISTO_WEIGHT > 0.0)[None, :],
                 C.HISTO_WEIGHT[None, :], 0.0)
    s = adaptive._seq_sum
    sw, sx, sxx = s(w, 1), s(w * xs, 1), s(w * xs * xs, 1)
    sy1, syy1 = s(w * dsum, 1), s(w * dsum * dsum, 1)
    sxy1 = s(w * dsum * xs, 1)
    cov = sw * sxy1 - sx * sy1
    return cov * cov, (C.CORRELATION_THRESHOLD * (sw * sxx - sx * sx)
                       * (sw * syy1 - sy1 * sy1))


def _correlation_rows(quant):
    """Rows whose correlation test lies within a hair of its edge: at each
    position the row, of a seeded family of two-bin rows, whose cov^2 over
    the test's right-hand side came nearest 1, from below at even positions
    (poor: left out of lambda) and from above at odd ones."""
    rng = np.random.RandomState(77)
    out = np.zeros((64, BINS), np.int32)
    best = np.full(64, np.inf)
    even = np.arange(64) % 2 == 0
    for _ in range(200):
        h = np.zeros((64, BINS), np.int32)
        for _ in range(2):
            h[np.arange(64), rng.randint(0, 24, 64)] += rng.randint(1, 400,
                                                                    64)
        lhs, rhs = _correlation_margins(h, quant)
        with np.errstate(divide="ignore", invalid="ignore"):
            dist = np.abs(np.log(lhs / rhs))
        take = ((lhs < rhs) == even) & np.isfinite(dist) & (dist < best)
        out[take], best[take] = h[take], dist[take]
    return out


CASES = ["zeros", "spikes", "large_counts", "density_edge",
         "correlation_edge", "lambda_clamped", "lambda_default", "quant_1",
         "quant_255", "min_quant", "qdelta_1", "qdelta_12", "random_0",
         "random_1", "random_2", "random_3"]


@pytest.mark.parametrize("name", CASES)
def test_fit_core_host_build_matches_host_route(fit_core, name):
    """The kernel's arithmetic == analyse_histo + finalize_quant_matrix,
    the port's and the JAX package's (the reference of the port), bit for
    bit, tuned and untuned; each edge case shows its edge."""
    from sjpeg_tpu import adaptive as jax_adaptive   # CPU only: not on the card
    from sjpeg_tpu import spec as jax_spec
    histo, quant, min_quant, qdelta_max, q_bias, shows = _case(name)
    got, lam = run_core(fit_core, histo, quant, min_quant, qdelta_max,
                        q_bias)
    want = host_route(histo, quant, min_quant, qdelta_max, q_bias)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, host_route(
        histo, quant, min_quant, qdelta_max, q_bias,
        modules=(jax_adaptive, jax_spec)))
    got0, _ = run_core(fit_core, histo, quant, min_quant, qdelta_max, q_bias,
                       tuned=False)
    for modules in ((adaptive, spec), (jax_adaptive, jax_spec)):
        np.testing.assert_array_equal(got0, host_route(
            histo, quant, min_quant, qdelta_max, q_bias, tuned=False,
            modules=modules))
    if shows == "large":
        _, _, err = adaptive._delta_tables(quant.tobytes(),
                                           min_quant.tobytes())
        dsum = np.matmul(err, histo.astype(np.int64)[:, :, None])
        assert (dsum > 2 ** 24).mean() > 0.5
        assert (dsum.astype(np.float32).astype(np.int64) != dsum).any()
    elif shows == "density":
        last = 2 * (np.arange(64) % 30) + 2
        total = histo.sum(axis=1)
        assert ((total == last // 2) == (np.arange(64) % 2 == 0)).all()
    elif shows == "correlation":
        lhs, rhs = _correlation_margins(histo, quant)
        ratio = lhs[2:] / rhs[2:]
        assert (ratio < 1).any() and (ratio > 1).any()
        assert np.abs(np.log(ratio)).min() < 1e-2
    elif shows == "clamped":
        assert lam == 1.0
    elif shows == "default":
        assert lam == float(C.HLAMBDA)
    if name == "quant_1":
        assert (got[0][got[2] == 1] == 0xFFFF).all() and (got[2] == 1).any()
    if name == "quant_255":
        assert (got[2] == 255).any()
    if name == "min_quant":
        assert (got[2] == min_quant).any()


def _fit_inputs():
    """Three images' (luma, chroma) histograms, a param with a tuned chroma
    group, and lambda_fit's matrix arguments."""
    rng = np.random.RandomState(18)
    b = 3
    hl = torch.from_numpy(np.stack([_photo_histo(rng) for _ in range(b)]))
    hc = torch.from_numpy(np.stack([_photo_histo(rng, 0.3)
                                    for _ in range(b)]))
    param = EncoderParam(quality=60, qdelta_max_chroma=3)
    base = engine._quant_matrices(param)
    args = (np.stack([base[0]["quant"], base[1]["quant"]]),
            param.resolved_min_quant_matrices(),
            (param.qdelta_max_luma, param.qdelta_max_chroma),
            param.quantization_bias)
    return hl, hc, param, base, args


def _histos(hl, hc, shared):
    return ((hl.sum(0, dtype=torch.int32), hc.sum(0, dtype=torch.int32))
            if shared else (hl, hc))


class _FixedHook:
    """A search hook that proposes the param's matrices every pass."""

    def __init__(self, param):
        self.quants = param.resolved_quant_matrices()

    def next_matrices(self):
        return self.quants


def test_lambda_fit_plain_matches_the_engine_host_fit():
    """lambda_fit_plain (the kernel's plain twin) == the batched search's
    per-image host fit (`_Search.make_qms`) == analyse_histo of each tuned
    group, chroma first as the reference runs it, then
    finalize_quant_matrix; per image and shared, one and two groups.
    `_fit_on_device` on host histograms returns its rows, and
    `_host_matrices` rebuilds from them the matrix dicts that make_qms
    gives."""
    from sjpeg_tpu_torch import engine_search

    hl, hc, param, base, args = _fit_inputs()
    b = hl.shape[0]
    flags = {"use_adaptive_quant": True}
    minq = param.resolved_min_quant_matrices()
    search = engine_search._Search(
        torch.zeros((1, 16, 16, 3), dtype=torch.uint8), "rgb", C.YUV_420,
        16, 16, EncoderParam(quality=60, qdelta_max_chroma=3)
        .set_target_size(1000, passes=3), 4.0)
    search.hooks = [_FixedHook(param)] * b
    for n_groups in (1, 2):
        search.n_groups = n_groups
        for shared in (False, True):
            histos = _histos(hl, hc, shared)
            hh = torch.stack(histos).numpy().reshape(2, -1, 64, BINS)
            per_qms = []
            for i in range(hh.shape[1]):
                qms = list(base)
                for g in range(n_groups - 1, -1, -1):
                    tuned = adaptive.analyse_histo(
                        hh[g, i], qms[g]["quant"], minq[g], args[2][g])
                    qms[g] = spec.finalize_quant_matrix(
                        tuned, minq[g], param.quantization_bias)
                per_qms.append(qms)
            search.histos = hh.astype(np.int64)
            for i, want in enumerate(per_qms):
                have = search.make_qms(i)
                for g in range(2):
                    assert want[g].keys() == have[g].keys()
                    for k in want[g]:
                        np.testing.assert_array_equal(want[g][k], have[g][k])
            got = lambda_fit.lambda_fit_plain(*histos, *args, n_groups)
            rows = [r[0] for r in got] if shared else list(got)
            for k, row in zip(("iquant", "bias", "quant"), rows):
                want = np.stack([[q[k] for q in qms] for qms in per_qms])
                np.testing.assert_array_equal(
                    row.numpy(), want[0] if shared else want)
            fitted = engine._fit_on_device(histos, param, flags, n_groups,
                                           shared, torch.device("cpu"))
            for f, r in zip(fitted, rows):
                assert torch.equal(f, r)
            rebuilt = engine._host_matrices(rows[2], param, b)
            assert len(rebuilt) == b
            for want, have in zip(per_qms * b if shared else per_qms,
                                  rebuilt):
                for g in range(2):
                    assert want[g].keys() == have[g].keys()
                    for k in want[g]:
                        assert want[g][k].dtype == have[g][k].dtype
                        np.testing.assert_array_equal(want[g][k], have[g][k])


@pytest.mark.parametrize("shared", [False, True])
def test_lambda_fit_on_cpu_histograms_runs_the_host_route(shared):
    """lambda_fit on CPU histograms returns exactly lambda_fit_plain's rows
    (one and two groups), launches nothing, and times the fit as the
    `sjpeg.analysis` span."""
    hl, hc, _, _, args = _fit_inputs()
    histos = _histos(hl, hc, shared)
    timer = profiling.StageTimer()
    lambda_fit.lambda_fit.launches = 0
    for n_groups in (1, 2):
        with profiling.timing(timer):
            got = lambda_fit.lambda_fit(*histos, *args, n_groups)
        want = lambda_fit.lambda_fit_plain(*histos, *args, n_groups)
        for g, w in zip(got, want):
            assert g.device.type == "cpu" and g.dtype == torch.int32
            assert torch.equal(g, w)
    assert lambda_fit.lambda_fit.launches == 0
    assert timer.counts["analysis"] == 2


def test_lambda_fit_raises_off_cuda_and_on_bad_inputs():
    h = torch.zeros((2, 64, BINS), dtype=torch.int32)
    q = np.full((2, 64), 16, np.uint8)
    m = np.ones((2, 64), np.uint8)
    with pytest.raises(TypeError):
        lambda_fit.lambda_fit(h.long(), h, q, m, (12, 1), 0x78, 2)
    with pytest.raises(ValueError, match="histograms"):
        lambda_fit.lambda_fit(h[..., :64], h[..., :64], q, m, (12, 1), 0x78,
                              2)
    with pytest.raises(ValueError, match="differ"):
        lambda_fit.lambda_fit(h, h[0], q, m, (12, 1), 0x78, 2)
    with pytest.raises(ValueError, match="qdelta_max"):
        lambda_fit.lambda_fit(h, h, q, m, (13, 1), 0x78, 2)
    with pytest.raises(ValueError, match="matrices"):
        lambda_fit.lambda_fit(h, h, q[0], m, (12, 1), 0x78, 2)


# ---- on the card -----------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")


@pytest.mark.cuda
@pytest.mark.parametrize("n_groups", [1, 2])
@pytest.mark.parametrize("shared", [False, True])
def test_lambda_fit_kernel_matches_host_route(n_groups, shared):
    """The kernel's three rows == the host route on every edge case: each
    case's histogram as the luma of one image, beside photo-like chroma."""
    _need_cuda()
    rng = np.random.RandomState(9)
    for name in CASES:
        histo, quant, min_quant, qdelta_max, q_bias, _ = _case(name)
        b = 1 if shared else 3
        hl = np.stack([histo] + [_photo_histo(rng) for _ in range(b - 1)])
        hc = np.stack([_photo_histo(rng, 0.3) for _ in range(b)])
        if shared:
            hl, hc = hl[0], hc[0]
        qc = np.maximum(_base(75, 1), min_quant)
        args = (np.stack([quant, qc]), np.stack([min_quant, min_quant]),
                (qdelta_max, 2), q_bias, n_groups)
        got = lambda_fit.lambda_fit(torch.from_numpy(hl).cuda(),
                                    torch.from_numpy(hc).cuda(), *args)
        want = lambda_fit.lambda_fit_plain(torch.from_numpy(hl),
                                           torch.from_numpy(hc), *args)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w), name


def _auto_batch():
    """test_torch_cuda's four-mode AUTO batch at 408^2: gray, a tinted
    gradient, a chroma sinusoid (sharp), noise (4:4:4)."""
    n = 408
    yy, xx = np.mgrid[0:n, 0:n]
    return np.stack([
        np.repeat(((xx + yy) % 256)[..., None], 3, -1),
        np.stack([xx * 64 // n + 96, yy * 64 // n + 96, 128 + 0 * xx], -1),
        np.stack([128 + 40 * np.sin(xx / 8), 128 + 0 * xx,
                  128 - 40 * np.sin(yy / 10.4)], -1),
        np.random.RandomState(34).randint(0, 256, (n, n, 3)),
    ]).astype(np.uint8)


@pytest.mark.cuda
@pytest.mark.parametrize("method", [1, 3, 4, 7])
def test_encode_batch_card_fit_bytes_match_cpu(method):
    """encode_batch under AUTO (four sub-batches: 4:0:0, 4:2:0, sharp
    4:2:0, 4:4:4), per image and shared, and encode_rgb: the card's bytes
    == the CPU path's; one lambda_fit launch a sub-batch (one an image)
    where the method fits."""
    _need_cuda()
    rgb = _auto_batch()
    param = EncoderParam(quality=70, huffman_compress=method != 3,
                         adaptive_quantization=method >= 3,
                         use_trellis=method == 7)
    assert param.method == method
    fits = method >= 3
    for share in (False, True):
        lambda_fit.lambda_fit.launches = 0
        got = engine.encode_batch(rgb, param, share_statistics=share)
        assert lambda_fit.lambda_fit.launches == (4 if fits else 0)
        assert got == engine.encode_batch(rgb, param, share_statistics=share,
                                          device="cpu")
    lambda_fit.lambda_fit.launches = 0
    got = [engine.encode_rgb(im, param) for im in rgb]
    assert lambda_fit.lambda_fit.launches == (4 if fits else 0)
    assert got == [engine.encode_rgb(im, param, device="cpu") for im in rgb]


@pytest.mark.cuda
def test_card_fit_fetches_no_histogram(tmp_path):
    """One traced method-4 encode_batch (pinned 4:2:0, per-image tables):
    four fetches (totals, words, DHT descriptions, tuned matrices), none
    done before the quantizer's pack ran on the card, and no analysis
    span."""
    _need_cuda()
    dev = torch.device("cuda")
    yy, xx = np.mgrid[0:256, 0:256]
    noise = np.random.RandomState(3).randint(-8, 9, (4, 256, 256, 3))
    rgb = np.clip(noise + np.stack([xx, yy, (xx + yy) // 2], -1), 0,
                  255).astype(np.uint8)       # no image overflows its bucket
    param = EncoderParam(yuv_mode=C.YUV_420)
    engine.encode_batch(rgb, param, device=dev)
    with profiling.device_trace(str(tmp_path)):
        tracing.prime_trace(dev)
        engine.encode_batch(rgb, param, device=dev)
    spans = profiling.trace_spans()
    fetch_ends = [s["ts"] + s["dur"] for s in spans
                  if s["name"] == "sjpeg.fetch"]
    assert len(fetch_ends) == 4
    assert not [s for s in spans if s["name"] == "sjpeg.analysis"]
    events = json.loads(next(tmp_path.glob("*.pt.trace.json")).read_text())[
        "traceEvents"]
    packs = [e["ts"] + e["dur"] for e in events
             if e.get("cat") == "kernel" and "vlc_pack" in e["name"]]
    assert len(packs) == 1 and min(fetch_ends) >= packs[0]


@pytest.mark.cuda
@pytest.mark.parametrize("method", [4, 7])
def test_sharded_fit_on_the_card(method):
    """encode_batch_sharded on meshes of the card (cuda:0 repeated): the
    lambda fit runs where each dp row's sums are, one launch a row (one for
    the batch with share_statistics), no host fit; the bytes == the CPU
    path's encode_batch."""
    _need_cuda()
    from unittest import mock

    from sjpeg_tpu_torch.parallel import api
    from sjpeg_tpu_torch.parallel.mesh import make_mesh
    rgb = _auto_batch()[1:]                   # three 4:2:0 images: ragged dp
    param = EncoderParam(quality=70, yuv_mode=C.YUV_420,
                         use_trellis=method == 7)
    assert param.method == method
    for (dp, sp), share in (((2, 2), False), ((1, 4), False),
                            ((2, 2), True)):
        mesh = make_mesh(dp, sp, [torch.device("cuda", 0)] * (dp * sp))
        lambda_fit.lambda_fit.launches = 0
        with mock.patch.object(adaptive, "analyse_histo",
                               wraps=adaptive.analyse_histo) as host_fits:
            got = api.encode_batch_sharded(rgb, param, mesh,
                                           share_statistics=share)
        assert host_fits.call_count == 0
        assert lambda_fit.lambda_fit.launches == (1 if share else dp)
        assert got == engine.encode_batch(rgb, param, share_statistics=share,
                                          device="cpu"), (dp, sp, share)


@pytest.mark.cuda
@pytest.mark.parametrize("method", [4, 7])
@pytest.mark.parametrize("target", ["size", "psnr"])
def test_single_image_search_fits_on_the_card(method, target):
    """The single-image search (encode_rgb with passes > 1): one lambda_fit
    launch a pass with that pass's matrices, no host fit; the bytes == the
    CPU path's."""
    _need_cuda()
    from unittest import mock
    rgb = _auto_batch()[1]
    param = EncoderParam(quality=70, yuv_mode=C.YUV_420,
                         use_trellis=method == 7)
    if target == "size":
        param.set_target_size(4000, passes=5)
    else:
        param.set_target_psnr(36.0, passes=5)
    lambda_fit.lambda_fit.launches = 0
    with mock.patch.object(adaptive, "analyse_histo",
                           wraps=adaptive.analyse_histo) as host_fits:
        got = engine.encode_rgb(rgb, param)
    assert host_fits.call_count == 0
    assert 1 <= lambda_fit.lambda_fit.launches <= 5
    assert got == engine.encode_rgb(rgb, param, device="cpu")
