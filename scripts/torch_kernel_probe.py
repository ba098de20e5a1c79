"""Time variants of the port's kernels side by side on one GPU, on the same
inputs.

    python3 scripts/torch_kernel_probe.py [--tree NAME=DIR ...]
        [--kernels stream_concat,vlc_pack,...] [--reps 20]

Each variant is a kernel source (`sjpeg_tpu_torch/csrc/<kernel>.cu` of this
tree, or of another checkout unpacked in DIR, with that tree's headers)
built by nvcc with the port's flags in a temporary directory under
`sjpeg_tpu_torch/_build/`, removed once the libraries are loaded.  Inputs
are chip_smoke.py's main configuration, 16 x 1024 x 1024 RGB, 4:2:0, q75
(N = 393,216 blocks):
- stream_concat: method 0's block streams of the batch, and of one
  4032 x 3024 photo (285,768 blocks in one image, bucket 64 words a
  block).  The timed unit is the whole op as that tree's
  ops/stream_concat.py runs it: offsets, totals and the zeroed output in
  torch, then the kernel, for a library that exports sjpeg_stream_concat;
  the zeroed output, then the scan and the placement, for one that exports
  sjpeg_stream_concat_scan;
- vlc_pack: method 4's fields with its per-image optimal LUTs, and with
  the shared K.3 LUTs;
- sample_pack: method 0's int16 samples, shared K.3 tables and per-image
  sets (16 quantizers);
- trellis: method 7's coefficients with fitted per-image matrices (and,
  as the engine has them, the K.3 rate table), and with shared matrices;
  the per-image case at q40, with every row zero, and four times over (64
  images); 4 x 512^2 at q75 and q40 (the method-7 search's batch).  For a
  library that exports sjpeg_trellis_ranked the timed unit is the whole
  op as ops/trellis.py runs it: its scratch (one buffer of the size
  sjpeg_trellis_scratch gives), then the work pass, the class starts, the
  scatter and the search; for one that exports sjpeg_trellis, its one
  launch;
- merge_codesizes: method 4's DC and AC frequencies.  The timed unit is
  the whole table build as that tree runs it: for a library that exports
  sjpeg_optimal_tables, its one launch (DC and AC rows in one grid); for
  one that exports sjpeg_merge_codesizes, the torch table build
  (huffman_device.optimal_code_luts_plain, the parent tree's
  optimal_code_luts body) with that merge kernel inside it, once for the
  DC rows and once for the AC rows, its rebalance reading a device flag
  on the host each turn.  That op allocates its outputs through torch's
  caching allocator, as in its tree; the one-launch variant writes the
  same buffers on every call;
- fdct: int32 samples; quant_pack: coefficients with K.3 tables;
- sharp_yuv: the sweep kernel on the set-up planes of the batch (every
  image sharp), of the 12-MP photo, and of the four sharp images of
  chip_smoke.py's AUTO batch.  The planes are restored before each launch,
  outside the timed events.  A library that exports
  sjpeg_sharp_yuv_cluster runs a cluster an image; one that exports only
  sjpeg_sharp_yuv is the CTA-an-image kernel with its scratch ring;
- risk_stats: the riskiness reduction on chip_smoke.py's AUTO batch and
  on the photo: the kernel (the zero fill and its launch) of each tree
  that has csrc/risk_stats.cu, and, as the variant of a tree without it,
  that tree's device path, the plain tensor code (risk_stats_plain).
Each variant's output is held against the plain PyTorch version; the
variants of a case write to the same output buffers.  Each call is timed
with CUDA events, median of --reps after a warm-up, the variants in turn,
twice (a, b).  torch.profiler then traces 5 more calls of each variant and
reports each kernel it launched (a stream_concat op's zero fill, chunk
sums and placement; the parent table build's some 70 kernels) with its
launches and device microseconds a call (chip_smoke.device_kernels), and
their sum a call.
With --steps TREE (repeatable), a stamped build of that tree's sweep
kernel splits each row-pair step on the batch and the photo from clock64()
stamps in every thread: cycles a step, the mean over the threads that hold
columns, and each part's share of the stamped step applied to the
unstamped kernel's device time a step.  For the CTA-an-image kernel (a
tree whose csrc/sharp_core.cuh has `sharp_column` and a ring in
`SharpImage`, as the kernel of 0f648a5 does) the parts are the global
loads (issued and waited for), the dependent arithmetic with the stores,
and the __syncthreads().  For a cluster kernel (a tree whose sharp_yuv.cu
exports sjpeg_sharp_yuv_cluster; its policy, kernel set-up and plan are
included from it) they are the front of a step (from the wait to the
arrive: the schedule's work before the arrive), the arrive, the window
(from the arrive to the wait) and the wait.
Prints one JSON line with every time, error and ptxas line, then the
card's name and power limit.  Needs CUDA and nvcc.
"""

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from sjpeg_tpu_torch import constants as C  # noqa: E402
from sjpeg_tpu_torch import (engine, kernels, pipeline,  # noqa: E402
                             sharp_yuv, state)
from sjpeg_tpu_torch.huffman import (k3_default_tables,  # noqa: E402
                                     trellis_cost_lens)
from sjpeg_tpu_torch.ops import sharp_yuv as sharp_ops  # noqa: E402
from sjpeg_tpu_torch.ops import (colorspace, fdct,  # noqa: E402
                                 huffman_device, merge_codesizes, quant_pack,
                                 riskiness, sample_pack, stream_concat,
                                 trellis, vlc_pack)
from sjpeg_tpu_torch.params import method_flags  # noqa: E402

KERNELS = ("stream_concat", "vlc_pack", "sample_pack", "trellis",
           "merge_codesizes", "fdct", "quant_pack", "sharp_yuv",
           "risk_stats")
B, H, W = chip_smoke.BATCH, chip_smoke.HEIGHT, chip_smoke.WIDTH
PHOTO = (3024, 4032)             # height, width of the single-image case


def build(csrc: Path, name: str, lib: Path, include: Path = None):
    """nvcc csrc/<name>.cu -> lib, with `include` on the header path;
    returns ptxas's register and spill lines."""
    res = subprocess.run([kernels.nvcc_path(), *kernels.NVCC_FLAGS,
                          *([f"-I{include}"] if include else []), "-o",
                          str(lib), str(csrc / f"{name}.cu")],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc {name} {csrc}: {res.stdout}{res.stderr}")
    return [ln.strip() for ln in (res.stdout + res.stderr).splitlines()
            if "registers" in ln or "spill" in ln]


def k3_tables(dev):
    return state.tables_from_numpy(
        *engine._quant_arrays(engine._quant_matrices(
            chip_smoke.method0(C.YUV_420))),
        *engine._host_luts(k3_default_tables()), dev)


def interleaved_samples(rgb, tables):
    """Method 0's interleaved samples, DC codes and groups of `rgb`."""
    b, h, w = rgb.shape[:3]
    nb = tuple(pipeline.component_layout(C.YUV_420, w, h).nb_blocks)
    blocks = colorspace.rgb_to_blocks(
        torch.from_numpy(rgb).to(tables[0].device), C.YUV_420, w, h)
    return engine._interleave_samples(blocks, tables[0], tables[1], nb, b)


def trellis_inputs(rgb, dev, quality=chip_smoke.QUALITY):
    """Method 7's coefficients, groups, per-image matrices (quality
    `quality`) and the K.3 rate table, with the batch's image count; the
    same with shared matrices."""
    b, h, w = rgb.shape[:3]
    param = chip_smoke.method7(C.YUV_420, quality)
    nb = tuple(pipeline.component_layout(C.YUV_420, w, h).nb_blocks)
    coeffs, histos = engine._stage_batch_coeffs(
        torch.from_numpy(rgb).to(dev), "rgb", C.YUV_420, w, h, True, b)
    iq, ib, qq = engine._fit_on_device(histos, param,
                                       method_flags(param.method), 2, False,
                                       dev)
    (lt,) = state.arrays_to_device(trellis_cost_lens(), device=dev)
    cinter, _, group = engine._interleave_coeffs(coeffs, iq, ib, nb, b)
    return {"per_image_mats": (cinter, group, iq, ib, qq, lt, b),
            "shared_mats": (cinter, group, iq[0], ib[0], qq[0], lt, b)}


def trellis_cases(rgb, dev):
    """The trellis's cases: the method-7 batch (per-image and shared
    matrices); the same batch at q40; its rows all zero (no coded AC
    position: the op's cost without a search); its rows four times over
    (64 images, 1,572,864 blocks: how the ranking grows with the rows);
    4 x 512^2 at q75 and q40, the method-7 search's batch."""
    cases = trellis_inputs(rgb, dev)
    c, g, iq, ib, qq, lt, b = cases["per_image_mats"]
    cases["q40"] = trellis_inputs(rgb, dev, 40)["per_image_mats"]
    cases["zero_rows"] = (torch.zeros_like(c), g, iq, ib, qq, lt, b)
    cases["rows_x4"] = (c.repeat(4, 1), g.repeat(4), iq.repeat(4, 1, 1),
                        ib.repeat(4, 1, 1), qq.repeat(4, 1, 1), lt, 4 * b)
    small = chip_smoke.make_rgb(4, 512, 512, chip_smoke.SEED + 700)
    for q in (75, 40):
        cases[f"search_4x512_q{q}"] = trellis_inputs(
            small, dev, q)["per_image_mats"]
    return cases


def make_cases(dev, wanted):
    """{kernel: {case: inputs}} for the kernels in `wanted`."""
    rgb = chip_smoke.make_rgb(B, H, W, chip_smoke.SEED)
    k3 = k3_tables(dev)
    cases = {}
    samples, dc, group = interleaved_samples(rgb, k3)
    if "sample_pack" in wanted:
        per_image = chip_smoke.search_inputs(rgb, C.YUV_420,
                                             [40 + 3 * i for i in range(B)])
        cases["sample_pack"] = {"shared": (samples, dc, group, k3),
                                "per_image": (*per_image[:3],
                                              per_image[3:])}
    if "stream_concat" in wanted:
        layout = pipeline.component_layout(C.YUV_420, W, H)
        words, bits = sample_pack.sample_pack_plain(samples, dc, group, *k3)
        photo = chip_smoke.make_rgb(1, *PHOTO, chip_smoke.SEED + 600)
        one = sample_pack.sample_pack_plain(*interleaved_samples(photo, k3),
                                            *k3)
        cases["stream_concat"] = {
            "batch": (words, bits, B, engine._bucket(layout, W, H, 4.0)),
            "photo": (*one, 1, one[0].shape[0] * 64)}
    if {"vlc_pack", "merge_codesizes"} & wanted:
        fields, luts, k3_luts, freqs = chip_smoke.method4_inputs(rgb)
        cases["vlc_pack"] = {"per_image": (*fields, *luts),
                             "shared": (*fields, *k3_luts)}
        cases["merge_codesizes"] = {"batch": (huffman_device.table_jobs(
            freqs[0].reshape(B, 2, -1), freqs[1].reshape(B, 2, -1)),)}
    if "trellis" in wanted:
        cases["trellis"] = trellis_cases(rgb, dev)
    if {"fdct", "quant_pack"} & wanted:
        nb = tuple(pipeline.component_layout(C.YUV_420, W, H).nb_blocks)
        blocks = colorspace.rgb_to_blocks(torch.from_numpy(rgb).to(dev),
                                          C.YUV_420, W, H)
        samples32 = torch.cat(blocks)
        coeffs = fdct.fdct_blocks_plain(samples32)
        cases["fdct"] = {"int32": (samples32,)}
        cinter, dc, group = engine._interleave_coeffs(
            list(coeffs.split([b.shape[0] for b in blocks])), k3[0], k3[1],
            nb, B)
        cases["quant_pack"] = {"k3": (cinter, dc, group, *k3)}
    if {"sharp_yuv", "risk_stats"} & wanted:
        photo = chip_smoke.make_rgb(1, *PHOTO, chip_smoke.SEED + 600)
        auto = chip_smoke.four_mode_batch(W, B // 4)
        images = {"batch_16x1024": rgb, "photo_12mp": photo,
                  "auto_sharp_4x1024": auto[2::4]}
        cases["sharp_yuv"] = {
            k: sharp_yuv.sharp_setup(torch.from_numpy(v).to(dev))
            for k, v in images.items()}
        cases["risk_stats"] = {
            "auto_batch_16x1024": (torch.from_numpy(auto).to(dev),),
            "photo_12mp": (torch.from_numpy(photo).to(dev),)}
    return {k: v for k, v in cases.items() if k in wanted}


def plain(kernel, args):
    """The plain PyTorch version's outputs for one case."""
    if kernel == "stream_concat":
        return stream_concat.stream_concat_plain(*args)
    if kernel == "vlc_pack":
        return vlc_pack.vlc_pack_plain(*args)
    if kernel == "sample_pack":
        return sample_pack.sample_pack_plain(*args[:3], *args[3])
    if kernel == "trellis":
        c, g, a, b, q, r, n_img = args
        return (trellis.trellis_quantize_plain(c, a, b, q, g, r, n_img),)
    if kernel == "merge_codesizes":
        return [t for out in chip_smoke.plain_tables(*args) for t in out]
    if kernel == "fdct":
        return (fdct.fdct_blocks_plain(*args),)
    if kernel == "sharp_yuv":
        y, uv, ty, tuv = args
        y, uv = y.clone(), uv.clone()
        return y, uv, sharp_yuv.sharp_iterate_plain(y, uv, ty, tuv)
    if kernel == "risk_stats":
        return riskiness.risk_stats_plain(*args)
    return quant_pack.quant_pack_plain(*args)


def launcher(kernel, lib, args, stream, buffers):
    """A callable that runs one case through `lib` and returns its
    outputs.  Kernels whose outputs the caller allocates write into
    `buffers`, one set per case, so that every variant writes to the same
    memory."""
    def fn(name, argtypes):
        f = getattr(lib, name)
        f.argtypes, f.restype = argtypes, ctypes.c_int
        return f

    def check(rc):
        kernels.check(rc, kernel)

    if kernel == "stream_concat":
        words, bits, n_img, bucket = args
        n = words.shape[0]
        if hasattr(lib, "sjpeg_stream_concat_scan"):
            f = fn("sjpeg_stream_concat_scan", stream_concat._ARGTYPES)

            def op():
                out, sums, totals = stream_concat.scratch(
                    n_img, n // n_img, bucket, words.device)
                stream_concat.launch(f, words, bits, out, sums, totals)
                return out, totals
            return op
        f = fn("sjpeg_stream_concat", [ctypes.c_void_p] * 4
               + [ctypes.c_int] * 3 + [ctypes.c_void_p])

        def parent_op():      # offsets and totals in torch, then the kernel
            lens = bits.to(torch.int64).reshape(n_img, -1)
            offs = (torch.cumsum(lens, dim=1) - lens).reshape(-1)
            totals = lens.sum(dim=1).to(torch.int32)
            out = torch.zeros((n_img, bucket), dtype=torch.int32,
                              device=words.device)
            with torch.cuda.device(words.device):
                check(f(words.data_ptr(), bits.data_ptr(), offs.data_ptr(),
                        out.data_ptr(), n, n // n_img, bucket,
                        torch.cuda.current_stream().cuda_stream))
            return out, totals
        return parent_op

    if kernel in ("vlc_pack", "sample_pack", "quant_pack"):
        n = args[0].shape[0]
        words, bits = buffers.setdefault("words", (
            torch.empty((n, 64), dtype=torch.int32, device="cuda"),
            torch.empty((n,), dtype=torch.int32, device="cuda")))
        if kernel == "vlc_pack":
            f = fn("sjpeg_vlc_pack", vlc_pack._ARGTYPES)
            n_sets = 1 if args[5].dim() == 2 else args[5].shape[0]
            ptrs = [t.data_ptr() for t in args]
            tail = (n, n // n_sets, n_sets, stream)
        elif kernel == "sample_pack":
            f = fn("sjpeg_sample_pack", sample_pack._ARGTYPES)
            samples, dc, group, tables = args
            n_sets = 1 if tables[0].dim() == 2 else tables[0].shape[0]
            ptrs = [samples.data_ptr(), samples.element_size(),
                    dc.data_ptr(), group.data_ptr(),
                    *(t.data_ptr() for t in tables)]
            tail = (n, n // n_sets, n_sets, stream)
        else:
            f = fn("sjpeg_quant_pack", quant_pack._ARGTYPES)
            ptrs = [t.data_ptr() for t in args]
            tail = (n, stream)

        def run():
            check(f(*ptrs, words.data_ptr(), bits.data_ptr(), *tail))
            return words, bits
        return run

    if kernel == "sharp_yuv":
        y0, uv0, ty, tuv = args
        b, h, w = y0.shape
        y, uv, it = buffers.setdefault("planes", (
            torch.empty_like(y0), torch.empty_like(uv0),
            torch.empty((b,), dtype=torch.int32, device=y0.device)))
        g2l, l2g = sharp_yuv.gamma_tensors(y0.device)
        ptrs = [y.data_ptr(), uv.data_ptr(), ty.data_ptr(), tuv.data_ptr(),
                g2l.data_ptr(), l2g.data_ptr()]
        if hasattr(lib, "sjpeg_sharp_yuv_cluster"):
            f = fn("sjpeg_sharp_yuv_cluster", sharp_ops._ARGTYPES)
        else:                 # the CTA-an-image kernel, its scratch ring
            f = fn("sjpeg_sharp_yuv", [ctypes.c_void_p] * 8
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
            ring = torch.empty((b, 2, w // 2, 3), dtype=torch.int32,
                               device=y0.device)
            ptrs.append(ring.data_ptr())

        def restore():
            y.copy_(y0)
            uv.copy_(uv0)

        def launch():
            check(f(*ptrs, it.data_ptr(), b, w, h, stream))

        def run():
            restore()
            launch()
            return y, uv, it
        run.restore, run.launch = restore, launch
        return run

    if kernel == "risk_stats":
        (src,) = args
        b, h, w = src.shape[:3]
        if lib is None:       # a tree without the kernel: its plain path
            return lambda: riskiness.risk_stats_plain(src)
        f = fn("sjpeg_risk_stats", riskiness._ARGTYPES)
        out = buffers.setdefault("sums", torch.empty(
            (b, 3), dtype=torch.int64, device=src.device))

        def run():
            out.zero_()
            check(f(src.data_ptr(), out.data_ptr(), b, h, w, stream))
            return out.unbind(1)
        return run

    if kernel == "trellis":
        c, g, a, b, q, r, n_img = args
        n = c.shape[0]
        levels = buffers.setdefault("levels", torch.empty_like(c))
        if hasattr(lib, "sjpeg_trellis_ranked"):
            f = fn("sjpeg_trellis_ranked", trellis._ARGTYPES)
            parts = (ctypes.c_int64 * 9)()    # the tree's scratch layout
            check(fn("sjpeg_trellis_scratch", [ctypes.c_int,
                                               ctypes.c_void_p])(
                n, ctypes.addressof(parts)))

            def op():         # its scratch, then the four launches
                trellis.launch(f, c, a, b, q, g, r, levels, torch.empty(
                    (parts[6],), dtype=torch.int32, device=c.device), n_img)
                return (levels,)
            return op
        f = fn("sjpeg_trellis", [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
               + [ctypes.c_void_p])

        def run():
            check(f(c.data_ptr(), g.data_ptr(), a.data_ptr(), b.data_ptr(),
                    q.data_ptr(), r.data_ptr(), levels.data_ptr(), n,
                    n // n_img, 1 if a.dim() == 2 else n_img,
                    1 if r.dim() == 2 else n_img, stream))
            return (levels,)
        return run

    if kernel == "merge_codesizes":
        (jobs,) = args
        if hasattr(lib, "sjpeg_optimal_tables"):
            f = fn("sjpeg_optimal_tables", merge_codesizes._ARGTYPES)
            outs = buffers.setdefault("tables", merge_codesizes.outputs(jobs))

            def tables():
                merge_codesizes.launch(f, jobs, outs)
                return [t for out in outs for t in out]
            return tables
        f = fn("sjpeg_merge_codesizes", [ctypes.c_void_p] * 6
               + [ctypes.c_int] * 3 + [ctypes.c_void_p])

        def merge(freqw, active, comp, cs, nleft, steps):
            act = active.to(torch.int32).contiguous()
            out = torch.empty_like(freqw)
            with torch.cuda.device(freqw.device):
                check(f(freqw.data_ptr(), act.data_ptr(), comp.data_ptr(),
                        cs.data_ptr(), nleft.data_ptr(), out.data_ptr(),
                        freqw.shape[0], freqw.shape[1], steps,
                        torch.cuda.current_stream().cuda_stream))
            return out

        def parent_op():      # the torch table build around the merge kernel
            with mock.patch.object(merge_codesizes, "merge_codesizes_plain",
                                   merge):
                return [t for freq, size, lut in jobs
                        for t in huffman_device.optimal_code_luts_plain(
                            freq, size, lut, with_syms=True)]
        return parent_op

    (x,) = args
    coeffs = buffers.setdefault("coeffs", torch.empty_like(x))
    f = fn("sjpeg_fdct", fdct._ARGTYPES)

    def run():
        check(f(x.data_ptr(), x.element_size(), coeffs.data_ptr(),
                x.shape[0], stream))
        return (coeffs,)
    return run


# The CTA-an-image sweep kernel of 0f648a5 (one CTA an image, a
# __syncthreads() a row pair, loads inside the step), its row-pair loop
# copied with clock64() stamps around each column's loads, its arithmetic
# and stores, and the sync.  The loads' values are summed into one
# register that an empty asm statement consumes, so the loads complete
# before the second stamp; the stamps clobber memory, so no load or store
# moves across them.  out[thread] = (load, arithmetic, sync cycles, steps).
STEPS_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#define SJ_SHARP_FN __device__ __forceinline__
#include "sharp_core.cuh"

namespace {
constexpr int kTableWords =
    sjpeg::kGammaToLinearSize + sjpeg::kLinearToGammaSize;

__device__ __forceinline__ long long stamp() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t) :: "memory");
  return t;
}

__device__ int64_t block_sum(int64_t v, int64_t* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int o = 16; o; o >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0;
    for (int o = 16; o; o >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, o);
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  const int64_t total = red[32];
  __syncthreads();
  return total;
}

__global__ void __launch_bounds__(1024)
sharp_steps_kernel(int32_t* y_all, int32_t* uv_all, const int32_t* ty_all,
                   const int32_t* tuv_all, const int32_t* g2l,
                   const int32_t* l2g, int32_t* scratch, long long* out,
                   int w, int h) {
  extern __shared__ int32_t smem[];
  __shared__ int64_t red[33];
  for (int i = threadIdx.x; i < kTableWords; i += blockDim.x)
    smem[i] = i < sjpeg::kGammaToLinearSize
                  ? g2l[i] : l2g[i - sjpeg::kGammaToLinearSize];
  __syncthreads();
  const int64_t b = blockIdx.x;
  const int64_t plane = (int64_t)w * h;
  const int uv_w = w >> 1, uv_h = h >> 1;
  int32_t* rows = scratch + b * uv_w * 6;
  int32_t* Y = y_all + b * plane;
  int32_t* UV = uv_all + b * (plane / 4) * 3;
  const int32_t* TY = ty_all + b * plane;
  const int32_t* TUV = tuv_all + b * (plane / 4) * 3;
  const sjpeg::SharpTables t{smem, smem + sjpeg::kGammaToLinearSize};
  long long acc[3] = {0, 0, 0}, steps = 0;
  const int64_t thr = 3 * (int64_t)w * h;
  int64_t prev = 0;
  int it = 0;
  while (it < sjpeg::kSharpIterations) {
    int64_t part = 0;
    for (int k = 0; k < uv_h; ++k) {
      for (int j = threadIdx.x; j < uv_w; j += blockDim.x) {
        const long long t0 = stamp();
        const bool first = j == 0, last = j == uv_w - 1;
        const int32_t* own = UV + (int64_t)k * uv_w * 3;
        const int32_t* above = k ? rows + ((k - 1) & 1) * uv_w * 3 : own;
        const int32_t* below = k + 1 < uv_h ? own + uv_w * 3 : own;
        int32_t a[3][3] = {}, p[3][3] = {}, n[3][3] = {};
        int32_t chk = 0;
        for (int d = 0; d < 3; ++d) {
          const int col = j - 1 + d;
          if ((d == 0 && first) || (d == 2 && last)) continue;
          for (int c = 0; c < 3; ++c) {
            a[c][d] = own[col * 3 + c];
            p[c][d] = above[col * 3 + c];
            n[c][d] = below[col * 3 + c];
            chk += a[c][d] + p[c][d] + n[c][d];
          }
        }
        int32_t* y = Y + (int64_t)2 * k * w + 2 * j;
        const int32_t* ty = TY + (int64_t)2 * k * w + 2 * j;
        int32_t yy[2][2] = {{y[0], y[1]}, {y[w], y[w + 1]}};
        const int32_t tt[2][2] = {{ty[0], ty[1]}, {ty[w], ty[w + 1]}};
        const int32_t* tuv = TUV + ((int64_t)k * uv_w + j) * 3;
        const int32_t tv[3] = {tuv[0], tuv[1], tuv[2]};
        chk += yy[0][0] + yy[0][1] + yy[1][0] + yy[1][1] + tt[0][0] +
               tt[0][1] + tt[1][0] + tt[1][1] + tv[0] + tv[1] + tv[2];
        asm volatile("" :: "r"(chk));
        const long long t1 = stamp();
        int32_t* ring = rows + (k & 1) * uv_w * 3 + j * 3;
        part += sjpeg::sharp_column(t, a, p, n, yy, tt, tv, first, last,
                                    ring);
        y[0] = yy[0][0];
        y[1] = yy[0][1];
        y[w] = yy[1][0];
        y[w + 1] = yy[1][1];
        if (k) {
          const int32_t* done = rows + ((k - 1) & 1) * uv_w * 3 + j * 3;
          int32_t* dst = UV + ((int64_t)(k - 1) * uv_w + j) * 3;
          for (int c = 0; c < 3; ++c) dst[c] = done[c];
        }
        const long long t2 = stamp();
        acc[0] += t1 - t0;
        acc[1] += t2 - t1;
      }
      const long long t2 = stamp();
      __syncthreads();
      acc[2] += stamp() - t2;
      ++steps;
    }
    for (int j = threadIdx.x; j < uv_w; j += blockDim.x) {
      const int32_t* done = rows + ((uv_h - 1) & 1) * uv_w * 3 + j * 3;
      int32_t* dst = UV + ((int64_t)(uv_h - 1) * uv_w + j) * 3;
      for (int c = 0; c < 3; ++c) dst[c] = done[c];
    }
    const int64_t diff = block_sum(part, red);
    ++it;
    if (it > 1 && (diff < thr || diff > prev)) break;
    prev = diff;
  }
  long long* o = out + (b * blockDim.x + threadIdx.x) * 4;
  o[0] = acc[0];
  o[1] = acc[1];
  o[2] = acc[2];
  o[3] = steps;
}
}  // namespace

extern "C" int sjpeg_sharp_steps(void* y, void* uv, const void* ty,
                                 const void* tuv, const void* g2l,
                                 const void* l2g, void* scratch, void* out,
                                 int b, int w, int h, int threads,
                                 void* stream) {
  const size_t shared = kTableWords * sizeof(int32_t);
  sharp_steps_kernel<<<b, threads, shared, (cudaStream_t)stream>>>(
      (int32_t*)y, (int32_t*)uv, (const int32_t*)ty, (const int32_t*)tuv,
      (const int32_t*)g2l, (const int32_t*)l2g, (int32_t*)scratch,
      (long long*)out, w, h);
  return (int)cudaGetLastError();
}
"""


# A cluster tree's kernel (its policy, set-up and plan included from its
# sharp_yuv.cu) with the policy's arrive() and wait() stamped:
# out[thread] = (front, arrive, window, wait cycles, waits).
CLUSTER_STEPS_SOURCE = r"""
#include "sharp_yuv.cu"

namespace {
__device__ __forceinline__ long long stamp() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t) :: "memory");
  return t;
}

template <int CPT>
struct StampedCta : ClusterCta<CPT> {
  long long acc[5];
  long long last;
  __device__ __forceinline__ void arrive() {
    const long long t = stamp();
    acc[0] += t - last;
    ClusterCta<CPT>::arrive();
    last = stamp();
    acc[1] += last - t;
  }
  __device__ __forceinline__ void wait() {
    const long long t = stamp();
    acc[2] += t - last;
    ClusterCta<CPT>::wait();
    last = stamp();
    acc[3] += last - t;
    acc[4] += 1;
  }
  __device__ __forceinline__ void sync() {
    arrive();
    wait();
  }
  __device__ int64_t sum(int64_t v) {
    const int64_t total = ClusterCta<CPT>::sum(v);
    last = stamp();
    return total;
  }
};

__global__ void __launch_bounds__(kMaxThreads, 1)
sharp_stamped_kernel(int32_t* y, int32_t* uv, const int32_t* ty,
                     const int32_t* tuv, const int32_t* g2l,
                     const int32_t* l2g, int32_t* iters, long long* out,
                     int w, int h, int cols) {
  extern __shared__ __align__(16) int32_t smem[];
  __shared__ int64_t red[34];
  __shared__ uint64_t bars[5];
  StampedCta<1> cta;
  const sjpeg::SharpImage im = setup(cta, smem, red, bars, y, uv, ty, tuv,
                                     g2l, l2g, w, h, cols);
  for (int i = 0; i < 5; ++i) cta.acc[i] = 0;
  cta.last = stamp();
  const int it = sjpeg::sharp_image(
      cta, sjpeg::SharpTables{smem, smem + sjpeg::kGammaToLinearSize}, im);
  cluster_sync();
  const unsigned n = cg::this_cluster().num_blocks();
  if (cg::this_cluster().block_rank() == 0 && threadIdx.x == 0)
    iters[blockIdx.x / n] = it;
  long long* o = out + ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * 5;
  for (int i = 0; i < 5; ++i) o[i] = cta.acc[i];
}
}  // namespace

extern "C" int sjpeg_sharp_stamped(void* y, void* uv, const void* ty,
                                   const void* tuv, const void* g2l,
                                   const void* l2g, void* iters, void* out,
                                   int b, int w, int h, void* stream) {
  Plan p;
  cudaError_t e = make_plan(b, w, h, p);
  if (e != cudaSuccess) return (int)e;
  if (p.cols_per_thread != 1) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  e = prepare<1>(p, cfg, attr, b, (cudaStream_t)stream);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(sharp_stamped_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  if (e == cudaSuccess)
    e = cudaLaunchKernelEx(&cfg, sharp_stamped_kernel, (int32_t*)y,
                           (int32_t*)uv, (const int32_t*)ty,
                           (const int32_t*)tuv, (const int32_t*)g2l,
                           (const int32_t*)l2g, (int32_t*)iters,
                           (long long*)out, w, h, p.cols);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
"""


def sharp_steps_cluster(lib, cases, device_us, tree):
    """Step split of a cluster tree's kernel (see CLUSTER_STEPS_SOURCE):
    cycles a step in the front, the arrive, the window and the wait, the
    mean over every thread, and each part's share of the unstamped
    kernel's device time a step."""
    f = lib.sjpeg_sharp_stamped
    f.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    f.restype = ctypes.c_int
    plan_fn = lib.sjpeg_sharp_yuv_plan       # the included tree's plan
    plan_fn.argtypes = sharp_ops._PLAN_ARGTYPES
    plan_fn.restype = ctypes.c_int
    names = ("front", "arrive", "window", "wait")
    out = {}
    for case in ("batch_16x1024", "photo_12mp"):
        y0, uv0, ty, tuv = cases[case]
        b, h, w = y0.shape
        raw = (ctypes.c_int * len(sharp_ops.PLAN_KEYS))()
        kernels.check(plan_fn(b, w, h, ctypes.addressof(raw)), "plan")
        plan = dict(zip(sharp_ops.PLAN_KEYS, raw))
        y, uv = y0.clone(), uv0.clone()
        it = torch.empty((b,), dtype=torch.int32, device="cuda")
        stamps = torch.zeros((b * plan["cluster"] * plan["threads"], 5),
                             dtype=torch.int64, device="cuda")
        g2l, l2g = sharp_yuv.gamma_tensors(y.device)

        def launch():
            kernels.check(f(y.data_ptr(), uv.data_ptr(), ty.data_ptr(),
                            tuv.data_ptr(), g2l.data_ptr(), l2g.data_ptr(),
                            it.data_ptr(), stamps.data_ptr(), b, w, h,
                            torch.cuda.current_stream().cuda_stream),
                          "sharp_stamped")

        def restore():
            y.copy_(y0)
            uv.copy_(uv0)
        stamped_ms = chip_smoke.launch_ms(restore, launch)
        want = plain("sharp_yuv", cases[case])
        torch.cuda.synchronize()
        err = chip_smoke.max_err([(y, want[0]), (uv, want[1])])
        held = stamps.double()
        per_step = (held[:, :4] / held[:, 4:]).mean(dim=0).tolist()
        total = sum(per_step)
        n_steps = int(stamps[:, 4].max())
        step_us = device_us[f"sharp_yuv/{tree}/{case}"] / n_steps
        out[case] = {
            "plan": plan, "waits": n_steps, "max_abs_err": err,
            "stamped_ms": stamped_ms,
            "cycles_a_step": dict(zip(names, per_step)),
            "unstamped_us_a_step": step_us,
            "us_a_step": {k: step_us * v / total
                          for k, v in zip(names, per_step)}}
    return out


def sharp_steps(lib, cases, device_us, tree):
    """Step 0: the stamped CTA-an-image kernel on the batch and the photo;
    cycles a row-pair step in each part, the mean over the threads that
    hold columns, and each part's share of the unstamped kernel's device
    time a step (device_us of sharp_yuv/<tree>/<case>)."""
    f = lib.sjpeg_sharp_steps
    f.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    f.restype = ctypes.c_int
    out = {}
    for case in ("batch_16x1024", "photo_12mp"):
        y0, uv0, ty, tuv = cases[case]
        b, h, w = y0.shape
        uv_w = w // 2
        threads = min(1024, (uv_w + 31) // 32 * 32)   # as the kernel's
        y, uv = y0.clone(), uv0.clone()
        ring = torch.empty((b, 2, uv_w, 3), dtype=torch.int32, device="cuda")
        stamps = torch.zeros((b, threads, 4), dtype=torch.int64,
                             device="cuda")
        g2l, l2g = sharp_yuv.gamma_tensors(y.device)

        def launch():
            kernels.check(f(y.data_ptr(), uv.data_ptr(), ty.data_ptr(),
                            tuv.data_ptr(), g2l.data_ptr(), l2g.data_ptr(),
                            ring.data_ptr(), stamps.data_ptr(), b, w, h,
                            threads, torch.cuda.current_stream().cuda_stream),
                          "sharp_steps")

        def restore():
            y.copy_(y0)
            uv.copy_(uv0)
        stamped_ms = chip_smoke.launch_ms(restore, launch)
        want = plain("sharp_yuv", cases[case])
        torch.cuda.synchronize()
        err = chip_smoke.max_err([(y, want[0]), (uv, want[1])])
        held = stamps[:, :min(threads, uv_w)].double()
        per_step = (held[..., :3] / held[..., 3:]).mean(dim=(0, 1)).tolist()
        total = sum(per_step)
        n_steps = int(stamps[:, 0, 3].max())      # the longest image's
        step_us = device_us[f"sharp_yuv/{tree}/{case}"] / n_steps
        out[case] = {
            "threads": threads, "columns_a_thread": -(-uv_w // threads),
            "steps": n_steps, "max_abs_err": err,
            "stamped_ms": stamped_ms,
            "cycles_a_step": dict(zip(("loads", "arithmetic", "sync"),
                                      per_step)),
            "unstamped_us_a_step": step_us,
            "us_a_step": {k: step_us * v / total for k, v in zip(
                ("loads", "arithmetic", "sync"), per_step)}}
    return out


def traced_us(fn, tries: int = 3):
    """(chip_smoke.device_kernels trace of 5 calls of fn, the device
    microseconds a call of its kernels and memsets, not its copies): a
    trace that recorded no kernel, or lost some calls' launches (a kernel
    or memset recorded a fractional number of times a call), is taken
    again, up to `tries`; after that the time is None, never a part."""
    for _ in range(tries):
        kern = chip_smoke.device_kernels(fn, 5)
        ours = {k: v for k, v in kern.items() if not k.startswith("Memcpy")}
        if ours and all(v["launches"] >= 1
                        and v["launches"] == int(v["launches"])
                        for v in ours.values()):
            return kern, sum(v["us"] for v in ours.values())
    return kern, None


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", default=[],
                    metavar="NAME=DIR",
                    help="another checkout whose sjpeg_tpu_torch/csrc to "
                         "compare, e.g. parent=_archive/parent")
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help="comma-separated subset of " + ",".join(KERNELS))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--steps", metavar="TREE", action="append", default=[],
                    help="split the row-pair steps of this tree's "
                         "sharp_yuv kernel with clock64() stamps")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_probe: CUDA is not available", file=sys.stderr)
        return 1
    wanted = args.kernels.split(",")
    if not set(wanted) <= set(KERNELS):
        ap.error(f"--kernels: unknown {set(wanted) - set(KERNELS)}")
    kernels.BUILD_DIR.mkdir(exist_ok=True)
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    trees = {"change": REPO / "sjpeg_tpu_torch" / "csrc"}
    for spec in args.tree:
        name, path = spec.split("=", 1)
        trees[name] = Path(path) / "sjpeg_tpu_torch" / "csrc"

    if args.steps and (set(args.steps) - set(trees)
                       or "sharp_yuv" not in wanted):
        ap.error("--steps needs trees named by --tree (or change) and "
                 "sharp_yuv in --kernels")
    clustered = {t for t in args.steps if "sjpeg_sharp_yuv_cluster" in (
        trees[t] / "sharp_yuv.cu").read_text()}

    tmp = Path(tempfile.mkdtemp(prefix="probe_", dir=kernels.BUILD_DIR))
    keys = [(kernel, tree) for kernel in wanted for tree in trees]
    built = [k for k in keys if (trees[k[1]] / f"{k[0]}.cu").exists()]
    libs = {key: tmp / f"lib{key[0]}_{key[1]}.so" for key in built}
    jobs = [(trees[k[1]], k[0], libs[k]) for k in built]
    for tree in args.steps:
        name = f"steps_{tree}"
        (tmp / f"{name}.cu").write_text(
            CLUSTER_STEPS_SOURCE if tree in clustered else STEPS_SOURCE)
        jobs.append((tmp, name, tmp / f"lib{name}.so", trees[tree]))
    try:
        with ThreadPoolExecutor(len(jobs)) as pool:   # one nvcc each, at once
            logs = list(pool.map(lambda job: build(*job), jobs))
        ptxas = dict(zip(["/".join(k) for k in built]
                         + [f"steps/{t}" for t in args.steps], logs))
        steps_libs = {t: ctypes.CDLL(str(tmp / f"libsteps_{t}.so"))
                      for t in args.steps}
        libs = {key: ctypes.CDLL(str(libs[key])) if key in libs else None
                for key in keys}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)  # loaded libraries stay mapped

    cases = make_cases(dev, set(wanted))
    launches, errors, buffers, plains = {}, {}, {}, {}
    for (kernel, variant), lib in libs.items():
        if lib is None and kernel != "risk_stats":
            continue
        for case, inputs in cases[kernel].items():
            key = f"{kernel}/{variant}/{case}"
            launches[key] = launcher(kernel, lib, inputs, stream,
                                     buffers.setdefault((kernel, case), {}))
            got = launches[key]()
            if (kernel, case) not in plains:
                plains[kernel, case] = plain(kernel, inputs)
            torch.cuda.synchronize()
            errors[key] = chip_smoke.max_err(zip(got, plains[kernel, case]))
            del got
    plains.clear()
    ms = {}
    for turn in ("a", "b"):
        for key, fn in launches.items():
            ms.setdefault(key, {})[turn] = (
                chip_smoke.launch_ms(fn.restore, fn.launch, args.reps)
                if hasattr(fn, "launch")
                else chip_smoke.event_ms(fn, args.reps))
    profile, device_us = {}, {}
    for key, fn in launches.items():
        profile[key], device_us[key] = traced_us(fn)
    steps = {t: (sharp_steps_cluster if t in clustered else sharp_steps)(
        lib, cases["sharp_yuv"], device_us, t)
        for t, lib in steps_libs.items()}
    ratios = {}
    for key in ms:
        kernel, variant, case = key.split("/")
        base = ms.get(f"{kernel}/parent/{case}")
        if variant != "parent" and base:
            ratios[key] = {t: ms[key][t] / base[t] for t in ("a", "b")}
    card = chip_smoke.gpu_name_and_limit()
    print(json.dumps({"gpu": card, "ms": ms, "over_parent": ratios,
                      "max_abs_err": errors, "device_us": device_us,
                      "device_kernels": profile,
                      "sharp_steps": steps,
                      "ptxas": ptxas,
                      "blocks": B * H * W * 3 // 2 // 64}), flush=True)
    print(card, flush=True)
    return 0 if all(e == 0 for e in errors.values()) else 2


if __name__ == "__main__":
    sys.exit(main())
