"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two paths through sjpeg_tpu_torch.engine.encode_batch at
16 x 1024 x 1024 RGB, 4:2:0, q75, and holds every kernel and every output
against the plain PyTorch versions on the same card:

- method 0 (K.3 tables), through sample_pack and stream_concat.  Phases:
  probe, build, parity (each kernel vs its plain version at full size),
  sc_edges (stream_concat on one 12-MP image, images shorter than a scan
  chunk, an overflow past the bucket, empty and 2,048-bit blocks),
  sp_long_streams (sample_pack, vlc_pack and quant_pack on the longest
  streams, shared and per-image tables, three or more sets a CTA), main_path
  (launch counts, bytes vs the plain-forced path), cases (4:4:4, 4:0:0,
  1000 x 750, a bucket overflow, GPU vs CPU path), timing (CUDA events and
  host clock; the kernels of one stream_concat op from a torch.profiler
  trace), breakdown (host clock per stage);
- method 4 (adaptive quantization + per-image optimal Huffman tables),
  through merge_codesizes (the whole table build, one launch), vlc_pack
  and stream_concat.  Phases: tables (the table kernel on rows of every
  kind: ties, the rebalance, one symbol, empty, wrapping sums), m4_parity,
  m4_path, m4_cases (methods 1 and 3, shared statistics, 4:4:4, 4:0:0,
  1000 x 750, NV12, overflow re-packs, GPU vs CPU path), m4_timing,
  m4_breakdown; lambda_fit (the kernel against the host route, its
  device time and bound, launches and host fits a request in the three
  benchmark cells' entries); vlc_fields (the fields-and-frequencies
  kernel against its plain twin on coefficients and on the trellis's
  levels, on the main batch and a 12-MP photo; its device time, ptxas
  figures and launches a request in the benchmark cells' entries);
  scan_stuff (the padding-and-stuffing kernel against words_to_scan on
  the main batch's streams and a 12-MP photo's; its device time beside
  its bound, the host stuffing's time and the tail's join of headers and
  scans; launches a request in the four benchmark cells' entries);
- method 7 (method 4 with trellis quantization), through trellis,
  merge_codesizes, vlc_pack and stream_concat.  Phases: tr_parity (the
  trellis op: a work pass, class starts, a ranking and the search; with
  per-image and shared matrices and per-image rate tables; on 48 images
  of 512 blocks, 512 of 48, all-zero blocks and half-zeroed rows; its
  ranking, class histograms, starts and totals read back against a
  stable heaviest-first sort; the table kernel on the
  trellis's frequencies), tr_path, tr_cases (shared
  statistics, 4:4:4, 4:0:0, 1000 x 750, NV12, q40, q90, an overflow
  re-pack, GPU vs CPU path), tr_timing (the op's four launches, the whole
  op, all-zero blocks, each kernel's device time), tr_breakdown;
- the batched target-size search (method 4, set_target_size(200_000,
  passes=8)), through sample_pack with per-image tables, stream_concat
  and merge_codesizes (one table build) once a pass.  Phases: search_parity (the per-image
  kernel at 16 x 1024^2, 1000 x 750 and images under 128 blocks),
  search_path (launches, bytes vs the plain-forced path, sizes against the
  target), search_cases (PSNR, passes=10, methods 0, 1 and 7, gray, NV12,
  a bucket overflow, GPU vs CPU path), search_timing, search_breakdown;
- the single-image API (encode_rgb, encode_gray, encode_yuv, the
  single-image search, custom search hooks), through the standalone fDCT
  (fdct) and the coefficients-in pack (quant_pack) besides the kernels
  above.  Phases: single_kernels (fdct and quant_pack vs their plain
  versions at 16 x 1024^2, and their times; quant_pack also on the
  longest streams, in sp_long_streams), single_parity (1000 x 750:
  every entry point, method and search, and a custom hook through
  encode_batch, vs the plain-forced path), single_path and single_timing
  (a 4032 x 3024 12-MP photo: encode_rgb methods 0 and 4, encode_yuv
  method 0, an encode_rgb size search);
- the serving wrappers: serving (encode_pipelined over four 16 x 1024^2
  batches vs encode_batch, and encode_many on mixed shapes vs encode_rgb);
- YUV_AUTO and sharp YUV, through the riskiness kernel (risk_stats) and
  the sharp-YUV sweep kernel (sharp_yuv, a thread-block cluster an image)
  besides the kernels above.  Phases: auto_batch (a 16 x 1024^2 q75 batch
  in which AUTO picks each of the four modes four times, with the default
  EncoderParam, method 4, and with method 0: bytes vs the plain-forced
  path, modes vs the host scorer, one risk_stats launch a batch and its
  device time), sharp_kernel (the kernel vs its plain version, planes and
  sweep counts exact, at 16 x 1024^2, on the 12-MP photo, on the AUTO
  batch's four sharp images, at 1000 x 751, on a batch whose images stop
  after 2, 3 and 4 sweeps, and on a 19,000-wide row whose slices are
  wider than their CTAs; each shape's cluster plan, and the times of the
  first three), risk_kernel (the riskiness kernel vs its plain version on
  the AUTO batch, the main batch, the photo, one row, one column and a
  2 x 2 image; its times), single_auto (encode_rgb on the 12-MP photo with
  the default EncoderParam and with SHARP pinned), and cli (python -m
  sjpeg_tpu_torch.cli on a 256^2 PPM, with and without -sharp, vs
  --device cpu);
- the sharded API (sjpeg_tpu_torch.parallel.encode_batch_sharded) on
  meshes of the card (cuda:0 repeated; distinct devices too when there
  are several), through fdct, trellis, merge_codesizes, vlc_pack,
  stream_concat (a stripe's stream, and the stitch), sharp_yuv and
  risk_stats.  Phase sharded (before cli): the main batch with methods
  0, 4 and 7 on (1, 4) and (2, 2), 8 x 1920 x 1080 on (2, 4) (a partial
  MCU row inside a stripe), 3 images on dp = 2, shared statistics, the
  AUTO batch and SHARP on (2, 2), and two processes (gloo, a file://
  store) each with a (1, 2) grid of the card, every case's bytes vs
  engine.encode_batch on the card; the stitch's stream_concat launch vs
  its plain version on the same 64-word pieces (stripe streams of
  0-2,049 bits and the main batch's stripes); the wrappers' launch
  counts of each call and torch.profiler's of one; median-of-3 ms
  beside encode_batch's; a host-clock stage breakdown.  The kernels
  line's rows gain `sharded_launches`;
- the sharded search (target size / PSNR through encode_batch_sharded),
  through fdct, trellis, merge_codesizes, vlc_pack and stream_concat.
  Phase sharded_search (after sharded): size with methods 4 and 7 and
  PSNR with method 4 on (2, 2), size with method 0 on (1, 4), every
  case's bytes vs engine.encode_batch on the card; passes run, each
  kernel's launches against the count the passes imply, a stage
  breakdown, median-of-3 ms beside encode_batch's.  The kernels line's
  rows gain `sharded_search_launches`;
- the C++ host helpers (sjpeg_tpu_torch.native, built by g++ in the build
  phase): host_native (which version of each helper the search and a
  shared-statistics encode ran, the build seconds, the main batch's scan
  tails in C++ and in the NumPy twin, the node fit in C++ and by the
  NumPy fit per pair, the host stages that run them);
- the profiling utilities (sjpeg_tpu_torch.utils.profiling): profiling
  (after host_native) traces one encode_batch of the main batch with
  method 0 and with method 4 through device_trace, inside a StageTimer
  stage after priming the trace with small copies and kernels (late in a
  long process the profiler loses a session's first device records), and
  reads the exported Chrome trace: the device's busy time
  (the union of kernel, memcpy and memset intervals), the idle share of
  the call's host-clock window, the top device ops, the longest idle gaps
  and the CPU op each began in (benchmark/tracing.py's arithmetic), and
  the port's spans that the trace kept (their stages also feed the
  StageTimer, installed with `timing`); the path's
  kernels and the batch's upload must be in the trace; StageTimer's
  report through log_jsonl and back;
- the inspector (sjpeg_tpu_torch.inspect_tool): inspector (before cli)
  holds risk_map on the card against device="cpu" and block_riskiness's
  loop, times it on the 12-MP photo, and holds the quality sweep's
  encodes with the interactive loop's settings against device="cpu",
  counting each kernel's launches over the card's encodes (the kernels
  line's rows gain `inspector_launches`).  PIL is absent on the card's
  machine, so the decode-based views are held by tier-1 only.

One JSON line each.  Then the `kernels` line (each kernel's device
microseconds a launch from a torch.profiler trace beside its CUDA-event
times), the card's name and power limit, and last
{"ok": true, "device": {...}}.  Any failure raises and
exits non-zero; without CUDA it exits 1 before printing any result.
"""

import collections
import contextlib
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

BATCH, HEIGHT, WIDTH, QUALITY = 16, 1024, 1024, 75
SEED = 1234
DEVICE = "cuda"
H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_OPS_PER_S = 67e12          # 32-bit non-tensor rate (float32 entry)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def need(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def gpu_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def make_rgb(b: int, h: int, w: int, seed: int) -> np.ndarray:
    """Seeded noise over gradients, with saturated blue and red patches
    (chroma +128)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    grad = np.stack([xx * 255 // w, yy * 255 // h, (xx + yy) % 256], -1)
    img = np.empty((b, h, w, 3), np.uint8)
    for i in range(b):
        noise = rng.randint(-24 - 4 * i, 24 + 4 * i, (h, w, 3))
        img[i] = np.clip(grad + noise, 0, 255)
    img[:, :32, :32] = [0, 0, 255]
    img[:, -32:, -32:] = [255, 0, 0]
    return img


def method0(mode: int, quality: float = QUALITY):
    from sjpeg_tpu_torch.params import EncoderParam
    return EncoderParam(quality=quality, yuv_mode=mode,
                        huffman_compress=False, adaptive_quantization=False)


def method7(mode: int, quality: float = QUALITY):
    from sjpeg_tpu_torch.params import EncoderParam
    return EncoderParam(quality=quality, yuv_mode=mode, use_trellis=True)


def method4(mode: int, quality: float = QUALITY, method: int = 4):
    """Method 4 (the default toggles), or 1 (no adaptive quantization) or
    3 (no Huffman optimization)."""
    from sjpeg_tpu_torch.params import EncoderParam
    return EncoderParam(quality=quality, yuv_mode=mode,
                        adaptive_quantization=method != 1,
                        huffman_compress=method != 3)


def method_param(method: int, mode: int, quality: float = QUALITY):
    """Parameters of method 0, 1, 3, 4 or 7."""
    if method == 0:
        return method0(mode, quality)
    if method == 7:
        return method7(mode, quality)
    return method4(mode, quality, method)


def stateful_hook():
    """A custom SearchHook: bisection that starts 10 below the estimated
    quality for every image it has been set up for, state that runs
    across a batch."""
    from sjpeg_tpu_torch.params import SearchHook

    class Stateful(SearchHook):
        def __init__(self):
            self.images = 0

        def setup(self, param, initial_q):
            ok = super().setup(param, initial_q)
            self.images += 1
            self.q = max(self.qmin, min(self.qmax,
                                        initial_q - 10.0 * self.images))
            return ok

    return Stateful()


@contextlib.contextmanager
def plain_forced():
    """Patch the engine's kernel calls with the plain versions (this
    script only: the package itself never falls back).  fdct, quant_pack,
    the table build, the sharp sweeps and scan_stuff (its host route on
    the fetched words) are patched on their own modules, which every
    caller reads them from."""
    from sjpeg_tpu_torch.ops import (fdct, huffman_device, lambda_fit,
                                     merge_codesizes, quant_pack,
                                     sample_pack, scan_stuff, sharp_yuv,
                                     stream_concat, trellis, vlc_fields,
                                     vlc_pack)
    from sjpeg_tpu_torch.sharp_yuv import sharp_iterate_plain

    def stuff_on_host(words, totals):
        return tuple(t.to(words.device) for t in scan_stuff.scan_stuff_plain(
            words.cpu(), totals.cpu()))
    packs = dict(
        sample_pack=mock.Mock(sample_pack=sample_pack.sample_pack_plain),
        stream_concat=mock.Mock(
            stream_concat=stream_concat.stream_concat_plain))
    with mock.patch.multiple(
            "sjpeg_tpu_torch.engine", **packs,
            trellis=mock.Mock(
                trellis_quantize=trellis.trellis_quantize_plain),
            vlc_pack=mock.Mock(vlc_pack=vlc_pack.vlc_pack_plain)), \
            mock.patch.multiple("sjpeg_tpu_torch.engine_search", **packs), \
            mock.patch.object(merge_codesizes, "optimal_tables",
                              plain_tables), \
            mock.patch.object(fdct, "fdct_blocks", fdct.fdct_blocks_plain), \
            mock.patch.object(quant_pack, "quant_pack",
                              quant_pack.quant_pack_plain), \
            mock.patch.object(sharp_yuv, "sharp_iterate",
                              sharp_iterate_plain), \
            mock.patch.object(lambda_fit, "lambda_fit",
                              lambda_fit.lambda_fit_plain), \
            mock.patch.object(vlc_fields, "vlc_fields",
                              vlc_fields.vlc_fields_plain), \
            mock.patch.object(scan_stuff, "scan_stuff", stuff_on_host):
        yield


def plain_tables(jobs):
    """merge_codesizes.optimal_tables' results from the plain version."""
    from sjpeg_tpu_torch.ops import huffman_device
    return [huffman_device.optimal_code_luts_plain(f, size, lut, True)
            for f, size, lut in jobs]


def counted_wrappers() -> dict:
    """{kernel: its wrapper}, each wrapper counting its own launches in
    `.launches`."""
    from sjpeg_tpu_torch.ops import (fdct, lambda_fit, merge_codesizes,
                                     quant_pack, sample_pack, scan_stuff,
                                     stream_concat, trellis, vlc_fields,
                                     vlc_pack)
    from sjpeg_tpu_torch.ops import riskiness as risk_dev
    from sjpeg_tpu_torch.ops import sharp_yuv as sharp_ops
    return {"sharp_yuv": sharp_ops.sharp_iterate,
            "lambda_fit": lambda_fit.lambda_fit,
            "vlc_fields": vlc_fields.vlc_fields,
            "risk_stats": risk_dev.risk_stats,
            "sample_pack": sample_pack.sample_pack,
            "fdct": fdct.fdct_blocks,
            "merge_codesizes": merge_codesizes.optimal_tables,
            "vlc_pack": vlc_pack.vlc_pack,
            "quant_pack": quant_pack.quant_pack,
            "trellis": trellis.trellis_quantize,
            "stream_concat": stream_concat.stream_concat,
            "scan_stuff": scan_stuff.scan_stuff}


def run_counted(fn):
    """fn() with every kernel's count set to 0 just before it -> (its
    result, {kernel: launches in that call})."""
    counted = counted_wrappers()
    for k in counted.values():
        k.launches = 0
    out = fn()
    return out, {k: f.launches for k, f in counted.items()}


def host_words(words: torch.Tensor, totals_np) -> np.ndarray:
    """The used word columns of [B, bucket] stream words, fetched ->
    [B, ncols] uint32: what the host stuffing (native.words_to_scan)
    reads."""
    ncols = max(1, -(-int(totals_np.max()) // 32))
    return words[:, :ncols].contiguous().cpu().numpy().view(np.uint32)


def max_err(pairs) -> int:
    """Largest absolute difference over (kernel, plain) tensor pairs."""
    return max(int((a.long() - b.long()).abs().max()) for a, b in pairs)


def kernel_row(name, source, replaces, launches, err, ms, plain, nbytes,
               ops, **extra) -> dict:
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_OPS_PER_S * 1e3
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "bytes": nbytes, "operations": ops, **extra}


def event_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median of `reps` CUDA-event timings of fn()."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def device_kernels(fn, calls: int = 1) -> dict:
    """{name: {"launches": n, "us": t}} a call, for each kernel or memset
    that `calls` calls of fn ran on the card, from a torch.profiler trace
    taken after one untraced call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
            out[ev.key] = {"launches": ev.count / calls, "us": us / calls}
    return out


def global_names(source: str) -> list:
    """The __global__ functions of csrc/<source>.cu."""
    from sjpeg_tpu_torch import kernels
    return re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(",
        (kernels.CSRC / f"{source}.cu").read_text())


def source_trace(fn, source: str, calls: int = 5, trace=None,
                 tries: int = 3):
    """A device_kernels trace of fn (first the given one) that recorded a
    launch of a kernel of csrc/<source>.cu, with those launches' device
    microseconds, one launch each: a trace that recorded none is taken
    again, up to `tries` traces of fn; after that (None, [])."""
    names = global_names(source)
    for _ in range(tries):
        if trace is None:
            if fn is None:
                break
            trace = device_kernels(fn, calls)
        hits = [v["us"] / v["launches"] for k, v in trace.items()
                if v["launches"] and any(nm in k for nm in names)]
        if hits:
            return trace, hits
        trace = None
    print(f"source_trace: no {source} launch recorded in {tries} traces",
          flush=True)
    return None, []


def kernel_us(fn, source: str, calls: int = 5, trace=None, tries: int = 3):
    """Device microseconds of one launch of each kernel of csrc/<source>.cu
    that fn runs, summed over those kernels: the mean over the launches
    that torch.profiler recorded in `calls` calls (or first in a given
    device_kernels trace), which may be fewer than the calls made; from
    source_trace, so None, never 0, when no trace recorded a launch."""
    _, hits = source_trace(fn, source, calls, trace, tries)
    return sum(hits) if hits else None


def op_us(fn, source: str, calls: int = 5, trace=None, tries: int = 3):
    """Device microseconds of one call of fn, an op that launches each of
    its kernels and memsets once (a zero fill, then csrc/<source>.cu's
    kernel), summed over them: each one's time a launch, as kernel_us
    takes it, from a device_kernels trace (first the given one) that
    recorded a launch of the source, so that a trace that lost some calls'
    records still gives a call's time.  A trace that recorded no launch of
    the source, or something launched more than once a call, is taken
    again, up to `tries` traces of fn; after that the result is None."""
    names = global_names(source)
    for _ in range(tries):
        if trace is None:
            trace = device_kernels(fn, calls)
        if (any(any(nm in k for nm in names) for k in trace)
                and all(0 < v["launches"] <= 1 for v in trace.values())):
            return sum(v["us"] / v["launches"] for v in trace.values())
        trace = None
    print(f"op_us: no {source} op recorded in {tries} traces", flush=True)
    return None


def host_ms(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from sjpeg_tpu_torch import constants as C
    from sjpeg_tpu_torch import engine, kernels, pipeline, state
    from sjpeg_tpu_torch.huffman import k3_default_tables
    from sjpeg_tpu_torch.ops import (colorspace, fdct, merge_codesizes,
                                     quantize, sample_pack, scan_stuff,
                                     stream_concat, vlc_pack)

    dev = torch.device(DEVICE)
    card = gpu_name_and_limit()

    # ---- 1. probe -------------------------------------------------------
    nvcc = kernels.nvcc_path()
    nvcc_version = subprocess.run([nvcc, "--version"], capture_output=True,
                                  text=True, timeout=60).stdout
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    emit("probe", gpu=card, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, nvcc=nvcc,
         nvcc_version=nvcc_version.strip().splitlines()[-1],
         triton=triton_version, route="cuda")
    need(torch.cuda.device_count() >= 1, "a CUDA device")

    # ---- 2. build -------------------------------------------------------
    shutil.rmtree(kernels.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    logs = kernels.build_all()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_lib = kernels.host_library()
    host_build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for log in logs.values() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", seconds=build_s, libraries=sorted(logs), ptxas=ptxas,
         host_library=host_lib.name, host_build_seconds=host_build_s)
    need(sorted(logs) == kernels.kernel_names(), "every kernel built")

    # ---- 3. kernel parity at full size ----------------------------------
    rgb = make_rgb(BATCH, HEIGHT, WIDTH, SEED)
    param = method0(C.YUV_420)
    layout = pipeline.component_layout(C.YUV_420, WIDTH, HEIGHT)
    qms = engine._quant_matrices(param)
    tables = state.tables_from_numpy(*engine._quant_arrays(qms),
                                     *engine._host_luts(k3_default_tables()),
                                     dev)
    iq, ib = tables[0], tables[1]
    n_blocks = layout.mb_w * layout.mb_h * sum(layout.nb_blocks)
    bucket = int(min(n_blocks * 64, max(4096, WIDTH * HEIGHT * 4.0 / 32)))
    src = torch.from_numpy(rgb).to(dev)
    blocks = colorspace.rgb_to_blocks(src, C.YUV_420, WIDTH, HEIGHT)
    sinter, dc, group = engine._interleave_samples(
        blocks, iq, ib, tuple(layout.nb_blocks), BATCH)
    n = sinter.shape[0]

    words, bits = sample_pack.sample_pack(sinter, dc, group, *tables)
    pwords, pbits = sample_pack.sample_pack_plain(sinter, dc, group, *tables)
    torch.cuda.synchronize()
    err1 = max(int((words.long() - pwords.long()).abs().max()),
               int((bits - pbits).abs().max()))
    out, totals = stream_concat.stream_concat(words, bits, BATCH, bucket)
    pout, ptotals = stream_concat.stream_concat_plain(words, bits, BATCH,
                                                      bucket)
    torch.cuda.synchronize()
    err2 = max(int((out.long() - pout.long()).abs().max()),
               int((totals - ptotals).abs().max()))
    emit("parity", blocks=n, samples_dtype=str(sinter.dtype), bucket=bucket,
         sample_pack_max_abs_err=err1, stream_concat_max_abs_err=err2,
         total_bits=int(totals.long().sum()))
    need(err2 == 0, "stream_concat bit-exact against its plain version")
    edge_errs, edge_info = stream_concat_edges(dev)
    emit("sc_edges", max_abs_err=edge_errs, **edge_info)
    err2 = max(err2, *edge_errs.values())
    need(err2 == 0, "stream_concat bit-exact at its edges")
    long_errs, long_bits = long_stream_parity(dev)
    emit("sp_long_streams", max_abs_err=long_errs, max_bits=long_bits)
    err1 = max(err1, *(v for k, v in long_errs.items()
                       if k.startswith("sample_pack")))
    vlc_long_err = max(v for k, v in long_errs.items()
                       if k.startswith("vlc_pack"))
    qp_long_err = max(v for k, v in long_errs.items()
                      if k.startswith("quant_pack"))
    need(err1 == 0, "sample_pack bit-exact against its plain version")
    need(vlc_long_err == 0, "vlc_pack bit-exact on the longest streams")
    need(qp_long_err == 0, "quant_pack bit-exact on the longest streams")
    need(long_bits["sample_pack/full_pieces_shared"] == 2048
         and long_bits["vlc_pack/full_pieces_shared"] == 2048
         and long_bits["quant_pack/full_pieces_shared"] == 2048,
         "a block fills its row")
    need(int(totals.max()) <= bucket * 32, "config 1 fits its bucket")

    # ---- 4. main path ---------------------------------------------------
    counted = {"sample_pack": sample_pack.sample_pack,
               "stream_concat": stream_concat.stream_concat,
               "vlc_pack": vlc_pack.vlc_pack,
               "merge_codesizes": merge_codesizes.optimal_tables}
    for fn in counted.values():
        fn.launches = 0
    jpegs = engine.encode_batch(rgb, param, device=dev)
    launches = {k: fn.launches for k, fn in counted.items()}
    with plain_forced():
        plain_jpegs = engine.encode_batch(rgb, param, device=dev)
    same = jpegs == plain_jpegs
    emit("main_path", images=len(jpegs), launches=launches,
         bytes_total=sum(len(j) for j in jpegs), byte_equal_plain=same)
    need(launches["sample_pack"] > 0 and launches["stream_concat"] > 0,
         "main path ran both kernels")
    need(same, "main path bytes equal the plain-forced path")
    need(all(j[:2] == b"\xff\xd8" and j[-2:] == b"\xff\xd9" for j in jpegs),
         "SOI/EOI markers")

    # ---- other geometries, the overflow fallback, GPU vs CPU ------------
    cases = {}
    for name, mode, (b, h, w), q, budget in [
            ("444", C.YUV_444, (4, 512, 512), 75, 4.0),
            ("400", C.YUV_400, (4, 512, 512), 75, 4.0),
            ("420_1000x750", C.YUV_420, (4, 750, 1000), 75, 4.0),
            ("overflow", C.YUV_420, (2, 256, 256), 95, 0.0)]:
        img = make_rgb(b, h, w, SEED + len(cases) + 1)
        if name == "overflow":
            img[0] = np.random.RandomState(SEED).randint(0, 256, (h, w, 3))
        p = method0(mode, q)
        got = engine.encode_batch(img, p, budget, device=dev)
        with plain_forced():
            want = engine.encode_batch(img, p, budget, device=dev)
        cases[name] = got == want
        if name == "overflow":
            t = state.tables_from_numpy(
                *engine._quant_arrays(engine._quant_matrices(p)),
                *engine._host_luts(k3_default_tables()), dev)
            _, tot = engine.encode_batch_core(
                torch.from_numpy(img).to(dev), *t, yuv_mode=mode, width=w,
                height=h, nb_blocks=(4, 1, 1), bucket=4096)
            cases["overflow_happened"] = int(tot[0]) > 4096 * 32
    small = make_rgb(2, 40, 24, SEED)
    cases["gpu_equals_cpu"] = (engine.encode_batch(small, param, device=dev)
                               == engine.encode_batch(small, param,
                                                      device="cpu"))
    emit("cases", **cases)
    need(all(cases.values()), "every case byte-equal")

    # ---- 5. timing ------------------------------------------------------
    sp_fn = kernels.function("sample_pack", "sjpeg_sample_pack",
                             sample_pack._ARGTYPES)
    sc_fn = kernels.function("stream_concat", "sjpeg_stream_concat_scan",
                             stream_concat._ARGTYPES)
    sc_bufs = stream_concat.scratch(BATCH, n // BATCH, bucket, dev)
    stream = torch.cuda.current_stream().cuda_stream

    def launch_sample_pack():
        kernels.check(sp_fn(sinter.data_ptr(), sinter.element_size(),
                            dc.data_ptr(), group.data_ptr(),
                            *(t.data_ptr() for t in tables),
                            words.data_ptr(), bits.data_ptr(), n, n, 1,
                            stream), "sample_pack")

    def launch_stream_concat():     # the two launches, without the memset
        stream_concat.launch(sc_fn, words, bits, *sc_bufs)

    def stream_concat_op():
        return stream_concat.stream_concat(words, bits, BATCH, bucket)

    sp_ms = event_ms(launch_sample_pack, 20)
    sc_ms = event_ms(launch_stream_concat, 20)
    sc_op_ms = event_ms(stream_concat_op, 20)
    # the kernels that one op launches, from torch.profiler's trace
    sc_names = global_names("stream_concat")
    sc_trace, _ = source_trace(stream_concat_op, "stream_concat", calls=1)
    sc_kernel_launches = (sum(v["launches"] for k, v in sc_trace.items()
                              if any(nm in k for nm in sc_names))
                          if sc_trace else None)
    sp_plain_ms = event_ms(lambda: sample_pack.sample_pack_plain(
        sinter, dc, group, *tables), 3)
    sc_plain_ms = event_ms(lambda: stream_concat.stream_concat_plain(
        words, bits, BATCH, bucket), 3)
    e2e_ms = host_ms(lambda: engine.encode_batch(rgb, param, device=dev), 5)
    mpx = BATCH * HEIGHT * WIDTH / 1e6
    emit("timing", gpu=card, sample_pack_ms=sp_ms,
         sample_pack_plain_ms=sp_plain_ms, stream_concat_ms=sc_ms,
         stream_concat_op_ms=sc_op_ms, stream_concat_plain_ms=sc_plain_ms,
         stream_concat_op_device_kernels=sc_trace,
         encode_batch_ms=e2e_ms,
         encode_batch_mpx_per_s=mpx / (e2e_ms / 1e3), megapixels=mpx)

    # ---- breakdown of one encode_batch, host clock, synchronised --------
    stages = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        stages[name] = (time.perf_counter() - t0) * 1e3
        return r

    s = stage("h2d", lambda: torch.from_numpy(rgb).to(dev))
    bl = stage("colour_blockize", lambda: colorspace.rgb_to_blocks(
        s, C.YUV_420, WIDTH, HEIGHT))
    si, d, g = stage("interleave_dc_chain", lambda: engine._interleave_samples(
        bl, iq, ib, tuple(layout.nb_blocks), BATCH))
    w_, b_ = stage("sample_pack", lambda: sample_pack.sample_pack(
        si, d, g, *tables))
    o_, t_ = stage("stream_concat", lambda: stream_concat.stream_concat(
        w_, b_, BATCH, bucket))
    sc_, ln_ = stage("scan_stuff", lambda: scan_stuff.scan_stuff(o_, t_))

    def fetch_scans():
        tn, ln = torch.stack([t_, ln_]).cpu().numpy()
        return tn, engine.fetch_scan_rows(sc_, ln)

    tn, scans = stage("fetch", fetch_scans)
    stage("host_tail", lambda: [engine._assemble_jpeg(
        layout, param, qms, k3_default_tables(), sc) for sc in scans])
    emit("breakdown", gpu=card, ms=stages,
         fetched_bytes=int(len(scans) * max(map(len, scans))))
    tail_inputs = (host_words(o_, tn), tn, stages["host_tail"])

    # ---- kernels line ---------------------------------------------------
    used_words = int(((bits.long() + 31) // 32).sum())
    ac_nonzero = int((quantize.quantize_values(
        fdct.fdct_blocks(sinter), iq.long()[group.long()],
        ib.long()[group.long()])[:, 1:] != 0).sum())
    # bytes: each input read once, each output written once
    sp_bytes = (n * 64 * sinter.element_size() + 8 * n
                + 4 * sum(t.numel() for t in tables) + n * 64 * 4 + 4 * n)
    # 32-bit operations: ~1,250 for the fDCT, ~7 per coefficient to
    # quantize and test, ~20 per coded coefficient to code and pack
    sp_ops = n * (1250 + 63 * 7) + ac_nonzero * 20
    # stream_concat, the whole op: the used words and the counts read once,
    # the zeroed output and the totals written once, the chunk sums written
    # and read; ~8 operations a used word to join and store it, ~20 a block
    # to scan and place
    sc_bytes = (used_words * 4 + 4 * n + BATCH * bucket * 4 + 4 * BATCH
                + 8 * sc_bufs[1].numel())
    sc_ops = used_words * 8 + n * 20
    rows = [
        kernel_row("sample_pack", "sjpeg_tpu_torch/csrc/sample_pack.cu",
                   "sjpeg_tpu/ops/pallas_quant_pack.py:340",
                   launches["sample_pack"], err1, sp_ms, sp_plain_ms,
                   sp_bytes, sp_ops,
                   device_us=kernel_us(launch_sample_pack, "sample_pack")),
        kernel_row("stream_concat", "sjpeg_tpu_torch/csrc/stream_concat.cu",
                   "sjpeg_tpu/ops/pallas_tree_concat.py:371",
                   launches["stream_concat"], err2, sc_op_ms, sc_plain_ms,
                   sc_bytes, sc_ops, kernel_ms=sc_ms,
                   kernel_launches_per_op=sc_kernel_launches,
                   device_us=kernel_us(stream_concat_op, "stream_concat",
                                       trace=sc_trace),
                   redesigned=True)]
    del words, bits, pwords, pbits, out, pout, sinter, blocks, src
    torch.cuda.empty_cache()
    rows += method4_phases(card, rgb, vlc_long_err)
    torch.cuda.empty_cache()
    rows.append(lambda_fit_phase(card, rgb))
    torch.cuda.empty_cache()
    rows.append(vlc_fields_phase(card, rgb, logs))
    torch.cuda.empty_cache()
    rows.append(scan_stuff_phase(card, rgb, logs))
    torch.cuda.empty_cache()
    by_name = {r["name"]: r for r in rows}
    tr_rows, tr_table_err = trellis_phases(card, rgb)
    by_name["merge_codesizes"]["max_abs_err"] = max(
        by_name["merge_codesizes"]["max_abs_err"], tr_table_err)
    rows += tr_rows
    by_name.update((r["name"], r) for r in tr_rows)
    torch.cuda.empty_cache()
    search_row, rate_launches, search_host = search_phases(card, rgb)
    by_name["trellis"]["search_per_image_rate_launches"] = rate_launches
    rows.append(search_row)
    torch.cuda.empty_cache()
    rows += single_phases(card, rgb, qp_long_err)
    torch.cuda.empty_cache()
    serving_phases(card, rgb)
    torch.cuda.empty_cache()
    rows += auto_sharp_phases(card, rgb, logs)
    torch.cuda.empty_cache()
    sharded = sharded_phases(card, rgb)
    torch.cuda.empty_cache()
    sharded_search = sharded_search_phase(card, rgb)
    for row in rows:
        if row["name"] in sharded:
            row["sharded_launches"] = sharded[row["name"]]
        if row["name"] in sharded_search:
            row["sharded_search_launches"] = sharded_search[row["name"]]
    torch.cuda.empty_cache()
    host_native_phase(card, rgb, host_build_s, tail_inputs, search_host)
    torch.cuda.empty_cache()
    profiling_phase(card, rgb)
    torch.cuda.empty_cache()
    inspector = inspector_phase(card)
    for row in rows:
        if row["name"] in inspector:
            row["inspector_launches"] = inspector[row["name"]]
    cli_phase()
    # the kernels redesigned for the H100 since their port, with each
    # instance's registers, spills, shared memory and stack from ptxas
    by_name = {r["name"]: r for r in rows}
    for name, lib, entries in (
            ("sample_pack", "sample_pack", ["sample_pack_kernelIsLi1E"]),
            ("sample_pack_per_image", "sample_pack",
             ["sample_pack_kernelIsLi2E"]),
            ("trellis", "trellis", global_names("trellis"))):
        by_name[name]["redesigned"] = True
        by_name[name]["ptxas"] = {e: ptxas_info(logs.get(lib, ""), e)
                                  for e in entries}
    print(json.dumps({"kernels": rows}), flush=True)
    print(gpu_name_and_limit(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def long_stream_parity(dev):
    """sample_pack, vlc_pack and quant_pack against their plain versions on
    the longest streams: full int16-range samples (quant_pack: full
    int16-range coefficients) at q100 with the K.3 tables,
    and LUTs whose every piece is 32 bits (code lengths 32 - size), where a
    block with every position coded fills all 2,048 bits of its word row
    (no stream is longer: at most 64 pieces of at most 32 bits);
    vlc_pack also on runs longer than the positions they skip, whose ZRLs
    carry its in-place stream past fields still to be read.  Shared
    tables, and per-image sets over images of 48 blocks, so that a CTA's
    128 rows span three or four sets.  Returns ({kernel/case: max abs
    error}, {kernel/case: the longest stream in bits})."""
    from sjpeg_tpu_torch import constants as C
    from sjpeg_tpu_torch import engine, state
    from sjpeg_tpu_torch.huffman import k3_default_tables
    from sjpeg_tpu_torch.ops import quant_pack, sample_pack, vlc, vlc_pack

    rng = np.random.RandomState(SEED + 500)
    n_img, per_img = 64, 48
    n = n_img * per_img
    samples = torch.from_numpy(rng.randint(-32768, 32768, (n, 64))).to(
        dev, torch.int16)
    dc = vlc.dc_diff_codes(torch.from_numpy(
        rng.randint(-2047, 2048, n)).to(dev), n_img)
    group = torch.from_numpy((np.arange(n) % 6 >= 4).astype(np.int32)).to(
        dev)
    quants = [engine._quant_arrays(engine._quant_matrices(
        method0(C.YUV_420, q))) for q in (100, 95, 90, 85)]
    size = np.arange(256) & 15
    full = (np.stack([(rng.randint(0, 1 << 16, 16) << 16)
                      | (32 - np.arange(16))] * 2),
            np.stack([(rng.randint(0, 1 << 16, 256) << 16) | (32 - size)]
                     * 2))
    # vlc_pack's fields: every position coded in a third of the rows
    q = rng.randint(-2047, 2048, (n, 64)) * (rng.rand(n, 64) < 0.5)
    q[::3] = rng.choice([-1, 1], (len(q[::3]), 64)) * rng.randint(
        1, 2048, (len(q[::3]), 64))
    rl = vlc.run_levels(torch.from_numpy(q).to(dev), torch.int32)
    long_runs = torch.where(rl["size"] > 0, torch.from_numpy(
        rng.randint(0, 64, (n, 64)).astype(np.int32)).to(dev), 0)
    coeffs = torch.from_numpy(rng.randint(-32768, 32768, (n, 64)).astype(
        np.int32)).to(dev)
    errs, longest = {}, {}
    for lut_name, luts in (("k3", engine._host_luts(k3_default_tables())),
                           ("full_pieces", full)):
        for sets in ("shared", "per_image"):
            if sets == "shared":
                arrays = (*quants[0], *luts)
            else:
                arrays = (*(np.stack([quants[i % 4][k] for i in range(n_img)])
                            for k in range(2)),
                          *(np.stack([a] * n_img) for a in luts))
            t = state.tables_from_numpy(*arrays, dev)
            runs = [("", rl["run"])]
            if lut_name == "full_pieces":
                runs.append(("_long_runs", long_runs))
            for suffix, run in runs:
                args = (run, rl["size"], rl["code"], dc, group, *t[2:])
                got = vlc_pack.vlc_pack(*args)
                want = vlc_pack.vlc_pack_plain(*args)
                torch.cuda.synchronize()
                key = f"vlc_pack/{lut_name}_{sets}{suffix}"
                errs[key] = max_err(zip(got, want))
                longest[key] = int(got[1].max())
            got = sample_pack.sample_pack(samples, dc, group, *t)
            want = sample_pack.sample_pack_plain(samples, dc, group, *t)
            torch.cuda.synchronize()
            errs[f"sample_pack/{lut_name}_{sets}"] = max_err(zip(got, want))
            longest[f"sample_pack/{lut_name}_{sets}"] = int(got[1].max())
            if sets == "shared":         # quant_pack takes one table set
                got = quant_pack.quant_pack(coeffs, dc, group, *t)
                want = quant_pack.quant_pack_plain(coeffs, dc, group, *t)
                torch.cuda.synchronize()
                key = f"quant_pack/{lut_name}_shared"
                errs[key] = max_err(zip(got, want))
                longest[key] = int(got[1].max())
    return errs, longest


def random_streams(rng, lens):
    """[N, 64] int32 words of random bits left-aligned per block, zero past
    each block's count `lens` [N]."""
    words = rng.randint(0, 1 << 32, (len(lens), 64), dtype=np.uint64)
    keep = np.clip(lens[:, None] - 32 * np.arange(64)[None, :], 0,
                   32).astype(np.uint64)
    one = np.uint64(1)
    mask = ((one << keep) - one) << (np.uint64(32) - keep)
    return (words & mask).astype(np.uint32).view(np.int32)


def stream_concat_edges(dev):
    """stream_concat against its plain version where its scan and its
    placement meet their edges: one 4032 x 3024 4:2:0 image (285,768
    blocks, 1,117 chunks in one image, at the single-image bucket of 64
    words a block), images of 48 blocks (shorter than a chunk), totals past
    the bucket, all-empty blocks, and 2,048-bit rows.  Block lengths mix
    empty, short and full streams.  Returns ({case: max abs error},
    {"cases": {case: [images, blocks an image, bucket, largest total]}})."""
    from sjpeg_tpu_torch.ops import stream_concat

    rng = np.random.RandomState(SEED + 800)
    errs, info = {}, {}
    for name, n_img, per_img, bucket in [
            ("one_image_4032x3024", 1, 285_768, 285_768 * 64),
            ("images_of_48", 64, 48, 4096),
            ("overflow", 4, 700, 64),
            ("all_empty", 8, 700, 4096),
            ("full_rows", 3, 700, 700 * 64)]:
        n = n_img * per_img
        lens = rng.randint(0, 400, n)
        lens[rng.rand(n) < 0.2] = 0
        lens[rng.rand(n) < 0.02] = 2048
        if name == "all_empty":
            lens[:] = 0
        elif name == "full_rows":
            lens[:] = 2048
        words = torch.from_numpy(random_streams(rng, lens)).to(dev)
        bits = torch.from_numpy(lens.astype(np.int32)).to(dev)
        got = stream_concat.stream_concat(words, bits, n_img, bucket)
        want = stream_concat.stream_concat_plain(words, bits, n_img, bucket)
        torch.cuda.synchronize()
        errs[name] = max_err(zip(got, want))
        info[name] = [n_img, per_img, bucket, int(want[1].max())]
        del words, bits, got, want
    need(info["overflow"][3] > 64 * 32, "the overflow case passes its bucket")
    return errs, {"cases": info}


def adversarial_freq_rows(size: int, width: int, seed: int) -> np.ndarray:
    """[145, width] int32 frequency rows (symbols in the first `size`
    columns) of every kind a table build meets, in this order: ties
    everywhere (row 0) and over half the symbols, an empty row (2), one
    symbol at either end (3, 4), two symbols, Fibonacci rows whose codes
    pass 16 and 32 bits (the rebalance and the clamp), shuffled and with
    symbol 0 the most frequent (6-11), values near 2^30, 12 rows whose
    sums wrap past 2^31 (13-24: the table kernel's 64-bit keys; the fake
    symbol can land before symbol 0 there), then 120 skewed rows."""
    rng = np.random.RandomState(seed)
    fib = [1, 1]
    while len(fib) < 60:
        fib.append(fib[-1] + fib[-2])
    rows = [np.full(size, 5), np.where(rng.rand(size) < 0.5, 7, 0),
            np.zeros(size, np.int64)]
    for at in (0, size - 1):
        one = np.zeros(size, np.int64)
        one[at] = 3
        rows.append(one)
    two = np.zeros(size, np.int64)
    two[[0, size - 1]] = 2
    rows.append(two)
    for n in (24, 40, 60):
        m = min(n, size)
        r = np.zeros(size, np.int64)
        r[rng.permutation(size)[:m]] = fib[:m]
        rows.append(r)
        r = np.zeros(size, np.int64)
        r[:m] = fib[:m][::-1]
        rows.append(r)
    big = rng.randint(0, 4, size)
    big[:3] = [(1 << 30) - 1, 1 << 29, (1 << 28) + 5]
    rows.append(big)
    for _ in range(12):
        r = np.zeros(size, np.int64)
        n = rng.randint(3, size + 1)
        r[rng.permutation(size)[:n]] = rng.randint(1 << 29, 1 << 31, n)
        rows.append(r)
    for _ in range(120):
        r = (rng.pareto(0.4 + 2 * rng.rand(), size)
             * rng.randint(1, 5000)).astype(np.int64)
        rows.append(np.minimum(r * (rng.rand(size) < rng.rand()),
                               (1 << 31) - 1))
    freq = np.zeros((len(rows), width), np.int32)
    freq[:, :size] = np.stack(rows)
    return freq


def table_parity(dev) -> dict:
    """The table kernel against optimal_code_luts_plain on the adversarial
    rows: DC (12 symbols in 16 slots), AC (256 in 320 and in 257), and DC
    and AC in one launch.  Returns {case: max abs error}."""
    from sjpeg_tpu_torch.ops import merge_codesizes

    jobs = {name: (torch.from_numpy(adversarial_freq_rows(
        size, width, SEED + 900 + width)).to(dev), size, lut)
        for name, size, width, lut in [("dc", 12, 16, 16),
                                       ("ac", 256, 320, 256),
                                       ("ac_257", 256, 257, 256)]}
    errs = {}
    for name, job in jobs.items():
        got = merge_codesizes.optimal_tables([job])[0]
        errs[name] = max_err(zip(got, plain_tables([job])[0]))
    both = [jobs["dc"], jobs["ac"]]
    errs["dc_ac_one_launch"] = max(
        max_err(zip(g, w)) for g, w in zip(merge_codesizes.optimal_tables(
            both), plain_tables(both)))
    torch.cuda.synchronize()
    return errs


def trellis_edge_cases(cinter, group, mats, lt_img) -> dict:
    """The ranked trellis op against its plain version on inputs cut from
    the method-7 batch's first 24,576 rows (one image's worth): 48 images
    of 512 blocks (far more images than the two whose sets a search CTA
    stages), 512 images of 48 blocks (under 128: a CTA's rows span three
    or more images), each with the batch's per-image matrices and rate
    tables in turn; all-zero blocks (every search CTA writes DC-only rows);
    and the rows with every other 1,024-row range zeroed (mixed CTAs).
    Returns {case: max abs error}."""
    from sjpeg_tpu_torch.ops import trellis

    rows = 24576
    c, g = cinter[:rows].contiguous(), group[:rows].contiguous()
    zeroed = c.clone()
    for s in range(0, rows, 2048):
        zeroed[s:s + 1024] = 0
    errs = {}
    for name, coeffs, n_img in [("images_48x512", c, 48),
                                ("images_512x48", c, 512),
                                ("all_zero", torch.zeros_like(c), 16),
                                ("half_zero", zeroed, 16)]:
        sets = [t[torch.arange(n_img, device=t.device) % t.shape[0]]
                .contiguous() for t in (*mats, lt_img)]
        got = trellis.trellis_quantize(coeffs, *sets[:3], g, sets[3], n_img)
        want = trellis.trellis_quantize_plain(coeffs, *sets[:3], g, sets[3],
                                              n_img)
        torch.cuda.synchronize()
        errs[name] = max_err([(got, want)])
    return errs


def trellis_ranking(cinter, group, iquant, ibias, quant, lt) -> dict:
    """The ranking the op ran on the card (its scratch after one call with
    per-image matrices) against a stable sort of the rows by their count of
    nonzero bias-quantized AC values, heaviest first, computed here with
    torch: the order of the rows with a coded AC position (class 0's are
    the work pass's and not placed), their count, the chunks' class
    histograms, their starts within each class and the class totals."""
    from sjpeg_tpu_torch import kernels
    from sjpeg_tpu_torch.ops import trellis

    n = cinter.shape[0]
    buf = trellis.scratch(n, cinter.device)
    out = torch.empty_like(cinter)
    trellis.launch(kernels.function("trellis", "sjpeg_trellis_ranked",
                                    trellis._ARGTYPES),
                   cinter, iquant, ibias, quant, group, lt, out, buf, BATCH)
    hist, starts, totals, order, count, _ = trellis.scratch_parts(buf, n)
    img = torch.arange(n, device=cinter.device) // (n // BATCH)
    cls = torch.empty(n, dtype=torch.int64, device=cinter.device)
    for s in range(0, n, 32768):
        e = min(n, s + 32768)
        iq, ib = (trellis.rows_from_mats(m, group[s:e], img[s:e])
                  for m in (iquant, ibias))
        v0 = trellis._bias_quantized(cinter[s:e].to(torch.int64).abs(),
                                     iq, ib)
        cls[s:e] = (v0[:, 1:] > 0).sum(1)
    placed = int((cls > 0).sum())
    want = torch.argsort(-cls, stable=True)[:placed]   # the check's own
    want_hist = class_histograms(cls, *trellis.scratch_layout(n)[7:])
    counts = want_hist.sum(1)
    return {"order_equal": bool(torch.equal(order[:placed].long(), want)),
            "placed_equal": int(count) == placed,
            "histograms_equal": bool(torch.equal(hist.long(), want_hist)),
            "starts_equal": bool(torch.equal(
                starts.long(), want_hist.cumsum(1) - want_hist)),
            "totals_equal": bool(torch.equal(totals.long(), counts)),
            "zero_class_rows": int(counts[0]),
            "classes_present": int((counts > 0).sum())}


def class_histograms(cls: torch.Tensor, chunk: int,
                     classes: int) -> torch.Tensor:
    """[n] classes -> [classes, n_chunks] int64 counts of each class in
    each chunk of `chunk` rows."""
    n = cls.shape[0]
    nc = -(-n // chunk)
    out = torch.zeros(classes * nc, dtype=torch.int64, device=cls.device)
    out.index_add_(0, cls * nc + torch.arange(n, device=cls.device) // chunk,
                   torch.ones_like(cls))
    return out.view(classes, nc)


def method4_inputs(rgb: np.ndarray):
    """The method-4 batch's vlc_pack arguments and symbol frequencies, as
    its encode_batch stages them: (fields: run, size, code, DC codes,
    groups; its per-image DC and AC LUTs; the K.3 LUTs; the DC and AC
    frequencies of its table build)."""
    from sjpeg_tpu_torch import constants as C
    from sjpeg_tpu_torch import engine, pipeline, state
    from sjpeg_tpu_torch.huffman import k3_default_tables
    from sjpeg_tpu_torch.params import method_flags

    dev = torch.device(DEVICE)
    b, h, w = rgb.shape[:3]
    param = method4(C.YUV_420)
    nb = tuple(pipeline.component_layout(C.YUV_420, w, h).nb_blocks)
    src = torch.from_numpy(rgb).to(dev)
    coeffs, histos = engine._stage_batch_coeffs(src, "rgb", C.YUV_420, w, h,
                                                True, b)
    iq, ib, _ = engine._fit_on_device(histos, param,
                                      method_flags(param.method), 2, False,
                                      dev)
    vlc_state, freqs = engine._stage_batch_quantize(coeffs, iq, ib, True, nb,
                                                    b, b)
    del coeffs, src
    dcl, acl, _, _ = engine._stage_tables(freqs, method_flags(param.method),
                                          2, b, False, dev)
    k3 = state.arrays_to_device(*engine._host_luts(k3_default_tables()),
                                device=dev)
    rl, dc, group = vlc_state
    fields = (rl["run"], rl["size"], rl["code"], dc, group)
    return fields, (dcl, acl), k3, freqs


def method4_phases(card: str, rgb: np.ndarray, vlc_long_err: int) -> list:
    """The method-4 path on the same batch: tables, m4_parity, m4_path,
    m4_cases, m4_timing and m4_breakdown; returns the kernel rows of
    vlc_pack (its error including sp_long_streams' vlc_pack cases,
    vlc_long_err) and merge_codesizes (its error including the
    adversarial rows)."""
    from sjpeg_tpu_torch import constants as C
    from sjpeg_tpu_torch import engine, kernels, pipeline
    from sjpeg_tpu_torch.ops import (huffman_device, merge_codesizes,
                                     sample_pack, scan_stuff, stream_concat,
                                     vlc_pack)
    from sjpeg_tpu_torch.params import method_flags

    dev = torch.device(DEVICE)
    param = method4(C.YUV_420)
    flags = method_flags(param.method)
    layout = pipeline.component_layout(C.YUV_420, WIDTH, HEIGHT)
    nb = tuple(layout.nb_blocks)
    bucket = engine._bucket(layout, WIDTH, HEIGHT, 4.0)

    # ---- tables: the table kernel on rows of every kind -----------------
    table_errs = table_parity(dev)
    emit("tables", max_abs_err=table_errs)
    need(max(table_errs.values()) == 0,
         "the table kernel exact against its plain version (every row kind)")

    # ---- m4_parity: the path's own inputs, each kernel vs plain ---------
    fields, (dcl, acl), (k3_dcl, k3_acl), freqs = method4_inputs(rgb)
    n = fields[3].shape[0]
    jobs = huffman_device.table_jobs(freqs[0].reshape(BATCH, 2, -1),
                                     freqs[1].reshape(BATCH, 2, -1))
    tables = merge_codesizes.optimal_tables(jobs)
    err_tables = max(max_err(zip(g, w)) for g, w in zip(
        tables, plain_tables(jobs)))

    words, bits = vlc_pack.vlc_pack(*fields, dcl, acl)
    pwords, pbits = vlc_pack.vlc_pack_plain(*fields, dcl, acl)
    torch.cuda.synchronize()
    err_sets = max_err([(words, pwords), (bits, pbits)])
    del pwords
    swords, sbits = vlc_pack.vlc_pack(*fields, k3_dcl, k3_acl)
    pswords, psbits = vlc_pack.vlc_pack_plain(*fields, k3_dcl, k3_acl)
    torch.cuda.synchronize()
    err_shared = max_err([(swords, pswords), (sbits, psbits)])
    del swords, pswords
    emit("m4_parity", blocks=n, bucket=bucket,
         vlc_pack_per_image_max_abs_err=err_sets,
         vlc_pack_shared_max_abs_err=err_shared,
         merge_codesizes_shapes=[list(j[0].shape) for j in jobs],
         merge_codesizes_max_abs_err=err_tables,
         total_bits=int(bits.long().sum()))
    need(err_sets == 0 and err_shared == 0,
         "vlc_pack bit-exact against its plain version (both LUT variants)")
    need(err_tables == 0,
         "the table kernel exact against its plain version (DC and AC)")

    # ---- m4_path --------------------------------------------------------
    counted = {"vlc_pack": vlc_pack.vlc_pack,
               "merge_codesizes": merge_codesizes.optimal_tables,
               "stream_concat": stream_concat.stream_concat,
               "sample_pack": sample_pack.sample_pack}
    for fn in counted.values():
        fn.launches = 0
    huffman_device.optimal_code_luts.any_reads = 0
    jpegs = engine.encode_batch(rgb, param, device=dev)
    launches = {k: fn.launches for k, fn in counted.items()}
    any_reads = huffman_device.optimal_code_luts.any_reads
    with plain_forced():
        plain_jpegs = engine.encode_batch(rgb, param, device=dev)
    same = jpegs == plain_jpegs
    emit("m4_path", images=len(jpegs), launches=launches,
         any_reads=any_reads, bytes_total=sum(len(j) for j in jpegs),
         byte_equal_plain=same)
    need(all(launches[k] > 0 for k in ("vlc_pack", "merge_codesizes",
                                       "stream_concat")),
         "the method-4 path ran vlc_pack, merge_codesizes, stream_concat")
    need(launches["merge_codesizes"] == 1 and any_reads == 0,
         "one table launch a batch, with no host read")
    need(same, "method-4 bytes equal the plain-forced path")
    need(all(j[:2] == b"\xff\xd8" and j[-2:] == b"\xff\xd9" for j in jpegs),
         "SOI/EOI markers")

    # ---- m4_cases -------------------------------------------------------
    cases = {}
    for name, mode, (b, h, w), q, method, share, budget in [
            ("method1", C.YUV_420, (4, 512, 512), 75, 1, False, 4.0),
            ("method3", C.YUV_420, (4, 512, 512), 75, 3, False, 4.0),
            ("shared_statistics", C.YUV_420, (4, 512, 512), 75, 4, True, 4.0),
            ("444", C.YUV_444, (4, 512, 512), 75, 4, False, 4.0),
            ("400", C.YUV_400, (4, 512, 512), 75, 4, False, 4.0),
            ("420_1000x750", C.YUV_420, (4, 750, 1000), 75, 4, False, 4.0),
            ("nv12", C.YUV_420, (4, 512, 512), 75, 4, False, 4.0),
            ("overflow_per_image", C.YUV_420, (2, 256, 256), 95, 4, False,
             0.0),
            ("overflow_shared", C.YUV_420, (2, 256, 256), 95, 4, True, 0.0)]:
        img = make_rgb(b, h, w, SEED + 100 + len(cases))
        if name.startswith("overflow"):
            img[0] = np.random.RandomState(SEED).randint(0, 256, (h, w, 3))
        p = method4(mode, q, method)

        def run():
            if name == "nv12":
                y = img[..., 0]
                uv = np.stack([img[:, ::2, ::2, 1], img[:, ::2, ::2, 2]], -1)
                return engine.encode_batch_nv12(y, uv, p, budget,
                                                device=dev)
            return engine.encode_batch(img, p, budget, share, device=dev)

        with mock.patch.object(engine, "_repack_one",
                               wraps=engine._repack_one) as spy:
            got = run()
        with plain_forced():
            cases[name] = got == run()
        if name.startswith("overflow"):
            cases[name + "_repacked"] = spy.call_count >= 1
    small = make_rgb(2, 40, 24, SEED)
    for share in (False, True):
        cases["gpu_equals_cpu" + ("_shared" if share else "")] = (
            engine.encode_batch(small, param, share_statistics=share,
                                device=dev)
            == engine.encode_batch(small, param, share_statistics=share,
                                   device="cpu"))
    emit("m4_cases", **cases)
    need(all(cases.values()), "every method-4 case byte-equal")

    # ---- m4_timing ------------------------------------------------------
    vp_fn = kernels.function("vlc_pack", "sjpeg_vlc_pack", vlc_pack._ARGTYPES)
    mc_fn = kernels.function("merge_codesizes", "sjpeg_optimal_tables",
                             merge_codesizes._ARGTYPES)
    stream = torch.cuda.current_stream().cuda_stream

    def launch_vlc_pack(dl, al, n_sets):
        kernels.check(vp_fn(*(t.data_ptr() for t in fields), dl.data_ptr(),
                            al.data_ptr(), words.data_ptr(), bits.data_ptr(),
                            n, n // n_sets, n_sets, stream), "vlc_pack")

    def launch_tables():            # the one launch, into the same buffers
        merge_codesizes.launch(mc_fn, jobs, tables)

    def tables_op():                # as _stage_tables runs it
        return huffman_device.luts_and_desc_from_freqs(
            freqs[0].reshape(BATCH, 2, -1), freqs[1].reshape(BATCH, 2, -1))

    vp_ms = event_ms(lambda: launch_vlc_pack(dcl, acl, BATCH), 20)
    vp_shared_ms = event_ms(lambda: launch_vlc_pack(k3_dcl, k3_acl, 1), 20)
    mc_ms = event_ms(launch_tables, 20)
    mc_op_ms = event_ms(tables_op, 20)
    vp_plain_ms = event_ms(lambda: vlc_pack.vlc_pack_plain(*fields, dcl, acl),
                           3)
    mc_plain_ms = event_ms(lambda: plain_tables(jobs), 3)
    mc_us = kernel_us(launch_tables, "merge_codesizes")
    mc_op_trace, _ = source_trace(tables_op, "merge_codesizes")
    vp_us = kernel_us(lambda: launch_vlc_pack(dcl, acl, BATCH), "vlc_pack")
    e2e_ms = host_ms(lambda: engine.encode_batch(rgb, param, device=dev), 5)
    mpx = BATCH * HEIGHT * WIDTH / 1e6
    emit("m4_timing", gpu=card, vlc_pack_ms=vp_ms,
         vlc_pack_shared_ms=vp_shared_ms, vlc_pack_plain_ms=vp_plain_ms,
         vlc_pack_device_us=vp_us, merge_codesizes_ms=mc_ms,
         merge_codesizes_op_ms=mc_op_ms, merge_codesizes_plain_ms=mc_plain_ms,
         merge_codesizes_device_us=mc_us,
         merge_codesizes_op_device_kernels=mc_op_trace,
         encode_batch_ms=e2e_ms, encode_batch_mpx_per_s=mpx / (e2e_ms / 1e3),
         megapixels=mpx)

    # ---- m4_breakdown: one encode_batch, host clock, synchronised -------
    stages = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        stages[name] = (time.perf_counter() - t0) * 1e3
        return r

    s = stage("h2d", lambda: torch.from_numpy(rgb).to(dev))
    co, hi = stage("colour_fdct_histograms", lambda: engine._stage_batch_coeffs(
        s, "rgb", C.YUV_420, WIDTH, HEIGHT, True, BATCH))
    qa = stage("fit", lambda: engine._fit_on_device(
        hi, param, flags, 2, False, dev))
    vs, fr = stage("quantize_interleave_stats", lambda: (
        engine._stage_batch_quantize(co, *qa[:2], True, nb, BATCH, BATCH)))
    del co
    huffman_device.optimal_code_luts.any_reads = 0
    dl, al, _, desc = stage("tables", lambda: engine._stage_tables(
        fr, flags, 2, BATCH, False, dev))
    any_reads = huffman_device.optimal_code_luts.any_reads
    w_, b_ = stage("vlc_pack", lambda: vlc_pack.vlc_pack(
        vs[0]["run"], vs[0]["size"], vs[0]["code"], vs[1], vs[2], dl, al))
    o_, t_ = stage("stream_concat", lambda: stream_concat.stream_concat(
        w_, b_, BATCH, bucket))

    sc_, ln_ = stage("scan_stuff", lambda: scan_stuff.scan_stuff(o_, t_))

    def fetch():
        _, ln = torch.stack([t_, ln_]).cpu().numpy()
        return (engine.fetch_scan_rows(sc_, ln), desc.cpu().numpy(),
                engine._host_matrices(qa[2], param, BATCH))

    scans, flat, qms = stage("fetch", fetch)
    stage("host_tail", lambda: [engine._assemble_jpeg(
        layout, param, qms[i], huffman_device.tables_from_flat(flat, i, 2),
        scans[i]) for i in range(BATCH)])
    emit("m4_breakdown", gpu=card, ms=stages, any_reads=any_reads,
         fetched_bytes=int(len(scans) * max(map(len, scans))))

    # ---- kernel rows ----------------------------------------------------
    coded = (fields[1][:, 1:] > 0)
    n_coded = int(coded.sum())
    n_zrl = int(torch.where(coded, fields[0][:, 1:] >> 4, 0).sum())
    lut_bytes = 4 * (dcl.numel() + acl.numel())
    # each input read once (three [N, 64] int32 fields, DC codes, groups,
    # the per-image LUTs), each output written once (64 words, 1 count)
    vp_bytes = 3 * 4 * n * 64 + 8 * n + lut_bytes + 4 * n * 64 + 4 * n
    # 32-bit operations: ~4 per position to stage the fields and their
    # mask, ~20 per coded coefficient and ~8 per ZRL to look up and pack,
    # ~30 a block for the DC code, EOB and flush
    vp_ops = n * (64 * 4 + 30) + n_coded * 20 + n_zrl * 8
    # the table build: each row's `size` frequencies read once (the kernel
    # reads no padding column), the LUTs, counts, symbol counts and DHT
    # orders written once; operations for the merge
    # steps this run's rows take (the fake's and one a symbol more), ~2 a
    # live key for the argmin-2 and ~4 a slot for the code-size update,
    # and ~40 a symbol for the ranks, codes and writes
    mc_bytes = mc_ops = 0
    for (freq, size, lut_size), out in zip(jobs, tables):
        g = freq.shape[0]
        mc_bytes += 4 * (g * size + sum(t.numel() for t in out))
        nbs = out[2].long().cpu()
        mc_ops += int((nbs * (nbs + 1) + 4 * (size + 1) * nbs).sum()
                      + 40 * size * g)
    return [
        kernel_row("vlc_pack", "sjpeg_tpu_torch/csrc/vlc_pack.cu",
                   "sjpeg_tpu/ops/pallas_vlc_pack.py:534",
                   launches["vlc_pack"],
                   max(err_sets, err_shared, vlc_long_err), vp_ms,
                   vp_plain_ms, vp_bytes, vp_ops, shared_ms=vp_shared_ms,
                   device_us=vp_us, coded_positions=n_coded,
                   redesigned=True),
        kernel_row("merge_codesizes", "sjpeg_tpu_torch/csrc/merge_codesizes.cu",
                   "sjpeg_tpu/ops/huffman_device.py:101",
                   launches["merge_codesizes"],
                   max(err_tables, *table_errs.values()),
                   mc_ms, mc_plain_ms, mc_bytes, mc_ops, op_ms=mc_op_ms,
                   device_us=mc_us, longest_chain=int(max(
                       int(t[2].max()) for t in tables)),
                   redesigned=True)]


def lambda_fit_phase(card: str, rgb: np.ndarray) -> dict:
    """lambda_fit on the main batch's histograms: the kernel against its
    plain twin (the host route) per image and shared, with one and two
    groups; its device microseconds a launch (16 images x 2 groups) beside
    the bin sums' bound, CUDA-event ms and the host route's ms; then, in
    the entries of the three benchmark cells (encode_batch of a 16 x 1024^2 AUTO batch of
    four modes with the default param, encode_rgb of a 12-MP photo,
    method 0's encode_batch), the kernel's launches and the host fits a
    request runs.  Returns the kernels-line row."""
    from sjpeg_tpu_torch import adaptive, engine
    from sjpeg_tpu_torch import constants as C
    from sjpeg_tpu_torch.ops import lambda_fit
    from sjpeg_tpu_torch.params import EncoderParam

    dev = torch.device(DEVICE)
    b, h, w = rgb.shape[:3]
    param = method4(C.YUV_420)
    _, histos = engine._stage_batch_coeffs(torch.from_numpy(rgb).to(dev),
                                           "rgb", C.YUV_420, w, h, True, b)
    base = engine._quant_matrices(param)
    args = (np.stack([base[0]["quant"], base[1]["quant"]]),
            param.resolved_min_quant_matrices(),
            (param.qdelta_max_luma, param.qdelta_max_chroma),
            param.quantization_bias)
    shared = tuple(x.sum(0, dtype=torch.int32) for x in histos)
    errs = {}
    for name, hh in (("per_image", histos), ("shared", shared)):
        for n_groups in (1, 2):
            got = lambda_fit.lambda_fit(*hh, *args, n_groups)
            want = lambda_fit.lambda_fit_plain(*hh, *args, n_groups)
            torch.cuda.synchronize()
            errs[f"{name}_{n_groups}_groups"] = max_err(zip(got, want))

    def fit():
        return lambda_fit.lambda_fit(*histos, *args, 2)

    device_us = kernel_us(fit, "lambda_fit")
    ms = event_ms(fit, 20)
    plain = host_ms(lambda: lambda_fit.lambda_fit_plain(*histos, *args, 2), 3)
    auto, photo = four_mode_batch(1024, 4), make_rgb(1, 3024, 4032,
                                                     SEED + 600)[0]
    entries = {
        "default_batch": lambda: engine.encode_batch(auto, EncoderParam(),
                                                     device=dev),
        "photo": lambda: engine.encode_rgb(photo, EncoderParam(),
                                           device=dev),
        "m0_batch": lambda: engine.encode_batch(rgb, method0(C.YUV_420),
                                                device=dev)}
    per_request = {}
    for name, call in entries.items():
        with mock.patch.object(adaptive, "analyse_histo",
                               wraps=adaptive.analyse_histo) as host_fit:
            call()
            lambda_fit.lambda_fit.launches = 0
            host_fit.reset_mock()
            call()
            per_request[name] = {
                "lambda_fit_launches": lambda_fit.lambda_fit.launches,
                "host_fits": host_fit.call_count}
    emit("lambda_fit", gpu=card, images=b, max_abs_err=errs,
         device_us=device_us, ms=ms, plain_ms=plain,
         per_request=per_request)
    need(max(errs.values()) == 0,
         "lambda_fit exact against the host route (per image and shared)")
    need(per_request["default_batch"]["lambda_fit_launches"] == 4
         and per_request["photo"]["lambda_fit_launches"] == 1
         and per_request["m0_batch"]["lambda_fit_launches"] == 0
         and all(v["host_fits"] == 0 for v in per_request.values()),
         "one fit launch a sub-batch and no host fit in the cells' entries")
    n_pairs = b * 2 * 64 * C.QSIZE
    return kernel_row(
        "lambda_fit", "csrc/lambda_fit.cu",
        "none: adaptive.analyse_histo (host NumPy in the JAX package)",
        per_request["default_batch"]["lambda_fit_launches"],
        max(errs.values()), ms, plain,
        histos[0].numel() * 4 * 2 + 3 * b * 2 * 64 * 4,
        n_pairs * C.MAX_HISTO_DCT_COEFF * 4, device_us=device_us,
        per_request=per_request)


def vlc_fields_phase(card: str, rgb: np.ndarray, logs: dict) -> dict:
    """vlc_fields on the main batch's interleaved coefficients (method 4:
    per-image quantizer sets and stats images, and one shared set) and on
    the trellis's levels of the same rows (method 7), with and without
    counts and with a `valid` mask, and on a 12-MP photo's: the kernel
    against its plain twin; its device microseconds a launch at 16 x
    1024^2 and on the photo beside the bytes' bound, CUDA-event ms and the
    plain twin's ms; each instance's registers, spills and shared memory;
    its launches a request in the entries of the benchmark cells (the
    default AUTO batch, the photo at methods 4 and 7, method 0's batch).
    Returns the kernels-line row."""
    from sjpeg_tpu_torch import constants as C
    from sjpeg_tpu_torch import engine, pipeline
    from sjpeg_tpu_torch.ops import trellis, vlc_fields
    from sjpeg_tpu_torch.params import EncoderParam, method_flags

    dev = torch.device(DEVICE)
    param = method4(C.YUV_420)
    flags = method_flags(param.method)

    def staged(img: np.ndarray, per_image: bool):
        """(interleaved coefficients, DC codes, groups, quantizer rows,
        the trellis's levels of the rows) of a batch."""
        b, h, w = img.shape[:3]
        nb = tuple(pipeline.component_layout(C.YUV_420, w, h).nb_blocks)
        coeffs, histos = engine._stage_batch_coeffs(
            torch.from_numpy(img).to(dev), "rgb", C.YUV_420, w, h, True,
            b if per_image else 1)
        iq, ib, quant = engine._fit_on_device(histos, param, flags, 2,
                                              not per_image, dev)
        cinter, dc, group = engine._interleave_coeffs(coeffs, iq, ib, nb, b)
        levels = trellis.trellis_quantize(cinter, iq, ib, quant, group,
                                          engine._cost_lens(dev), b)
        return cinter, dc, group, (iq, ib), levels

    photo = make_rgb(1, 3024, 4032, SEED + 600)
    inputs = {"batch": staged(rgb, True), "batch_shared": staged(rgb, False),
              "photo": staged(photo, False)}
    errs = {}
    for name, (cinter, dc, group, quant, levels) in inputs.items():
        b = rgb.shape[0] if name == "batch" else 1
        valid = (torch.arange(dc.shape[0], device=dev) % 7 != 3)
        for form, rows, q in (("coefficients", cinter, quant),
                              ("levels", levels, ())):
            for stats, v in ((True, None), (True, valid), (False, None)):
                kw = dict(stats_images=b, valid=v, with_stats=stats)
                got, gf = vlc_fields.vlc_fields(rows, dc, group, *q, **kw)
                want, wf = vlc_fields.vlc_fields_plain(rows, dc, group, *q,
                                                       **kw)
                torch.cuda.synchronize()
                pairs = [(got[k], want[k]) for k in ("run", "size", "code")]
                errs[f"{name}/{form}/stats={stats}/valid={v is not None}"] = \
                    max_err(pairs + (list(zip(gf, wf)) if stats else []))

    def launch(name: str, form: str):
        cinter, dc, group, quant, levels = inputs[name]
        b = rgb.shape[0] if name == "batch" else 1
        if form == "levels":
            return lambda: vlc_fields.vlc_fields(levels, dc, group,
                                                 stats_images=b)
        return lambda: vlc_fields.vlc_fields(cinter, dc, group, *quant,
                                             stats_images=b)

    timing = {}
    for name in ("batch", "photo"):
        for form in ("coefficients", "levels"):
            fn = launch(name, form)
            timing[f"{name}/{form}"] = {
                "device_us": kernel_us(fn, "vlc_fields"),
                "ms": event_ms(fn, 20)}
        cinter, dc, group, quant, _ = inputs[name]
        b = rgb.shape[0] if name == "batch" else 1
        timing[f"{name}/coefficients"]["plain_ms"] = host_ms(
            lambda: vlc_fields.vlc_fields_plain(cinter, dc, group, *quant,
                                                stats_images=b), 3)
        timing[f"{name}/rows"] = int(dc.shape[0])
    auto = four_mode_batch(1024, 4)
    entries = {
        "default_batch": lambda: engine.encode_batch(auto, EncoderParam(),
                                                     device=dev),
        "photo": lambda: engine.encode_rgb(photo[0], EncoderParam(),
                                           device=dev),
        "m7_photo": lambda: engine.encode_rgb(
            photo[0], EncoderParam(use_trellis=True), device=dev),
        "m0_batch": lambda: engine.encode_batch(rgb, method0(C.YUV_420),
                                                device=dev)}
    per_request = {}
    for name, call in entries.items():
        call()
        vlc_fields.vlc_fields.launches = 0
        call()
        per_request[name] = vlc_fields.vlc_fields.launches
    ptxas = {e: ptxas_info(logs.get("vlc_fields", ""), e)
             for e in ("vlc_fields_kernelILb1E", "vlc_fields_kernelILb0E")}
    emit("vlc_fields", gpu=card, max_abs_err=errs, timing=timing,
         launches_per_request=per_request, ptxas=ptxas)
    need(max(errs.values()) == 0,
         "vlc_fields exact against its plain twin in both forms")
    need(per_request == {"default_batch": 4, "photo": 1, "m7_photo": 1,
                         "m0_batch": 0},
         "one vlc_fields launch a sub-batch or staged image, none in "
         "method 0")
    n = timing["batch/rows"]
    return kernel_row(
        "vlc_fields", "csrc/vlc_fields.cu",
        "none: the interleaved quantize + grouped stats (XLA glue in the "
        "JAX package's engine)", per_request["default_batch"],
        max(errs.values()), timing["batch/coefficients"]["ms"],
        timing["batch/coefficients"]["plain_ms"],
        n * (64 * 4 + 3 * 64 * 4 + 2 * 4), 0,
        device_us=timing["batch/coefficients"]["device_us"], timing=timing,
        per_request=per_request, ptxas=ptxas)


def scan_stuff_phase(card: str, rgb: np.ndarray, logs: dict) -> dict:
    """scan_stuff on the main batch's method-0 streams (16 x 1024^2 4:2:0,
    the engine's bucket) and on a 12-MP photo's (4:2:0, the staged path's
    worst-case bucket of 64 words a block): every row exact against
    native.words_to_scan on the fetched words; the op's device µs a call
    (both launches, torch.profiler) beside its bound (the used words and
    totals read, the tile counts written and read, the stuffed bytes and
    lengths written, over 3.35 TB/s), its CUDA-event ms, the host
    stuffing's ms on the same rows, and the ms of what the host tail does
    with the fetched rows instead: each row joined to its headers and EOI
    (the one copy of each scan into its JPEG's bytes); then, in the
    entries of the four benchmark cells, its launches a request (each
    cell's first pool input from the benchmark's generator at this
    script's seed, and its configuration's param).  Returns the
    kernels-line row."""
    from sjpeg_tpu_torch import engine, headers, native, pipeline, state
    from sjpeg_tpu_torch import constants as C
    from sjpeg_tpu_torch.huffman import k3_default_tables
    from sjpeg_tpu_torch.ops import scan_stuff
    from benchmark import harness
    from benchmark.gen import photo as gen

    dev = torch.device(DEVICE)
    op = scan_stuff.scan_stuff
    param = method0(C.YUV_420)
    tables = state.tables_from_numpy(
        *engine._quant_arrays(engine._quant_matrices(param)),
        *engine._host_luts(k3_default_tables()), dev)
    photo = make_rgb(1, 3024, 4032, SEED + 600)
    errs, timing = {}, {}
    for name, img in (("batch", rgb), ("photo", photo)):
        b, h, w = img.shape[:3]
        layout = pipeline.component_layout(C.YUV_420, w, h)
        bucket = (engine._bucket(layout, w, h, 4.0) if name == "batch" else
                  engine._blocks_per_image(layout) * 64)
        words, totals = engine.encode_batch_core(
            torch.from_numpy(img).to(dev), *tables, yuv_mode=C.YUV_420,
            width=w, height=h, nb_blocks=tuple(layout.nb_blocks),
            bucket=bucket, n_images=b)
        scan, lengths = op(words, totals)
        tn, ln = torch.stack([totals, lengths]).cpu().numpy()
        got = engine.fetch_scan_rows(scan, ln)
        wn = host_words(words, tn)
        bits = [scan_stuff.scan_bits(t, bucket) for t in tn]

        def host_stuffing():
            return [native.words_to_scan(wn[i], bits[i]) for i in range(b)]

        head = bytes(engine._jpeg_headers(
            layout, param, engine._quant_matrices(param),
            k3_default_tables()))

        def join():
            return [b"".join((head, row, headers.EOI)) for row in got]

        want = host_stuffing()
        errs[name] = sum(g.tobytes() != x for g, x in zip(got, want))
        raw = sum((x + 7) // 8 for x in bits)
        tiles = sum(-(-((x + 7) // 8) // 4096) for x in bits)
        nbytes = 4 * sum((x + 31) // 32 for x in bits) + 8 * b \
            + 8 * tiles + int(ln.sum())
        call = (lambda words=words, totals=totals: op(words, totals))
        timing[name] = {
            "images": b, "bucket_words": bucket, "scan_bytes": raw,
            "stuffed_bytes": int(ln.sum()), "ff_bytes": int(ln.sum()) - raw,
            "used_tiles": tiles, "device_us": kernel_us(call, "scan_stuff"),
            "ms": event_ms(call, 20), "host_ms": host_ms(host_stuffing, 3),
            "join_ms": host_ms(join, 5), "bytes": nbytes,
            "bound_us": nbytes / H100_BYTES_PER_S * 1e6}
        del words, totals, scan, lengths
    cells = {"m0_batch": "sjpeg-m0-420-q75.batch16x1024",
             "default_batch": "sjpeg-default-q75.batch16x1024",
             "photo": "sjpeg-default-q75.photo12mp",
             "m7_photo": "sjpeg-m7-q75.photo12mp"}
    per_request = {}
    for name, workload in cells.items():
        cell = harness.load_cell(workload)     # the cell's input and param
        x = gen.pool({**cell.traffic, "pool": 1}, SEED, dev)[0]
        p = harness.port_param(cell.config)
        if cell.traffic["entry"] == "encode_batch":
            call = (lambda x=x, p=p: engine.encode_batch(x, p, device=dev))
        else:
            call = (lambda x=x, p=p: engine.encode_rgb(x[0], p, device=dev))
        call()
        op.launches = 0
        call()
        per_request[name] = {"launches": op.launches}
    ptxas = {e: ptxas_info(logs.get("scan_stuff", ""), e)
             for e in global_names("scan_stuff")}
    emit("scan_stuff", gpu=card, wrong_rows=errs, timing=timing,
         per_request=per_request, ptxas=ptxas)
    need(max(errs.values()) == 0,
         "scan_stuff exact against words_to_scan on every row")
    need({k: v["launches"] for k, v in per_request.items()}
         == {"m0_batch": 1, "default_batch": 4, "photo": 1, "m7_photo": 1},
         "one scan_stuff launch a batch, sub-batch or image")
    t = timing["batch"]
    return kernel_row(
        "scan_stuff", "csrc/scan_stuff.cu",
        "none: native.words_to_scan (host C++ in the JAX package)",
        per_request["m0_batch"]["launches"], max(errs.values()), t["ms"],
        t["host_ms"], t["bytes"], 0, device_us=t["device_us"],
        timing=timing, per_request=per_request, ptxas=ptxas)


def trellis_phases(card: str, rgb: np.ndarray) -> list:
    """The method-7 path on the same batch: tr_parity, tr_path, tr_cases,
    tr_timing and tr_breakdown; returns the trellis kernel row and the
    table kernel's error on the trellis's frequencies."""
    from sjpeg_tpu_torch import constants as C
    from sjpeg_tpu_torch import engine, kernels, pipeline, state
    from sjpeg_tpu_torch.huffman import trellis_cost_lens
    from sjpeg_tpu_torch.ops import (huffman_device, merge_codesizes,
                                     sample_pack, scan_stuff, stream_concat,
                                     trellis, vlc_pack)
    from sjpeg_tpu_torch.params import method_flags

    dev = torch.device(DEVICE)
    param = method7(C.YUV_420)
    flags = method_flags(param.method)
    need(param.method == 7 and flags["use_trellis"], "method 7 is trellis")
    layout = pipeline.component_layout(C.YUV_420, WIDTH, HEIGHT)
    nb = tuple(layout.nb_blocks)
    bucket = engine._bucket(layout, WIDTH, HEIGHT, 4.0)

    # ---- tr_parity: the path's own inputs, kernel vs plain --------------
    src = torch.from_numpy(rgb).to(dev)
    coeffs, histos = engine._stage_batch_coeffs(
        src, "rgb", C.YUV_420, WIDTH, HEIGHT, True, BATCH)
    iq, ib, qq = engine._fit_on_device(histos, param, flags, 2, False, dev)
    (lt,) = state.arrays_to_device(trellis_cost_lens(), device=dev)
    cinter, dc, group = engine._interleave_coeffs(coeffs, iq, ib, nb, BATCH)
    del coeffs, src
    n = cinter.shape[0]
    levels = trellis.trellis_quantize(cinter, iq, ib, qq, group, lt, BATCH)
    # per-image rate tables as a search pass would have them: the optimal
    # AC code lengths of each image's own trellis statistics
    _, freqs = engine._stage_trellis_post(levels, dc, group, True, BATCH)
    jobs = huffman_device.table_jobs(freqs[0].reshape(BATCH, 2, -1),
                                     freqs[1].reshape(BATCH, 2, -1))
    table_err = max(max_err(zip(g, w)) for g, w in zip(
        merge_codesizes.optimal_tables(jobs), plain_tables(jobs)))
    _, acl, _, _ = engine._stage_tables(freqs, flags, 2, BATCH, False, dev)
    lt_img = (acl & 0xFF).contiguous()
    variants = {"per_image_mats": (iq, ib, qq, lt),
                "shared_mats": (iq[0], ib[0], qq[0], lt),
                "per_image_rates": (iq, ib, qq, lt_img)}
    errs = {}
    for name, (a, b, q, r) in variants.items():
        got = trellis.trellis_quantize(cinter, a, b, q, group, r, BATCH)
        want = trellis.trellis_quantize_plain(cinter, a, b, q, group, r,
                                              BATCH)
        torch.cuda.synchronize()
        errs[name] = max_err([(got, want)])
        del got, want
    errs.update(trellis_edge_cases(cinter, group, (iq, ib, qq), lt_img))
    ranking = trellis_ranking(cinter, group, iq, ib, qq, lt)
    evaluations = trellis.search_evaluations(cinter, iq, ib, group, BATCH)
    emit("tr_parity", blocks=n, max_abs_err=errs,
         table_max_abs_err=table_err, ranking=ranking,
         nonzero_ac_levels=int((levels[:, 1:] != 0).sum()),
         evaluated_scores=evaluations)
    need(all(e == 0 for e in errs.values()),
         "trellis bit-exact against its plain version (every variant)")
    need(ranking["order_equal"] and ranking["placed_equal"]
         and ranking["histograms_equal"] and ranking["starts_equal"]
         and ranking["totals_equal"],
         "the trellis op's ranking is the stable heaviest-first order")
    need(table_err == 0, "the table kernel exact on method 7's frequencies")

    # ---- tr_path --------------------------------------------------------
    counted = {"trellis": trellis.trellis_quantize,
               "vlc_pack": vlc_pack.vlc_pack,
               "merge_codesizes": merge_codesizes.optimal_tables,
               "stream_concat": stream_concat.stream_concat,
               "sample_pack": sample_pack.sample_pack}
    for fn in counted.values():
        fn.launches = 0
    jpegs = engine.encode_batch(rgb, param, device=dev)
    launches = {k: fn.launches for k, fn in counted.items()}
    with plain_forced():
        plain_jpegs = engine.encode_batch(rgb, param, device=dev)
    same = jpegs == plain_jpegs
    m4_bytes = sum(len(j) for j in engine.encode_batch(
        rgb, method4(C.YUV_420), device=dev))
    emit("tr_path", images=len(jpegs), launches=launches,
         bytes_total=sum(len(j) for j in jpegs), method4_bytes_total=m4_bytes,
         byte_equal_plain=same)
    need(all(launches[k] > 0 for k in ("trellis", "merge_codesizes",
                                       "vlc_pack", "stream_concat")),
         "the method-7 path ran trellis, merge_codesizes, vlc_pack, "
         "stream_concat")
    need(same, "method-7 bytes equal the plain-forced path")
    need(all(j[:2] == b"\xff\xd8" and j[-2:] == b"\xff\xd9" for j in jpegs),
         "SOI/EOI markers")

    # ---- tr_cases -------------------------------------------------------
    cases = {}
    for name, mode, (b, h, w), q, share, budget in [
            ("shared_statistics", C.YUV_420, (4, 512, 512), 75, True, 4.0),
            ("444", C.YUV_444, (4, 512, 512), 75, False, 4.0),
            ("400", C.YUV_400, (4, 512, 512), 75, False, 4.0),
            ("420_1000x750", C.YUV_420, (4, 750, 1000), 75, False, 4.0),
            ("nv12", C.YUV_420, (4, 512, 512), 75, False, 4.0),
            ("q40", C.YUV_420, (4, 512, 512), 40, False, 4.0),
            ("q90", C.YUV_420, (4, 512, 512), 90, False, 4.0),
            ("overflow", C.YUV_420, (2, 256, 256), 95, False, 0.0)]:
        img = make_rgb(b, h, w, SEED + 200 + len(cases))
        if name == "overflow":
            img[0] = np.random.RandomState(SEED).randint(0, 256, (h, w, 3))
        p = method7(mode, q)

        def run():
            if name == "nv12":
                y = img[..., 0]
                uv = np.stack([img[:, ::2, ::2, 1], img[:, ::2, ::2, 2]], -1)
                return engine.encode_batch_nv12(y, uv, p, budget,
                                                device=dev)
            return engine.encode_batch(img, p, budget, share, device=dev)

        with mock.patch.object(engine, "_repack_one",
                               wraps=engine._repack_one) as spy:
            got = run()
        with plain_forced():
            cases[name] = got == run()
        if name == "overflow":
            cases["overflow_repacked"] = spy.call_count >= 1
    small = make_rgb(2, 40, 24, SEED)
    for share in (False, True):
        cases["gpu_equals_cpu" + ("_shared" if share else "")] = (
            engine.encode_batch(small, param, share_statistics=share,
                                device=dev)
            == engine.encode_batch(small, param, share_statistics=share,
                                   device="cpu"))
    emit("tr_cases", **cases)
    need(all(cases.values()), "every method-7 case byte-equal")

    # ---- tr_timing ------------------------------------------------------
    # the op's four launches into preallocated scratch, and the whole op
    # (validation, scratch and output allocation) as the engine calls it
    tr_fn = kernels.function("trellis", "sjpeg_trellis_ranked",
                             trellis._ARGTYPES)
    buf = trellis.scratch(n, dev)

    def launch_trellis(a, b, q, r, coeffs=cinter):
        trellis.launch(tr_fn, coeffs, a, b, q, group, r, levels, buf, BATCH)

    tr_ms = {k: event_ms(lambda v=v: launch_trellis(*v), 20)
             for k, v in variants.items()}
    tr_ms["op"] = event_ms(lambda: trellis.trellis_quantize(
        cinter, iq, ib, qq, group, lt, BATCH), 20)
    # all-zero blocks open no node: the op's cost without a search
    zeros = torch.zeros_like(cinter)
    tr_ms["zero_blocks"] = event_ms(lambda: launch_trellis(
        *variants["per_image_mats"], coeffs=zeros), 20)
    del zeros
    tr_trace, tr_hits = source_trace(
        lambda: launch_trellis(*variants["per_image_mats"]), "trellis")
    tr_steps_us = {nm: v["us"] / v["launches"]
                   for nm, v in (tr_trace or {}).items()
                   if v["launches"] and "trellis" in nm}
    tr_us = sum(tr_hits) if tr_hits else None
    tr_plain_ms = event_ms(lambda: trellis.trellis_quantize_plain(
        cinter, iq, ib, qq, group, lt, BATCH), 3)
    e2e_ms = host_ms(lambda: engine.encode_batch(rgb, param, device=dev), 5)
    mpx = BATCH * HEIGHT * WIDTH / 1e6
    emit("tr_timing", gpu=card, trellis_ms=tr_ms, trellis_plain_ms=tr_plain_ms,
         encode_batch_ms=e2e_ms, encode_batch_mpx_per_s=mpx / (e2e_ms / 1e3),
         megapixels=mpx)

    # ---- tr_breakdown: one encode_batch, host clock, synchronised -------
    stages = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        stages[name] = (time.perf_counter() - t0) * 1e3
        return r

    s = stage("h2d", lambda: torch.from_numpy(rgb).to(dev))
    co, hi = stage("colour_fdct_histograms", lambda: engine._stage_batch_coeffs(
        s, "rgb", C.YUV_420, WIDTH, HEIGHT, True, BATCH))
    i_, b_, q_ = stage("fit", lambda: engine._fit_on_device(
        hi, param, flags, 2, False, dev))
    (l_,) = state.arrays_to_device(trellis_cost_lens(), device=dev)
    ci, dcc, gr = stage("trellis_prep", lambda: engine._interleave_coeffs(
        co, i_, b_, nb, BATCH))
    del co
    lv = stage("trellis", lambda: trellis.trellis_quantize(
        ci, i_, b_, q_, gr, l_, BATCH))
    vs, fr = stage("trellis_post_stats", lambda: engine._stage_trellis_post(
        lv, dcc, gr, True, BATCH))
    huffman_device.optimal_code_luts.any_reads = 0
    dl, al, _, desc = stage("tables", lambda: engine._stage_tables(
        fr, flags, 2, BATCH, False, dev))
    any_reads = huffman_device.optimal_code_luts.any_reads
    w_, bb = stage("vlc_pack", lambda: vlc_pack.vlc_pack(
        vs[0]["run"], vs[0]["size"], vs[0]["code"], vs[1], vs[2], dl, al))
    o_, t_ = stage("stream_concat", lambda: stream_concat.stream_concat(
        w_, bb, BATCH, bucket))

    sc_, ln_ = stage("scan_stuff", lambda: scan_stuff.scan_stuff(o_, t_))

    def fetch():
        _, ln = torch.stack([t_, ln_]).cpu().numpy()
        return (engine.fetch_scan_rows(sc_, ln), desc.cpu().numpy(),
                engine._host_matrices(q_, param, BATCH))

    scans, flat, qms = stage("fetch", fetch)
    stage("host_tail", lambda: [engine._assemble_jpeg(
        layout, param, qms[i], huffman_device.tables_from_flat(flat, i, 2),
        scans[i]) for i in range(BATCH)])
    emit("tr_breakdown", gpu=card, ms=stages, any_reads=any_reads,
         fetched_bytes=int(len(scans) * max(map(len, scans))))

    # ---- kernel row -----------------------------------------------------
    # each input read once (coefficients, groups, per-image matrices, rate
    # table), the [N, 64] levels written once
    tr_bytes = (4 * n * 64 + 4 * n + 4 * sum(t.numel() for t in (iq, ib, qq))
                + 4 * lt.numel() + 4 * n * 64)
    # 32-bit operations: ~15 per evaluated (candidate, predecessor) score
    # (run, rate lookup, bits, multiply-add, compare, select), ~10 per
    # position for the block's energy and bias-quantize pass
    tr_ops = evaluations * 15 + n * 63 * 10
    return [kernel_row("trellis", "sjpeg_tpu_torch/csrc/trellis.cu",
                       "sjpeg_tpu/ops/pallas_trellis.py:319",
                       launches["trellis"], max(errs.values()),
                       tr_ms["per_image_mats"], tr_plain_ms, tr_bytes,
                       tr_ops, variant_ms=tr_ms, device_us=tr_us,
                       device_us_by_kernel=tr_steps_us,
                       evaluated_scores=evaluations)], table_err


def search_inputs(img: np.ndarray, mode: int, quals) -> tuple:
    """sample_pack's per-image arguments for a batch on the card, as a
    size-search pass builds them: int16 samples, each image's own
    quantizers (quality quals[i]) and its own optimal tables."""
    from sjpeg_tpu_torch import constants as C
    from sjpeg_tpu_torch import engine, engine_search, pipeline
    from sjpeg_tpu_torch.ops import huffman_device
    from sjpeg_tpu_torch.params import quant_matrices_for_quality

    b, h, w = img.shape[:3]
    nb = tuple(pipeline.component_layout(mode, w, h).nb_blocks)
    prep = engine_search._stage_search_prep(
        torch.from_numpy(img).to(DEVICE), "rgb", mode, w, h, nb, b, False,
        True)
    qn = torch.from_numpy(np.stack([quant_matrices_for_quality(q)
                                    for q in quals]).astype(np.int32))
    iq3, ib3 = engine_search._derive_quant_arrays(qn.to(DEVICE),
                                                  C.DEFAULT_BIAS)
    dc = engine._dc_codes(prep["coeffs"], iq3, ib3, nb, b)
    _, freqs = engine._stage_batch_quantize(prep["coeffs"], iq3, ib3, True,
                                            nb, b, b, dc_codes=dc)
    dcl, acl, _, _ = huffman_device.luts_and_desc_from_freqs(
        freqs[0].reshape(b, 2, -1), freqs[1].reshape(b, 2, -1),
        2 if len(nb) > 1 else 1)
    return prep["sinter"], dc, prep["group"], iq3, ib3, dcl, acl


def search_phases(card: str, rgb: np.ndarray):
    """The batched target-size search on the same batch: search_parity,
    search_path, search_cases, search_timing and search_breakdown; returns
    the per-image sample_pack row, the trellis's [B, 2, 256] rate-table
    launches in the method-7 search, and the host stages for host_native
    (the search breakdown, the node fit in C++ and one image's luma by
    adaptive.analyse_histo per pair)."""
    from sjpeg_tpu_torch import constants as C
    from sjpeg_tpu_torch import adaptive, engine, engine_search, kernels
    from sjpeg_tpu_torch.dichotomy import build_q_tree
    from sjpeg_tpu_torch.ops import (fdct, merge_codesizes, quantize,
                                     sample_pack, stream_concat, trellis,
                                     vlc_pack)
    from sjpeg_tpu_torch.params import quant_matrices_for_quality

    dev = torch.device(DEVICE)
    target, passes = 200_000, 8
    param = method4(C.YUV_420).set_target_size(target, passes=passes)

    # ---- search_parity: the per-image kernel vs its plain version -------
    quals = [40 + 3 * i for i in range(BATCH)]        # 16 distinct sets
    args = search_inputs(rgb, C.YUV_420, quals)
    n = args[0].shape[0]
    words, bits = sample_pack.sample_pack(*args)
    pwords, pbits = sample_pack.sample_pack_plain(*args)
    torch.cuda.synchronize()
    errs = {"16x1024x1024": max_err([(words, pwords), (bits, pbits)])}
    del pwords
    for name, (b, h, w) in [("4x1000x750", (4, 750, 1000)),
                            ("24x40x24", (24, 24, 40))]:
        small_args = search_inputs(make_rgb(b, h, w, SEED + 300 + b),
                                   C.YUV_420, [30 + 5 * i for i in range(b)])
        errs[name] = max_err([(x, y) for x, y in zip(
            sample_pack.sample_pack(*small_args),
            sample_pack.sample_pack_plain(*small_args))])
        errs[name + "_blocks_per_image"] = small_args[0].shape[0] // b
    emit("search_parity", blocks=n, sets=BATCH, max_abs_err=errs,
         total_bits=int(bits.long().sum()))
    need(all(v == 0 for k, v in errs.items() if "blocks" not in k),
         "per-image sample_pack bit-exact against its plain version")

    # ---- search_path ----------------------------------------------------
    counted = {"sample_pack": sample_pack.sample_pack,
               "stream_concat": stream_concat.stream_concat,
               "merge_codesizes": merge_codesizes.optimal_tables,
               "vlc_pack": vlc_pack.vlc_pack,
               "trellis": trellis.trellis_quantize}
    runs = []
    loop_fn = engine_search._stage_search_loop_size

    def spy_loop(*a, **k):
        out = loop_fn(*a, **k)
        runs.append(out[-1])
        return out

    for fn in counted.values():
        fn.launches = 0
    sample_pack.sample_pack.per_image_launches = 0
    with mock.patch.object(engine_search, "_stage_search_loop_size",
                           spy_loop):
        jpegs = engine.encode_batch(rgb, param, device=dev)
    launches = {k: fn.launches for k, fn in counted.items()}
    per_image = sample_pack.sample_pack.per_image_launches
    with plain_forced():
        plain_jpegs = engine.encode_batch(rgb, param, device=dev)
    same = jpegs == plain_jpegs
    sizes = [len(j) for j in jpegs]
    within = [abs(s - target) < target / 100 for s in sizes]
    emit("search_path", images=len(jpegs), target_bytes=target,
         passes=passes, passes_run=runs, launches=launches,
         sample_pack_per_image_launches=per_image, sizes=sizes,
         within_tolerance=sum(within), byte_equal_plain=same)
    need(len(runs) == 1 and per_image == runs[0] == launches["sample_pack"],
         "one per-image sample_pack launch per executed pass")
    need(launches["stream_concat"] == runs[0]
         and launches["merge_codesizes"] == runs[0],
         "stream_concat and the table kernel once a pass")
    need(same, "search bytes equal the plain-forced path")
    need(all(j[:2] == b"\xff\xd8" and j[-2:] == b"\xff\xd9" for j in jpegs),
         "SOI/EOI markers")
    need(all(abs(s - target) < 0.25 * target for s in sizes),
         "every image within 25% of the target")

    # ---- search_cases ---------------------------------------------------
    cases, sizes_by_case = {}, {}
    rate_launches = 0
    for name, mode, (b, h, w), kw, budget in [
            ("psnr35", C.YUV_420, (4, 512, 512),
             dict(psnr=35.0, passes=8), 4.0),
            ("size_passes10", C.YUV_420, (4, 512, 512),
             dict(size=50_000, passes=10), 4.0),
            ("method0", C.YUV_420, (4, 512, 512),
             dict(size=50_000, passes=8, method=0), 4.0),
            ("method1", C.YUV_420, (4, 512, 512),
             dict(size=50_000, passes=8, method=1), 4.0),
            ("method7", C.YUV_420, (4, 512, 512),
             dict(size=50_000, passes=6, method=7), 4.0),
            ("gray", C.YUV_400, (4, 512, 512),
             dict(size=30_000, passes=6), 4.0),
            ("nv12", C.YUV_420, (4, 512, 512),
             dict(size=50_000, passes=6), 4.0),
            ("overflow", C.YUV_420, (2, 256, 256),
             dict(size=4000, passes=3, method=0, quality=90), 0.0001)]:
        img = make_rgb(b, h, w, SEED + 400 + len(cases))
        if name == "overflow":
            img[0] = np.random.RandomState(SEED).randint(0, 256, (h, w, 3))
        method, q = kw.get("method", 4), kw.get("quality", QUALITY)
        p = method_param(method, mode, q)
        if "psnr" in kw:
            p.set_target_psnr(kw["psnr"], passes=kw["passes"])
        else:
            p.set_target_size(kw["size"], passes=kw["passes"])

        def run():
            if name == "gray":
                return engine.encode_batch_gray(img[..., 0], p, budget,
                                                device=dev)
            if name == "nv12":
                y = img[..., 0]
                uv = np.stack([img[:, ::2, ::2, 1], img[:, ::2, ::2, 2]], -1)
                return engine.encode_batch_nv12(y, uv, p, budget, device=dev)
            return engine.encode_batch(img, p, budget, device=dev)

        trellis.trellis_quantize.per_image_rate_launches = 0
        with mock.patch.object(engine_search._Search, "fallback",
                               autospec=True,
                               side_effect=engine_search._Search.fallback) \
                as spy:
            got = run()
        if name == "method7":
            rate_launches = trellis.trellis_quantize.per_image_rate_launches
            cases["method7_used_rate_tables"] = rate_launches > 0
        with plain_forced():
            cases[name] = got == run()
        sizes_by_case[name] = [len(j) for j in got]
        if name == "overflow":
            cases["overflow_fell_back"] = spy.call_count >= 1
    small = make_rgb(2, 48, 64, SEED)
    for name, p in [
            ("gpu_equals_cpu_size",
             method4(C.YUV_420).set_target_size(2000, passes=8)),
            ("gpu_equals_cpu_psnr",
             method4(C.YUV_420).set_target_psnr(35.0, passes=8))]:
        cases[name] = (engine.encode_batch(small, p, device=dev)
                       == engine.encode_batch(small, p, device="cpu"))
    emit("search_cases", gpu=card, sizes=sizes_by_case,
         method7_rate_table_launches=rate_launches, **cases)
    need(all(cases.values()), "every search case byte-equal and checked")

    # ---- search_timing --------------------------------------------------
    sp_fn = kernels.function("sample_pack", "sjpeg_sample_pack",
                             sample_pack._ARGTYPES)
    stream = torch.cuda.current_stream().cuda_stream
    sinter, dc, group, iq3, ib3, dcl, acl = args

    def launch(tables, n_sets):
        kernels.check(sp_fn(sinter.data_ptr(), sinter.element_size(),
                            dc.data_ptr(), group.data_ptr(),
                            *(t.data_ptr() for t in tables),
                            words.data_ptr(), bits.data_ptr(), n,
                            n // n_sets, n_sets, stream), "sample_pack")

    per_image_ms = event_ms(lambda: launch((iq3, ib3, dcl, acl), BATCH), 20)
    per_image_us = kernel_us(lambda: launch((iq3, ib3, dcl, acl), BATCH),
                             "sample_pack")
    shared_ms = event_ms(lambda: launch((iq3[0], ib3[0], dcl[0], acl[0]), 1),
                         20)
    plain_ms = event_ms(lambda: sample_pack.sample_pack_plain(*args), 3)
    host_ms(lambda: engine.encode_batch(rgb, param, device=dev), 1)  # warm-up
    e2e_ms = host_ms(lambda: engine.encode_batch(rgb, param, device=dev), 3)
    mpx = BATCH * HEIGHT * WIDTH / 1e6
    emit("search_timing", gpu=card, sample_pack_per_image_ms=per_image_ms,
         sample_pack_shared_ms=shared_ms, sample_pack_plain_ms=plain_ms,
         encode_batch_ms=e2e_ms, encode_batch_mpx_per_s=mpx / (e2e_ms / 1e3),
         megapixels=mpx, passes_run=runs[0])

    # ---- search_breakdown: one search, host clock, synchronised ---------
    stages = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        stages[name] = (time.perf_counter() - t0) * 1e3
        return r

    src = stage("h2d", lambda: torch.from_numpy(rgb).to(dev))
    srch = engine_search._Search(src, "rgb", C.YUV_420, WIDTH, HEIGHT, param,
                                 4.0)
    stage("prep", srch.stage_prep)
    nodes = stage("node_fit", srch.node_matrices)
    loop, thr = stage("loop", lambda: srch.size_loop(nodes))
    combo = stage("trace_fetch", lambda: srch.fetch_size_trace(loop))
    best_pass, opt = stage("replay", lambda: srch.replay_size(nodes, combo,
                                                              thr))
    picked = stage("pick_fetch", lambda: srch.pick_streams(loop, combo,
                                                           best_pass))
    out = stage("host_tail", lambda: srch.size_tail(opt, *picked))
    emit("search_breakdown", gpu=card, ms=stages, passes_run=loop[-1],
         distinct_node_matrices=int(np.unique(
             nodes[0].reshape(-1, 128), axis=0).shape[0]),
         fetched_bytes=sum(map(len, picked[0])))
    need(out == jpegs, "the staged search gives the same bytes")
    # the node fit in C++, and image 0's luma nodes by the NumPy fit per
    # pair, its reference, on the same histograms
    fit_ms = {"native": host_ms(srch.node_matrices, 3)}
    minq = srch.min_qmats[0]
    base = np.maximum(np.stack(
        [quant_matrices_for_quality(q)[0]
         for q in build_q_tree(param, srch.initial_q, passes)]), minq)
    t0 = time.perf_counter()
    per_pair = np.stack([adaptive.analyse_histo(
        srch.histos[0, 0], qk.astype(np.uint8), minq, param.qdelta_max_luma)
        for qk in base])
    fit_ms["numpy_per_pair_image0_luma"] = (time.perf_counter() - t0) * 1e3
    need(np.array_equal(np.maximum(per_pair, minq), nodes[0][0, :, 0]),
         "the C++ node fit equals analyse_histo per pair")

    # ---- kernel row -----------------------------------------------------
    tab = (torch.arange(n, device=dev) // (n // BATCH)) * 2 + group.long()
    ac_nonzero = int((quantize.quantize_values(
        fdct.fdct_blocks(sinter), iq3.reshape(-1, 64).long()[tab],
        ib3.reshape(-1, 64).long()[tab])[:, 1:] != 0).sum())
    tables = (iq3, ib3, dcl, acl)
    # bytes: each input read once (samples, codes, groups, 16 table sets),
    # each output written once; operations as the shared-table row's
    sp_bytes = (n * 64 * sinter.element_size() + 8 * n
                + 4 * sum(t.numel() for t in tables) + n * 64 * 4 + 4 * n)
    sp_ops = n * (1250 + 63 * 7) + ac_nonzero * 20
    row = kernel_row("sample_pack_per_image",
                     "sjpeg_tpu_torch/csrc/sample_pack.cu",
                     "sjpeg_tpu/ops/pallas_quant_pack.py:432",
                     per_image, max(v for k, v in errs.items()
                                    if "blocks" not in k),
                     per_image_ms, plain_ms, sp_bytes, sp_ops,
                     shared_tables_ms=shared_ms, device_us=per_image_us)
    return row, rate_launches, {"search_breakdown_ms": stages,
                                "node_fit_ms": fit_ms}


def single_phases(card: str, rgb: np.ndarray, qp_long_err: int) -> list:
    """The single-image API and the last two kernels: single_kernels,
    single_parity, single_path and single_timing; returns the kernel rows
    of fdct and quant_pack (its error including sp_long_streams'
    quant_pack cases, qp_long_err)."""
    from sjpeg_tpu_torch import constants as C
    from sjpeg_tpu_torch import engine, kernels, pipeline, state
    from sjpeg_tpu_torch.huffman import k3_default_tables
    from sjpeg_tpu_torch.ops import (colorspace, fdct, merge_codesizes,
                                     quant_pack, quantize, sample_pack,
                                     stream_concat, trellis, vlc_pack)
    from sjpeg_tpu_torch.params import SearchHook

    dev = torch.device(DEVICE)

    # ---- single_kernels: both kernels vs plain at 16 x 1024^2 ------------
    layout = pipeline.component_layout(C.YUV_420, WIDTH, HEIGHT)
    nb = tuple(layout.nb_blocks)
    blocks = colorspace.rgb_to_blocks(torch.from_numpy(rgb).to(dev),
                                      C.YUV_420, WIDTH, HEIGHT)
    per_comp = [b.shape[0] for b in blocks]
    samples = torch.cat(blocks)                      # int32, as staged
    del blocks
    n = samples.shape[0]
    coeffs = fdct.fdct_blocks(samples)
    torch.cuda.synchronize()
    err_fdct = max_err([(coeffs, fdct.fdct_blocks_plain(samples))])
    tables = state.tables_from_numpy(
        *engine._quant_arrays(engine._quant_matrices(method0(C.YUV_420))),
        *engine._host_luts(k3_default_tables()), dev)
    cinter, dc, group = engine._interleave_coeffs(
        list(coeffs.split(per_comp)), tables[0], tables[1], nb, BATCH)
    qargs = (cinter, dc, group, *tables)
    words, bits = quant_pack.quant_pack(*qargs)
    pwords, pbits = quant_pack.quant_pack_plain(*qargs)
    torch.cuda.synchronize()
    err_qp = max_err([(words, pwords), (bits, pbits)])
    del pwords, pbits

    fd_fn = kernels.function("fdct", "sjpeg_fdct", fdct._ARGTYPES)
    qp_fn = kernels.function("quant_pack", "sjpeg_quant_pack",
                             quant_pack._ARGTYPES)
    stream = torch.cuda.current_stream().cuda_stream
    s16 = samples.to(torch.int16)

    def launch_fdct(x):
        kernels.check(fd_fn(x.data_ptr(), x.element_size(),
                            coeffs.data_ptr(), n, stream), "fdct")

    def launch_quant_pack():
        kernels.check(qp_fn(*(t.data_ptr() for t in qargs), words.data_ptr(),
                            bits.data_ptr(), n, stream), "quant_pack")

    fd_ms = event_ms(lambda: launch_fdct(samples), 20)
    fd16_ms = event_ms(lambda: launch_fdct(s16), 20)
    qp_ms = event_ms(launch_quant_pack, 20)
    fd_us = kernel_us(lambda: launch_fdct(samples), "fdct")
    qp_us = kernel_us(launch_quant_pack, "quant_pack")
    fd_plain_ms = event_ms(lambda: fdct.fdct_blocks_plain(samples), 3)
    qp_plain_ms = event_ms(lambda: quant_pack.quant_pack_plain(*qargs), 3)
    emit("single_kernels", gpu=card, blocks=n, fdct_max_abs_err=err_fdct,
         quant_pack_max_abs_err=err_qp, fdct_ms=fd_ms, fdct_int16_ms=fd16_ms,
         fdct_plain_ms=fd_plain_ms, fdct_device_us=fd_us,
         quant_pack_ms=qp_ms, quant_pack_plain_ms=qp_plain_ms,
         quant_pack_device_us=qp_us, total_bits=int(bits.long().sum()))
    need(err_fdct == 0, "fdct bit-exact against its plain version")
    need(err_qp == 0, "quant_pack bit-exact against its plain version")
    ac_nonzero = int((quantize.quantize_values(
        cinter, tables[0].long()[group.long()],
        tables[1].long()[group.long()])[:, 1:] != 0).sum())
    del samples, s16, coeffs, cinter, dc, group, qargs, words, bits

    # ---- single_parity: card vs the plain-forced path at 1000 x 750 -----
    img = make_rgb(2, 750, 1000, SEED + 500)
    one = img[0]
    p420 = (one[..., 0].copy(), one[::2, ::2, 1].copy(),
            one[::2, ::2, 2].copy())
    p444 = tuple(one[..., c].copy() for c in range(3))
    runs = {}
    for m in (0, 1, 3, 4, 7):
        runs[f"rgb_m{m}"] = lambda m=m: engine.encode_rgb(
            one, method_param(m, C.YUV_420), device=dev)
    for m in (0, 4):
        runs[f"gray_m{m}"] = lambda m=m: engine.encode_gray(
            p420[0], method_param(m, C.YUV_400), device=dev)
        runs[f"yuv420_m{m}"] = lambda m=m: engine.encode_yuv(
            *p420, True, method_param(m, C.YUV_420), device=dev)
        runs[f"yuv444_m{m}"] = lambda m=m: engine.encode_yuv(
            *p444, False, method_param(m, C.YUV_444), device=dev)
    for m in (0, 4, 7):
        runs[f"size_search_m{m}"] = lambda m=m: engine.encode_rgb(
            one, method_param(m, C.YUV_420).set_target_size(60_000,
                                                            passes=6),
            device=dev)
        runs[f"psnr_search_m{m}"] = lambda m=m: engine.encode_rgb(
            one, method_param(m, C.YUV_420).set_target_psnr(36.0, passes=6),
            device=dev)

    def hook_batch():
        p = method4(C.YUV_420).set_target_size(60_000, passes=5)
        p.search_hook = stateful_hook()
        return engine.encode_batch(img, p, device=dev)

    runs["custom_hook_batch"] = hook_batch
    cases, sizes = {}, {}
    for name, fn in runs.items():
        got = fn()
        with plain_forced():
            cases[name] = got == fn()
        sizes[name] = (len(got) if isinstance(got, bytes)
                       else [len(j) for j in got])
    emit("single_parity", width=1000, height=750, sizes=sizes, **cases)
    need(all(cases.values()), "every single-image case byte-equal")

    # ---- single_path: a 12-MP phone photo through the entry points ------
    bh, bw = 3024, 4032
    big = make_rgb(1, bh, bw, SEED + 600)[0]
    planes = (big[..., 0].copy(), big[::2, ::2, 1].copy(),
              big[::2, ::2, 2].copy())
    m4_bytes = len(engine.encode_rgb(big, method4(C.YUV_420), device=dev))
    target = int(0.6 * m4_bytes)
    search_param = method4(C.YUV_420).set_target_size(target, passes=8)
    runs = {
        "rgb_m0": lambda: engine.encode_rgb(big, method0(C.YUV_420),
                                            device=dev),
        "rgb_m4": lambda: engine.encode_rgb(big, method4(C.YUV_420),
                                            device=dev),
        "yuv420_m0": lambda: engine.encode_yuv(*planes, True,
                                               method0(C.YUV_420),
                                               device=dev),
        "rgb_m4_size_search": lambda: engine.encode_rgb(big, search_param,
                                                        device=dev)}
    counted = {"fdct": fdct.fdct_blocks, "quant_pack": quant_pack.quant_pack,
               "sample_pack": sample_pack.sample_pack,
               "stream_concat": stream_concat.stream_concat,
               "vlc_pack": vlc_pack.vlc_pack,
               "merge_codesizes": merge_codesizes.optimal_tables,
               "trellis": trellis.trellis_quantize}
    launches, jpegs, same, passes = {}, {}, {}, {}
    for name, fn in runs.items():
        for k in counted.values():
            k.launches = 0
        with mock.patch.object(SearchHook, "update", autospec=True,
                               side_effect=SearchHook.update) as upd:
            jpegs[name] = fn()
        launches[name] = {k: f.launches for k, f in counted.items()}
        passes[name] = upd.call_count
        with plain_forced():
            same[name] = jpegs[name] == fn()
    blocks_big = engine._blocks_per_image(
        pipeline.component_layout(C.YUV_420, bw, bh))
    emit("single_path", width=bw, height=bh, blocks=blocks_big,
         launches=launches, bytes={k: len(j) for k, j in jpegs.items()},
         method4_q75_bytes=m4_bytes, target_bytes=target, passes=passes,
         byte_equal_plain=same)
    need(all(same.values()), "single-image bytes equal the plain-forced path")
    need(all(j[:2] == b"\xff\xd8" and j[-2:] == b"\xff\xd9"
             for j in jpegs.values()), "SOI/EOI markers")
    need(launches["rgb_m0"]["sample_pack"] == 1
         and launches["rgb_m4"]["fdct"] > 0
         and launches["rgb_m4"]["vlc_pack"] == 1
         and launches["yuv420_m0"]["fdct"] > 0
         and launches["yuv420_m0"]["quant_pack"] == 1
         and launches["rgb_m4_size_search"]["merge_codesizes"] > 0
         and all(v["stream_concat"] > 0 for v in launches.values()),
         "the single-image paths ran fdct, quant_pack, sample_pack, "
         "vlc_pack, merge_codesizes and stream_concat")
    need(abs(len(jpegs["rgb_m4_size_search"]) - target) < 0.1 * target,
         "the size search within 10% of its target")

    # ---- single_timing --------------------------------------------------
    mpx = bh * bw / 1e6
    ms = {name: host_ms(fn, 5) for name, fn in runs.items()}
    emit("single_timing", gpu=card, ms=ms, megapixels=mpx,
         mpx_per_s={k: mpx / (v / 1e3) for k, v in ms.items()},
         passes=passes)

    # ---- kernel rows ----------------------------------------------------
    # fdct: the int32 samples read once, the coefficients written once;
    # ~1,250 32-bit operations a block.  quant_pack: the coefficients, DC
    # codes, groups and the one table set read once, words and counts
    # written once; ~7 operations a coefficient to quantize and test, ~20
    # a coded coefficient to code and pack.
    fd_bytes = n * 64 * 4 * 2
    qp_bytes = (n * 64 * 4 + 8 * n + 4 * sum(t.numel() for t in tables)
                + n * 64 * 4 + 4 * n)
    total = {k: sum(v[k] for v in launches.values()) for k in counted}
    return [
        kernel_row("fdct", "sjpeg_tpu_torch/csrc/fdct.cu",
                   "sjpeg_tpu/ops/pallas_fdct.py:270", total["fdct"],
                   err_fdct, fd_ms, fd_plain_ms, fd_bytes, n * 1250,
                   int16_ms=fd16_ms, device_us=fd_us),
        kernel_row("quant_pack", "sjpeg_tpu_torch/csrc/quant_pack.cu",
                   "sjpeg_tpu/ops/pallas_quant_pack.py:493",
                   total["quant_pack"], max(err_qp, qp_long_err), qp_ms,
                   qp_plain_ms, qp_bytes, n * 63 * 7 + ac_nonzero * 20,
                   device_us=qp_us, redesigned=True)]


def serving_phases(card: str, rgb: np.ndarray) -> None:
    """The serving wrappers: encode_pipelined over four 16 x 1024^2
    batches against sequential encode_batch, and encode_many on mixed
    shapes against encode_rgb per image."""
    from sjpeg_tpu_torch import constants as C
    from sjpeg_tpu_torch import engine

    dev = torch.device(DEVICE)
    batches = [rgb, np.ascontiguousarray(rgb[:, ::-1]),
               np.ascontiguousarray(rgb[:, :, ::-1]), 255 - rgb]
    param = method0(C.YUV_420)

    def sequential():
        return [engine.encode_batch(b, param, device=dev) for b in batches]

    def pipelined():
        return list(engine.encode_pipelined(batches, param, depth=2,
                                            device=dev))

    seq = sequential()
    same_pipelined = pipelined() == seq
    seq_ms = host_ms(sequential, 3) / len(batches)
    pipe_ms = host_ms(pipelined, 3) / len(batches)

    small, vga = make_rgb(2, 750, 1000, SEED + 700), make_rgb(2, 480, 640,
                                                              SEED + 701)
    mixed = [rgb[0], small[0], vga[0], rgb[1], vga[1], small[1], rgb[2]]
    p4 = method4(C.YUV_420)
    many = engine.encode_many(mixed, p4, device=dev)
    same_many = many == [engine.encode_rgb(im, p4, device=dev)
                         for im in mixed]
    emit("serving", gpu=card, batches=len(batches), batch=BATCH,
         pipelined_equals_encode_batch=same_pipelined,
         encode_batch_ms_per_batch=seq_ms,
         encode_pipelined_ms_per_batch=pipe_ms, depth=2,
         many_shapes=[list(im.shape) for im in mixed],
         encode_many_equals_encode_rgb=same_many)
    need(same_pipelined, "encode_pipelined equals encode_batch per batch")
    need(same_many, "encode_many equals encode_rgb per image")


def four_mode_batch(n: int, per_mode: int) -> np.ndarray:
    """[4 per_mode, n, n, 3] uint8 images in which YUV_AUTO picks, in turn,
    4:0:0 (gray), 4:2:0 (a gently tinted gradient), sharp 4:2:0 (a soft
    chroma sinusoid) and 4:4:4 (noise), each mode per_mode times."""
    yy, xx = np.mgrid[0:n, 0:n]
    rng = np.random.RandomState(SEED + 800)
    out = []
    for i in range(per_mode):
        per = 8 + 4 * i
        out += [np.repeat(((xx + yy + 16 * i) % 256)[..., None], 3, -1),
                np.stack([xx * 64 // n + 96 + 8 * i, yy * 64 // n + 96,
                          np.full_like(xx, 128 - 8 * i)], -1),
                np.stack([128 + 40 * np.sin(xx / per), np.full_like(xx, 128),
                          128 - 40 * np.sin(yy / (per * 1.3))], -1),
                rng.randint(0, 256, (n, n, 3))]
    return np.stack(out).astype(np.uint8)


def sweep_count_batch(n: int) -> np.ndarray:
    """Three n x n images whose sharp conversions stop after 2, 3 and 4
    sweeps: faint noise, full-range noise, and a gradient under it."""
    yy, xx = np.mgrid[0:n, 0:n]
    rng = np.random.RandomState(SEED + 801)
    return np.stack([
        np.clip(128 + rng.randint(-10, 11, (n, n, 3)), 0, 255),
        np.clip(128 + rng.randint(-128, 129, (n, n, 3)), 0, 255),
        np.clip(np.stack([xx, yy, (xx + yy) // 2], -1)
                + rng.randint(-128, 129, (n, n, 3)), 0, 255),
    ]).astype(np.uint8)


def ptxas_info(log: str, entry: str = "") -> dict:
    """Registers, spill bytes, shared memory and stack of the first kernel
    of a library's `-Xptxas=-v` log whose mangled name holds `entry`."""
    for part in log.split("Compiling entry function")[1:]:
        if entry in part.split("'")[1]:
            log = part
            break

    def num(pattern):
        m = re.search(pattern, log)
        return int(m.group(1)) if m else None
    return {"registers": num(r"Used (\d+) registers"),
            "spill_store_bytes": num(r"(\d+) bytes spill stores"),
            "spill_load_bytes": num(r"(\d+) bytes spill loads"),
            "static_smem_bytes": num(r"(\d+) bytes smem"),
            "stack_bytes": num(r"(\d+) bytes stack frame")}


def launch_ms(restore, launch, reps: int = 5) -> float:
    """Median of `reps` CUDA-event timings of launch() alone, after one
    warm-up, with restore() run before each, outside the events."""
    times = []
    for _ in range(reps + 1):
        restore()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        launch()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times[1:])


def auto_sharp_phases(card: str, rgb: np.ndarray, logs: dict) -> list:
    """YUV_AUTO and sharp YUV: auto_batch, sharp_kernel, risk_kernel and
    single_auto; returns the sharp_yuv and risk_stats kernel rows."""
    from sjpeg_tpu_torch import constants as C
    from sjpeg_tpu_torch import engine, kernels, riskiness, sharp_yuv
    from sjpeg_tpu_torch.ops import riskiness as risk_dev
    from sjpeg_tpu_torch.ops import sharp_yuv as sharp_ops
    from sjpeg_tpu_torch.params import EncoderParam

    dev = torch.device(DEVICE)

    # ---- auto_batch: every mode four times, default param and method 0 --
    batch = four_mode_batch(WIDTH, BATCH // 4)
    src = torch.from_numpy(batch).to(dev)
    want_modes = [C.YUV_400, C.YUV_420, C.YUV_SHARP, C.YUV_444] * (BATCH // 4)
    host_modes = [riskiness.riskiness(im)[0] for im in batch]
    modes = engine.auto_modes(src)
    stats = risk_dev.risk_stats(src)
    cpu_stats = risk_dev.risk_stats(src[:2].cpu())
    risk_exact = all(torch.equal(a[:2].cpu(), b)
                     for a, b in zip(stats, cpu_stats))
    risk_trace = device_kernels(lambda: risk_dev.risk_stats(src), 20)
    risk_event_ms = event_ms(lambda: risk_dev.risk_stats(src), 20)
    params = {"m4_default": EncoderParam(), "m0": method0(C.YUV_AUTO)}
    launches, same, ms, sizes = {}, {}, {}, {}
    for name, p in params.items():
        jpegs, launches[name] = run_counted(
            lambda p=p: engine.encode_batch(batch, p, device=dev))
        with plain_forced():
            same[name] = jpegs == engine.encode_batch(batch, p, device=dev)
        ms[name] = host_ms(lambda p=p: engine.encode_batch(batch, p,
                                                           device=dev), 3)
        sizes[name] = sum(len(j) for j in jpegs)
    emit("auto_batch", gpu=card, images=BATCH, modes=modes,
         host_scorer_modes=host_modes, risk_stats_exact_vs_cpu=risk_exact,
         risk_stats_device_us=kernel_us(
             lambda: risk_dev.risk_stats(src), "risk_stats", calls=20,
             trace=risk_trace),
         risk_stats_op_device_us=op_us(
             lambda: risk_dev.risk_stats(src), "risk_stats", calls=20,
             trace=risk_trace),
         risk_stats_event_us=risk_event_ms * 1e3,
         launches=launches, byte_equal_plain=same, bytes_total=sizes,
         encode_batch_ms=ms,
         encode_batch_mpx_per_s={k: BATCH * WIDTH * HEIGHT / 1e3 / v
                                 for k, v in ms.items()})
    need(modes == want_modes and host_modes == want_modes,
         "AUTO picks each mode four times, as the host scorer does")
    need(risk_exact, "risk_stats on the card equals the CPU's")
    need(all(same.values()), "AUTO bytes equal the plain-forced path")
    m4, m0 = launches["m4_default"], launches["m0"]
    need(m4["sharp_yuv"] == 1 and m0["sharp_yuv"] == 1
         and m4["risk_stats"] == 1 and m0["risk_stats"] == 1
         and all(m4[k] > 0 for k in ("fdct", "merge_codesizes", "vlc_pack",
                                     "stream_concat"))
         and m0["sample_pack"] > 0 and m0["stream_concat"] > 0,
         "the AUTO path ran risk_stats and sharp_yuv once, fdct, "
         "merge_codesizes, vlc_pack, stream_concat (method 4) and "
         "sample_pack (method 0)")
    del src, stats, cpu_stats

    # ---- sharp_kernel: the kernel vs its plain version ------------------
    photo = make_rgb(1, 3024, 4032, SEED + 600)
    cases = {"batch_16x1024": rgb, "photo_12mp": photo,
             "auto_sharp_4x1024": batch[2::4],
             "odd_1000x751": make_rgb(2, 751, 1000, SEED + 802),
             "sweeps_2_3_4": sweep_count_batch(256),
             "wide_19000x8": make_rgb(1, 8, 19_000, SEED + 803)}
    timed = ("batch_16x1024", "photo_12mp", "auto_sharp_4x1024")
    errs, iters, plain_ms, setups, plans = {}, {}, {}, {}, {}
    for name, imgs in cases.items():
        planes = sharp_yuv.sharp_setup(torch.from_numpy(imgs).to(dev))
        y, uv, ty, tuv = planes
        plans[name] = sharp_ops.plan(*y.shape)
        ky, kuv, py, puv = y.clone(), uv.clone(), y.clone(), uv.clone()
        k_it = sharp_ops.sharp_iterate(ky, kuv, ty, tuv)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p_it = sharp_yuv.sharp_iterate_plain(py, puv, ty, tuv)
        torch.cuda.synchronize()
        plain_ms[name] = (time.perf_counter() - t0) * 1e3
        errs[name] = max_err([(ky, py), (kuv, puv), (k_it, p_it)])
        iters[name] = k_it.tolist()
        if name in timed:
            setups[name] = planes
        del ky, kuv, py, puv
    need(iters["sweeps_2_3_4"] == [2, 3, 4], "sweep counts 2, 3 and 4")

    fn = kernels.function("sharp_yuv", "sjpeg_sharp_yuv_cluster",
                          sharp_ops._ARGTYPES)
    stream = torch.cuda.current_stream().cuda_stream
    g2l, l2g = sharp_yuv.gamma_tensors(dev)
    times, dev_us, chain, nbytes, ops = {}, {}, {}, {}, {}
    for name, (y0, uv0, ty, tuv) in setups.items():
        b, h, w = y0.shape
        y, uv = y0.clone(), uv0.clone()
        it = torch.empty((b,), dtype=torch.int32, device=dev)

        def restore():
            y.copy_(y0)
            uv.copy_(uv0)

        def launch():
            kernels.check(fn(y.data_ptr(), uv.data_ptr(), ty.data_ptr(),
                             tuv.data_ptr(), g2l.data_ptr(), l2g.data_ptr(),
                             it.data_ptr(), b, w, h, stream), "sharp_yuv")

        times[name] = launch_ms(restore, launch)
        dev_us[name] = kernel_us(lambda: (restore(), launch()), "sharp_yuv",
                                 calls=3)
        sweeps = sum(iters[name])
        # a sweep reads y, ty, uv, tuv once and writes y and uv once: 21
        # bytes a pixel; ~45 operations a pixel (the filter, 3 lookups, the
        # gray, the interpolated inverse, the update, a quarter of the
        # chroma's 2x2 mean)
        nbytes[name] = 21 * h * w * sweeps
        ops[name] = 45 * h * w * sweeps
        chain[name] = (h // 2) * max(iters[name])
    build = {e: ptxas_info(logs.get("sharp_yuv", ""), e)
             for e in ("ILi1E", "ILi4E")}
    emit("sharp_kernel", gpu=card, max_abs_err=errs, sweeps=iters,
         ms=times, device_us=dev_us, plain_ms=plain_ms,
         dependent_row_pair_steps=chain,
         us_per_step={k: dev_us[k] and dev_us[k] / chain[k]
                      for k in times},
         plan=plans, ring="shared memory: each CTA's slice, 2 slots of "
         "cols + 2 cells of 16 bytes; a slice's edge columns reach the "
         "neighbours' halo cells by st.async",
         bound_ms={k: max(nbytes[k] / H100_BYTES_PER_S,
                          ops[k] / H100_OPS_PER_S) * 1e3 for k in times},
         build={"cols_per_thread_1": build["ILi1E"],
                "cols_per_thread_4": build["ILi4E"]})
    need(max(errs.values()) == 0,
         "sharp_yuv exact against its plain version")
    need(plans["wide_19000x8"]["cols_per_thread"] > 1,
         "a slice wider than its CTA runs")
    del setups

    risk_row = risk_kernel_phase(card, batch, photo, rgb,
                                 launches["m4_default"]["risk_stats"],
                                 logs.get("risk_stats", ""))

    # ---- single_auto: encode_rgb on the 12-MP photo ---------------------
    runs = {"default": EncoderParam(),
            "sharp": EncoderParam(yuv_mode=C.YUV_SHARP)}
    s_same, s_ms, s_launches, s_bytes = {}, {}, {}, {}
    for name, p in runs.items():
        jpeg, s_launches[name] = run_counted(
            lambda p=p: engine.encode_rgb(photo[0], p, device=dev))
        with plain_forced():
            s_same[name] = jpeg == engine.encode_rgb(photo[0], p, device=dev)
        s_ms[name] = host_ms(lambda p=p: engine.encode_rgb(photo[0], p,
                                                           device=dev), 3)
        s_bytes[name] = len(jpeg)
    emit("single_auto", gpu=card, width=4032, height=3024,
         auto_mode=engine.auto_modes(torch.from_numpy(photo).to(dev))[0],
         launches=s_launches, bytes=s_bytes, byte_equal_plain=s_same,
         ms=s_ms)
    need(all(s_same.values()), "single-image AUTO and SHARP bytes equal "
         "the plain-forced path")
    need(s_launches["sharp"]["sharp_yuv"] == 1
         and s_launches["sharp"]["fdct"] > 0,
         "encode_rgb SHARP ran sharp_yuv and fdct")
    need(s_launches["default"]["risk_stats"] == 1,
         "encode_rgb AUTO ran risk_stats once")

    name = "batch_16x1024"
    sharp_row = kernel_row(
        "sharp_yuv", "sjpeg_tpu_torch/csrc/sharp_yuv.cu",
        "sjpeg_tpu/sharp_yuv_device.py:135-204",
        launches["m4_default"]["sharp_yuv"], max(errs.values()),
        times[name], plain_ms[name], nbytes[name], ops[name],
        device_us=dev_us[name], sweeps=iters[name],
        dependent_row_pair_steps=chain[name], plan=plans[name],
        photo_12mp_ms=times["photo_12mp"],
        photo_12mp_device_us=dev_us["photo_12mp"],
        photo_12mp_plain_ms=plain_ms["photo_12mp"],
        photo_12mp_plan=plans["photo_12mp"],
        auto_sharp_4x1024_ms=times["auto_sharp_4x1024"],
        auto_sharp_4x1024_device_us=dev_us["auto_sharp_4x1024"],
        **build["ILi1E"])
    return [sharp_row, risk_row]


def risk_kernel_phase(card: str, auto_batch: np.ndarray, photo: np.ndarray,
                      rgb: np.ndarray, launches: int, build_log: str) -> dict:
    """risk_kernel: the riskiness kernel vs its plain version on the AUTO
    batch, the main batch, the 12-MP photo, one row and one column, with
    its times; returns the risk_stats kernel row."""
    from sjpeg_tpu_torch.ops import riskiness as risk_dev

    dev = torch.device(DEVICE)
    cases = {"auto_batch_16x1024": auto_batch, "batch_16x1024": rgb,
             "photo_12mp": photo, "row_1x4032": photo[:, :1],
             "column_3024x1": np.ascontiguousarray(photo[:, :, :1]),
             "tiny_2x2": photo[:, :2, :2].copy()}
    errs, times, plain, dev_us, op_dev_us, nbytes, ops = ({}, {}, {}, {},
                                                          {}, {}, {})
    for name, imgs in cases.items():
        src = torch.from_numpy(np.ascontiguousarray(imgs)).to(dev)
        got = risk_dev.risk_stats(src)
        want = risk_dev.risk_stats_plain(src)
        torch.cuda.synchronize()
        errs[name] = max_err(zip(got, want))
        if name in ("auto_batch_16x1024", "photo_12mp"):
            times[name] = event_ms(lambda: risk_dev.risk_stats(src), 20)
            plain[name] = event_ms(lambda: risk_dev.risk_stats_plain(src), 3)
            trace = device_kernels(lambda: risk_dev.risk_stats(src), 5)
            dev_us[name] = kernel_us(lambda: risk_dev.risk_stats(src),
                                     "risk_stats", trace=trace)
            op_dev_us[name] = op_us(lambda: risk_dev.risk_stats(src),
                                    "risk_stats", trace=trace)
            b, h, w = src.shape[:3]
            # the input read once and the [b, 3] int64 sums written once;
            # ~100 integer operations an interior position (the levels of
            # one pixel, three pair scores with their exact rounding, the
            # sums)
            nbytes[name] = src.numel() + b * 3 * 8
            ops[name] = 100 * b * (h - 1) * (w - 1)
        del src, got, want
    emit("risk_kernel", gpu=card, max_abs_err=errs, ms=times,
         device_us=dev_us, op_device_us=op_dev_us, plain_ms=plain,
         bound_ms={k: max(nbytes[k] / H100_BYTES_PER_S,
                          ops[k] / H100_OPS_PER_S) * 1e3 for k in times},
         build=ptxas_info(build_log))
    need(max(errs.values()) == 0, "risk_stats exact against its plain "
         "version")
    name = "auto_batch_16x1024"
    return kernel_row("risk_stats", "sjpeg_tpu_torch/csrc/risk_stats.cu",
                      "sjpeg_tpu/ops/riskiness.py:86-105", launches,
                      max(errs.values()), times[name], plain[name],
                      nbytes[name], ops[name], device_us=dev_us[name],
                      op_device_us=op_dev_us[name],
                      photo_12mp_ms=times["photo_12mp"],
                      photo_12mp_device_us=dev_us["photo_12mp"],
                      photo_12mp_plain_ms=plain["photo_12mp"],
                      **ptxas_info(build_log))


PORT_SOURCES = ("fdct", "trellis", "merge_codesizes", "vlc_pack",
                "stream_concat", "sharp_yuv", "risk_stats", "sample_pack",
                "quant_pack", "scan_stuff")


def port_launches(trace: dict) -> dict:
    """{csrc source: kernel launches} of a device_kernels trace, for the
    port's own kernels."""
    out = {}
    for source in PORT_SOURCES:
        names = global_names(source)
        n = sum(v["launches"] for k, v in trace.items()
                if any(nm in k for nm in names))
        if n:
            out[source] = n
    return out


def sharded_worker(rank: int, world: int, init_method: str, out_dir: str,
                   device: str, height: int, width: int) -> None:
    """One of the two processes of the sharded phase: a (1, 2) grid of the
    card under a (2, 2) mesh, method 4, two of the four images."""
    import pickle
    from pathlib import Path

    import torch.distributed as dist
    from sjpeg_tpu_torch import constants as C
    from sjpeg_tpu_torch.parallel.api import encode_batch_sharded
    from sjpeg_tpu_torch.parallel.mesh import init_distributed, make_mesh

    init_distributed(init_method, world, rank)
    try:
        mesh = make_mesh(devices=[torch.device(device, 0)] * 2)
        imgs = make_rgb(2 * world, height, width, SEED + 1100)
        jpegs = encode_batch_sharded(imgs[2 * rank:2 * rank + 2],
                                     method4(C.YUV_420), mesh)
        info = {"dp": mesh.dp, "sp": mesh.sp, "rank": mesh.rank,
                "world": mesh.world}
    finally:
        dist.destroy_process_group()
    Path(out_dir, f"{rank}.pkl").write_bytes(pickle.dumps((info, jpegs)))


def sharded_phases(card: str, rgb: np.ndarray) -> dict:
    """The sharded API (sjpeg_tpu_torch.parallel) on meshes of the card
    (cuda:0 repeated: the stripes run one after another) and, with two or
    more cards, of distinct devices: every case's bytes against
    engine.encode_batch on the card; the stitch's stream_concat launch
    against its plain version; times, a stage breakdown and the kernels'
    launches of one sharded call; two processes under gloo.  Returns
    {kernel: launches} of the method-7 call on (2, 2) (fdct, lambda_fit,
    trellis, merge_codesizes, vlc_pack, stream_concat), and of the AUTO
    batch's
    call for the kernels that call alone runs (sharp_yuv, risk_stats)."""
    import pickle
    import torch.multiprocessing as mp

    from sjpeg_tpu_torch import constants as C
    from sjpeg_tpu_torch import engine, kernels
    from sjpeg_tpu_torch.ops import (fdct, lambda_fit, merge_codesizes,
                                     stream_concat, trellis, vlc_fields,
                                     vlc_pack)
    from sjpeg_tpu_torch.ops import riskiness as risk_dev
    from sjpeg_tpu_torch.ops import sharp_yuv as sharp_ops
    from sjpeg_tpu_torch.params import EncoderParam
    from sjpeg_tpu_torch.parallel import api
    from sjpeg_tpu_torch.parallel.mesh import make_mesh
    from sjpeg_tpu_torch.parallel.shard import stitch_shard_streams

    dev = torch.device(DEVICE, 0)
    n_dev = torch.cuda.device_count()

    def mesh(dp, sp, distinct=False):
        devs = [torch.device(DEVICE, i % n_dev if distinct else 0)
                for i in range(dp * sp)]
        return make_mesh(dp, sp, devs)

    counted = {"fdct": fdct.fdct_blocks, "lambda_fit": lambda_fit.lambda_fit,
               "vlc_fields": vlc_fields.vlc_fields,
               "trellis": trellis.trellis_quantize,
               "merge_codesizes": merge_codesizes.optimal_tables,
               "vlc_pack": vlc_pack.vlc_pack,
               "stream_concat": stream_concat.stream_concat,
               "sharp_yuv": sharp_ops.sharp_iterate,
               "risk_stats": risk_dev.risk_stats}

    def counted_run(fn):
        for f in counted.values():
            f.launches = 0
        out = fn()
        return out, {k: f.launches for k, f in counted.items()}

    # ---- the main batch: methods 0, 4, 7 on (1, 4) and (2, 2) -----------
    same, launches, ms = {}, {}, {}
    meshes = {"1x4": (1, 4), "2x2": (2, 2)}
    for m in (0, 4, 7):
        p = method_param(m, C.YUV_420)
        want = engine.encode_batch(rgb, p, device=dev)
        for name, (dp, sp) in meshes.items():
            got, launches[f"m{m}_{name}"] = counted_run(
                lambda: api.encode_batch_sharded(rgb, p, mesh(dp, sp)))
            same[f"m{m}_{name}"] = got == want
        if n_dev > 1:
            same[f"m{m}_2x2_distinct"] = api.encode_batch_sharded(
                rgb, p, mesh(2, 2, True)) == want
        ms[f"m{m}"] = {"encode_batch": host_ms(
            lambda: engine.encode_batch(rgb, p, device=dev), 3)}
        for name, (dp, sp) in meshes.items():
            ms[f"m{m}"][f"sharded_{name}"] = host_ms(
                lambda: api.encode_batch_sharded(rgb, p, mesh(dp, sp)), 3)
    path = launches["m7_2x2"]
    need(all(path[k] > 0 for k in ("fdct", "trellis", "merge_codesizes",
                                   "vlc_pack", "stream_concat")),
         "the method-7 sharded path ran fdct, trellis, merge_codesizes, "
         "vlc_pack and stream_concat")
    need(launches["m0_2x2"]["merge_codesizes"] == 0
         and launches["m4_2x2"]["merge_codesizes"] == 2
         and launches["m4_2x2"]["stream_concat"] == 2 * 2 + 2,
         "method 4 on (2, 2): a table build and a stitch a dp row, a "
         "stream_concat a stripe")
    need(all(launches[f"m{m}_{name}"]["lambda_fit"] == (dp if m else 0)
             for m in (0, 4, 7) for name, (dp, _) in meshes.items()),
         "the lambda fit on the card: one launch a dp row (none for "
         "method 0)")

    # ---- ragged, odd, shared, AUTO, sharp --------------------------------
    p4 = method4(C.YUV_420)
    tall = make_rgb(8, 1080, 1920, SEED + 1101)
    same["ragged_1080p_2x4"] = (api.encode_batch_sharded(tall, p4,
                                                         mesh(2, 4))
                                == engine.encode_batch(tall, p4, device=dev))
    del tall
    same["odd_3_2x2"] = (api.encode_batch_sharded(rgb[:3], p4, mesh(2, 2))
                         == engine.encode_batch(rgb[:3], p4, device=dev))
    got, launches["shared_m4_2x2"] = counted_run(
        lambda: api.encode_batch_sharded(rgb, p4, mesh(2, 2),
                                         share_statistics=True))
    same["shared_m4_2x2"] = got == engine.encode_batch(
        rgb, p4, share_statistics=True, device=dev)
    need(launches["shared_m4_2x2"]["lambda_fit"] == 1,
         "share_statistics: one lambda_fit launch for the batch")
    auto = four_mode_batch(WIDTH, BATCH // 4)
    got, launches["auto_2x2"] = counted_run(
        lambda: api.encode_batch_sharded(auto, EncoderParam(), mesh(2, 2)))
    same["auto_2x2"] = got == engine.encode_batch(auto, EncoderParam(),
                                                  device=dev)
    sharp = EncoderParam(yuv_mode=C.YUV_SHARP)
    got, launches["sharp_2x2"] = counted_run(
        lambda: api.encode_batch_sharded(rgb, sharp, mesh(2, 2)))
    same["sharp_2x2"] = got == engine.encode_batch(rgb, sharp, device=dev)
    need(launches["auto_2x2"]["risk_stats"] == 1
         and launches["auto_2x2"]["sharp_yuv"] > 0
         and launches["sharp_2x2"]["sharp_yuv"] == 2,
         "AUTO ran risk_stats once and sharp_yuv; SHARP a sweep launch a "
         "dp row")

    # ---- the stitch against its plain version -----------------------------
    stitch_err = {}
    rng = np.random.RandomState(SEED + 1102)
    lens = np.array([0, 1, 31, 32, 2047, 2048, 2049])
    totals = np.stack([rng.permutation(lens) for _ in range(3)])
    pieces = np.clip(totals.reshape(-1, 1) - 2048 * np.arange(2), 0, 2048)
    edge_w = torch.from_numpy(random_streams(rng, pieces.reshape(-1))).to(
        dev).reshape(3, len(lens), 128)
    edge_t = torch.from_numpy(totals.astype(np.int32)).to(dev)
    run = api._Sharded(rgb, p4, mesh(2, 2), C.YUV_420, 4.0, False)
    for stage in run.stages()[:5]:
        stage()
    cases = {"edges": (edge_w, edge_t)}
    for r, (words, tots) in enumerate(run.streams):
        cases[f"main_row{r}"] = (torch.stack(words, 1), torch.stack(tots, 1))
    for name, (w, t) in cases.items():
        b, s, bucket = w.shape
        bits = (t.long()[..., None] - 2048 * torch.arange(
            bucket // 64, device=dev)).clamp(0, 2048).int().reshape(-1)
        got = stitch_shard_streams(w, t)
        want = stream_concat.stream_concat_plain(w.reshape(-1, 64), bits, b,
                                                 s * bucket)
        torch.cuda.synchronize()
        stitch_err[name] = max_err(zip(got, want))
    need(max(stitch_err.values()) == 0,
         "the stitch equals stream_concat_plain on the same pieces")
    del run, cases

    # ---- one sharded call: kernels (torch.profiler), stage breakdown -----
    p7 = method7(C.YUV_420)
    traces = {f"m{m}_2x2": port_launches(device_kernels(
        lambda p=p: api.encode_batch_sharded(rgb, p, mesh(2, 2))))
        for m, p in ((4, p4), (7, p7))}
    breakdown = {}
    for name, p in (("m4_2x2", p4), ("m7_2x2", p7)):
        run = api._Sharded(rgb, p, mesh(2, 2), C.YUV_420, 4.0, False)
        breakdown[name] = {}
        for stage in run.stages():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stage()
            torch.cuda.synchronize()
            breakdown[name][stage.__name__] = (time.perf_counter() - t0) * 1e3
        need(run.out == engine.encode_batch(rgb, p, device=dev),
             "the staged run's bytes")
        del run

    # ---- two processes on the card (gloo, file:// store) -----------------
    work = kernels.BUILD_DIR / "sharded_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    mp.start_processes(sharded_worker,
                       args=(2, f"file://{work / 'store'}", str(work),
                             DEVICE, HEIGHT, WIDTH),
                       nprocs=2, join=True, start_method="spawn")
    two_proc_s = time.perf_counter() - t0
    outs = [pickle.loads((work / f"{r}.pkl").read_bytes()) for r in range(2)]
    glob = make_rgb(4, HEIGHT, WIDTH, SEED + 1100)
    same["two_processes_m4"] = ([j for _, js in outs for j in js]
                                == engine.encode_batch(glob, p4, device=dev))
    emit("sharded", gpu=card, devices=n_dev, byte_equal=same,
         launches=launches, stitch_max_abs_err=stitch_err, ms=ms,
         profiler_launches=traces, breakdown_ms=breakdown,
         two_processes={"meshes": [info for info, _ in outs],
                        "seconds": two_proc_s},
         repeated_device=n_dev == 1)
    need(all(same.values()), "every sharded case byte-equal to "
         "engine.encode_batch on the card")
    return {k: launches["m7_2x2"][k] or launches["auto_2x2"][k]
            for k in counted}



def sharded_search_phase(card: str, rgb: np.ndarray) -> dict:
    """The sharded target-size / target-PSNR search on the main batch
    (meshes of the card, cuda:0 repeated): size with methods 4 and 7 and
    PSNR with method 4 on (2, 2) (PSNR 35 too, whose high-quality final
    pass outgrows the 4-bit-a-pixel stripe buckets of some images, which
    are searched again alone), size with method 0 on (1, 4), each case's
    bytes against engine.encode_batch on the card; the passes run, each
    kernel's launches outside those images' own searches (on (2, 2) with
    P passes: fdct 12, vlc_pack 4 (P + 1), stream_concat 6 (P + 1) ops,
    merge_codesizes 2 (P + 1), trellis 4 (P + 1); a PSNR search packs in
    its final pass only), a stage breakdown and median-of-3 host ms beside
    encode_batch's.  Returns {kernel: launches} of the method-7 size
    search."""
    from sjpeg_tpu_torch import constants as C
    from sjpeg_tpu_torch import engine, engine_search
    from sjpeg_tpu_torch.ops import (fdct, merge_codesizes, stream_concat,
                                     trellis, vlc_pack)
    from sjpeg_tpu_torch.params import TARGET_SIZE
    from sjpeg_tpu_torch.parallel import api
    from sjpeg_tpu_torch.parallel.mesh import make_mesh

    dev = torch.device(DEVICE, 0)
    counted = {"fdct": fdct.fdct_blocks, "trellis": trellis.trellis_quantize,
               "merge_codesizes": merge_codesizes.optimal_tables,
               "vlc_pack": vlc_pack.vlc_pack,
               "stream_concat": stream_concat.stream_concat}
    cases = {
        "m4_size_2x2": (method4(C.YUV_420).set_target_size(
            200_000, passes=8), (2, 2)),
        "m7_size_2x2": (method7(C.YUV_420).set_target_size(
            200_000, passes=6), (2, 2)),
        "m4_psnr_2x2": (method4(C.YUV_420).set_target_psnr(
            33.0, passes=8), (2, 2)),
        "m4_psnr35_2x2": (method4(C.YUV_420).set_target_psnr(
            35.0, passes=8), (2, 2)),
        "m0_size_1x4": (method0(C.YUV_420).set_target_size(
            200_000, passes=8), (1, 4)),
    }
    same, launches, passes_run, want_launches, ms = {}, {}, {}, {}, {}
    alone = {}                # images searched alone, and their launches
    real_passes = api._ShardedSearch.passes
    real_alone = engine_search.search_alone

    def spy(run):
        real_passes(run)
        passes_run[name] = run.passes_run

    def spy_alone(*a, **k):
        before = {key: f.launches for key, f in counted.items()}
        out = real_alone(*a, **k)
        rec = alone.setdefault(name, {"images": 0, "launches": dict.fromkeys(
            counted, 0)})
        rec["images"] += 1
        for key, f in counted.items():
            rec["launches"][key] += f.launches - before[key]
        return out

    for name, (p, (dp, sp)) in cases.items():
        mesh = make_mesh(dp, sp, [dev] * (dp * sp))
        want = engine.encode_batch(rgb, p, device=dev)
        for f in counted.values():
            f.launches = 0
        with mock.patch.object(api._ShardedSearch, "passes", spy), \
                mock.patch.object(engine_search, "search_alone", spy_alone):
            got = api.encode_batch_sharded(rgb, p, mesh)
        own = alone.get(name, {"launches": dict.fromkeys(counted, 0)})
        launches[name] = {k: f.launches - own["launches"][k]
                          for k, f in counted.items()}
        same[name] = got == want
        # packing passes: each size pass and the final pass
        n = passes_run[name] + 1 if p.target_mode == TARGET_SIZE else 1
        want_launches[name] = {
            "fdct": 3 * dp * sp,
            "trellis": dp * sp * n if name.startswith("m7") else 0,
            "merge_codesizes": 0 if name.startswith("m0") else dp * n,
            "vlc_pack": dp * sp * n, "stream_concat": dp * (sp + 1) * n}
        ms[name] = {"encode_batch": host_ms(
            lambda: engine.encode_batch(rgb, p, device=dev), 3),
            "sharded": host_ms(
            lambda: api.encode_batch_sharded(rgb, p, mesh), 3)}

    # ---- a stage breakdown of the method-4 size search on (2, 2) ---------
    p, (dp, sp) = cases["m4_size_2x2"]
    run = api._ShardedSearch(rgb, p, make_mesh(dp, sp, [dev] * (dp * sp)),
                             C.YUV_420, 4.0)
    breakdown = {}
    for st in run.stages():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st()
        torch.cuda.synchronize()
        breakdown[st.__name__] = (time.perf_counter() - t0) * 1e3
    same["m4_size_2x2_staged"] = run.out == engine.encode_batch(
        rgb, p, device=dev)
    emit("sharded_search", gpu=card, byte_equal=same, passes_run=passes_run,
         launches=launches, predicted_launches=want_launches,
         searched_alone=alone, ms=ms, breakdown_ms=breakdown,
         bucket_words=run.geo.bucket,
         repeated_device=torch.cuda.device_count() == 1)
    need(all(same.values()), "every sharded search byte-equal to "
         "engine.encode_batch on the card")
    need(launches == want_launches, "the sharded search's launches: per "
         "pass a stripe's vlc_pack and stream_concat, a dp row's table "
         "build and stitch")
    return launches["m7_size_2x2"]


def host_native_phase(card: str, rgb: np.ndarray, build_s: float,
                      tail_inputs, search_host: dict) -> None:
    """The port's C++ host helpers (sjpeg_tpu_torch.native): which version
    of each helper a method-4 size search and a shared-statistics encode
    call (the C++ one, never a twin, and words_to_scan neither, since the
    card stuffs the scans), the g++ build seconds, the main
    batch's scan tails in C++ and in the NumPy twin (same words, same
    bytes), and the host stages that run them: the method-0 breakdown's
    host_tail, the search breakdown (its node fit, in C++ and by the NumPy
    fit per pair for one image's luma, and its host_tail)."""
    from sjpeg_tpu_torch import adaptive, bitio, engine, huffman, native
    from sjpeg_tpu_torch import constants as C

    dev = torch.device(DEVICE)
    wn, tn, breakdown_tail = tail_inputs
    # each C++ helper and its twin
    names = {"words_to_scan": (bitio, "words_to_scan"),
             "huffman_codesizes": (huffman, "_codesizes_python"),
             "analyse_histo_nodes": (adaptive, "analyse_histo")}
    calls = {kind: dict.fromkeys(names, 0) for kind in ("native", "twin")}

    def counter(kind, key, fn):
        def wrapped(*a, **k):
            calls[kind][key] += 1
            return fn(*a, **k)
        return wrapped

    with contextlib.ExitStack() as stack:
        for key, (twin_mod, twin_name) in names.items():
            stack.enter_context(mock.patch.object(
                native, key, counter("native", key, getattr(native, key))))
            stack.enter_context(mock.patch.object(
                twin_mod, twin_name, counter("twin", key,
                                             getattr(twin_mod, twin_name))))
        engine.encode_batch(rgb, method4(C.YUV_420).set_target_size(
            200_000, passes=8), device=dev)
        engine.encode_batch(rgb, method4(C.YUV_420), share_statistics=True,
                            device=dev)
    # the card stuffs every scan (scan_stuff), so words_to_scan runs in
    # neither version there
    card_stuffed = calls["native"]["words_to_scan"] == 0
    impl = ("native" if all(v for k, v in calls["native"].items()
                            if k != "words_to_scan")
            and not any(calls["twin"].values()) else "twin")
    scans = {}
    tail_ms = {}
    for kind, fn in (("native", native.words_to_scan),
                     ("numpy_twin", bitio.words_to_scan)):
        t0 = time.perf_counter()
        scans[kind] = [fn(wn[i][:(int(tn[i]) + 31) // 32], int(tn[i]))
                       for i in range(len(tn))]
        tail_ms[kind] = (time.perf_counter() - t0) * 1e3
    emit("host_native", gpu=card, impl=impl, calls=calls,
         build_seconds=build_s, library=str(native._LIB._name).rsplit(
             "/", 1)[-1],
         scan_tail_ms=tail_ms, scan_bytes=sum(len(b) for b in
                                              scans["native"]),
         breakdown_host_tail_ms=breakdown_tail, **search_host)
    need(impl == "native", "every host helper ran its C++ version")
    need(card_stuffed, "no scan was stuffed on the host")
    need(scans["native"] == scans["numpy_twin"],
         "the C++ scan tail equals the NumPy twin on the main batch")


def profiling_phase(card: str, rgb: np.ndarray) -> None:
    """One traced encode_batch of the main batch with method 0 and with
    method 4 (utils/profiling.device_trace, after warm calls and
    prime_trace, inside a StageTimer stage that synchronises before it
    ends, the timer installed for the port's spans): the device's busy µs
    from the exported Chrome trace (benchmark/tracing.py's arithmetic), the
    window on the host clock, the idle share, the top device ops, the
    longest idle gaps and the spans the trace kept; StageTimer's report,
    written by log_jsonl and read back."""
    from benchmark import tracing
    from sjpeg_tpu_torch import constants as C
    from sjpeg_tpu_torch import engine, kernels
    from sjpeg_tpu_torch.utils.profiling import (StageTimer, device_trace,
                                                 log_jsonl, timing,
                                                 trace_spans)

    dev = torch.device(DEVICE)
    timer = StageTimer()
    pixels = BATCH * HEIGHT * WIDTH
    runs = {"m0": (method0(C.YUV_420), ("sample_pack", "stream_concat")),
            "m4": (method4(C.YUV_420), ("fdct", "merge_codesizes",
                                        "vlc_pack", "stream_concat"))}
    for name, (param, sources) in runs.items():
        untraced_ms = host_ms(lambda p=param: engine.encode_batch(
            rgb, p, device=dev), 3)
        logdir = kernels.BUILD_DIR / f"trace_{name}"
        shutil.rmtree(logdir, ignore_errors=True)
        stage = f"encode_batch_{name}"
        with device_trace(str(logdir)):
            tracing.prime_trace(dev)
            with timer.stage(stage, pixels), timing(timer), \
                    torch.profiler.record_function(stage):
                jpegs = engine.encode_batch(rgb, param, device=dev)
                torch.cuda.synchronize()
        spans = collections.Counter(sp["name"] for sp in trace_spans())
        files = sorted(logdir.glob("*.pt.trace.json"))
        need(len(files) == 1, f"device_trace wrote one trace ({name})")
        events = json.loads(files[0].read_text())["traceEvents"]
        marks = [e for e in events if e.get("name") == stage
                 and e.get("cat") == "user_annotation"]
        need(len(marks) == 1, f"the traced call's window ({name})")
        lo, hi = marks[0]["ts"], marks[0]["ts"] + marks[0]["dur"]
        summary = tracing.trace_summary(events, lo, hi, top=8, n_gaps=5)
        device_ops = sorted({e["name"] for e in
                             tracing.device_events(events, lo, hi)})
        window_us = timer.times[stage] * 1e6
        share = 1.0 - summary["busy_us"] / window_us
        missing = [src for src in sources
                   if not any(nm in op for nm in global_names(src)
                              for op in device_ops)]
        emit("profiling", gpu=card, method=name, images=len(jpegs),
             trace=f"{logdir.name}/{files[0].name}",
             trace_bytes=files[0].stat().st_size, window_us=window_us,
             trace_window_us=hi - lo, busy_us=summary["busy_us"],
             idle_share=share, untraced_ms=untraced_ms,
             top_device_ops=summary["top_device_ops"],
             longest_gaps=summary["longest_gaps"],
             device_op_kinds=len(device_ops), spans=dict(spans),
             path_kernels_missing=missing)
        need(0.0 <= share <= 1.0, f"the idle share is in [0, 1] ({name})")
        need(not missing, f"the {name} path's kernels are in the trace")
        need(any(op.startswith("Memcpy HtoD") for op in device_ops),
             f"the batch's upload is in the trace's window ({name})")
        need(all(spans[f"sjpeg.{sp}"] for sp in ("request", "upload",
                                                 "fetch", "tail")),
             f"the encode's spans are in the trace ({name})")
    report = timer.report()
    log = kernels.BUILD_DIR / "profiling.jsonl"
    log.unlink(missing_ok=True)
    log_jsonl(str(log), {"phase": "profiling", "stages": report})
    back = [json.loads(ln) for ln in log.read_text().splitlines()]
    emit("profiling_report", stage_timer=report, log_jsonl=back)
    need(len(back) == 1 and back[0]["stages"] == report
         and isinstance(back[0]["ts"], float),
         "log_jsonl's record reads back")


def inspector_phase(card: str) -> dict:
    """The inspector (sjpeg_tpu_torch.inspect_tool) on the card: risk_map
    on the card, at device="cpu" and through block_riskiness's loop on a
    256 x 256 crop of the 12-MP photo and on four 256 x 256 images of
    each AUTO mode; on the card against the CPU at 1000 x 750; its time
    on the photo; the quality sweep's encodes (qualities 20, 50, 90 at
    1000 x 750, an image AUTO converts to sharp 4:2:0) with the
    interactive loop's settings after the keys named (the default param,
    AUTO and method 4; `t`; `l`; `o` `a`, method 0 from the sharp planes,
    through quant_pack; `1` `o` `a`, method 0 from RGB, through
    sample_pack) on the card against device="cpu", with the kernels'
    launches counted over the card's encodes.  No PIL: the decode-based
    views (PSNR, error_map) are held by tier-1 only.  Returns
    {kernel: launches}."""
    from sjpeg_tpu_torch import constants as C
    from sjpeg_tpu_torch import inspect_tool, riskiness

    dev = torch.device(DEVICE)
    photo = make_rgb(1, 3024, 4032, SEED + 600)[0]
    crops = {"photo_crop_256": photo[:256, :256].copy()}
    crops.update((f"auto_mode_{i}", im)
                 for i, im in enumerate(four_mode_batch(256, 1)))
    exact = {}
    for name, im in crops.items():
        card_map = inspect_tool.risk_map(im, dev)
        cpu_map = inspect_tool.risk_map(im, device="cpu")
        loop = np.array([[riskiness.block_riskiness(
            im[8 * j:8 * j + 8, 8 * i:8 * i + 8])[0] for i in range(32)]
            for j in range(32)], np.float32)
        exact[name] = (card_map.tobytes() == cpu_map.tobytes()
                       == loop.tobytes())
    img = make_rgb(1, 750, 1000, SEED + 1300)[0]
    exact["card_vs_cpu_1000x750"] = (
        inspect_tool.risk_map(img, dev).tobytes()
        == inspect_tool.risk_map(img, device="cpu").tobytes())
    risk_ms = host_ms(lambda: inspect_tool.risk_map(photo, dev), 3)
    distinct = int(np.unique(inspect_tool.risk_map(photo, dev)).size)

    quals = (20, 50, 90)
    settings = {"default": {}, "t": {"use_trellis": True},
                "l": {"limit": True},
                "o_a": {"huffman_compress": False,
                        "adaptive_quantization": False},
                "1_o_a": {"yuv_mode": C.YUV_420, "huffman_compress": False,
                          "adaptive_quantization": False}}

    def sweeps(device):
        return {name: inspect_tool.sweep_jpegs(
            img, quals, lambda q, kw=kw: inspect_tool.session_param(
                quality=q, **kw), device)
            for name, kw in settings.items()}

    card_jpegs, launches = run_counted(lambda: sweeps(dev))
    cpu_jpegs = sweeps("cpu")
    same = {k: card_jpegs[k] == cpu_jpegs[k] for k in settings}
    emit("inspector", gpu=card, risk_map_exact=exact,
         risk_map_photo_12mp_ms=risk_ms, risk_map_photo_distinct=distinct,
         sweep_qualities=quals, sweep_width=1000, sweep_height=750,
         sweep_bytes={k: [len(j) for j in v] for k, v in card_jpegs.items()},
         sweep_cuda_equals_cpu=same, launches=launches,
         decode_views="PSNR and error_map decode with PIL, which this "
         "machine lacks: tier-1 holds them against sjpeg_tpu")
    need(all(exact.values()), "risk_map on the card equals the CPU and "
         "block_riskiness's loop")
    need(all(same.values()), "the inspector's encodes on the card equal "
         "device='cpu'")
    # single-image encodes build their optimal tables on the host
    # (engine._stage_one_pass), so merge_codesizes is not on this path
    need(all(v > 0 for k, v in launches.items() if k != "merge_codesizes"),
         "the inspector's encodes launched every kernel of their path")
    return launches


def cli_phase() -> None:
    """python -m sjpeg_tpu_torch.cli on a 256 x 256 PPM, with and without
    -sharp, on the card (two processes at once) against --device cpu."""
    from sjpeg_tpu_torch import cli, kernels

    work = kernels.BUILD_DIR / "cli_smoke"
    work.mkdir(parents=True, exist_ok=True)
    img = make_rgb(1, 256, 256, SEED + 900)[0]
    ppm = work / "in.ppm"
    ppm.write_bytes(b"P6\n256 256\n255\n" + img.tobytes())
    flag_sets = {"default": [], "sharp": ["-sharp"]}
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", "sjpeg_tpu_torch.cli", str(ppm), "-o",
         str(work / f"{name}_cuda.jpg"), "-quiet", *flags],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, flags in flag_sets.items()}
    same, rcs = {}, {}
    try:
        for name, flags in flag_sets.items():
            need(cli.main([str(ppm), "-o", str(work / f"{name}_cpu.jpg"),
                           "-quiet", "--device", "cpu", *flags]) == 0,
                 "the CLI on the CPU")
        for name, proc in procs.items():
            out = proc.communicate(timeout=300)[0]
            rcs[name] = proc.returncode
            if proc.returncode:
                print(out, file=sys.stderr)
            same[name] = (proc.returncode == 0
                          and (work / f"{name}_cuda.jpg").read_bytes()
                          == (work / f"{name}_cpu.jpg").read_bytes())
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    emit("cli", width=256, height=256, exit_codes=rcs,
         cuda_equals_cpu=same)
    need(all(same.values()), "the CLI's bytes on the card equal --device cpu")


if __name__ == "__main__":
    sys.exit(main())
