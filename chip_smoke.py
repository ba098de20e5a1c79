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
  m4_breakdown;
- method 7 (method 4 with trellis quantization), through trellis,
  merge_codesizes, vlc_pack and stream_concat.  Phases: tr_parity (the
  trellis kernel with per-image and shared matrices and per-image rate
  tables, and on rows sorted by search work; the table kernel on the
  trellis's frequencies), tr_path, tr_cases (shared
  statistics, 4:4:4, 4:0:0, 1000 x 750, NV12, q40, q90, an overflow
  re-pack, GPU vs CPU path), tr_timing, tr_breakdown;
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
  batches vs encode_batch, and encode_many on mixed shapes vs encode_rgb).

One JSON line each.  Then the `kernels` line (each kernel's device
microseconds a launch from a torch.profiler trace beside its CUDA-event
times), the card's name and power limit, and last
{"ok": true, "device": {...}}.  Any failure raises and
exits non-zero; without CUDA it exits 1 before printing any result.
"""

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
    script only: the package itself never falls back).  fdct, quant_pack
    and the table build are patched on their own modules, which every
    caller reads them from."""
    from sjpeg_tpu_torch.ops import (fdct, huffman_device, merge_codesizes,
                                     quant_pack, sample_pack, stream_concat,
                                     trellis, vlc_pack)
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
                              quant_pack.quant_pack_plain):
        yield


def plain_tables(jobs):
    """merge_codesizes.optimal_tables' results from the plain version."""
    from sjpeg_tpu_torch.ops import huffman_device
    return [huffman_device.optimal_code_luts_plain(f, size, lut, True)
            for f, size, lut in jobs]


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


def kernel_us(fn, source: str, calls: int = 5, trace=None) -> float:
    """Device microseconds of one launch of each kernel of csrc/<source>.cu
    that fn runs, summed over those kernels: the mean over the launches
    that torch.profiler recorded in `calls` calls (or in a device_kernels
    trace), which may be fewer than the calls made."""
    names = global_names(source)
    trace = trace if trace is not None else device_kernels(fn, calls)
    return sum(v["us"] / v["launches"] for k, v in trace.items()
               if v["launches"] and any(nm in k for nm in names))


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
                                     quantize, sample_pack, stream_concat,
                                     vlc_pack)

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
    ptxas = [ln.strip() for log in logs.values() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", seconds=build_s, libraries=sorted(logs), ptxas=ptxas)
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
    sc_trace = device_kernels(stream_concat_op)
    sc_kernel_launches = sum(v["launches"] for k, v in sc_trace.items()
                             if any(nm in k for nm in sc_names))
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
    tn = t_.cpu().numpy()
    wn = stage("fetch", lambda: engine.fetch_streams_batch(o_, tn))
    stage("host_tail", lambda: [engine._assemble_jpeg(
        layout, param, qms, k3_default_tables(),
        engine._finalize_scan_bytes(wn[i], int(tn[i])))
        for i in range(BATCH)])
    emit("breakdown", gpu=card, ms=stages, fetched_words=int(wn.size))

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
                   device_us=kernel_us(None, "stream_concat",
                                       trace=sc_trace),
                   redesigned=True)]
    del words, bits, pwords, pbits, out, pout, sinter, blocks, src
    torch.cuda.empty_cache()
    rows += method4_phases(card, rgb, vlc_long_err)
    torch.cuda.empty_cache()
    by_name = {r["name"]: r for r in rows}
    tr_rows, tr_table_err = trellis_phases(card, rgb)
    by_name["merge_codesizes"]["max_abs_err"] = max(
        by_name["merge_codesizes"]["max_abs_err"], tr_table_err)
    rows += tr_rows
    by_name.update((r["name"], r) for r in tr_rows)
    torch.cuda.empty_cache()
    search_row, rate_launches = search_phases(card, rgb)
    by_name["trellis"]["search_per_image_rate_launches"] = rate_launches
    rows.append(search_row)
    torch.cuda.empty_cache()
    rows += single_phases(card, rgb, qp_long_err)
    torch.cuda.empty_cache()
    serving_phases(card, rgb)
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


def sorted_by_search_work(cinter, group, iquant, ibias):
    """The trellis rows (with their groups) by search work, densest first,
    so that a warp's rows cost about the same; for shared matrices and
    rate table only, since per-image sets follow the row index, which the
    permutation breaks."""
    from sjpeg_tpu_torch.ops import trellis

    order = torch.argsort(trellis.row_evaluations(cinter, iquant, ibias,
                                                  group),
                          descending=True, stable=True)
    return cinter[order].contiguous(), group[order].contiguous()


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
    _, quant = engine._fit_quantizers(histos, param, 2, b, False)
    iq, ib = state.arrays_to_device(*quant, device=dev)
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
    from sjpeg_tpu_torch import engine, kernels, pipeline, state
    from sjpeg_tpu_torch.ops import (huffman_device, merge_codesizes,
                                     sample_pack, stream_concat, vlc_pack)
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
    mc_op_trace = device_kernels(tables_op, 5)
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
    qms, qa = stage("host_fit", lambda: engine._fit_quantizers(
        hi, param, 2, BATCH, False))
    vs, fr = stage("quantize_interleave_stats", lambda: (
        engine._stage_batch_quantize(
            co, *state.arrays_to_device(*qa, device=dev), True, nb, BATCH,
            BATCH)))
    del co
    huffman_device.optimal_code_luts.any_reads = 0
    dl, al, _, desc = stage("tables", lambda: engine._stage_tables(
        fr, flags, 2, BATCH, False, dev))
    any_reads = huffman_device.optimal_code_luts.any_reads
    w_, b_ = stage("vlc_pack", lambda: vlc_pack.vlc_pack(
        vs[0]["run"], vs[0]["size"], vs[0]["code"], vs[1], vs[2], dl, al))
    o_, t_ = stage("stream_concat", lambda: stream_concat.stream_concat(
        w_, b_, BATCH, bucket))

    def fetch():
        tn = t_.cpu().numpy()
        return tn, engine.fetch_streams_batch(o_, tn), desc.cpu().numpy()

    tn, wn, flat = stage("fetch", fetch)
    stage("host_tail", lambda: [engine._assemble_jpeg(
        layout, param, qms[i], huffman_device.tables_from_flat(flat, i, 2),
        engine._finalize_scan_bytes(wn[i], int(tn[i])))
        for i in range(BATCH)])
    emit("m4_breakdown", gpu=card, ms=stages, any_reads=any_reads,
         fetched_words=int(wn.size))

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


def trellis_phases(card: str, rgb: np.ndarray) -> list:
    """The method-7 path on the same batch: tr_parity, tr_path, tr_cases,
    tr_timing and tr_breakdown; returns the trellis kernel row and the
    table kernel's error on the trellis's frequencies."""
    from sjpeg_tpu_torch import constants as C
    from sjpeg_tpu_torch import engine, kernels, pipeline, state
    from sjpeg_tpu_torch.huffman import trellis_cost_lens
    from sjpeg_tpu_torch.ops import (huffman_device, merge_codesizes,
                                     sample_pack, stream_concat, trellis,
                                     vlc_pack)
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
    per_qms, quant = engine._fit_quantizers(histos, param, 2, BATCH, False)
    iq, ib = state.arrays_to_device(*quant, device=dev)
    qq, lt = state.arrays_to_device(engine._clamped_quant(per_qms, False),
                                    trellis_cost_lens(), device=dev)
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
    shared = state.arrays_to_device(*engine._quant_arrays(per_qms[0]),
                                    engine._clamped_quant(per_qms, True),
                                    device=dev)
    variants = {"per_image_mats": (iq, ib, qq, lt),
                "shared_mats": (*shared, lt),
                "per_image_rates": (iq, ib, qq, lt_img)}
    csorted, gsorted = sorted_by_search_work(cinter, group, *shared[:2])
    errs = {}
    for name, (a, b, q, r) in [*variants.items(),
                               ("sorted_rows", variants["shared_mats"])]:
        rows, grp = ((csorted, gsorted) if name == "sorted_rows"
                     else (cinter, group))
        got = trellis.trellis_quantize(rows, a, b, q, grp, r, BATCH)
        want = trellis.trellis_quantize_plain(rows, a, b, q, grp, r, BATCH)
        torch.cuda.synchronize()
        errs[name] = max_err([(got, want)])
        del got, want
    evaluations = trellis.search_evaluations(cinter, iq, ib, group, BATCH)
    emit("tr_parity", blocks=n, max_abs_err=errs,
         table_max_abs_err=table_err,
         nonzero_ac_levels=int((levels[:, 1:] != 0).sum()),
         evaluated_scores=evaluations)
    need(all(e == 0 for e in errs.values()),
         "trellis bit-exact against its plain version (every variant)")
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
    tr_fn = kernels.function("trellis", "sjpeg_trellis", trellis._ARGTYPES)
    stream = torch.cuda.current_stream().cuda_stream

    def launch_trellis(a, b, q, r, coeffs=cinter, grp=group):
        kernels.check(tr_fn(coeffs.data_ptr(), grp.data_ptr(),
                            a.data_ptr(), b.data_ptr(), q.data_ptr(),
                            r.data_ptr(), levels.data_ptr(), n, n // BATCH,
                            1 if a.dim() == 2 else BATCH,
                            1 if r.dim() == 2 else BATCH, stream), "trellis")

    tr_ms = {k: event_ms(lambda v=v: launch_trellis(*v), 20)
             for k, v in variants.items()}
    # all-zero blocks open no node: the kernel's cost without its search
    zeros = torch.zeros_like(cinter)
    tr_ms["zero_blocks"] = event_ms(lambda: launch_trellis(
        *variants["per_image_mats"], coeffs=zeros), 20)
    del zeros
    # against shared_mats: the same work without divergence across a warp
    tr_ms["sorted_rows"] = event_ms(lambda: launch_trellis(
        *variants["shared_mats"], coeffs=csorted, grp=gsorted), 20)
    del csorted, gsorted
    tr_us = kernel_us(lambda: launch_trellis(*variants["per_image_mats"]),
                      "trellis")
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
    qms, qa = stage("host_fit", lambda: engine._fit_quantizers(
        hi, param, 2, BATCH, False))
    i_, b_, q_, l_ = stage("upload_tables", lambda: state.arrays_to_device(
        *qa, engine._clamped_quant(qms, False), trellis_cost_lens(),
        device=dev))
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

    def fetch():
        tn = t_.cpu().numpy()
        return tn, engine.fetch_streams_batch(o_, tn), desc.cpu().numpy()

    tn, wn, flat = stage("fetch", fetch)
    stage("host_tail", lambda: [engine._assemble_jpeg(
        layout, param, qms[i], huffman_device.tables_from_flat(flat, i, 2),
        engine._finalize_scan_bytes(wn[i], int(tn[i])))
        for i in range(BATCH)])
    emit("tr_breakdown", gpu=card, ms=stages, any_reads=any_reads,
         fetched_words=int(wn.size))

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
    freqs = engine_search._search_component_freqs(prep["coeffs"], iq3, ib3,
                                                  b)
    dcl, acl, _, _ = huffman_device.luts_and_desc_from_freqs(
        *freqs, 2 if len(nb) > 1 else 1)
    dc = engine._dc_codes(prep["coeffs"], iq3, ib3, nb, b)
    return prep["sinter"], dc, prep["group"], iq3, ib3, dcl, acl


def search_phases(card: str, rgb: np.ndarray):
    """The batched target-size search on the same batch: search_parity,
    search_path, search_cases, search_timing and search_breakdown; returns
    the per-image sample_pack row and the trellis's [B, 2, 256]
    rate-table launches in the method-7 search."""
    from sjpeg_tpu_torch import constants as C
    from sjpeg_tpu_torch import engine, engine_search, kernels
    from sjpeg_tpu_torch.ops import (fdct, merge_codesizes, quantize,
                                     sample_pack, stream_concat, trellis,
                                     vlc_pack)

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
         fetched_words=int(picked[0].size))
    need(out == jpegs, "the staged search gives the same bytes")

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
    return row, rate_launches


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


if __name__ == "__main__":
    sys.exit(main())
