"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path, the method-0 batched encode
(sjpeg_tpu_torch.engine.encode_batch) at 16 x 1024 x 1024 RGB, 4:2:0, q75,
through the two CUDA kernels, and holds every kernel and every output
against the plain PyTorch versions on the same card.  Phases, one JSON line
each: probe, build, parity (each kernel vs its plain version at full size),
main_path (launch counts, bytes vs the plain-forced path), cases (4:4:4,
4:0:0, 1000 x 750, a bucket overflow, GPU vs CPU path), timing (CUDA events
and host clock), breakdown (host clock per stage).  Then the `kernels`
line, the card's name and power limit, and last
{"ok": true, "device": {...}}.  Any failure raises and exits non-zero;
without CUDA it exits 1 before printing any result.
"""

import json
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


def plain_forced():
    """Patch the engine's kernel calls with the plain versions (this
    script only: the package itself never falls back)."""
    from sjpeg_tpu_torch.ops import sample_pack, stream_concat
    return mock.patch.multiple(
        "sjpeg_tpu_torch.engine",
        sample_pack=mock.Mock(sample_pack=sample_pack.sample_pack_plain),
        stream_concat=mock.Mock(
            stream_concat=stream_concat.stream_concat_plain))


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
    from sjpeg_tpu_torch.ops import (colorspace, fdct, quantize,
                                     sample_pack, stream_concat)

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
    need(err1 == 0, "sample_pack bit-exact against its plain version")
    need(err2 == 0, "stream_concat bit-exact against its plain version")
    need(int(totals.max()) <= bucket * 32, "config 1 fits its bucket")

    # ---- 4. main path ---------------------------------------------------
    sample_pack.sample_pack.launches = 0
    stream_concat.stream_concat.launches = 0
    jpegs = engine.encode_batch(rgb, param, device=dev)
    launches = {"sample_pack": sample_pack.sample_pack.launches,
                "stream_concat": stream_concat.stream_concat.launches}
    with plain_forced():
        plain_jpegs = engine.encode_batch(rgb, param, device=dev)
    same = jpegs == plain_jpegs
    emit("main_path", images=len(jpegs), launches=launches,
         bytes_total=sum(len(j) for j in jpegs), byte_equal_plain=same)
    need(all(v > 0 for v in launches.values()), "main path ran both kernels")
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
    sc_fn = kernels.function("stream_concat", "sjpeg_stream_concat",
                             stream_concat._ARGTYPES)
    lens = bits.long().reshape(BATCH, -1)
    offs = (torch.cumsum(lens, 1) - lens).reshape(-1)
    stream = torch.cuda.current_stream().cuda_stream

    def launch_sample_pack():
        kernels.check(sp_fn(sinter.data_ptr(), sinter.element_size(),
                            dc.data_ptr(), group.data_ptr(),
                            *(t.data_ptr() for t in tables),
                            words.data_ptr(), bits.data_ptr(), n, stream),
                      "sample_pack")

    def launch_stream_concat():
        kernels.check(sc_fn(words.data_ptr(), bits.data_ptr(),
                            offs.data_ptr(), out.data_ptr(), n, n // BATCH,
                            bucket, stream), "stream_concat")

    sp_ms = event_ms(launch_sample_pack, 20)
    sc_ms = event_ms(launch_stream_concat, 20)
    sp_plain_ms = event_ms(lambda: sample_pack.sample_pack_plain(
        sinter, dc, group, *tables), 3)
    sc_plain_ms = event_ms(lambda: stream_concat.stream_concat_plain(
        words, bits, BATCH, bucket), 3)
    e2e_ms = host_ms(lambda: engine.encode_batch(rgb, param, device=dev), 5)
    mpx = BATCH * HEIGHT * WIDTH / 1e6
    emit("timing", gpu=card, sample_pack_ms=sp_ms,
         sample_pack_plain_ms=sp_plain_ms, stream_concat_ms=sc_ms,
         stream_concat_plain_ms=sc_plain_ms, encode_batch_ms=e2e_ms,
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
    sc_bytes = used_words * 4 + 12 * n + BATCH * bucket * 4
    sc_ops = used_words * 12
    rows = []
    for name, src_file, replaces, ms, plain, nbytes, ops, err in [
            ("sample_pack", "sjpeg_tpu_torch/csrc/sample_pack.cu",
             "sjpeg_tpu/ops/pallas_quant_pack.py:340", sp_ms, sp_plain_ms,
             sp_bytes, sp_ops, err1),
            ("stream_concat", "sjpeg_tpu_torch/csrc/stream_concat.cu",
             "sjpeg_tpu/ops/pallas_tree_concat.py:371", sc_ms, sc_plain_ms,
             sc_bytes, sc_ops, err2)]:
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = ops / H100_OPS_PER_S * 1e3
        rows.append({"name": name, "route": "cuda", "source": src_file,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain,
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "library_ms": None, "bytes": nbytes, "operations": ops})
    print(json.dumps({"kernels": rows}), flush=True)
    print(gpu_name_and_limit(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
