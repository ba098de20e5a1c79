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
- trellis: method 7's coefficients with fitted per-image matrices, and the
  same rows sorted by search work with shared matrices;
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
- fdct: int32 samples; quant_pack: coefficients with K.3 tables.
Each variant's output is held against the plain PyTorch version; the
variants of a case write to the same output buffers.  Each call is timed
with CUDA events, median of --reps after a warm-up, the variants in turn,
twice (a, b).  torch.profiler then traces 5 more calls of each variant and
reports each kernel it launched (a stream_concat op's zero fill, chunk
sums and placement; the parent table build's some 70 kernels) with its
launches and device microseconds a call (chip_smoke.device_kernels), and
their sum a call.
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
from sjpeg_tpu_torch import engine, kernels, pipeline, state  # noqa: E402
from sjpeg_tpu_torch.huffman import (k3_default_tables,  # noqa: E402
                                     trellis_cost_lens)
from sjpeg_tpu_torch.ops import (colorspace, fdct,  # noqa: E402
                                 huffman_device, merge_codesizes, quant_pack,
                                 sample_pack, stream_concat, trellis,
                                 vlc_pack)

KERNELS = ("stream_concat", "vlc_pack", "sample_pack", "trellis",
           "merge_codesizes", "fdct", "quant_pack")
B, H, W = chip_smoke.BATCH, chip_smoke.HEIGHT, chip_smoke.WIDTH
PHOTO = (3024, 4032)             # height, width of the single-image case


def build(csrc: Path, name: str, lib: Path):
    """nvcc csrc/<name>.cu -> lib; returns ptxas's register and spill
    lines."""
    res = subprocess.run([kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o",
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


def trellis_inputs(rgb, dev):
    """Method 7's coefficients, groups, per-image matrices and the K.3 rate
    table; the rows sorted by search work with shared matrices."""
    param = chip_smoke.method7(C.YUV_420)
    nb = tuple(pipeline.component_layout(C.YUV_420, W, H).nb_blocks)
    coeffs, histos = engine._stage_batch_coeffs(
        torch.from_numpy(rgb).to(dev), "rgb", C.YUV_420, W, H, True, B)
    per_qms, quant = engine._fit_quantizers(histos, param, 2, B, False)
    iq, ib = state.arrays_to_device(*quant, device=dev)
    qq, lt = state.arrays_to_device(engine._clamped_quant(per_qms, False),
                                    trellis_cost_lens(), device=dev)
    cinter, _, group = engine._interleave_coeffs(coeffs, iq, ib, nb, B)
    shared = state.arrays_to_device(*engine._quant_arrays(per_qms[0]),
                                    engine._clamped_quant(per_qms, True),
                                    device=dev)
    return {"per_image_mats": (cinter, group, iq, ib, qq, lt),
            "sorted_rows": (*chip_smoke.sorted_by_search_work(
                cinter, group, *shared[:2]), *shared, lt)}


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
        cases["trellis"] = trellis_inputs(rgb, dev)
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
        c, g, a, b, q, r = args
        return (trellis.trellis_quantize_plain(c, a, b, q, g, r, B),)
    if kernel == "merge_codesizes":
        return [t for out in chip_smoke.plain_tables(*args) for t in out]
    if kernel == "fdct":
        return (fdct.fdct_blocks_plain(*args),)
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

    if kernel == "trellis":
        c, g, a, b, q, r = args
        n = c.shape[0]
        levels = buffers.setdefault("levels", torch.empty_like(c))
        f = fn("sjpeg_trellis", trellis._ARGTYPES)

        def run():
            check(f(c.data_ptr(), g.data_ptr(), a.data_ptr(), b.data_ptr(),
                    q.data_ptr(), r.data_ptr(), levels.data_ptr(), n, n // B,
                    1 if a.dim() == 2 else B, 1 if r.dim() == 2 else B,
                    stream))
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", default=[],
                    metavar="NAME=DIR",
                    help="another checkout whose sjpeg_tpu_torch/csrc to "
                         "compare, e.g. parent=_archive/parent")
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help="comma-separated subset of " + ",".join(KERNELS))
    ap.add_argument("--reps", type=int, default=20)
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

    tmp = Path(tempfile.mkdtemp(prefix="probe_", dir=kernels.BUILD_DIR))
    keys = [(kernel, tree) for kernel in wanted for tree in trees]
    libs = {key: tmp / f"lib{key[0]}_{key[1]}.so" for key in keys}
    try:
        with ThreadPoolExecutor(len(keys)) as pool:   # one nvcc each, at once
            ptxas = dict(zip(("/".join(k) for k in keys), pool.map(
                lambda k: build(trees[k[1]], k[0], libs[k]), keys)))
        libs = {key: ctypes.CDLL(str(lib)) for key, lib in libs.items()}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)  # loaded libraries stay mapped

    cases = make_cases(dev, set(wanted))
    launches, errors, buffers = {}, {}, {}
    for (kernel, variant), lib in libs.items():
        for case, inputs in cases[kernel].items():
            key = f"{kernel}/{variant}/{case}"
            launches[key] = launcher(kernel, lib, inputs, stream,
                                     buffers.setdefault((kernel, case), {}))
            got = launches[key]()
            want = plain(kernel, inputs)
            torch.cuda.synchronize()
            errors[key] = chip_smoke.max_err(zip(got, want))
            del got, want
    ms = {}
    for turn in ("a", "b"):
        for key, fn in launches.items():
            ms.setdefault(key, {})[turn] = chip_smoke.event_ms(fn, args.reps)
    profile = {key: chip_smoke.device_kernels(fn, 5)
               for key, fn in launches.items()}
    device_us = {key: sum(v["us"] for v in kern.values())
                 for key, kern in profile.items()}
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
                      "ptxas": ptxas,
                      "blocks": B * H * W * 3 // 2 // 64}), flush=True)
    print(card, flush=True)
    return 0 if all(e == 0 for e in errors.values()) else 2


if __name__ == "__main__":
    sys.exit(main())
