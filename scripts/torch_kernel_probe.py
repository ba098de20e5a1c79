"""Time variants of the port's sample_pack and trellis kernels side by side
on one GPU, on the same inputs.

    python3 scripts/torch_kernel_probe.py [--tree NAME=DIR ...] [--reps 20]

Each variant is a kernel source (`sjpeg_tpu_torch/csrc/<kernel>.cu` of this
tree, or of another checkout unpacked in DIR) built by nvcc with the
port's flags in a temporary directory under `sjpeg_tpu_torch/_build/`,
removed at exit.  Inputs are chip_smoke.py's main
configuration, 16 x 1024 x 1024 RGB, 4:2:0, q75 (N = 393,216 blocks):
method 0's interleaved int16 samples, K.3 tables, shared and per-image
(16 quantizer sets); method 7's coefficients, fitted per-image matrices
and the K.3 rate table, and the same rows sorted by search work with
shared matrices.  Each variant's output is held against the plain
PyTorch version; each launch is timed with CUDA events, median of --reps after a warm-up, the
variants in turn, twice (a, b).  Prints one JSON line with every time,
error and ptxas line, then the card's name and power limit.  Needs CUDA
and nvcc.
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

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from sjpeg_tpu_torch import constants as C  # noqa: E402
from sjpeg_tpu_torch import engine, kernels, pipeline, state  # noqa: E402
from sjpeg_tpu_torch.huffman import (k3_default_tables,  # noqa: E402
                                     trellis_cost_lens)
from sjpeg_tpu_torch.ops import colorspace, sample_pack, trellis  # noqa: E402

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


def sample_pack_inputs(dev):
    """Method 0's samples, DC codes and groups, shared and per-image tables."""
    rgb = chip_smoke.make_rgb(16, 1024, 1024, chip_smoke.SEED)
    param = chip_smoke.method0(C.YUV_420)
    layout = pipeline.component_layout(C.YUV_420, 1024, 1024)
    shared = state.tables_from_numpy(
        *engine._quant_arrays(engine._quant_matrices(param)),
        *engine._host_luts(k3_default_tables()), dev)
    blocks = colorspace.rgb_to_blocks(torch.from_numpy(rgb).to(dev),
                                      C.YUV_420, 1024, 1024)
    samples, dc, group = engine._interleave_samples(
        blocks, shared[0], shared[1], tuple(layout.nb_blocks), 16)
    per_image = chip_smoke.search_inputs(rgb, C.YUV_420,
                                         [40 + 3 * i for i in range(16)])
    return (samples, dc, group, shared), per_image


def trellis_inputs(dev):
    """Method 7's coefficients, groups, per-image matrices and the K.3 rate
    table; the rows sorted by search work with shared matrices."""
    rgb = chip_smoke.make_rgb(16, 1024, 1024, chip_smoke.SEED)
    param = chip_smoke.method7(C.YUV_420)
    layout = pipeline.component_layout(C.YUV_420, 1024, 1024)
    coeffs, histos = engine._stage_batch_coeffs(
        torch.from_numpy(rgb).to(dev), "rgb", C.YUV_420, 1024, 1024, True,
        16)
    per_qms, quant = engine._fit_quantizers(histos, param, 2, 16, False)
    iq, ib = state.arrays_to_device(*quant, device=dev)
    qq, lt = state.arrays_to_device(engine._clamped_quant(per_qms, False),
                                    trellis_cost_lens(), device=dev)
    cinter, _, group = engine._interleave_coeffs(
        coeffs, iq, ib, tuple(layout.nb_blocks), 16)
    shared = state.arrays_to_device(*engine._quant_arrays(per_qms[0]),
                                    engine._clamped_quant(per_qms, True),
                                    device=dev)
    return ((cinter, group, iq, ib, qq, lt),
            (*chip_smoke.sorted_by_search_work(cinter, group, *shared[:2]),
             *shared, lt))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", default=[],
                    metavar="NAME=DIR",
                    help="another checkout whose sjpeg_tpu_torch/csrc to "
                         "compare, e.g. parent=_archive/parent")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_probe: CUDA is not available", file=sys.stderr)
        return 1
    kernels.BUILD_DIR.mkdir(exist_ok=True)
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    trees = {"change": REPO / "sjpeg_tpu_torch" / "csrc"}
    for spec in args.tree:
        name, path = spec.split("=", 1)
        trees[name] = Path(path) / "sjpeg_tpu_torch" / "csrc"

    tmp = Path(tempfile.mkdtemp(prefix="probe_", dir=kernels.BUILD_DIR))
    keys = [(kernel, tree) for kernel in ("sample_pack", "trellis")
            for tree in trees]
    libs = {key: tmp / f"lib{key[0]}_{key[1]}.so" for key in keys}
    try:
        with ThreadPoolExecutor(len(keys)) as pool:   # one nvcc each, at once
            ptxas = dict(zip(("/".join(k) for k in keys), pool.map(
                lambda k: build(trees[k[1]], k[0], libs[k]), keys)))
        libs = {key: ctypes.CDLL(str(lib)) for key, lib in libs.items()}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)  # loaded libraries stay mapped

    (sp_shared, sp_per_image) = sample_pack_inputs(dev)
    tr_path, tr_sorted = trellis_inputs(dev)
    n = sp_shared[0].shape[0]
    words = torch.empty((n, 64), dtype=torch.int32, device=dev)
    bits = torch.empty((n,), dtype=torch.int32, device=dev)
    levels = torch.empty((n, 64), dtype=torch.int32, device=dev)

    def sp_launch(lib, inputs, n_sets):
        samples, dc, group, tables = inputs
        fn = lib.sjpeg_sample_pack
        fn.argtypes = sample_pack._ARGTYPES
        return lambda: kernels.check(fn(
            samples.data_ptr(), samples.element_size(), dc.data_ptr(),
            group.data_ptr(), *(t.data_ptr() for t in tables),
            words.data_ptr(), bits.data_ptr(), n, n // n_sets, n_sets,
            stream), "sample_pack")

    def tr_launch(lib, inputs):
        c, grp, a, b, q, r = inputs
        fn = lib.sjpeg_trellis
        fn.argtypes = trellis._ARGTYPES
        return lambda: kernels.check(fn(
            c.data_ptr(), grp.data_ptr(), a.data_ptr(), b.data_ptr(),
            q.data_ptr(), r.data_ptr(), levels.data_ptr(), n, n // 16,
            1 if a.dim() == 2 else 16, 1 if r.dim() == 2 else 16, stream),
            "trellis")

    sp_cases = {"shared": ((*sp_shared[:3], sp_shared[3]), 1),
                "per_image": ((*sp_per_image[:3], sp_per_image[3:]), 16)}
    tr_cases = {"per_image_mats": tr_path, "sorted_rows": tr_sorted}
    want = {("sample_pack", c): sample_pack.sample_pack_plain(
                inp[0], inp[1], inp[2], *inp[3])
            for c, (inp, _) in sp_cases.items()}
    want.update({("trellis", c): trellis.trellis_quantize_plain(
                     inp[0], *inp[2:5], inp[1], inp[5], 16)
                 for c, inp in tr_cases.items()})

    launches, errors = {}, {}
    for (kernel, variant), lib in libs.items():
        cases = sp_cases if kernel == "sample_pack" else tr_cases
        for case, spec in cases.items():
            key = f"{kernel}/{variant}/{case}"
            launches[key] = (sp_launch(lib, *spec) if kernel == "sample_pack"
                             else tr_launch(lib, spec))
            launches[key]()
            torch.cuda.synchronize()
            got = (words, bits) if kernel == "sample_pack" else (levels,)
            ref = want[(kernel, case)]
            ref = ref if isinstance(ref, tuple) else (ref,)
            errors[key] = max(int((x.long() - y.long()).abs().max())
                              for x, y in zip(got, ref))
    ms = {}
    for turn in ("a", "b"):
        for key, fn in launches.items():
            ms.setdefault(key, {})[turn] = chip_smoke.event_ms(fn, args.reps)
    card = chip_smoke.gpu_name_and_limit()
    print(json.dumps({"gpu": card, "ms": ms, "max_abs_err": errors,
                      "ptxas": ptxas, "blocks": n}), flush=True)
    print(card, flush=True)
    return 0 if all(e == 0 for e in errors.values()) else 2


if __name__ == "__main__":
    sys.exit(main())
