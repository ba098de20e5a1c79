"""Where sjpeg_tpu_torch's encode_pipelined spends its time on one GPU.

    python3 scripts/torch_serving_probe.py [--reps 3]

Four method-0 batches of 16 x 1024 x 1024 RGB (4:2:0, q75), as
chip_smoke.py's serving phase encodes them, timed on the host clock
(median of --reps, after a warm-up; torch.cuda.synchronize() on either
side) as wall ms per batch in variants that change one thing at a time:

- sequential: encode_batch on each batch in turn;
- pipelined_depth{1,2,3}: encode_pipelined at that depth;
- pipelined_depth2_pageable: depth 2, the upload from pageable memory
  (no pinning);
- pipelined_depth2_switch_0.5ms: depth 2 with the interpreter's thread
  switch interval at 0.5 ms instead of 5 ms;
- threads_depth2_default_stream: two threads calling encode_batch on
  the default stream;
- sequential_pinned: encode_batch on batches pinned beforehand.

Then the same for one method-4 batch list (sequential and depth 2).
Prints one JSON line, then the card's name and power limit.  Needs CUDA.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from sjpeg_tpu_torch import constants as C  # noqa: E402
from sjpeg_tpu_torch import engine  # noqa: E402
from sjpeg_tpu_torch.params import EncoderParam  # noqa: E402


def batches_of(seed: int) -> list:
    """chip_smoke.py's batch (noise over gradients, saturated patches)
    and three cheap variants of it."""
    rng = np.random.RandomState(seed)
    h = w = 1024
    yy, xx = np.mgrid[0:h, 0:w]
    grad = np.stack([xx * 255 // w, yy * 255 // h, (xx + yy) % 256], -1)
    rgb = np.empty((16, h, w, 3), np.uint8)
    for i in range(16):
        noise = rng.randint(-24 - 4 * i, 24 + 4 * i, (h, w, 3))
        rgb[i] = np.clip(grad + noise, 0, 255)
    rgb[:, :32, :32] = [0, 0, 255]
    rgb[:, -32:, -32:] = [255, 0, 0]
    return [rgb, np.ascontiguousarray(rgb[:, ::-1]),
            np.ascontiguousarray(rgb[:, :, ::-1]), 255 - rgb]


def wall_ms(fn, reps: int, n: int) -> float:
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / n)
    return statistics.median(times)


def variants(batches, param, reps: int) -> dict:
    dev = torch.device("cuda")
    n = len(batches)

    def sequential(bs=batches):
        return [engine.encode_batch(b, param, device=dev) for b in bs]

    def pipelined(depth):
        return lambda: list(engine.encode_pipelined(batches, param,
                                                    depth=depth, device=dev))

    def pageable():
        with mock.patch.object(engine, "_upload",
                               lambda b, d: torch.from_numpy(b).to(d)):
            return pipelined(2)()

    def switch():
        old = sys.getswitchinterval()
        sys.setswitchinterval(0.0005)
        try:
            return pipelined(2)()
        finally:
            sys.setswitchinterval(old)

    def threads_default_stream():
        with ThreadPoolExecutor(max_workers=2) as pool:
            return list(pool.map(lambda b: engine.encode_batch(
                b, param, device=dev), batches))

    pinned = [torch.from_numpy(b).pin_memory() for b in batches]
    want = sequential()
    runs = {"sequential": sequential,
            "pipelined_depth1": pipelined(1),
            "pipelined_depth2": pipelined(2),
            "pipelined_depth3": pipelined(3),
            "pipelined_depth2_pageable": pageable,
            "pipelined_depth2_switch_0.5ms": switch,
            "threads_depth2_default_stream": threads_default_stream,
            "sequential_pinned": lambda: sequential(pinned)}
    out = {}
    for name, fn in runs.items():
        if fn() != want:
            raise RuntimeError(f"{name}: bytes differ from encode_batch")
        out[name] = wall_ms(fn, reps, n)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    reps = ap.parse_args().reps
    if not torch.cuda.is_available():
        print("torch_serving_probe: CUDA is not available", file=sys.stderr)
        return 1
    batches = batches_of(1234)
    m0 = EncoderParam(yuv_mode=C.YUV_420, huffman_compress=False,
                      adaptive_quantization=False)
    m4 = EncoderParam(yuv_mode=C.YUV_420)
    result = {"method0_ms_per_batch": variants(batches, m0, reps)}
    dev = torch.device("cuda")
    result["method4_ms_per_batch"] = {
        "sequential": wall_ms(lambda: [engine.encode_batch(b, m4, device=dev)
                                       for b in batches], reps, 4),
        "pipelined_depth2": wall_ms(lambda: list(engine.encode_pipelined(
            batches, m4, depth=2, device=dev)), reps, 4)}
    print(json.dumps({"serving_probe": result,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
