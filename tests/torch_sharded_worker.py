"""One process of the two-process sharded encode of
tests/test_torch_sharded_multiproc.py: joins a gloo group through a
file:// store, encodes its own local images on a mesh of CPU devices, and
pickles the JPEGs (and the passes each search ran) to
<out_dir>/<rank>.pkl.  Imports only the port."""

import pickle
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from sjpeg_tpu_torch.params import TARGET_SIZE

H, W = 40, 48          # 3 MCU rows at 4:2:0, the last partial
M0 = dict(huffman_compress=False, adaptive_quantization=False)
# name -> (EncoderParam keywords, local images, dp, sp)
CASES = {
    "m0": (dict(M0, quality=78), 2, 2, 2),
    "m4": (dict(quality=78), 2, 2, 2),
    "ragged_m1": (dict(adaptive_quantization=False, quality=78), 3, 4, 1),
    # a size search whose images converge after 1 pass on rank 0 and 4 on
    # rank 1: each process's loop ends on its own, with no collective
    "search_m4": (dict(quality=78, target_mode=TARGET_SIZE,
                       target_value=800.0, tolerance=5.0, passes=5),
                  2, 2, 2),
}


def images(rank: int, b: int) -> np.ndarray:
    """Process `rank`'s local batch: gradients plus seeded noise."""
    yy, xx = np.mgrid[0:H, 0:W]
    grad = np.stack([xx * 255 // (W - 1), yy * 255 // (H - 1),
                     (xx + yy) // 2 % 256], -1)
    out = [np.clip(grad + np.random.RandomState(1000 * rank + j).randint(
        -25, 25, grad.shape), 0, 255) for j in range(b)]
    return np.stack(out).astype(np.uint8)


def run(rank: int, world: int, init_method: str, out_dir: str) -> None:
    started = time.time()
    from sjpeg_tpu_torch import constants as C
    from sjpeg_tpu_torch.params import EncoderParam
    from sjpeg_tpu_torch.parallel import api
    from sjpeg_tpu_torch.parallel.mesh import init_distributed, make_mesh

    out = {"started": started, "passes": []}
    real = api._ShardedSearch.passes

    def passes(run):
        real(run)
        out["passes"].append(run.passes_run)

    api._ShardedSearch.passes = passes

    # the two processes share the host's cores (with each other and with
    # other test workers): intra-op threads would only spin on these tiny
    # tensors
    torch.set_num_threads(1)
    init_distributed(init_method, world, rank)
    try:
        for name, (kw, b, dp, sp) in CASES.items():
            mesh = make_mesh(dp, sp, [torch.device("cpu")] * (dp // world
                                                              * sp))
            out[name] = api.encode_batch_sharded(
                images(rank, b), EncoderParam(yuv_mode=C.YUV_420, **kw),
                mesh)
    finally:
        dist.destroy_process_group()
    Path(out_dir, f"{rank}.pkl").write_bytes(pickle.dumps(out))
