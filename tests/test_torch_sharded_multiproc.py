"""The port's sharded API across two processes: dp laid across them, each
with a (1, 2) or (2, 1) grid of CPU devices, joined by gloo through a
file:// store (no TCP port).  The processes are spawned once for the file
(torch.multiprocessing) and import only the port; each encodes its own
local images, and its JPEGs must equal sjpeg_tpu.engine.encode_batch of
the global batch (rank 0's images, then rank 1's), byte for byte, for
method 0, method 4, a ragged local batch (3 images on dp = 4) and a size
search whose processes stop after different numbers of passes."""

import pickle
import time

import pytest
import torch.multiprocessing as mp

from sjpeg_tpu import constants as JC
from sjpeg_tpu import engine as jengine
from sjpeg_tpu.params import EncoderParam as JaxParam

import numpy as np
import torch_sharded_worker as worker

WORLD = 2


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded_mp")
    t0 = time.time()
    mp.start_processes(worker.run, args=(WORLD, f"file://{d / 'store'}",
                                         str(d)),
                       nprocs=WORLD, join=True, start_method="spawn")
    out = [pickle.loads((d / f"{r}.pkl").read_bytes())
           for r in range(WORLD)]
    return out, max(o["started"] for o in out) - t0


@pytest.mark.parametrize("name", list(worker.CASES))
def test_two_processes_match_jax(spawned, name, record_property):
    out, startup = spawned
    record_property("spawn_startup_s", round(startup, 2))
    kw, b, _, _ = worker.CASES[name]
    glob = np.concatenate([worker.images(r, b) for r in range(WORLD)])
    want = jengine.encode_batch(glob, JaxParam(yuv_mode=JC.YUV_420, **kw))
    got = [jpeg for o in out for jpeg in o[name]]
    assert len(got) == len(want) == WORLD * b
    for g, w in zip(got, want):
        assert g[:2] == b"\xff\xd8" and g[-2:] == b"\xff\xd9"
        assert g == w
    if name.startswith("search"):
        # one search a process, each loop ending on its own images alone
        assert [o["passes"] for o in out] == [[1], [4]]
