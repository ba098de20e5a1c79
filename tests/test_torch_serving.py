"""The port's custom search hooks and serving wrappers: a stateful
SearchHook subclass through encode_batch and encode_batch_yuv (each image
runs the single-image search with the same hook object) and encode_many on
mixed shapes, byte for byte against the JAX package on device="cpu";
encode_pipelined against encode_batch per batch, in order; and the module
lock of kernels.py that makes the first build safe from several threads.
The card's streams are tested in test_torch_cuda.py."""

import os
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from sjpeg_tpu import engine as jengine
from sjpeg_tpu.params import EncoderParam as JaxParam
from sjpeg_tpu.params import SearchHook as JHook

from sjpeg_tpu_torch import constants as C
from sjpeg_tpu_torch import engine, kernels
from sjpeg_tpu_torch.params import EncoderParam, SearchHook


def _rgb(b: int, h: int, w: int, seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    grad = np.stack([xx * 255 // w, yy * 255 // h, (xx + yy) * 4 % 256], -1)
    return np.clip(grad + rng.randint(-40, 40, (b, h, w, 3)), 0,
                   255).astype(np.uint8)


def _race(fn) -> None:
    """Run fn in more threads than the machine has cores, released
    together by a barrier, with a short interpreter switch interval."""
    n = (os.cpu_count() or 8) + 1
    start = threading.Barrier(n)

    def run(i):
        start.wait()
        fn(i)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)


def _stateful(base):
    """A bisection hook whose starting quality falls with every image it
    is set up for, and which logs every result: state that runs across a
    batch.  One class per package, the same logic."""

    class Stateful(base):
        def __init__(self):
            self.images = 0
            self.results = []

        def setup(self, param, initial_q):
            ok = super().setup(param, initial_q)
            self.images += 1
            self.q = max(self.qmin, min(self.qmax,
                                        initial_q - 12.0 * self.images))
            return ok

        def update(self, result):
            self.results.append(result)
            return super().update(result)

    return Stateful()


@pytest.mark.parametrize("entry", ["rgb_size_m3", "yuv420_psnr_m0"])
def test_custom_hook_matches_jax(entry):
    """A stateful hook through encode_batch / encode_batch_yuv: the same
    bytes, the same results seen by the hook, the same final state.
    Methods 3 and 0 keep the JAX side's compiles few; the optimal-table
    passes of the search are held in test_torch_single.py."""
    kw = dict(yuv_mode=C.YUV_420, quality=80, passes=5)
    if entry == "yuv420_psnr_m0":
        kw.update(huffman_compress=False, adaptive_quantization=False,
                  target_mode=2, target_value=32.0)
    else:
        kw.update(huffman_compress=False, target_mode=1, target_value=800.0)
    jhook, thook = _stateful(JHook), _stateful(SearchHook)
    jp = JaxParam(search_hook=jhook, **kw)
    tp = EncoderParam(search_hook=thook, **kw)
    imgs = _rgb(2, 24, 40, 81)
    if entry.startswith("yuv"):
        planes = (imgs[..., 0], imgs[:, ::2, ::2, 1], imgs[:, ::2, ::2, 2])
        planes = tuple(np.ascontiguousarray(p) for p in planes)
        got = engine.encode_batch_yuv(*planes, True, tp, device="cpu")
        want = jengine.encode_batch_yuv(*planes, True, jp)
    else:
        got = engine.encode_batch(imgs, tp, device="cpu")
        want = jengine.encode_batch(imgs, jp)
    assert got == want
    assert thook.images == jhook.images == 2
    assert thook.results == jhook.results
    assert (thook.q, thook.value) == (jhook.q, jhook.value)


def test_encode_many_matches_jax():
    """Mixed shapes, interleaved: grouped by shape, results in input
    order, each equal to JAX's encode_many and to encode_rgb alone."""
    a, b = _rgb(2, 24, 40, 82), _rgb(1, 17, 33, 83)
    images = [a[0], b[0], a[1]]
    kw = dict(yuv_mode=C.YUV_420, quality=70, huffman_compress=False,
              adaptive_quantization=False)
    got = engine.encode_many(images, EncoderParam(**kw), device="cpu")
    assert got == jengine.encode_many(images, JaxParam(**kw))
    assert got == [engine.encode_rgb(im, EncoderParam(**kw), device="cpu")
                   for im in images]


def test_encode_pipelined_matches_encode_batch():
    """Five batches through depth 2: each yield equals encode_batch on
    that batch, in order."""
    batches = [_rgb(2, 24, 40, 90 + i) for i in range(5)]
    param = EncoderParam(yuv_mode=C.YUV_420, huffman_compress=False)
    got = list(engine.encode_pipelined(iter(batches), param, depth=2,
                                       device="cpu"))
    assert got == [engine.encode_batch(b, param, device="cpu")
                   for b in batches]


def test_kernel_function_loads_once_under_threads(monkeypatch):
    """Threads asking for one kernel at once build and load it once, and
    all get the same function."""
    builds, loads = [], []

    def fake_build_all():
        builds.append(threading.get_ident())
        threading.Event().wait(0.05)        # let the others arrive
        return {}

    class FakeLib:
        def __init__(self, path):
            loads.append(path)
            self.sjpeg_x = type("Fn", (), {})()

    monkeypatch.setattr(kernels, "_functions", {})
    monkeypatch.setattr(kernels, "build_all", fake_build_all)
    monkeypatch.setattr(kernels, "library_path",
                        lambda name: Path(f"lib{name}.so"))
    monkeypatch.setattr(kernels.ctypes, "CDLL", FakeLib)
    got = {}

    def ask(i):
        got[i] = kernels.function("x", "sjpeg_x", [])

    _race(ask)
    assert len(builds) == 1 and len(loads) == 1
    assert len(got) > 8 and all(fn is got[0] for fn in got.values())


def test_build_all_under_threads(monkeypatch, tmp_path):
    """Concurrent build_all calls with a stand-in compiler: every library
    is compiled once, lands under its final name, and no temporary file
    is left."""
    log = tmp_path / "log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    f'echo "$2" >> {log}\necho built > "$2"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(kernels, "nvcc_path", lambda: str(nvcc))
    _race(lambda i: kernels.build_all())
    names = kernels.kernel_names()
    assert len(log.read_text().splitlines()) == len(names)
    assert all(kernels.library_path(n).exists() for n in names)
    assert not list(Path(kernels.BUILD_DIR).glob("*.tmp"))
