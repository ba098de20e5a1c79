"""The port's native host helpers (sjpeg_tpu_torch.native over
csrc/native_host.cc, built with g++ into sjpeg_tpu_torch/_build/) against
the JAX package's NumPy host code and the port's own twins, bit for bit:
the scan tail (words_to_scan: '1' padding and 0xFF stuffing, also
through the scan_stuff op's CPU route) and stuff_bytes against
sjpeg_tpu.bitio on streams with runs of 0xFF, every
bit length mod 8, one word and none; merge_streams against
sjpeg_tpu.native's NumPy merge; huffman_codesizes against the port's
Python merge on random and adversarial rows; the node fit with 1 and 4
threads against sjpeg_tpu.adaptive.analyse_histo per (image, node) pair,
and the port's adaptive.analyse_histo_nodes, which runs it.  Then where
the library lies, and that a broken compiler raises instead of falling
back."""

import numpy as np
import pytest
import torch

from sjpeg_tpu import adaptive as jadaptive
from sjpeg_tpu import bitio as jbitio
from sjpeg_tpu import native as jnative
from sjpeg_tpu.params import quant_matrices_for_quality

from sjpeg_tpu_torch import adaptive, bitio, huffman, kernels, native
from sjpeg_tpu_torch import constants as C
from sjpeg_tpu_torch.ops import scan_stuff

from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)


def _streams():
    """(name, uint32 words, total bits) cases."""
    rng = np.random.RandomState(17)
    out = []
    for r in range(8):                      # every bit length mod 8
        n = 32 * 5 + 8 * r + (r % 3)
        out.append((f"mod8_{n % 8}", rng.randint(
            0, 1 << 32, (n + 31) // 32, dtype=np.uint64).astype(np.uint32),
            n))
    ff = rng.randint(0, 1 << 32, 40, dtype=np.uint64).astype(np.uint32)
    ff[3:9] = 0xFFFFFFFF                    # a run of 24 0xFF bytes
    ff[12] = 0xFF00FFFF
    ff[20] = 0x00FFFFFF
    ff[-1] = 0xFFFFFFFF                     # 0xFF in the padded last byte
    out += [("ff_runs", ff, 40 * 32 - 5), ("ff_exact", ff, 40 * 32),
            ("one_word", np.array([0xF0FFFF0F], np.uint32), 29),
            ("one_word_ff", np.array([0xFFFFFFFF], np.uint32), 32),
            ("empty", np.zeros(0, np.uint32), 0),
            ("no_bits", np.array([0xFFFFFFFF], np.uint32), 0)]
    return out


STREAMS = _streams()


def _jax_scan(words, total_bits):
    """The JAX package's NumPy scan tail: its bytes, the '1' padding of the
    last byte, then its 0xFF stuffing."""
    raw = np.array(jbitio.pack_bits_to_bytes(words, total_bits))
    pad = (-total_bits) % 8
    if pad and raw.size:
        raw[-1] |= (1 << pad) - 1
    return jbitio.stuff_bytes(raw)


@pytest.mark.parametrize("name,words,total", STREAMS,
                         ids=[c[0] for c in STREAMS])
def test_words_to_scan_and_stuffing_match_jax(name, words, total):
    want = _jax_scan(words, total)
    assert native.words_to_scan(words, total) == want
    assert bitio.words_to_scan(words, total) == want
    scan, lengths = scan_stuff.scan_stuff(          # the op's CPU route
        torch.from_numpy(words.astype(np.uint32).view(np.int32)[None]),
        torch.tensor([total], dtype=torch.int32))
    assert scan[0, :int(lengths[0])].numpy().tobytes() == want
    raw = words.astype(">u4").view(np.uint8)
    assert native.stuff_bytes(raw) == jbitio.stuff_bytes(raw)
    assert native.stuff_bytes(raw) == bitio.stuff_bytes(raw)


def test_words_to_scan_rejects_short_words():
    """More bits than the words hold would read past the buffer."""
    with pytest.raises(ValueError, match="words_to_scan"):
        native.words_to_scan(np.zeros(2, np.uint32), 65)


def test_merge_streams_matches_jax_numpy():
    rng = np.random.RandomState(5)
    lens = np.array([0, 1, 31, 32, 33, 200, 64, 7], np.int32)
    words = rng.randint(0, 1 << 32, (len(lens), 8),
                        dtype=np.uint64).astype(np.uint32)
    for s, n in enumerate(lens.tolist()):    # zero past each stream
        words[s, -(-n // 32):] = 0
        if n % 32:
            words[s, n // 32] &= np.uint32((0xFFFFFFFF << (32 - n % 32))
                                           & 0xFFFFFFFF)
    got, total = native.merge_streams(words, lens)
    assert total == int(lens.sum())
    np.testing.assert_array_equal(got, jnative._py_merge(words, lens))


def _freq_rows():
    rng = np.random.RandomState(9)
    fib = [1, 1]
    while len(fib) < 40:
        fib.append(fib[-1] + fib[-2])
    rows = {
        "random_ac": (rng.randint(0, 5000, 256), 256),
        "sparse_ac": (rng.randint(0, 50, 256) * (rng.rand(256) < 0.2), 256),
        "random_dc": (rng.randint(0, 900, 12), 12),
        "ties_ac": (np.full(256, 77), 256),
        "ties_dc": (np.full(12, 3), 12),
        "one_symbol": (np.eye(256, dtype=np.int64)[200] * 12345, 256),
        "one_symbol_dc": (np.eye(12, dtype=np.int64)[0], 12),
        "all_256": (np.arange(1, 257), 256),
        "deep_tree": (np.array(fib[:12]), 12),   # merges past 16 bits
        "deep_ac": (np.array(fib + [1] * 216), 256),
        "empty": (np.zeros(256, np.int64), 256),
    }
    return [(k, v[0].astype(np.int64), v[1]) for k, v in rows.items()]


FREQS = _freq_rows()


@pytest.mark.parametrize("name,freq,size", FREQS,
                         ids=[c[0] for c in FREQS])
def test_huffman_codesizes_match_python_merge(name, freq, size):
    got = native.huffman_codesizes(freq, size)
    assert got.dtype == np.int32 and got.shape == (size + 1,)
    np.testing.assert_array_equal(got, huffman._codesizes_python(freq, size))


def _fit_cases():
    """tests/test_adaptive_twins.py's cases: four histogram scales, sparse
    rows for the density filter, luma and chroma delta ranges."""
    rng = np.random.RandomState(7)
    cases = []
    for trial, hi in enumerate((1, 30, 4000, 10 ** 6)):
        histos = rng.randint(0, hi + 1, (5, 64, C.MAX_HISTO_DCT_COEFF))
        histos[trial % 5, trial % 64] = 0
        quants = np.stack([quant_matrices_for_quality(q)[trial % 2]
                           for q in np.linspace(3, 99, 17)]).astype(np.uint8)
        minq = np.full(64, int(rng.randint(1, 40)), np.uint8)
        cases.append((histos.astype(np.int64), np.maximum(quants, minq),
                      minq, 12 if trial % 2 == 0 else 1))
    return cases


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("case", range(4))
def test_node_fit_matches_jax_per_pair(case, threads, monkeypatch):
    """Every (image, node) pair == sjpeg_tpu.adaptive.analyse_histo (its
    NumPy fit, pinned so that the JAX side loads no library), and the
    port's adaptive.analyse_histo_nodes (duplicate nodes fitted once)
    returns the same."""
    monkeypatch.setenv("SJPEG_ADAPTIVE_IMPL", "numpy")
    histos, quants, minq, qd = _fit_cases()[case]
    got = native.analyse_histo_nodes(histos, quants, minq, qd,
                                     C.HISTO_WEIGHT, n_threads=threads)
    for i in range(histos.shape[0]):
        for k in range(quants.shape[0]):
            np.testing.assert_array_equal(
                got[i, k], jadaptive.analyse_histo(histos[i], quants[k],
                                                   minq, qd),
                err_msg=f"image {i}, node {k}")
    np.testing.assert_array_equal(
        got, adaptive.analyse_histo_nodes(histos, quants, minq, qd))
    np.testing.assert_array_equal(
        got, jadaptive.analyse_histo_nodes(histos, quants, minq, qd))


def test_library_is_built_into_the_port_build_dir():
    assert native.build_native() and native.available()
    path = kernels.host_library()
    assert path.parent == kernels.BUILD_DIR
    assert kernels.BUILD_DIR.parent.name == "sjpeg_tpu_torch"
    assert path.name.startswith("libsjpeg_host-") and path.exists()
    assert native._LIB._name == str(path)


def test_broken_compiler_raises(tmp_path, monkeypatch):
    """With no library built and a compiler that fails, the helpers raise
    with its output: nothing falls back to the NumPy twins."""
    gxx = tmp_path / "gxx"
    gxx.write_text("#!/bin/sh\necho broken compiler >&2\nexit 3\n")
    gxx.chmod(0o755)
    monkeypatch.setattr(kernels, "GXX", str(gxx))
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(RuntimeError, match="broken compiler"):
        scan_stuff.scan_stuff(torch.zeros((1, 1), dtype=torch.int32),
                              torch.tensor([8], dtype=torch.int32))
    with pytest.raises(RuntimeError, match="exited 3"):
        native.build_native()
    assert not (tmp_path / "_build").exists() or not any(
        p.suffix == ".so" for p in (tmp_path / "_build").iterdir())
