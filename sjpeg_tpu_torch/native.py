"""ctypes bindings for the port's native host helpers.

Name for name the JAX package's `native` module, over the port's own copy
of its C++ (`csrc/native_host.cc`), built with g++ at first use into
`_build/` (`kernels.host_library`); nothing builds at import.  The
helpers run on the host after the card: the padding and 0xFF stuffing
of the scans of CPU runs and of a bucket overflow's repack
(`words_to_scan`, from `ops/scan_stuff.scan_stuff_plain`), the
Huffman merge of the host table builds (`huffman_codesizes`, from
`huffman.build_optimal_table`) and the search's node fit
(`analyse_histo_nodes`, from `adaptive.analyse_histo_nodes`).

Unlike the JAX package's module there is no silent fallback: a failed
build raises with g++'s output.  The NumPy versions
(`bitio.words_to_scan` / `stuff_bytes`, `huffman.merge_codesizes`,
`adaptive.analyse_histo` per pair) are their parity twins, run only when
asked for by name.
"""

import ctypes
import os

import numpy as np

from . import constants as C
from . import kernels

_P = ctypes.c_void_p
_SIGNATURES = {
    "sjpeg_stuff_bytes": (ctypes.c_size_t, [_P, ctypes.c_size_t, _P]),
    "sjpeg_words_to_scan": (ctypes.c_size_t, [_P, ctypes.c_size_t, _P]),
    "sjpeg_merge_streams": (ctypes.c_uint64, [_P, ctypes.c_size_t, _P,
                                              ctypes.c_size_t, _P]),
    "sjpeg_huffman_codesizes": (None, [_P, ctypes.c_int, _P]),
    "sjpeg_analyse_histo_nodes": (None, [_P, ctypes.c_int, _P, ctypes.c_int,
                                         _P, ctypes.c_int, _P, _P,
                                         ctypes.c_int]),
}
_LIB = None


def _load():
    """The loaded library, built first if missing (raises on failure)."""
    global _LIB
    if _LIB is None:
        with kernels._lock:
            if _LIB is None:
                lib = ctypes.CDLL(str(kernels.host_library()))
                for name, (restype, argtypes) in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.restype, fn.argtypes = restype, argtypes
                _LIB = lib
    return _LIB


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_P)


def available() -> bool:
    """True once the library loads; building it may raise instead."""
    return _load() is not None


def build_native() -> bool:
    """Build the library if missing and load it; returns True or raises
    with g++'s output."""
    return available()


def huffman_codesizes(freq: np.ndarray, size: int) -> np.ndarray:
    """Huffman-merge code lengths of `freq[:size]` (the merge loop of
    huffman.build_optimal_table, with its fake symbol at index `size`) ->
    int32[size + 1]."""
    f = np.asarray(freq[:size])
    if not 0 < size <= 256 or f.shape != (size,):
        raise ValueError(f"huffman_codesizes: {f.shape} frequencies for "
                         f"size {size}")
    if f.size and (f.min() < 0 or f.max() >= 1 << 46):
        raise ValueError("huffman_codesizes: frequencies outside "
                         "[0, 2^46)")
    f = np.ascontiguousarray(f, dtype=np.uint64)
    out = np.zeros(size + 1, dtype=np.int32)
    _load().sjpeg_huffman_codesizes(_ptr(f), size, _ptr(out))
    return out


def analyse_histo_nodes(histos: np.ndarray, quants: np.ndarray,
                        min_quant: np.ndarray, qdelta_max: int,
                        weight: np.ndarray, n_threads: int = 0) -> np.ndarray:
    """[B, 64, 128] histograms x [K, 64] uint8 candidate matrices (already
    clamped to min_quant) -> [B, K, 64] uint8 tuned matrices, bit-identical
    to adaptive.analyse_histo per pair; threaded over the images
    (n_threads <= 0: up to 8, the host's cores)."""
    h = np.ascontiguousarray(histos, dtype=np.int64)
    q = np.ascontiguousarray(quants, dtype=np.uint8)
    mq = np.ascontiguousarray(min_quant, dtype=np.uint8)
    w = np.ascontiguousarray(weight, dtype=np.float64)
    if (h.ndim != 3 or h.shape[1:] != (64, C.MAX_HISTO_DCT_COEFF)
            or q.ndim != 2 or q.shape[1] != 64 or mq.shape != (64,)
            or w.shape != (C.QSIZE,)
            or not 0 <= qdelta_max - C.QDELTA_MIN < C.QSIZE):
        raise ValueError("analyse_histo_nodes: histos [B, 64, 128], quants "
                         "[K, 64], min_quant [64], weight [25] and a delta "
                         f"range inside QSIZE; got {h.shape}, {q.shape}, "
                         f"{mq.shape}, {w.shape}, qdelta_max={qdelta_max}")
    B, K = h.shape[0], q.shape[0]
    out = np.empty((B, K, 64), dtype=np.uint8)
    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 1, 8)
    _load().sjpeg_analyse_histo_nodes(_ptr(h), B, _ptr(q), K, _ptr(mq),
                                      int(qdelta_max), _ptr(w), _ptr(out),
                                      int(n_threads))
    return out


def stuff_bytes(raw: np.ndarray) -> bytes:
    """Insert a 0x00 after every 0xFF byte of `raw` (uint8)."""
    raw = np.ascontiguousarray(raw, dtype=np.uint8).reshape(-1)
    out = np.empty(raw.size * 2, dtype=np.uint8)
    n = _load().sjpeg_stuff_bytes(_ptr(raw), raw.size, _ptr(out))
    return out[:n].tobytes()


def words_to_scan(words: np.ndarray, total_bits: int) -> bytes:
    """MSB-first uint32 words (bit 31 of word 0 first) -> the stuffed,
    '1'-padded scan segment of their first `total_bits` bits."""
    w = np.ascontiguousarray(words, dtype=np.uint32).reshape(-1)
    if not 0 <= total_bits <= 32 * w.size:
        raise ValueError(f"words_to_scan: {total_bits} bits from "
                         f"{w.size} words")
    out = np.empty((total_bits // 8 + 2) * 2, dtype=np.uint8)
    n = _load().sjpeg_words_to_scan(_ptr(w), total_bits, _ptr(out))
    return out[:n].tobytes()


def merge_streams(words: np.ndarray, bit_lens: np.ndarray):
    """Merge [S, W] MSB-first word streams of bit_lens[s] bits each ->
    (merged uint32 words, total bits)."""
    src = np.ascontiguousarray(words, dtype=np.uint32)
    lens = np.ascontiguousarray(bit_lens, dtype=np.int32).reshape(-1)
    if (src.ndim != 2 or lens.size != src.shape[0]
            or (lens.size and (lens.min() < 0
                               or lens.max() > 32 * src.shape[1]))):
        raise ValueError(f"merge_streams: {lens.size} lengths for streams "
                         f"{src.shape}")
    total = int(lens.astype(np.int64).sum())
    out = np.zeros(total // 32 + 2, dtype=np.uint32)
    _load().sjpeg_merge_streams(_ptr(src), src.shape[1], _ptr(lens),
                                src.shape[0], _ptr(out))
    return out, total
