"""Scan stuffing on the card (csrc/scan_stuff.cu over csrc/stuff_core.cuh,
ops/scan_stuff.py).

On the CPU: the kernel's core built with g++ and run as the kernel runs
it (each image's tiles up to its scan's last, in both launches, the
placement steps in reverse order, each tile's threads in turn into a
staged tile with the CTA's sums and scan written out), byte for byte
against the JAX package's NumPy scan tail (`sjpeg_tpu.bitio`: the bytes,
the '1' padding, the 0xFF stuffing): random words, all-0xFF words, a last
byte that the padding turns into 0xFF, totals of 0, 1, 7, 8 and 32 n
bits, rows of different totals in one batch, overflowed rows (a total
past the row, and one past 2^31); the op's CPU route
(`native.words_to_scan`, the card tests' row oracle) against the same
reference on the same cases; the CPU path's JPEG bytes for the card
tests' images against the JAX package's.  On the card (`cuda`): the
kernel against `words_to_scan` on every row, and encode_batch /
encode_rgb bytes of methods 0, 4 and 7 against the CPU path's, with the
op's launches, an overflow's repack or re-encode included.

The `cuda` tests import no JAX, so they run where only the port is
installed:
    python -m pytest tests/test_torch_scan_stuff.py -m cuda -q
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from sjpeg_tpu_torch import constants as C
from sjpeg_tpu_torch import engine, native
from sjpeg_tpu_torch.ops import scan_stuff
from sjpeg_tpu_torch.params import EncoderParam
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
TILE_WORDS = 1024                    # stuff_core.cuh kStuffTileWords

_HOST_SHIM = """
#define __host__
#define __device__
#include <vector>
#include "stuff_core.cuh"
// scan_stuff.cu's two launches on the host: the tile counts over each
// image's tiles up to its scan's last, in order, then the placement steps
// in reverse order (no step reads what another step of its launch
// writes), each tile's threads in turn into the tile's stage, the CTA's
// sums and exclusive scan written out, then the stage stored in order.
extern "C" void stuff_rows(const uint32_t* words, const int32_t* totals,
                           int n_images, int64_t bucket, uint8_t* out,
                           int32_t* lengths) {
  using namespace sjpeg;
  const int64_t tiles_max = (bucket + kStuffTileWords - 1) / kStuffTileWords;
  std::vector<int32_t> counts(n_images * tiles_max, -1000000);
  uint32_t w[kStuffWordsPerThread];
  for (int64_t img = 0; img < n_images; ++img) {
    const ScanRow r = scan_row(totals[img], bucket);
    for (int64_t t = 0; t < scan_tiles(r); ++t) {
      int ff = 0;
      for (int lane = 0; lane < kStuffThreads; ++lane)
        ff += load_thread_words(words + img * bucket, t, lane, r, w);
      counts[img * tiles_max + t] = ff;
    }
  }
  for (int64_t img = n_images - 1; img >= 0; --img) {
    const ScanRow r = scan_row(totals[img], bucket);
    const int64_t n_t = scan_tiles(r);
    if (n_t == 0) lengths[img] = 0;
    for (int64_t t = n_t - 1; t >= 0; --t) {
      int64_t base = 0;
      for (int64_t j = 0; j < t; ++j) base += counts[img * tiles_max + j];
      std::vector<uint8_t> stage(2 * kStuffTileBytes, 0x5A);
      int excl = 0;
      for (int lane = 0; lane < kStuffThreads; ++lane) {
        const int ff = load_thread_words(words + img * bucket, t, lane, r, w);
        emit_thread_words(w, t, lane, r, stage.data()
                          + 4 * kStuffWordsPerThread * lane + excl);
        excl += ff;
      }
      const int n_out = tile_bytes(t, r) + excl;
      uint8_t* dst = out + img * 8 * bucket + t * kStuffTileBytes + base;
      for (int i = 0; i < n_out; ++i) dst[i] = stage[i];
      if (t == n_t - 1) lengths[img] = (int32_t)(r.n_bytes + base + excl);
    }
  }
}
extern "C" int ff_count(uint32_t w) { return sjpeg::count_ff(w); }
"""


@pytest.fixture(scope="module")
def stuff_core(tmp_path_factory):
    """csrc/stuff_core.cuh built by the host C++ compiler."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("stuff")
    (d / "stuff.cpp").write_text(_HOST_SHIM)
    lib = d / "libstuff.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    f"-I{REPO / 'sjpeg_tpu_torch' / 'csrc'}", "-o", str(lib),
                    str(d / "stuff.cpp")], check=True)
    so = ctypes.CDLL(str(lib))
    so.stuff_rows.argtypes = [ctypes.c_void_p] * 2 + [
        ctypes.c_int, ctypes.c_int64] + [ctypes.c_void_p] * 2
    so.stuff_rows.restype = None
    so.ff_count.argtypes = [ctypes.c_uint32]
    so.ff_count.restype = ctypes.c_int
    return so


def run_core(so, words, totals):
    """The g++ build's ([B, 8 * bucket] uint8 rows, unwritten bytes 0xA5;
    [B] lengths)."""
    w = np.ascontiguousarray(words, np.uint32)
    t = np.ascontiguousarray(totals, np.int32)
    b, bucket = w.shape
    out = np.full((b, 8 * bucket), 0xA5, np.uint8)
    lengths = np.full(b, -1, np.int32)
    so.stuff_rows(w.ctypes.data, t.ctypes.data, b, bucket, out.ctypes.data,
                  lengths.ctypes.data)
    return out, lengths


def oracle(words, totals) -> list:
    """native.words_to_scan a row, at the row's clamped bits."""
    bucket = words.shape[1]
    return [native.words_to_scan(words[i],
                                 scan_stuff.scan_bits(int(t), bucket))
            for i, t in enumerate(totals)]


def reference(words, totals) -> list:
    """The JAX package's NumPy scan tail a row, at the row's clamped bits:
    its bytes, the last byte's '1' padding, then its 0xFF stuffing."""
    from sjpeg_tpu import bitio as jbitio
    out = []
    for i, t in enumerate(totals):
        bits = scan_stuff.scan_bits(int(t), words.shape[1])
        raw = np.array(jbitio.pack_bits_to_bytes(
            np.ascontiguousarray(words[i, :(bits + 31) // 32]), bits))
        if bits % 8:
            raw[-1] |= (1 << (-bits % 8)) - 1
        out.append(jbitio.stuff_bytes(raw))
    return out


def _stream(rng, totals, bucket: int, fill=None) -> np.ndarray:
    """[B, bucket] uint32 streams as stream_concat leaves them: random (or
    `fill`) bits up to each total, zero past it; a total past the row (an
    overflow) fills the row."""
    w = (rng.randint(0, 1 << 32, (len(totals), bucket), dtype=np.uint64)
         if fill is None else np.full((len(totals), bucket), fill, np.uint64))
    bits = np.arange(bucket, dtype=np.int64)[None] * 32
    used = np.array([scan_stuff.scan_bits(t, bucket) for t in totals],
                    np.int64)[:, None]
    keep = np.clip(used - bits, 0, 32)
    mask = np.where(keep > 0, ((1 << keep) - 1) << (32 - keep), 0)
    return (w & mask.astype(np.uint64)).astype(np.uint32)


def _case(name: str):
    """(words [B, bucket] uint32, totals [B] int32)."""
    rng = np.random.RandomState(sum(map(ord, name)))
    if name == "random":
        bucket = 3 * TILE_WORDS + 17
        totals = rng.randint(0, 32 * bucket, 6)
        return _stream(rng, totals, bucket), totals
    if name == "all_ff":
        bucket = 2 * TILE_WORDS + 5
        totals = [32 * bucket, 32 * bucket - 3, 8 * 4096 + 1, 9, 0]
        return _stream(rng, totals, bucket, 0xFFFFFFFF), totals
    if name == "pad_makes_ff":     # a last byte of '1's up to the padding
        bucket = 64
        totals = [8 * 5 + 3, 8 * 4 + 1, 8 * 4 + 7, 8 * 255 + 4]
        w = _stream(rng, totals, bucket)
        for i, t in enumerate(totals):
            k, j = divmod(t // 8, 4)
            w[i, k] |= np.uint32(0xFF << (24 - 8 * j))
        return w & _stream(rng, totals, bucket, 0xFFFFFFFF), totals
    if name == "small_totals":
        bucket = TILE_WORDS
        totals = [0, 1, 7, 8, 32, 64, 32 * TILE_WORDS, 32 * 100 + 31]
        return _stream(rng, totals, bucket, 0xFFFFFFFF), totals
    if name == "tile_edges":          # scans ending on and around tile ends
        bucket = 4 * TILE_WORDS
        tile = 32 * TILE_WORDS
        totals = [tile, tile - 1, tile + 1, 2 * tile, 3 * tile + 8, 0, 1]
        w = _stream(rng, totals, bucket)
        w[:, ::3] |= np.uint32(0xFF00FF00)       # many 0xFF bytes
        return w & _stream(rng, totals, bucket, 0xFFFFFFFF), totals
    if name == "overflow":           # past the row, and past 2^31 bits
        bucket = TILE_WORDS + 300
        totals = [32 * bucket + 5, 1000, -5, 32 * bucket]
        return _stream(rng, totals, bucket), totals
    if name == "wide_row":         # a worst-case row, little of it used
        bucket = 300 * TILE_WORDS
        totals = [8 * 9000 + 3, 0, 32 * 5 * TILE_WORDS]
        return _stream(rng, totals, bucket), totals
    raise KeyError(name)


CASES = ["random", "all_ff", "pad_makes_ff", "small_totals", "tile_edges",
         "overflow", "wide_row"]


@pytest.mark.parametrize("name", CASES)
def test_stuff_core_host_build_matches_words_to_scan(stuff_core, name):
    """The g++ build of stuff_core.cuh, run tile by tile as scan_stuff.cu
    runs it, == the JAX package's scan tail on every row, and writes
    nothing past a row's length."""
    words, totals = _case(name)
    out, lengths = run_core(stuff_core, words, totals)
    for i, want in enumerate(reference(words, totals)):
        assert lengths[i] == len(want), (name, i)
        assert out[i, :lengths[i]].tobytes() == want, (name, i)
        assert (out[i, lengths[i]:] == 0xA5).all(), (name, i)


@pytest.mark.parametrize("name", CASES)
def test_scan_stuff_cpu_route_matches_words_to_scan(name):
    """The op on CPU tensors (`scan_stuff_plain`, native.words_to_scan a
    row: the card tests' oracle) == the JAX package's scan tail, with as
    many columns as the longest scan."""
    words, totals = _case(name)
    scan, lengths = scan_stuff.scan_stuff(
        torch.from_numpy(words.view(np.int32)),
        torch.tensor(totals, dtype=torch.int32))
    want = reference(words, totals)
    assert oracle(words, totals) == want
    assert scan.dtype == torch.uint8 and lengths.dtype == torch.int32
    assert scan.shape == (len(want), max(map(len, want)))
    for i, row in enumerate(want):
        assert lengths[i] == len(row)
        assert scan[i, :len(row)].numpy().tobytes() == row


def test_cases_cover_the_edges():
    """The cases hold what they are named for: a padded last byte that is
    0xFF, each listed small total, tiles ending on a scan's last byte, an
    overflowed and a wrapped total, and 0xFF-heavy rows."""
    words, totals = _case("pad_makes_ff")
    for i, row in enumerate(reference(words, totals)):
        assert row[-2:] == b"\xff\x00", i
    _, totals = _case("small_totals")
    assert {0, 1, 7, 8, 32, 64, 32 * TILE_WORDS} <= set(totals)
    _, totals = _case("tile_edges")
    assert 32 * TILE_WORDS in totals
    words, totals = _case("overflow")
    assert totals[0] > 32 * words.shape[1] and totals[2] < 0
    words, totals = _case("all_ff")
    assert reference(words, totals)[0] == b"\xff\x00" * (4 * words.shape[1])


def test_ff_count_word(stuff_core):
    """count_ff counts the 0xFF bytes of a word, every byte value in every
    position, and 0xFF next to every value."""
    rng = np.random.RandomState(3)
    for v in range(256):
        for pos in range(4):
            base = rng.randint(0, 1 << 32, dtype=np.uint64)
            w = int(base) & ~(0xFF << (8 * pos)) | (v << (8 * pos))
            want = sum(((w >> (8 * j)) & 0xFF) == 0xFF for j in range(4))
            assert stuff_core.ff_count(w) == want, hex(w)


def test_scan_stuff_checks_its_inputs():
    """On a device other than the CPU the op checks types and shapes
    before it launches."""
    m = torch.device("meta")
    w = torch.empty((2, 64), dtype=torch.int32, device=m)
    t = torch.empty(2, dtype=torch.int32, device=m)
    for bad in ((w.to(torch.int64), t), (w, t.to(torch.int64)),
                (w, t[:1]), (w[:, :0], t), (w.reshape(-1), t),
                (w.t(), torch.empty(64, dtype=torch.int32, device=m))):
        with pytest.raises(ValueError, match="scan_stuff takes"):
            scan_stuff.scan_stuff(*bad)


def test_assemble_jpeg_joins_headers_and_scan():
    """The tail's JPEG is the headers, the scan (any bytes-like object)
    and EOI, and the method-0 loop's shared headers are the same bytes."""
    from sjpeg_tpu_torch import headers, pipeline
    from sjpeg_tpu_torch.huffman import k3_default_tables
    param = EncoderParam(quality=70, yuv_mode=C.YUV_420)
    layout = pipeline.component_layout(C.YUV_420, 40, 24)
    qms, tables = engine._quant_matrices(param), k3_default_tables()
    scan = np.frombuffer(b"\x12\xff\x00\x34", np.uint8)
    head = bytes(engine._jpeg_headers(layout, param, qms, tables))
    got = engine._assemble_jpeg(layout, param, qms, tables, scan)
    assert got == head + scan.tobytes() + headers.EOI
    assert head.startswith(headers.APP0_JFIF)
    assert head[-14:-12] == b"\xff\xda"           # SOS, three components


# ---- on the card -----------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES + ["photo_row"])
def test_scan_stuff_matches_words_to_scan_on_gpu(name):
    """The kernel == words_to_scan on every row; its rows hold 8 * bucket
    bytes; one launch a call."""
    _need_cuda()
    if name == "photo_row":          # a 12-MP photo's worst-case row
        rng = np.random.RandomState(7)
        bucket = 285_768 * 64
        words, totals = _stream(rng, [8 * 2_700_000 + 5], bucket), [
            8 * 2_700_000 + 5]
    else:
        words, totals = _case(name)
    dev = torch.device("cuda")
    launches = scan_stuff.scan_stuff.launches
    scan, lengths = scan_stuff.scan_stuff(
        torch.from_numpy(words.view(np.int32)).to(dev),
        torch.tensor(totals, dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    assert scan.shape == (len(totals), 8 * words.shape[1])
    assert scan_stuff.scan_stuff.launches == launches + 1
    lengths = lengths.cpu().numpy()
    for i, want in enumerate(oracle(words, totals)):
        assert lengths[i] == len(want), (name, i)
        assert scan[i, :len(want)].cpu().numpy().tobytes() == want, (name, i)


def _photo(h: int, w: int, seed: int) -> np.ndarray:
    yy, xx = np.mgrid[0:h, 0:w]
    noise = np.random.RandomState(seed).randint(-12, 13, (h, w, 3))
    return np.clip(noise + np.stack([xx * 255 // w, yy * 255 // h,
                                     (xx + yy) % 256], -1), 0,
                   255).astype(np.uint8)


def _encode_case(method: int, cls=EncoderParam):
    """The card tests' images and settings: three 72 x 64 photos at q70
    4:2:0; a noise image at q95 4:4:4 that overflows a bucket of 4,096
    words (a budget of 0) beside a flat one that fits.  `cls` builds the
    params (the port's or the JAX package's EncoderParam)."""
    def param(**kw):
        return cls(huffman_compress=method > 0,
                   adaptive_quantization=method > 0,
                   use_trellis=method == 7, **kw)
    rgb = np.stack([_photo(72, 64, s) for s in range(3)])
    noise = np.random.RandomState(1).randint(0, 256, (2, 256, 256, 3),
                                             dtype=np.uint8)
    noise[1] = 128                                  # fits its bucket
    return (rgb, param(quality=70, yuv_mode=C.YUV_420), noise,
            param(quality=95, yuv_mode=C.YUV_444))


@pytest.mark.parametrize("method", [0, 4, 7])
def test_encode_case_cpu_bytes_match_jax_package(method):
    """The CPU path's bytes, which the card tests hold the card's to, ==
    the JAX package's for the same images and settings, the overflowing
    batch included."""
    from sjpeg_tpu import engine as jengine
    from sjpeg_tpu.params import EncoderParam as JaxParam
    rgb, param, noise, loud = _encode_case(method)
    _, jparam, _, jloud = _encode_case(method, JaxParam)
    assert param.method == method
    assert (engine.encode_batch(rgb, param, device="cpu")
            == jengine.encode_batch(rgb, jparam))
    assert (engine.encode_batch(noise, loud, bits_per_pixel_budget=0.0,
                                device="cpu")
            == jengine.encode_batch(noise, jloud, bits_per_pixel_budget=0.0))


@pytest.mark.cuda
@pytest.mark.parametrize("method", [0, 4, 7])
def test_encode_bytes_on_gpu_match_cpu(method):
    """encode_batch and encode_rgb on the card == the CPU path's bytes,
    with one scan_stuff launch a batch and an image; a bucket overflow (a
    noise image at q95 past 4,096 words) is packed again (methods 4 and
    7) or encoded again (method 0) and stuffed on the card, one launch
    more, with the same bytes."""
    _need_cuda()
    rgb, param, noise, loud = _encode_case(method)
    assert param.method == method
    op = scan_stuff.scan_stuff
    want = engine.encode_batch(rgb, param, device="cpu")
    want_each = [engine.encode_rgb(img, param, device="cpu") for img in rgb]
    op.launches = 0
    assert engine.encode_batch(rgb, param) == want
    assert op.launches == 1
    for img, one in zip(rgb, want_each):
        op.launches = 0
        assert engine.encode_rgb(img, param) == one
        assert op.launches == 1
    want = engine.encode_batch(noise, loud, bits_per_pixel_budget=0.0,
                               device="cpu")
    op.launches = 0
    assert engine.encode_batch(noise, loud, bits_per_pixel_budget=0.0) == want
    assert op.launches == 2
