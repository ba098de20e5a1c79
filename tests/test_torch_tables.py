"""The table kernel's row algorithm (csrc/table_core.cuh, table_row)
built with g++ over a host policy that loops over the 32 lanes of a warp,
held bit for bit against the plain PyTorch table build,
ops/huffman_device.optimal_code_luts_plain (itself held against the JAX
package in test_torch_huffman.py).  The CUDA launch itself is tested in
test_torch_cuda.py."""

import ctypes
import functools
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import adversarial_freq_rows
from sjpeg_tpu_torch.ops import huffman_device as hd
from sjpeg_tpu_torch.ops import merge_codesizes as mc
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]

_HOST_SHIM = """
#define __host__
#define __device__
#include <algorithm>
#include "table_core.cuh"
namespace {
// table_core.cuh's Warp policy: 32 lane states, each collective a loop.
struct HostWarp {
  sjpeg::TableLane s[32];
  template <class F> void each(F&& f) {
    for (int l = 0; l < 32; ++l) f(l, s[l]);
  }
  template <class F> uint32_t sum(F&& f) {
    uint32_t t = 0;
    for (int l = 0; l < 32; ++l) t += (uint32_t)f(l, s[l]);
    return t;
  }
  template <class F> auto min(F&& f) {
    auto m = f(0, s[0]);
    for (int l = 1; l < 32; ++l) m = std::min(m, f(l, s[l]));
    return m;
  }
  template <class F> uint32_t ballot(F&& f) {
    uint32_t b = 0;
    for (int l = 0; l < 32; ++l) b |= (f(l, s[l]) ? 1u : 0u) << l;
    return b;
  }
  template <class F> int32_t shfl(F&& f, int src) { return f(src, s[src]); }
  template <class F, class G> void scan(F&& f, G&& g) {
    int32_t v[32], acc = 0;
    for (int l = 0; l < 32; ++l) v[l] = acc += f(l, s[l]);
    for (int l = 0; l < 32; ++l) g(l, s[l], v[l]);
  }
  template <class F, class G> void match(F&& f, G&& g) {
    int32_t k[32];
    for (int l = 0; l < 32; ++l) k[l] = f(l, s[l]);
    for (int l = 0; l < 32; ++l) {
      int lower = 0, same = 0;
      for (int m = 0; m < 32; ++m) {
        same += k[m] == k[l];
        lower += m < l && k[m] == k[l];
      }
      g(l, s[l], lower, same);
    }
  }
  void add(int32_t* p, int32_t v) { *p += v; }
  void sync() {}
};
}  // namespace
// Every row of [rows, width] frequencies, as the kernel runs one.
extern "C" void table_rows(const int32_t* freq, int rows, int width,
                           int size, int lut_size, int32_t* lut,
                           int32_t* bits, int32_t* nb, int32_t* syms) {
  for (int r = 0; r < rows; ++r) {
    sjpeg::TableShared sh;
    const sjpeg::TableRow row{freq + (int64_t)r * width,
                              lut + (int64_t)r * lut_size, bits + 16 * r,
                              nb + r, syms + (int64_t)r * size, size,
                              lut_size};
    HostWarp w;
    sjpeg::table_row(w, sh, row);
  }
}
"""


@pytest.fixture(scope="module")
def table_core(tmp_path_factory):
    """csrc/table_core.cuh built by the host C++ compiler."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("tables")
    (d / "tables.cpp").write_text(_HOST_SHIM)
    lib = d / "libtables.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    f"-I{REPO / 'sjpeg_tpu_torch' / 'csrc'}", "-o", str(lib),
                    str(d / "tables.cpp")], check=True)
    so = ctypes.CDLL(str(lib))
    so.table_rows.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 4
                              + [ctypes.c_void_p] * 4)
    so.table_rows.restype = None
    return so


# chip_smoke's adversarial frequency rows: the edge rows (ties, the
# rebalance, the clamp, one symbol, empty, wrapping sums where the fake
# symbol lands before symbol 0) and 15 skewed rows, or 40 further skewed
# rows.
_ROWS = {"edges": slice(0, 40), "skewed": slice(40, 80)}


@functools.lru_cache(maxsize=None)
def _case(size: int):
    """The 80 frequency rows in size + 1 columns, and the plain build's
    outputs, which no wider padding changes.  One build for both row sets:
    its cost is the count of its small torch operations, not its rows."""
    freq = adversarial_freq_rows(size, size + 1, 44)[:80]
    lut_size = size if size > 16 else 16
    want = hd.optimal_code_luts_plain(torch.from_numpy(freq), size, lut_size,
                                      with_syms=True)
    return freq, lut_size, [w.numpy() for w in want]


def test_optimal_tables_rejects_tensors_off_cuda():
    """The kernel's wrapper launches or raises: CPU tensors go to the plain
    version in huffman_device, never to merge_codesizes.optimal_tables."""
    freq = torch.from_numpy(adversarial_freq_rows(12, 16, 3))
    with pytest.raises(ValueError):
        mc.optimal_tables([(freq, 12, 16)])
    launches = mc.optimal_tables.launches
    got = hd.optimal_code_luts(freq, 12, with_syms=True)
    want = hd.optimal_code_luts_plain(freq, 12, with_syms=True)
    assert mc.optimal_tables.launches == launches
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("rows", ["edges", "skewed"])
@pytest.mark.parametrize("size,width", [(12, 16), (256, 320), (256, 257)])
def test_table_core_host_build_matches_plain(table_core, size, width, rows):
    """table_row (merge, clamp, rebalance, ranks, canonical codes, DHT
    order) == optimal_code_luts_plain on every row: LUTs, code-length
    counts, symbol counts and symbol order."""
    freq, lut_size, want = _case(size)
    freq, want = freq[_ROWS[rows]], [w[_ROWS[rows]] for w in want]
    g = freq.shape[0]
    freq = np.ascontiguousarray(np.pad(freq, ((0, 0),
                                              (0, width - freq.shape[1]))))
    got = [np.zeros((g, lut_size), np.int32), np.zeros((g, 16), np.int32),
           np.zeros(g, np.int32), np.zeros((g, size), np.int32)]
    table_core.table_rows(freq.ctypes.data, g, width, size, lut_size,
                          *(a.ctypes.data for a in got))
    for gt, w in zip(got, want):
        np.testing.assert_array_equal(gt, w)
    if rows == "edges":     # the rebalance was reached
        assert (want[1][:, 15] > 0).any() == (size > 16)
