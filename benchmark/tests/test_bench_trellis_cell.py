"""The readers of the method-7 cell: `trellis_roofline` at one shape and on
a synthetic trace against hand counts, and `host.trellis_ms_per_mpx` on
synthetic spans; each gives nothing where its events are missing, as on a
program without the trellis span.

Run: python -m pytest benchmark/tests -q
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from benchmark import harness, jpeg_info, roofline, tracing  # noqa: E402
from benchmark.reference import encoder  # noqa: E402

BENCH = ROOT / "benchmark"
FAMILIES = harness.kernel_families(BENCH)
CELL = "sjpeg-m7-q75.photo12mp"


def reader(name):
    return harness.load_module(BENCH, "metrics", name)


def ev(name, ts, dur, cat="kernel"):
    return {"name": name, "cat": cat, "ph": "X", "ts": ts, "dur": dur}


# a slice [100, 200] µs: the trellis op's four kernels (the search
# straddles the end), a glue kernel, a copy, and a search outside it
EVENTS = [
    ev("trellis_work_kernel(int const*, int)", 110, 6),
    ev("trellis_scan_kernel(int*, int)", 117, 1),
    ev("trellis_scatter_kernel(int const*, int*)", 119, 2),
    ev("void sjpeg::trellis_search_kernel<int>(int const*)", 150, 60),
    ev("void at::native::vectorized_elementwise_kernel<4>(int)", 125, 10),
    ev("Memcpy DtoH (Device -> Pageable)", 180, 5, cat="gpu_memcpy"),
    ev("trellis_search_kernel(int const*)", 300, 40),
]
TRELLIS_US = 6 + 1 + 2 + 50


def view(jpegs=(), mpx=2.0, events=EVENTS):
    events = tracing.device_events(events, 100, 200)
    return harness.TraceView(
        events=events, lo=100.0, hi=200.0,
        busy_us=tracing.busy_us([(e["ts"], e["ts"] + e["dur"])
                                 for e in events], 100, 200),
        mpx=mpx, jpegs=list(jpegs), families=FAMILIES,
        power_limit_w=700.0)


def test_the_cell_reads_both_metrics():
    names = [m["name"] for m in harness.load_cell(CELL).per_layer]
    assert {"trellis_roofline", "host.trellis_ms_per_mpx"} <= set(names)
    assert {"trellis_work_kernel", "trellis_search_kernel"} <= set(
        FAMILIES["trellis"]["names"])


def test_trellis_roofline_at_one_shape():
    """One 4032 x 3024 photo at 4:2:0: 252 x 189 MCUs of six blocks."""
    blocks = 252 * 189 * 6
    assert blocks == 285_768
    nbytes = reader("trellis_roofline").work(blocks, 1)
    # 64 coefficients in and 64 levels out a block, 2 B each; the two
    # matrices and two rows of 256 code lengths once, 2 B each
    assert nbytes == 2 * 128 * 285_768 + 2 * (2 * 64 + 2 * 256)
    assert nbytes == 73_157_888
    least, bound = roofline.least_seconds(nbytes, 0)
    # 73.16 MB / 3.35 TB/s = 21.84 µs
    assert bound == "bytes"
    assert least == pytest.approx(21.838e-6, rel=1e-4)


def _jpeg(h, w):
    rng = np.random.default_rng(h * w)
    im = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    return encoder.encode_images(im[None], encoder.Settings(
        yuv_mode="420", use_trellis=True))[0].jpeg


def test_trellis_roofline_from_a_trace():
    """The four kernels ran 59 µs inside the slice over two JPEGs' work;
    the glue kernel and the search outside the slice do not count."""
    jpegs = [_jpeg(64, 96), _jpeg(48, 80)]
    blocks = sum(jpeg_info.parse(j).blocks for j in jpegs)
    assert blocks == (96 + 24 + 24) + (60 + 15 + 15)
    got = reader("trellis_roofline").read(view(jpegs))
    want = 2 * (128 * blocks + 2 * 640) / 3.35e12 / (TRELLIS_US * 1e-6)
    assert got["device_us"] == TRELLIS_US
    assert got["value"] == pytest.approx(100 * want)
    assert got["bound"] == "bytes" and got["power_limit_w"] == 700.0


def test_trellis_roofline_without_its_kernels():
    events = [e for e in EVENTS if "trellis" not in e["name"]
              or e["ts"] >= 200]
    jpegs = [_jpeg(64, 96)]
    assert reader("trellis_roofline").read(view(jpegs, events=events)) \
        is None
    assert reader("trellis_roofline").read(view(events=[])) is None


def span(name, ts, dur, tid=1):
    return {"name": "sjpeg." + name, "ts": ts, "dur": dur, "tid": tid}


# a request with its trellis stage, a fetch inside that stage (owned by
# the fetch), a tail, and a trellis stage that ends before the slice
SPANS = [
    span("request", 95, 100),           # [95, 195]
    span("trellis", 105, 40),           # [105, 145]
    span("fetch", 120, 5),              # [120, 125] inside the trellis
    span("tail", 150, 40),              # [150, 190]
    span("trellis", 40, 20),            # outside the slice
]
# busy in the slice: [110, 116] [117, 118] [119, 121] [125, 135]
# [150, 200]; the trellis owns [105, 120] and [125, 145]: 35 µs, of which
# idle [105, 110] [116, 117] [118, 119] [135, 145]: 17 µs


@pytest.fixture
def spans(monkeypatch):
    from sjpeg_tpu_torch.utils import profiling

    def use(rows):
        monkeypatch.setattr(profiling, "trace_spans", lambda: list(rows))
    return use


def test_host_trellis_counts_only_its_spans(spans):
    spans(SPANS)
    got = reader("host.trellis_ms_per_mpx").read(view(mpx=2.0))
    assert got == pytest.approx({"value": 35 / 1e3 / 2.0,
                                 "idle_ms_per_mpx": 17 / 1e3 / 2.0})
    # the same spans named otherwise: the reader sees none of them
    spans([dict(s, name=s["name"].replace("trellis", "analysis"))
           for s in SPANS])
    assert reader("host.trellis_ms_per_mpx").read(view()) is None


@pytest.mark.parametrize("rows", [[], [span("request", 100, 50),
                                       span("fetch", 110, 5),
                                       span("trellis", 10, 20)]],
                         ids=["no spans", "no trellis span in the slice"])
def test_host_trellis_without_its_spans(rows, spans):
    spans(rows)
    assert reader("host.trellis_ms_per_mpx").read(view()) is None


def test_host_trellis_on_a_program_without_spans(monkeypatch):
    from sjpeg_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "trace_spans")
    assert reader("host.trellis_ms_per_mpx").read(view()) is None
