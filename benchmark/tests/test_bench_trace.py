"""The trace arithmetic, the per-layer readers and the roofline counts on a
synthetic Chrome trace and on JPEGs of known layout, against hand counts.

Run: python -m pytest benchmark/tests -q
"""

import json
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


def ev(name, cat, ts, dur, ph="X"):
    return {"name": name, "cat": cat, "ts": ts, "dur": dur, "ph": ph}


# a slice [100, 200] µs: an upload, two port kernels, torch glue, a fetch,
# the host's ops, and events outside the slice that must not count
TRACE = [
    ev("bench.slice_begin", "user_annotation", 100, 0),
    ev("bench.slice_end", "user_annotation", 200, 0),
    ev("aten::copy_", "cpu_op", 95, 20),
    ev("aten::add", "cpu_op", 150, 10),
    ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 90, 20),
    ev("void sjpeg::sample_pack_kernel<short>(short const*, int)", "kernel",
       120, 10),
    ev("void at::native::vectorized_elementwise_kernel<4>(int)", "kernel",
       125, 10),
    ev("void replace_kernel<int>(int*)", "kernel", 140, 5),
    ev("place_kernel(unsigned int const*, int)", "kernel", 146, 4),
    ev("Memset (Device)", "gpu_memset", 160, 2),
    ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 190, 20),
    ev("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 170, 3),
    ev("vlc_pack_kernel(int const*)", "kernel", 300, 50),
]


def test_merge_busy_and_gaps():
    spans = [(0, 10), (5, 20), (30, 40), (40, 45), (50, 50)]
    assert tracing.merge_spans(spans) == [(0, 20), (30, 45)]
    assert tracing.busy_us(spans, 10, 35) == 15
    assert tracing.idle_gaps(spans, -5, 60) == [(-5, 0), (20, 30), (45, 60)]
    assert tracing.idle_gaps([], 0, 7) == [(0, 7)]


def test_op_at_takes_the_innermost_op():
    ops = [(0, 100, "outer"), (10, 50, "inner"), (10, 20, "innermost")]
    assert tracing.op_at(15, ops) == "innermost"
    assert tracing.op_at(30, ops) == "inner"
    assert tracing.op_at(60, ops) == "outer"
    assert tracing.op_at(200, ops) == tracing.HOST_WORK


def test_trace_summary_on_a_synthetic_trace():
    s = tracing.trace_summary(TRACE, 100, 200)
    # device union inside [100, 200]: [100, 110] [120, 135] [140, 145]
    # [146, 150] [160, 162] [170, 173] [190, 200]
    assert s["busy_us"] == 10 + 15 + 5 + 4 + 2 + 3 + 10
    names = [o["name"] for o in s["top_device_ops"]]
    assert "vlc_pack_kernel(int const*)" not in names
    assert s["top_device_ops"][0]["us"] == 20
    assert s["top_device_ops"][0]["launches"] == 1
    gaps = s["longest_gaps"]
    assert [g["us"] for g in gaps] == [17, 10, 10, 8, 5, 1]
    assert gaps[0]["began_in"] == tracing.HOST_WORK      # 173 .. 190
    assert gaps[1]["began_in"] == "aten::copy_"          # 110 .. 120
    assert gaps[2]["began_in"] == "aten::add"            # 150 .. 160


def view(jpegs=(), mpx=2.0):
    tracer = harness.Tracer(0, 3, None, FAMILIES)
    tracer.events, tracer.pixels, tracer.jpegs = TRACE, int(mpx * 1e6), \
        list(jpegs)
    return harness.trace_view(tracer, FAMILIES, "NVIDIA H100, 700.00 W")


def metric(name):
    return harness.load_module(BENCH, "metrics", name).read


def test_kernel_names_match_whole_identifiers():
    t = view()
    assert t.is_port_kernel("place_kernel(unsigned int const*, int)")
    assert not t.is_port_kernel("void replace_kernel<int>(int*)")
    assert t.is_port_kernel("void sjpeg::sample_pack_kernel<short>(short)",
                            "sample_pack")
    assert not t.is_port_kernel("void sjpeg::sample_pack_kernel<short>()",
                                "vlc_pack")
    assert t.power_limit_w == 700.0 and t.requests == 3


def test_layer_readers_on_a_synthetic_trace():
    t = view(mpx=2.0)
    assert metric("device.idle_share")(t) == pytest.approx(1 - 49 / 100)
    # HtoD 10 µs and DtoH 10 µs inside the slice; DtoD is not a transfer
    assert metric("transfer.ms_per_mpx")(t) == pytest.approx(0.020 / 2)
    # port kernels: sample_pack 10, place 4
    assert metric("kernels.ms_per_mpx")(t) == pytest.approx(0.014 / 2)
    # glue: the element-wise kernel 10, replace_kernel 5
    assert metric("glue.ms_per_mpx")(t) == pytest.approx(0.015 / 2)


def test_readers_return_nothing_without_their_events():
    t = view()
    t.events = [e for e in t.events if e["cat"] != "kernel"]
    assert metric("kernels.ms_per_mpx")(t) is None
    assert metric("glue.ms_per_mpx")(t) is None
    assert metric("sample_pack_roofline")(t) is None
    assert metric("vlc_pack_roofline")(view()) is None


def _jpeg(h, w, mode, optimize):
    rng = np.random.default_rng(h * w)
    im = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    s = encoder.Settings(yuv_mode=mode, optimize_huffman=optimize,
                         adaptive_quantization=optimize)
    return encoder.encode_images(im[None], s)[0]


@pytest.mark.parametrize("mode, blocks", [("420", 96 + 24 + 24),
                                          ("444", 3 * 96), ("400", 96)])
def test_jpeg_info_counts_blocks_tables_and_scan(mode, blocks):
    enc = _jpeg(64, 96, mode, optimize=False)
    info = jpeg_info.parse(enc.jpeg)
    assert (info.width, info.height, info.blocks) == (96, 64, blocks)
    tables = 2 if mode != "400" else 1
    # DQT: 65 B a table; DHT: the K.3 tables, 29 + 179 B a DC/AC pair
    dht = {1: 29 + 179, 2: 2 * (29 + 179)}[tables]
    assert info.table_bytes == 65 * tables + dht
    header = enc.jpeg.index(b"\xff\xda")
    sos_len = (enc.jpeg[header + 2] << 8) | enc.jpeg[header + 3]
    scan = enc.jpeg[header + 2 + sos_len:-2]
    assert info.scan_bytes == len(scan) - scan.count(b"\xff\x00")


def test_sample_pack_roofline_at_one_shape():
    """16 images of 1024 x 1024 at 4:2:0: 16 x 24,576 blocks."""
    rl = harness.load_module(BENCH, "metrics", "sample_pack_roofline")
    blocks = 16 * (4096 + 1024 + 1024) * 4
    scan, tables = 4_000_000, 16 * (2 * 65 + 420)
    nbytes, ops = rl.work(blocks, scan, tables)
    assert blocks == 393_216
    assert nbytes == 64 * 393_216 + 4_000_000 + 16 * 550
    assert ops == 896 * 393_216
    least, bound = roofline.least_seconds(nbytes, ops)
    # bytes 29.17 MB / 3.35 TB/s = 8.71 µs against 352.3 M / 67 T = 5.26 µs
    assert bound == "bytes"
    assert least == pytest.approx(nbytes / 3.35e12)


def test_vlc_pack_roofline_at_one_shape():
    rl = harness.load_module(BENCH, "metrics", "vlc_pack_roofline")
    assert rl.work(393_216, 4_000_000, 8_800) == (
        2 * 64 * 393_216 + 4_000_000 + 8_800)
    assert roofline.least_seconds(rl.work(393_216, 0, 0), 0)[1] == "bytes"


def test_roofline_share_from_a_trace():
    """sample_pack ran 10 µs in the slice over the work of two JPEGs."""
    jpegs = [_jpeg(64, 96, "420", optimize=False).jpeg for _ in range(2)]
    t = view(jpegs)
    got = metric("sample_pack_roofline")(t)
    info = [jpeg_info.parse(j) for j in jpegs]
    nbytes = sum(64 * i.blocks + i.scan_bytes + i.table_bytes for i in info)
    ops = 896 * sum(i.blocks for i in info)
    want = 100 * max(nbytes / 3.35e12, ops / 67e12) / 10e-6
    assert got["value"] == pytest.approx(want)
    assert got["bound"] == "bytes" and got["power_limit_w"] == 700.0


def test_kernel_families_name_every_global_of_the_port():
    """Each __global__ of the port's CUDA sources is named by one family
    file, and each family names only kernels that exist."""
    import re
    src = ROOT / "sjpeg_tpu_torch" / "csrc"
    found = {}
    for cu in src.glob("*.cu"):
        for name in re.findall(
                r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                r"(\w+)\s*\(", cu.read_text()):
            found[name] = cu.name
    named = {k: f for f, fam in FAMILIES.items() for k in fam["names"]}
    assert set(named) == set(found)
    for fam in FAMILIES.values():
        assert len({found[k] for k in fam["names"]}) == 1
    json.dumps(FAMILIES)
