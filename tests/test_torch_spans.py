"""The port's host-stage spans (sjpeg_tpu_torch.utils.profiling.span):
free when nothing records, on the trace's clock under `device_trace`,
counted by an installed StageTimer; and the benchmark's four host readers
(benchmark/metrics/host/) on synthetic spans against hand counts.

Imports no JAX.  The one `cuda`-marked test runs on the card:
    python -m pytest tests/test_torch_spans.py -m cuda -q
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import harness, tracing
from sjpeg_tpu_torch import constants as C
from sjpeg_tpu_torch import engine
from sjpeg_tpu_torch.params import EncoderParam
from sjpeg_tpu_torch.utils import profiling
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
BATCH = np.random.RandomState(17).randint(0, 256, (2, 64, 72, 3)).astype(
    np.uint8)
METHOD0 = EncoderParam(huffman_compress=False, adaptive_quantization=False,
                       yuv_mode=C.YUV_420)
METHOD4 = EncoderParam(yuv_mode=C.YUV_420)
NAMES = {"sjpeg.request", "sjpeg.upload", "sjpeg.fetch", "sjpeg.analysis",
         "sjpeg.tail"}
READERS = ("host.transfer_ms_per_mpx", "host.analysis_ms_per_mpx",
           "host.tail_ms_per_mpx", "host.dispatch_ms_per_mpx")


def _raise(*args, **kwargs):
    raise AssertionError("a span built a record_function range")


def test_spans_off_build_no_range_and_keep_the_bytes(monkeypatch, tmp_path):
    with profiling.device_trace(str(tmp_path)):
        traced = (engine.encode_batch(BATCH, METHOD4, device="cpu"),
                  engine.encode_rgb(BATCH[0], METHOD0, device="cpu"))
    assert profiling.trace_spans()
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    assert profiling.span("request") is profiling.span("tail")
    plain = (engine.encode_batch(BATCH, METHOD4, device="cpu"),
             engine.encode_rgb(BATCH[0], METHOD0, device="cpu"))
    assert plain == traced


def _ns(t: float) -> int:
    return round(t * 1000)


def test_spans_nest_in_requests_on_the_trace_clock(tmp_path):
    with profiling.device_trace(str(tmp_path)):
        engine.encode_batch(BATCH, METHOD4, device="cpu")
        engine.encode_rgb(BATCH[0], METHOD0, device="cpu")
    spans = profiling.trace_spans()
    assert {s["name"] for s in spans} == NAMES
    requests = [s for s in spans if s["name"] == "sjpeg.request"]
    assert len(requests) == 2
    for s in spans:
        if s["name"] != "sjpeg.request":
            assert any(r["tid"] == s["tid"]
                       and _ns(r["ts"]) <= _ns(s["ts"])
                       and _ns(s["ts"] + s["dur"]) <= _ns(r["ts"] + r["dur"])
                       for r in requests), s
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    written = [{k: e[k] for k in ("name", "ts", "dur", "tid")}
               for e in json.loads(files[0].read_text())["traceEvents"]
               if e.get("cat") == "user_annotation"
               and e["name"].startswith("sjpeg.")]
    assert spans == written


def test_installed_timer_counts_one_batch():
    timer = profiling.StageTimer()
    with profiling.timing(timer):
        engine.encode_batch(BATCH, METHOD0, device="cpu")
    counts = {name: v["calls"] for name, v in timer.report().items()}
    assert counts["request"] == counts["upload"] == counts["tail"] == 1
    assert counts["fetch"] == 2                  # the totals, the words
    assert profiling.span("request") is profiling.span("fetch")


def view(mpx=2.0):
    """A slice [100, 200] µs: the card busy in [100, 110], [130, 150] and
    [185, 190] (an event straddling the start, two that overlap)."""
    def ev(ts, dur):
        return {"name": "k", "cat": "kernel", "ph": "X", "ts": ts, "dur": dur}
    events = [ev(95, 15), ev(130, 15), ev(140, 10), ev(185, 5)]
    return harness.TraceView(
        events=events, lo=100.0, hi=200.0,
        busy_us=tracing.busy_us([(e["ts"], e["ts"] + e["dur"])
                                 for e in events], 100, 200),
        mpx=mpx, jpegs=[], families={})


def span(name, ts, dur, tid=1):
    return {"name": "sjpeg." + name, "ts": ts, "dur": dur, "tid": tid}


# two requests on one thread, one on another thread that begins before the
# slice; nested spans go to the innermost, a fetch inside the tail included
SPANS = [
    span("request", 90, 70),             # [90, 160]: 100-160 in the slice
    span("upload", 90, 15),              # [90, 105]
    span("fetch", 120, 10),              # [120, 130]
    span("analysis", 130, 12),           # [130, 142]
    span("tail", 145, 15),               # [145, 160]
    span("fetch", 148, 4),               # [148, 152] inside the tail
    span("request", 170, 20),            # [170, 190]
    span("tail", 180, 10),               # [180, 190]
    span("request", 40, 10),             # outside the slice
    span("request", 192, 6, tid=2),      # [192, 198], another thread
    span("fetch", 194, 2, tid=2),        # [194, 196]
]
# µs owned in the slice / idle µs inside them (busy: 100-110, 130-150,
# 185-190)
OWNED = {
    "host.transfer_ms_per_mpx": (5 + 10 + 4 + 2, 0 + 10 + 2 + 2),
    "host.analysis_ms_per_mpx": (12, 0),
    "host.tail_ms_per_mpx": (3 + 8 + 10, 0 + 8 + 5),
    "host.dispatch_ms_per_mpx": (15 + 3 + 10 + 4, 10 + 0 + 10 + 4),
}


def reader(name):
    return harness.load_module(BENCH, "metrics", name).read


@pytest.mark.parametrize("name", READERS)
def test_host_readers_hand_counts(name, monkeypatch):
    monkeypatch.setattr(profiling, "trace_spans", lambda: list(SPANS))
    own, idle = OWNED[name]
    got = reader(name)(view(mpx=2.0))
    assert got == pytest.approx({"value": own / 1e3 / 2.0,
                                 "idle_ms_per_mpx": idle / 1e3 / 2.0})


def test_host_readers_idle_sums_to_the_slices(monkeypatch):
    monkeypatch.setattr(profiling, "trace_spans", lambda: list(SPANS))
    t = view(mpx=1.0)
    idle = sum(reader(name)(t)["idle_ms_per_mpx"] for name in READERS)
    # outside every request span: [160, 170], [190, 192], [198, 200], idle
    outside_ms = (10 + 2 + 2) / 1e3
    span_ms = (t.hi - t.lo) / 1e3
    assert idle + outside_ms == pytest.approx(
        (1 - t.busy_us / (t.hi - t.lo)) * span_ms)


@pytest.mark.parametrize("name", READERS)
def test_host_readers_without_spans(name, monkeypatch):
    monkeypatch.setattr(profiling, "trace_spans", lambda: [])
    assert reader(name)(view()) is None
    monkeypatch.setattr(profiling, "trace_spans",
                        lambda: [span("request", 300, 10)])
    assert reader(name)(view()) is None
    monkeypatch.delattr(profiling, "trace_spans")    # a port without spans
    assert reader(name)(view()) is None


@pytest.mark.cuda
def test_upload_span_holds_its_copy_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    dev = torch.device("cuda")
    rgb = np.random.RandomState(3).randint(0, 256, (4, 512, 512, 3)).astype(
        np.uint8)
    engine.encode_batch(rgb, METHOD0, device=dev)
    with profiling.device_trace(str(tmp_path)):
        tracing.prime_trace(dev)
        engine.encode_batch(rgb, METHOD0, device=dev)
    (upload,) = [s for s in profiling.trace_spans()
                 if s["name"] == "sjpeg.upload"]
    events = json.loads(next(tmp_path.glob("*.pt.trace.json")).read_text())[
        "traceEvents"]
    copies = [e for e in events if e.get("cat") == "gpu_memcpy"
              and e["name"].startswith("Memcpy HtoD")
              and e["dur"] > 0 and e["ts"] >= upload["ts"] - 1]
    big = max(copies, key=lambda e: e["dur"])
    assert upload["ts"] <= big["ts"] <= upload["ts"] + upload["dur"]
