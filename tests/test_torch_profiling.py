"""The port's profiling utilities (sjpeg_tpu_torch.utils.profiling) against
sjpeg_tpu.utils.profiling, `device_trace` on the CPU, the trace
arithmetic that chip_smoke.py's profiling phase and the benchmark share
(benchmark/tracing.py: interval union, idle gaps, the CPU op a gap began
in) on synthetic intervals, and which traces chip_smoke's device times
accept."""

import json
import time

import numpy as np
import pytest

from sjpeg_tpu.utils import profiling as jprof

import chip_smoke
from benchmark.tracing import (HOST_WORK, busy_us, device_events, idle_gaps,
                               merge_spans, op_at, trace_summary)
from sjpeg_tpu_torch import engine
from sjpeg_tpu_torch.utils import profiling
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)


def _fake_clock(monkeypatch, ticks):
    it = iter(ticks)
    monkeypatch.setattr(time, "perf_counter", lambda: next(it))


def _timed(module, monkeypatch):
    # two stages, one called twice, one with no pixels
    _fake_clock(monkeypatch, [1.0, 1.25, 2.0, 2.5000004, 10.0, 10.125])
    timer = module.StageTimer()
    with timer.stage("encode", pixels=1_000_000):
        pass
    with timer.stage("encode", pixels=3_000_000):
        pass
    with timer.stage("fetch"):
        pass
    return timer


def test_stage_timer_report_matches_jax(monkeypatch):
    got = _timed(profiling, monkeypatch)
    want = _timed(jprof, monkeypatch)
    assert got.report() == want.report()
    assert got.report() == {
        "encode": {"seconds": 0.75, "calls": 2, "mpixels_per_s": 5.33},
        "fetch": {"seconds": 0.125, "calls": 1}}
    assert str(got) == str(want)


def test_stage_timer_counts_a_raising_stage(monkeypatch):
    _fake_clock(monkeypatch, [0.0, 0.5])
    timer = profiling.StageTimer()
    with pytest.raises(ValueError):
        with timer.stage("boom", pixels=10):
            raise ValueError
    assert timer.report() == {"boom": {"seconds": 0.5, "calls": 1,
                                       "mpixels_per_s": 0.0}}


def test_log_jsonl_matches_jax(monkeypatch, tmp_path):
    monkeypatch.setattr(time, "time", lambda: 1234.5)
    records = [{"stage": "encode", "ms": 1.5}, {"n": [1, 2], "ts": 0}]
    for module, name in ((profiling, "port"), (jprof, "jax")):
        for rec in records:
            module.log_jsonl(str(tmp_path / f"{name}.jsonl"), rec)
    got = (tmp_path / "port.jsonl").read_text()
    assert got == (tmp_path / "jax.jsonl").read_text()
    assert [json.loads(ln) for ln in got.splitlines()] == [
        {"stage": "encode", "ms": 1.5, "ts": 1234.5},
        {"n": [1, 2], "ts": 1234.5}]


def _one_trace(logdir) -> list:
    files = list(logdir.glob("*.pt.trace.json"))
    assert len(files) == 1, files
    return json.loads(files[0].read_text())["traceEvents"]


RGB = np.random.RandomState(5).randint(0, 256, (64, 72, 3)).astype(np.uint8)


def test_device_trace_writes_a_chrome_trace(tmp_path):
    logdir = tmp_path / "new" / "dir"
    with profiling.device_trace(str(logdir)) as prof:
        jpeg = engine.encode_rgb(RGB, device="cpu")
    assert jpeg[:2] == b"\xff\xd8"
    events = _one_trace(logdir)
    aten = {e["name"] for e in events if e.get("cat") == "cpu_op"}
    assert "aten::copy_" in aten and len(aten) > 10
    assert any(ev.key.startswith("aten::") for ev in prof.key_averages())


def test_device_trace_writes_its_trace_after_an_exception(tmp_path):
    with pytest.raises(RuntimeError, match="inside"):
        with profiling.device_trace(str(tmp_path)):
            engine.encode_rgb(RGB[:16, :16], device="cpu")
            raise RuntimeError("inside")
    assert any(e.get("cat") == "cpu_op" for e in _one_trace(tmp_path))


@pytest.mark.parametrize("spans,union,busy,gaps", [
    # overlapping
    ([(2, 5), (4, 7)], [(2, 7)], 5, [(0, 2), (7, 10)]),
    # nested
    ([(1, 9), (3, 4), (5, 6)], [(1, 9)], 8, [(0, 1), (9, 10)]),
    # empty spans and none at all
    ([(3, 3), (6, 5)], [], 0, [(0, 10)]),
    ([], [], 0, [(0, 10)]),
    # a gap at each end, spans reaching past the window, out of order
    ([(8, 12), (-3, 1), (4, 5)], [(-3, 1), (4, 5), (8, 12)], 4,
     [(1, 4), (5, 8)]),
    # touching spans merge; a span wholly outside the window
    ([(2, 4), (4, 6), (11, 12)], [(2, 6), (11, 12)], 4,
     [(0, 2), (6, 10)]),
])
def test_interval_union_and_gaps(spans, union, busy, gaps):
    assert merge_spans(spans) == union
    assert busy_us(spans, 0, 10) == busy
    assert idle_gaps(spans, 0, 10) == gaps
    # busy and idle partition the window
    assert busy + sum(e - s for s, e in gaps) == 10


def test_gap_attribution():
    ops = [(0, 100, "aten::to"), (10, 40, "aten::copy_"),
           (10, 20, "aten::empty"), (60, 70, "aten::item")]
    assert op_at(5, ops) == "aten::to"
    assert op_at(15, ops) == "aten::empty"      # innermost: same start,
    assert op_at(25, ops) == "aten::copy_"      # the shorter one first
    assert op_at(40, ops) == "aten::to"         # an op's end is outside it
    assert op_at(65, ops) == "aten::item"
    assert op_at(150, ops) == HOST_WORK


def test_trace_summary_on_synthetic_events():
    def x(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}

    events = [
        x("cpu_op", "aten::to", 95, 30),
        x("cpu_op", "aten::copy_", 100, 10),
        x("kernel", "sample_pack_kernel", 110, 40),
        x("kernel", "sample_pack_kernel", 140, 20),    # overlaps the first
        x("gpu_memset", "Memset (Device)", 170, 5),
        x("gpu_memcpy", "Memcpy DtoH", 300, 50),
        x("kernel", "outside", 900, 10),              # past the window
        x("cuda_runtime", "cudaLaunchKernel", 100, 5),
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 120},
    ]
    s = trace_summary(events, 100, 400, top=2, n_gaps=3)
    assert s["busy_us"] == 50 + 5 + 50
    assert s["top_device_ops"] == [
        {"name": "sample_pack_kernel", "us": 60, "launches": 2},
        {"name": "Memcpy DtoH", "us": 50, "launches": 1}]
    assert s["longest_gaps"] == [
        {"us": 125, "at_us": 75, "began_in": HOST_WORK},
        {"us": 50, "at_us": 250, "began_in": HOST_WORK},
        {"us": 10, "at_us": 0, "began_in": "aten::copy_"}]
    assert sorted({e["name"] for e in device_events(events, 100, 400)}) == [
        "Memcpy DtoH", "Memset (Device)", "sample_pack_kernel"]



def test_device_times_come_from_whole_traces(monkeypatch):
    """chip_smoke's kernel_us and op_us on synthetic torch.profiler
    summaries ({name: launches and us a call}): a kernel's time is a
    launch's, and an op's (a zero fill and a kernel, each once a call) the
    sum of its parts' times a launch, also from a trace that lost some
    calls' records; a trace that misses the kernel, or in which something
    ran twice a call, is taken again, and after the last try the result
    is None, never 0 or a part of a call."""
    kernel = "void (anonymous namespace)::risk_kernel(...)"
    whole = {kernel: {"launches": 1.0, "us": 90.0},
             "Memset (Device)": {"launches": 1.0, "us": 3.0}}
    partial = {kernel: {"launches": 0.6, "us": 54.0},
               "Memset (Device)": {"launches": 0.8, "us": 2.4}}
    missed = {"Memset (Device)": {"launches": 1.0, "us": 3.0}}
    twice = {kernel: {"launches": 1.0, "us": 90.0},
             "Memset (Device)": {"launches": 2.0, "us": 6.0}}
    assert chip_smoke.kernel_us(None, "risk_stats", trace=partial) == 90.0
    assert chip_smoke.op_us(None, "risk_stats", trace=whole) == 93.0
    assert chip_smoke.op_us(None, "risk_stats",
                            trace=partial) == pytest.approx(93.0)
    traces = iter([twice, whole])
    monkeypatch.setattr(chip_smoke, "device_kernels",
                        lambda fn, calls: next(traces))
    assert chip_smoke.op_us(lambda: None, "risk_stats", trace=missed) == 93.0
    traces = iter([missed, twice])
    monkeypatch.setattr(chip_smoke, "device_kernels",
                        lambda fn, calls: next(traces))
    assert chip_smoke.op_us(lambda: None, "risk_stats", trace=twice) is None
    traces = iter([missed, missed])
    monkeypatch.setattr(chip_smoke, "device_kernels",
                        lambda fn, calls: next(traces))
    assert chip_smoke.kernel_us(lambda: None, "risk_stats",
                                trace=missed) is None
