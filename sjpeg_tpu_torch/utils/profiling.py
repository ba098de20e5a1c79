"""Profiling and observability helpers of the PyTorch port.

- `StageTimer`: accumulates wall time + pixel counts per pipeline stage and
  reports Mpixels/s.
- `span`: the host interval of one encoder stage (`sjpeg.<name>`): a
  `record_function` range while a torch.profiler session records, time
  added to the `StageTimer` installed by `timing`, nothing otherwise.
- `device_trace`: context manager around `torch.profiler.profile` that
  writes a Chrome trace of an encode run (CPU ops, the spans, and the
  card's kernels, copies and memsets when CUDA is available) into a
  directory, readable by TensorBoard's PyTorch profiler plugin or
  chrome://tracing; `trace_spans` returns the spans of its last trace.
- `log_jsonl`: append structured metrics records (one JSON object per line).
"""

import contextlib
import json
import pathlib
import threading
import time
from collections import defaultdict

import torch
import torch.autograd.profiler as _autograd_profiler

SPAN_PREFIX = "sjpeg."


class StageTimer:
    """Host-clock time per named stage.  It adds no synchronise of its own:
    kernels run asynchronously, so on the card a caller that wants a
    stage's device work inside its time synchronises inside the stage
    (`torch.cuda.synchronize()` before the `with` block ends)."""

    def __init__(self):
        self.times = defaultdict(float)
        self.pixels = defaultdict(int)
        self.counts = defaultdict(int)
        self._lock = threading.Lock()   # stages may end on several threads

    @contextlib.contextmanager
    def stage(self, name: str, pixels: int = 0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.times[name] += dt
                self.pixels[name] += pixels
                self.counts[name] += 1

    def report(self) -> dict:
        out = {}
        for name, t in self.times.items():
            entry = {"seconds": round(t, 6), "calls": self.counts[name]}
            if self.pixels[name]:
                entry["mpixels_per_s"] = round(self.pixels[name] / t / 1e6, 2)
            out[name] = entry
        return out

    def __str__(self):
        return json.dumps(self.report(), indent=2)


# the StageTimer that spans feed (`timing`), process-wide
_timer = None
# the names of the spans open on each thread
_open = threading.local()
_NO_SPAN = contextlib.nullcontext()
# the spans of the last trace that device_trace wrote
_trace_spans = []


class _Span:
    """An open span: its record_function range while the profiler records,
    its stage in the installed timer.  A span inside a span of the same
    name on its thread opens nothing, so a public entry point that calls
    another (encode_rgb -> encode_yuv) is one request."""

    __slots__ = ("name", "parts")

    def __init__(self, name: str):
        self.name = name
        self.parts = None

    def __enter__(self):
        names = getattr(_open, "names", None)
        if names is None:
            names = _open.names = set()
        if self.name in names:
            return self
        names.add(self.name)
        parts = []
        if _autograd_profiler._is_profiler_enabled:
            parts.append(torch.profiler.record_function(
                SPAN_PREFIX + self.name))
        if _timer is not None:
            parts.append(_timer.stage(self.name))
        for part in parts:
            part.__enter__()
        self.parts = parts
        return self

    def __exit__(self, *exc):
        if self.parts is None:
            return False
        for part in reversed(self.parts):
            part.__exit__(*exc)
        _open.names.discard(self.name)
        return False


def span(name: str):
    """The host interval of the encoder stage `name`, a context manager.
    While a torch.profiler session records, a `record_function` range
    `sjpeg.<name>`: a `user_annotation` event of the Chrome trace, on the
    clock of its kernels and copies; while a StageTimer is installed
    (`timing`), its seconds go to `timer.stage(name)`.  Otherwise the
    shared no-op context: no range, no clock read, no allocation."""
    if _timer is None and not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Span(name)


@contextlib.contextmanager
def timing(timer: StageTimer):
    """Install `timer` for the body, process-wide: every span on any thread
    adds its host seconds and a call to `timer.stage(<span name>)`.  A
    stage's seconds hold its inner spans' (a request holds its upload)."""
    global _timer
    previous, _timer = _timer, timer
    try:
        yield timer
    finally:
        _timer = previous


def trace_spans() -> list:
    """The `sjpeg.*` spans of the trace that the last `device_trace` wrote:
    [{"name", "ts", "dur", "tid"}] as the trace file has them (µs, the
    clock of its device events); empty before its body has ended."""
    return list(_trace_spans)


def _spans_of(trace_file: pathlib.Path) -> list:
    events = json.loads(trace_file.read_text()).get("traceEvents", [])
    return [{k: e[k] for k in ("name", "ts", "dur", "tid")} for e in events
            if e.get("cat") == "user_annotation" and e.get("ph") == "X"
            and e.get("name", "").startswith(SPAN_PREFIX)]


@contextlib.contextmanager
def device_trace(logdir: str):
    """Trace the body with torch.profiler and write a Chrome trace
    (`<host>_<pid>.<ns>.pt.trace.json`) into `logdir`, created if needed,
    when the body ends, also after an exception.  Records CPU activity,
    and CUDA activity whenever CUDA is available; the device is
    synchronised before the profiler stops, so kernels still in flight
    reach the trace.  Yields the profiler (`key_averages()` after exit).
    Once the trace is written, `trace_spans()` returns its spans."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    logdir = pathlib.Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    _trace_spans.clear()
    before = set(logdir.glob("*.pt.trace.json"))
    prof = profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(str(logdir)))
    prof.start()
    try:
        yield prof
    finally:
        try:
            if cuda:
                torch.cuda.synchronize()
        finally:
            prof.stop()
            for path in sorted(set(logdir.glob("*.pt.trace.json")) - before):
                _trace_spans.extend(_spans_of(path))


def log_jsonl(path: str, record: dict) -> None:
    record = dict(record, ts=time.time())
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")
