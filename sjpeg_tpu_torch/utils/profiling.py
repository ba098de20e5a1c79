"""Profiling and observability helpers of the PyTorch port.

- `StageTimer`: accumulates wall time + pixel counts per pipeline stage and
  reports Mpixels/s.
- `device_trace`: context manager around `torch.profiler.profile` that
  writes a Chrome trace of an encode run (CPU ops, and the card's kernels,
  copies and memsets when CUDA is available) into a directory, readable by
  TensorBoard's PyTorch profiler plugin or chrome://tracing.
- `log_jsonl`: append structured metrics records (one JSON object per line).
"""

import contextlib
import json
import pathlib
import time
from collections import defaultdict

import torch


class StageTimer:
    """Host-clock time per named stage.  It adds no synchronise of its own:
    kernels run asynchronously, so on the card a caller that wants a
    stage's device work inside its time synchronises inside the stage
    (`torch.cuda.synchronize()` before the `with` block ends)."""

    def __init__(self):
        self.times = defaultdict(float)
        self.pixels = defaultdict(int)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, pixels: int = 0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
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


@contextlib.contextmanager
def device_trace(logdir: str):
    """Trace the body with torch.profiler and write a Chrome trace
    (`<host>_<pid>.<ns>.pt.trace.json`) into `logdir`, created if needed,
    when the body ends, also after an exception.  Records CPU activity,
    and CUDA activity whenever CUDA is available; the device is
    synchronised before the profiler stops, so kernels still in flight
    reach the trace.  Yields the profiler (`key_averages()` after exit)."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    pathlib.Path(logdir).mkdir(parents=True, exist_ok=True)
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


def log_jsonl(path: str, record: dict) -> None:
    record = dict(record, ts=time.time())
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")
