"""What the port's host-stage spans (sjpeg_tpu_torch.utils.profiling.span)
cost, and how many a request opens, on the card:

    python3 scripts/torch_span_probe.py [--seed N] [--out FILE]

Prints one JSON line: the card's name and power limit; µs a `with span()`
block when nothing records (against a bare loop and a shared
nullcontext), while a StageTimer is installed, and while torch.profiler
records; µs of the `sjpeg.request` wrapper around a call when nothing
records; and for each cell of BENCHMARK.json, after its warm requests,
its entry's spans a request by name (from one traced request), and in
ROUNDS rounds of REQUESTS requests each with nothing recording, with a
StageTimer installed, and with the timer installed under `device_trace`,
the median request ms and the timer's ms a request by stage (a stage's
ms hold its inner spans').  Exits non-zero without a card."""

import argparse
import collections
import contextlib
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
LOOPS_OFF = 1_000_000
LOOPS_ON = 20_000
ROUNDS = 3
REQUESTS = 8


def per_loop_us(body, loops: int) -> float:
    """Median over 5 rounds of µs a call of `body` (a loop of `loops`)."""
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        body(loops)
        times.append((time.perf_counter() - t0) / loops * 1e6)
    return sorted(times)[2]


def span_loop(span, name="fetch"):
    def body(n):
        for _ in range(n):
            with span(name):
                pass
    return body


def costs() -> dict:
    from sjpeg_tpu_torch import engine
    from sjpeg_tpu_torch.utils import profiling

    null = contextlib.nullcontext()

    def bare(n):
        for _ in range(n):
            pass

    def shared_null(n):
        for _ in range(n):
            with null:
                pass

    wrapped = engine._request(lambda: None)

    def request_off(n):
        for _ in range(n):
            wrapped()

    def call_off(n):
        f = (lambda: None)
        for _ in range(n):
            f()

    out = {"bare_loop_us": per_loop_us(bare, LOOPS_OFF),
           "nullcontext_us": per_loop_us(shared_null, LOOPS_OFF),
           "span_off_us": per_loop_us(span_loop(profiling.span), LOOPS_OFF),
           "call_us": per_loop_us(call_off, LOOPS_OFF),
           "request_wrapper_off_us": per_loop_us(request_off, LOOPS_OFF)}
    with profiling.timing(profiling.StageTimer()):
        out["span_timer_us"] = per_loop_us(span_loop(profiling.span),
                                           LOOPS_ON)
    with tempfile.TemporaryDirectory() as d:
        with profiling.device_trace(d):
            out["span_profiler_us"] = per_loop_us(span_loop(profiling.span),
                                                  LOOPS_ON)
        out["profiler_spans_kept"] = len(profiling.trace_spans())
    return out


def run(harness, cell, setup, count: int):
    """`count` requests of the cell's entry -> their host seconds."""
    engine, param, pool, pixels, drive, dev = setup
    win = harness.Window(pixels, count=count)
    drive(engine, param, pool, cell.traffic, win, dev)
    return win.lat


def cells(seed: int, dev) -> dict:
    from benchmark import harness
    from sjpeg_tpu_torch.utils import profiling

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    out = {}
    for w in spec["workloads"]:
        cell = harness.load_cell(w["name"])
        setup = (*harness.set_up(cell, seed, dev), dev)
        run(harness, cell, setup, cell.traffic["warm_requests"])
        with tempfile.TemporaryDirectory() as d:
            with profiling.device_trace(d):
                run(harness, cell, setup, 1)
        counts = collections.Counter(s["name"] for s in
                                     profiling.trace_spans())
        lat = {"off": [], "timer": [], "traced": []}
        stages = {"timer": profiling.StageTimer(),
                  "traced": profiling.StageTimer()}
        for _ in range(ROUNDS):
            lat["off"] += run(harness, cell, setup, REQUESTS)
            with profiling.timing(stages["timer"]):
                lat["timer"] += run(harness, cell, setup, REQUESTS)
            with tempfile.TemporaryDirectory() as d:
                with profiling.device_trace(d), \
                        profiling.timing(stages["traced"]):
                    lat["traced"] += run(harness, cell, setup, REQUESTS)
        n = ROUNDS * REQUESTS
        out[w["name"]] = {
            "spans": sum(counts.values()),
            "by_name": dict(sorted(counts.items())),
            "request_ms_median": {k: 1e3 * sorted(v)[len(v) // 2]
                                  for k, v in lat.items()},
            "stage_ms_a_request": {
                k: {name: 1e3 * sec / n
                    for name, sec in sorted(t.times.items())}
                for k, t in stages.items()}}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=2 ** 31 + 7)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[0] = str(ROOT)

    import torch
    from benchmark import harness
    if not torch.cuda.is_available():
        print("no CUDA device: the probe runs on the card", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    row = {"card": harness.power_limit(), "torch": torch.__version__,
           "costs": costs(), "cells": cells(args.seed, dev)}
    line = json.dumps(row)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
