"""One run of one cell: set-up, the measured window, the traced slice, the
check against the plain reference, and the result line.

Everything that belongs to one configuration, traffic mix, per-layer metric
or kernel family is a file found by its name:

  configs/<config>.json      the encoder's settings (BENCHMARK.json names it)
  traffic/<mix>.json         the entry, the generator and its parameters
  entries/<entry>.py         drive(engine, param, pool, traffic, window, dev)
  gen/<generator>.py         pool(traffic, seed, device)
  metrics/<metric>.py        read(trace view) -> value, {"value": ...} or
                             None; a dot in the name is a folder
  kernels/<family>.json      the family's __global__ names and counter

A request is one call of the cell's entry, from handing over host pixels to
holding the JPEG bytes.  The window issues requests in a closed loop until
its seconds are up, and waits for those already issued; its length runs
from the first request's start to the last one's end.
"""

import contextlib
import importlib
import importlib.util
import json
import math
import random
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from . import tracing
from .reference import encoder as reference
from .reference import spec as reference_spec

BENCH_DIR = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "sjpeg_tpu")
MODES = {"auto": "YUV_AUTO", "420": "YUV_420", "sharp": "YUV_SHARP",
         "444": "YUV_444", "400": "YUV_400"}
REFERENCE_THREADS = 8


class Failure(Exception):
    """A run that cannot give a result: an unknown cell, a missing file, a
    forbidden module loaded."""


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list
    per_layer: list
    bench_dir: Path


def load_cell(workload: str, spec_path: Path = None,
              bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell `workload` of BENCHMARK.json, with its config and traffic
    files, its end-to-end metrics and its per-layer metrics."""
    spec_path = Path(spec_path or bench_dir.parent / "BENCHMARK.json")
    if not spec_path.is_file():
        raise Failure(f"no {spec_path}")
    spec = json.loads(spec_path.read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise Failure(f"no workload {workload!r} in {spec_path}")
    w = cells[workload]
    cfg = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = json.loads(_file(spec_path.parent / cfg["file"]).read_text())
    traffic = json.loads(
        _file(bench_dir / "traffic" / f"{w['traffic']}.json").read_text())

    e2e = [m for m in spec["end_to_end"]
           if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in names)]
    return Cell(workload, config, traffic, w["chips"], e2e, per_layer,
                bench_dir)


def _file(path: Path) -> Path:
    if not path.is_file():
        raise Failure(f"no file {path}")
    return path


def load_module(bench_dir: Path, kind: str, name: str):
    """The module of `kind`/<name>.py under `bench_dir`, a dot in the name
    being a folder; loaded from its path, so a file added under a copy of
    the folder is found as well."""
    path = _file(bench_dir / kind / (name.replace(".", "/") + ".py"))
    key = f"_bench_{kind}_{re.sub(r'[^0-9A-Za-z_]', '_', name)}"
    spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def port_param(config: dict):
    """The port's EncoderParam for a configuration file."""
    from sjpeg_tpu_torch import constants as C
    from sjpeg_tpu_torch.params import EncoderParam
    return EncoderParam(
        quality=config["quality"],
        yuv_mode=getattr(C, MODES[config["yuv_mode"]]),
        huffman_compress=config["huffman_compress"],
        adaptive_quantization=config["adaptive_quantization"],
        use_trellis=config["use_trellis"],
        quantization_bias=config["quantization_bias"],
        qdelta_max_luma=config["qdelta_max_luma"],
        qdelta_max_chroma=config["qdelta_max_chroma"])


def reference_settings(config: dict) -> reference.Settings:
    if config["use_trellis"]:
        raise Failure("the plain reference has no trellis quantization")
    return reference.Settings(
        quality=config["quality"], yuv_mode=config["yuv_mode"],
        optimize_huffman=config["huffman_compress"],
        adaptive_quantization=config["adaptive_quantization"],
        quantization_bias=config["quantization_bias"],
        qdelta_max_luma=config["qdelta_max_luma"],
        qdelta_max_chroma=config["qdelta_max_chroma"])


def kernel_families(bench_dir: Path) -> dict:
    """{family: its kernels/<family>.json}."""
    return {p.stem: json.loads(p.read_text())
            for p in sorted((bench_dir / "kernels").glob("*.json"))}


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is jax, jaxlib, flax or the
    JAX package, compared whole (so sjpeg_tpu_torch is not sjpeg_tpu)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in list(names)} & set(FORBIDDEN))


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile."""
    s = sorted(values)
    return s[max(math.ceil(q / 100.0 * len(s)) - 1, 0)]


def _counter(spec: str):
    module, attr = spec.split(":")
    return getattr(importlib.import_module(module), attr)


class Tracer:
    """Traces requests [first, first + count) of a window with the port's
    device_trace, primed, between two markers; the trace is read and
    deleted when the slice ends."""

    def __init__(self, first: int, count: int, device, families: dict):
        self.first, self.last = first, first + count - 1
        self.device, self.families = device, families
        self.stack = contextlib.ExitStack()
        self.dir = None
        self.events = None
        self.launches = {}
        self.jpegs = []
        self.pixels = 0

    def begin(self, i: int) -> None:
        if i != self.first:
            return
        from sjpeg_tpu_torch.utils.profiling import device_trace
        self.dir = tempfile.mkdtemp(prefix="bench_trace_")
        self.stack.enter_context(device_trace(self.dir))
        if self.device.type == "cuda":
            tracing.prime_trace(self.device)
        for fam in self.families.values():
            _counter(fam["counter"]).launches = 0
        with torch.profiler.record_function("bench.slice_begin"):
            pass

    def end(self, i: int, outputs, pixels: int) -> None:
        if self.first <= i <= self.last and self.dir is not None:
            self.jpegs.extend(outputs)
            self.pixels += pixels
        if i == self.last:
            self.finish()

    def finish(self) -> None:
        if self.dir is None or self.events is not None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        with torch.profiler.record_function("bench.slice_end"):
            pass
        self.launches = {f: _counter(fam["counter"]).launches
                         for f, fam in self.families.items()}
        try:
            self.stack.close()
            files = sorted(Path(self.dir).glob("*.pt.trace.json"))
            self.events = (json.loads(files[0].read_text())["traceEvents"]
                           if files else [])
        finally:
            shutil.rmtree(self.dir, ignore_errors=True)


class Window:
    """The closed loop's bookkeeping: issues requests while `more()`
    (until a count is reached, or until the seconds are up, every input
    has been requested and, traced, the slice's last request is issued),
    times each, and keeps for the check the outputs of each input's first
    request and a reservoir sample, drawn from the seed, of the rest."""

    def __init__(self, pool_pixels, seconds=None, count=None, seed=0,
                 keep=0, tracer=None):
        self.pool_pixels = pool_pixels
        self.seconds, self.count = seconds, count
        self.tracer = tracer
        self.rng = random.Random(seed)
        self.keep = keep
        self.firsts = {}            # pool item -> (request, outputs)
        self.reservoir = []         # [(request, pool item, outputs)]
        self.others = 0
        self.lat, self.items, self.pixels = [], [], 0
        self.started = self.ended = None
        self.n = 0

    def more(self) -> bool:
        if self.started is None:
            self.started = time.perf_counter()
            return True
        if self.count is not None:
            return self.n < self.count
        if self.n < len(self.pool_pixels):
            return True             # every input is requested once
        if self.tracer is not None and self.n <= self.tracer.last:
            return True             # the traced slice runs to its end
        return time.perf_counter() - self.started < self.seconds

    def begin(self, i: int) -> float:
        if self.tracer:
            self.tracer.begin(i)
        self.n = max(self.n, i + 1)
        return time.perf_counter()

    def end(self, i: int, item: int, t0: float, outputs) -> None:
        t1 = time.perf_counter()
        self.ended = t1
        self.lat.append(t1 - t0)
        self.items.append(item)
        pixels = self.pool_pixels[item]
        self.pixels += pixels
        if self.tracer:
            self.tracer.end(i, outputs, pixels)
        if item not in self.firsts:
            self.firsts[item] = (i, outputs)
            return
        self.others += 1
        if len(self.reservoir) < self.keep:
            self.reservoir.append((i, item, outputs))
            return
        j = self.rng.randrange(self.others)
        if j < self.keep:
            self.reservoir[j] = (i, item, outputs)

    @property
    def sample(self) -> dict:
        """{request: (pool item, outputs)} of the requests kept."""
        out = {i: (item, o) for item, (i, o) in self.firsts.items()}
        out.update((i, (item, o)) for i, item, o in self.reservoir)
        return out

    @property
    def length_s(self) -> float:
        return self.ended - self.started


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def _watts(limit: str):
    try:
        return float(limit.rsplit(",", 1)[1].strip().split()[0])
    except (IndexError, ValueError):
        return None


def _name_pattern(names) -> re.Pattern:
    """Any of `names` as a whole identifier inside a demangled kernel
    name (so place_kernel does not match replace_kernel)."""
    alts = "|".join(re.escape(n) for n in names)
    return re.compile(rf"(?<![0-9A-Za-z_])(?:{alts})(?![0-9A-Za-z_])")


@dataclass
class TraceView:
    """What a per-layer metric reads: the device events of the traced
    slice [lo, hi] (µs), its busy µs, the megapixels and JPEGs of its
    requests, the kernel families and the card's power limit."""
    events: list
    lo: float
    hi: float
    busy_us: float
    mpx: float
    jpegs: list
    families: dict
    power_limit_w: float = None
    requests: int = 0
    extra: dict = field(default_factory=dict)

    def is_port_kernel(self, name: str, family: str = None) -> bool:
        fams = [family] if family else sorted(self.families)
        key = tuple(fams)
        pats = self.extra.setdefault("patterns", {})
        if key not in pats:
            pats[key] = _name_pattern(
                [k for f in fams for k in self.families[f]["names"]])
        return pats[key].search(name) is not None

    def device_us(self, pred) -> float:
        """Device µs inside [lo, hi] of the events that `pred` keeps."""
        return sum(min(e["ts"] + e["dur"], self.hi) - max(e["ts"], self.lo)
                   for e in self.events if pred(e))


def trace_view(tracer: Tracer, families: dict, limit: str) -> TraceView:
    ev = tracer.events or []
    marks = {e["name"]: e["ts"] for e in ev
             if e.get("cat") == "user_annotation"
             and e.get("name", "").startswith("bench.slice_")}
    if "bench.slice_begin" not in marks or "bench.slice_end" not in marks:
        return None
    lo, hi = marks["bench.slice_begin"], marks["bench.slice_end"]
    summary = tracing.trace_summary(ev, lo, hi)
    view = TraceView(events=tracing.device_events(ev, lo, hi), lo=lo, hi=hi,
                     busy_us=summary["busy_us"], mpx=tracer.pixels / 1e6,
                     jpegs=tracer.jpegs, families=families,
                     power_limit_w=_watts(limit),
                     requests=tracer.last - tracer.first + 1)
    view.extra["summary"] = summary
    return view


def compare(sample: dict, expected: dict) -> tuple:
    """(the numbers held against their limits, requests at fault): outputs
    whose bytes differ from the reference's, outputs missing, and distinct
    inputs never compared."""
    wrong = missing = failed = 0
    for item, outputs in sample.values():
        want = expected[item]
        got = list(outputs) if outputs is not None else []
        ok = [isinstance(g, (bytes, bytearray)) for g in got]
        miss = max(len(want) - len(got), 0) + ok.count(False)
        bad = max(len(got) - len(want), 0) + sum(
            1 for g, w, k in zip(got, want, ok) if k and bytes(g) != w)
        wrong += bad
        missing += miss
        failed += bool(bad or miss)
    unchecked = len(expected) - len({it for it, _ in sample.values()})
    return ({"wrong_jpegs": {"value": wrong, "limit": 0},
             "missing_jpegs": {"value": missing, "limit": 0},
             "unchecked_inputs": {"value": unchecked, "limit": 0}}, failed)


def reference_jpegs(pool: list, settings, fdct=reference_spec.fdct_blocks,
                    threads: int = REFERENCE_THREADS) -> tuple:
    """Each pool item's JPEGs from the plain reference, image by image on
    a few threads, and what the content did: modes, bits a pixel, coded
    AC share.  `fdct` swaps the transform (the control's float32 one)."""
    jobs = [(i, j) for i, item in enumerate(pool) for j in range(len(item))]

    def one(job):
        i, j = job
        return reference.encode_images(pool[i][j:j + 1], settings,
                                       fdct=fdct)[0]

    with ThreadPoolExecutor(threads) as ex:
        done = list(ex.map(one, jobs))
    out = {i: [] for i in range(len(pool))}
    modes = {}
    for (i, _), enc in zip(jobs, done):
        out[i].append(enc.jpeg)
        modes[enc.mode] = modes.get(enc.mode, 0) + 1
    pixels = sum(item[0].shape[0] * item[0].shape[1] * len(item)
                 for item in pool)
    content = {"modes": modes,
               "bits_per_pixel": 8 * sum(len(e.jpeg) for e in done) / pixels,
               "coded_ac_share": sum(e.coded_ac for e in done)
               / (63 * sum(e.blocks for e in done))}
    return out, content


def set_up(cell: Cell, seed: int, device):
    """(engine, param, pool, pool pixels, drive) for a cell and seed."""
    from sjpeg_tpu_torch import engine
    dev = torch.device(device)
    traffic = cell.traffic
    gen = load_module(cell.bench_dir, "gen", traffic["generator"])
    drive = load_module(cell.bench_dir, "entries", traffic["entry"]).drive
    pool = gen.pool(traffic, seed, dev)
    pool_pixels = [int(np.prod(item.shape[:3])) for item in pool]
    return engine, port_param(cell.config), pool, pool_pixels, drive


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, log=print) -> dict:
    """Set-up, window, traced slice, check; returns the result line."""
    dev = torch.device(device)
    traffic = cell.traffic
    engine, param, pool, pool_pixels, drive = set_up(cell, seed, dev)

    warm = Window(pool_pixels, count=traffic["warm_requests"])
    drive(engine, param, pool, traffic, warm, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start

    families = kernel_families(cell.bench_dir)
    tracer = (Tracer(traffic["trace_skip"], traffic["trace_requests"], dev,
                     families) if trace else None)
    win = Window(pool_pixels, seconds=seconds, seed=seed,
                 keep=traffic["check_requests"], tracer=tracer)
    cpu0 = time.process_time()
    drive(engine, param, pool, traffic, win, dev)
    process_cpu_s = time.process_time() - cpu0
    if tracer:
        tracer.finish()
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    limit = power_limit() if dev.type == "cuda" else "no card"

    t_ref = time.perf_counter()
    expected, content = reference_jpegs(pool, reference_settings(cell.config))
    checks, failed = compare(win.sample, expected)
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    lat = np.asarray(win.lat) * 1e3
    items = np.asarray(win.items)
    log(json.dumps({"card": limit, "seed": seed, "requests": len(win.lat),
                    "window_s": win.length_s, "setup_s": setup_s,
                    "request_ms_p50_by_tenth": [
                        float(np.median(p)) for p in np.array_split(lat, 10)
                        if len(p)],
                    "request_ms_p50_by_input": [
                        float(np.median(lat[items == i]))
                        for i in range(len(pool)) if (items == i).any()],
                    "request_ms_deciles": np.percentile(
                        lat, range(10, 100, 10)).tolist(),
                    "process_cpu_s": process_cpu_s,
                    "reference_s": time.perf_counter() - t_ref,
                    "checked_requests": len(win.sample),
                    "content": content}))

    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": len(win.lat),
              "failed": failed, "metrics": {}, "device": device_info}
    if not trace:
        values = {"mpx_per_s": win.pixels / 1e6 / win.length_s,
                  "request_ms_p50": 1e3 * statistics.median(win.lat),
                  "request_ms_p95": 1e3 * percentile(win.lat, 95),
                  "setup_s": setup_s}
        for m in cell.end_to_end:
            result["metrics"][m["name"]] = {"value": values[m["name"]],
                                            "unit": m["unit"]}
    else:
        view = trace_view(tracer, families, limit)
        s = view.extra["summary"] if view is not None else None
        log(json.dumps({"launches": tracer.launches,
                        "traced_requests": tracer.last - tracer.first + 1,
                        "top_device_ops": s and s["top_device_ops"]}))
        if view is not None:
            for m in cell.per_layer:
                got = load_module(cell.bench_dir, "metrics",
                                  m["name"]).read(view)
                if got is None:
                    continue
                got = got if isinstance(got, dict) else {"value": got}
                result["metrics"][m["name"]] = dict(got, unit=m["unit"])
            device_info["busy_s"] = view.busy_us / 1e6
            device_info["window_s"] = (view.hi - view.lo) / 1e6
            result["breakdown"] = {
                "device_ops": [[o["name"], o["us"] / 1e6]
                               for o in s["top_device_ops"]],
                "idle_gaps": [[g["began_in"], g["us"] / 1e6]
                              for g in s["longest_gaps"]]}
    bad = forbidden_modules()
    if bad:
        raise Failure(f"modules loaded in the measured process: {bad}")
    result["checks"] = checks
    return result
