"""CPU rehearsal of the benchmark's harness: BENCHMARK.json against the
contract's format, discovery of cells, mixes and metrics by name, the
generator, the result line, the check against the plain reference with the
timed path broken underneath, and the import rule.

Run: python -m pytest benchmark/tests -q
"""

import ast
import hashlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.gen import photo  # noqa: E402

BENCH = ROOT / "benchmark"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[0-9A-Za-z_][0-9A-Za-z_.\-]{0,63}$")
UNIT = re.compile(r"^[0-9A-Za-z_/%.\-]{1,16}$")


def tiny(cell: harness.Cell) -> harness.Cell:
    """The cell at a size a CPU test holds: its entry, generator, classes
    and settings, on 64 x 96 images (one per class) and short windows."""
    t = dict(cell.traffic, height=64, width=96, warm_requests=2,
             trace_skip=1, trace_requests=2, check_requests=3)
    t["counts"] = {k: 1 for k in t["counts"]}
    cell.traffic = t
    return cell


def run_tiny(name: str, trace=False, seconds=0.4, **kw) -> dict:
    cell = tiny(harness.load_cell(name, **kw))
    return harness.run_cell(cell, 2 ** 31 + 11, seconds, trace, "cpu", 0.0,
                            log=lambda *_: None)


# --- BENCHMARK.json against the contract's format ---------------------------

def test_spec_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert isinstance(SPEC["run_seconds"], int)
    assert len(json.dumps(SPEC)) < 64 * 1024
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)


def _text_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_spec_configs_and_cells():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _text_ok(c["source"]) and _text_ok(c["why"])
        assert c["file"].startswith("benchmark/configs/")
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["reduced"] == c["reduced"] == []
        assert body["assumed"] == []
    configs = {c["name"] for c in SPEC["configs"]}
    assert configs == {w["config"] for w in SPEC["workloads"]}
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and _text_ok(w["why"])
        assert NAME.match(w["traffic"])
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(SPEC["workloads"])


def test_spec_metrics():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert set(e2e) == {"mpx_per_s", "request_ms_p50", "request_ms_p95",
                        "setup_s"}
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert e2e["setup_s"]["bound"] == 0.25
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and _text_ok(m["layer"])
        assert set(m.get("workloads", [])) <= set(CELLS)
        path = BENCH / "metrics" / (m["name"].replace(".", "/") + ".py")
        assert path.is_file(), path
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def e2e_names(name):
    return [m["name"] for m in SPEC["end_to_end"]
            if name in m.get("workloads", CELLS)]


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_loads_its_files(name):
    cell = harness.load_cell(name)
    assert [m["name"] for m in cell.end_to_end] == e2e_names(name)
    assert {"mpx_per_s", "setup_s"} <= set(e2e_names(name))
    assert all(m["moves"] in e2e_names(name) for m in cell.per_layer)
    assert cell.per_layer
    harness.load_module(BENCH, "entries", cell.traffic["entry"])
    harness.load_module(BENCH, "gen", cell.traffic["generator"])
    for m in cell.per_layer:
        assert callable(harness.load_module(BENCH, "metrics",
                                            m["name"]).read)


# --- discovery by name -------------------------------------------------------

def _digest(folder: Path) -> dict:
    return {str(p.relative_to(folder)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(folder.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_mix_and_metric_are_files_found_by_name(tmp_path):
    """A later change adds a cell, a traffic mix and a per-layer metric by
    adding files and entries; no file that is there changes."""
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = _digest(bench)
    mix = json.loads((bench / "traffic" / "batch16x1024.json").read_text())
    mix.update(pool=1, counts={"photo": 2}, height=48, width=64)
    (bench / "traffic" / "tiny-probe.json").write_text(json.dumps(mix))
    (bench / "metrics" / "probe").mkdir()
    (bench / "metrics" / "probe" / "requests.py").write_text(
        "def read(t):\n    return t.requests\n")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "sjpeg-m0-420-q75.tiny-probe",
                              "config": "sjpeg-m0-420-q75",
                              "traffic": "tiny-probe", "chips": 1,
                              "why": "a probe"})
    spec["per_layer"].append({"name": "probe.requests", "unit": "requests",
                              "better": "higher", "source": "device_trace",
                              "layer": "entry", "moves": "mpx_per_s",
                              "workloads": ["sjpeg-m0-420-q75.tiny-probe"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.load_cell("sjpeg-m0-420-q75.tiny-probe",
                             spec_path=tmp_path / "BENCHMARK.json",
                             bench_dir=bench)
    assert "probe.requests" in [m["name"] for m in cell.per_layer]
    cell = tiny(cell)
    out = harness.run_cell(cell, 7, 0.3, True, "cpu", 0.0,
                           log=lambda *_: None)
    assert out["metrics"]["probe.requests"] == {"value": 2,
                                                "unit": "requests"}
    after = _digest(bench)
    assert {k: v for k, v in after.items() if k in before} == before


def test_unknown_cell_and_missing_file_are_failures(tmp_path):
    with pytest.raises(harness.Failure):
        harness.load_cell("no-such-cell")
    with pytest.raises(harness.Failure):
        harness.load_module(BENCH, "metrics", "no.such_metric")


# --- the generator -----------------------------------------------------------

def test_generator_is_seeded_with_fixed_class_counts():
    traffic = json.loads((BENCH / "traffic" / "batch16x1024.json")
                         .read_text())
    small = dict(traffic, height=40, width=56, pool=2)
    a = photo.pool(small, 2 ** 31 + 3, torch.device("cpu"))
    b = photo.pool(small, 2 ** 31 + 3, torch.device("cpu"))
    c = photo.pool(small, 2 ** 31 + 4, torch.device("cpu"))
    assert len(a) == 2 and all(x.shape == (16, 40, 56, 3) for x in a)
    assert all(x.dtype == np.uint8 for x in a)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    for seed in (1, 2 ** 31 + 9, 5 * 10 ** 9):
        gen = torch.Generator().manual_seed(seed)
        _, names = photo.images(small["classes"], small["counts"], 16, 16,
                                2.0, gen, "cpu")
        assert {n: names.count(n) for n in set(names)} == small["counts"]


def test_fields_have_unit_variance_and_falling_spectrum():
    gen = torch.Generator().manual_seed(5)
    f = photo.fields(8, 128, 128, 2.0, gen, "cpu")
    assert abs(float(f.mean())) < 0.1
    assert 0.5 < float(f.var()) < 1.5
    power = (torch.fft.rfft2(f).abs() ** 2).mean(0)
    assert float(power[1:4, 1:4].mean()) > 100 * float(
        power[40:60, 40:60].mean())


# --- the result line ---------------------------------------------------------

@pytest.mark.parametrize("name", CELLS)
def test_result_line_keys(name):
    out = run_tiny(name)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    assert list(out["metrics"]) == e2e_names(name)
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert set(out["checks"]) == {"wrong_jpegs", "missing_jpegs",
                                  "unchecked_inputs"}
    json.dumps(out)


def test_traced_result_line_keys():
    out = run_tiny(CELLS[0], trace=True)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert len(out["breakdown"]["idle_gaps"]) <= 10
    # the window ran on to the end of the traced slice (skip 1, trace 2)
    assert out["attempted"] >= 3


def test_traced_window_outlasts_its_seconds():
    out = run_tiny(CELLS[0], trace=True, seconds=0.0)
    assert out["attempted"] == 3 and out["correct"] is True


@pytest.mark.parametrize("name", CELLS)
def test_window_requests_every_input(name):
    out = run_tiny(name, seconds=0.0)
    pool = harness.load_cell(name).traffic["pool"]
    assert out["attempted"] == pool and out["correct"] is True


def test_stream_mix_left_for_later_runs_correct(tmp_path):
    """The pipelined stream mix and its entry stay in the folder for a
    later cell (added by a BENCHMARK.json entry alone); they run correct."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    name = "sjpeg-m0-420-q75.stream16x1024-d2"
    assert name not in CELLS
    spec["workloads"].append({"name": name, "config": "sjpeg-m0-420-q75",
                              "traffic": "stream16x1024-d2", "chips": 1,
                              "why": "the pipelined stream"})
    for c in spec["configs"]:
        c["file"] = str(ROOT / c["file"])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = tiny(harness.load_cell(name, spec_path=tmp_path /
                                  "BENCHMARK.json", bench_dir=BENCH))
    assert cell.traffic["entry"] == "encode_pipelined"
    out = harness.run_cell(cell, 2 ** 31 + 13, 0.4, False, "cpu", 0.0,
                           log=lambda *_: None)
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= cell.traffic["pool"]


# --- the check, with the timed path broken underneath ------------------------

def _alter_one_byte(jpegs):
    out = [bytes(j) for j in jpegs]
    j = out[0]
    k = len(j) // 2
    out[0] = j[:k] + bytes([j[k] ^ 0x01]) + j[k + 1:]
    return out


def _drop_half(jpegs):
    return list(jpegs)[: len(jpegs) // 2]


FAULTS = {"one_byte_altered": _alter_one_byte, "half_the_batch": _drop_half}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    """The answer altered where it is produced, or half of the batch left
    out: the run says not correct and counts the requests at fault."""
    from sjpeg_tpu_torch import engine
    broken = FAULTS[fault]
    batch, single = engine.encode_batch, engine.encode_rgb
    monkeypatch.setattr(engine, "encode_batch",
                        lambda *a, **k: broken(batch(*a, **k)))
    monkeypatch.setattr(engine, "encode_rgb",
                        lambda *a, **k: broken([single(*a, **k)])[0]
                        if fault == "one_byte_altered" else b"")
    out = run_tiny(name)
    assert out["correct"] is False
    assert out["failed"] >= 1
    c = out["checks"]
    assert c["wrong_jpegs"]["value"] + c["missing_jpegs"]["value"] > 0


def test_compare_counts_wrong_missing_and_unchecked():
    expected = {0: [b"a", b"b"], 1: [b"c"], 2: [b"d"]}
    sample = {0: (0, [b"a", b"x"]), 5: (0, [b"a"]), 1: (1, [b"c"])}
    checks, failed = harness.compare(sample, expected)
    assert {k: v["value"] for k, v in checks.items()} == {
        "wrong_jpegs": 1, "missing_jpegs": 1, "unchecked_inputs": 1}
    assert failed == 2


def test_window_keeps_firsts_and_a_seeded_reservoir():
    def fill(seed):
        w = harness.Window([1, 1, 1], count=40, seed=seed, keep=5)
        while w.more():
            i = w.n
            w.end(i, i % 3, w.begin(i), [i])
        return w
    a, b = fill(3), fill(3)
    assert a.sample == b.sample
    assert {item for item, _ in a.sample.values()} == {0, 1, 2}
    assert len(a.sample) == 8 and len(a.lat) == 40


# --- imports -----------------------------------------------------------------

def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
    return out


def test_no_module_imports_jax_or_the_jax_package():
    sources = list(BENCH.rglob("*.py"))
    assert any("tests" in p.parts for p in sources)
    for p in sources:
        tops = {m.split(".")[0] for m in _imports(p)}
        assert not tops & set(harness.FORBIDDEN), p
        if "reference" in p.parts:
            assert "sjpeg_tpu_torch" not in tops, p
            assert tops <= {"dataclasses", "functools", "numpy",
                            "pathlib"}, p


def test_forbidden_modules_compares_whole_top_level_names():
    loaded = ["sjpeg_tpu_torch", "sjpeg_tpu_torch.engine", "jaxtyping",
              "flaxen", "numpy"]
    assert harness.forbidden_modules(loaded) == []
    assert harness.forbidden_modules(loaded + ["sjpeg_tpu.spec"]) == [
        "sjpeg_tpu"]
    assert harness.forbidden_modules(["jaxlib.xla", "flax", "jax"]) == [
        "flax", "jax", "jaxlib"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark import harness\n"
            "from benchmark.tests.test_bench_harness import run_tiny\n"
            "out = run_tiny(%r)\n"
            "print(out['correct'], harness.forbidden_modules())\n"
            % (str(ROOT), CELLS[0]))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "True []"


def test_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: run.py would measure")
    res = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
         "--seed", str(2 ** 31 + 1), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "no CUDA device" in res.stderr
