"""The benchmark on the card: one short run of each cell, untraced and
traced, through run.py as the check runs it.  Marked `cuda`; skips
without a card.  Run on the card: python -m pytest benchmark/tests -m cuda
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")


def _run(name, trace):
    res = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", name, "--seed",
         str(2 ** 31 + 17), "--seconds", "3", "--trace", str(trace)],
        capture_output=True, text=True, timeout=360, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_card(card, name):
    out = _run(name, 0)
    assert out["correct"] is True
    assert out["device"]["platform"] == "gpu"
    assert out["device"]["kind"] == torch.cuda.get_device_name(0)
    assert set(out["metrics"]) == {m["name"] for m in SPEC["end_to_end"]
                                   if name in m.get("workloads", CELLS)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_traced_cell_reports_its_layers(card, name):
    out = _run(name, 1)
    assert out["correct"] is True
    want = {m["name"] for m in SPEC["per_layer"]
            if name in m.get("workloads", CELLS)}
    assert set(out["metrics"]) == want
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    assert out["breakdown"]["device_ops"]
    for m in out["metrics"].values():
        if m["unit"] == "%":
            assert 0 < m["value"] <= 100
