"""sjpeg's -trellis (method 7) on the single-image path that the
benchmark's `sjpeg-m7-q75.photo12mp` cell times: `engine.encode_rgb`'s
bytes against the benchmark's plain reference (benchmark/reference/) on
small photo-like images of each AUTO pick, with partial MCUs, at two
qualities, and the port's method-4 bytes as the control that shows the
comparison sees the trellis; the configuration file's mapping to both
sides; the `sjpeg.trellis` span, one a trellis stage; the K.3 rate lengths
uploaded once a device.

Imports no JAX.
"""

import functools
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.gen import photo
from benchmark.reference import encoder
from sjpeg_tpu_torch import constants as C
from sjpeg_tpu_torch import engine
from sjpeg_tpu_torch.huffman import trellis_cost_lens
from sjpeg_tpu_torch.utils import profiling
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
CONFIG = json.loads((BENCH / "configs" / "sjpeg-m7-q75.json").read_text())
DEFAULT = json.loads((BENCH / "configs" / "sjpeg-default-q75.json")
                     .read_text())
TRAFFIC = json.loads((BENCH / "traffic" / "batch16x1024.json").read_text())
SEED = 2 ** 31 + 21
# (content class, height, width) -> the mode that YUV_AUTO picks, alike
# by sjpeg's table and the port's model: partial MCUs in both directions
# (4:0:0 needs about 400 x 400 before the grey share can pass 99.5%)
CASES = {("photo", 45, 67): "420", ("graphic", 45, 67): "444",
         ("vivid", 45, 67): "sharp", ("mono", 403, 411): "400"}
QUALITIES = (75, 40)
PARAMS = [(*case, q) for case in CASES for q in QUALITIES]
IDS = [f"{c}-{h}x{w}-q{q}" for c, h, w, q in PARAMS]


@functools.lru_cache(maxsize=None)
def _image(cls: str, h: int, w: int) -> np.ndarray:
    gen = torch.Generator().manual_seed(SEED)
    imgs, _ = photo.images(TRAFFIC["classes"], {cls: 1}, h, w,
                           TRAFFIC["slope"], gen, "cpu")
    return imgs.numpy()[0]


def _config(quality: int, **changes) -> dict:
    return dict(CONFIG, quality=quality, **changes)


@functools.lru_cache(maxsize=None)
def _reference(cls: str, h: int, w: int, quality: int):
    return encoder.encode_images(
        _image(cls, h, w)[None],
        harness.reference_settings(_config(quality)))[0]


def _port(cls: str, h: int, w: int, quality: int, **changes) -> bytes:
    return engine.encode_rgb(_image(cls, h, w),
                             harness.port_param(_config(quality, **changes)),
                             device="cpu")


@pytest.mark.parametrize("cls, h, w, quality", PARAMS, ids=IDS)
def test_method7_equals_the_reference(cls, h, w, quality):
    want = _reference(cls, h, w, quality)
    assert want.mode == CASES[(cls, h, w)]
    assert _port(cls, h, w, quality) == want.jpeg


@pytest.mark.parametrize("cls, h, w, quality", PARAMS, ids=IDS)
def test_method4_differs_from_the_reference_method7(cls, h, w, quality):
    """The control: the same settings without the trellis give other
    bytes, so the comparison above sees the trellis."""
    assert (_port(cls, h, w, quality, use_trellis=False)
            != _reference(cls, h, w, quality).jpeg)


def test_configuration_is_the_default_with_the_trellis():
    descriptive = set(harness.DESCRIPTIVE)
    settings = {k: v for k, v in CONFIG.items() if k not in descriptive}
    default = {k: v for k, v in DEFAULT.items() if k not in descriptive}
    assert settings == dict(default, use_trellis=True)
    assert CONFIG["reduced"] == CONFIG["assumed"] == []
    param = harness.port_param(CONFIG)
    assert param.method == 7 and param.use_trellis
    assert param.yuv_mode == C.YUV_AUTO and param.quality == 75
    s = harness.reference_settings(CONFIG)
    assert s.trellis and not s.searches
    assert not harness.reference_settings(DEFAULT).trellis


def _stage_calls(monkeypatch) -> list:
    calls = []
    stage = engine._stage_quantize_trellis

    def counted(*args, **kwargs):
        calls.append(1)
        return stage(*args, **kwargs)
    monkeypatch.setattr(engine, "_stage_quantize_trellis", counted)
    return calls


def _encode(entry: str, param):
    if entry == "encode_rgb":
        return [engine.encode_rgb(_image("photo", 45, 67), param,
                                  device="cpu")]
    # an AUTO batch of two picks: one sub-batch, one stage, a mode
    both = np.stack([_image("photo", 45, 67), _image("graphic", 45, 67)])
    return engine.encode_batch(both, param, device="cpu")


@pytest.mark.parametrize("entry, stages", [("encode_rgb", 1),
                                           ("encode_batch", 2)])
def test_trellis_span_once_a_stage(entry, stages, monkeypatch):
    calls = _stage_calls(monkeypatch)
    timer = profiling.StageTimer()
    with profiling.timing(timer):
        _encode(entry, harness.port_param(CONFIG))
    counts = {name: v["calls"] for name, v in timer.report().items()}
    assert len(calls) == stages
    assert counts["trellis"] == stages and counts["request"] == 1


@pytest.mark.parametrize("entry", ["encode_rgb", "encode_batch"])
def test_no_trellis_span_in_method4(entry, monkeypatch):
    calls = _stage_calls(monkeypatch)
    timer = profiling.StageTimer()
    with profiling.timing(timer):
        _encode(entry, harness.port_param(DEFAULT))
    assert calls == [] and "trellis" not in timer.report()
    assert timer.report()["request"]["calls"] == 1


def test_trellis_span_nests_in_its_request_on_the_trace(tmp_path):
    with profiling.device_trace(str(tmp_path)):
        engine.encode_rgb(_image("photo", 45, 67),
                          harness.port_param(CONFIG), device="cpu")
    spans = profiling.trace_spans()
    (trellis,) = [s for s in spans if s["name"] == "sjpeg.trellis"]
    (request,) = [s for s in spans if s["name"] == "sjpeg.request"]
    assert trellis["tid"] == request["tid"]
    assert request["ts"] <= trellis["ts"]
    assert (trellis["ts"] + trellis["dur"]
            <= request["ts"] + request["dur"] + 1e-3)


@pytest.mark.parametrize("entry", ["encode_rgb", "encode_batch"])
def test_rate_lengths_go_to_a_device_once(entry):
    engine._cost_lens.cache_clear()
    param = harness.port_param(CONFIG)
    first = _encode(entry, param)
    assert _encode(entry, param) == first
    info = engine._cost_lens.cache_info()
    assert info.misses == 1 and info.hits >= 1
    lens = engine._cost_lens(torch.device("cpu"))
    assert lens.dtype == torch.int32
    np.testing.assert_array_equal(lens.numpy(), trellis_cost_lens())
