"""The benchmark's plain reference against the port's CPU path, byte for
byte, at small sizes, for both configurations and every mode YUV_AUTO
picks, and against hand-checked cases; and the control (the reference with
a float32 fDCT), which has to come out wrong.

Only these tests import sjpeg_tpu_torch beside the benchmark; nothing
under benchmark/ imports JAX or the JAX package.
Run: python -m pytest benchmark/tests -q
"""

import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.gen import photo  # noqa: E402
from benchmark.reference import encoder, riskiness, spec  # noqa: E402

CONFIGS = ["sjpeg-m0-420-q75", "sjpeg-default-q75"]
# the smallest square at which YUV_AUTO can pick 4:0:0 is ~400 x 400
SIDE = 416


def _config(name):
    return json.loads((ROOT / "benchmark" / "configs" /
                       f"{name}.json").read_text())


@pytest.fixture(scope="module")
def classes_batch():
    """One image of each content class of the batch traffic, 416 x 416,
    drawn on the CPU: (uint8 [4, h, w, 3], class names)."""
    traffic = json.loads((ROOT / "benchmark" / "traffic" /
                          "batch16x1024.json").read_text())
    gen = torch.Generator().manual_seed(2 ** 31 + 5)
    imgs, names = photo.images(traffic["classes"],
                               {k: 1 for k in traffic["classes"]},
                               SIDE, SIDE, traffic["slope"], gen, "cpu")
    return imgs.numpy(), names


def _smooth(h, w, seed):
    r = np.random.default_rng(seed)
    base = r.normal(0, 1, (h // 8 + 1, w // 8 + 1, 3)).cumsum(0).cumsum(1)
    base = np.kron(base, np.ones((8, 8, 1)))[:h, :w]
    base = (base - base.min()) / (np.ptp(base) + 1e-9) * 255
    return np.clip(base + r.normal(0, 6, base.shape), 0,
                   255).astype(np.uint8)


def _port_param(settings):
    from sjpeg_tpu_torch import constants as PC
    from sjpeg_tpu_torch.params import EncoderParam
    return EncoderParam(
        quality=settings.quality,
        yuv_mode=getattr(PC, harness.MODES[settings.yuv_mode]),
        huffman_compress=settings.optimize_huffman,
        adaptive_quantization=settings.adaptive_quantization,
        quantization_bias=settings.quantization_bias,
        qdelta_max_luma=settings.qdelta_max_luma,
        qdelta_max_chroma=settings.qdelta_max_chroma)


@pytest.fixture
def exact_port():
    """The port with sjpeg's own riskiness table switched on, restored
    after the test."""
    from sjpeg_tpu_torch import riskiness as port_risk
    before = port_risk.exact_table_active()
    port_risk.use_exact_table(True)
    yield
    port_risk.use_exact_table(before)


def test_classes_cover_every_auto_pick(classes_batch):
    imgs, names = classes_batch
    picks = {n: encoder.MODE_NAMES[riskiness.riskiness(im)[0]]
             for im, n in zip(imgs, names)}
    assert picks == {"photo": "420", "mono": "400", "vivid": "sharp",
                     "graphic": "444"}


def test_risk_table_is_sjpegs_not_the_ports_model():
    """The reference scores pairs with sjpeg's kSharpnessScore (the same
    bytes as the port's copy of score_7.cc's table), not the port's
    regenerated default model."""
    from sjpeg_tpu_torch import riskiness as port_risk
    table = riskiness.sharpness_table()
    assert np.array_equal(table, port_risk._exact_table())
    assert not np.array_equal(table, port_risk.sharpness_table())
    # a pair of equal colours scores nothing
    idx = np.arange(riskiness.KRGB3)
    square = table.reshape(riskiness.KRGB3, riskiness.KRGB3)
    assert not square[idx, idx].any()


@pytest.mark.parametrize("config", CONFIGS)
def test_reference_equals_port_cpu_exact_table(config, classes_batch,
                                               exact_port):
    from sjpeg_tpu_torch import engine
    cfg = _config(config)
    imgs, _ = classes_batch
    want = [e.jpeg for e in encoder.encode_images(
        imgs, harness.reference_settings(cfg))]
    got = engine.encode_batch(imgs, harness.port_param(cfg), device="cpu")
    assert got == want


@pytest.mark.parametrize("mode", ["420", "444", "400", "sharp", "auto"])
@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("shape", [(48, 64), (37, 53), (130, 96)])
def test_reference_equals_port_cpu_odd_shapes(mode, optimize, shape,
                                              exact_port):
    from sjpeg_tpu_torch import engine
    settings = encoder.Settings(yuv_mode=mode, optimize_huffman=optimize,
                                adaptive_quantization=optimize)
    im = _smooth(*shape, seed=shape[0] * shape[1])
    got = encoder.encode_images(im[None], settings)[0].jpeg
    assert got == engine.encode_rgb(im, _port_param(settings), device="cpu")


@pytest.mark.parametrize("config", CONFIGS)
def test_reference_equals_port_cpu_batch(config, classes_batch):
    from sjpeg_tpu_torch import engine
    cfg = _config(config)
    imgs, _ = classes_batch
    want = [e.jpeg for e in encoder.encode_images(
        imgs, harness.reference_settings(cfg))]
    got = engine.encode_batch(imgs, harness.port_param(cfg), device="cpu")
    assert got == want


@pytest.mark.parametrize("config", CONFIGS)
def test_reference_equals_port_cpu_single(config):
    from sjpeg_tpu_torch import engine
    cfg = _config(config)
    im = _smooth(72, 100, seed=7)
    want = encoder.encode_images(im[None],
                                 harness.reference_settings(cfg))[0].jpeg
    assert engine.encode_rgb(im, harness.port_param(cfg),
                             device="cpu") == want


def test_fdct_equals_port_plain_fdct():
    from sjpeg_tpu_torch.ops import fdct
    blocks = np.random.default_rng(1).integers(-128, 128, (4096, 64))
    got = fdct.fdct_blocks_plain(torch.from_numpy(blocks).to(torch.int32))
    assert np.array_equal(spec.fdct_blocks(blocks), got.numpy())


def test_fdct_hand_checked():
    """A flat block differs from the zero block (whose rounding terms
    leave 2 and -3 in two vertical positions) only in its DC, 16 x 8 x
    the level; any block lies within 3 of the orthonormal DCT x16 in
    float64."""
    flat = np.repeat(np.array([[-128], [0], [100], [127]]), 64, axis=1)
    out = spec.fdct_blocks(flat).astype(np.int64)
    zero = out[1]
    assert zero[[8, 24]].tolist() == [2, -3]
    assert np.count_nonzero(zero) == 2
    assert (out - zero)[:, 0].tolist() == [-16384, 0, 12800, 16256]
    assert not (out - zero)[:, 1:].any()
    blocks = np.random.default_rng(2).integers(-128, 128, (4096, 64))
    d = spec._dct_matrix()
    x = blocks.reshape(-1, 8, 8).astype(np.float64)
    want = (np.matmul(np.matmul(d, x), d.T) * 16).reshape(-1, 64)
    assert np.abs(spec.fdct_blocks(blocks) - want).max() < 3


@pytest.mark.parametrize("config", CONFIGS)
def test_control_comes_out_wrong(config, classes_batch):
    """The control, the reference with sjpeg's integer fDCT swapped for a
    float32 DCT, breaks the configuration's guarantee of sjpeg's bytes:
    every image differs, and the comparison calls it not correct."""
    settings = harness.reference_settings(_config(config))
    imgs, _ = classes_batch
    pool = [imgs[:2], imgs[2:]]
    expected, _ = harness.reference_jpegs(pool, settings, threads=2)
    control, _ = harness.reference_jpegs(pool, settings, threads=2,
                                         fdct=spec.fdct_blocks_float32)
    checks, failed = harness.compare({i: (i, control[i]) for i in control},
                                     expected)
    assert checks["wrong_jpegs"]["value"] == 4
    assert failed == 2
    assert checks["wrong_jpegs"]["value"] > checks["wrong_jpegs"]["limit"]
