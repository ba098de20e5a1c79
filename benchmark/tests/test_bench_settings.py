"""The configuration keys that state sjpeg's trellis (method 7) and its
search for a target size or PSNR: the harness passes them to the port's
EncoderParam and to the plain reference's Settings, rejects a key it does
not know, and the reference gives the port's bytes (its CPU path) through
each of the port's three batched search routes and its single-image
search; the controls that skip the trellis or the search, or swap the
fDCT, come out wrong; and a cell of such a configuration runs from data
files alone.

Run: python -m pytest benchmark/tests/test_bench_settings.py -q
"""

import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.gen import photo  # noqa: E402
from benchmark.reference import encoder, spec, trellis  # noqa: E402

CONFIGS = ["sjpeg-m0-420-q75", "sjpeg-default-q75"]
TRAFFIC = json.loads((ROOT / "benchmark" / "traffic" /
                      "batch16x1024.json").read_text())
# about 68% of what the default configuration writes for the 416 x 416
# classes below (29.3-50.9 kB an image)
SIZE_416 = 28000
# the trellis searches run on two 192 x 192 images, ~9-12 kB by default
SIZE_192 = 6000


def _config(name, **changes):
    cfg = json.loads((ROOT / "benchmark" / "configs" /
                      f"{name}.json").read_text())
    return dict(cfg, **changes)


def _images(side, seed, count=None):
    """One image of each content class of the batch traffic (uint8
    [4, side, side, 3]), or the first `count`."""
    gen = torch.Generator().manual_seed(seed)
    imgs, names = photo.images(TRAFFIC["classes"],
                               {k: 1 for k in TRAFFIC["classes"]}, side,
                               side, TRAFFIC["slope"], gen, "cpu")
    return imgs.numpy()[:count], names[:count]


@pytest.fixture(scope="module")
def classes_416():
    return _images(416, 2 ** 31 + 5)


@pytest.fixture(scope="module")
def pair_192():
    return _images(192, 2 ** 31 + 9, count=2)


# --- the mapping --------------------------------------------------------------

@pytest.mark.parametrize("name", CONFIGS)
def test_existing_configurations_map_as_before(name):
    """The committed files give the EncoderParam and Settings that the
    harness built before the trellis and search keys existed."""
    from sjpeg_tpu_torch import constants as PC
    from sjpeg_tpu_torch.params import TARGET_NONE, EncoderParam
    cfg = _config(name)
    assert harness.port_param(cfg) == EncoderParam(
        quality=cfg["quality"],
        yuv_mode=getattr(PC, harness.MODES[cfg["yuv_mode"]]),
        huffman_compress=cfg["huffman_compress"],
        adaptive_quantization=cfg["adaptive_quantization"],
        use_trellis=cfg["use_trellis"],
        quantization_bias=cfg["quantization_bias"],
        qdelta_max_luma=cfg["qdelta_max_luma"],
        qdelta_max_chroma=cfg["qdelta_max_chroma"])
    assert harness.port_param(cfg).target_mode == TARGET_NONE
    settings = harness.reference_settings(cfg)
    assert settings == encoder.Settings(
        quality=cfg["quality"], yuv_mode=cfg["yuv_mode"],
        optimize_huffman=cfg["huffman_compress"],
        adaptive_quantization=cfg["adaptive_quantization"],
        quantization_bias=cfg["quantization_bias"],
        qdelta_max_luma=cfg["qdelta_max_luma"],
        qdelta_max_chroma=cfg["qdelta_max_chroma"])
    assert not settings.trellis and not settings.searches


@pytest.mark.parametrize("mode,given", [
    ("size", {"mode": "size", "value": 160000}),
    ("psnr", {"mode": "psnr", "value": 37.5, "passes": 6, "tolerance": 0.5,
              "qmin": 20, "qmax": 90}),
])
def test_target_maps_to_both_sides(mode, given):
    from sjpeg_tpu_torch.params import TARGET_PSNR, TARGET_SIZE
    cfg = _config("sjpeg-default-q75", use_trellis=True, target=given)
    want = dict(harness.TARGET_DEFAULTS, **given)
    p = harness.port_param(cfg)
    assert p.method == 7
    assert p.target_mode == {"size": TARGET_SIZE, "psnr": TARGET_PSNR}[mode]
    assert (p.target_value, p.passes, p.tolerance, p.qmin, p.qmax) == (
        want["value"], want["passes"], want["tolerance"], want["qmin"],
        want["qmax"])
    s = harness.reference_settings(cfg)
    assert s.trellis and s.searches
    assert (s.target_mode, s.target_value, s.passes, s.tolerance, s.qmin,
            s.qmax) == (mode, want["value"], want["passes"],
                        want["tolerance"], want["qmin"], want["qmax"])


@pytest.mark.parametrize("changes,words", [
    ({"use_trelis": True}, "unknown configuration keys ['use_trelis']"),
    ({"passes": 8}, "unknown configuration keys ['passes']"),
    ({"target": {"mode": "size", "value": 9000, "pass": 8}},
     "unknown target keys ['pass']"),
    ({"target": {"mode": "bytes", "value": 9000}}, "target.mode"),
    ({"target": {"value": 9000}}, "target.mode"),
    ({"target": {"mode": "size"}}, "target.value"),
    ({"target": {"mode": "size", "value": 0}}, "target.value"),
    ({"target": {"mode": "psnr", "value": 38, "passes": 1}},
     "target.passes"),
    ({"target": {"mode": "psnr", "value": 38, "passes": 21}},
     "target.passes"),
    ({"target": 9000}, "target is an object"),
    ({"yuv_mode": "422"}, "yuv_mode"),
    ({"use_trellis": True, "huffman_compress": False}, "use_trellis"),
])
def test_a_key_not_understood_is_a_failure(changes, words):
    cfg = _config("sjpeg-default-q75", **changes)
    for read in (harness.port_param, harness.reference_settings):
        with pytest.raises(harness.Failure, match=words.replace(
                "[", r"\[").replace("]", r"\]")):
            read(cfg)


def test_a_missing_setting_is_a_failure():
    cfg = _config("sjpeg-default-q75")
    del cfg["quantization_bias"]
    for read in (harness.port_param, harness.reference_settings):
        with pytest.raises(harness.Failure, match="quantization_bias"):
            read(cfg)


# --- the reference against the port's CPU path --------------------------------

def test_trellis_equals_the_ports_plain_trellis():
    """The reference's trellis against the port's plain PyTorch one on
    seeded blocks (noise and smooth ramps) at four qualities, over the K.3
    rate model and one a search pass could leave."""
    from sjpeg_tpu_torch.ops import trellis as port_trellis
    rng = np.random.default_rng(5)
    blocks = np.concatenate([
        rng.integers(-128, 128, (300, 64)),
        np.cumsum(rng.normal(0, 12, (700, 64)), axis=1).clip(-128, 127)
        .astype(np.int64)])
    coeffs = spec.fdct_blocks(blocks)
    k3 = trellis.k3_ac_lens()
    moved = k3.copy()
    moved[:, 1:] = np.where(k3[:, 1:] > 0, np.clip(
        k3[:, 1:] + rng.integers(-3, 4, k3[:, 1:].shape), 1, 16), 0)
    ones = np.ones(64, dtype=np.uint8)
    changed = 0
    for quality in (5, 30, 75, 95):
        base = encoder.quant_matrices(quality)
        qms = [spec.finalize_quant_matrix(base[g], ones, 120)
               for g in range(2)]
        rows = [torch.from_numpy(np.stack([q[k] for q in qms])
                                 .astype(np.int32))
                for k in ("iquant", "bias", "quant")]
        for lens in (k3, moved):
            for g in range(2):
                want = trellis.trellis_blocks(coeffs, qms[g], lens[g])
                got = port_trellis.trellis_quantize_plain(
                    torch.from_numpy(coeffs.astype(np.int32)), *rows,
                    torch.full((len(coeffs),), g, dtype=torch.int32),
                    torch.from_numpy(lens.astype(np.int32)))
                assert np.array_equal(want, got.numpy()), (quality, g)
                changed += int((want != spec.quantize_blocks(
                    coeffs, qms[g])).any(axis=1).sum())
    assert changed > 0.2 * 16 * len(coeffs)


def test_method7_equals_the_port_in_each_auto_pick(classes_416):
    from sjpeg_tpu_torch import engine
    cfg = _config("sjpeg-default-q75", use_trellis=True)
    imgs, _ = classes_416
    enc = encoder.encode_images(imgs, harness.reference_settings(cfg))
    assert sorted(e.mode for e in enc) == ["400", "420", "444", "sharp"]
    assert engine.encode_batch(imgs, harness.port_param(cfg),
                               device="cpu") == [e.jpeg for e in enc]


def _routes(monkeypatch):
    """Record which of the batched search's routes run, and fail on the
    per-image fallback, which would leave the route unchecked."""
    from sjpeg_tpu_torch import engine_search
    ran = []
    for route in ("size_device", "psnr_device", "pass_by_pass"):
        method = getattr(engine_search._Search, route)

        def spy(self, *a, _m=method, _r=route, **kw):
            ran.append(_r)
            return _m(self, *a, **kw)
        monkeypatch.setattr(engine_search._Search, route, spy)

    def no_fallback(*a, **kw):
        raise AssertionError("an image fell back to the search alone")
    monkeypatch.setattr(engine_search, "search_alone", no_fallback)
    return ran


SEARCHES = {
    # route 1: size, the loop on the device (2-8 passes, no trellis)
    "size-8": ({"target": {"mode": "size", "value": SIZE_416, "passes": 8}},
               "size_device", "classes_416"),
    # route 3: pass by pass (sjpeg's default of 10 passes)
    "size-10": ({"target": {"mode": "size", "value": SIZE_416}},
                "pass_by_pass", "classes_416"),
    # route 2: PSNR, the loop on the device
    "psnr-6": ({"target": {"mode": "psnr", "value": 36.0, "passes": 6}},
               "psnr_device", "classes_416"),
    # route 3: the trellis's size search, its rate model evolving
    "m7-size-6": ({"use_trellis": True,
                   "target": {"mode": "size", "value": SIZE_192,
                              "passes": 6}}, "pass_by_pass", "pair_192"),
    # route 3's PSNR: the passes measure the bias quantizer, the final
    # pass runs the trellis
    "m7-psnr-5": ({"use_trellis": True,
                   "target": {"mode": "psnr", "value": 34.0, "passes": 5}},
                  "pass_by_pass", "pair_192"),
    # method 0's size search: K.3 tables in the header model
    "m0-size-8": ({"huffman_compress": False, "adaptive_quantization": False,
                   "yuv_mode": "420",
                   "target": {"mode": "size", "value": 15000, "passes": 8}},
                  "size_device", "classes_416"),
}


@pytest.mark.parametrize("case", sorted(SEARCHES))
def test_search_equals_the_port_batched(case, request, monkeypatch):
    from sjpeg_tpu_torch import engine
    changes, route, images = SEARCHES[case]
    imgs, _ = request.getfixturevalue(images)
    cfg = _config("sjpeg-default-q75", **changes)
    want = [e.jpeg for e in encoder.encode_images(
        imgs, harness.reference_settings(cfg))]
    ran = _routes(monkeypatch)
    got = engine.encode_batch(imgs, harness.port_param(cfg), device="cpu")
    assert ran and set(ran) == {route}
    assert got == want
    # the search moved the bytes: one pass at q75 writes others
    once = [e.jpeg for e in encoder.encode_images(
        imgs, dataclasses.replace(harness.reference_settings(cfg),
                                  passes=1))]
    assert all(w != o for w, o in zip(want, once))


@pytest.mark.parametrize("case", ["size-10", "psnr-6", "m7-size-6"])
def test_search_equals_the_port_single_image(case, pair_192):
    """encode_rgb's search, one pass at a time (the photo entry's path)."""
    from sjpeg_tpu_torch import engine
    changes = SEARCHES[case][0]
    if changes["target"]["mode"] == "size":
        changes = dict(changes, target=dict(changes["target"],
                                            value=SIZE_192))
    cfg = _config("sjpeg-default-q75", **changes)
    imgs, _ = pair_192
    want = encoder.encode_images(imgs[:1],
                                 harness.reference_settings(cfg))[0].jpeg
    assert engine.encode_rgb(imgs[0], harness.port_param(cfg),
                             device="cpu") == want


# --- controls -----------------------------------------------------------------

def _checks(pool, settings, control):
    expected, _ = harness.reference_jpegs(pool, settings, threads=2)
    got, _ = harness.reference_jpegs(pool, control, threads=2)
    return harness.compare({i: (i, got[i]) for i in got}, expected)


@pytest.mark.parametrize("control", ["trellis off", "one pass"])
def test_skipping_the_trellis_or_the_search_comes_out_wrong(control,
                                                            pair_192):
    imgs, _ = pair_192
    if control == "trellis off":
        cfg = _config("sjpeg-default-q75", use_trellis=True)
        off = {"use_trellis": False}
    else:
        cfg = _config("sjpeg-default-q75", target={
            "mode": "size", "value": SIZE_192, "passes": 8})
        off = {"passes": 1}
    settings = harness.reference_settings(cfg)
    checks, failed = _checks([imgs[:1], imgs[1:]], settings,
                             dataclasses.replace(settings, **off))
    assert checks["wrong_jpegs"]["value"] == 2 and failed == 2
    assert checks["wrong_jpegs"]["value"] > checks["wrong_jpegs"]["limit"]


@pytest.mark.parametrize("changes", [
    {"use_trellis": True},
    {"target": {"mode": "size", "value": SIZE_192, "passes": 8}},
], ids=["trellis", "size-search"])
def test_float_fdct_control_comes_out_wrong_on_new_settings(changes,
                                                            pair_192):
    """control.py's control, a float32 DCT in place of sjpeg's integer
    fDCT, on a method-7 and on a size-search configuration."""
    imgs, _ = pair_192
    settings = harness.reference_settings(
        _config("sjpeg-default-q75", **changes))
    pool = [imgs[:1], imgs[1:]]
    expected, _ = harness.reference_jpegs(pool, settings, threads=2)
    control, _ = harness.reference_jpegs(pool, settings, threads=2,
                                         fdct=spec.fdct_blocks_float32)
    checks, failed = harness.compare({i: (i, control[i]) for i in control},
                                     expected)
    assert checks["wrong_jpegs"]["value"] == 2 and failed == 2


# --- a cell from data files alone ---------------------------------------------

@pytest.mark.parametrize("changes", [
    {"use_trellis": True},
    {"target": {"mode": "size", "value": 1500, "passes": 8}},
], ids=["m7", "size-search"])
def test_a_new_configuration_is_a_data_file(changes, tmp_path):
    """A scratch BENCHMARK.json and configuration file, outside the
    folder, run through load_cell and run_cell with the folder's traffic,
    entries and generator as they are: correct, every check 0."""
    from benchmark.tests.test_bench_harness import run_tiny
    (tmp_path / "configs").mkdir()
    cfg = dict(_config("sjpeg-default-q75"), name="scratch", **changes)
    (tmp_path / "configs" / "scratch.json").write_text(json.dumps(cfg))
    spec_path = tmp_path / "BENCHMARK.json"
    spec_path.write_text(json.dumps(dict(
        json.loads((ROOT / "BENCHMARK.json").read_text()),
        configs=[{"name": "scratch", "source": "https://example.org",
                  "file": "configs/scratch.json", "reduced": [],
                  "why": "scratch"}],
        workloads=[{"name": "scratch.batch16x1024", "config": "scratch",
                    "traffic": "batch16x1024", "chips": 1,
                    "why": "scratch"}])))
    out = run_tiny("scratch.batch16x1024", spec_path=spec_path)
    assert out["correct"] is True
    assert all(c["value"] == 0 for c in out["checks"].values())
    assert out["metrics"]["mpx_per_s"]["value"] > 0
