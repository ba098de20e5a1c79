"""The port's encode inspector (sjpeg_tpu_torch.inspect_tool) against
sjpeg_tpu.inspect_tool on the CPU: the error and risk maps (float32 risk
values bit for bit, the batched map also against block_riskiness's loop),
the quality sweep, inspect's report and PNGs, the interactive loop's
transcript, and main.  The one intended difference is the `l` key, which
here applies the quantization limit (sjpeg_tpu's toggles a flag it never
reads).  Geometries: 32 x 40 as the JAX CLI tests use, and 37 x 53 for
sizes that are not multiples of 8."""

import io
import json

import numpy as np
import pytest
import torch
from PIL import Image

from sjpeg_tpu import host_encoder as jhost
from sjpeg_tpu import inspect_tool as jinspect
from sjpeg_tpu import riskiness as jrisk
from sjpeg_tpu.params import EncoderParam as JaxParam

from sjpeg_tpu_torch import constants as C
from sjpeg_tpu_torch import inspect_tool, riskiness
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

KEYS = ["+", "++", "-", "1", "3", "o", "a", "t", "t", "e", "r", "m", "i",
        "w", "h", "zz", "q"]


def _noise(h: int, w: int, seed: int) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(
        np.uint8)


def _smooth(h: int, w: int, seed: int) -> np.ndarray:
    """Gradients and chroma waves under mild noise: block risks spread
    over 0..100 instead of saturating."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(xx / 3.0 + seed),
                     128 + 100 * np.cos(yy / 4.0),
                     xx * 255 // w], -1)
    return np.clip(base + rng.randint(-5, 6, (h, w, 3)), 0, 255).astype(
        np.uint8)


NOISE = _noise(32, 40, 3)         # the JAX CLI tests' image
SMOOTH = _smooth(32, 40, 4)
ODD = _smooth(37, 53, 5)          # not multiples of 8: floor, as JAX


def _bits(a: np.ndarray) -> np.ndarray:
    assert a.dtype == np.float32
    return a.view(np.int32)


@pytest.mark.parametrize("name", ["noise", "smooth", "odd", "tiny"])
def test_risk_map_matches_jax_and_block_loop(name):
    rgb = {"noise": NOISE, "smooth": SMOOTH, "odd": ODD,
           "tiny": ODD[:7, :20]}[name]
    got = inspect_tool.risk_map(rgb, device="cpu")
    want = jinspect.risk_map(rgb)
    assert got.shape == (rgb.shape[0] // 8, rgb.shape[1] // 8)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    loop = np.array([[riskiness.block_riskiness(
        rgb[8 * j:8 * j + 8, 8 * i:8 * i + 8])[0]
        for i in range(got.shape[1])] for j in range(got.shape[0])],
        np.float32).reshape(got.shape)
    np.testing.assert_array_equal(_bits(got), _bits(loop))
    if name in ("smooth", "odd"):
        assert len(np.unique(got)) > 5          # not one saturated value


def test_risk_map_with_the_exact_table():
    """With the reference's exact sharpness table active in both
    packages."""
    riskiness.use_exact_table(True)
    jrisk.use_exact_table(True)
    try:
        got = inspect_tool.risk_map(ODD, device="cpu")
        want = jinspect.risk_map(ODD)
    finally:
        riskiness.use_exact_table(False)
        jrisk.use_exact_table(False)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("rgb,quality,mode", [
    (NOISE, 75, C.YUV_420), (ODD, 40, C.YUV_444), (ODD, 90, C.YUV_400)])
def test_error_map_matches_jax(rgb, quality, mode):
    got = inspect_tool.error_map(rgb, quality, mode, device="cpu")
    want = jinspect.error_map(rgb, quality, mode)
    assert got.dtype == want.dtype and got.shape == rgb.shape[:2]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("qualities", [None, (5, 33, 97)])
def test_quality_sweep_matches_jax(qualities):
    kw = {} if qualities is None else {"qualities": qualities}
    got = inspect_tool.quality_sweep(NOISE, device="cpu", **kw)
    want = jinspect.quality_sweep(NOISE, **kw)
    assert got == want
    assert len(got) == (18 if qualities is None else 3)


def _png(tmp_path, rgb, name="in.png"):
    path = tmp_path / name
    Image.fromarray(rgb).save(path)
    return path


def test_inspect_report_and_pngs_match_jax(tmp_path):
    src = _png(tmp_path, SMOOTH)
    got = inspect_tool.inspect(str(src), str(tmp_path / "port"), 60,
                               device="cpu")
    want = jinspect.inspect(str(src), str(tmp_path / "jax"), 60)
    assert got == want and "max_error_at_q60" in got
    for name in ("error_map.png", "risk_map.png", "report.json"):
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name


def _transcript(module, src, out_dir, keys, **kw):
    out = io.StringIO()
    report = module.interactive(str(src), str(out_dir), quality=70,
                                stdin=io.StringIO("\n".join(keys) + "\n"),
                                stdout=out, **kw)
    return report, out.getvalue().splitlines()


def test_interactive_transcript_matches_jax(tmp_path):
    """The JAX CLI test's key script: the same lines, the same files."""
    src = _png(tmp_path, NOISE)
    want_report, want = _transcript(jinspect, src, tmp_path / "rep", KEYS)
    want_files = {p.name: p.read_bytes()
                  for p in (tmp_path / "rep").iterdir()}
    got_report, got = _transcript(inspect_tool, src, tmp_path / "rep", KEYS,
                                  device="cpu")
    assert got == want and len(got) > 40
    assert got_report == want_report and got_report["quality"] == 80.0
    for name, data in want_files.items():
        assert (tmp_path / "rep" / name).read_bytes() == data, name


def _limited(quality: float) -> JaxParam:
    p = JaxParam(quality=quality)
    p.set_quantization(p.resolved_quant_matrices())
    p.set_limit_quantization(True)
    return p


def test_limit_key_applies_the_limit(tmp_path):
    """`l` re-encodes under the limit and keeps it through `+`, until `l`
    again: each written out.jpg is sjpeg_tpu.host_encoder's encode under
    the limited param of its quality (and differs from the unlimited
    one)."""
    src = _png(tmp_path, SMOOTH)
    outs = []

    class Keys(io.StringIO):
        def __iter__(self):
            for key in ("l", "w", "+", "w", "l", "w"):
                yield key + "\n"
                if key == "w":
                    outs.append((tmp_path / "rep" / "out.jpg").read_bytes())

    out = io.StringIO()
    inspect_tool.interactive(str(src), str(tmp_path / "rep"), quality=70,
                             stdin=Keys(), stdout=out, device="cpu")
    lines = out.getvalue().splitlines()
    assert "limit quantization: True" in lines
    assert "limit quantization: False" in lines
    encodes = [ln for ln in lines if ln.startswith("q=")]
    assert [ln.split(" -> ")[0][-7:] for ln in encodes] == [
        "limit=0", "limit=1", "limit=1", "limit=0"]
    assert outs[0] == jhost.encode_rgb(SMOOTH, _limited(70.0))
    assert outs[1] == jhost.encode_rgb(SMOOTH, _limited(71.0))
    assert outs[2] == jhost.encode_rgb(SMOOTH, JaxParam(quality=71.0))
    assert outs[1] != outs[2]


def test_session_param_limit():
    p = inspect_tool.session_param(quality=50, limit=True)
    np.testing.assert_array_equal(p.min_quant_matrices, p.quant_matrices)
    np.testing.assert_array_equal(
        p.quant_matrices, inspect_tool.session_param(
            quality=50).resolved_quant_matrices())
    assert inspect_tool.session_param(quality=50).min_quant_matrices is None


@pytest.mark.parametrize("kind", ["png", "ppm"])
def test_main_matches_jax(tmp_path, capsys, kind):
    if kind == "png":
        src = _png(tmp_path, ODD)
    else:
        src = tmp_path / "in.ppm"
        h, w = ODD.shape[:2]
        src.write_bytes(f"P6\n{w} {h}\n255\n".encode() + ODD.tobytes())
    argv = [str(src), "-o", str(tmp_path / "out"), "-q", "55"]
    assert jinspect.main(argv) == 0
    want = capsys.readouterr().out
    want_files = {p.name: p.read_bytes()
                  for p in (tmp_path / "out").iterdir()}
    assert inspect_tool.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want and json.loads(got)["input"] == str(src)
    for name, data in want_files.items():
        assert (tmp_path / "out" / name).read_bytes() == data, name


def test_main_without_arguments():
    assert inspect_tool.main([]) == 1


def test_default_device_needs_cuda(monkeypatch, tmp_path):
    """No fallback: with no CUDA, every entry point that is not given
    device='cpu' raises, and says how to run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = _png(tmp_path, NOISE)
    calls = [lambda: inspect_tool.risk_map(NOISE),
             lambda: inspect_tool.error_map(NOISE),
             lambda: inspect_tool.quality_sweep(NOISE, (50,)),
             lambda: inspect_tool.inspect(str(src), str(tmp_path / "o")),
             lambda: inspect_tool.interactive(
                 str(src), str(tmp_path / "o"), stdin=io.StringIO("q\n"),
                 stdout=io.StringIO()),
             lambda: inspect_tool.main([str(src), "-o",
                                        str(tmp_path / "o")])]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert not (tmp_path / "o").exists()
