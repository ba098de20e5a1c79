"""The port's command-line tool (`python -m sjpeg_tpu_torch.cli`, run here
with --device cpu) against sjpeg_tpu.cli: the same output bytes and the
same standard output, but for the `elapsed:` line, on one tiny PPM through
each flag family, and on a JPEG the port wrote (quality estimate, info,
recompression).  The JAX side runs its host backend, the NumPy oracle, and
its device backend for two flag sets."""

import sys

import numpy as np
import pytest

from sjpeg_tpu import cli as jcli

from sjpeg_tpu_torch import cli


def _write_ppm(path, rgb):
    path.write_bytes(f"P6\n{rgb.shape[1]} {rgb.shape[0]}\n255\n".encode()
                     + np.ascontiguousarray(rgb).tobytes())


@pytest.fixture(scope="module")
def ppm(tmp_path_factory):
    """A 40 x 24 gradient with noise and saturated corners."""
    rng = np.random.RandomState(91)
    yy, xx = np.mgrid[0:24, 0:40]
    rgb = np.stack([xx * 6, yy * 10, (xx + yy) * 4 % 256], -1)
    rgb = np.clip(rgb + rng.randint(-40, 40, rgb.shape), 0, 255)
    rgb[:8, :8] = [0, 0, 255]
    rgb[-8:, -8:] = [255, 0, 0]
    p = tmp_path_factory.mktemp("cli") / "in.ppm"
    _write_ppm(p, rgb.astype(np.uint8))
    return p


def _text(out: str) -> list:
    return [ln for ln in out.splitlines() if not ln.startswith("elapsed:")]


def _both(capsys, src, out, flags, backend="host"):
    """Run sjpeg_tpu.cli, then the port's CLI, writing the same output
    path; -> ((bytes, stdout lines) of each)."""
    runs = []
    for main, extra in ((jcli.main, ["--backend", backend]),
                        (cli.main, ["--device", "cpu"])):
        if out.exists():
            out.unlink()
        argv = [str(src), "-o", str(out), *flags, *extra]
        assert main(argv) == 0
        data = out.read_bytes() if out.exists() else None
        runs.append((data, _text(capsys.readouterr().out)))
    return runs


FLAGS = {
    "default": [],
    "q": ["-q", "60"],
    "420": ["-420"],
    "444": ["-444"],
    "gray": ["-gray"],
    "sharp": ["-sharp", "-q", "85"],
    "no_optim_no_adapt": ["-no_optim", "-no_adapt"],
    "trellis": ["-trellis"],
    "size_pass": ["-size", "700", "-pass", "4"],
    "psnr": ["-psnr", "34"],
    "info": ["-i"],
    "crc": ["-crc"],
    "md5": ["-md5", "-420"],
    "short": ["-short", "-q", "40"],
}


@pytest.mark.parametrize("name", list(FLAGS))
def test_cli_matches_jax_host(ppm, tmp_path, capsys, name):
    (want, want_out), (got, got_out) = _both(capsys, ppm,
                                             tmp_path / "out.jpg",
                                             FLAGS[name])
    assert got == want and got_out == want_out
    if name not in ("info", "crc", "md5"):
        assert got[:2] == b"\xff\xd8"


@pytest.mark.parametrize("name", ["default", "sharp"])
def test_cli_matches_jax_device(ppm, tmp_path, capsys, name):
    (want, want_out), (got, got_out) = _both(
        capsys, ppm, tmp_path / "out.jpg", FLAGS[name], backend="tpu")
    assert got == want and got_out == want_out


@pytest.mark.parametrize("flags", [["-estimate"], ["-i"], ["-r", "80"],
                                   ["-r", "70", "-no_limit", "-sharp"]])
def test_cli_on_a_port_jpeg_matches_jax(ppm, tmp_path, capsys, flags):
    """Recompression input: a JPEG that the port's CLI wrote."""
    jpeg = tmp_path / "src.jpg"
    assert cli.main([str(ppm), "-o", str(jpeg), "-q", "60", "-quiet",
                     "--device", "cpu"]) == 0
    capsys.readouterr()
    (want, want_out), (got, got_out) = _both(capsys, jpeg,
                                             tmp_path / "out.jpg", flags)
    assert got == want and got_out == want_out and got_out


def test_cli_reads_ppm_without_pil(ppm, tmp_path, capsys, monkeypatch):
    """PPM input never imports PIL, which the card's machine lacks."""
    out = tmp_path / "out.jpg"
    assert jcli.main([str(ppm), "-o", str(out), "-quiet"]) == 0
    want = out.read_bytes()
    monkeypatch.setitem(sys.modules, "PIL", None)      # import PIL fails
    assert cli.main([str(ppm), "-o", str(out), "-quiet",
                     "--device", "cpu"]) == 0
    assert out.read_bytes() == want
    with pytest.raises(ImportError):
        cli.read_image(want, None)


def test_cli_version_matches_jax(capsys):
    assert jcli.main(["x", "-version"]) == 0
    want = capsys.readouterr().out
    assert cli.main(["x", "-version"]) == 0
    assert capsys.readouterr().out == want
