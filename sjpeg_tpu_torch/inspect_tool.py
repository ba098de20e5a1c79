"""Static encode inspector of the PyTorch port (sjpeg's vjpeg viewer,
without a display).

sjpeg_tpu.inspect_tool's views, computed by the port: every encode runs
the port's engine (`engine.encode_rgb`), so on the card it reaches the
CUDA kernels of the chosen settings: risk_stats and sharp_yuv under AUTO,
fdct, vlc_pack and stream_concat for method 4 (a single image's optimal
tables are built on the host), trellis for method 7, sample_pack (from
RGB) or quant_pack (from planes) for methods 0 and 3.

- `error_map`: per-pixel absolute reconstruction error of an encode
- `risk_map`: per-8x8-block riskiness scores (BlockRiskinessScore analog),
  every block in one batched tensor pass on the device
- `quality_sweep`: (size, PSNR) curve across qualities
- `inspect`: write all of the above next to the output file
- `interactive`: the viewer's key loop over stdin

Every entry point takes `device`: None means "cuda" and raises when CUDA
is missing; device="cpu" runs the kernels' plain versions.  Decoding (the
PSNR and the error map) and PNG output need PIL, imported where it is
used; PPM input is read without it.

CLI: python -m sjpeg_tpu_torch.inspect_tool input.png -o report_dir/
     [-q quality] [--interactive] [--device cpu]
"""

import io
import json
import pathlib
import sys

import numpy as np
import torch

from . import constants as C
from . import engine
from .cli import _read_ppm
from .ops import colorspace
from .params import EncoderParam
from .riskiness import KRGB, KRGB3, NOISE_LEVEL, sharpness_table


def _decode(jpeg: bytes) -> np.ndarray:
    from PIL import Image
    return np.asarray(Image.open(io.BytesIO(jpeg)).convert("RGB"))


def _read_rgb(path) -> np.ndarray:
    """[H, W, 3] uint8 of an image file: binary PPM without PIL, anything
    else through PIL."""
    data = pathlib.Path(path).read_bytes()
    if data[:2] == b"P6":
        return _read_ppm(data)
    from PIL import Image
    return np.array(Image.open(io.BytesIO(data)).convert("RGB"))


def _save_png(array: np.ndarray, path) -> None:
    from PIL import Image
    Image.fromarray(array).save(path)


def _psnr(jpeg: bytes, rgb: np.ndarray) -> float:
    dec = _decode(jpeg)
    mse = np.mean((dec.astype(np.float64) - rgb) ** 2)
    return 10 * np.log10(255 ** 2 / mse) if mse > 0 else 99.0


def error_map(rgb: np.ndarray, quality: float = 75,
              yuv_mode: int = C.YUV_420, device=None) -> np.ndarray:
    """Per-pixel max-channel absolute error of an encode at `quality`."""
    jpeg = engine.encode_rgb(
        rgb, EncoderParam(quality=quality, yuv_mode=yuv_mode), device)
    dec = _decode(jpeg)
    return np.abs(dec.astype(np.int16) - rgb.astype(np.int16)).max(axis=-1)


def risk_map(rgb: np.ndarray, device=None) -> np.ndarray:
    """[H // 8, W // 8] float32 per-block riskiness (0..100): each whole
    8x8 block scored as riskiness.block_riskiness scores it (neighbour
    pairs reflected at the block's own edges, pair scores from
    sharpness_table(), scores at or under the noise level dropped, the
    float64 mean of the rest clamped at 25 points and scaled to 100),
    every block at once on `device`."""
    dev = engine.resolve_device(device)
    h, w = rgb.shape[:2]
    mh, mw = h // 8, w // 8
    if not (mh and mw):
        return np.zeros((mh, mw), np.float32)
    t = engine._to_device(np.asarray(rgb)[:8 * mh, :8 * mw], dev)
    blocks = t.reshape(mh, 8, mw, 8, 3).transpose(1, 2)   # [mh, mw, 8, 8, 3]

    def level(x):
        x = torch.clamp(x + 128, 0, 255)
        return (x * (0x0101 * (KRGB - 1))) >> 16

    y, u, v = colorspace.rgb_to_yuv444_planes(blocks)
    idx = (level(y) + level(u) * KRGB + level(v) * KRGB * KRGB).long()
    # each position's right and lower neighbour, reflected at the edge
    right = torch.cat([idx[..., 1:], idx[..., 6:7]], dim=-1)
    down = torch.cat([idx[..., 1:, :], idx[..., 6:7, :]], dim=-2)
    table = torch.from_numpy(sharpness_table().astype(np.int64)).to(dev)
    score = (table[idx + KRGB3 * right] + table[idx + KRGB3 * down]
             + table[right + KRGB3 * down])
    keep = score > NOISE_LEVEL
    count = keep.sum(dim=(-1, -2))
    total = torch.where(keep, score, 0).sum(dim=(-1, -2))
    mean = torch.where(count > 0, total.double() / count.clamp(min=1).double(),
                       0.0)
    risk = torch.where(mean > 25.0, 100.0, mean * 100.0 / 25.0)
    return risk.to(torch.float32).cpu().numpy()


def sweep_jpegs(rgb: np.ndarray, qualities, make_param, device=None) -> list:
    """The encodes behind a quality sweep: one JPEG a quality, each with
    `make_param(quality)`."""
    return [engine.encode_rgb(rgb, make_param(float(q)), device)
            for q in qualities]


def quality_sweep(rgb: np.ndarray, qualities=range(10, 96, 5),
                  yuv_mode: int = C.YUV_420, device=None):
    """[(quality, bytes, psnr_db)] across the quality range."""
    engine.resolve_device(device)
    qualities = list(qualities)
    jpegs = sweep_jpegs(rgb, qualities, lambda q: EncoderParam(
        quality=q, yuv_mode=yuv_mode), device)
    return [(int(q), len(jpeg), round(_psnr(jpeg, rgb), 2))
            for q, jpeg in zip(qualities, jpegs)]


def inspect(input_path: str, out_dir: str, quality: float = 75,
            device=None) -> dict:
    engine.resolve_device(device)
    rgb = _read_rgb(input_path)
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)

    emap = error_map(rgb, quality, device=device)
    _save_png((np.clip(emap * 4, 0, 255)).astype(np.uint8),
              out / "error_map.png")
    rmap = risk_map(rgb, device)
    _save_png((rmap * 2.55).astype(np.uint8), out / "risk_map.png")
    sweep = quality_sweep(rgb, device=device)
    report = {
        "input": str(input_path),
        "max_error_at_q%d" % int(quality): int(emap.max()),
        "mean_block_risk": round(float(rmap.mean()), 2),
        "quality_sweep": sweep,
    }
    (out / "report.json").write_text(json.dumps(report, indent=2))
    return report


_INTERACTIVE_HELP = """\
interactive inspector (vjpeg HandleKey analog, examples/vjpeg.cc:452-522):
  + / -      quality up / down (shift by 1, 10 with ++/--)
  0..4       yuv_mode (0 auto, 1 420, 2 sharp, 3 444, 4 gray)
  o a b l t  toggle size-optimize / adaptive-quant / adaptive-bias /
             quant-limit / trellis
  e          write error map for current settings -> error_map.png
  r          write riskiness map -> risk_map.png
  m          print current quantization matrices
  i          print info (riskiness, estimated quality)
  w          write the current encode -> out.jpg
  h          this help
  q          quit
Every change re-encodes and prints (size, PSNR)."""


def session_param(quality: float = 75, yuv_mode: int = C.YUV_AUTO,
                  huffman_compress: bool = True,
                  adaptive_quantization: bool = True,
                  adaptive_bias: bool = False, use_trellis: bool = False,
                  limit: bool = False) -> EncoderParam:
    """The interactive loop's EncoderParam for its settings.  With `limit`
    (the `l` key) the matrices of `quality` become explicit and the floor
    of their own quantization: sjpeg's SetLimitQuantization, which no
    adaptive step may quantize finer than."""
    p = EncoderParam(quality=quality, yuv_mode=yuv_mode,
                     huffman_compress=huffman_compress,
                     adaptive_quantization=adaptive_quantization,
                     adaptive_bias=adaptive_bias, use_trellis=use_trellis)
    if limit:
        p.set_quantization(p.resolved_quant_matrices())
        p.set_limit_quantization(True)
    return p


def interactive(input_path: str, out_dir: str, quality: float = 75,
                stdin=None, stdout=None, device=None):
    """Terminal re-encode loop: the vjpeg viewer's keyboard protocol
    over stdin, with views written to files (the decode-and-display half
    is the caller's terminal image viewer of choice).  Reads one command
    per line; returns the final report dict.  The `l` key toggles the
    quantization limit and re-encodes with it; it stays on through later
    keys until `l` again."""
    engine.resolve_device(device)
    stdin = stdin if stdin is not None else sys.stdin
    stdout = stdout if stdout is not None else sys.stdout
    rgb = _read_rgb(input_path)
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    state = dict(quality=float(quality), yuv_mode=C.YUV_AUTO,
                 huffman_compress=True, adaptive_quantization=True,
                 adaptive_bias=False, use_trellis=False, limit=False)
    last = {}

    def param():
        return session_param(**state)

    def reencode():
        jpeg = engine.encode_rgb(rgb, param(), device)
        psnr = _psnr(jpeg, rgb)
        last.update(jpeg=jpeg, psnr=psnr)
        print(f"q={state['quality']:.1f} mode={state['yuv_mode']} "
              f"optim={int(state['huffman_compress'])}"
              f" adapt={int(state['adaptive_quantization'])}"
              f" bias={int(state['adaptive_bias'])}"
              f" trellis={int(state['use_trellis'])}"
              f" limit={int(state['limit'])}"
              f" -> {len(jpeg)} bytes, {psnr:.2f} dB", file=stdout)

    toggles = {"o": "huffman_compress", "a": "adaptive_quantization",
               "b": "adaptive_bias", "t": "use_trellis"}
    print(_INTERACTIVE_HELP, file=stdout)
    reencode()
    for line in stdin:
        cmd = line.strip()
        if not cmd:
            continue
        if cmd == "q":
            break
        elif cmd in ("+", "-", "++", "--"):
            step = 10.0 if len(cmd) == 2 else 1.0
            delta = step if cmd[0] == "+" else -step
            state["quality"] = float(np.clip(state["quality"] + delta,
                                             0, 100))
            reencode()
        elif cmd in ("0", "1", "2", "3", "4"):
            state["yuv_mode"] = int(cmd)
            reencode()
        elif cmd in toggles:
            state[toggles[cmd]] = not state[toggles[cmd]]
            reencode()
        elif cmd == "l":
            state["limit"] = not state["limit"]
            print(f"limit quantization: {state['limit']}", file=stdout)
            reencode()
        elif cmd == "e":
            emap = error_map(rgb, state["quality"],
                             state["yuv_mode"]
                             if state["yuv_mode"] not in
                             (C.YUV_AUTO, C.YUV_SHARP) else C.YUV_420,
                             device)
            _save_png(np.clip(emap * 4, 0, 255).astype(np.uint8),
                      out / "error_map.png")
            print(f"error map (max {int(emap.max())}) -> "
                  f"{out / 'error_map.png'}", file=stdout)
        elif cmd == "r":
            rmap = risk_map(rgb, device)
            _save_png((rmap * 2.55).astype(np.uint8), out / "risk_map.png")
            print(f"risk map (mean {rmap.mean():.1f}) -> "
                  f"{out / 'risk_map.png'}", file=stdout)
        elif cmd == "m":
            qm = param().resolved_quant_matrices()
            for g, name in enumerate(("luma", "chroma")):
                print(f"{name}:", file=stdout)
                for r in range(8):
                    print(" ".join(f"{v:3d}" for v in
                                   qm[g][8 * r: 8 * r + 8]), file=stdout)
        elif cmd == "i":
            from .riskiness import riskiness
            from .tools import estimate_quality
            mode, score = riskiness(rgb)
            print(f"riskiness {score:.1f} -> mode {mode}; estimated "
                  f"quality of current matrices "
                  f"{estimate_quality(param().resolved_quant_matrices()[0]):.0f}",
                  file=stdout)
        elif cmd == "w":
            (out / "out.jpg").write_bytes(last["jpeg"])
            print(f"wrote {out / 'out.jpg'} "
                  f"({len(last['jpeg'])} bytes)", file=stdout)
        elif cmd == "h":
            print(_INTERACTIVE_HELP, file=stdout)
        else:
            print(f"? (h for help): {cmd!r}", file=stdout)
    return {"quality": state["quality"], "bytes": len(last["jpeg"]),
            "psnr": round(float(last["psnr"]), 2)}


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print("usage: python -m sjpeg_tpu_torch.inspect_tool input -o outdir "
              "[-q quality] [--interactive] [--device cuda|cpu]",
              file=sys.stderr)
        return 1
    inp = argv[0]
    outdir = "inspect_out"
    quality = 75.0
    inter = False
    device = None
    i = 1
    while i < len(argv):
        if argv[i] == "-o":
            outdir = argv[i + 1]
            i += 2
        elif argv[i] == "-q":
            quality = float(argv[i + 1])
            i += 2
        elif argv[i] == "--interactive":
            inter = True
            i += 1
        elif argv[i] == "--device":
            device = argv[i + 1]
            i += 2
        else:
            i += 1
    if inter:
        report = interactive(inp, outdir, quality, device=device)
    else:
        report = inspect(inp, outdir, quality, device=device)
    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
