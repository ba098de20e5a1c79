"""sjpeg-compatible command-line interface of the PyTorch port.

    python -m sjpeg_tpu_torch.cli input.ppm -o out.jpg [flags] [--device cpu]

Compress or recompress PNG/JPEG/PPM images to baseline JPEG with the same
flag surface and recompression recipe as the reference `sjpeg` tool
(examples/sjpeg.cc): quality / reduction factors, target-size/PSNR search,
YUV-mode control, metadata injection, quality estimation, info and
checksum outputs.  A copy of sjpeg_tpu.cli whose encode always runs the
port's engine (`engine.encode_rgb`): on the GPU by default, or with
`--device cpu` through the kernels' plain versions.  PPM input needs no
PIL; PNG and JPEG input import it when they are read.
"""

import argparse
import hashlib
import sys
import zlib

import numpy as np

from . import constants as C
from . import tools
from .engine import encode_rgb
from .params import EncoderParam, TARGET_NONE
from .riskiness import riskiness as compute_riskiness

YUV_MODE_NAMES = {
    C.YUV_AUTO: "Auto", C.YUV_420: "YUV420", C.YUV_SHARP: "SharpYUV420",
    C.YUV_444: "YUV444", C.YUV_400: "YUV400",
}


def _read_ppm(data: bytes):
    assert data[:2] == b"P6"
    fields = []
    pos = 2
    while len(fields) < 3:
        while pos < len(data) and data[pos] in b" \t\r\n":
            pos += 1
        if data[pos:pos + 1] == b"#":
            while data[pos] not in b"\r\n":
                pos += 1
            continue
        start = pos
        while pos < len(data) and data[pos] not in b" \t\r\n":
            pos += 1
        fields.append(int(data[start:pos]))
    pos += 1
    w, h, _maxval = fields
    # a writable copy: torch.from_numpy warns on read-only buffers
    return np.frombuffer(data[pos:pos + w * h * 3],
                         np.uint8).reshape(h, w, 3).copy()


def guess_image_type(data: bytes) -> str:
    if data[:3] == b"\xff\xd8\xff":
        return "JPEG"
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        return "PNG"
    if data[:2] in (b"P5", b"P6"):
        return "PPM"
    return "UNKNOWN"


def read_image(data: bytes, param: EncoderParam, keep_metadata: bool = True):
    """Decode to RGB and (for PNG/JPEG) capture EXIF/ICC metadata."""
    kind = guess_image_type(data)
    if kind == "PPM":
        return _read_ppm(data)
    import io
    from PIL import Image
    im = Image.open(io.BytesIO(data))
    if keep_metadata:
        exif = im.info.get("exif")
        if exif:
            # PIL keeps the "Exif\0\0" prefix; the encoder re-adds it
            param.exif = exif[6:] if exif.startswith(b"Exif\x00\x00") else exif
        icc = im.info.get("icc_profile")
        if icc:
            param.iccp = icc if isinstance(icc, bytes) else icc.encode()
        xmp = im.info.get("XML:com.adobe.xmp")
        if xmp:
            param.xmp = xmp.encode() if isinstance(xmp, str) else xmp
    return np.asarray(im.convert("RGB"))


def _print_matrix(name, m, for_chroma):
    q = tools.estimate_quality(m, for_chroma)
    print(f"{name} quantization matrix (estimated quality: {q:.0f})")
    for i in range(8):
        print("  " + " ".join(f"{int(v):3d}" for v in m[8 * i: 8 * i + 8]))


def build_arg_parser():
    p = argparse.ArgumentParser(
        prog="sjpeg-tpu-torch",
        description="Compress or recompress pictures to baseline JPEG "
                    "(the PyTorch/CUDA port of the encode engine).")
    p.add_argument("input")
    p.add_argument("-o", dest="output", help="output JPEG file")
    p.add_argument("-q", dest="quality", type=float, default=None,
                   help="quality factor in [0..100]")
    p.add_argument("-r", dest="reduction", type=float, default=100.0,
                   help="reduction factor in [0..100] (JPEG source only)")
    p.add_argument("-size", type=int, help="target size in bytes")
    p.add_argument("-psnr", type=float, help="target YUV-PSNR (dB)")
    p.add_argument("-estimate", action="store_true",
                   help="print estimated source JPEG quality and exit")
    p.add_argument("-i", "-info", dest="info", action="store_true",
                   help="print information about the input file")
    p.add_argument("-xmp", metavar="FILE", help="XMP metadata file")
    p.add_argument("-exif", metavar="FILE", help="EXIF metadata file")
    p.add_argument("-icc", metavar="FILE", help="ICC profile file")
    p.add_argument("-version", action="store_true")
    p.add_argument("-quiet", action="store_true")
    p.add_argument("-short", dest="short_output", action="store_true")
    p.add_argument("-crc", action="store_true", help="print CRC32 and exit")
    p.add_argument("-md5", action="store_true", help="print MD5 and exit")
    p.add_argument("-yuv_mode", type=int, default=0, choices=range(5))
    p.add_argument("-420", dest="yuv420", action="store_true")
    p.add_argument("-sharp", action="store_true")
    p.add_argument("-444", dest="yuv444", action="store_true")
    p.add_argument("-gray", action="store_true")
    p.add_argument("-no_limit", action="store_true",
                   help="allow quality above the source's (JPEG input)")
    p.add_argument("-no_optim", action="store_true",
                   help="disable Huffman optimization")
    p.add_argument("-no_adapt", action="store_true",
                   help="disable adaptive quantization")
    p.add_argument("-trellis", action="store_true")
    p.add_argument("-adapt_bias", action="store_true")
    p.add_argument("-no_metadata", action="store_true")
    p.add_argument("-pass", dest="passes", type=int, default=0)
    p.add_argument("-qmin", type=float, default=0.0)
    p.add_argument("-qmax", type=float, default=100.0)
    p.add_argument("-tolerance", type=float, default=1.0)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the encode runs (cpu: the plain versions)")
    return p


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    if args.version:
        from . import version
        print(version())
        return 0

    param = EncoderParam()
    param.huffman_compress = not args.no_optim
    param.adaptive_quantization = not args.no_adapt
    param.use_trellis = args.trellis
    param.adaptive_bias = args.adapt_bias
    param.qmin, param.qmax = args.qmin, args.qmax
    param.tolerance = args.tolerance
    if args.yuv420:
        param.yuv_mode = C.YUV_420
    elif args.sharp:
        param.yuv_mode = C.YUV_SHARP
    elif args.yuv444:
        param.yuv_mode = C.YUV_444
    elif args.gray:
        param.yuv_mode = C.YUV_400
    else:
        param.yuv_mode = args.yuv_mode
    # reference CLI: a search with -pass <= 1 is forced to 10 passes
    # (examples/sjpeg.cc:254-256)
    if args.size is not None:
        param.set_target_size(args.size, args.tolerance,
                              args.passes if args.passes > 1 else 10)
    elif args.psnr is not None:
        param.set_target_psnr(args.psnr, args.tolerance,
                              args.passes if args.passes > 1 else 10)
    elif args.passes > 1:
        param.passes = args.passes

    try:
        data = open(args.input, "rb").read()
    except OSError as e:
        print(f"cannot read input file: {e}", file=sys.stderr)
        return 1

    kind = guess_image_type(data)
    use_reduction = args.quality is None
    nb_matrices, quant_matrices = (tools.find_quantizer(data)
                                   if kind == "JPEG" else (0, None))
    is_jpeg = kind == "JPEG" and nb_matrices > 0
    if use_reduction and not is_jpeg:
        if not args.quiet and not args.short_output:
            print("Warning! reduction factor (-r option) disabled "
                  "(only applies to JPEG source).")
        use_reduction = False

    if use_reduction:
        param.set_quantization(quant_matrices, args.reduction)
        if not args.no_limit:
            param.set_limit_quantization(True)
    else:
        param.set_quality(args.quality if args.quality is not None else 75.0)
        if is_jpeg and not args.no_limit:
            param.set_min_quantization(quant_matrices)

    if args.estimate:
        q = (tools.estimate_quality(quant_matrices[0]) if is_jpeg else 100)
        print(int(q))
        return 0

    rgb = read_image(data, param, keep_metadata=not args.no_metadata)
    h, w = rgb.shape[:2]

    if args.xmp:
        param.xmp = open(args.xmp, "rb").read()
    if args.icc:
        param.iccp = open(args.icc, "rb").read()
    if args.exif:
        param.exif = open(args.exif, "rb").read()
    if args.no_metadata:
        param.exif = param.iccp = param.xmp = param.app_markers = b""

    if args.info:
        mode, risk = compute_riskiness(rgb)
        print(f"Input [{kind}]: {args.input} ({len(data)} bytes, "
              f"{8.0 * len(data) / (w * h):.2f} bpp, {w} x {h})")
        print(f"Riskiness:   {risk:.1f} "
              f"(recommended yuv_mode: {YUV_MODE_NAMES[mode]})")
        if is_jpeg:
            print(f"Input is JPEG w/ {nb_matrices} matrices:")
            _print_matrix("Luma", quant_matrices[0], False)
            if nb_matrices > 1:
                _print_matrix("UV-chroma", quant_matrices[1], True)
        return 0

    import time
    start = time.time()
    out = encode_rgb(rgb, param, device=args.device)
    elapsed = time.time() - start

    if args.crc:
        print(f"0x{zlib.crc32(out) & 0xFFFFFFFF:08x}")
        return 0
    if args.md5:
        print(hashlib.md5(out).hexdigest())
        return 0

    if not args.quiet and not args.short_output:
        mode, risk = compute_riskiness(rgb)
        label = ("reduction:   r=" if (use_reduction and
                                       param.target_mode == TARGET_NONE)
                 else "quality:     q=")
        value = (args.reduction if use_reduction
                 else (args.quality if args.quality is not None else 75.0))
        print(f"new size:    {len(out)} bytes "
              f"({8.0 * len(out) / (w * h):.2f} bpp, "
              f"{100.0 * len(out) / len(data):.2f}% of original)")
        print(f"{label}{value:.1f} "
              f"(adaptive: {'yes' if param.adaptive_quantization else 'no'}, "
              f"Huffman: {'yes' if param.huffman_compress else 'no'})")
        print(f"yuv mode:    {YUV_MODE_NAMES[mode]} (riskiness: {risk:.1f}%)")
        print(f"elapsed:     {int(1000 * elapsed)} ms")
    elif not args.quiet:
        print(f"{len(data)} {len(out)} "
              f"{100.0 * len(out) / len(data):.2f} %")

    if args.output:
        with open(args.output, "wb") as f:
            f.write(out)
        if not args.quiet:
            print(f"Saved file: {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
