"""sjpeg_tpu_torch: the PyTorch/CUDA port of the sjpeg-tpu encode engine.

It runs the encode for methods 0, 1, 3, 4 and 7 (fixed K.3 or optimal
Huffman tables, with or without adaptive quantization, method 7 with
trellis quantization; 4:2:0, sharp 4:2:0, 4:4:4 or 4:0:0, or YUV_AUTO,
which picks one of them per image from its riskiness) on an NVIDIA GPU
through ten hand-written CUDA kernels, and produces the same bytes as
sjpeg_tpu: one image (`encode`, `encode_rgb`, `encode_gray`,
`encode_yuv`), a batch (`encode_batch` and its planar, gray, NV12 and NV21
forms), a stream of batches (`encode_pipelined`), a list of images of
mixed shapes (`encode_many`) or a batch over a (dp, sp) mesh of devices
(`encode_batch_sharded`, sjpeg_tpu_torch.parallel: dp shards images, sp
MCU-row stripes of each image).  With passes > 1 and a target size or PSNR
(`EncoderParam.set_target_size` / `set_target_psnr`) each image runs its
own search, driven by `EncoderParam.search_hook` when one is set (a
`SearchHook` subclass).  Entry points live in `sjpeg_tpu_torch.engine`;
each runs on "cuda" unless the caller passes device="cpu" (the
`host_encode_*` names, sjpeg_tpu_torch.host_encoder's, run the plain path
on the CPU).  The command-line tool is `python -m sjpeg_tpu_torch.cli`;
the encode inspector `python -m sjpeg_tpu_torch.inspect_tool`.
"""

from .constants import (SJPEG_TPU_VERSION, YUV_400, YUV_420, YUV_444,
                        YUV_AUTO, YUV_SHARP)
from .engine import (encode_batch, encode_batch_gray, encode_batch_nv12,
                     encode_batch_nv21, encode_batch_yuv, encode_gray,
                     encode_many, encode_pipelined, encode_rgb, encode_yuv)
from .host_encoder import encode_gray as host_encode_gray
from .host_encoder import encode_rgb as host_encode_rgb
from .host_encoder import encode_yuv as host_encode_yuv
from .parallel.api import encode_batch_sharded
from .params import (TARGET_NONE, TARGET_PSNR, TARGET_SIZE, EncoderParam,
                     SearchHook)
from .tools import dimensions, estimate_quality, find_quantizer, quant_matrix


def version() -> str:
    return ".".join(map(str, SJPEG_TPU_VERSION))


def encode(rgb, param=None, backend: str = "auto", *, device=None) -> bytes:
    """Encode one RGB uint8 image [H, W, 3] to baseline JPEG (sjpeg's
    Encode()).  backend: "host" runs the plain path on the CPU; "auto" (or
    "tpu", the JAX package's name for the accelerator) runs on the card,
    or on `device` when one is given.  The same bytes as sjpeg_tpu.encode."""
    if backend == "host":
        return host_encode_rgb(rgb, param)
    if backend not in ("auto", "tpu"):
        raise ValueError(f"unknown backend {backend!r}: expected 'auto', "
                         "'tpu' or 'host'")
    return encode_rgb(rgb, param, device)


__all__ = [
    "EncoderParam", "SearchHook", "encode", "encode_batch", "encode_many",
    "encode_pipelined",
    "encode_batch_yuv", "encode_batch_gray", "encode_batch_nv12",
    "encode_batch_nv21", "encode_batch_sharded", "version",
    "host_encode_rgb", "host_encode_gray", "host_encode_yuv",
    "dimensions", "estimate_quality", "find_quantizer", "quant_matrix",
    "YUV_AUTO", "YUV_420", "YUV_SHARP", "YUV_444", "YUV_400",
    "TARGET_NONE", "TARGET_SIZE", "TARGET_PSNR",
]
