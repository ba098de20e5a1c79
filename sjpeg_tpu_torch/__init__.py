"""sjpeg_tpu_torch: the PyTorch/CUDA port of the sjpeg-tpu encode engine.

It runs the encode for methods 0, 1, 3, 4 and 7 (fixed K.3 or optimal
Huffman tables, with or without adaptive quantization, method 7 with
trellis quantization; pinned 4:2:0, 4:4:4 or 4:0:0) on an NVIDIA GPU
through seven hand-written CUDA kernels, and produces the same bytes as
sjpeg_tpu: one image (`encode`, `encode_rgb`, `encode_gray`,
`encode_yuv`), a batch (`encode_batch` and its planar, gray, NV12 and NV21
forms), a stream of batches (`encode_pipelined`) or a list of images of
mixed shapes (`encode_many`).  With passes > 1 and a target size or PSNR
(`EncoderParam.set_target_size` / `set_target_psnr`) each image runs its
own search, driven by `EncoderParam.search_hook` when one is set (a
`SearchHook` subclass).  Entry points live in `sjpeg_tpu_torch.engine`;
each runs on "cuda" unless the caller passes device="cpu".
"""

from .constants import YUV_400, YUV_420, YUV_444
from .engine import (encode_batch, encode_batch_gray, encode_batch_nv12,
                     encode_batch_nv21, encode_batch_yuv, encode_gray,
                     encode_many, encode_pipelined, encode_rgb, encode_yuv)
from .params import EncoderParam, SearchHook


def encode(rgb, param=None, device=None) -> bytes:
    """Encode one RGB uint8 image [H, W, 3] to baseline JPEG (sjpeg's
    Encode()); the same bytes as sjpeg_tpu.encode on its device path."""
    return encode_rgb(rgb, param, device)
