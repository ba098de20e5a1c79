"""sjpeg_tpu_torch: the PyTorch/CUDA port of the sjpeg-tpu encode engine.

It runs the batched encode for methods 0, 1, 3, 4 and 7 (fixed K.3 or
optimal Huffman tables, with or without adaptive quantization, method 7
with trellis quantization; pinned 4:2:0, 4:4:4 or 4:0:0) on an NVIDIA GPU
through five hand-written CUDA kernels, and produces the same bytes as
`sjpeg_tpu.engine.encode_batch`; with passes > 1 and a target size or
PSNR (`EncoderParam.set_target_size` / `set_target_psnr`) each image runs
its own search.
Entry points live in `sjpeg_tpu_torch.engine`; each runs on "cuda" unless
the caller passes device="cpu".
"""

from .constants import YUV_400, YUV_420, YUV_444
from .engine import (encode_batch, encode_batch_gray, encode_batch_nv12,
                     encode_batch_nv21, encode_batch_yuv)
from .params import EncoderParam
