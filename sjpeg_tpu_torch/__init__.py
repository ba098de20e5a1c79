"""sjpeg_tpu_torch: the PyTorch/CUDA port of the sjpeg-tpu encode engine.

It runs the method-0 batched encode (fixed K.3 Huffman tables, pinned
4:2:0, 4:4:4 or 4:0:0) on an NVIDIA GPU through two hand-written CUDA
kernels, and produces the same bytes as `sjpeg_tpu.engine.encode_batch`.
Entry points live in `sjpeg_tpu_torch.engine`; each runs on "cuda" unless
the caller passes device="cpu".
"""

from .constants import YUV_400, YUV_420, YUV_444
from .engine import (encode_batch, encode_batch_gray, encode_batch_nv12,
                     encode_batch_nv21, encode_batch_yuv)
from .params import EncoderParam
