"""The host encoder by name: sjpeg_tpu.host_encoder's entry points on the
CPU.

The JAX package's host encoder is its NumPy oracle.  The port has no
second encoder: these names run the port's engine on the CPU, through the
kernels' plain PyTorch versions, which give sjpeg_tpu.host_encoder's
bytes.  `encode_components` starts from converted blocks (the
`pipeline.*_to_component_blocks` helpers', or any [N_c, 64] int32 arrays
in component scan order); the image entry points are
`engine.encode_rgb` / `encode_gray` / `encode_yuv` with device="cpu".
"""

from typing import Optional

import numpy as np
import torch

from . import engine
from .params import EncoderParam, method_flags


def encode_components(comp_blocks, layout,
                      param: Optional[EncoderParam] = None) -> bytes:
    """Encode already-converted component blocks into a full JPEG stream:
    the fDCT of each component, then one pass (methods 0 and 3 through
    quant_pack's plain version, 1, 4 and 7 through the quantize or the
    trellis and vlc_pack's) or, with passes > 1, the single-image
    search."""
    param = param or EncoderParam()
    blocks = [torch.as_tensor(np.asarray(b), dtype=torch.int32)
              for b in comp_blocks]
    coeffs, histos = engine._block_coeffs(
        blocks, method_flags(param.method)["use_adaptive_quant"])
    return engine._encode_coeffs(coeffs, histos, layout, param)


def encode_rgb(rgb: np.ndarray, param: Optional[EncoderParam] = None) -> bytes:
    """Encode an RGB image ([H, W, 3] uint8) to a baseline JPEG stream."""
    return engine.encode_rgb(rgb, param, device="cpu")


def encode_gray(gray: np.ndarray,
                param: Optional[EncoderParam] = None) -> bytes:
    """Encode a grayscale plane ([H, W] uint8) as YUV 4:0:0."""
    return engine.encode_gray(gray, param, device="cpu")


def encode_yuv(y: np.ndarray, u: np.ndarray, v: np.ndarray, is_420: bool,
               param: Optional[EncoderParam] = None) -> bytes:
    """Encode planar YUV input (4:2:0 when `is_420`, else 4:4:4)."""
    return engine.encode_yuv(y, u, v, is_420, param, device="cpu")


def encode_nv12(y: np.ndarray, uv: np.ndarray,
                param: Optional[EncoderParam] = None) -> bytes:
    """Encode semi-planar NV12 input: y [H, W], uv [ceil(H/2), ceil(W/2), 2]
    with interleaved U/V samples."""
    return encode_yuv(y, uv[..., 0], uv[..., 1], is_420=True, param=param)


def encode_nv21(y: np.ndarray, vu: np.ndarray,
                param: Optional[EncoderParam] = None) -> bytes:
    """Encode semi-planar NV21 input (V/U interleaved chroma)."""
    return encode_yuv(y, vu[..., 1], vu[..., 0], is_420=True, param=param)
