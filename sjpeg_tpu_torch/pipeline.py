"""Component geometry of an encode (reference src/enc.cc:1645-1701), the
conversion of an image into per-component block arrays in component scan
order, and the MCU interleave of those arrays.

The block helpers are sjpeg_tpu.pipeline's, computed with the port's
tensor programs (ops/colorspace) on the CPU: NumPy (or torch) input,
NumPy [N_c, 64] int32 blocks out, for `host_encoder.encode_components`.
"""

import dataclasses
from typing import List

import numpy as np
import torch

from . import constants as C
from .ops import colorspace


@dataclasses.dataclass
class ComponentLayout:
    yuv_mode: int
    width: int
    height: int
    mb_w: int
    mb_h: int
    nb_comps: int
    quant_idx: List[int]      # per component: 0 = luma table, 1 = chroma
    nb_blocks: List[int]      # blocks per MCU per component
    block_dims: List[int]     # SOF sampling byte per component
    block_w: int              # MCU pixel width
    block_h: int


def component_layout(yuv_mode: int, width: int, height: int) -> ComponentLayout:
    if yuv_mode == C.YUV_444:
        geo = dict(nb_comps=3, quant_idx=[0, 1, 1], nb_blocks=[1, 1, 1],
                   block_dims=[0x11, 0x11, 0x11], block_w=8, block_h=8)
    elif yuv_mode in (C.YUV_420, C.YUV_SHARP):
        geo = dict(nb_comps=3, quant_idx=[0, 1, 1], nb_blocks=[4, 1, 1],
                   block_dims=[0x22, 0x11, 0x11], block_w=16, block_h=16)
    elif yuv_mode == C.YUV_400:
        geo = dict(nb_comps=1, quant_idx=[0], nb_blocks=[1],
                   block_dims=[0x11], block_w=8, block_h=8)
    else:
        raise ValueError(f"unresolved yuv_mode {yuv_mode}")
    mb_w = (width + geo["block_w"] - 1) // geo["block_w"]
    mb_h = (height + geo["block_h"] - 1) // geo["block_h"]
    return ComponentLayout(yuv_mode=yuv_mode, width=width, height=height,
                           mb_w=mb_w, mb_h=mb_h, **geo)


def _cpu(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.cpu()
    return torch.from_numpy(np.ascontiguousarray(x))


def _numpy(blocks) -> list:
    return [b.contiguous().numpy() for b in blocks]


def rgb_to_component_blocks(rgb, layout: ComponentLayout):
    """RGB [H, W, 3] -> list of [N_c, 64] int32 block arrays (centered),
    each in component scan order (MCU raster; 2x2 luma sub-order for 420,
    with the extra luma of clipped MCUs flattened)."""
    return _numpy(colorspace.rgb_to_blocks(_cpu(rgb), layout.yuv_mode,
                                           layout.width, layout.height))


def gray_to_component_blocks(gray, layout: ComponentLayout):
    """Direct luma-plane input (YUV 4:0:0), values shifted by -128."""
    return _numpy(colorspace.planes_to_blocks(
        (_cpu(gray),), C.YUV_400, layout.width, layout.height))


def yuv_planes_to_component_blocks(y, u, v, layout: ComponentLayout):
    """Planar YUV input (4:4:4 or 4:2:0), values shifted by -128."""
    mode = layout.yuv_mode
    if mode == C.YUV_SHARP:
        mode = C.YUV_420
    if mode not in (C.YUV_444, C.YUV_420):
        raise ValueError(f"unsupported yuv_mode {mode} for planar input")
    return _numpy(colorspace.planes_to_blocks(
        tuple(_cpu(p) for p in (y, u, v)), mode, layout.width,
        layout.height))


def nv12_to_component_blocks(y, uv, layout: ComponentLayout,
                             is_nv12: bool = True):
    """Semi-planar NV12/NV21 input: uv is [ceil(H/2), ceil(W/2), 2]."""
    u = uv[..., 0] if is_nv12 else uv[..., 1]
    v = uv[..., 1] if is_nv12 else uv[..., 0]
    return yuv_planes_to_component_blocks(y, u, v, layout)


def scan_order(layout: ComponentLayout):
    """[(component, per-component block index)] in MCU-interleaved order."""
    order = []
    counters = [0] * layout.nb_comps
    for _ in range(layout.mb_w * layout.mb_h):
        for c in range(layout.nb_comps):
            for _b in range(layout.nb_blocks[c]):
                order.append((c, counters[c]))
                counters[c] += 1
    return order
