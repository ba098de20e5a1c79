"""Component geometry of an encode (reference src/enc.cc:1645-1701)."""

import dataclasses
from typing import List

from . import constants as C


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
