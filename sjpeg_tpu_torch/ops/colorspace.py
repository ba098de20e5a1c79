"""Colour conversion and block layout on tensors.

Whole-image tensor programs in place of the reference's per-MCU conversion
(src/colors_rgb.cc:505-603): fixed-point BT.601 full-range RGB->YUV with
the exact rounding and shift order, MCU padding by edge replication, and
the extra-luma flattening of clipped 4:2:0 MCUs (src/enc.cc:1703-1754).

Every function takes an optional leading batch dimension; a batch of
images is just more 8x8 blocks, image-major.  Planes are int32; samples
centred on 0 span [-128, 127] for luma and [-127, +128] for RGB-derived
chroma, so any signed type of 16 bits or more holds them exactly.
"""

import torch

from .. import constants as C


def _edge_index(n: int, pad: int, device) -> torch.Tensor:
    return torch.clamp(torch.arange(n + pad, device=device), max=n - 1)


def pad_edge(img: torch.Tensor, block_w: int, block_h: int) -> torch.Tensor:
    """Replicate the last row/column up to MCU multiples ([..., H, W] or
    [..., H, W, 3])."""
    if img.shape[-1] == 3 and img.dim() >= 3:
        ha, wa = img.dim() - 3, img.dim() - 2
    else:
        ha, wa = img.dim() - 2, img.dim() - 1
    h, w = img.shape[ha], img.shape[wa]
    ph = (-h) % block_h
    pw = (-w) % block_w
    if ph:
        img = img.index_select(ha, _edge_index(h, ph, img.device))
    if pw:
        img = img.index_select(wa, _edge_index(w, pw, img.device))
    return img


def blockize(plane: torch.Tensor) -> torch.Tensor:
    """[..., H, W] -> [prod(lead) * H/8 * W/8, 64] in raster block order."""
    *lead, h, w = plane.shape
    out = (plane.reshape(*lead, h // 8, 8, w // 8, 8)
           .transpose(-3, -2)
           .reshape(*lead, (h // 8) * (w // 8), 64))
    return out.reshape(-1, 64)


def blockize_420_luma(plane: torch.Tensor) -> torch.Tensor:
    """[..., H, W] -> [prod(lead) * n_mcu * 4, 64]; row-major 2x2 block
    order inside each MCU."""
    *lead, h, w = plane.shape
    x = plane.reshape(*lead, h // 16, 2, 8, w // 16, 2, 8)
    n = x.dim()
    perm = (list(range(n - 6))
            + [n - 6, n - 3, n - 5, n - 2, n - 4, n - 1])
    return x.permute(perm).reshape(-1, 64)


def _channel_planes(rgb: torch.Tensor):
    """[..., H, W, 3] uint8 -> three [..., H, W] int32 planes."""
    return (rgb[..., 0].to(torch.int32), rgb[..., 1].to(torch.int32),
            rgb[..., 2].to(torch.int32))


def rgb_to_yuv444_planes(rgb: torch.Tensor):
    """[..., H, W, 3] uint8 -> (y, u, v) [..., H, W] int32, centred on 0."""
    r, g, b = _channel_planes(rgb)
    y = (19595 * r + 38469 * g + 7471 * b + C.ROUND_Y) >> C.YUV_FRAC
    u = (-11059 * r - 21709 * g + 32768 * b + C.YUV_HALF) >> C.YUV_FRAC
    v = (32768 * r - 27439 * g - 5329 * b + C.YUV_HALF) >> C.YUV_FRAC
    return y, u, v


def rgb_to_y_plane(rgb: torch.Tensor) -> torch.Tensor:
    r, g, b = _channel_planes(rgb)
    return (19595 * r + 38469 * g + 7471 * b + C.ROUND_Y) >> C.YUV_FRAC


def _quad_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of each 2x2 quad of [..., H, W] -> [..., H/2, W/2]."""
    *lead, h, w = x.shape
    return x.reshape(*lead, h // 2, 2, w // 2, 2).sum(dim=(-3, -1),
                                                      dtype=torch.int32)


def rgb_to_yuv420_planes(rgb: torch.Tensor):
    """[..., H, W, 3] uint8 (16-aligned) -> (y, u, v) int32 planes.

    Chroma derives from the sum of each 2x2 RGB quad with ROUND_UV rounding
    and a FRAC+2 shift, matching the reference's summed-quad fixed point.
    """
    y = rgb_to_y_plane(rgb)
    r, g, b = (_quad_sum(p) for p in _channel_planes(rgb))
    u = (-11059 * r - 21709 * g + 32768 * b + C.ROUND_UV) >> (C.YUV_FRAC + 2)
    v = (32768 * r - 27439 * g - 5329 * b + C.ROUND_UV) >> (C.YUV_FRAC + 2)
    return y, u, v


def _block_avg(block: torch.Tensor) -> torch.Tensor:
    """Rounded mean of 8x8 blocks over the last axis: (sum + 32) >> 6."""
    return (block.sum(dim=-1, dtype=torch.int32) + 32) >> 6


def fix_mcu(mcu: torch.Tensor, sw: int, sh: int) -> torch.Tensor:
    """AverageExtraLuma flattening of one clipped 4:2:0 MCU's luma blocks
    (src/enc.cc:1720-1738).  mcu: [..., 4, 64]; sw/sh are the MCU's
    in-frame sub-sizes."""
    b0, b1 = mcu[..., 0, :], mcu[..., 1, :]
    b2, b3 = mcu[..., 2, :], mcu[..., 3, :]
    dc = _block_avg(b0)[..., None].to(mcu.dtype)
    if sw <= 8:
        b1 = dc.expand(b1.shape)
    if sh <= 8:
        dc2 = _block_avg(b1)[..., None].to(mcu.dtype) if sw > 8 else dc
        b2 = dc2.expand(b2.shape)
        b3 = dc2.expand(b3.shape)
    elif sw <= 8:
        b3 = _block_avg(b2)[..., None].to(mcu.dtype).expand(b3.shape)
    return torch.stack([b0, b1, b2, b3], dim=-2)


def average_extra_luma(y_blocks: torch.Tensor, mb_w: int, mb_h: int,
                       width: int, height: int) -> torch.Tensor:
    """Flatten fully out-of-frame 4:2:0 luma blocks.

    `y_blocks`: [B * mb_h * mb_w * 4, 64] in MCU-nested 2x2 order.  Which
    blocks are flattened follows from the geometry; only the averages
    depend on the data.  Nothing changes for MCU-aligned images.
    """
    mb_x_max = width // 16
    mb_y_max = height // 16
    x_clip = mb_x_max < mb_w
    y_clip = mb_y_max < mb_h
    if not (x_clip or y_clip):
        return y_blocks
    sub_w = width - mb_x_max * 16
    sub_h = height - mb_y_max * 16

    yb = y_blocks.reshape(-1, mb_h, mb_w, 4, 64).clone()
    if x_clip:
        fixed = fix_mcu(yb[:, :, mb_x_max], sub_w, 16)
        if y_clip:
            fixed[:, mb_y_max] = fix_mcu(yb[:, mb_y_max, mb_x_max], sub_w,
                                         sub_h)
        yb[:, :, mb_x_max] = fixed
    if y_clip:
        fixed = fix_mcu(yb[:, mb_y_max], 16, sub_h)
        if x_clip:
            fixed[:, mb_x_max] = yb[:, mb_y_max, mb_x_max]
        yb[:, mb_y_max] = fixed
    return yb.reshape(-1, 64)


def rgb_to_blocks(rgb: torch.Tensor, yuv_mode: int, width: int,
                  height: int):
    """RGB [..., H, W, 3] uint8 -> list of [N_c, 64] int32 sample blocks.

    With a leading batch dimension, each component array holds the
    images' blocks in batch order (image-major, then component scan
    order).  RGB-derived chroma reaches +128 (pure blue gives U = +128,
    pure red V = +128; the reference keeps unclamped int16 samples,
    src/colors_rgb.cc ToU/ToUV).
    """
    if yuv_mode == C.YUV_444:
        img = pad_edge(rgb, 8, 8)
        return [blockize(p) for p in rgb_to_yuv444_planes(img)]
    if yuv_mode == C.YUV_420:
        img = pad_edge(rgb, 16, 16)
        y, u, v = rgb_to_yuv420_planes(img)
        mb_w = img.shape[-2] // 16
        mb_h = img.shape[-3] // 16
        yb = average_extra_luma(blockize_420_luma(y), mb_w, mb_h, width,
                                height)
        return [yb, blockize(u), blockize(v)]
    if yuv_mode == C.YUV_400:
        return [blockize(rgb_to_y_plane(pad_edge(rgb, 8, 8)))]
    raise ValueError(f"unsupported yuv_mode {yuv_mode}")


def planes_to_blocks(planes, yuv_mode: int, width: int, height: int):
    """Planar YUV/gray uint8 input [..., H, W] -> component block lists,
    shifted by -128."""
    def centred(p, block):
        return pad_edge(p, block, block).to(torch.int32) - 128

    if yuv_mode == C.YUV_400:
        return [blockize(centred(planes[0], 8))]
    if yuv_mode == C.YUV_444:
        return [blockize(centred(p, 8)) for p in planes]
    if yuv_mode == C.YUV_420:
        y, u, v = planes
        yp = centred(y, 16)
        mb_w = yp.shape[-1] // 16
        mb_h = yp.shape[-2] // 16
        yb = average_extra_luma(blockize_420_luma(yp), mb_w, mb_h, width,
                                height)
        return [yb, blockize(centred(u, 8)), blockize(centred(v, 8))]
    raise ValueError(f"unsupported yuv_mode {yuv_mode}")
