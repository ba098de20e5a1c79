"""VLC preparation on tensors: run/levels, DC prediction, each table's
symbol frequencies, and per-block (value, length) entry streams ready for
bit packing.

The reference walks each block serially emitting bits (src/enc.cc:882-911);
here every quantity is computed for all blocks at once.  Each block becomes
a fixed 191-lane entry stream: DC, then per AC position an escape-pair
lane, an escape-single lane and a symbol+value lane, then EOB.  Every lane
is at most 32 bits long.  Values are uint32 carried in int64.
"""

import torch

from .. import constants as C
from .pack import to_u32

# per-block entry-stream layout
NUM_ENTRIES = 1 + 63 * 3 + 1
_DC_LANE = 0
_EOB_LANE = NUM_ENTRIES - 1


def calc_log2(v: torch.Tensor) -> torch.Tensor:
    """Bit length of v for 1 <= v < 2^16, elementwise (src/enc.cc:468-480)."""
    out = torch.zeros_like(v)
    x = v
    for shift in (8, 4, 2, 1):
        hit = x >= (1 << shift)
        out = out + hit.to(v.dtype) * shift
        x = torch.where(hit, x >> shift, x)
    return out + (v > 0).to(v.dtype)


def run_levels(qblocks: torch.Tensor, dtype=torch.int64) -> dict:
    """[N, 64] quantized blocks (raster) -> zigzag-layout VLC fields.

    Returns a dict of [N, 64] tensors of `dtype`: nz (bool, AC nonzero),
    run (zero run before), size (bit length), code (suffix bits), plus
    last [N] (zigzag index of the last nonzero AC, 0 if none).  The
    optimized path asks for int32, the layout its pack kernel reads.
    """
    zz_idx = torch.as_tensor(C.ZIGZAG, dtype=torch.int64,
                             device=qblocks.device)
    zz = qblocks.to(dtype)[:, zz_idx]
    pos = torch.arange(64, dtype=dtype, device=qblocks.device)[None, :]
    nz = (zz != 0) & (pos > 0)
    mag = zz.abs()
    zero = torch.zeros((), dtype=dtype, device=qblocks.device)
    size = torch.where(nz, calc_log2(mag.clamp(min=1)), zero)
    code = (mag ^ -(zz < 0).to(dtype)) & ((1 << size) - 1)
    prev = torch.cummax(torch.where(nz, pos, zero), dim=1).values
    prev_before = torch.nn.functional.pad(prev[:, :-1], (1, 0))
    run = torch.where(nz, pos - prev_before - 1, zero)
    return {"nz": nz, "run": run, "size": size, "code": code,
            "last": prev[:, -1]}


def dc_diff_codes(dc: torch.Tensor, n_images: int = 1,
                  prev=None) -> torch.Tensor:
    """[N] signed quantized DC (component scan order) -> int32 codes.

    code = n | (suffix << 4); the predictor starts at 0 (src/enc.cc:482-499)
    and resets at every image boundary (N = n_images * blocks per image,
    image-major).  `prev`: optional [n_images] predictor each image starts
    from instead of 0 (a stripe's carried-in DC, parallel/shard.py).
    """
    d2 = dc.to(torch.int64).reshape(n_images, -1)
    prev = torch.cat([torch.zeros_like(d2[:, :1]) if prev is None
                      else prev.to(torch.int64).reshape(n_images, 1),
                      d2[:, :-1]], dim=1)
    diff = (d2 - prev).reshape(-1)
    n = torch.where(diff == 0, 0, calc_log2(diff.abs()))
    suff = torch.where(diff < 0, (diff - 1) & ((1 << n) - 1), diff)
    return torch.where(diff == 0, 0, n | (suff << 4)).to(torch.int32)


def grouped_stats(rl, dc_codes, group, n_images: int = 1, valid=None):
    """Per-table-group symbol frequencies from interleaved VLC fields:
    int32 ([B, 2, 12] DC, [B, 2, 256] AC) per image (rows image-major,
    equal blocks per image), unbatched ([2, 12], [2, 256]) when
    n_images == 1.  AC counts include a ZRL at 0xF0 for every 16 zeros
    of a run and an EOB at 0x00 for each block not ending at position 63.
    `valid`: optional [N] bool; blocks with False count no symbol, DC and
    EOB included (the padding blocks of a ragged stripe).  Integer
    scatter-adds are exact: no one-hot matmul."""
    nz = rl["nz"] if valid is None else rl["nz"] & valid[:, None]
    n = nz.shape[0]
    dev = nz.device
    img = torch.arange(n_images, device=dev).repeat_interleave(n // n_images)
    tab = img * 2 + group                                  # [N] table
    sym = ((rl["run"] & 15) << 4) | rl["size"]             # 0 where not nz
    freq_ac = torch.zeros(n_images * 512, dtype=torch.int32, device=dev)
    freq_ac.scatter_add_(0, (tab[:, None] * 256 + sym).reshape(-1),
                         nz.to(torch.int32).reshape(-1))
    esc = torch.where(nz, rl["run"] >> 4, 0).sum(dim=1, dtype=torch.int32)
    freq_ac.scatter_add_(0, tab * 256 + 0xF0, esc)
    eob = rl["last"] < 63
    if valid is not None:
        eob = eob & valid
    freq_ac.scatter_add_(0, tab * 256, eob.to(torch.int32))

    # DC: the JAX one-hot over 26 = 2 x 13 size bins drops larger indices
    dci = group * 13 + (dc_codes & 0x0F)
    dump = n_images * 26
    keep = dci < 26 if valid is None else (dci < 26) & valid
    idx = torch.where(keep, img * 26 + dci, dump)
    freq_dc = torch.zeros(dump + 1, dtype=torch.int32, device=dev)
    freq_dc.scatter_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
    freq_dc = freq_dc[:dump].reshape(n_images, 2, 13)[:, :, :12]
    freq_ac = freq_ac.reshape(n_images, 2, 256)
    if n_images == 1:
        return freq_dc[0], freq_ac[0]
    return freq_dc, freq_ac


def block_entries_grouped(rl: dict, dc_codes: torch.Tensor,
                          dc_luts: torch.Tensor, ac_luts: torch.Tensor,
                          group: torch.Tensor):
    """Per-block entry streams for rows of mixed luma/chroma tables.

    `dc_luts` [2, 16] / `ac_luts` [2, 256] hold packed (code << 16) | len
    uint32 LUT entries (as int32 bit patterns); `group` [N] is each row's
    table index.  Returns ([N, 191] int64 values, [N, 191] int64 lengths).
    """
    N = dc_codes.shape[0]
    dev = dc_codes.device
    dc_flat = to_u32(dc_luts).reshape(-1)
    ac_flat = to_u32(ac_luts).reshape(-1)
    g = group.to(torch.int64)
    dcc = dc_codes.to(torch.int64)

    vals = torch.zeros((N, NUM_ENTRIES), dtype=torch.int64, device=dev)
    lens = torch.zeros((N, NUM_ENTRIES), dtype=torch.int64, device=dev)

    dc_len = dcc & 0x0F
    packed = dc_flat[g * 16 + dc_len]
    vals[:, _DC_LANE] = ((packed >> 16) << dc_len) | (dcc >> 4)
    lens[:, _DC_LANE] = (packed & 0xFF) + dc_len

    nz = rl["nz"][:, 1:]
    run = rl["run"][:, 1:]
    size = rl["size"][:, 1:]
    code = rl["code"][:, 1:]
    g256 = (g * 256)[:, None]

    esc_packed = ac_flat[g256 + 0xF0]                    # [N, 1]
    esc_code = esc_packed >> 16
    esc_len = esc_packed & 0xFF

    n_esc = torch.where(nz, run >> 4, 0)
    pair = n_esc.clamp(max=2)
    single = n_esc - pair
    pair_val = torch.where(pair == 2, (esc_code << esc_len) | esc_code,
                           torch.where(pair == 1, esc_code, 0))
    sym_packed = ac_flat[g256 + (((run & 15) << 4) | size)]
    sym_val = ((sym_packed >> 16) << size) | code

    vals[:, 1:190:3] = pair_val
    lens[:, 1:190:3] = pair * esc_len
    vals[:, 2:190:3] = torch.where(single == 1, esc_code, 0)
    lens[:, 2:190:3] = single * esc_len
    vals[:, 3:190:3] = torch.where(nz, sym_val, 0)
    lens[:, 3:190:3] = torch.where(nz, (sym_packed & 0xFF) + size, 0)

    eob_packed = ac_flat[g * 256]
    has_eob = rl["last"] < 63
    vals[:, _EOB_LANE] = torch.where(has_eob, eob_packed >> 16, 0)
    lens[:, _EOB_LANE] = torch.where(has_eob, eob_packed & 0xFF, 0)
    return vals, lens
