"""Public sharded encode API: JPEGs out of a (dp, sp) mesh of devices.

`encode_batch_sharded` runs the encode, adaptive quantization and
per-image two-pass Huffman optimization included, over a 2-D mesh (dp =
images, sp = MCU-row stripes within an image), and produces the bytes of
the one-device `engine.encode_batch` (sjpeg_tpu.parallel.api's contract).
Its stages are the one-device engine's staged stages run once a stripe, on
the stripe's device, with the engine's kernels:

  1. colour + fDCT per stripe (the fdct kernel) + per-image coefficient
     histograms, summed over sp on the dp row's lead device  -> the
     lambda fit where the sums are (one lambda_fit launch a dp row on a
     card, or one on the lead device for the batch with share_statistics;
     the host fit for host devices), its rows kept on the lead devices
  2. quantize (or the trellis kernel, method 7) + run/levels; the DC
     chains carry across stripes: each stripe hands its last quantized DC
     of each image and component to the next stripe's device; per-image
     symbol frequencies summed over sp          -> tables on the lead
     device (the merge_codesizes kernel; shared tables on the host)
  3. VLC + per-block pack (vlc_pack) + per-stripe compaction
     (stream_concat), padding blocks masked out  -> one stream_concat
     launch a dp row stitches the stripes -> scan_stuff on the lead
     device -> one fetch a dp row -> host tail (markers)

Launches are asynchronous and the quantizers are uploaded before the
stripe loops, so stripes on distinct devices are meant to overlap; no run
on more than one card has measured that yet.  Stripes on a repeated
device run one after another.  Ragged geometry (MCU
rows not divisible by sp, a partial last MCU row, fewer MCU rows than
stripes) pads each stripe to whole MCU rows by edge replication and masks
the padding blocks out of the histograms, the frequencies and the
bitstream.  A batch not divisible by the dp rows is padded with copies of
image 0, whose outputs are dropped and whose statistics never count.

Sharp YUV converts per dp row (the sharp_yuv kernel on the row's images)
and encodes the planes' stripes; a mixed YUV_AUTO batch runs as one
sharded sub-batch per mode.

A target-size / target-PSNR search (passes > 1 with a target) runs the
same stages pass by pass (`_ShardedSearch`): the coefficients once, then
per pass each image's matrices from its hook on the host, and

  size: quantize (DC chains across stripes) + tables on the lead device +
        VLC + pack + stitch, the stuffing counted on the stitched words
        -> one fetch a dp row (totals, stuffing, largest stripe, nb_syms)
  PSNR: the masked squared error a stripe, summed in int64 on the lead
        device -> one fetch a dp row

then a final pass at each image's best matrices through the single-shot
stages.  Each process's loop ends when its own images' hooks are done: no
collective a pass.  Delegated to the one-device engine on the mesh's first
device, as sjpeg_tpu.parallel.api delegates: sharp images with a side <=
4, sharp searches, YUV_AUTO under several processes, and custom search
hooks.
"""

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import constants as C
from .. import engine, engine_search, pipeline, sharp_yuv, state
from ..dichotomy import get_psnr
from ..huffman import trellis_cost_lens
from ..ops import fdct, huffman_device, pack, quantize
from ..params import EncoderParam, method_flags
from .mesh import Mesh, default_mesh
from .shard import _dc_codes_sharded, _local_blocks, stitch_shard_streams


def encode_batch_sharded(rgbs, param: Optional[EncoderParam] = None,
                         mesh: Optional[Mesh] = None,
                         bits_per_pixel_budget: float = 4.0,
                         share_statistics: bool = False):
    """Encode a uint8 batch [B, H, W, 3] (numpy or torch) over a (dp, sp)
    mesh (`make_mesh`; `default_mesh()` when None).  Returns a list of
    JPEG byte strings, byte-identical to `engine.encode_batch`.

    Under several processes (`init_distributed`, dp laid across them),
    `rgbs` is this process's LOCAL images, the same count and shape in
    every process, and the list holds their JPEGs, in order; image data
    never crosses processes, and with share_statistics the shared tables
    span each process's local batch.  With passes > 1 and a target, each
    image runs its own search (share_statistics does not apply)."""
    param = param or EncoderParam()
    mesh = mesh or default_mesh()
    b, h, w = rgbs.shape[:3]
    engine._check_size(w, h)
    if mesh.world > 1:
        _check_processes(mesh, tuple(rgbs.shape))
    lead = mesh.lead()
    yuv_mode = param.yuv_mode
    if yuv_mode == C.YUV_AUTO and mesh.world == 1:
        rgbs = engine._to_device(rgbs, lead)
        groups = {}
        for i, m in enumerate(engine.auto_modes(rgbs)):
            groups.setdefault(m, []).append(i)
        if len(groups) > 1:
            out = [None] * b
            for m, idxs in groups.items():
                res = encode_batch_sharded(
                    rgbs[torch.tensor(idxs, device=lead)],
                    dataclasses.replace(param, yuv_mode=m), mesh,
                    bits_per_pixel_budget, share_statistics)
                for i, jpeg in zip(idxs, res):
                    out[i] = jpeg
            return out
        yuv_mode = next(iter(groups))
    if yuv_mode != C.YUV_AUTO:
        param = dataclasses.replace(param, yuv_mode=yuv_mode)
    search = engine._is_search(param)
    sharp = yuv_mode == C.YUV_SHARP
    if (yuv_mode == C.YUV_AUTO or (search and param.search_hook is not None)
            or (sharp and (search or min(w, h) <= sharp_yuv.MIN_DIMENSION))):
        return engine.encode_batch(rgbs, param, bits_per_pixel_budget,
                                   share_statistics, device=lead)
    run = (_ShardedSearch(rgbs, param, mesh, yuv_mode, bits_per_pixel_budget)
           if search else _Sharded(rgbs, param, mesh, yuv_mode,
                                   bits_per_pixel_budget, share_statistics))
    for stage in run.stages():
        stage()
    return run.out


def _check_processes(mesh: Mesh, shape: tuple) -> None:
    """Every process must encode the same local batch shape on the same
    mesh shape: one all_gather of a few ints over the (gloo) group."""
    mine = torch.tensor([*shape, mesh.dp, mesh.sp], dtype=torch.int64)
    every = [torch.empty_like(mine) for _ in range(mesh.world)]
    dist.all_gather(every, mine)
    if any(not torch.equal(t, mine) for t in every):
        raise ValueError("encode_batch_sharded: processes differ in batch "
                         "shape or mesh: "
                         + str([t.tolist() for t in every]))


def _rows(t: torch.Tensor, start: int, n: int, limit: int) -> torch.Tensor:
    """Rows [start, start + n) of t's dim 1, the rows past `limit` replaced
    by row limit - 1 (edge padding)."""
    if start + n <= limit:
        return t[:, start:start + n]
    idx = torch.arange(start, start + n, device=t.device).clamp(max=limit - 1)
    return t.index_select(1, idx)


def _psum(parts, device) -> torch.Tensor:
    """The sum over sp: each stripe's tensor moved to `device` and added."""
    total = parts[0].to(device)
    for p in parts[1:]:
        total = total + p.to(device)
    return total


@dataclasses.dataclass
class _Geometry:
    """Stripe geometry: whole MCU rows a stripe (`rows`), the real MCU rows
    of each stripe (`vrows`), the stripe-local index of a partial last MCU
    row (`crow`), and the words of each stripe's stream (`bucket`): the
    JAX sharded API's formula (a search's `target_value` adds room for its
    early high-quality passes), rounded up to 64 words for the stitch.
    The bucket only moves which images take the overflow fallback, never
    their bytes."""
    layout: pipeline.ComponentLayout
    sp: int
    rows: int
    stripe_h: int
    sub_h_partial: int
    vrows: list
    crow: list
    bucket: int

    @classmethod
    def of(cls, yuv_mode: int, w: int, h: int, sp: int,
           bits_per_pixel_budget: float, target_value=None):
        layout = pipeline.component_layout(yuv_mode, w, h)
        mcu_h = layout.block_h
        rows = -(-layout.mb_h // sp)
        sub_h = h - (layout.mb_h - 1) * mcu_h if h % mcu_h else 0
        vrows = [min(max(layout.mb_h - s * rows, 0), rows)
                 for s in range(sp)]
        crow = [(layout.mb_h - 1) - s * rows if sub_h else -1
                for s in range(sp)]
        per_img_blocks = layout.mb_w * rows * sp * sum(layout.nb_blocks)
        room = [1024, w * h * bits_per_pixel_budget / 32 / sp]
        if target_value is not None:
            room.append(target_value * 2 * 8 / 32 / sp + 4096)
        bucket = int(min(per_img_blocks // sp * pack.WORDS_PER_BLOCK,
                         max(room)))
        bucket = -(-bucket // pack.WORDS_PER_BLOCK) * pack.WORDS_PER_BLOCK
        return cls(layout, sp, rows, rows * mcu_h, sub_h, vrows, crow, bucket)

    def valid(self, s: int, blocks_per_row: int, b_l: int, device):
        """[b_l * rows * blocks_per_row] bool mask of the blocks of stripe s
        in real MCU rows, None when the stripe has no padding row."""
        if self.vrows[s] == self.rows:
            return None
        per = self.rows * blocks_per_row
        keep = torch.arange(per, device=device) < self.vrows[s] * (
            blocks_per_row)
        return keep.repeat(b_l)


class _Sharded:
    """One sharded encode, stage by stage (`stages()`); the JPEGs land in
    `out`.  Per stripe: `src` (its samples), `coeffs`, `state` (VLC
    fields, DC codes, groups), `streams`; per dp row: the sums, the
    tables and the stitched streams."""

    def __init__(self, rgbs, param: EncoderParam, mesh: Mesh, yuv_mode: int,
                 bits_per_pixel_budget: float, share_statistics: bool):
        self.param, self.mesh, self.share = param, mesh, share_statistics
        self.flags = method_flags(param.method)
        self.sharp = yuv_mode == C.YUV_SHARP
        self.yuv_mode = C.YUV_420 if self.sharp else yuv_mode
        src = rgbs if isinstance(rgbs, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(rgbs))
        if src.dtype != torch.uint8:
            raise TypeError(f"expected uint8 samples, got {src.dtype}")
        self.b_real, self.h, self.w = src.shape[:3]
        # pad to whole dp rows with copies of image 0 (outputs dropped)
        pad_b = -self.b_real % mesh.dp_local
        if pad_b:
            src = torch.cat([src, src[:1].expand(pad_b, *src.shape[1:])])
        self.src = src
        self.b_l = src.shape[0] // mesh.dp_local
        self.geo = _Geometry.of(self.yuv_mode, self.w, self.h, mesh.sp,
                                bits_per_pixel_budget)
        layout = self.geo.layout
        self.nb_blocks = tuple(layout.nb_blocks)
        self.n_groups = 2 if layout.nb_comps > 1 else 1
        self.fitted = None
        self.out = []

    def stages(self):
        return [self.coeffs, self.fit, self.quantize, self.tables,
                self.pack, self.stitch, self.fetch, self.tail]

    def _grid(self):
        """(row, stripe, device) over this process's grid."""
        for r, row in enumerate(self.mesh.devices):
            for s, dev in enumerate(row):
                yield r, s, dev

    def _images(self, r: int) -> slice:
        return slice(r * self.b_l, (r + 1) * self.b_l)

    def _stripe_sources(self, r: int):
        """Dp row r's images on its lead device -> each stripe's samples
        (RGB, or the sharp conversion's planes), edge-padded to whole MCU
        rows."""
        geo, h = self.geo, self.h
        row = self.src[self._images(r)].to(self.mesh.lead(r))
        if not self.sharp:
            return [_rows(row, s * geo.stripe_h, geo.stripe_h, h)
                    for s in range(geo.sp)]
        y, u, v = sharp_yuv.sharp_rgb_to_yuv420(row)
        half, ch = geo.stripe_h // 2, u.shape[1]
        return [(_rows(y, s * geo.stripe_h, geo.stripe_h, h),
                 _rows(u, s * half, half, ch), _rows(v, s * half, half, ch))
                for s in range(geo.sp)]

    # ---- stage 1: colour + fDCT (+ histograms) --------------------------
    def coeffs(self):
        geo, b_l = self.geo, self.b_l
        mb_w = geo.layout.mb_w
        self.coef = [[None] * geo.sp for _ in self.mesh.devices]
        self.histos = []
        for r, row in enumerate(self.mesh.devices):
            hl, hc = [], []
            for s, (x, dev) in enumerate(zip(self._stripe_sources(r), row)):
                x = (x.to(dev) if isinstance(x, torch.Tensor)
                     else tuple(p.to(dev) for p in x))
                blocks = _local_blocks(
                    x, "planes" if self.sharp else "rgb", self.yuv_mode,
                    self.w, geo.stripe_h, geo.rows, mb_w, geo.sub_h_partial,
                    geo.crow[s])
                co = [fdct.fdct_blocks(bl.contiguous()) for bl in blocks]
                self.coef[r][s] = co
                if not self.flags["use_adaptive_quant"]:
                    continue
                hl.append(quantize.store_histo(
                    co[0], b_l, geo.valid(s, mb_w * self.nb_blocks[0], b_l,
                                          dev)).reshape(b_l, 64, -1))
                if len(co) > 1:
                    vc = geo.valid(s, mb_w, b_l, dev)
                    hc.append((quantize.store_histo(co[1], b_l, vc)
                               + quantize.store_histo(co[2], b_l, vc)
                               ).reshape(b_l, 64, -1))
                else:
                    hc.append(torch.zeros_like(hl[-1]))
            if hl:
                self.histos.append(torch.stack([_psum(hl, row[0]),
                                                _psum(hc, row[0])]))

    # ---- the lambda fit, where the sums are -------------------------------
    def fit(self):
        """Each dp row's quantizer rows on its lead device (iquant, bias,
        quant, and for the trellis its rate lengths): one fit a dp row of
        its images' sums, or, with share_statistics or without adaptive
        quantization, one on the lead device that every row takes.  The
        quant rows (`fitted`) are read for the headers in the tail.
        Padding images are copies of image 0; their rows are never read."""
        mesh = self.mesh
        if self.flags["use_adaptive_quant"] and not self.share:
            fits = [engine._fit_on_device(tuple(t), self.param, self.flags,
                                          self.n_groups, False, mesh.lead(r))
                    for r, t in enumerate(self.histos)]
        else:
            fits = [engine._fit_on_device(
                self._batch_histos(), self.param, self.flags, self.n_groups,
                True, mesh.lead())]
        del self.histos
        self.fitted = [rows[2] for rows in fits]
        self.row_arrays = []
        for r in range(mesh.dp_local):
            lead = mesh.lead(r)
            rows = [a.to(lead) for a in fits[r % len(fits)]]
            if self.flags["use_trellis"]:
                rows += state.arrays_to_device(trellis_cost_lens(),
                                               device=lead)
            self.row_arrays.append(rows)

    def _batch_histos(self):
        """The real images' summed (luma, chroma) histograms on the lead
        device, or None without adaptive quantization."""
        if not self.flags["use_adaptive_quant"]:
            return None
        sums = [t[:, :max(0, self.b_real - r * self.b_l)].sum(
            1, dtype=torch.int32) for r, t in enumerate(self.histos)]
        total = _psum(sums, self.mesh.lead())
        return total[0], total[1]

    # ---- stage 2: quantize (or the trellis) + DC chains (+ frequencies) -
    def quantize(self):
        geo, b_l = self.geo, self.b_l
        with_stats = self.flags["optimize_size"]
        per_row = geo.layout.mb_w * sum(self.nb_blocks)
        self.state = [[None] * geo.sp for _ in self.mesh.devices]
        self.freqs = []
        for r, row in enumerate(self.mesh.devices):
            prev = [None] * len(self.nb_blocks)
            fdc, fac = [], []
            for s, dev in enumerate(row):
                co = self.coef[r][s]
                arrays = [a.to(dev) for a in self.row_arrays[r]]
                iq, ib = arrays[:2]
                dcq = engine._dc_quantized(co, iq, ib, b_l)
                codes = engine._interleave_dc(
                    [_dc_codes_sharded(d, p) for d, p in zip(dcq, prev)],
                    self.nb_blocks)
                if s + 1 < geo.sp:        # hand the last DCs down
                    prev = [d[:, -1].to(row[s + 1]) for d in dcq]
                valid = geo.valid(s, per_row, b_l, dev)
                if self.flags["use_trellis"]:
                    st, freqs = engine._stage_quantize_trellis(
                        co, *arrays, with_stats, self.nb_blocks, b_l, b_l,
                        dc_codes=codes, valid=valid)
                else:
                    st, freqs = engine._stage_batch_quantize(
                        co, iq, ib, with_stats, self.nb_blocks, b_l, b_l,
                        dc_codes=codes, valid=valid)
                self.state[r][s] = st
                if with_stats:
                    fdc.append(freqs[0].reshape(b_l, 2, -1))
                    fac.append(freqs[1].reshape(b_l, 2, -1))
            if with_stats:
                self.freqs.append((_psum(fdc, row[0]), _psum(fac, row[0])))
        del self.coef

    # ---- Huffman tables ---------------------------------------------------
    def tables(self):
        flags, mesh = self.flags, self.mesh
        b_local = self.b_l * mesh.dp_local
        self.desc = None
        if flags["optimize_size"] and not self.share:
            # per-image optimal tables on each lead device, no host read
            built = [engine._stage_tables(f, flags, self.n_groups, self.b_l,
                                          False, mesh.lead(r))
                     for r, f in enumerate(self.freqs)]
            self.luts = [bt[:2] for bt in built]
            self.desc = [bt[3] for bt in built]
            self.per_tables = None
        else:
            freqs = None
            if flags["optimize_size"]:    # one fetch a dp row
                both = torch.cat([torch.cat([d, a], dim=2).cpu()
                                  for d, a in self.freqs])[:self.b_real]
                freqs = (both[..., :12].sum(0), both[..., 12:].sum(0))
            dcl, acl, self.per_tables, _ = engine._stage_tables(
                freqs, flags, self.n_groups, b_local, True, mesh.lead())
            self.luts = [(dcl, acl)] * mesh.dp_local
        del self.freqs

    # ---- stage 3: VLC + pack + per-stripe compaction ----------------------
    def pack(self):
        geo, b_l = self.geo, self.b_l
        per_row = geo.layout.mb_w * sum(self.nb_blocks)
        self.streams = []
        for r, row in enumerate(self.mesh.devices):
            words, totals = [], []
            for s, dev in enumerate(row):
                dcl, acl = (t.to(dev) for t in self.luts[r])
                wd, tt = engine._stage_batch_pack(
                    self.state[r][s], dcl, acl, b_l, geo.bucket,
                    block_valid=geo.valid(s, per_row, b_l, dev))
                words.append(wd)
                totals.append(tt)
            self.streams.append((words, totals))

    # ---- the stitch: one stream_concat launch a dp row --------------------
    def stitch(self):
        self.stitched = []
        for r, (words, totals) in enumerate(self.streams):
            lead = self.mesh.lead(r)
            wd = torch.stack([x.to(lead) for x in words], dim=1)
            tt = torch.stack([x.to(lead) for x in totals], dim=1)
            iw, it = stitch_shard_streams(wd, tt)
            self.stitched.append((iw, torch.cat([tt, it[:, None]], dim=1)))
        del self.streams

    # ---- fetch: totals, stuffed scans and DHT descriptions, a dp row each -
    def fetch(self):
        """Per image: its stitched stream stuffed on the lead device and
        fetched with its stripes' totals (`engine.fetch_scans`), whether a
        stripe overflowed its bucket, and its Huffman tables."""
        self.scans, self.overflow = [], []
        self.host_tables = self.per_tables or []
        for r, (iw, tt) in enumerate(self.stitched):
            tt, scans = engine.fetch_scans(iw, tt)
            self.scans += scans
            self.overflow += list((tt[:, :-1] > self.geo.bucket * 32).any(1))
            if self.desc is not None:
                desc = self.desc[r].cpu().numpy()
                self.host_tables += [huffman_device.tables_from_flat(
                    desc, j, self.n_groups) for j in range(self.b_l)]
        del self.stitched

    # ---- host tail: markers; overflowing images re-packed ------------------
    def tail(self):
        n = self.b_real
        if self.fitted is not None:    # read after the totals' fetch
            self.per_qms = [
                m for q in self.fitted for m in engine._host_matrices(
                    q, self.param, self.b_l * self.mesh.dp_local)]
        self.out = engine._jpegs(
            self.geo.layout, self.param, self.per_qms[:n],
            self.host_tables[:n], self.scans, self.overflow,
            lambda i: self._repack(*divmod(i, self.b_l)))

    def _repack(self, r: int, j: int):
        """Scan bytes of image j of dp row r after a stripe overflowed its
        bucket: its real blocks' VLC state from every stripe, on the lead
        device, packed again by the one-device engine's `_repack_image`."""
        geo, lead = self.geo, self.mesh.lead(r)
        per_row = geo.layout.mb_w * sum(self.nb_blocks)
        parts = []
        for s, st in enumerate(self.state[r]):
            per_l = st[1].shape[0] // self.b_l
            rl, dc, grp = engine._state_rows(
                st, slice(j * per_l, j * per_l + geo.vrows[s] * per_row))
            parts.append(({k: v.to(lead) for k, v in rl.items()},
                          dc.to(lead), grp.to(lead)))
        state_i = ({k: torch.cat([p[0][k] for p in parts])
                    for k in parts[0][0]},
                   torch.cat([p[1] for p in parts]),
                   torch.cat([p[2] for p in parts]))
        return engine._repack_image(state_i, *self.luts[r], j)


class _ShardedSearch(_Sharded):
    """One sharded target-size / target-PSNR search, stage by stage
    (`stages()`); the JPEGs land in `out`.  The images' dichotomies are an
    engine_search._Search (`dich`: the hooks, each pass's matrices and
    lambda fits, the size results and the best-pass bookkeeping) over the
    real images; padding images take image 0's matrices and count
    nowhere.  The coefficients stay on their stripes' devices across the
    passes (`coef_all`); the size passes, the final pass and the tail run
    `_Sharded`'s stages."""

    def __init__(self, rgbs, param: EncoderParam, mesh: Mesh, yuv_mode: int,
                 bits_per_pixel_budget: float):
        super().__init__(rgbs, param, mesh, yuv_mode, bits_per_pixel_budget,
                         False)
        self.dich = engine_search._Search(
            self.src[:self.b_real], "rgb", self.yuv_mode, self.w, self.h,
            param, bits_per_pixel_budget)
        self.geo = _Geometry.of(
            self.yuv_mode, self.w, self.h, mesh.sp, bits_per_pixel_budget,
            param.target_value if self.dich.for_size else 0)
        self.passes_run = 0

    def stages(self):
        return [self.coeffs, self.fit, self.passes, self.final,
                self.quantize, self.tables, self.pack, self.stitch,
                self.fetch, self.tail]

    # ---- the histograms, one fetch a dp row -------------------------------
    def fit(self):
        """The hooks' lambda fits read each image's histograms every pass;
        padding images never count."""
        if self.flags["use_adaptive_quant"]:
            self.dich.histos = torch.cat(
                [t.cpu() for t in self.histos], dim=1)[:, :self.b_real] \
                .numpy().astype(np.int64)
            del self.histos
        self.coef_all = self.coef

    def _upload(self, per_qms, lens=None):
        """The real images' finalized matrices (padding images take image
        0's) -> each dp row's iquant, bias and quant on its lead device,
        and for the trellis its [b_l, 2, 256] rate tables."""
        per_qms = per_qms + per_qms[:1] * (
            self.b_l * self.mesh.dp_local - self.b_real)
        host = [np.stack([[q[k] for q in qms] for qms in per_qms]).astype(
            np.int32) for k in ("iquant", "bias", "quant")]
        self.row_arrays = [
            [*state.arrays_to_device(*(a[self._images(r)] for a in host),
                                     device=self.mesh.lead(r)),
             *([lens[r]] if lens is not None else [])]
            for r in range(self.mesh.dp_local)]

    def _row_flags(self, flags, r: int) -> list:
        """Dp row r's slice of per-real-image flags, False for padding."""
        sl = self._images(r)
        return (flags[sl] + [False] * self.b_l)[:self.b_l]

    def _cost_lens(self) -> list:
        """The trellis's starting rate tables (the K.3 AC code lengths),
        [b_l, 2, 256] on each dp row's lead device."""
        return [state.arrays_to_device(np.broadcast_to(
            trellis_cost_lens(), (self.b_l, 2, 256)),
            device=self.mesh.lead(r))[0] for r in range(self.mesh.dp_local)]

    # ---- the passes ---------------------------------------------------------
    def passes(self):
        d = self.dich
        if self.flags["use_trellis"] and d.for_size:
            self.lens = self._cost_lens()
            self.lens_prev = list(self.lens)
        for pc in range(d.passes):
            per_qms = d.pass_matrices()
            results = (self._size_pass(per_qms) if d.for_size
                       else self._psnr_pass(per_qms))
            self.passes_run += 1
            if d.record(pc, results, per_qms):
                break

    def _size_pass(self, per_qms) -> list:
        """Every image's exact JPEG size at per_qms: the single-shot
        stages from quantize to the stitch, then the stuffing of the
        stitched words; one fetch a dp row."""
        d, trellis = self.dich, self.flags["use_trellis"]
        self._upload(per_qms, self.lens if trellis else None)
        self.coef = self.coef_all
        self.quantize()
        self.tables()
        if trellis:
            searching = d.searching()
            for r, (_, acl) in enumerate(self.luts):
                self.lens[r], self.lens_prev[r] = \
                    engine_search._evolve_rate_tables(
                        self.lens[r], self.lens_prev[r], acl,
                        self._row_flags(searching, r))
        self.pack()
        self.stitch()
        evs = []
        for r, (iw, tt) in enumerate(self.stitched):
            rows = [tt[:, -1].to(torch.int64),
                    engine_search._stage_count_stuffing_batch(iw, tt[:, -1])]
            if self.desc is not None:                  # nb_syms, 4 tables
                rows += list(self.desc[r][:, :4].to(torch.int64).t())
            rows.append(tt[:, :-1].max(dim=1).values.to(torch.int64))
            evs.append(torch.stack(rows).cpu())
        del self.stitched
        ev = torch.cat(evs, dim=1)[:, :self.b_real].numpy()
        return d.size_results(ev[:-1], ev[-1] <= self.geo.bucket * 32)

    def _psnr_pass(self, per_qms) -> list:
        """Every image's PSNR at per_qms: the exact squared error of each
        stripe's real blocks, summed over sp in int64 on the lead device;
        one fetch a dp row."""
        self._upload(per_qms)
        return [get_psnr(int(e), 64 * self.dich.n_blocks_img)
                for e in self.stripe_errors()[:self.b_real]]

    def stripe_errors(self) -> np.ndarray:
        """[b_l * dp_local] int64 squared error of each image at the
        uploaded matrices, over its stripes' real blocks."""
        mb_w, b_l = self.geo.layout.mb_w, self.b_l
        errs = []
        for r, row in enumerate(self.mesh.devices):
            parts = []
            for s, dev in enumerate(row):
                iq, ib, qq = (a.to(dev) for a in self.row_arrays[r][:3])
                valid = [self.geo.valid(s, mb_w * nb, b_l, dev)
                         for nb in self.nb_blocks]
                parts.append(engine_search._batch_qerr(
                    self.coef_all[r][s], iq, ib, qq, b_l, valid))
            errs.append(_psum(parts, row[0]).cpu())
        return torch.cat(errs).numpy()

    # ---- the final pass at each image's best matrices ---------------------
    def final(self):
        """Each image's best matrices (an image past its bucket stands in
        with the param's, unused), and for the trellis its final rate
        tables, ready for the single-shot stages."""
        d = self.dich
        base = engine._quant_matrices(self.param)
        self.per_qms = [base if over or opt is None else d.finalize(opt)
                        for opt, over in zip(d.opt, d.overflow)]
        lens = None
        if self.flags["use_trellis"] and d.for_size:
            lens = [engine_search._final_rate_tables(
                self.lens[r], self.lens_prev[r],
                self._row_flags(d.last_best, r))
                for r in range(self.mesh.dp_local)]
        elif self.flags["use_trellis"]:
            lens = self._cost_lens()
        self._upload(self.per_qms, lens)
        self.coef = self.coef_all

    # ---- host tail: markers; overflowing images searched alone -------------
    def tail(self):
        d = self.dich
        self.out = [self._fallback(i) if d.overflow[i] or self.overflow[i]
                    else d.assemble(self.per_qms[i], self.host_tables[i],
                                    self.scans[i])
                    for i in range(self.b_real)]

    def _fallback(self, i: int) -> bytes:
        """Image i, whose stripe outgrew its bucket in some pass, searched
        again alone on its dp row's lead device."""
        one = self.src[i:i + 1].to(self.mesh.lead(i // self.b_l))
        return engine_search.search_alone(one, "rgb", self.yuv_mode, self.w,
                                          self.h, self.param)
