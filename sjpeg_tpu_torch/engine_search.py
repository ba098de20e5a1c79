"""Batched target-size / target-PSNR search on the GPU.

The counterpart of sjpeg_tpu.engine._encode_batch_search: B independent
dichotomies (the reference's LoopScan, src/dichotomy.cc:106-192, run per
image with the default bisection hook) share one batched pass at a time
over coefficients computed once, and give the bytes of a per-image search.
`engine._encode_batch_src` enters it when passes > 1 and a target is set.
It takes one of three routes, as the JAX engine does:

1. Size, device loop (no trellis, 2 <= passes <= 8).  The host tabulates
   the candidate matrices of every node of the bisection tree
   (dichotomy.build_q_tree; with adaptive quantization tuned per image by
   adaptive.analyse_histo_nodes), and the card runs the passes with only
   integer decisions (`_stage_search_loop_size`):

     colour, fDCT, int16 samples, histograms _stage_search_prep [torch]
     per pass: the node's quantizers         _derive_quant_arrays
       DC chain                              engine._dc_codes
       quantize + symbol frequencies         engine._stage_batch_quantize,
                                             ops/vlc_fields [CUDA kernel 10]
       per-image optimal tables              ops/huffman_device
       fDCT + quantize + VLC + pack with
         per-image tables                    ops/sample_pack [CUDA kernel 1]
       per-image stream concatenation        ops/stream_concat [kernel 2]
       stuffing count, exact size, decision  _stage_count_stuffing_batch
     one fetch of the trace, float64 replay  dichotomy.replay_search_trace
     the winning pass's streams, stuffed     ops/scan_stuff [kernel 11]
     fetch of the scans, assembly            [host]

   The loop leaves after the first pass in which every image's hook has
   converged (one host read a pass).
2. PSNR, device loop: the per-image exact squared error of every pass
   (`_stage_search_loop_psnr`, `_batch_qerr`), the replay, then one final
   pass at each image's best matrices (`_Search.final_pass`, vlc_pack).
3. Pass by pass with the hooks on the host (trellis, or passes > 8,
   sjpeg's default of 10): each pass is the staged encode of
   engine._encode_batch_optimized at each image's matrices; method 7's
   per-image rate tables evolve on the card (ops/trellis with [B, 2, 256]
   tables).  Then the final pass.

An image whose stream outgrows the bucket, or whose device decision
disagrees with the float hook, is searched again alone through route 3
with a bucket of 64 words a block, which cannot overflow
(`search_alone`).  On the CPU the same routes run with the kernels' plain
versions.  The sharded search (parallel/api._ShardedSearch) runs route 3
over a mesh with `_Search`'s hooks, matrices and bookkeeping.

`encode_search_one` is the single-image search of engine.encode_rgb (and
the gray and planar entry points): one pass at a time with the hook on the
host, which is how a custom `param.search_hook` runs, in a batch too.
"""

import math
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from . import engine, pipeline, spec, state
from . import constants as C
from .adaptive import analyse_histo_nodes
from .dichotomy import (build_q_conv_table, build_q_tree, get_psnr,
                        header_size_bits, header_size_bits_nbsyms,
                        psnr_err_threshold, psnr_tolerance_range,
                        replay_search_trace, size_tolerance_range)
from .huffman import k3_default_tables, trellis_cost_lens
from .ops import (colorspace, fdct, huffman_device, lambda_fit, pack,
                  quantize, sample_pack, stream_concat)
from .params import (TARGET_SIZE, EncoderParam, SearchHook, method_flags,
                     quant_matrices_for_quality)
from .tools import estimate_quality

_INT32_MAX = 0x7FFFFFFF


def _stage_count_stuffing_batch(words, totals):
    """Per-image number of 0xFF bytes among each stream's complete bytes
    (the reference BitCounter's stuffing model: the trailing partial byte
    never counts): [B, W] int32 words + [B] bits -> [B] int64."""
    word_idx = torch.arange(words.shape[1], device=words.device)[None, :]
    n_bytes = (totals.to(torch.int64) // 8)[:, None]
    cnt = torch.zeros(words.shape[0], dtype=torch.int64, device=words.device)
    for k in range(4):
        byte = (words >> (24 - 8 * k)) & 0xFF
        cnt += ((byte == 0xFF) & (word_idx * 4 + k < n_bytes)).sum(dim=1)
    return cnt


def _stage_eval_size_batch(words, totals):
    """[2, B] int64 (total scan bits, stuffing bytes): one fetch a pass."""
    return torch.stack([totals.to(torch.int64),
                        _stage_count_stuffing_batch(words, totals)])


def _stage_eval_size_nbs(words, totals, nbs):
    """[6, B] int64: `_stage_eval_size_batch` and the four tables' symbol
    counts, which feed the header size model, in one fetch."""
    return torch.cat([_stage_eval_size_batch(words, totals),
                      nbs.t().to(torch.int64)])


def _derive_quant_arrays(q_u8, q_bias: int):
    """[..., 2, 64] quant matrices (already clamped to min_quant) ->
    (iquant, bias) int32: the integer arithmetic of
    spec.finalize_quant_matrix."""
    q = q_u8.to(torch.int32).clamp(min=1)
    is_one = q == 1
    iq = torch.where(is_one, 0xFFFF, ((1 << C.FP_BITS) + q // 2) // q)
    bias = torch.full_like(q, q_bias)
    bias[..., 0] = C.BIAS_DC
    bias = torch.where(is_one, 0x80, bias)
    ib = (((bias * q) << C.AC_BITS) + 128) >> 8
    return iq.to(torch.int32), ib.to(torch.int32)


def _batch_qerr(coeffs, iq3, ib3, q3, n_images: int, valid=None):
    """Per-image exact squared quantization error (the PSNR search's
    value): per-component [N, 64] coefficients (image-major) against
    [B, 2, 64] per-image iquant, bias and quant -> [B] int64.  `valid`:
    optional per-component [N] bool masks (or None entries); blocks with
    False count no error (the padding blocks of a ragged stripe)."""
    err = 0
    for c, coef in enumerate(coeffs):
        g = 0 if c == 0 else 1
        rows = [t[:, None, g, :].to(torch.int64) for t in (iq3, ib3, q3)]
        e = quantize.quantize_error(coef.reshape(n_images, -1, 64), *rows)
        if valid is not None and valid[c] is not None:
            e = torch.where(valid[c].reshape(n_images, -1), e, 0)
        err = err + e.sum(dim=1)
    return err


def _stage_search_prep(src, src_kind: str, yuv_mode: int, width: int,
                       height: int, nb_blocks, n_images: int,
                       with_histo: bool, with_samples: bool):
    """Pass-independent state: per-component fDCT coefficients (int32),
    with `with_samples` the MCU-interleaved int16 samples and their table
    groups for sample_pack, with `with_histo` the (luma, chroma)
    histograms."""
    if src_kind == "planes":
        blocks = colorspace.planes_to_blocks(src, yuv_mode, width, height)
    else:
        blocks = colorspace.rgb_to_blocks(src, yuv_mode, width, height)
    prep = {"coeffs": [fdct.fdct_blocks(b) for b in blocks]}
    if with_samples:
        n_mcu = blocks[0].shape[0] // nb_blocks[0]
        prep["sinter"] = torch.cat(
            [b.to(torch.int16).reshape(n_mcu, nb, 64)
             for b, nb in zip(blocks, nb_blocks)], dim=1).reshape(-1, 64)
        prep["group"] = engine._slot_groups(nb_blocks, n_mcu,
                                            blocks[0].device)
    if with_histo:
        prep["histos"] = engine._coeff_histos(prep["coeffs"], n_images)
    return prep


def _fused_pack_from_samples(sinter, dc_codes, group, iq3, ib3, dcl3, acl3,
                             n_images: int, bucket: int):
    """Per-image-table fDCT + quantize + VLC + pack from the cached
    samples, then the per-image concatenation -> ([B, bucket] int32 words,
    [B] int32 exact totals)."""
    words, bits = sample_pack.sample_pack(sinter, dc_codes, group, iq3, ib3,
                                          dcl3, acl3)
    return stream_concat.stream_concat(words, bits, n_images, bucket)


def _stage_search_pass(coeffs, iq3, ib3, nb_blocks, n_images: int,
                       n_groups: int, bucket: int):
    """One pass-by-pass size evaluation with per-image optimal tables:
    quantize once, per-image tables on the card, pack -> (words, totals,
    [6, B] evaluation)."""
    vlc_state, freqs = engine._stage_batch_quantize(
        coeffs, iq3, ib3, True, nb_blocks, n_images, n_images)
    dcl, acl, nbs, _ = huffman_device.luts_and_desc_from_freqs(
        freqs[0].reshape(n_images, 2, -1), freqs[1].reshape(n_images, 2, -1),
        n_groups)
    words, totals = engine._stage_batch_pack(vlc_state, dcl, acl, n_images,
                                             bucket)
    return words, totals, _stage_eval_size_nbs(words, totals, nbs)


def _node_quants(quants_nodes, node, per_image_mats: bool):
    """Each image's [2, 64] matrices at its tree node: [B, 2, 64]."""
    if per_image_mats:
        return quants_nodes[torch.arange(node.shape[0],
                                         device=node.device), node]
    return quants_nodes[node]


def _stage_search_loop_size(prep, quants_nodes, thr: int, conv_lo: int,
                            conv_hi: int, conv_tbl, dcl_def, acl_def,
                            passes: int, nb_blocks, n_images: int,
                            n_groups: int, bucket: int, optimize_size: bool,
                            hdr_fixed_bits: int, q_bias: int,
                            per_image_mats: bool):
    """The target-size dichotomy of every image on the card, walking the
    host's tree of candidate matrices (quants_nodes: [B, K, 2, 64] with
    per_image_mats, else [K, 2, 64], K = 2^passes - 1).

    Each pass evaluates each image's exact JPEG size in bits (header model
    + scan + stuffing) and branches on the integer form of the hook's
    `value > target` (bits >= thr = floor(8 * target) + 1).  An image is
    done when its bits fall in the tolerance range [conv_lo, conv_hi] or
    its bracket converges (conv_tbl [K, 2], per node and decision); the
    loop stops after the first pass that leaves every image done.  A pass
    whose stream outgrows the bucket records INT32_MAX.

    Returns (trace [P, B] int64 bits, totals [P, B] int32 scan bits,
    desc [P, B, 604] int32 DHT descriptions or None, words
    [P, B, bucket] int32, passes run); rows of passes not run stay 0."""
    coeffs = prep["coeffs"]
    dev = coeffs[0].device
    B = n_images
    qn_all = torch.from_numpy(quants_nodes.astype(np.int32)).to(dev)
    conv = torch.from_numpy(conv_tbl).to(dev)
    path = torch.zeros(B, dtype=torch.int64, device=dev)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    trace = torch.zeros((passes, B), dtype=torch.int64, device=dev)
    totals_all = torch.zeros((passes, B), dtype=torch.int32, device=dev)
    words_all = torch.zeros((passes, B, bucket), dtype=torch.int32,
                            device=dev)
    desc_all = (torch.zeros((passes, B, 604), dtype=torch.int32, device=dev)
                if optimize_size else None)
    if not optimize_size:
        dcl = dcl_def.expand(B, 2, 16).contiguous()
        acl = acl_def.expand(B, 2, 256).contiguous()
        nb_sum = 0
    run = 0
    for p in range(passes):
        if p and not bool(active.any()):
            break
        run += 1
        node = (1 << p) - 1 + path
        iq3, ib3 = _derive_quant_arrays(
            _node_quants(qn_all, node, per_image_mats), q_bias)
        dc_codes = engine._dc_codes(coeffs, iq3, ib3, nb_blocks, B)
        if optimize_size:
            _, freqs = engine._stage_batch_quantize(
                coeffs, iq3, ib3, True, nb_blocks, B, B, dc_codes=dc_codes)
            dcl, acl, nbs, desc = huffman_device.luts_and_desc_from_freqs(
                freqs[0].reshape(B, 2, -1), freqs[1].reshape(B, 2, -1),
                n_groups)
            desc_all[p] = huffman_device.desc_to_flat(nbs, desc)
            nb_sum = (nbs[:, 0] + nbs[:, 2] if n_groups == 1
                      else nbs.sum(dim=1)).to(torch.int64)
        words, totals = _fused_pack_from_samples(
            prep["sinter"], dc_codes, prep["group"], iq3, ib3, dcl, acl, B,
            bucket)
        ok = totals <= bucket * 32
        bits = (hdr_fixed_bits + 8 * nb_sum + totals.to(torch.int64)
                + 8 * _stage_count_stuffing_batch(words, totals))
        bits = torch.where(ok, bits, _INT32_MAX)
        d = (bits >= thr).to(torch.int64)
        tol_hit = ok & (bits >= conv_lo) & (bits <= conv_hi)
        active = active & ~(tol_hit | (conv[node, d] > 0)) & ok
        trace[p], totals_all[p], words_all[p] = bits, totals, words
        path = path * 2 + d
    return trace, totals_all, desc_all, words_all, run


def _stage_search_loop_psnr(coeffs, quants_nodes, err_thr: int,
                            zero_d: int, tol_range, zero_tol: bool,
                            conv_tbl, passes: int, n_images: int,
                            q_bias: int, per_image_mats: bool):
    """The target-PSNR dichotomy of every image on the card: per pass one
    exact squared error per image; the hook's `value > target` is
    err <= err_thr, and err == 0 (PSNR 99) decides zero_d.  Done and
    early exit as in `_stage_search_loop_size`, with tol_range the
    (lo, hi) errors inside the tolerance and zero_tol whether err == 0
    is.  Returns the [P, B] int64 error trace."""
    dev = coeffs[0].device
    B = n_images
    qn_all = torch.from_numpy(quants_nodes.astype(np.int32)).to(dev)
    conv = torch.from_numpy(conv_tbl).to(dev)
    lo, hi = tol_range
    path = torch.zeros(B, dtype=torch.int64, device=dev)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    trace = torch.zeros((passes, B), dtype=torch.int64, device=dev)
    for p in range(passes):
        if p and not bool(active.any()):
            break
        node = (1 << p) - 1 + path
        qn = _node_quants(qn_all, node, per_image_mats)
        iq3, ib3 = _derive_quant_arrays(qn, q_bias)
        err = _batch_qerr(coeffs, iq3, ib3, qn.clamp(min=1), B)
        zero = err == 0
        d = torch.where(zero, zero_d, (err <= err_thr).to(torch.int64))
        tol_hit = torch.where(zero, torch.full_like(zero, zero_tol),
                              (err >= lo) & (err <= hi))
        active = active & ~(tol_hit | (conv[node, d] > 0))
        trace[p] = err
        path = path * 2 + d
    return trace


def _evolve_rate_tables(lens, lens_prev, acl, searching):
    """Method 7's per-image [B, 2, 256] rate tables after a size pass, as
    the reference's persistent ac_codes_ arrays evolve (src/dichotomy.cc:
    83-85, 144): the images still searching (`searching`, [B] bools) keep
    their entry tables in lens_prev, and their present symbols take the
    pass's new code lengths (acl: its [B, 2, 256] LUTs); the others keep
    both.  -> (lens, lens_prev)."""
    upd = torch.tensor(searching, device=lens.device)[:, None, None]
    lens_prev = torch.where(upd, lens, lens_prev)
    new_lens = acl & 0xFF
    return torch.where(upd & (new_lens > 0), new_lens, lens), lens_prev


def _final_rate_tables(lens, lens_prev, last_best):
    """The final pass's rate tables: an image whose best pass was its last
    reuses that pass's entry tables (the reference keeps the run-levels it
    quantized before the pass's table update)."""
    last = torch.tensor(last_best, device=lens.device)[:, None, None]
    return torch.where(last, lens_prev, lens)


def search_alone(one, src_kind: str, yuv_mode: int, w: int, h: int,
                 param: EncoderParam) -> bytes:
    """One image (a batch of one on its device) searched alone, pass by
    pass, with a bucket of 64 words a block, which cannot overflow: the
    port's rule for an image whose stream outgrew its bucket (the JAX
    engine runs its host search there)."""
    return _Search(one, src_kind, yuv_mode, w, h, param, math.inf,
                   per_pass=True).run()[0]


class _Search:
    """One batched search: its configuration, its per-image hooks and the
    steps of its three routes (see the module docstring)."""

    def __init__(self, src, src_kind: str, yuv_mode: int, w: int, h: int,
                 param: EncoderParam, bits_per_pixel_budget: float,
                 per_pass: bool = False):
        self.src, self.src_kind, self.yuv_mode = src, src_kind, yuv_mode
        self.w, self.h, self.param = w, h, param
        self.flags = method_flags(param.method)
        self.b = src.shape[0] if src_kind == "rgb" else src[0].shape[0]
        self.device = src.device if src_kind == "rgb" else src[0].device
        self.layout = pipeline.component_layout(yuv_mode, w, h)
        self.nb_blocks = tuple(self.layout.nb_blocks)
        self.n_groups = 2 if self.layout.nb_comps > 1 else 1
        self.n_blocks_img = engine._blocks_per_image(self.layout)
        self.min_qmats = param.resolved_min_quant_matrices()
        self.defaults = k3_default_tables()
        self.for_size = param.target_mode == TARGET_SIZE
        self.passes = min(max(param.passes, 1), 20)
        self.per_pass = per_pass
        self.device_loop = (not per_pass and not self.flags["use_trellis"]
                            and 2 <= self.passes <= 8)
        self.initial_q = min(max(estimate_quality(
            param.resolved_quant_matrices()[0]), 0.0), 100.0)
        self.hooks = []
        for _ in range(self.b):
            hook = SearchHook()
            hook.setup(param, self.initial_q)
            self.hooks.append(hook)
        # room for the early high-quality passes on top of the pixel budget
        self.bucket = int(min(
            self.n_blocks_img * pack.WORDS_PER_BLOCK,
            max(4096, w * h * bits_per_pixel_budget / 32,
                (param.target_value * 2 * 8) / 32 + 4096)))
        self.prep = self.histos = None
        # pass-by-pass bookkeeping (route 3, and the sharded search's)
        self.best = [0.0] * self.b
        self.opt = [None] * self.b
        self.done = [False] * self.b
        self.overflow = [False] * self.b
        self.last_best = [False] * self.b

    # ---- shared steps ---------------------------------------------------

    def stage_prep(self):
        """The coefficients (+ samples, histograms) on the card; one fetch
        of the histograms."""
        adaptive = self.flags["use_adaptive_quant"]
        self.prep = _stage_search_prep(
            self.src, self.src_kind, self.yuv_mode, self.w, self.h,
            self.nb_blocks, self.b, adaptive,
            self.device_loop and self.for_size)
        if adaptive:
            self.histos = torch.stack(self.prep.pop("histos")).cpu().numpy() \
                .astype(np.int64).reshape(2, self.b, 64, -1)

    def node_matrices(self):
        """The candidate matrices of every tree node: ([K, 2, 64] uint8,
        False), or ([B, K, 2, 64], True) tuned per image."""
        p = self.param
        tree_q = build_q_tree(p, self.initial_q, self.passes)
        base = np.stack([quant_matrices_for_quality(q) for q in tree_q])
        minq = np.stack(list(self.min_qmats)).astype(np.int64)
        clamped = np.maximum(base.astype(np.int64), minq[None])
        if not self.flags["use_adaptive_quant"]:
            return clamped.astype(np.uint8), False
        K = clamped.shape[0]
        tuned_l = analyse_histo_nodes(
            self.histos[0], clamped[:, 0].astype(np.uint8), self.min_qmats[0],
            p.qdelta_max_luma)
        tuned_c = (analyse_histo_nodes(
            self.histos[1], clamped[:, 1].astype(np.uint8),
            self.min_qmats[1], p.qdelta_max_chroma) if self.n_groups > 1
            else np.broadcast_to(clamped[None, :, 1], (self.b, K, 64)))
        tuned = np.stack([tuned_l, tuned_c], axis=2).astype(np.int64)
        return np.maximum(tuned, minq[None, None]).astype(np.uint8), True

    def finalize(self, quants):
        """[2] raw matrices -> finalized quant dicts."""
        return [spec.finalize_quant_matrix(quants[g], self.min_qmats[g],
                                           self.param.quantization_bias)
                for g in range(2)]

    def make_qms(self, i: int):
        """Image i's pass matrices from its hook (+ its lambda fit)."""
        qms = self.finalize(self.hooks[i].next_matrices())
        if not self.flags["use_adaptive_quant"]:
            return qms
        p = self.param
        return lambda_fit.fit_image(
            self.histos[:, i], np.stack([qms[0]["quant"], qms[1]["quant"]]),
            self.min_qmats, (p.qdelta_max_luma, p.qdelta_max_chroma),
            p.quantization_bias, self.n_groups)

    def pass_matrices(self):
        """Every image's matrices for the next pass, its lambda fit
        threaded over the images (the NumPy fit releases the GIL)."""
        with ThreadPoolExecutor(max_workers=min(8, self.b)) as pool:
            return list(pool.map(self.make_qms, range(self.b)))

    def quant_arrays(self, per_qms, keys=("iquant", "bias")):
        """Per-image finalized matrices -> [B, 2, 64] int32 tensors."""
        return state.arrays_to_device(
            *(np.stack([[q[k] for q in qms] for qms in per_qms])
              for k in keys), device=self.device)

    def fallback(self, i: int) -> bytes:
        """Image i searched again alone (`search_alone`)."""
        if self.per_pass:             # its bucket is already the worst case
            raise RuntimeError("a worst-case bucket overflowed")
        one = (self.src[i:i + 1] if self.src_kind == "rgb"
               else tuple(p[i:i + 1] for p in self.src))
        return search_alone(one, self.src_kind, self.yuv_mode, self.w,
                            self.h, self.param)

    def assemble(self, qms, tables, scan):
        return engine._assemble_jpeg(self.layout, self.param, qms, tables,
                                     scan)

    def run(self):
        self.stage_prep()
        if self.device_loop and self.for_size:
            return self.size_device()
        if self.device_loop:
            return self.final_pass(*self.psnr_device())
        return self.final_pass(*self.pass_by_pass())

    # ---- route 1: size, device loop -------------------------------------

    def size_loop(self, nodes):
        """Run `_stage_search_loop_size`; returns its outputs and thr."""
        p = self.param
        quants_nodes, per_image_mats = nodes
        optimize = self.flags["optimize_size"]
        nb_comps = self.layout.nb_comps
        hdr_fixed = (header_size_bits_nbsyms(p, nb_comps, [0, 0, 0, 0])
                     if optimize else
                     header_size_bits(p, nb_comps, self.defaults))
        clamp = lambda v: min(max(v, -(2 ** 31)), 2 ** 31 - 1)  # noqa: E731
        thr = clamp(int(np.floor(8.0 * p.target_value)) + 1)
        conv_lo, conv_hi = (clamp(v) for v in size_tolerance_range(p))
        dcl_def, acl_def = state.arrays_to_device(
            *engine._host_luts(self.defaults), device=self.device)
        loop = _stage_search_loop_size(
            self.prep, quants_nodes, thr, conv_lo, conv_hi,
            build_q_conv_table(p, self.initial_q, self.passes), dcl_def,
            acl_def, self.passes, self.nb_blocks, self.b, self.n_groups,
            self.bucket, optimize, int(hdr_fixed),
            int(p.quantization_bias), per_image_mats)
        return loop, thr

    @staticmethod
    def fetch_size_trace(loop):
        """One fetch of the trace, the scan totals and the descriptions:
        [P, B, 2 (+ 604)] int64."""
        trace, totals_all, desc_all = loop[:3]
        parts = [trace[:, :, None], totals_all[:, :, None].to(torch.int64)]
        if desc_all is not None:
            parts.append(desc_all.to(torch.int64))
        return torch.cat(parts, dim=2).cpu().numpy()

    def replay_size(self, nodes, combo, thr: int):
        """Each image's float64 hook over its fetched trace -> (best pass
        [B], best matrices [B] or None where the image falls back)."""
        quants_nodes, per_image_mats = nodes
        best_pass = np.zeros(self.b, np.int64)
        opt = [None] * self.b
        for i in range(self.b):
            col = combo[:, i, 0]
            if (col == _INT32_MAX).any():
                continue
            vals = [float(np.float32(int(v) / 8.0)) for v in col]
            decs = [1 if int(v) >= thr else 0 for v in col]
            best_node, ok = replay_search_trace(vals, decs, self.param,
                                                self.hooks[i])
            if ok:
                opt[i] = (quants_nodes[i, best_node] if per_image_mats
                          else quants_nodes[best_node])
                best_pass[i] = (best_node + 1).bit_length() - 1
        return best_pass, opt

    def pick_streams(self, loop, combo, best_pass):
        """The winning pass's streams: a gather on the card, stuffed there,
        and the fetches of `engine.fetch_scans` -> (B stuffed scans,
        totals [B], DHT descriptions [B, 604] or None)."""
        bi = np.arange(self.b)
        desc = combo[best_pass, bi, 2:] if combo.shape[2] > 2 else None
        pick = (torch.from_numpy(best_pass).to(self.device),
                torch.arange(self.b, device=self.device))
        totals, scans = engine.fetch_scans(loop[3][pick], loop[1][pick])
        return scans, totals, desc

    def size_device(self):
        nodes = self.node_matrices()
        loop, thr = self.size_loop(nodes)
        combo = self.fetch_size_trace(loop)
        best_pass, opt = self.replay_size(nodes, combo, thr)
        scans, totals, desc = self.pick_streams(loop, combo, best_pass)
        return self.size_tail(opt, scans, totals, desc)

    def size_tail(self, opt, scans, totals, desc):
        out = []
        for i in range(self.b):
            if opt[i] is None or totals[i] > self.bucket * 32:
                out.append(self.fallback(i))
                continue
            tables = (huffman_device.tables_from_flat(desc, i, self.n_groups)
                      if desc is not None else self.defaults)
            out.append(self.assemble(self.finalize(opt[i]), tables,
                                     scans[i]))
        return out

    # ---- route 2: PSNR, device loop -------------------------------------

    def psnr_device(self):
        """-> (best matrices [B] or None, no rate tables)."""
        p = self.param
        quants_nodes, per_image_mats = self.node_matrices()
        size_img = 64 * self.n_blocks_img
        err_thr = psnr_err_threshold(p.target_value, size_img)
        zero_d = 1 if 99.0 > p.target_value else 0
        lo, hi, zero_tol = psnr_tolerance_range(p, size_img)
        trace = _stage_search_loop_psnr(
            self.prep["coeffs"], quants_nodes, err_thr, zero_d, (lo, hi),
            zero_tol, build_q_conv_table(p, self.initial_q, self.passes),
            self.passes, self.b, int(p.quantization_bias),
            per_image_mats).cpu().numpy()
        opt = [None] * self.b
        for i in range(self.b):
            errs = [int(e) for e in trace[:, i]]
            vals = [get_psnr(e, size_img) for e in errs]
            decs = [zero_d if e == 0 else int(e <= err_thr) for e in errs]
            best_node, ok = replay_search_trace(vals, decs, p, self.hooks[i])
            if ok:
                opt[i] = (quants_nodes[i, best_node] if per_image_mats
                          else quants_nodes[best_node])
        return opt, None

    # ---- route 3: pass by pass ------------------------------------------

    def pass_by_pass(self):
        """The hooks on the host, one batched evaluation a pass -> (best
        matrices [B] or None, the trellis's final rate tables or None)."""
        b, flags = self.b, self.flags
        coeffs, nb = self.prep["coeffs"], self.nb_blocks
        trellis = flags["use_trellis"]
        optimize = flags["optimize_size"]
        if trellis:
            lens = state.arrays_to_device(np.broadcast_to(
                trellis_cost_lens(), (b, 2, 256)), device=self.device)[0]
            lens_prev = lens
        if not optimize:
            dcl_def, acl_def = state.arrays_to_device(
                *engine._host_luts(self.defaults), device=self.device)
        for pc in range(self.passes):
            per_qms = self.pass_matrices()
            iq3, ib3 = self.quant_arrays(per_qms)
            if self.for_size:
                if trellis:
                    (qq3,) = self.quant_arrays(per_qms, ("quant",))
                    vlc_state, freqs = engine._stage_quantize_trellis(
                        coeffs, iq3, ib3, qq3, lens, True, nb, b, b)
                    dcl, acl, nbs, _ = \
                        huffman_device.luts_and_desc_from_freqs(
                            freqs[0].reshape(b, 2, -1),
                            freqs[1].reshape(b, 2, -1), self.n_groups)
                    lens, lens_prev = _evolve_rate_tables(
                        lens, lens_prev, acl, self.searching())
                    words, totals = engine._stage_batch_pack(
                        vlc_state, dcl, acl, b, self.bucket)
                    ev = _stage_eval_size_nbs(words, totals, nbs)
                elif optimize:
                    _, _, ev = _stage_search_pass(coeffs, iq3, ib3, nb, b,
                                                  self.n_groups, self.bucket)
                else:
                    vlc_state, _ = engine._stage_batch_quantize(
                        coeffs, iq3, ib3, False, nb, b, b)
                    words, totals = engine._stage_batch_pack(
                        vlc_state, dcl_def, acl_def, b, self.bucket)
                    ev = _stage_eval_size_batch(words, totals)
                results = self.size_results(ev.cpu().numpy())
            else:
                (q3,) = self.quant_arrays(per_qms, ("quant",))
                err = _batch_qerr(coeffs, iq3, ib3, q3, b).cpu().numpy()
                results = [get_psnr(int(e), 64 * self.n_blocks_img)
                           for e in err]
            if self.record(pc, results, per_qms):
                break
        opt = [None if self.overflow[i] else self.opt[i] for i in range(b)]
        if not trellis:
            return opt, None
        if not self.for_size:
            return opt, lens
        return opt, _final_rate_tables(lens, lens_prev, self.last_best)

    def searching(self) -> list:
        """Whether each image's search goes on: neither done nor past its
        bucket."""
        return [not (d or o) for d, o in zip(self.done, self.overflow)]

    def record(self, pc: int, results, per_qms) -> bool:
        """Pass pc's results into each searching image's hook: its best
        pass so far (opt, best, last_best) and whether it is done.
        Returns whether every image is done (or past its bucket)."""
        all_done = True
        for i in range(self.b):
            if self.done[i] or self.overflow[i]:
                continue
            hook = self.hooks[i]
            hook.pass_count = pc
            is_best = pc == 0 or abs(results[i] - hook.target) < self.best[i]
            self.last_best[i] = is_best
            if is_best:
                self.opt[i] = [per_qms[i][g]["quant"].copy()
                               for g in range(2)]
                self.best[i] = abs(results[i] - hook.target)
            if hook.update(results[i]):
                self.done[i] = True
            else:
                all_done = False
        return all_done

    def size_results(self, ev, fits=None):
        """[2 (+ 4), B] fetched evaluation -> each image's float32 size in
        bytes; None, and its overflow set, where it does not fit (`fits`,
        [B] bools; by default its total within the bucket)."""
        if fits is None:
            fits = ev[0] <= self.bucket * 32
        results = []
        for i in range(self.b):
            if not fits[i]:
                self.overflow[i] = True
                results.append(None)
                continue
            hdr = (header_size_bits(self.param, self.layout.nb_comps,
                                    self.defaults) if ev.shape[0] == 2
                   else header_size_bits_nbsyms(
                       self.param, self.layout.nb_comps, ev[2:6, i]))
            bits = hdr + int(ev[0, i]) + 8 * int(ev[1, i])
            results.append(float(np.float32(bits / 8.0)))
        return results

    # ---- the final pass of routes 2 and 3 -------------------------------

    def final_pass(self, opt, final_lens):
        """Every image at its best matrices: the staged encode of
        engine._encode_batch_optimized (tables are a function of the
        matrices, so this reproduces the best pass's bytes)."""
        b, flags = self.b, self.flags
        base = engine._quant_matrices(self.param)      # stands in unused
        final_qms = [base if o is None else self.finalize(o) for o in opt]
        iq3, ib3 = self.quant_arrays(final_qms)
        coeffs, nb = self.prep["coeffs"], self.nb_blocks
        if flags["use_trellis"]:
            (qq3,) = self.quant_arrays(final_qms, ("quant",))
            vlc_state, freqs = engine._stage_quantize_trellis(
                coeffs, iq3, ib3, qq3, final_lens, flags["optimize_size"],
                nb, b, b)
        else:
            vlc_state, freqs = engine._stage_batch_quantize(
                coeffs, iq3, ib3, flags["optimize_size"], nb, b, b)
        dcl, acl, per_tables, desc_flat = engine._stage_tables(
            freqs, flags, self.n_groups, b, False, self.device)
        totals_np, scans = engine.fetch_scans(*engine._stage_batch_pack(
            vlc_state, dcl, acl, b, self.bucket))
        fits = totals_np <= self.bucket * 32
        if per_tables is None:
            flat = desc_flat.cpu().numpy()
            per_tables = [huffman_device.tables_from_flat(flat, i,
                                                          self.n_groups)
                          for i in range(b)]
        return [self.fallback(i) if opt[i] is None or not fits[i]
                else self.assemble(final_qms[i], per_tables[i], scans[i])
                for i in range(b)]


def encode_batch_search(src, src_kind: str, yuv_mode: int, w: int, h: int,
                        param: EncoderParam,
                        bits_per_pixel_budget: float = 4.0):
    """Batched target-size / target-PSNR search over a device source (RGB
    batch or component plane tuple) -> one JPEG byte string per image,
    byte-identical to sjpeg_tpu.engine.encode_batch."""
    return _Search(src, src_kind, yuv_mode, w, h, param,
                   bits_per_pixel_budget).run()


def encode_search_one(coeffs, histos, layout, param: EncoderParam) -> bytes:
    """One image's target-size / target-PSNR dichotomy over its
    coefficients on the card, the counterpart of
    sjpeg_tpu.engine._encode_search_device: the hook (param.search_hook, or
    the default bisection) runs on the host, one fetch a pass.

    A size pass with Huffman optimization builds its tables on the card
    (ops/huffman_device) and packs through vlc_pack; methods 0 and 3 pack
    straight from the coefficients through quant_pack.  Method 7's [2, 256]
    rate lengths take each size pass's new code lengths (the reference's
    InitCodes(true) in StoreRunLevels, src/dichotomy.cc:83-85, 144).  A
    PSNR pass computes the exact squared error alone.  The final pass runs
    at the best matrices unless the best pass was the last size pass,
    whose streams are kept.  histos: the (luma, chroma) [64, bins]
    histograms with adaptive quantization, where the coefficients are, else
    None: each pass fits its matrices there (`engine._fit_on_device`, one
    lambda_fit launch a pass on the card), and the host reads the best
    pass's tuned matrices once, at the end."""
    flags = method_flags(param.method)
    dev = coeffs[0].device
    optimize = flags["optimize_size"]
    min_qmats = param.resolved_min_quant_matrices()
    hook = param.search_hook or SearchHook()
    initial_q = min(max(estimate_quality(
        param.resolved_quant_matrices()[0]), 0.0), 100.0)
    hook.setup(param, initial_q)
    defaults = k3_default_tables()
    n_groups = 2 if layout.nb_comps > 1 else 1
    nb_blocks = tuple(layout.nb_blocks)
    n_blocks = sum(int(co.shape[0]) for co in coeffs)
    dcl_def, acl_def = state.arrays_to_device(*engine._host_luts(defaults),
                                              device=dev)
    cost_lens = (state.arrays_to_device(trellis_cost_lens(), device=dev)[0]
                 if flags["use_trellis"] else None)

    def pass_rows():
        # next_matrices() once per table, as the JAX engine calls it
        qmats = [hook.next_matrices()[c] for c in range(2)]
        qms = [spec.finalize_quant_matrix(qmats[g], min_qmats[g],
                                          param.quantization_bias)
               for g in range(2)]
        return engine._fit_on_device(histos, param, flags, n_groups, True,
                                     dev, qms)

    best = best_q = best_result = 0.0
    last_is_best = False
    best_rows = kept = None
    for p in range(min(max(param.passes, 1), 20)):
        hook.pass_count = p
        rows = pass_rows()
        iq, ib, quant = rows
        if hook.for_size and optimize:
            if flags["use_trellis"]:
                vlc_state, freqs = engine._stage_quantize_trellis(
                    coeffs, iq, ib, quant, cost_lens, True, nb_blocks, 1, 1)
            else:
                vlc_state, freqs = engine._stage_batch_quantize(
                    coeffs, iq, ib, True, nb_blocks, 1, 1)
            dcl, acl, nbs, desc = huffman_device.luts_and_desc_from_freqs(
                freqs[0][None], freqs[1][None], n_groups)
            if flags["use_trellis"]:
                new_lens = acl[0] & 0xFF
                cost_lens = torch.where(new_lens > 0, new_lens, cost_lens)
            words, totals = engine._stage_pack(vlc_state, dcl[0], acl[0])
            ev = _stage_eval_size_nbs(words, totals, nbs)[:, 0].cpu().numpy()
            hdr = header_size_bits_nbsyms(param, layout.nb_comps, ev[2:6])
            kept = (words, totals, huffman_device.desc_to_flat(nbs, desc))
        elif hook.for_size:
            words, totals = engine._stage_quant_pack(coeffs, iq, ib, dcl_def,
                                                     acl_def, nb_blocks)
            ev = _stage_eval_size_batch(words, totals)[:, 0].cpu().numpy()
            hdr = header_size_bits(param, layout.nb_comps, defaults)
            kept = (words, totals, None)
        if hook.for_size:
            result = float(np.float32((hdr + int(ev[0]) + 8 * int(ev[1]))
                                      / 8.0))
        else:
            err = int(_batch_qerr(coeffs, iq[None], ib[None], quant[None],
                                  1)[0])
            result = get_psnr(err, 64 * n_blocks)
        last_is_best = p == 0 or abs(result - hook.target) < best
        if last_is_best:
            best_rows = rows
            best = abs(result - hook.target)
            best_q = hook.q
            best_result = result
        if hook.update(result):
            break

    hook.q = best_q
    hook.value = best_result
    if not hook.for_size or not last_is_best:
        words, totals, tables = engine._stage_one_pass(
            coeffs, best_rows, flags, nb_blocks, n_groups, cost_lens)
    else:
        words, totals, flat = kept
        tables = (defaults if flat is None else
                  huffman_device.tables_from_flat(flat.cpu().numpy(), 0,
                                                  n_groups))
    scan = engine._scan_bytes(words, totals)
    return engine._assemble_jpeg(
        layout, param, engine._host_matrices(best_rows[2], param, 1)[0],
        tables, scan)
