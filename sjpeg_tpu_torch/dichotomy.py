"""Target-size / target-PSNR search arithmetic, copied for the PyTorch port.

The reference's dichotomy (src/dichotomy.cc:34-295) bisects the quality
with a float64 hook.  The batched search runs every pass of every image on
the card and leaves only integer decisions there, so this module turns the
hook's float tests into exact integer ranges ahead of the loop, and
replays the hook in float64 on the fetched trace afterwards:

- `build_q_tree` / `build_q_conv_table`: every quality the default hook
  can visit (a binary tree over the decisions taken so far) and whether
  its bracket update converges after each decision;
- `size_tolerance_range`, `psnr_tolerance_range`, `psnr_err_threshold`:
  the bit counts or squared errors that pass the hook's tolerance and
  `value > target` tests;
- `header_size_bits` / `header_size_bits_nbsyms`: the reference's header
  size model;
- `replay_search_trace`: the float64 hook against the device's trace.
"""

import math
from typing import List

import numpy as np

from .huffman import HuffmanTable
from .params import EncoderParam, SearchHook


def header_size_bits(param: EncoderParam, nb_comps: int,
                     tables: List[HuffmanTable]) -> int:
    """The reference's header-size model (src/dichotomy.cc:197-228), bits."""
    return header_size_bits_nbsyms(
        param, nb_comps, [t.nb_syms if t is not None else 0
                          for t in tables])


def header_size_bits_nbsyms(param: EncoderParam, nb_comps: int,
                            nb_syms4) -> int:
    """header_size_bits from the four tables' symbol counts alone (order
    [dc_luma, dc_chroma, ac_luma, ac_chroma]), the form a table pass built
    on the card reports."""
    size = 20                                # APP0
    size += len(param.app_markers)
    if param.exif:
        size += 8 + len(param.exif)
    if param.iccp:
        chunk_max = 0xFFFF - 12 - 4
        num_chunks = (len(param.iccp) - 1) // chunk_max + 1
        size += num_chunks * (12 + 4 + 2) + len(param.iccp)
    if param.xmp:
        size += 2 + 2 + 29 + len(param.xmp)
        if len(param.xmp) > 65533:
            size += (len(param.xmp) // 65458 + 1) * 40
    size += 2 * 65 + 2 + 2                   # DQT
    size += 8 + 3 * nb_comps + 2             # SOF
    size += 6 + 2 * nb_comps + 2             # SOS
    size += 2                                # EOI
    for c in range(1 if nb_comps == 1 else 2):
        for type_ in range(2):
            size += 2 + 3 + 16 + int(nb_syms4[type_ * 2 + c])
    return size * 8


def get_psnr(err: int, size: int) -> float:
    """float32 PSNR formula, written exactly like the reference."""
    if err > 0 and size > 0:
        return float(np.float32(4.3429448 * math.log(
            size / (err / 255.0 / 255.0))))
    return 99.0


def _q_nodes(param: EncoderParam, initial_q: float, passes: int):
    """[(qmin, qmax, q)] of every tree node, in the SearchHook's exact
    float64 arithmetic (src/dichotomy.cc:34-74).  Node 2^p - 1 + path is
    pass p's, where path holds the decisions taken so far (1 = value >
    target, i.e. qmax <- q)."""
    qmin0 = max(param.qmin, 0.0)
    qmax0 = (100.0 if param.qmax > 100 else
             param.qmin if param.qmax < param.qmin else param.qmax)
    nodes = [(qmin0, qmax0, min(max(initial_q, qmin0), qmax0))]
    for p in range(1, passes):
        base = (1 << (p - 1)) - 1
        for path in range(1 << p):
            qmin, qmax, q = nodes[base + (path >> 1)]
            if path & 1:
                qmax = q
            else:
                qmin = q
            nodes.append((qmin, qmax, (qmin + qmax) / 2.0))
    return nodes


def build_q_tree(param: EncoderParam, initial_q: float, passes: int):
    """[2^passes - 1] float64 quality of every node the default bisection
    hook can visit, so that the loop on the card can tabulate every pass's
    matrices ahead of time."""
    return np.asarray([n[2] for n in _q_nodes(param, initial_q, passes)],
                      dtype=np.float64)


def build_q_conv_table(param: EncoderParam, initial_q: float,
                       passes: int) -> np.ndarray:
    """[2^passes - 1, 2] int32: does the default hook's bracket update
    converge (|new_q - q| < 0.15, src/dichotomy.cc:66-69) after taking
    decision d at each tree node?  The loop on the card stops exactly when
    the host hook would."""
    nodes = _q_nodes(param, initial_q, passes)
    conv = np.zeros((len(nodes), 2), np.int32)
    for k, (qmin, qmax, q) in enumerate(nodes):
        for d in range(2):
            nmin, nmax = (qmin, q) if d else (q, qmax)
            conv[k, d] = 1 if abs((nmin + nmax) / 2.0 - q) < 0.15 else 0
    return conv


def size_tolerance_range(param: EncoderParam):
    """Largest contiguous int range [lo, hi] of total BIT counts whose
    float32 byte size satisfies the hook's tolerance test
    |float32(bits/8) - target| < tolerance/100 * target (the exact
    update() early return, src/dichotomy.cc:55-58).  Returns (1, 0) when
    no bit count satisfies it.  float32(bits/8) is monotone in bits, so
    the satisfying set is contiguous and binary search against the exact
    predicate finds its edges."""
    target = float(param.target_value)
    tt = (param.tolerance / 100.0) * target

    def hit(bits: int) -> bool:
        return abs(float(np.float32(bits / 8.0)) - target) < tt

    center = int(max(round(target * 8.0), 0))
    if not hit(center):
        for c in (center - 8, center + 8, center - 1, center + 1):
            if c >= 0 and hit(c):
                center = c
                break
        else:
            return 1, 0
    lo, x = 0, center
    while lo < x:                      # min satisfying bits
        mid = (lo + x) // 2
        if hit(mid):
            x = mid
        else:
            lo = mid + 1
    lo_bits = x
    x, hi = center, 2 ** 31 - 2
    while x < hi:                      # max satisfying bits
        mid = (x + hi + 1) // 2
        if hit(mid):
            x = mid
        else:
            hi = mid - 1
    return lo_bits, x


def psnr_tolerance_range(param: EncoderParam, size: int):
    """(lo, hi, zero_hit): contiguous range of POSITIVE quantization errors
    whose PSNR satisfies |psnr - target| < tolerance/100 * target ((1, 0,
    zero_hit) when empty), plus whether err=0 (psnr 99.0, outside the
    monotone branch) satisfies it.  get_psnr is monotone decreasing in
    err >= 1."""
    target = float(param.target_value)
    tt = (param.tolerance / 100.0) * target

    def hit(err: int) -> bool:
        return abs(get_psnr(err, size) - target) < tt

    zero_hit = hit(0)
    lo_e, hi_e = 1, 1 << 62
    if not hit(lo_e) and not hit(hi_e):
        # bracket some satisfying err by bisection on the monotone psnr
        lo, hi = lo_e, hi_e
        found = None
        while lo <= hi:
            mid = (lo + hi) // 2
            p = get_psnr(mid, size)
            if hit(mid):
                found = mid
                break
            if p > target:
                lo = mid + 1
            else:
                hi = mid - 1
        if found is None:
            return 1, 0, zero_hit
        center = found
    else:
        center = lo_e if hit(lo_e) else hi_e
    lo, x = 1, center
    while lo < x:
        mid = (lo + x) // 2
        if hit(mid):
            x = mid
        else:
            lo = mid + 1
    lo_err = x
    x, hi = center, 1 << 62
    while x < hi:
        mid = (x + hi + 1) // 2
        if hit(mid):
            x = mid
        else:
            hi = mid - 1
    return lo_err, x, zero_hit


def psnr_err_threshold(target: float, size: int) -> int:
    """Largest integer err with get_psnr(err, size) > target, so that the
    loop's `value > target` test becomes an exact integer compare; 0 when
    even err=1 misses the target (err=0 maps to 99.0 and is decided
    apart)."""
    if get_psnr(1, size) <= target:
        return 0
    lo, hi = 1, 1 << 62
    while lo < hi:                      # find last err with psnr > target
        mid = (lo + hi + 1) >> 1
        if get_psnr(mid, size) > target:
            lo = mid
        else:
            hi = mid - 1
    return lo


def replay_search_trace(values, decisions, param: EncoderParam,
                        hook: SearchHook):
    """Re-run the hook in float64 against a device loop's per-pass trace.

    `values`: per executed-tree-path pass the evaluated result (bytes or
    PSNR); `decisions`: the integer decision bit the device actually took
    at each pass.  Returns (best_node, ok): the winning tree node index,
    with ok=False when the device's integer decision ever disagrees with
    the exact float hook (the caller then searches that image pass by
    pass).  `hook` must be freshly set up; its q/value/pass_count are left
    at the reference's post-search state.
    """
    best = 0.0
    best_q = hook.q
    best_result = 0.0
    best_node = 0
    path = 0
    for p, value in enumerate(values):
        node = (1 << p) - 1 + path
        hook.pass_count = p
        if p == 0 or abs(value - hook.target) < best:
            best = abs(value - hook.target)
            best_q = hook.q
            best_result = value
            best_node = node
        d_host = 1 if value > hook.target else 0
        if hook.update(value):
            break
        if d_host != int(decisions[p]):
            return best_node, False
        path = path * 2 + d_host
    hook.q = best_q
    hook.value = best_result
    return best_node, True
