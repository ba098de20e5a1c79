"""sjpeg's search for a target size or PSNR (LoopScan with the default
SearchHook, src/dichotomy.cc:34-192), one image at a time.

The coefficients and histograms are computed once (`encoder.prepare`).
The quality starts at SjpegEstimateQuality of the configured matrix,
clamped to [qmin, qmax], and each pass:

- derives the matrices at the hook's quality (`encoder.pass_matrices`:
  the K.1 scaling, the bias, AnalyseHisto with adaptive quantization);
- for a size, quantizes (the trellis in method 7, over the rate model that
  the passes so far left), builds the pass's tables and measures sjpeg's
  header model plus the scan's bits, 8 more for each complete 0xFF byte;
  for a PSNR, measures the bias quantizer's squared error;
- keeps the pass closest to the target, and bisects the quality: the
  search ends when the value lies within tolerance * target, when the
  quality moves by less than 0.15, or after min(passes, 20) passes.

Then the final pass runs at the best matrices, unless the best was the
last size pass, whose levels stand (sjpeg keeps them).
"""

import math

import numpy as np

from . import encoder, trellis


class Bisection:
    """The default SearchHook (src/dichotomy.cc:34-74), in float64."""

    def __init__(self, s: encoder.Settings, initial_q: float):
        self.for_size = s.target_mode == "size"
        self.target = float(s.target_value)
        self.tolerance = s.tolerance / 100.0
        self.qmin = max(s.qmin, 0.0)
        self.qmax = (100.0 if s.qmax > 100 else
                     s.qmin if s.qmax < s.qmin else s.qmax)
        self.q = min(max(initial_q, self.qmin), self.qmax)

    def update(self, value: float) -> bool:
        """Take a pass's value; True when the search is over."""
        if abs(value - self.target) < self.tolerance * self.target:
            return True
        if value > self.target:
            self.qmax = self.q
        else:
            self.qmin = self.q
        q = (self.qmin + self.qmax) / 2.0
        done = abs(q - self.q) < 0.15
        self.q = q
        return done


def estimate_quality(matrix: np.ndarray) -> float:
    """SjpegEstimateQuality (src/jpeg_tools.cc): the quality in 0..100
    whose luma matrix lies nearest `matrix` in L2, the first of ties."""
    m = np.asarray(matrix, dtype=np.float32).reshape(64)
    scores = [float(((encoder.quant_matrices(q)[0].astype(np.float32)
                      - m) ** 2).sum()) for q in range(101)]
    return float(np.argmin(scores))


def header_bits(lay: encoder.Layout, tables: list) -> int:
    """sjpeg's model of the markers' size (src/dichotomy.cc:197-228), no
    metadata: APP0, two DQT tables always, SOF, SOS, EOI and the DHT
    segments of the tables in use, in bits."""
    nb_comps = len(lay.quant_idx)
    size = 20 + (2 * 65 + 2 + 2) + (8 + 3 * nb_comps + 2) \
        + (6 + 2 * nb_comps + 2) + 2
    for c in range(1 if nb_comps == 1 else 2):
        for kind in range(2):
            size += 2 + 3 + 16 + tables[kind * 2 + c].nb_syms
    return size * 8


def scan_bits(raw: np.ndarray, total: int) -> int:
    """The scan's bits with stuffing as sjpeg's BitCounter counts them: 8
    for each 0xFF among the complete bytes (the last partial byte never
    counts)."""
    return total + 8 * int(np.count_nonzero(raw[:total // 8] == 0xFF))


def get_psnr(err: int, size: int) -> float:
    """src/dichotomy.cc's GetPSNR: 4.3429448 * ln(size * 255^2 / err),
    rounded to float32; 99 for no error."""
    if err > 0 and size > 0:
        return float(np.float32(4.3429448 * math.log(
            size / (err / 255.0 / 255.0))))
    return 99.0


def loop_scan(prep: encoder.Prepared, s: encoder.Settings) -> tuple:
    """The search over a prepared image -> (levels, tables, scan bytes
    before stuffing) of the final pass."""
    lay = prep.lay
    hook = Bisection(s, min(max(estimate_quality(
        encoder.quant_matrices(s.quality)[0]), 0.0), 100.0))
    lens = trellis.k3_ac_lens()
    n_blocks = sum(len(co) for co in prep.coeffs)
    best = 0.0
    best_qms = kept = None
    last_is_best = False
    for p in range(min(max(s.passes, 1), 20)):
        qms = encoder.pass_matrices(prep, s, hook.q)
        if hook.for_size:
            qz = encoder.quantize(prep, qms, s, lens)
            tables = encoder.tables_for(qz, lay, s)
            if s.trellis:
                lens = trellis.overlay_lens(lens, tables)
            raw, total = encoder.scan_raw(qz, lay, tables)
            value = float(np.float32(
                (header_bits(lay, tables) + scan_bits(raw, total)) / 8.0))
            kept = (qz, tables, raw)
        else:
            value = get_psnr(encoder.quant_error(prep, qms), 64 * n_blocks)
        last_is_best = p == 0 or abs(value - hook.target) < best
        if last_is_best:
            best_qms = qms
            best = abs(value - hook.target)
        if hook.update(value):
            break
    if hook.for_size and last_is_best:
        return kept
    qz = encoder.quantize(prep, best_qms, s, lens)
    tables = encoder.tables_for(qz, lay, s)
    return qz, tables, encoder.scan_raw(qz, lay, tables)[0]
