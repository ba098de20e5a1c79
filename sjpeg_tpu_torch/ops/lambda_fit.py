"""The adaptive quantizer's lambda fit on the card: every (image, table
group) of a batch tuned by one launch of csrc/lambda_fit.cu, on the
histograms that ops/quantize.store_histo left there.

Replaces no TPU kernel (the JAX package fits on the host in NumPy); the
arithmetic is csrc/fit_core.cuh's, bit-exact to adaptive.analyse_histo
followed by spec.finalize_quant_matrix.  `lambda_fit` launches the kernel
for CUDA tensors and runs its plain twin, the host route, for any other:
`lambda_fit_plain`, the same fit and finalize in NumPy on the fetched
histograms, image by image through `fit_image`, the one host fit (the
batched search's pass-by-pass fits call it too).

The param's matrices, min_quant rows and HISTO_WEIGHT are uploaded once a
parameter set and device, and kept (the single-image search's passes each
bring their own matrices: they take the same cache's slots in turn).
"""

import ctypes
import functools

import numpy as np
import torch

from .. import adaptive, kernels, spec
from .. import constants as C
from ..utils.profiling import span

_BINS = C.MAX_HISTO_DCT_COEFF
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
             + [ctypes.c_void_p] * 2)


@functools.lru_cache(maxsize=16)
def _param_rows(mats: bytes, device: torch.device):
    """The kernel's parameter inputs on `device`: int32 [4, 64] (luma and
    chroma matrices, then their min_quant rows) and float64 [25] weights.
    The uploading stream is synchronised once here, so that a launch on any
    stream reads them complete; each launch records its stream on them
    (`lambda_fit`), so that an entry evicted from the cache is not freed
    while a launch still reads it."""
    rows = np.frombuffer(mats, dtype=np.uint8).reshape(4, 64)
    out = (torch.from_numpy(rows.astype(np.int32)).to(device),
           torch.from_numpy(C.HISTO_WEIGHT.copy()).to(device))
    torch.cuda.current_stream(device).synchronize()
    return out


def _check(histos_l, histos_c, quant, min_quant, qdelta_max) -> None:
    for h in (histos_l, histos_c):
        if h.dtype != torch.int32:
            raise TypeError(f"lambda_fit takes int32 histograms, got "
                            f"{h.dtype}")
        if h.dim() < 2 or tuple(h.shape[-2:]) != (64, _BINS):
            raise ValueError("lambda_fit takes [..., 64, "
                             f"{_BINS}] histograms, got {tuple(h.shape)}")
    if histos_l.shape != histos_c.shape:
        raise ValueError("lambda_fit: luma and chroma histograms differ in "
                         f"shape, {tuple(histos_l.shape)} and "
                         f"{tuple(histos_c.shape)}")
    if np.shape(quant) != (2, 64) or np.shape(min_quant) != (2, 64):
        raise ValueError("lambda_fit takes [2, 64] matrices and min_quant")
    if not all(C.QDELTA_MIN <= d <= C.QDELTA_MAX for d in qdelta_max):
        raise ValueError(f"lambda_fit: qdelta_max {tuple(qdelta_max)} "
                         f"outside {C.QDELTA_MIN}..{C.QDELTA_MAX}")


def lambda_fit(histos_l, histos_c, quant, min_quant, qdelta_max, q_bias: int,
               n_groups: int):
    """Tune each image's matrices on the card.

    histos_l, histos_c: int32 [B, 64, bins] (or [64, bins], one image or a
    shared batch) luma and chroma histograms on a CUDA device, contiguous;
    quant: [2, 64] uint8 finalized (clamped) luma and chroma matrices;
    min_quant: [2, 64]; qdelta_max: (luma, chroma); n_groups: 2, or 1 when
    the chroma group is not tuned (it keeps `quant[1]`).
    -> int32 (iquant, bias, quant) rows, each [B, 2, 64] on the device:
    spec.finalize_quant_matrix's `iquant` and `bias` of the tuned matrix,
    and the matrix itself.  On a CUDA device, launches one kernel on the
    current stream, no wait; elsewhere runs `lambda_fit_plain` inside the
    `sjpeg.analysis` span."""
    dev = histos_l.device
    if dev.type != "cuda":
        with span("analysis"):
            return lambda_fit_plain(histos_l, histos_c, quant, min_quant,
                                    qdelta_max, q_bias, n_groups)
    _check(histos_l, histos_c, quant, min_quant, qdelta_max)
    if histos_c.device != dev:
        raise ValueError("lambda_fit: luma and chroma histograms on "
                         f"{dev} and {histos_c.device}")
    if not (histos_l.is_contiguous() and histos_c.is_contiguous()):
        raise ValueError("lambda_fit takes contiguous histograms")
    b = histos_l.numel() // (64 * _BINS)
    mats = np.concatenate([np.asarray(quant), np.asarray(min_quant)])
    rows, weight = _param_rows(mats.astype(np.uint8).tobytes(), dev)
    out = torch.empty((3, b, 2, 64), dtype=torch.int32, device=dev)
    fn = kernels.function("lambda_fit", "sjpeg_lambda_fit", _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream()
        rows.record_stream(stream)
        weight.record_stream(stream)
        rc = fn(histos_l.data_ptr(), histos_c.data_ptr(), rows.data_ptr(),
                weight.data_ptr(), b, n_groups, int(qdelta_max[0]),
                int(qdelta_max[1]), int(q_bias), out.data_ptr(),
                stream.cuda_stream)
    kernels.check(rc, "lambda_fit")
    lambda_fit.launches += 1
    return out[0], out[1], out[2]


lambda_fit.launches = 0


def fit_image(histo_pair, quant, min_quant, qdelta_max, q_bias: int,
              n_groups: int) -> list:
    """One image's host fit: adaptive.analyse_histo of each tuned group
    (histo_pair: its (luma, chroma) [64, bins] histograms) and
    spec.finalize_quant_matrix of both -> [2] finalized matrix dicts.
    quant: [2, 64] finalized matrices; the other arguments as
    `lambda_fit`'s."""
    out = []
    for g in range(2):
        q = np.asarray(quant[g], dtype=np.uint8)
        if g < n_groups:
            q = adaptive.analyse_histo(histo_pair[g], q, min_quant[g],
                                       qdelta_max[g])
        out.append(spec.finalize_quant_matrix(q, min_quant[g], q_bias))
    return out


def lambda_fit_plain(histos_l, histos_c, quant, min_quant, qdelta_max,
                     q_bias: int, n_groups: int):
    """`lambda_fit` by the host route, on any device: one fetch of the
    histograms, `fit_image` of each image -> the same three int32
    [B, 2, 64] rows, on the histograms' device."""
    _check(histos_l, histos_c, quant, min_quant, qdelta_max)
    hh = torch.stack([histos_l, histos_c]).cpu().numpy().reshape(
        2, -1, 64, _BINS)
    b = hh.shape[1]
    out = np.empty((3, b, 2, 64), dtype=np.int32)
    for i in range(b):
        fins = fit_image(hh[:, i], quant, min_quant, qdelta_max, q_bias,
                         n_groups)
        for g, fin in enumerate(fins):
            out[:, i, g] = fin["iquant"], fin["bias"], fin["quant"]
    t = torch.from_numpy(out).to(histos_l.device)
    return t[0], t[1], t[2]
