"""Encoder configuration, copied for the PyTorch port.

`EncoderParam` mirrors the capability surface of the reference's parameter
object (src/sjpeg.h:187-275).  The compression "method" 0..8 is the same
preset bundle of four booleans (src/enc.cc:199-207, sjpeg.h:77-99).  The
port runs methods 0, 1, 3, 4 and 7, every YUV mode, and the target-size /
target-PSNR searches with the default or a custom hook.
"""

import dataclasses
from typing import Optional

import numpy as np

from . import constants as C

TARGET_NONE = 0
TARGET_SIZE = 1
TARGET_PSNR = 2


def quant_matrices_for_quality(quality: float) -> np.ndarray:
    """Annex-K matrices scaled by the jpeg-6b quality mapping -> [2, 64] u8."""
    q = quality
    q = 5000.0 if q <= 0 else (5000.0 / q if q < 50 else
                               (2 * (100 - q) if q < 100 else 0.0))
    q = np.floor(q)
    return scale_quant_matrices(C.DEFAULT_QUANT_MATRICES, q)


def scale_quant_matrices(m: np.ndarray, q_factor: float) -> np.ndarray:
    """Scale matrices by q_factor/100 with round-half-up, clamped to [1,255]."""
    v = np.floor(m.astype(np.float32) * (np.float32(q_factor) / 100.0) + 0.5)
    return np.clip(v, 1, 255).astype(np.uint8)


def min_quant_matrices(m: np.ndarray, tolerance: int) -> np.ndarray:
    """Derive min-quant limits from source matrices (recompression limiting)."""
    v = (m.astype(np.int64) * (256 - tolerance)) >> 8
    return np.clip(v, 1, 255).astype(np.uint8)


def method_flags(method: int) -> dict:
    """Decode a compression method 0..8 into its feature booleans."""
    assert 0 <= method <= 8
    return {
        "use_adaptive_quant": method >= 3,
        "optimize_size": method not in (0, 3),
        "use_extra_memory": method in (3, 4, 7),
        "reuse_run_levels": method in (1, 4, 5, 7, 8),
        "use_trellis": method >= 7,
    }


class SearchHook:
    """Pluggable convergence control for target-size / target-PSNR search.

    Default implementation: bisection on the quality factor between qmin and
    qmax (reference src/dichotomy.cc:34-74).
    """

    def setup(self, param: "EncoderParam", initial_q: float) -> bool:
        """`initial_q` is the estimated quality of the starting matrices."""
        self.for_size = param.target_mode == TARGET_SIZE
        self.target = param.target_value
        self.tolerance = param.tolerance / 100.0
        self.qmin = max(param.qmin, 0.0)
        self.qmax = (100.0 if param.qmax > 100 else
                     param.qmin if param.qmax < param.qmin else param.qmax)
        self.q = min(max(initial_q, self.qmin), self.qmax)
        self.value = 0.0
        self.pass_count = 0
        return True

    def update(self, result: float) -> bool:
        """Record `result`; return True when converged."""
        self.value = result
        if abs(self.value - self.target) < self.tolerance * self.target:
            return True
        if self.value > self.target:
            self.qmax = self.q
        else:
            self.qmin = self.q
        q = (self.qmin + self.qmax) / 2.0
        converged = abs(q - self.q) < 0.15
        self.q = q
        return converged

    def next_matrices(self) -> np.ndarray:
        return quant_matrices_for_quality(self.q)


@dataclasses.dataclass
class EncoderParam:
    quality: float = C.DEFAULT_QUALITY
    yuv_mode: int = C.YUV_AUTO
    # feature toggles (mapped to a method preset like the reference)
    huffman_compress: bool = True
    adaptive_quantization: bool = True
    use_trellis: bool = False
    adaptive_bias: bool = False
    # quantization
    quant_matrices: Optional[np.ndarray] = None       # [2, 64] overrides quality
    min_quant_matrices: Optional[np.ndarray] = None   # [2, 64]
    min_quant_tolerance: int = 0
    quantization_bias: int = C.DEFAULT_BIAS
    qdelta_max_luma: int = C.DEFAULT_DELTA_MAX_LUMA
    qdelta_max_chroma: int = C.DEFAULT_DELTA_MAX_CHROMA
    # target search
    target_mode: int = TARGET_NONE
    target_value: float = 0.0
    passes: int = 1
    tolerance: float = 1.0     # percent, like the reference default
    qmin: float = 0.0
    qmax: float = 100.0
    search_hook: Optional[SearchHook] = None
    # metadata
    exif: bytes = b""
    iccp: bytes = b""
    xmp: bytes = b""
    app_markers: bytes = b""
    xmp_split_point: int = 0

    def set_quality(self, q: float) -> "EncoderParam":
        self.quality = q
        self.quant_matrices = None
        return self

    def set_quantization(self, m: np.ndarray,
                         reduction: float = 100.0) -> "EncoderParam":
        """Use explicit matrices (e.g. extracted from a source JPEG)."""
        m = np.asarray(m, dtype=np.uint8).reshape(2, 64)
        if reduction <= 1.0:
            reduction = 1.0
        v = np.floor(m.astype(np.float64) * 100.0 / reduction + 0.5)
        self.quant_matrices = np.clip(v, 1, 255).astype(np.uint8)
        return self

    def set_limit_quantization(self, limit: bool = True,
                               tolerance: int = 0) -> "EncoderParam":
        """Never quantize finer than the (reduced) source matrices."""
        if limit:
            assert self.quant_matrices is not None
            self.min_quant_matrices = self.quant_matrices.copy()
            self.min_quant_tolerance = tolerance
        else:
            self.min_quant_matrices = None
        return self

    def set_min_quantization(self, m: np.ndarray,
                             tolerance: int = 0) -> "EncoderParam":
        self.min_quant_matrices = np.asarray(m, dtype=np.uint8).reshape(2, 64)
        self.min_quant_tolerance = tolerance
        return self

    def set_target_size(self, size: int, tolerance: float = 1.0,
                        passes: int = 10) -> "EncoderParam":
        self.target_mode = TARGET_SIZE
        self.target_value = float(size)
        self.tolerance = tolerance
        self.passes = passes
        return self

    def set_target_psnr(self, psnr: float, tolerance: float = 1.0,
                        passes: int = 10) -> "EncoderParam":
        self.target_mode = TARGET_PSNR
        self.target_value = float(psnr)
        self.tolerance = tolerance
        self.passes = passes
        return self

    @property
    def method(self) -> int:
        """The method preset implied by the toggles (src/enc.cc:2282-2288)."""
        method = 1 if self.huffman_compress else 0
        if self.adaptive_quantization:
            method += 3
        if self.use_trellis:
            method = 7 if method == 4 else (8 if method == 6 else method)
        return method

    def resolved_quant_matrices(self) -> np.ndarray:
        if self.quant_matrices is not None:
            return self.quant_matrices
        return quant_matrices_for_quality(self.quality)

    def resolved_min_quant_matrices(self) -> np.ndarray:
        if self.min_quant_matrices is None:
            return np.ones((2, 64), dtype=np.uint8)
        return np.stack([
            min_quant_matrices(self.min_quant_matrices[0],
                               self.min_quant_tolerance),
            min_quant_matrices(self.min_quant_matrices[1],
                               self.min_quant_tolerance),
        ])
