"""Quality estimation, copied for the PyTorch port.

`quant_matrix` is the jpeg-6b quality -> matrix mapping and
`estimate_quality` brute-forces the best-L2 quality in [0, 100] (reference
src/jpeg_tools.cc:34-164).  The search starts its bisection from the
quality that `estimate_quality` gives the luma matrix.
"""

import numpy as np

from .params import quant_matrices_for_quality


def quant_matrix(quality: float, for_chroma: bool) -> np.ndarray:
    """jpeg-6b style quality -> quant matrix (raster order, uint8[64])."""
    return quant_matrices_for_quality(quality)[1 if for_chroma else 0]


def estimate_quality(matrix: np.ndarray, for_chroma: bool = False) -> float:
    """Best-L2 quality in [0, 100] whose jpeg-6b matrix matches `matrix`."""
    matrix = np.asarray(matrix, dtype=np.float32).reshape(64)
    best_quality = 0
    best_score = 256.0 * 256 * 64 + 1
    for quality in range(101):
        m = quant_matrix(quality, for_chroma).astype(np.float32)
        score = float(((m - matrix) ** 2).sum())
        if score < best_score:
            best_score = score
            best_quality = quality
    return float(best_quality)
