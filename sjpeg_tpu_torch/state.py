"""The encoder's state as the port's tensors.

The encoder has no weights; its state is the quantizer rows (iquant and
bias, and for the trellis the clamped quant matrix), the Huffman LUTs and
the trellis's AC code lengths, shared ([2, 64] rows, [2, 16] / [2, 256]
LUTs and lengths) or one set per image ([B, 2, 64], [B, 2, 16] /
[B, 2, 256]).  `tables_from_numpy` carries them from NumPy (the JAX
package's `engine._quant_device_arrays` / `engine._device_luts` arrays,
or the port's own) onto a device, in the layout the kernels read;
`arrays_to_device` carries any subset of them.
"""

import numpy as np
import torch


def _bits32(a) -> np.ndarray:
    """Integers in [0, 2^32) -> int32 array of the same bit patterns."""
    return np.ascontiguousarray(
        np.asarray(a).astype(np.int64).astype(np.uint32).view(np.int32))


def arrays_to_device(*arrays, device):
    """Integer arrays with values in [0, 2^32) -> int32 tensors on
    `device` holding the same bit patterns."""
    return tuple(torch.from_numpy(_bits32(a)).to(device) for a in arrays)


def tables_from_numpy(iquant, ibias, dc_luts, ac_luts, device):
    """(iquant, ibias [(B,) 2, 64], DC LUTs [(B,) 2, 16], AC LUTs
    [(B,) 2, 256]) -> int32 tensors on `device`; LUT entries, packed
    (code << 16) | len uint32 values, keep their bit patterns."""
    return arrays_to_device(iquant, ibias, dc_luts, ac_luts, device=device)
