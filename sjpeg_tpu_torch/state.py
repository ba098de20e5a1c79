"""The encoder's state as the port's tensors.

The encoder has no weights; its state is the quantizer rows and the Huffman
LUTs.  `tables_from_numpy` carries them from NumPy (the JAX package's
`engine._quant_device_arrays` / `engine._device_luts` arrays, or the
port's own) onto a device, in the layout the kernels read.
"""

import numpy as np
import torch


def _bits32(a) -> np.ndarray:
    """Integers in [0, 2^32) -> int32 array of the same bit patterns."""
    return np.ascontiguousarray(
        np.asarray(a).astype(np.int64).astype(np.uint32).view(np.int32))


def tables_from_numpy(iquant, ibias, dc_luts, ac_luts, device):
    """([2, 64] iquant, [2, 64] ibias, [2, 16] DC LUTs, [2, 256] AC LUTs)
    -> int32 tensors on `device`; LUT entries, packed (code << 16) | len
    uint32 values, keep their bit patterns."""
    return tuple(torch.from_numpy(_bits32(a)).to(device)
                 for a in (iquant, ibias, dc_luts, ac_luts))
