"""Host-side finishing of the entropy-coded segment (NumPy).

The device hands back MSB-first uint32 words and an exact bit count; the
host turns them into bytes, pads the last byte with '1' bits and applies
JPEG 0xFF byte stuffing (reference src/bit_writer.h:99-110).
"""

import numpy as np


def stuff_bytes(raw: np.ndarray) -> bytes:
    """Insert a 0x00 after every 0xFF byte of `raw` (uint8 array)."""
    raw = np.asarray(raw, dtype=np.uint8)
    ff = raw == 0xFF
    n_ff = int(np.count_nonzero(ff))
    if n_ff == 0:
        return raw.tobytes()
    out = np.zeros(raw.size + n_ff, dtype=np.uint8)
    # destination index of each source byte: shifted down by the number of
    # 0xFF bytes seen before it
    dst = np.arange(raw.size, dtype=np.int64) + np.cumsum(ff) - ff
    out[dst] = raw
    return out.tobytes()


def pack_bits_to_bytes(words: np.ndarray, total_bits: int) -> np.ndarray:
    """Convert a uint32 MSB-first word stream into its uint8 byte stream
    (the first ceil(total_bits / 8) bytes)."""
    n_bytes = (total_bits + 7) // 8
    b = words.astype('>u4').view(np.uint8)
    return b[:n_bytes]


def words_to_scan(words: np.ndarray, total_bits: int) -> bytes:
    """MSB-first uint32 words -> final stuffed, '1'-padded scan segment."""
    raw = np.array(pack_bits_to_bytes(np.ascontiguousarray(words),
                                      total_bits))
    pad = (-total_bits) % 8
    if pad and raw.size:
        raw[-1] |= (1 << pad) - 1
    return stuff_bytes(raw)
