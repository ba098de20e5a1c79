"""JPEG marker and metadata segment emission (host side).

A copy of the JAX package's writers, kept so that the port imports nothing
of `sjpeg_tpu`.  Markers are a few hundred bytes per image and inherently
serial, so they are assembled on the host as `bytes` around the entropy
segment the device produced.  Behavioural contract follows the reference
writers (src/headers.cc): JFIF APP0, raw APP markers, EXIF APP1,
multi-chunk ICC APP2, XMP APP1 (with extended-XMP splitting + MD5 GUID
patching), DQT, SOF0, DHT, SOS, EOI.
"""

import hashlib

import numpy as np

from .constants import ZIGZAG, YUV_400

# SOI + APP0 'JFIF' v1.01, 1:1 aspect ratio, no thumbnail.
APP0_JFIF = bytes([
    0xFF, 0xD8,
    0xFF, 0xE0, 0x00, 0x10,
    0x4A, 0x46, 0x49, 0x46, 0x00,
    0x01, 0x01,
    0x00, 0x00, 0x01, 0x00, 0x01,
    0x00, 0x00,
])


def _u16(v: int) -> bytes:
    return bytes([(v >> 8) & 0xFF, v & 0xFF])


def _u32(v: int) -> bytes:
    return _u16((v >> 16) & 0xFFFF) + _u16(v & 0xFFFF)


def write_app0() -> bytes:
    return APP0_JFIF


def write_app_markers(data: bytes) -> bytes:
    """Raw APP chunks, written as-is (caller supplies full marker bytes)."""
    return bytes(data)


def write_exif(data: bytes) -> bytes:
    if not data:
        return b""
    payload = b"Exif\x00\x00" + data
    seg_size = len(payload) + 2
    if seg_size > 0xFFFF:
        raise ValueError("EXIF metadata too large for a single APP1 segment")
    return _u16(0xFFE1) + _u16(seg_size) + payload


def write_iccp(data: bytes) -> bytes:
    """ICC profile, split into numbered 'ICC_PROFILE' APP2 chunks."""
    if not data:
        return b""
    tag = b"ICC_PROFILE\x00"
    max_chunk = 0xFFFF - len(tag) - 4
    n_chunks = (len(data) + max_chunk - 1) // max_chunk
    if n_chunks >= 256:
        raise ValueError("ICC profile too large")
    out = bytearray()
    for seq in range(1, n_chunks + 1):
        chunk = data[(seq - 1) * max_chunk: seq * max_chunk]
        total = len(chunk) + len(tag) + 4
        out += _u16(0xFFE2) + _u16(total) + tag
        out += bytes([seq & 0xFF, n_chunks & 0xFF]) + chunk
    return bytes(out)


_XMP_TAG = b"http://ns.adobe.com/xap/1.0/\x00"
_XMP_EXT_TAG = b"http://ns.adobe.com/xmp/extension/\x00"
_XMP_MAIN_LIMIT = 65503
_XMP_EXT_CHUNK = 65458
_XMP_NOTE = b'xmpNote:HasExtendedXMP="'


def write_xmp(data: bytes, split_point: int = 0) -> bytes:
    """XMP APP1 segment; large payloads use the extended-XMP chunk scheme.

    For payloads above 65503 bytes the data is split at `split_point` (or the
    main-size limit), the extension's MD5 GUID is patched into the
    xmpNote:HasExtendedXMP attribute of the main chunk, and the extension is
    emitted as numbered chunks with total-size/offset headers.
    """
    if not data:
        return b""
    seg_size = 2 + len(data) + len(_XMP_TAG)
    if seg_size <= 0xFFFF:
        return _u16(0xFFE1) + _u16(seg_size) + _XMP_TAG + data

    if len(data) > (1 << 31):
        raise ValueError("XMP metadata too large")
    split = split_point if split_point else _XMP_MAIN_LIMIT
    split = min(split, len(data))
    note_pos = data.find(_XMP_NOTE)
    if note_pos < 0:
        raise ValueError("oversized XMP without xmpNote:HasExtendedXMP tag")
    if note_pos + len(_XMP_NOTE) + 32 + 1 > split:
        raise ValueError("ill-formed XMP: GUID placeholder beyond split point")
    if data[note_pos + len(_XMP_NOTE) + 32] != ord('"'):
        raise ValueError("ill-formed XMP: GUID placeholder not 32 chars")

    main = bytearray(data[:split])
    ext = data[split:]
    guid = hashlib.md5(ext).hexdigest().upper().encode("ascii")
    main[note_pos + len(_XMP_NOTE): note_pos + len(_XMP_NOTE) + 32] = guid

    out = bytearray(write_xmp(bytes(main)))
    header_size = len(_XMP_EXT_TAG) + 40
    n_chunks = len(ext) // _XMP_EXT_CHUNK + 1
    read_pos = 0
    for _ in range(n_chunks):
        chunk = ext[read_pos: read_pos + _XMP_EXT_CHUNK]
        out += _u16(0xFFE1) + _u16(2 + header_size + len(chunk))
        out += _XMP_EXT_TAG + guid + _u32(len(ext)) + _u32(read_pos) + chunk
        read_pos += len(chunk)
    return bytes(out)


def write_dqt(quant_matrices, yuv_mode: int) -> bytes:
    """DQT segment: matrices in zigzag order, table ids 0 (luma), 1 (chroma)."""
    num = 1 if yuv_mode == YUV_400 else 2
    data_size = num * 65 + 2
    out = bytearray([0xFF, 0xDB, 0x00, data_size])
    for n in range(num):
        out.append(n)
        q = np.asarray(quant_matrices[n], dtype=np.uint8)
        out += q[ZIGZAG].tobytes()
    return bytes(out)


def write_sof0(width: int, height: int, nb_comps: int, block_dims,
               quant_idx) -> bytes:
    data_size = 3 * nb_comps + 8
    out = bytearray([0xFF, 0xC0]) + _u16(data_size) + bytes([0x08])
    out += _u16(height) + _u16(width) + bytes([nb_comps])
    for c in range(nb_comps):
        out += bytes([c + 1, block_dims[c], quant_idx[c]])
    return bytes(out)


def write_dht(tables, nb_comps: int) -> bytes:
    """DHT segments for the active tables.

    `tables` is [dc_luma, dc_chroma, ac_luma, ac_chroma] HuffmanTable objects;
    grayscale images emit only the luma pair.
    """
    nb_tables = 1 if nb_comps == 1 else 2
    out = bytearray()
    for c in range(nb_tables):
        for type_ in range(2):   # 0 = DC, 1 = AC
            h = tables[type_ * 2 + c]
            data_size = 3 + 16 + h.nb_syms
            out += _u16(0xFFC4) + _u16(data_size)
            out.append((type_ << 4) | c)
            out += bytes(np.asarray(h.bits, dtype=np.uint8)[:16])
            out += bytes(np.asarray(h.syms, dtype=np.uint8)[:h.nb_syms])
    return bytes(out)


def write_sos(nb_comps: int, quant_idx) -> bytes:
    data_size = 3 + nb_comps * 2 + 3
    out = bytearray([0xFF, 0xDA]) + _u16(data_size) + bytes([nb_comps])
    for c in range(nb_comps):
        out += bytes([c + 1, quant_idx[c] * 0x11])
    out += bytes([0x00, 0x3F, 0x00])   # Ss, Se, Ah/Al
    return bytes(out)


EOI = bytes([0xFF, 0xD9])
