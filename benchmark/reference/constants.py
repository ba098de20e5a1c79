"""Constants of sjpeg's baseline encoder, frozen for the benchmark's plain
reference (zigzag order, Annex K.1 matrices and K.3 Huffman tables, the
quantizer's and the colour converter's fixed point, the fDCT's cosine
tables, the adaptive fit's parameters).  Sources: sjpeg src/enc.cc:43-96,
327-421, 986-991; src/colors_rgb.cc:17-31; src/fdct.cc:28-43."""

import numpy as np

# ---------------------------------------------------------------------------
# Scan order
# ---------------------------------------------------------------------------

# zigzag[i] = raster position of the i-th coefficient in zigzag order.
ZIGZAG = np.array([
    0,   1,  8, 16,  9,  2,  3, 10,
    17, 24, 32, 25, 18, 11,  4,  5,
    12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13,  6,  7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46,
    53, 60, 61, 54, 47, 55, 62, 63,
], dtype=np.int32)

# Inverse permutation: UNZIGZAG[raster] = zigzag rank.
UNZIGZAG = np.zeros(64, dtype=np.int32)
UNZIGZAG[ZIGZAG] = np.arange(64, dtype=np.int32)

# ---------------------------------------------------------------------------
# Quantization (JPEG spec Annex K.1)
# ---------------------------------------------------------------------------

DEFAULT_QUANT_MATRICES = np.array([
    # luma
    [16,  11,  10,  16,  24,  40,  51,  61,
     12,  12,  14,  19,  26,  58,  60,  55,
     14,  13,  16,  24,  40,  57,  69,  56,
     14,  17,  22,  29,  51,  87,  80,  62,
     18,  22,  37,  56,  68, 109, 103,  77,
     24,  35,  55,  64,  81, 104, 113,  92,
     49,  64,  78,  87, 103, 121, 120, 101,
     72,  92,  95,  98, 112, 100, 103,  99],
    # chroma
    [17,  18,  24,  47,  99,  99,  99,  99,
     18,  21,  26,  66,  99,  99,  99,  99,
     24,  26,  56,  99,  99,  99,  99,  99,
     47,  66,  99,  99,  99,  99,  99,  99,
     99,  99,  99,  99,  99,  99,  99,  99,
     99,  99,  99,  99,  99,  99,  99,  99,
     99,  99,  99,  99,  99,  99,  99,  99,
     99,  99,  99,  99,  99,  99,  99,  99],
], dtype=np.uint8)

# Fixed-point precision of the quantizer's reciprocal multiply (enc.cc:327-329).
FP_BITS = 16   # fractional precision of reciprocal quantizer multipliers
AC_BITS = 4    # extra precision carried by the fDCT output (scaled x16)
BIAS_DC = 0x80  # mandatory neutral bias for the DC coefficient

DEFAULT_QUALITY = 75.0
DEFAULT_METHOD = 4
DEFAULT_BIAS = 0x78              # AC rounding bias, 8-bit fixed point
DEFAULT_DELTA_MAX_LUMA = 12      # adaptive-quant max positive delta (luma)
DEFAULT_DELTA_MAX_CHROMA = 1     # adaptive-quant max positive delta (chroma)

# Adaptive-quantization histogram parameters (enc.cc:43-61, sjpegi.h:176-202)
HSHIFT = 2                    # histogram binning shift on |coeff|
HHALF = 1 << HSHIFT >> 1
MAX_HISTO_DCT_COEFF = 1 << (9 - HSHIFT)  # number of histogram bins (=128)
QDELTA_MIN = -12
QDELTA_MAX = 12
QSIZE = 1 + QDELTA_MAX - QDELTA_MIN      # = 25
HLAMBDA = 0x80
DENSITY_THRESHOLD = 0.5
CORRELATION_THRESHOLD = 0.5
# Bitmap of raster positions whose quantizer is never tuned (DC + 2 lowest AC).
OMITTED_CHANNELS = 0x103

# Gaussian (sigma ~= 3) weights over the QSIZE delta window used by the
# lambda least-squares fit of AnalyseHisto (enc.cc:986-991).
HISTO_WEIGHT = np.array([
    0, 0, 0, 0, 0,
    1, 5, 16, 43, 94, 164, 228, 255, 228, 164, 94, 43, 16, 5, 1,
    0, 0, 0, 0, 0,
], dtype=np.float64)

# ---------------------------------------------------------------------------
# RGB -> YUV fixed point (BT.601 full range), FRAC = 16 (colors_rgb.cc:17-31)
# ---------------------------------------------------------------------------

YUV_FRAC = 16
YUV_HALF = 1 << (YUV_FRAC - 1)
ROUND_Y = YUV_HALF - (128 << YUV_FRAC)  # folds the -128 level shift into Y
ROUND_UV = YUV_HALF << 2                # rounding for 4-pixel-summed chroma

RGB_TO_Y = np.array([19595, 38469, 7471], dtype=np.int64)
RGB_TO_U = np.array([-11059, -21709, 32768], dtype=np.int64)
RGB_TO_V = np.array([32768, -27439, -5329], dtype=np.int64)

# ---------------------------------------------------------------------------
# fDCT 15-bit fixed-point constants (fdct.cc:28-43)
# ---------------------------------------------------------------------------

FDCT_K_TAN1 = 13036     # tan(pi/16)
FDCT_K_TAN2 = 27146     # tan(2*pi/16)
FDCT_K_TAN3M1 = -21746  # tan(3*pi/16) - 1
FDCT_K_2SQRT2 = 23170   # 1/(2*sqrt(2))

# Row-pass cosine tables: C(k) = cos(k*pi/16)/sqrt(2) in Q15, with rows
# 1/7, 2/6, 3/5 pre-multiplied by 2*C(1), 2*C(2), 2*C(3) respectively.
FDCT_TABLE04 = np.array([22725, 21407, 19266, 16384, 12873, 8867, 4520],
                        dtype=np.int64)
FDCT_TABLE17 = np.array([31521, 29692, 26722, 22725, 17855, 12299, 6270],
                        dtype=np.int64)
FDCT_TABLE26 = np.array([29692, 27969, 25172, 21407, 16819, 11585, 5906],
                        dtype=np.int64)
FDCT_TABLE35 = np.array([26722, 25172, 22654, 19266, 15137, 10426, 5315],
                        dtype=np.int64)

# ROW_TABLES[r] = the 7-entry cosine table used by output row r.
FDCT_ROW_TABLES = np.stack([
    FDCT_TABLE04, FDCT_TABLE17, FDCT_TABLE26, FDCT_TABLE35,
    FDCT_TABLE04, FDCT_TABLE35, FDCT_TABLE26, FDCT_TABLE17,
])

# ---------------------------------------------------------------------------
# Default Huffman tables (JPEG spec Annex K.3; reference src/enc.cc:368-421)
# ---------------------------------------------------------------------------

K3_DC_SYMS = np.arange(12, dtype=np.uint8)

K3_AC_SYMS_LUMA = np.array([
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12,
    0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07,
    0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0,
    0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16,
    0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49,
    0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69,
    0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79,
    0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98,
    0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
    0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5,
    0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4,
    0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea,
    0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8,
    0xf9, 0xfa], dtype=np.uint8)

K3_AC_SYMS_CHROMA = np.array([
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21,
    0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71,
    0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0,
    0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34,
    0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48,
    0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68,
    0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78,
    0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96,
    0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
    0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2,
    0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9,
    0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8,
    0xf9, 0xfa], dtype=np.uint8)

# (bits-per-length histogram [16], symbol list) for DC-luma / DC-chroma /
# AC-luma / AC-chroma.
K3_DC_BITS_LUMA = np.array(
    [0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], dtype=np.uint8)
K3_DC_BITS_CHROMA = np.array(
    [0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], dtype=np.uint8)
K3_AC_BITS_LUMA = np.array(
    [0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125], dtype=np.uint8)
K3_AC_BITS_CHROMA = np.array(
    [0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119], dtype=np.uint8)

# ---------------------------------------------------------------------------
# YUV modes (mirrors the SjpegYUVMode enum contract, sjpeg.h:54-60)
# ---------------------------------------------------------------------------

YUV_AUTO = 0
YUV_420 = 1
YUV_SHARP = 2   # sharp (iterative) YUV 4:2:0
YUV_444 = 3
YUV_400 = 4     # grayscale

MAX_DIMENSION = 65535  # JPEG SOF fields are 16-bit

