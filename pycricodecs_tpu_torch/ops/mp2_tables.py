"""MPEG Audio Layer II tables (ISO/IEC 11172-3, 13818-3).

A copy of pycricodecs_tpu/ops/mp2_tables.py (tests hold them equal): the
512-tap synthesis window and the analysis window made from it, the
bit-allocation tables and their MPEG-1 selection, the grouped classes, the
bitrate and sample-rate tables, the scalefactors, the synthesis and the
analysis matrixing (the last three from `_mp2_data` as stored float64
bits, see there), and the encoder's SNR of each quantisation class.
"""
from __future__ import annotations

import numpy as np

from . import _mp2_data

# Synthesis window D (ISO 11172-3 Table 3-B.3) x 65536.
SYNTH_WINDOW_INT = (
    0, -1, -1, -1, -1, -1, -1, -2, -2, -2,
    -2, -3, -3, -4, -4, -5, -5, -6, -7, -7,
    -8, -9, -10, -11, -13, -14, -16, -17, -19, -21,
    -24, -26, -29, -31, -35, -38, -41, -45, -49, -53,
    -58, -63, -68, -73, -79, -85, -91, -97, -104, -111,
    -117, -125, -132, -139, -147, -154, -161, -169, -176, -183,
    -190, -196, -202, -208, 213, 218, 222, 225, 227, 228,
    228, 227, 224, 221, 215, 208, 200, 189, 177, 163,
    146, 127, 106, 83, 57, 29, -2, -36, -72, -111,
    -153, -197, -244, -294, -347, -401, -459, -519, -581, -645,
    -711, -779, -848, -919, -991, -1064, -1137, -1210, -1283, -1356,
    -1428, -1498, -1567, -1634, -1698, -1759, -1817, -1870, -1919, -1962,
    -2001, -2032, -2057, -2075, -2085, -2087, -2080, -2063, 2037, 2000,
    1952, 1893, 1822, 1739, 1644, 1535, 1414, 1280, 1131, 970,
    794, 605, 402, 185, -45, -288, -545, -814, -1095, -1388,
    -1692, -2006, -2330, -2663, -3004, -3351, -3705, -4063, -4425, -4788,
    -5153, -5517, -5879, -6237, -6589, -6935, -7271, -7597, -7910, -8209,
    -8491, -8755, -8998, -9219, -9416, -9585, -9727, -9838, -9916, -9959,
    -9966, -9935, -9863, -9750, -9592, -9389, -9139, -8840, -8492, -8092,
    -7640, -7134, 6574, 5959, 5288, 4561, 3776, 2935, 2037, 1082,
    70, -998, -2122, -3300, -4533, -5818, -7154, -8540, -9975, -11455,
    -12980, -14548, -16155, -17799, -19478, -21189, -22929, -24694, -26482, -28289,
    -30112, -31947, -33791, -35640, -37489, -39336, -41176, -43006, -44821, -46617,
    -48390, -50137, -51853, -53534, -55178, -56778, -58333, -59838, -61289, -62684,
    -64019, -65290, -66494, -67629, -68692, -69679, -70590, -71420, -72169, -72835,
    -73415, -73908, -74313, -74630, -74856, -74992, 75038, 74992, 74856, 74630,
    74313, 73908, 73415, 72835, 72169, 71420, 70590, 69679, 68692, 67629,
    66494, 65290, 64019, 62684, 61289, 59838, 58333, 56778, 55178, 53534,
    51853, 50137, 48390, 46617, 44821, 43006, 41176, 39336, 37489, 35640,
    33791, 31947, 30112, 28289, 26482, 24694, 22929, 21189, 19478, 17799,
    16155, 14548, 12980, 11455, 9975, 8540, 7154, 5818, 4533, 3300,
    2122, 998, -70, -1082, -2037, -2935, -3776, -4561, -5288, -5959,
    6574, 7134, 7640, 8092, 8492, 8840, 9139, 9389, 9592, 9750,
    9863, 9935, 9966, 9959, 9916, 9838, 9727, 9585, 9416, 9219,
    8998, 8755, 8491, 8209, 7910, 7597, 7271, 6935, 6589, 6237,
    5879, 5517, 5153, 4788, 4425, 4063, 3705, 3351, 3004, 2663,
    2330, 2006, 1692, 1388, 1095, 814, 545, 288, 45, -185,
    -402, -605, -794, -970, -1131, -1280, -1414, -1535, -1644, -1739,
    -1822, -1893, -1952, -2000, 2037, 2063, 2080, 2087, 2085, 2075,
    2057, 2032, 2001, 1962, 1919, 1870, 1817, 1759, 1698, 1634,
    1567, 1498, 1428, 1356, 1283, 1210, 1137, 1064, 991, 919,
    848, 779, 711, 645, 581, 519, 459, 401, 347, 294,
    244, 197, 153, 111, 72, 36, 2, -29, -57, -83,
    -106, -127, -146, -163, -177, -189, -200, -208, -215, -221,
    -224, -227, -228, -228, -227, -225, -222, -218, 213, 208,
    202, 196, 190, 183, 176, 169, 161, 154, 147, 139,
    132, 125, 117, 111, 104, 97, 91, 85, 79, 73,
    68, 63, 58, 53, 49, 45, 41, 38, 35, 31,
    29, 26, 24, 21, 19, 17, 16, 14, 13, 11,
    10, 9, 8, 7, 7, 6, 5, 5, 4, 4,
    3, 3, 2, 2, 2, 2, 1, 1, 1, 1,
    1, 1,
)


def synth_window(dtype=np.float64) -> np.ndarray:
    """D[512] (the integers over 65536: exact in float64)."""
    return np.asarray(SYNTH_WINDOW_INT, dtype=dtype) / dtype(65536.0)


def analysis_window(dtype=np.float64) -> np.ndarray:
    """ISO Table 3-C.1 analysis window C[i] = D[i] / 32, [512] of `dtype`
    (exact in float64: the integers over 2^21)."""
    return np.asarray(SYNTH_WINDOW_INT, dtype=dtype) / dtype(65536.0 * 32.0)


# --- Layer II bit-allocation tables -----------------------------------------
# Per subband, the quant classes of each allocation index: entry 0 is "no
# samples", the others the number of quantisation levels; nbal is
# log2(len(list)). Classes 3/5/9 are grouped (one 5/7/10-bit code per three
# samples), all others ungrouped (three codes of code_bits(n) bits).

_L4A = [0, 3, 7, 15, 31, 63, 127, 255, 511, 1023, 2047, 4095, 8191, 16383,
        32767, 65535]                                   # 3-B.2a/b sb 0-2
_L4B = [0, 3, 5, 7, 9, 15, 31, 63, 127, 255, 511, 1023, 2047, 4095, 8191,
        65535]                                          # 3-B.2a/b sb 3-10
_L3B = [0, 3, 5, 7, 9, 15, 31, 65535]                   # 3-B.2a/b sb 11+
_L2B = [0, 3, 5, 65535]                                 # 3-B.2a/b top sbs
_L4C = [0, 3, 5, 9, 15, 31, 63, 127, 255, 511, 1023, 2047, 4095, 8191, 16383,
        32767]                                          # 3-B.2c/d sb 0-1
_L3C = [0, 3, 5, 9, 15, 31, 63, 127]                    # 3-B.2c/d sb 2+
_L4L = [0, 3, 5, 7, 9, 15, 31, 63, 127, 255, 511, 1023, 2047, 4095, 8191,
        16383]                                          # 13818-3 B.1 sb 0-3
_L2L = [0, 3, 5, 9]                                     # 13818-3 B.1 sb 11+

ALLOC_TABLES = {
    0: [_L4A] * 3 + [_L4B] * 8 + [_L3B] * 12 + [_L2B] * 4,    # 27 subbands
    1: [_L4A] * 3 + [_L4B] * 8 + [_L3B] * 12 + [_L2B] * 7,    # 30 subbands
    2: [_L4C] * 2 + [_L3C] * 6,                               # 8 subbands
    3: [_L4C] * 2 + [_L3C] * 10,                              # 12 subbands
    4: [_L4L] * 4 + [_L3C] * 7 + [_L2L] * 19,                 # LSF, 30
}

# MPEG-1 table selection [sfreq(44.1,48,32)][stereo? 0 : mono 1][bitrate_idx]
TABLE_SELECT = (
    ((0, 2, 2, 2, 2, 2, 2, 0, 0, 0, 1, 1, 1, 1, 1, 0),
     (0, 2, 2, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0)),
    ((0, 2, 2, 2, 2, 2, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0),
     (0, 2, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0)),
    ((0, 3, 3, 3, 3, 3, 3, 0, 0, 0, 1, 1, 1, 1, 1, 0),
     (0, 3, 3, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0)),
)

GROUP_BITS = {3: 5, 5: 7, 9: 10}       # grouped classes: one code / 3 samples

BITRATES_V1_L2 = (0, 32, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256,
                  320, 384)            # kbps, index 1..14
BITRATES_V2_L2 = (0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144,
                  160)
SAMPLE_RATES_V1 = (44100, 48000, 32000)
SAMPLE_RATES_V2 = (22050, 24000, 16000)


def code_bits(levels: int) -> int:
    """Bits per (ungrouped) code: smallest b with 2**b > levels."""
    b = 1
    while (1 << b) - 1 < levels:
        b += 1
    return b


def scalefactors(dtype=np.float64) -> np.ndarray:
    """ISO Table 3-B.1: sf[idx] = 2**(1 - idx/3), idx 0..62 (63 unused),
    [64] of `dtype` (the float64 values rounded to it)."""
    return _mp2_data.SCALEFACTORS.astype(dtype)


def synthesis_matrixing(dtype=np.float64) -> np.ndarray:
    """N[64, 32] = cos((16 + i)(2k + 1) pi / 64), float64 rounded to
    `dtype`: the ISO matrixing the synthesis applies once per 32-sample
    granule row."""
    return _mp2_data.SYNTHESIS_MATRIXING.astype(dtype)


def analysis_matrix(dtype=np.float64) -> np.ndarray:
    """M[32, 64] = cos((2k + 1)(q - 16) pi / 64), float64 rounded to
    `dtype`: S = M @ Y with Y the windowed and folded input (X[0] the
    newest sample)."""
    return _mp2_data.ANALYSIS_MATRIX.astype(dtype)


#: 20 log10(n) of every quantisation class n, as the JAX package's
#: models/ahx.py::_class_meta computes it with numpy; literal values (tests
#: hold them equal), so that no machine's log10 enters the encoder's tables
CLASS_SNR_DB = {
    3: 9.542425094393248,
    5: 13.979400086720377,
    7: 16.901960800285135,
    9: 19.084850188786497,
    15: 23.521825181113627,
    31: 29.827233876685455,
    63: 35.986810989071635,
    127: 42.07607441911914,
    255: 48.1308036086791,
    511: 54.16841800269425,
    1023: 60.1975126742432,
    2047: 66.22235685325012,
    4095: 72.24507812192874,
    8191: 78.26673851865246,
    16383: 84.28786862510412,
    32767: 90.30873362283398,
    65535: 96.32946607530499,
}
