"""HCA format constant tables (decode and encode).

Closed-form tables are generated in float64 and rounded once to float32,
which reproduces the format's exact fp32 bit patterns; irregular tables come
from `_hca_data`. Reference anchors: hca.cpp:451-485 (ATH), 887-960 (channel
types), 1260-1287 (dequantizer), 1579-1598 (scale conversion), 1689-1693
(intensity), 2030-2112 (encoder quantizer tables).
"""
from __future__ import annotations

import numpy as np

from . import _hca_data as data

SUBFRAMES = 8
SAMPLES_PER_SUBFRAME = 128
MDCT_BITS = 7

#: dequantizer step sizes: 1 / ((2^b - 1) / 2) style half-steps
QUANTIZER_INVERSE_STEP_SIZE = np.float32(
    [0.5, 1.5, 2.5, 3.5, 4.5, 5.5, 6.5, 7.5,
     15.5, 31.5, 63.5, 127.5, 255.5, 511.5, 1023.5, 2047.5])

#: scalefactor -> scaling: sqrt(128) * (2^(53/128))^(sf - 63)
SCALING_TABLE = np.float32([2.0 ** (3.5 + (i - 63) * 53.0 / 128.0)
                            for i in range(64)])

#: resolution -> range scale: 1 / inverse_step_size (index 0 is 1.0)
RANGE_TABLE = np.float32([1.0] + [1.0 / float(s) for s in
                                  QUANTIZER_INVERSE_STEP_SIZE[1:]])

#: scalefactor-delta -> ratio: 2^((i - 63) * 53/128), 0 at both rails
SCALE_CONVERSION_TABLE = np.float32(
    [0.0] + [2.0 ** ((i - 63) * 53.0 / 128.0) for i in range(1, 126)]
    + [0.0, 0.0])

#: intensity index -> L ratio: (14 - i) / 7
INTENSITY_RATIO_TABLE = np.float32([(14 - i) / 7.0 for i in range(15)]
                                   + [0.0])

#: encoder intensity quantisation boundaries: midpoints of the ratio table
INTENSITY_RATIO_BOUNDS = np.float32([(27 - 2 * i) / 14.0 for i in range(14)])

#: encoder dead zones: half a quantisation step
QUANTIZER_DEAD_ZONE = np.float32(
    [0.0] + [1.0 / (2.0 * float(s)) for s in QUANTIZER_INVERSE_STEP_SIZE[1:]])

#: encoder scaling (inverse of SCALING_TABLE): 2^((63 - i) * 53/128 - 3.5)
QUANTIZER_SCALING_TABLE = np.float32(
    [2.0 ** ((63 - i) * 53.0 / 128.0 - 3.5) for i in range(64)])

ATH_BASE_CURVE = data.ATH_BASE_CURVE                  # [656] u8
INVERT_TABLE = data.INVERT_TABLE                      # [66] u8: curve -> res
IMDCT_SIN = data.IMDCT_SIN                            # [7, 64] f32
IMDCT_COS = data.IMDCT_COS                            # [7, 64] f32
IMDCT_WINDOW = data.IMDCT_WINDOW                      # [128] f32
DCT4_SIN_FLAT = data.DCT4_SIN_FLAT                    # ragged stages, [255] f32
DCT4_COS_FLAT = data.DCT4_COS_FLAT
SHUFFLE_TABLE = data.SHUFFLE_TABLE                    # [128] u8
SCALE_TO_RESOLUTION_CURVE = data.SCALE_TO_RESOLUTION_CURVE  # [59] u8
QUANTIZE_SPECTRUM_BITS = data.QUANTIZE_SPECTRUM_BITS  # [8, 16] u8
QUANTIZE_SPECTRUM_VALUE = data.QUANTIZE_SPECTRUM_VALUE  # [8, 16] u8 (codes)
VALID_CHANNEL_MAPPINGS = data.VALID_CHANNEL_MAPPINGS  # [8, 8] u8
DEFAULT_CHANNEL_MAPPING = data.DEFAULT_CHANNEL_MAPPING  # [9] u8
QUANTIZED_SPECTRUM_MAX_BITS = data.QUANTIZED_SPECTRUM_MAX_BITS  # [16] u8


def dct4_stage_tables(stage: int):
    """Encoder DCT-IV twiddles for stage `stage` (0..7); length 2**stage."""
    lo = (1 << stage) - 1
    hi = (1 << (stage + 1)) - 1
    return DCT4_SIN_FLAT[lo:hi], DCT4_COS_FLAT[lo:hi]


def ath_curve(ath_type: int, sample_rate: int) -> np.ndarray:
    """Per-band ATH thresholds (hca.cpp:451-485). Returns [128] u8."""
    if ath_type == 0:
        return np.zeros(SAMPLES_PER_SUBFRAME, dtype=np.uint8)
    if ath_type != 1:
        raise ValueError("Unknown ATH type")
    acc = (np.arange(1, SAMPLES_PER_SUBFRAME + 1, dtype=np.uint64)
           * sample_rate)
    index = (acc >> 13).astype(np.int64)
    out = np.full(SAMPLES_PER_SUBFRAME, 0xFF, dtype=np.uint8)
    valid = index < 654
    out[valid] = ATH_BASE_CURVE[index[valid]]
    return out


DISCRETE, STEREO_PRIMARY, STEREO_SECONDARY = 0, 1, 2


def channel_types(channels: int, track_count: int, stereo_band_count: int,
                  channel_config: int) -> np.ndarray:
    """Per-channel type assignment (hca.cpp:887-960). Returns [channels] u8."""
    types = np.zeros(channels, dtype=np.uint8)
    cpt = channels // max(track_count, 1)
    if stereo_band_count > 0 and cpt > 1:
        layouts = {
            2: [1, 2],
            3: [1, 2, 0],
            4: [1, 2, 1, 2] if channel_config == 0 else [1, 2, 0, 0],
            5: [1, 2, 0, 1, 2] if channel_config <= 2 else [1, 2, 0, 0, 0],
            6: [1, 2, 0, 0, 1, 2],
            7: [1, 2, 0, 0, 1, 2, 0],
            8: [1, 2, 0, 0, 1, 2, 1, 2],
        }
        layout = layouts.get(cpt)
        if layout is not None:
            for t in range(max(track_count, 1)):
                types[t * cpt:(t + 1) * cpt] = layout
    return types
