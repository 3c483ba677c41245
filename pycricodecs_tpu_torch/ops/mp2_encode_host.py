"""Host configuration of one MPEG Layer II encode group (AHX encode).

A copy of the configuration half of pycricodecs_tpu/models/ahx.py::
encode_mp2 (its preamble, `_class_meta` and the padding-slot accumulator;
tests hold them equal): for a (channels, sample rate, bitrate, joint bound)
it fixes the MPEG version, the header's indices, mode and mode extension,
the probe header's allocation table, sblimit and bound, the allocation
field bits, the per-subband class tables the greedy allocation reads, and,
per frame count, the CBR frame sizes, padding bits and bit budgets. It
raises the JAX encoder's ValueErrors with the same text, in the same order.

The class SNRs are literal float64 values (mp2_tables.CLASS_SNR_DB), not a
log10 of this machine's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from . import mp2_frame
from . import mp2_tables as T

#: the most classes a subband has (nbal 4)
MAX_CLASSES = 16
#: what an encode of no samples raises (the JAX encoder fails there inside
#: its stream packer, with numpy's reshape ValueError)
EMPTY_STREAM = "Layer II encode of an empty stream (no samples)."


@dataclass(frozen=True)
class EncodeConfig:
    channels: int
    sample_rate: int
    bitrate_kbps: int
    version: int              # header field: 3 MPEG-1, 2 MPEG-2 LSF
    sr_idx: int
    bitrate_idx: int
    mode: int                 # 3 mono, 0 stereo, 1 joint
    mode_ext: int
    joint: bool
    hdr: mp2_frame.Mp2Header  # the probe header (padding 0)
    nbal_bits: int            # allocation field bits of a frame
    nbal: np.ndarray          # i32 [32]: allocation field width (0 past sblimit)
    ncls: np.ndarray          # i32 [32]: classes of the subband (0 past sblimit)
    bits_tbl: np.ndarray      # i32 [32, 17]: sample bits a frame by class
    levels_tbl: np.ndarray    # i32 [32, 16]: levels by class
    snr_tbl: np.ndarray       # f64 [32, 16]: SNR dB by class (inf past ncls)

    @property
    def sblimit(self) -> int:
        return self.hdr.sblimit

    @property
    def bound(self) -> int:
        return self.hdr.bound

    @property
    def header_base(self) -> int:
        """The frame header word with the padding bit clear."""
        return mp2_frame.header_word(self.version, self.bitrate_idx,
                                     self.sr_idx, 0, self.mode,
                                     self.mode_ext)

    def frame_plan(self, F: int):
        """(pads i32 [F], frame_sizes i64 [F], budgets i32 [F]) of the CBR
        padding-slot accumulator: frame f pads where the running remainder
        (f + 1) * r mod sample_rate wraps, r = 144 * bitrate % rate (the
        JAX loop's acc, in closed form)."""
        slots_num = 144 * self.bitrate_kbps * 1000
        r = slots_num % self.sample_rate
        f = np.arange(F + 1, dtype=np.int64)
        pads = np.diff(f * r // self.sample_rate).astype(np.int32)
        frame_sizes = slots_num // self.sample_rate + pads.astype(np.int64)
        budgets = (frame_sizes * 8 - 32 - self.nbal_bits).astype(np.int32)
        return pads, frame_sizes, budgets


def _class_meta(table_id: int):
    """Per-subband (class list, sample bits a frame, SNR dB) lists."""
    metas = []
    for classes in T.ALLOC_TABLES[table_id]:
        bits, snr = [0], [0.0]
        for n in classes[1:]:
            gb = T.GROUP_BITS.get(n)
            per_gr = gb if gb is not None else 3 * T.code_bits(n)
            bits.append(12 * per_gr)
            snr.append(T.CLASS_SNR_DB[n])
        metas.append((classes, bits, snr))
    return metas


def configure(channels: int, sample_rate: int,
              bitrate_kbps: Optional[int] = None,
              joint_bound: Optional[int] = None) -> EncodeConfig:
    """The encode configuration of `channels` at `sample_rate`; bitrate None
    picks 80 kbps a channel for MPEG-2 LSF and 128 for MPEG-1."""
    C = channels
    if C not in (1, 2):
        raise ValueError("Layer II supports 1 or 2 channels.")
    if joint_bound is not None and joint_bound not in (4, 8, 12, 16):
        raise ValueError("joint_bound must be one of 4/8/12/16.")
    joint = joint_bound is not None and C == 2
    if sample_rate in T.SAMPLE_RATES_V2:
        version, rates = 2, T.BITRATES_V2_L2
        sr_idx = T.SAMPLE_RATES_V2.index(sample_rate)
        if bitrate_kbps is None:
            bitrate_kbps = 80 * C
    elif sample_rate in T.SAMPLE_RATES_V1:
        version, rates = 3, T.BITRATES_V1_L2
        sr_idx = T.SAMPLE_RATES_V1.index(sample_rate)
        if bitrate_kbps is None:
            bitrate_kbps = 128 * C
    else:
        raise ValueError(f"Unsupported Layer II sample rate {sample_rate}.")
    if bitrate_kbps not in rates[1:]:
        raise ValueError(f"Unsupported Layer II bitrate {bitrate_kbps} "
                         f"(valid: {sorted(rates[1:])}).")
    bitrate_idx = rates.index(bitrate_kbps)
    mode = 3 if C == 1 else (1 if joint else 0)
    mode_ext = (joint_bound // 4 - 1) if joint else 0
    hdr = mp2_frame.parse_header(
        mp2_frame.header_word(version, bitrate_idx, sr_idx, 0, mode,
                              mode_ext).to_bytes(4, "big"))
    metas = _class_meta(hdr.table_id)
    nbal = np.zeros(32, np.int32)
    ncls = np.zeros(32, np.int32)
    bits_tbl = np.zeros((32, MAX_CLASSES + 1), np.int32)
    levels_tbl = np.zeros((32, MAX_CLASSES), np.int32)
    snr_tbl = np.full((32, MAX_CLASSES), np.inf)
    for sb, (classes, bits, snr) in enumerate(metas):
        k = len(classes)
        nbal[sb] = (k - 1).bit_length()
        ncls[sb] = k
        bits_tbl[sb, :k] = bits
        bits_tbl[sb, k:] = bits[-1]
        levels_tbl[sb, :k] = classes
        snr_tbl[sb, :k] = snr
    nbal_bits = sum(int(nbal[sb]) * (C if sb < hdr.bound else 1)
                    for sb in range(hdr.sblimit))
    return EncodeConfig(C, sample_rate, bitrate_kbps, version, sr_idx,
                        bitrate_idx, mode, mode_ext, joint, hdr, nbal_bits,
                        nbal, ncls, bits_tbl, levels_tbl, snr_tbl)
