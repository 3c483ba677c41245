"""HCA encoder host pieces (numpy): stream configuration, PCM timeline and
header bytes.

Copies of pycricodecs_tpu/ops/hca_encode_host.py (reference hca.cpp:
2206-3164), held equal to it by tests/test_torch_host.py. The batched encode
(hca_encode_device.encode_batch_device) derives each stream's configuration
on the host (`init_encode`), builds the PCM timeline the reference's
streaming buffer feeds (`build_timeline`) and prepends the header bytes
(`pack_header`); everything between runs on the device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from . import hca_frame
from . import hca_tables as T
from ..utils import wav as wavmod
from ..utils.crc import crc16

f32 = np.float32

SAMPLES_PER_FRAME = 1024


def _div_round_up(value: int, divisor: int) -> int:
    """(int)ceil((float)value / divisor) — float32 division like the reference."""
    return int(math.ceil(f32(value) / f32(divisor)))


def _get_next_multiple(value: int, multiple: int) -> int:
    if multiple <= 0 or value % multiple == 0:
        return value
    return value + multiple - value % multiple


def calculate_bitrate(channels: int, sample_rate: int, quality: int) -> int:
    pcm_bitrate = sample_rate * channels * 16
    max_bitrate = pcm_bitrate // 4
    # C switch on the enum: Highest..Lowest = 0..4; any other value falls
    # through to the default ratio 6, like the reference (hca.cpp:2210-2227)
    ratios = {0: 4, 1: 6, 2: 8,
              3: 10 if channels == 1 else 12,
              4: 12 if channels == 1 else 16}
    ratio = ratios.get(quality, 6)
    bitrate = pcm_bitrate // ratio
    return min(bitrate, max_bitrate)


@dataclass
class EncConfig:
    info: hca_frame.HcaInfo
    post_samples: int
    buffer_pre_samples: int
    sample_count_per_channel: int
    input_sample_count: int
    hfr_band_count: int


def init_encode(wav: wavmod.WavFile, quality: int,
                loop_flag: bool) -> EncConfig:
    """Mirror of initHCAEncode (hca.cpp:2414-2462)."""
    info = hca_frame.HcaInfo()
    info.version = 0x0200
    info.channels = wav.channels
    info.track_count = 1
    info.sample_rate = wav.sample_rate
    info.min_resolution = 1
    info.max_resolution = 15
    info.encoder_delay = 128
    info.loop_flag = loop_flag
    cutoff = wav.sample_rate // 2
    post_samples = 128

    scc = wav.num_samples // wav.channels

    bitrate = calculate_bitrate(info.channels, info.sample_rate, quality)

    # CalculateBandCounts (hca.cpp:2236-2270)
    info.frame_size = bitrate * 1024 // info.sample_rate // 8
    pcm_bitrate = info.sample_rate * info.channels * 16
    if info.channels <= 1 or pcm_bitrate // bitrate <= 6:
        hfr_ratio, cutoff_ratio = 6, 12
    else:
        hfr_ratio, cutoff_ratio = 8, 16
    if bitrate < pcm_bitrate // cutoff_ratio:
        cutoff = min(cutoff, cutoff_ratio * bitrate // (32 * info.channels))
    total_band_count = int(round(cutoff * 256.0 / info.sample_rate))
    hfr_start_band = min(total_band_count,
                         int(round(hfr_ratio * bitrate * 128.0 / pcm_bitrate)))
    stereo_start_band = (hfr_start_band if hfr_ratio == 6
                         else (hfr_start_band + 1) // 2)
    hfr_band_count_init = total_band_count - hfr_start_band
    bands_per_group = _div_round_up(hfr_band_count_init, 8)
    num_groups = _div_round_up(hfr_band_count_init, bands_per_group) \
        if bands_per_group > 0 else 0
    info.total_band_count = total_band_count
    info.base_band_count = stereo_start_band
    info.stereo_band_count = hfr_start_band - stereo_start_band
    info.hfr_group_count = num_groups
    info.bands_per_hfr_group = bands_per_group

    # CalculateHfrValues (hca.cpp:2272-2277)
    hfr_band_count = 0
    if info.bands_per_hfr_group > 0:
        hfr_band_count = (info.total_band_count - info.base_band_count
                          - info.stereo_band_count)
        info.hfr_group_count = _div_round_up(hfr_band_count,
                                             info.bands_per_hfr_group)

    # SetChannelConfiguration (hca.cpp:2279-2290)
    cpt = info.channels // info.track_count
    config = int(T.DEFAULT_CHANNEL_MAPPING[cpt])
    if T.VALID_CHANNEL_MAPPINGS[cpt - 1][config] != 1:
        raise hca_frame.HcaError("Error setting up channel configuration.")
    info.channel_config = config

    sample_count_per_channel = scc
    input_sample_count = scc
    if loop_flag:
        loop_start, loop_end = wav.loop_start, wav.loop_end
        sample_count_per_channel = min(loop_end, wav.num_samples)
        info.encoder_delay += (_get_next_multiple(loop_start, SAMPLES_PER_FRAME)
                               - loop_start)
        # CalculateLoopInfo (hca.cpp:2292-2305)
        ls = loop_start + info.encoder_delay
        le = loop_end + info.encoder_delay
        info.loop_start_frame = ls // SAMPLES_PER_FRAME
        info.loop_start_delay = ls % SAMPLES_PER_FRAME
        info.loop_end_frame = le // SAMPLES_PER_FRAME
        info.loop_end_padding = SAMPLES_PER_FRAME - le % SAMPLES_PER_FRAME
        if info.loop_end_padding == SAMPLES_PER_FRAME:
            info.loop_end_frame -= 1
            info.loop_end_padding = 0
        input_sample_count = min(
            _get_next_multiple(sample_count_per_channel, 128), wav.num_samples)
        input_sample_count += 128 * 2
        post_samples = input_sample_count - sample_count_per_channel

    # CalculateHeaderSize (hca.cpp:2307-2321)
    info.header_size = _get_next_multiple(96, 32)
    if loop_flag:
        loop_frame_offset = (info.header_size
                             + info.frame_size * info.loop_start_frame)
        padding_bytes = (_get_next_multiple(loop_frame_offset, 2048)
                         - loop_frame_offset)
        padding_frames = padding_bytes // info.frame_size
        info.encoder_delay += padding_frames * SAMPLES_PER_FRAME
        info.loop_start_frame += padding_frames
        info.loop_end_frame += padding_frames
        info.header_size += padding_bytes % info.frame_size

    total_samples = input_sample_count + info.encoder_delay
    info.frame_count = _div_round_up(total_samples, SAMPLES_PER_FRAME)
    info.encoder_padding = (info.frame_count * SAMPLES_PER_FRAME
                            - info.encoder_delay - input_sample_count)
    info.init_derived()
    return EncConfig(info=info, post_samples=post_samples,
                     buffer_pre_samples=info.encoder_delay - 128,
                     sample_count_per_channel=sample_count_per_channel,
                     input_sample_count=input_sample_count,
                     hfr_band_count=hfr_band_count)


def build_timeline(cfg: EncConfig, wav: wavmod.WavFile) -> np.ndarray:
    """Reproduce the streaming buffer feed (hca.cpp:2990-3107) as one array.

    Returns int16 [channels, frame_count * 1024].
    """
    info = cfg.info
    C = info.channels
    total = info.frame_count * SAMPLES_PER_FRAME
    per_ch = wav.pcm16.reshape(-1, C).T  # [C, samples]
    timeline = np.zeros((C, total), dtype=np.int16)

    pre = cfg.buffer_pre_samples
    # lead frames of silence while pre > 1024
    nlead = 0
    while pre > SAMPLES_PER_FRAME:
        nlead += 1
        pre -= SAMPLES_PER_FRAME
    pos = nlead * SAMPLES_PER_FRAME
    # remaining pre samples replicate the first input sample (hca.cpp:3007-3009)
    if pre > 0 and per_ch.shape[1] > 0:
        timeline[:, pos:pos + pre] = per_ch[:, 0:1]
    pos += pre
    # main audio (clamped to sample_count_per_channel for loops)
    scc = min(cfg.sample_count_per_channel, per_ch.shape[1])
    timeline[:, pos:pos + scc] = per_ch[:, :scc]
    pos += scc
    # post audio: loop region replay (or silence when not looping).
    # SaveLoopAudio (hca.cpp:3015-3026) accrues the loop window from the
    # encoder's 1024-sample input chunks and stops accruing the moment main
    # audio exhausts, so the captured window ends at the 1024 boundary of the
    # chunk where sample_count_per_channel falls; the PostAudio buffer's
    # remaining samples stay zero even when the input continues past it.
    if info.loop_flag and cfg.post_samples > 0:
        loop_start_sample = (info.loop_start_frame * SAMPLES_PER_FRAME
                             + info.loop_start_delay - info.encoder_delay)
        chunk_end = ((max(cfg.sample_count_per_channel, 1) - 1)
                     // SAMPLES_PER_FRAME + 1) * SAMPLES_PER_FRAME
        src_end = min(loop_start_sample + cfg.post_samples, chunk_end,
                      per_ch.shape[1])
        src = per_ch[:, loop_start_sample:src_end]
        n = min(src.shape[1], total - pos)
        timeline[:, pos:pos + n] = src[:, :n]
    return timeline


def pack_header(info: hca_frame.HcaInfo) -> bytes:
    """PackHeader (hca.cpp:3109-3164): HCA v2.0 header bytes."""
    out = bytearray(info.header_size)
    out[0:4] = b"HCA\x00"
    out[4:6] = (0x0200).to_bytes(2, "big")
    out[6:8] = info.header_size.to_bytes(2, "big")
    out[8:12] = b"fmt\x00"
    out[12:16] = info.sample_rate.to_bytes(4, "big")
    out[12] = info.channels
    out[16:20] = info.frame_count.to_bytes(4, "big")
    out[20:22] = (info.encoder_delay & 0xFFFF).to_bytes(2, "big")
    out[22:24] = (info.encoder_padding & 0xFFFF).to_bytes(2, "big")
    out[24:28] = b"comp"
    out[28:30] = info.frame_size.to_bytes(2, "big")
    out[30] = info.min_resolution
    out[31] = info.max_resolution
    out[32] = info.track_count
    out[33] = info.channel_config
    out[34] = info.total_band_count
    out[35] = info.base_band_count
    out[36] = info.stereo_band_count
    out[37] = info.bands_per_hfr_group
    pos = 40
    if info.loop_flag:
        out[40:44] = b"loop"
        out[44:48] = info.loop_start_frame.to_bytes(4, "big")
        out[48:52] = info.loop_end_frame.to_bytes(4, "big")
        out[52:54] = info.loop_start_delay.to_bytes(2, "big")
        out[54:56] = info.loop_end_padding.to_bytes(2, "big")
        pos = 56
    out[pos:pos + 4] = b"ciph"
    out[pos + 4:pos + 6] = b"\x00\x00"
    pos += 6
    out[pos:pos + 4] = b"pad\x00"
    crc = crc16(bytes(out[:info.header_size - 2]))
    out[info.header_size - 2:] = crc.to_bytes(2, "big")
    return bytes(out)
