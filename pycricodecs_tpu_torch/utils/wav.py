"""RIFF/WAVE parsing to PCM16 and WAV writing.

Parity target: the reference PCM core (pcm.cpp:286-556).
- parse_wav reads fmt/smpl/data chunks and skips unknown ones (odd sizes
  padded); PCM, IEEE float and EXTENSIBLE input of 8/16/24/32-bit int or
  f32/f64 becomes interleaved PCM16 with the reference's truncating
  conversions (shift down for wide ints, scale + clamp for float).
- write_wav emits a 44-byte header, or a 0x70-byte header holding a
  0x3C-byte smpl chunk with one loop when `looping` is set.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

WAVE_FORMAT_PCM = 0x0001
WAVE_FORMAT_IEEE_FLOAT = 0x0003
WAVE_FORMAT_EXTENSIBLE = 0xFFFE


class WavError(ValueError):
    pass


@dataclass
class WavFile:
    channels: int
    sample_rate: int
    pcm16: np.ndarray  # interleaved int16, shape [frames * channels]
    looping: bool = False
    loop_start: int = 0
    loop_end: int = 0
    bit_depth: int = 16
    compression: int = WAVE_FORMAT_PCM

    @property
    def num_samples(self) -> int:
        """Total interleaved sample count (frames * channels)."""
        return int(self.pcm16.size)

    @property
    def samples_per_channel(self) -> int:
        return int(self.pcm16.size) // self.channels

    def deinterleave(self) -> np.ndarray:
        """[channels, frames] view of the PCM data."""
        return self.pcm16.reshape(-1, self.channels).T


def _u16(b: bytes, off: int) -> int:
    return int.from_bytes(b[off:off + 2], "little")


def _u32(b: bytes, off: int) -> int:
    return int.from_bytes(b[off:off + 4], "little")


def parse_wav(data: bytes) -> WavFile:
    if len(data) < 44 or data[0:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise WavError("Invalid WAVE file header.")
    riff_size = _u32(data, 4)

    fmt = None
    smpl = None
    pcm_raw = None
    data_size = 0
    pos = 12
    consumed = 4
    while consumed < riff_size and pos + 8 <= len(data):
        tag = data[pos:pos + 4]
        size = _u32(data, pos + 4)
        body = data[pos + 8:pos + 8 + size]
        step = size + 8
        if step & 1 and consumed + step + 1 <= riff_size:
            step += 1  # RIFF chunks are word-aligned
        if tag == b"fmt ":
            if size < 16:
                raise WavError(
                    "Invalid WAVE file header. Format info is not present.")
            fmt = dict(
                compression=_u16(body, 0),
                channels=_u16(body, 2),
                sample_rate=_u32(body, 4),
                block_align=_u16(body, 12),
                bit_depth=_u16(body, 14),
            )
            if fmt["compression"] == WAVE_FORMAT_EXTENSIBLE and size >= 40:
                fmt["bit_depth_valid"] = _u16(body, 18)
                fmt["sub_format"] = _u32(body, 24)
                if fmt["sub_format"] not in (WAVE_FORMAT_PCM,
                                             WAVE_FORMAT_IEEE_FLOAT,
                                             WAVE_FORMAT_EXTENSIBLE):
                    raise WavError(
                        "Unsupported/Unknown WAVE compression mode.")
            if fmt["compression"] not in (WAVE_FORMAT_PCM,
                                          WAVE_FORMAT_IEEE_FLOAT,
                                          WAVE_FORMAT_EXTENSIBLE):
                raise WavError("Unsupported/Unknown WAVE compression mode.")
        elif tag == b"smpl":
            if size < 36:
                raise WavError("Invalid looping sample info data.")
            num_loops = _u32(body, 28)
            if num_loops >= 1 and size >= 36 + 24:
                smpl = dict(start=_u32(body, 36 + 8), end=_u32(body, 36 + 12))
        elif tag == b"data":
            data_size = size
            pcm_raw = body
        pos += step
        consumed += step

    if fmt is None:
        raise WavError("Invalid WAVE file header. Format info is not present.")
    if pcm_raw is None:
        raise WavError("Data tag is not present.")

    compression = fmt["compression"]
    bit_depth = fmt["bit_depth"]
    if compression == WAVE_FORMAT_EXTENSIBLE:
        bit_depth = fmt.get("bit_depth_valid", bit_depth)
        compression = fmt.get("sub_format", WAVE_FORMAT_PCM)
    if fmt["channels"] < 1:
        raise WavError("Invalid WAVE file header. Format info is not present.")
    sample_size = fmt["block_align"] // fmt["channels"]
    if sample_size < 1:
        raise WavError("PCM Bitdepth does not match compression type.")
    # the data chunk's declared size may exceed the bytes actually present
    count = min(data_size, len(pcm_raw)) // sample_size

    pcm16 = _to_pcm16(pcm_raw[:count * sample_size], compression, bit_depth,
                      sample_size)
    wav = WavFile(
        channels=fmt["channels"],
        sample_rate=fmt["sample_rate"],
        pcm16=pcm16,
        bit_depth=bit_depth,
        compression=compression,
    )
    if smpl is not None:
        wav.looping = True
        wav.loop_start = smpl["start"]
        wav.loop_end = smpl["end"]
    return wav


def _to_pcm16(raw: bytes, compression: int, bit_depth: int,
              sample_size: int) -> np.ndarray:
    if compression == WAVE_FORMAT_IEEE_FLOAT:
        # float -> int16: value * 0x7FFF at the *source precision* (the
        # reference multiplies float*int in float), truncated toward zero,
        # clamped to [-0x8000, 0x7FFF]
        if bit_depth == 32:
            src = np.frombuffer(raw, dtype="<f4")
            prod = (src * np.float32(0x7FFF)).astype(np.float64)
        elif bit_depth == 64:
            src = np.frombuffer(raw, dtype="<f8")
            prod = src * np.float64(0x7FFF)
        else:
            raise WavError("PCM Bitdepth does not match compression type.")
        vals = np.trunc(prod)
        return np.clip(vals, -0x8000, 0x7FFF).astype(np.int16)
    if sample_size < 1 or sample_size > 4 or \
            not (sample_size - 1) * 8 < bit_depth <= sample_size * 8:
        # bit depth must live inside its byte container (a 3-byte container
        # with bit_depth < 17 would otherwise shift by a negative amount)
        raise WavError("PCM Bitdepth does not match compression type.")
    if sample_size == 1:
        src = np.frombuffer(raw, dtype=np.uint8).astype(np.int32)
        mid = 1 << (bit_depth - 1)
        return ((src - mid) << 8).astype(np.int16)
    if sample_size == 2:
        return np.frombuffer(raw, dtype="<i2").copy()
    if sample_size == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3).astype(np.int32)
        val = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
        val = np.where(b[:, 2] & 0x80, val | (-1 << 24), val)
        return ((val >> (bit_depth - 16)) & 0xFFFF).astype(
            np.uint16).view(np.int16).copy()
    src = np.frombuffer(raw, dtype="<i4")
    return ((src >> (bit_depth - 16)) & 0xFFFF).astype(np.uint32).astype(
        np.uint16).view(np.int16).copy()


def write_wav(pcm16: np.ndarray, channels: int, sample_rate: int,
              looping: bool = False, loop_start: int = 0,
              loop_end: int = 0) -> bytes:
    """Serialise interleaved PCM16 to a WAV byte string."""
    pcm16 = np.ascontiguousarray(pcm16, dtype="<i2")
    payload = pcm16.tobytes()
    header_size = 0x70 if looping else 0x2C
    total = header_size + len(payload)
    out = bytearray(header_size)
    out[0:4] = b"RIFF"
    out[4:8] = (total - 8).to_bytes(4, "little")
    out[8:12] = b"WAVE"
    out[12:16] = b"fmt "
    out[16:20] = (16).to_bytes(4, "little")
    out[20:22] = WAVE_FORMAT_PCM.to_bytes(2, "little")
    out[22:24] = channels.to_bytes(2, "little")
    out[24:28] = sample_rate.to_bytes(4, "little")
    out[28:32] = (2 * channels * sample_rate).to_bytes(4, "little")
    out[32:34] = (2 * channels).to_bytes(2, "little")
    out[34:36] = (16).to_bytes(2, "little")
    pos = 36
    if looping:
        out[36:40] = b"smpl"
        out[40:44] = (0x3C).to_bytes(4, "little")
        # body zeroed; loop count at +0x24 from the chunk start,
        # start/end at +0x34/+0x38
        out[36 + 0x24:36 + 0x28] = (1).to_bytes(4, "little")
        out[36 + 0x34:36 + 0x38] = (loop_start & 0xFFFFFFFF).to_bytes(
            4, "little")
        out[36 + 0x38:36 + 0x3C] = (loop_end & 0xFFFFFFFF).to_bytes(
            4, "little")
        pos = 104
    out[pos:pos + 4] = b"data"
    out[pos + 4:pos + 8] = len(payload).to_bytes(4, "little")
    return bytes(out) + payload
