"""WAV writing for decoded PCM16.

Layout parity with the reference writer (pcm.cpp:350-375, 547-556): a
44-byte header, or a 0x70-byte header holding a 0x3C-byte smpl chunk with one
loop when `looping` is set.
"""
from __future__ import annotations

import numpy as np

WAVE_FORMAT_PCM = 0x0001


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
