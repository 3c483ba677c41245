"""HCA stream constants, loop-point math shared by the WAV writers, and the
frame cipher re-keying (`crypt`)."""
from __future__ import annotations

import numpy as np

from ..ops import hca_frame
from ..utils import hca_crypt

SAMPLES_PER_FRAME = 1024


def loop_points(info) -> tuple:
    """(looping, loop_start, loop_end) in output samples (hca.cpp:3372-3373)."""
    if not info.loop_flag:
        return False, 0, 0
    loop_start = (info.loop_start_frame * SAMPLES_PER_FRAME
                  + info.loop_start_delay - info.encoder_delay)
    loop_end = (info.loop_end_frame * SAMPLES_PER_FRAME
                + (SAMPLES_PER_FRAME - info.loop_end_padding)
                - info.encoder_delay)
    return True, loop_start, loop_end


def crypt(data: bytes, encrypt: bool, header_size: int, ciph_type: int,
          keycode: int, subkey: int = 0) -> bytes:
    """Encrypt/decrypt all frames (parity with CriCodecs.HcaCrypt; the JAX
    package's models.hca.crypt): encrypt enciphers with `ciph_type` under
    the key, decrypt deciphers with the stream's own cipher type; both
    re-stamp every frame CRC and the header's chunk masks and CRC."""
    data = bytearray(data)
    info = hca_frame.parse_header(bytes(data[:header_size]))
    use_type = ciph_type if encrypt else info.ciph_type
    keycode = hca_crypt.scramble_subkey(keycode, subkey)
    table = hca_crypt.cipher_table(use_type, keycode)
    if encrypt:
        table = hca_crypt.invert_cipher_table(table)
    fs = info.frame_size
    nbytes = info.frame_count * fs
    frames = np.frombuffer(bytes(data[header_size:header_size + nbytes]),
                           dtype=np.uint8).reshape(info.frame_count, fs)
    frames = hca_crypt.apply_cipher_frames(frames, table, restamp_crc=True)
    data[header_size:header_size + nbytes] = frames.tobytes()
    header = hca_crypt.crypt_header(data[:header_size],
                                    ciph_type if encrypt else 0)
    data[:header_size] = header
    return bytes(data)
