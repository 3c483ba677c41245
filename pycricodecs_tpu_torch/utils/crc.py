"""CRC-16 (poly 0x8005, MSB-first, init 0) used by HCA headers and frames.

Reference: hca.cpp:186-211. A buffer that carries its own CRC checks to 0.
"""
from __future__ import annotations

import numpy as np

_POLY = 0x8005


def _build_table() -> np.ndarray:
    entries = np.zeros(256, dtype=np.uint16)
    for byte in range(256):
        state = byte << 8
        for _ in range(8):
            state = ((state << 1) ^ (_POLY if state & 0x8000 else 0)) & 0xFFFF
        entries[byte] = state
    return entries


CRC16_TABLE: np.ndarray = _build_table()


def crc16(data) -> int:
    """CRC16 of a bytes-like object."""
    table = CRC16_TABLE
    s = 0
    for b in bytes(data):
        s = ((s << 8) ^ int(table[(s >> 8) ^ b])) & 0xFFFF
    return s


def crc16_batch(frames: np.ndarray) -> np.ndarray:
    """CRC16 over each row of a [N, frame_size] uint8 array: byte-serial
    along the row, vectorised across the N rows."""
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    n, size = frames.shape
    state = np.zeros(n, dtype=np.uint32)
    table = CRC16_TABLE.astype(np.uint32)
    for j in range(size):
        state = ((state << 8)
                 ^ table[((state >> 8) ^ frames[:, j]) & 0xFF]) & 0xFFFF
    return state.astype(np.uint16)
