"""HCA byte-substitution cipher tables (types 0 / 1 / 56), decode side.

Behaviour parity: hca.cpp:491-617 (table generation), hca.cpp:3309-3311
(key/subkey combination). Deciphering a frame is one lookup per byte in the
256-entry table.
"""
from __future__ import annotations

import numpy as np


def scramble_subkey(keycode: int, subkey: int) -> int:
    """Key/subkey combination (hca.cpp:3309-3311)."""
    if subkey:
        keycode = (keycode * (((subkey & 0xFFFF) << 16)
                              | ((~subkey + 2) & 0xFFFF))) \
            & 0xFFFFFFFFFFFFFFFF
    return keycode


def cipher_table(ciph_type: int, keycode: int = 0) -> np.ndarray:
    """Decryption substitution table for the given cipher type. [256] u8."""
    if ciph_type == 56 and not keycode:
        ciph_type = 0
    if ciph_type == 0:
        return np.arange(256, dtype=np.uint8)
    if ciph_type == 1:
        table = np.zeros(256, dtype=np.uint8)
        v = 0
        for i in range(1, 255):
            v = (v * 13 + 11) & 0xFF
            if v == 0 or v == 0xFF:
                v = (v * 13 + 11) & 0xFF
            table[i] = v
        table[0xFF] = 0xFF
        return table
    if ciph_type == 56:
        return _cipher56(keycode)
    raise ValueError("Unknown HCA cipher type")


def _init56_row(key: int) -> list:
    mul = ((key & 1) << 3) | 5
    add = (key & 0xE) | 1
    key >>= 4
    out = []
    for _ in range(16):
        key = (key * mul + add) & 0xF
        out.append(key)
    return out


def _cipher56(keycode: int) -> np.ndarray:
    if keycode != 0:
        keycode -= 1
    kc = [(keycode >> (8 * i)) & 0xFF for i in range(7)]
    seed = [
        kc[1], kc[1] ^ kc[6], kc[2] ^ kc[3], kc[2],
        kc[2] ^ kc[1], kc[3] ^ kc[4], kc[3], kc[3] ^ kc[2],
        kc[4] ^ kc[5], kc[4], kc[4] ^ kc[3], kc[5] ^ kc[6],
        kc[5], kc[5] ^ kc[4], kc[6] ^ kc[1], kc[6],
    ]
    base_r = _init56_row(kc[0])
    base = np.zeros(256, dtype=np.uint8)
    for r in range(16):
        base_c = _init56_row(seed[r])
        nb = base_r[r] << 4
        for c in range(16):
            base[r * 16 + c] = nb | base_c[c]
    table = np.zeros(256, dtype=np.uint8)
    x = 0
    pos = 1
    for _ in range(256):
        x = (x + 17) & 0xFF
        if base[x] != 0 and base[x] != 0xFF:
            table[pos] = base[x]
            pos += 1
    table[0] = 0
    table[0xFF] = 0xFF
    return table
