"""HCA byte-substitution cipher tables (types 0 / 1 / 56) and re-keying.

Behaviour parity: hca.cpp:491-617 (table generation), hca.cpp:3309-3311
(key/subkey combination), hca.cpp:3166-3250 (header chunk masking).
Deciphering a frame is one lookup per byte in the 256-entry table;
enciphering uses the inverted table.
"""
from __future__ import annotations

import numpy as np
import torch

from .crc import crc16, crc16_batch


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


def cipher_tables_56_batch(keycodes, *, device) -> torch.Tensor:
    """Type-56 tables of K keycodes (uint64, subkey already applied) ->
    uint8 [K, 256] on `device`: the numpy branch of the JAX package's
    cipher_tables_56_batch (utils/hca_crypt.py:106-141) in int64 PyTorch
    ops. A keycode of 0 is not decremented and gives _cipher56(0)'s table,
    as there (not the identity of cipher_table(56, 0))."""
    kq = np.array(keycodes, dtype=np.uint64).reshape(-1)
    kq[kq != 0] -= np.uint64(1)
    K = kq.shape[0]
    # the int64 bit pattern: bytes 0-6 survive the arithmetic shifts below
    k = torch.from_numpy(kq.view(np.int64)).to(device)
    shifts = 8 * torch.arange(7, device=device)
    kc = (k[:, None] >> shifts) & 0xFF                          # [K, 7]
    seed = torch.stack([
        kc[:, 1], kc[:, 1] ^ kc[:, 6], kc[:, 2] ^ kc[:, 3], kc[:, 2],
        kc[:, 2] ^ kc[:, 1], kc[:, 3] ^ kc[:, 4], kc[:, 3],
        kc[:, 3] ^ kc[:, 2], kc[:, 4] ^ kc[:, 5], kc[:, 4],
        kc[:, 4] ^ kc[:, 3], kc[:, 5] ^ kc[:, 6], kc[:, 5],
        kc[:, 5] ^ kc[:, 4], kc[:, 6] ^ kc[:, 1], kc[:, 6]], dim=1)

    def rows(keys):                                      # [N] -> [N, 16]
        mul = ((keys & 1) << 3) | 5
        add = (keys & 0xE) | 1
        key = keys >> 4
        out = []
        for _ in range(16):
            key = (key * mul + add) & 0xF
            out.append(key)
        return torch.stack(out, dim=-1)

    base_r = rows(kc[:, 0])                              # [K, 16]
    base_c = rows(seed.reshape(-1)).reshape(K, 16, 16)   # [K, 16, 16]
    base = ((base_r[:, :, None] << 4) | base_c).reshape(K, 256)
    order = (17 * (torch.arange(256, device=device) + 1)) & 0xFF
    vals = base[:, order]                                # key-independent walk
    mask = (vals != 0) & (vals != 0xFF)
    pos = torch.cumsum(mask, dim=1)                      # 1-based write slots
    table = torch.zeros((K, 256), dtype=torch.int64, device=device)
    # unmasked entries write 0 into column 0, which is 0 anyway
    table.scatter_(1, torch.where(mask, pos, 0), torch.where(mask, vals, 0))
    table[:, 0] = 0
    table[:, 0xFF] = 0xFF
    return table.to(torch.uint8)


def invert_cipher_table(table: np.ndarray) -> np.ndarray:
    inv = np.zeros(256, dtype=np.uint8)
    inv[table] = np.arange(256, dtype=np.uint8)
    return inv


def apply_cipher_frames(frames: np.ndarray, table: np.ndarray,
                        restamp_crc: bool = True) -> np.ndarray:
    """Substitute every byte of [N, frame_size] frames and re-stamp CRCs."""
    out = table[frames]
    if restamp_crc:
        crc = crc16_batch(out[:, :-2])
        out[:, -2] = (crc >> 8).astype(np.uint8)
        out[:, -1] = (crc & 0xFF).astype(np.uint8)
    return out


# The reference XORs a host-endian (little-endian) u32 over the 4 signature
# bytes (hca.cpp:3175 etc.): 0x00808080 toggles bytes 0-2, 0x80808080 all 4.
_CHUNK_MASKS = {
    b"HCA\x00": (0x80, 0x80, 0x80, 0x00), b"fmt\x00": (0x80, 0x80, 0x80, 0x00),
    b"comp": (0x80, 0x80, 0x80, 0x80), b"dec\x00": (0x80, 0x80, 0x80, 0x00),
    b"vbr\x00": (0x80, 0x80, 0x80, 0x00), b"ath\x00": (0x80, 0x80, 0x80, 0x00),
    b"loop": (0x80, 0x80, 0x80, 0x80), b"ciph": (0x80, 0x80, 0x80, 0x80),
    b"rva\x00": (0x80, 0x80, 0x80, 0x00), b"comm": (0x80, 0x80, 0x80, 0x80),
    b"pad\x00": (0x80, 0x80, 0x80, 0x00),
}

_CHUNK_SIZES = {
    b"HCA\x00": 8, b"fmt\x00": 16, b"comp": 16, b"dec\x00": 12, b"vbr\x00": 8,
    b"ath\x00": 6, b"loop": 16, b"ciph": 6, b"rva\x00": 8,
}


def crypt_header(header: bytearray, ciph_value: int) -> bytearray:
    """XOR-toggle chunk signature bytes, set the ciph type field, restamp CRC.

    Works in both directions (the masks are involutions). `ciph_value` is the
    value written into the ciph chunk (encryption type when encrypting, 0 when
    decrypting).
    """
    out = bytearray(header)
    size = len(out)
    pos = 0

    def sig_at(p):
        return bytes(b & 0x7F for b in out[p:p + 4])

    def toggle(p, mask):
        for i in range(4):
            out[p + i] ^= mask[i]

    order = [b"HCA\x00", b"fmt\x00", (b"comp", b"dec\x00"), b"vbr\x00",
             b"ath\x00", b"loop", b"ciph", b"rva\x00", b"comm", b"pad\x00"]
    for want in order:
        if pos + 4 > size:
            break
        sig = sig_at(pos)
        wants = want if isinstance(want, tuple) else (want,)
        if sig not in wants:
            continue
        toggle(pos, _CHUNK_MASKS[sig])
        if sig == b"ciph":
            out[pos + 4:pos + 6] = int(ciph_value).to_bytes(2, "big")
        if sig == b"comm":
            length = out[pos + 4]
            pos += 5 + length
        elif sig == b"pad\x00":
            break
        else:
            pos += _CHUNK_SIZES[sig]
    crc = crc16(bytes(out[:size - 2]))
    out[size - 2:size] = crc.to_bytes(2, "big")
    return out
