"""HCA frame packer: encode tensors -> frame bytes with their CRC16.

Counterpart of pycricodecs_tpu/ops/hca_pack_device.py (`pack_frames_device`,
which holds kernel B9, `_scatter_segments_pallas`) and of the host packer
`hca_frame.pack_frame` (reference PackFrame, hca.cpp:2894-2963, with the
MSB-first BitWriter of IO.cpp). `pack_frames` launches kernel `hca_pack`
(csrc/hca_pack.cu, one warp per frame) on CUDA tensors and runs
`pack_frames_plain` on CPU tensors.

A frame is the same symbol sequence for every frame of a config: sync
0xFFFF, level (9 bits) and boundary (7), per channel the 3-bit delta width,
the scalefactor codes (raw 6-bit, or delta with an escape + raw 6-bit), then
8 x 4-bit intensity (stereo secondary) or G x 6-bit HFR scales, then the
spectrum codes subframe-major, channel-minor, band innermost. Only values
and widths depend on the data.

End of frame (the JAX module's contract): the writer's range is frame bits
[16, fs*8); a symbol may end inside the 16-bit CRC slot (its spilled bits
are overwritten by the CRC), and a write that would cross fs*8 is dropped
whole without moving the cursor (IO.cpp), so a later shorter write can
still land. The twin drops every symbol that ends past fs*8, as the JAX
device packer does; the bytes are the same, because once a write of at most
11 bits has been dropped fewer than 11 bits are left, all inside the CRC
slot, where nothing written survives.
"""
from __future__ import annotations

import numpy as np
import torch

from . import cuda_kernels
from . import hca_tables as T
from .hca_kernels import _table
from ..utils.crc import CRC16_TABLE

#: frames per pass of the plain twin (bounds its [frames, symbols] temps)
PLAIN_CHUNK_FRAMES = 16384


def _spectrum_symbols(res, quant):
    """(value, bits) i64 [..., C, 8, 128] of every spectrum slot: res 0 (and
    >= 16) emits nothing; 1..7 the QUANTIZE_SPECTRUM_VALUE/BITS codes at
    q + 8; 8..15 |q| in QUANTIZED_SPECTRUM_MAX_BITS[res] - 1 bits, then a sign
    bit when q != 0 (one symbol here)."""
    dev = res.device
    r = res.long()[..., None, :]
    q = quant.long()
    code = torch.clamp(q + 8, 0, 15)
    row = torch.clamp(r, 0, 7) * 16 + code
    v_lo = _table(T.QUANTIZE_SPECTRUM_VALUE.astype(np.int64), dev).reshape(-1)[row]
    b_lo = _table(T.QUANTIZE_SPECTRUM_BITS.astype(np.int64), dev).reshape(-1)[row]
    base = _table(T.QUANTIZED_SPECTRUM_MAX_BITS.astype(np.int64),
                  dev)[torch.clamp(r, 0, 15)] - 1
    nz = q != 0
    v_hi = torch.where(nz, (q.abs() << 1) | (q < 0).long(), 0)
    b_hi = torch.where(nz, base + 1, base)
    value = torch.where(r >= 8, v_hi, torch.where(r >= 1, v_lo, 0))
    bits = torch.where(r >= 8, b_hi, torch.where(r >= 1, b_lo, 0))
    value = torch.where(r >= 16, 0, value)
    bits = torch.where(r >= 16, 0, bits)
    return value, bits


def _scalefactor_symbols(sf_c, db, cc: int):
    """(value, bits) i64 [N, max(cc, 1)] of one channel's scalefactors.

    sf_c i64 [N, 128], db i64 [N] (hca.cpp:2906-2920): width 0 emits
    nothing; width 6 raw codes; else sf[0] raw, then deltas in db bits with
    escape (1 << db) - 1 + raw 6-bit (one symbol here)."""
    dbe = db[:, None]
    s = sf_c[:, :max(cc, 1)]
    prev = torch.cat([s[:, :1], s[:, :-1]], dim=1)
    delta = s - prev
    maxd = (1 << torch.clamp(dbe - 1, min=0)) - 1
    escape = (1 << dbe) - 1
    esc = delta.abs() > maxd
    v_delta = torch.where(esc, (escape << 6) | s, maxd + delta)
    b_delta = torch.where(esc, dbe + 6, dbe)
    first = torch.arange(s.shape[1], device=s.device) == 0
    value = torch.where((dbe == 6) | first, s, v_delta)
    bits = torch.where((dbe == 6) | first, 6, b_delta)
    if cc == 0:
        # the reference writes sf[0] for any width but 0 and 6 (its raw
        # loop over zero bands writes nothing)
        bits = torch.where((dbe == 6), 0, bits)
    value = torch.where(dbe == 0, 0, value)
    bits = torch.where(dbe == 0, 0, bits)
    return value, bits


def _symbols(level, boundary, sf, res, intensity, hfr_scales, delta_bits,
             quant, *, coded_counts, channel_types, hfr_group_count):
    """(value, bits) i64 [N, S] of N frames' symbol sequences."""
    N = level.shape[0]
    C = sf.shape[1]
    dev = level.device
    ones = torch.ones((N, 1), dtype=torch.int64, device=dev)
    values = [ones * 0xFFFF,
              (((level.long() & 0x1FF) << 7) | (boundary.long() & 0x7F))[:, None]]
    widths = [ones * 16, ones * 16]
    sf_l = sf.long()
    for c in range(C):
        cc = int(coded_counts[c])
        db = delta_bits[:, c].long()
        values.append(db[:, None])
        widths.append(ones * 3)
        v, b = _scalefactor_symbols(sf_l[:, c], db, cc)
        values.append(v)
        widths.append(b)
        if channel_types[c] == T.STEREO_SECONDARY:
            values.append(intensity[:, c].long())
            widths.append(torch.full((N, 8), 4, dtype=torch.int64,
                                     device=dev))
        elif hfr_group_count > 0:
            values.append(hfr_scales[:, c, :hfr_group_count].long())
            widths.append(torch.full((N, hfr_group_count), 6,
                                     dtype=torch.int64, device=dev))
    v_spec, b_spec = _spectrum_symbols(res, quant)     # [N, C, 8, 128]
    idx = [(s * C + c) * 128 + i for s in range(8) for c in range(C)
           for i in range(int(coded_counts[c]))]
    if idx:
        order = torch.tensor(idx, dtype=torch.int64, device=dev)
        values.append(torch.movedim(v_spec, 2, 1).reshape(N, -1)[:, order])
        widths.append(torch.movedim(b_spec, 2, 1).reshape(N, -1)[:, order])
    return torch.cat(values, dim=1), torch.cat(widths, dim=1)


def _crc16_rows(data: torch.Tensor) -> torch.Tensor:
    """CRC16 of each row of u8 [N, L], byte-serial along the row."""
    table = _table(CRC16_TABLE.astype(np.int64), data.device)
    state = torch.zeros(data.shape[0], dtype=torch.int64, device=data.device)
    rows = data.long()
    for j in range(data.shape[1]):
        state = ((state << 8) ^ table[((state >> 8) ^ rows[:, j]) & 0xFF]) \
            & 0xFFFF
    return state


def crc_word_table(fs: int, nwords: int) -> np.ndarray:
    """K[w, t] u32: CRC16 contribution of bit t (LSB order) of big-endian
    frame word w (copy of the JAX package's _crc_word_table). CRC16 is
    GF(2)-linear, so the CRC of frame bytes [0, fs - 2) is the XOR of the
    unit contributions of its set bits; a bit's contribution depends only
    on its distance from the message end: D[d, k] is the CRC of byte
    1 << k followed by d zero bytes. Bytes from fs - 2 on contribute 0."""
    L = fs - 2
    table = CRC16_TABLE.astype(np.uint32)
    D = np.zeros((L, 8), dtype=np.uint32)
    state = table[1 << np.arange(8)]
    D[0] = state
    for d in range(1, L):
        state = ((state << 8) ^ table[(state >> 8) & 0xFF]) & 0xFFFF
        D[d] = state
    K = np.zeros((nwords, 32), dtype=np.uint32)
    for i in range(4):               # big-endian byte i of word w
        j = 4 * np.arange(nwords) + i
        ok = j < L
        K[ok, 24 - 8 * i:32 - 8 * i] = D[L - 1 - j[ok]]
    return K


def crc_mask_table(fs: int) -> np.ndarray:
    """M[w, j] u32, w < ceil(fs / 4): the bits of frame word w whose CRC
    contribution sets CRC bit j (copy of the JAX package's
    _crc_mask_table). CRC bit j is the parity of sum_w popcount(word_w &
    M[w, j]); kernel `hca_pack` reads it transposed, [16, W]."""
    W = -(-fs // 4)
    K = crc_word_table(fs, W)                           # [W, 32]
    bit = (K[:, :, None] >> np.arange(16, dtype=np.uint32)) & 1
    return (bit << np.arange(32, dtype=np.uint32)[None, :, None]).sum(
        axis=1).astype(np.uint32)                       # [W, 16]


def _pack_rows(value, bits, frame_size: int) -> torch.Tensor:
    """Exclusive prefix sum of the widths, the symbol -> word scatter (each
    symbol <= 16 bits lands in at most two 32-bit words; written bit ranges
    are disjoint, so integer sums are ORs), big-endian bytes, CRC.
    -> u8 [N, frame_size]."""
    N = value.shape[0]
    fs = frame_size
    W = -(-fs // 4)
    off = torch.cumsum(bits, dim=1) - bits
    keep = off + bits <= fs * 8
    val = torch.where(keep, value & ((1 << bits) - 1), 0)
    word = torch.where(keep, off >> 5, W)
    end = (off & 31) + bits
    hi = torch.where(end <= 32, val << torch.clamp(32 - end, 0, 63),
                     val >> torch.clamp(end - 32, 0, 63))
    lo = torch.where(end > 32,
                     (val << torch.clamp(64 - end, 0, 63)) & 0xFFFFFFFF, 0)
    words = torch.zeros((N, W + 2), dtype=torch.int64, device=value.device)
    words.scatter_add_(1, word, hi)
    words.scatter_add_(1, word + 1, lo)
    words = words[:, :W]
    be = torch.stack([(words >> s) & 0xFF for s in (24, 16, 8, 0)], dim=-1)
    data = be.reshape(N, W * 4)[:, :fs - 2].to(torch.uint8)
    crc = _crc16_rows(data)
    return torch.cat([data, (crc >> 8).to(torch.uint8)[:, None],
                      (crc & 0xFF).to(torch.uint8)[:, None]], dim=1)


def pack_frames_plain(level, boundary, sf, res, intensity, hfr_scales,
                      delta_bits, quant, *, channels, coded_counts,
                      channel_types, hfr_group_count, frame_size):
    """Plain PyTorch twin of kernel `hca_pack` (same arguments and result as
    `pack_frames`): vectorised over frames, PLAIN_CHUNK_FRAMES at a time."""
    B, F = level.shape
    C = channels
    fs = frame_size
    n = B * F
    args = [level.reshape(n), boundary.reshape(n), sf.reshape(n, C, 128),
            res.reshape(n, C, 128), intensity.reshape(n, C, 8),
            hfr_scales.reshape(n, C, -1), delta_bits.reshape(n, C),
            quant.reshape(n, C, 8, 128)]
    kw = dict(coded_counts=coded_counts, channel_types=channel_types,
              hfr_group_count=hfr_group_count)
    out = torch.empty((n, fs), dtype=torch.uint8, device=level.device)
    for lo in range(0, n, PLAIN_CHUNK_FRAMES):
        part = [a[lo:lo + PLAIN_CHUNK_FRAMES] for a in args]
        value, bits = _symbols(*part, **kw)
        out[lo:lo + value.shape[0]] = _pack_rows(value, bits, fs)
    return out.reshape(B, F, fs)


def pack_frames(level, boundary, sf, res, intensity, hfr_scales, delta_bits,
                quant, *, channels, coded_counts, channel_types,
                hfr_group_count, frame_size):
    """Pack frames: level/boundary i32 [B, F]; sf/res u8 [B, F, C, 128];
    intensity u8 [B, F, C, 8]; hfr_scales i32 [B, F, C, G'] (G' >= the HFR
    group count); delta_bits i32 [B, F, C]; quant i16 [B, F, C, 8, 128]
    -> u8 [B, F, frame_size], byte-equal to the reference's PackFrame.

    CUDA tensors launch kernel `hca_pack`; CPU tensors run the plain twin."""
    kw = dict(channels=int(channels),
              coded_counts=tuple(int(x) for x in coded_counts),
              channel_types=tuple(int(x) for x in channel_types),
              hfr_group_count=int(hfr_group_count),
              frame_size=int(frame_size))
    if level.device.type == "cpu":
        return pack_frames_plain(level, boundary, sf, res, intensity,
                                 hfr_scales, delta_bits, quant, **kw)
    return cuda_kernels.hca_pack(level, boundary, sf, res, intensity,
                                 hfr_scales, delta_bits, quant, **kw)
