"""MPEG Audio Layer II frame headers, the frame walk and the frame writer
(for AHX).

A copy of pycricodecs_tpu/ops/mp2_frame.py without its unpackers and its
stream packer: `Mp2Header`, `parse_header`, `scan_frames`, `header_word`
and `pack_frame` (tests hold them equal). Kernel B10
(ops/mp2_unpack_device.py) unpacks every frame of the port's AHX decode;
the encode packs whole streams with kernel K3 (ops/mp2_encode_device.py),
and `pack_frame`, the per-frame reference, stays the readable oracle the
tests hold it to.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np

from . import mp2_tables as T
from ..utils.bitio import BitWriter

SAMPLES_PER_FRAME = 1152          # 12 granules x 3 samples x 32 subbands
GRANULES = 12


class Mp2Header(NamedTuple):
    version: int          # 3 = MPEG-1, 2 = MPEG-2 LSF (header field value)
    layer: int            # always 2 here
    crc: bool             # protection bit 0 -> 16-bit CRC present
    bitrate: int          # bits/s
    sample_rate: int
    padding: int
    mode: int             # 0 stereo, 1 joint, 2 dual, 3 mono
    mode_ext: int
    nch: int
    frame_size: int       # bytes, including header (+pad)
    table_id: int         # allocation table 0-4
    sblimit: int
    bound: int            # first subband coded jointly (== sblimit if none)


def parse_header(data: bytes, offset: int = 0) -> Mp2Header:
    """Parse one 32-bit Layer II frame header at ``offset``."""
    w = int.from_bytes(data[offset:offset + 4], "big")
    if (w >> 21) & 0x7FF != 0x7FF:
        raise ValueError("MPEG sync word not found.")
    version = (w >> 19) & 3
    layer_code = (w >> 17) & 3
    if layer_code != 2:                       # 10b = Layer II
        raise ValueError("Not an MPEG Layer II frame.")
    if version not in (2, 3):                 # 10b = MPEG-2 LSF, 11b = MPEG-1
        raise ValueError("Unsupported MPEG version (2.5).")
    crc = not ((w >> 16) & 1)
    bri = (w >> 12) & 0xF
    sri = (w >> 10) & 3
    if bri in (0, 15) or sri == 3:
        raise ValueError("Free-format/invalid Layer II header.")
    padding = (w >> 9) & 1
    mode = (w >> 6) & 3
    mode_ext = (w >> 4) & 3
    nch = 1 if mode == 3 else 2
    if version == 3:
        bitrate = T.BITRATES_V1_L2[bri] * 1000
        sample_rate = T.SAMPLE_RATES_V1[sri]
        table_id = T.TABLE_SELECT[sri][0 if nch == 2 else 1][bri]
    else:
        bitrate = T.BITRATES_V2_L2[bri] * 1000
        sample_rate = T.SAMPLE_RATES_V2[sri]
        table_id = 4
    sblimit = len(T.ALLOC_TABLES[table_id])
    bound = (mode_ext + 1) * 4 if mode == 1 else sblimit
    bound = min(bound, sblimit)
    frame_size = 144 * bitrate // sample_rate + padding
    return Mp2Header(version, 2, crc, bitrate, sample_rate, padding, mode,
                     mode_ext, nch, frame_size, table_id, sblimit, bound)


def scan_frames(data: bytes, offset: int = 0,
                max_frames: Optional[int] = None
                ) -> Tuple[Mp2Header, List[Tuple[int, bytes]]]:
    """Walk consecutive same-config Layer II frames; returns (first header,
    [(abs byte offset, frame bytes)]). Stops at the end of the data, a sync
    loss, a config change or an incomplete frame."""
    hdr0 = parse_header(data, offset)
    frames = []                                  # (abs byte offset, frame)
    pos = offset
    while pos + 4 <= len(data):
        try:
            hdr = parse_header(data, pos)
        except ValueError:
            break
        if (hdr.version, hdr.sample_rate, hdr.mode, hdr.table_id) != \
                (hdr0.version, hdr0.sample_rate, hdr0.mode, hdr0.table_id):
            break
        if pos + hdr.frame_size > len(data):
            break
        frames.append((pos, data[pos:pos + hdr.frame_size]))
        pos += hdr.frame_size
        if max_frames is not None and len(frames) >= max_frames:
            break
    if not frames:
        raise ValueError("No complete Layer II frame found.")
    return hdr0, frames


# --- encoder side ------------------------------------------------------------

def header_word(version: int, bitrate_idx: int, sr_idx: int, padding: int,
                mode: int, mode_ext: int = 0) -> int:
    return ((0x7FF << 21) | (version << 19) | (2 << 17) | (1 << 16)
            | (bitrate_idx << 12) | (sr_idx << 10) | (padding << 9)
            | (mode << 6) | (mode_ext << 4))


def pack_frame(hdr: Mp2Header, bitrate_idx: int, sr_idx: int,
               alloc_idx: np.ndarray, scfsi: np.ndarray,
               sfidx: np.ndarray, codes: np.ndarray) -> bytes:
    """Pack one Layer II frame (no CRC).  alloc_idx [C, sblimit] are table
    indices (not levels); scfsi [C, sblimit]; sfidx [C, 3, sblimit];
    codes [C, 36, sblimit] quantised sample codes."""
    table = T.ALLOC_TABLES[hdr.table_id]
    sblimit, bound, nch = hdr.sblimit, hdr.bound, hdr.nch
    bw = BitWriter(hdr.frame_size)
    bw.write(header_word(hdr.version, bitrate_idx, sr_idx, hdr.padding,
                         hdr.mode, hdr.mode_ext), 32)

    for sb in range(sblimit):
        nbal = (len(table[sb]) - 1).bit_length()
        for ch in range(nch if sb < bound else 1):
            bw.write(int(alloc_idx[ch, sb]), nbal)
    for sb in range(sblimit):
        for ch in range(nch):
            if alloc_idx[ch, sb]:
                bw.write(int(scfsi[ch, sb]), 2)
    for sb in range(sblimit):
        for ch in range(nch):
            if not alloc_idx[ch, sb]:
                continue
            s = int(scfsi[ch, sb])
            a, b, c = (int(v) for v in sfidx[ch, :, sb])
            if s == 0:
                bw.write(a, 6), bw.write(b, 6), bw.write(c, 6)
            elif s == 1:
                bw.write(a, 6), bw.write(c, 6)
            elif s == 2:
                bw.write(a, 6)
            else:
                bw.write(a, 6), bw.write(b, 6)

    for gr in range(GRANULES):
        row = gr * 3
        for sb in range(sblimit):
            for ch in range(nch if sb < bound else 1):
                n = table[sb][int(alloc_idx[ch, sb])]
                if not n:
                    continue
                v0 = int(codes[ch, row, sb])
                v1 = int(codes[ch, row + 1, sb])
                v2 = int(codes[ch, row + 2, sb])
                gb = T.GROUP_BITS.get(n)
                if gb is not None:
                    bw.write(v0 + n * (v1 + n * v2), gb)
                else:
                    nb = T.code_bits(n)
                    bw.write(v0, nb), bw.write(v1, nb), bw.write(v2, nb)
    return bw.getvalue()
