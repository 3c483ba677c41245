"""AHX container: MPEG Layer II audio in an ADX-style CRI header.

A copy of the decode-side header of pycricodecs_tpu/models/ahx.py
(`AHX_TYPES`, `CRI_STRING`, `AHX.parse_header`) and of the AHX rule of
pycricodecs_tpu/utils/sniff.py; tests hold them equal.
"""
from __future__ import annotations

CRI_STRING = b"(c)CRI"
AHX_TYPES = (0x10, 0x11)


def is_ahx(data: bytes) -> bool:
    """sniff(data) == "ahx": the ADX magic byte with an AHX encoding type."""
    return data[:1] == b"\x80" and len(data) > 4 and data[4] in AHX_TYPES


def parse_header(data: bytes) -> dict:
    """AHX.parse_header: data offset, type, channels, sample rate and total
    samples of an AHX header; ValueError if it is not one."""
    if len(data) < 0x18 or data[0] != 0x80 or data[1] != 0x00:
        raise ValueError("Invalid AHX file header.")
    data_offset = int.from_bytes(data[2:4], "big") + 4
    enc_type = data[4]
    if enc_type not in AHX_TYPES:
        raise ValueError("Not an AHX stream (ADX encoding type "
                         f"0x{enc_type:02x}).")
    channels = data[7]
    sample_rate = int.from_bytes(data[8:12], "big")
    total_samples = int.from_bytes(data[12:16], "big")
    if data_offset >= 12 and CRI_STRING not in data[:data_offset]:
        raise ValueError("CRI copyright string not found in AHX header.")
    return dict(data_offset=data_offset, type=enc_type,
                channels=channels, sample_rate=sample_rate,
                total_samples=total_samples)
