"""AHX container: MPEG Layer II audio in an ADX-style CRI header.

A copy of the decode-side header of pycricodecs_tpu/models/ahx.py
(`AHX_TYPES`, `CRI_STRING`, `AHX.parse_header`) and of the AHX rule of
pycricodecs_tpu/utils/sniff.py; tests hold them equal. The `AHX` class is
the single-file surface (parse_header, decode, info; the encode is not
ported): its decode runs the batch path of parallel/pipeline.py on `device`
and, like the JAX package's AHX.decode, zero-fills a stream whose frames
hold fewer samples than its header declares (ahx_decode_batch trims).
"""
from __future__ import annotations

import torch

from ..ops import mp2_frame

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


def _read(data) -> bytes:
    if isinstance(data, str):
        with open(data, "rb") as fh:
            return fh.read()
    return bytes(data)


class AHX:
    """AHX (ADX-container MPEG-2 Layer II) decoder, the drop-in shape of the
    JAX package's AHX without its encode."""

    parse_header = staticmethod(parse_header)

    @staticmethod
    def decode(data, *, device="cuda") -> bytes:
        """AHX -> WAV (PCM16) on `device`: pycricodecs_tpu.models.ahx.
        AHX.decode's bytes (zero-filled to the declared sample count)."""
        from ..parallel import pipeline
        data = _read(data)
        parse_header(data)
        return pipeline._ahx_decode([data], torch.device(device), "raise",
                                    zero_fill=True)[0]

    @staticmethod
    def info(data) -> dict:
        data = _read(data)
        info = parse_header(data)
        hdr = mp2_frame.parse_header(data, info["data_offset"])
        info.update(bitrate=hdr.bitrate, mpeg_version=hdr.version,
                    frame_size=hdr.frame_size, mode=hdr.mode)
        return info
