"""Magic-byte format detection shared by the CLI and the container layer
(a copy of pycricodecs_tpu/utils/sniff.py, held equal by
tests/test_torch_containers.py)."""
from __future__ import annotations


def sniff(data: bytes) -> str:
    """Identify a CRIWARE-adjacent blob by its magic bytes.

    Returns one of: cpk, awb, usm, acb, hca, adx, ahx, wav, ivf — or raises
    ValueError.  AHX rides the ADX container (0x80 0x00 magic) with encoding
    type byte 0x10/0x11 where ADPCM uses 2/3/4.
    """
    if data[:4] == b"CPK ":
        return "cpk"
    if data[:4] == b"AFS2":
        return "awb"
    if data[:4] == b"CRID":
        return "usm"
    if data[:4] in (b"@UTF", b"\x1f\x9e\xf3\xf5"):
        return "acb"
    if data[:4] == b"HCA\x00" or bytes(b & 0x7F for b in data[:4]) == b"HCA\x00":
        return "hca"
    if data[:1] == b"\x80":
        return "ahx" if len(data) > 4 and data[4] in (0x10, 0x11) else "adx"
    if data[:4] == b"RIFF":
        return "wav"
    if data[:4] == b"DKIF":
        return "ivf"
    raise ValueError("unrecognised input format")
