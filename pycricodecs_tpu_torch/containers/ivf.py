"""IVF container (VP9 video as used inside USM files): the reader and
build_ivf.

A copy of pycricodecs_tpu/containers/ivf.py (held equal by
tests/test_torch_ivf.py). Parity surface: PyCriCodecs.IVF (ivf.py:9-61).
Host code: a frame walk over a file, bytes or an open stream.
"""
from __future__ import annotations

from io import BytesIO, FileIO
from struct import Struct
from typing import Generator

IvfChunkHeaderStruct = Struct("<4sHH4sHHIIII")
IvfFrameChunkHeaderStruct = Struct("<IQ")
# Quirk reproduced for parity (see PARITY.md): the reference matches this
# magic against data that STARTS with the 12-byte IVF frame header
# (ivf.py:53-59), so the flag never fires and built USMs carry minchk=0.
KEYFRAME_FLAG = b"\x82I\x83B"


class IVF:
    __slots__ = ["ivf", "stream"]

    def __init__(self, ivffile) -> None:
        if isinstance(ivffile, str):
            self.stream = FileIO(ivffile)
        elif isinstance(ivffile, (bytes, bytearray)):
            self.stream = BytesIO(ivffile)
        else:
            self.stream = ivffile
        self._load()

    def _load(self) -> None:
        (header, version, header_len, codec, width, height, tbd, tbn,
         num_frames, reserved) = IvfChunkHeaderStruct.unpack(
            self.stream.read(IvfChunkHeaderStruct.size))
        # the reference's check uses `and` (ivf.py:31), accepting files
        # where only one of magic/codec is right — a defect, not parity
        if header != b"DKIF" or codec != b"VP90":
            raise ValueError("Invalid or unsupported IVF file/codec.")
        self.ivf = dict(
            Header=header, Version=version, HeaderSize=header_len, Codec=codec,
            Width=width, Height=height, time_base_denominator=tbd,
            time_base_numerator=tbn, FrameCount=num_frames, Reserved=reserved)
        self.stream.seek(header_len, 0)

    def loadfile(self) -> None:
        """Drop-in alias for the reference's loadfile (ivf.py:21)."""
        self.stream.seek(0)
        return self._load()

    def get_frames(self) -> Generator:
        """Yield (size+12, timestamp, index, frame-with-12B-header, keyframe)."""
        for i in range(self.ivf["FrameCount"]):
            frame_size, timestamp = IvfFrameChunkHeaderStruct.unpack(
                self.stream.read(IvfFrameChunkHeaderStruct.size))
            self.stream.seek(-IvfFrameChunkHeaderStruct.size, 1)
            data = self.stream.read(frame_size + IvfFrameChunkHeaderStruct.size)
            yield (frame_size + IvfFrameChunkHeaderStruct.size, timestamp, i,
                   data, data.startswith(KEYFRAME_FLAG))

    def info(self) -> dict:
        return self.ivf


def build_ivf(frames: list, width: int = 640, height: int = 360,
              fps_num: int = 30, fps_den: int = 1) -> bytes:
    """Assemble an IVF container from raw VP9 frame payloads (test helper /
    builder counterpart; the reference package has no IVF writer)."""
    out = bytearray(IvfChunkHeaderStruct.pack(
        b"DKIF", 0, 32, b"VP90", width, height, fps_num, fps_den,
        len(frames), 0))
    for i, frame in enumerate(frames):
        out += IvfFrameChunkHeaderStruct.pack(len(frame), i)
        out += frame
    return bytes(out)
