"""Shared binary layouts and enums for CRI container formats.

A copy of pycricodecs_tpu/containers/chunk.py (held equal by
tests/test_torch_containers.py). Parity reference: PyCriCodecs/chunk.py —
same struct formats and enum values so downstream code (and user code
switching over) sees identical constants.
"""
from enum import Enum
from struct import Struct

UTFChunkHeader = Struct(">4sIIIIIHHI")
USMChunkHeader = Struct(">4sIBBHBBBBIIII")
CPKChunkHeader = Struct("<4sIII")
AWBChunkHeader = Struct("<4sBBHIHH")
SBTChunkHeader = Struct("<IIIII")
# WAV structs kept for drop-in compatibility (chunk.py:9-12). The reference's
# own comment admits WavHeaderStruct wrongly fuses RIFF+fmt; utils/wav.py is
# the real parser — these exist only so `from <pkg> import WavHeaderStruct`
# keeps working for reference users.
WavHeaderStruct = Struct("<4sI4s4sIHHIIHH")
WavSmplHeaderStruct = Struct("<4sIIIIIIIIIIIIIIII")
WavNoteHeaderStruct = Struct("<4sII")
WavDataHeaderStruct = Struct("<4sI")


class USMChunckHeaderType(Enum):
    CRID = b"CRID"
    SFSH = b"SFSH"
    SFV = b"@SFV"
    SFA = b"@SFA"
    ALP = b"@ALP"
    CUE = b"@CUE"
    SBT = b"@SBT"
    AHX = b"@AHX"
    USR = b"@USR"
    PST = b"@PST"


class CPKChunkHeaderType(Enum):
    CPK = b"CPK "
    TOC = b"TOC "
    ITOC = b"ITOC"
    GTOC = b"GTOC"
    ETOC = b"ETOC"
    HTOC = b"HTOC"
    HGTOC = b"HGTOC"


class UTFType(Enum):
    UTF = b"@UTF"
    EUTF = b"\x1F\x9E\xF3\xF5"


class AWBType(Enum):
    AFS2 = b"AFS2"


class HCAType(Enum):
    HCA = b"HCA\x00"
    EHCA = b"\xC8\xC3\xC1\x00"


class VideoType(Enum):
    IVF = b"DKIF"


class UTFTypeValues(Enum):
    uchar = 0
    char = 1
    ushort = 2
    short = 3
    uint = 4
    int = 5
    ullong = 6
    llong = 7
    float = 8
    double = 9
    string = 10
    bytes = 11


class CriHcaQuality(Enum):
    Highest = 0
    High = 1
    Middle = 2
    Low = 3
    Lowest = 5
