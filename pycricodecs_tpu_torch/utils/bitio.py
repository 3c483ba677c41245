"""MSB-first bitstream reader for HCA header parsing, and the writer of
the Layer II frame reference (ops/mp2_frame.pack_frame).

Reader semantics mirror the hca.cpp clData reader (bitreader_peek,
hca.cpp:224-281): bits are consumed most-significant-first within each
byte, and any read that crosses the end of the buffer returns 0. The writer
is a copy of pycricodecs_tpu/utils/bitio.py::BitWriter: a write past the
end of the buffer is dropped.
"""
from __future__ import annotations


class BitReader:
    __slots__ = ("buf", "nbits", "pos")

    def __init__(self, data) -> None:
        self.buf = bytes(data)
        self.nbits = len(self.buf) * 8
        self.pos = 0

    def peek(self, count: int) -> int:
        if count > self.nbits - self.pos or count == 0:
            return 0
        start = self.pos >> 3
        bit_off = self.pos & 7
        nbytes = (bit_off + count + 7) >> 3
        chunk = int.from_bytes(self.buf[start:start + nbytes], "big")
        return (chunk >> (nbytes * 8 - bit_off - count)) & ((1 << count) - 1)

    def read(self, count: int) -> int:
        v = self.peek(count)
        self.pos += count
        return v

    def skip(self, count: int) -> None:
        self.pos += count


class BitWriter:
    __slots__ = ("buf", "nbits", "pos")

    def __init__(self, size: int) -> None:
        self.buf = bytearray(size)
        self.nbits = size * 8
        self.pos = 0

    def write(self, value: int, count: int) -> None:
        if count < 0 or count > 32 or count > self.nbits - self.pos:
            return
        value &= (1 << count) - 1
        pos = self.pos
        self.pos += count
        while count > 0:
            byte_idx = pos >> 3
            bit_idx = pos & 7
            take = min(count, 8 - bit_idx)
            shift = 8 - bit_idx - take
            piece = (value >> (count - take)) & ((1 << take) - 1)
            mask = ((1 << take) - 1) << shift
            self.buf[byte_idx] = (self.buf[byte_idx] & ~mask) | (piece << shift)
            pos += take
            count -= take

    def getvalue(self) -> bytes:
        return bytes(self.buf)
