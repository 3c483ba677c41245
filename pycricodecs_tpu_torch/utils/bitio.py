"""MSB-first bitstream reader for HCA header parsing.

Semantics mirror the hca.cpp clData reader (bitreader_peek, hca.cpp:224-281):
bits are consumed most-significant-first within each byte, and any read that
crosses the end of the buffer returns 0.
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
