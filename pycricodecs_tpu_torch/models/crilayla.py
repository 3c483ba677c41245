"""CRILAYLA compression (LZ77 variant operating backwards from the buffer end).

A copy of the pure-Python halves of pycricodecs_tpu/models/crilayla.py
(`_decompress_py`, `_compress_py`, with `decompress`'s magic and size
checks); the JAX package prefers its native C++ core, which this port does
not carry, and the two agree byte for byte (tests hold them equal).

Format (crilayla.cpp:19-23): 16-byte header {"CRILAYLA", u32 decompress_size,
u32 compressed_size} + compressed bitstream + 256-byte raw prefix appended at
the end (copied verbatim to the output head). Host code: the format is a
serial bit stream read backwards, and a bank's CPK carries a few of them.
"""
from __future__ import annotations

MAGIC = b"CRILAYLA"


def decompress(data: bytes) -> bytes:
    """Parity with CriCodecs.CriLaylaDecompress: returns prefix + payload."""
    data = bytes(data)
    if data[:8] != MAGIC:
        # the reference doesn't validate the magic; uncompressed TOC entries
        # are never routed here, so treat a bad magic as an error
        raise ValueError("Not a CRILAYLA blob")
    decompress_size = int.from_bytes(data[8:12], "little")
    compressed_size = int.from_bytes(data[12:16], "little")
    payload = data[16:]
    if compressed_size + 256 > len(payload):
        raise ValueError("Truncated CRILAYLA blob")
    # LZ back-references expand at most ~255 bytes per flag bit, so a header
    # claiming more than ~256x the compressed bytes is corrupt; checking it
    # here keeps hostile archives from forcing multi-GiB allocations
    if decompress_size > 256 * max(compressed_size, 1) + 256:
        raise ValueError("Implausible CRILAYLA decompress size")
    return _decompress_py(payload, compressed_size, decompress_size)


def _decompress_py(payload: bytes, compressed_size: int,
                   decompress_size: int) -> bytes:
    out = bytearray(decompress_size + 256)
    out[:256] = payload[compressed_size:compressed_size + 256]
    pos = compressed_size - 1  # read bytes backward
    acc = 0
    nbits = 0

    def get(n):
        nonlocal pos, acc, nbits
        while nbits < n:
            if pos < 0:
                raise ValueError("Malformed CRILAYLA stream")
            acc = (acc << 8) | payload[pos]
            pos -= 1
            nbits += 8
        v = (acc >> (nbits - n)) & ((1 << n) - 1)
        nbits -= n
        return v

    w = decompress_size + 256 - 1
    base = 256
    while w >= base:
        if get(1) == 0:
            out[w] = get(8)
            w -= 1
        else:
            offset = get(13)
            length = get(2)
            if length == 3:
                length += get(3)
                if length == 10:
                    length += get(5)
                    if length == 41:
                        while True:
                            byte = get(8)
                            length += byte
                            if byte != 255:
                                break
            r = w + offset + 3
            if r >= len(out):
                raise ValueError("Malformed CRILAYLA stream")
            length += 3
            while length and w >= base:
                out[w] = out[r]
                w -= 1
                r -= 1
                length -= 1
    return bytes(out)


def compress(data: bytes) -> bytes:
    """Parity with CriCodecs.CriLaylaCompress (greedy backward matcher)."""
    return _compress_py(bytes(data))


def _compress_py(data: bytes) -> bytes:
    src_len = len(data)
    if src_len < 0x101:
        raise ValueError("CRILAYLA compression needs more than 256 bytes")
    # backward greedy matcher; work buffer congruent to src_len mod 4 so the
    # stream padding matches the reference exactly
    cap = src_len + ((src_len // 2 + 0x403) & ~3)
    work = bytearray(cap)
    m = cap - 1
    d = 0
    t = 0

    def flush():
        nonlocal m, d, t
        while t >= 8:
            work[m] = (d >> (t - 8)) & 0xFF
            m -= 1
            t -= 8
            d &= (1 << t) - 1

    n = src_len - 1
    while n >= 0x100:
        j = min(n + 3 + 0x2000, src_len)
        best_len = 0
        best_off = 0
        kmax = n - 0x100
        for i in range(n + 3, j):
            k = 0
            while k <= kmax and data[n - k] == data[i - k]:
                k += 1
            if k > best_len:
                best_off = i - n - 3
                best_len = k
        if best_len < 3:
            d = (d << 9) | data[n]
            t += 9
            n -= 1
        else:
            d = (((d << 1) | 1) << 13) | best_off
            t += 14
            n -= best_len
            p = best_len
            if p < 6:
                d = (d << 2) | (p - 3)
                t += 2
            elif p < 13:
                d = (((d << 2) | 3) << 3) | (p - 6)
                t += 5
            elif p < 44:
                d = (((d << 5) | 0x1F) << 5) | (p - 13)
                t += 10
            else:
                d = (d << 10) | 0x3FF
                t += 10
                p -= 44
                while True:
                    flush()
                    if p < 255:
                        break
                    d = (d << 8) | 0xFF
                    t += 8
                    p -= 0xFF
                d = (d << 8) | p
                t += 8
        flush()
    if t:
        work[m] = (d << (8 - t)) & 0xFF
        m -= 1
    work[m] = 0
    m -= 1
    work[m] = 0
    while (cap - m) & 3:
        m -= 1
        work[m] = 0
    stream = bytes(work[m:])
    header = (MAGIC + (src_len - 0x100).to_bytes(4, "little")
              + len(stream).to_bytes(4, "little"))
    return header + stream + data[:0x100]
