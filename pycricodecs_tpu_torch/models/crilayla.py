"""CRILAYLA compression (LZ77 variant operating backwards from the buffer end).

Counterpart of pycricodecs_tpu/models/crilayla.py, whose `decompress` and
`compress` run its native C++ core (cricore.cpp cri_layla_decompress and
cri_layla_compress). Here they run on the card as kernels C1 and C2
(csrc/crilayla.cu, ops/cuda_kernels.py): `decompress_batch` makes one
wrapper call for all the members of a call (its stages' kernels in order),
`compress_batch` one for each C2_BUDGET of their bytes, and
`decompress` / `compress` are one-member batches. The pure-Python
`_decompress_py` and `_compress_py` (copies of the JAX package's fallbacks,
decompress made linear and its copy length a u32, as in the native) are
the kernels' plain versions: a CPU device runs them member by member. All
give the JAX package's bytes (tests hold them equal).

Format (crilayla.cpp:19-23): 16-byte header {"CRILAYLA", u32 decompress_size,
u32 compressed_size} + compressed bitstream + 256-byte raw prefix appended at
the end (copied verbatim to the output head).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import cuda_kernels
from ..utils import tracing
from ..utils.device import as_device

MAGIC = b"CRILAYLA"
MALFORMED = "Malformed CRILAYLA stream"
TOO_SMALL = "CRILAYLA compression needs more than 256 bytes"
# the JAX native's refusal text (its `return 0`)
OVER_CAPACITY = ("CRILAYLA compression failed (input too small or "
                 "incompressible beyond buffer)")
#: source bytes C2 takes in one wrapper call: its scratch on the card is
#: about 19.5 bytes a source byte (`cuda_kernels.crilayla_compress`), so
#: a call stays near 2.6 GB; a larger member is a call alone
C2_BUDGET = 1 << 27


def parse(data: bytes) -> tuple:
    """(payload, compressed_size, decompress_size) of a CRILAYLA blob, after
    the JAX package's magic and size checks (ValueError)."""
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
    return payload, compressed_size, decompress_size


def decompress(data: bytes, *, device="cuda") -> bytes:
    """Parity with CriCodecs.CriLaylaDecompress: returns prefix + payload."""
    return decompress_batch([data], device=device)[0]


def decompress_batch(blobs, *, device="cuda") -> list:
    """[decompress(b) for b in blobs] in one launch of C1 on `device`;
    raises the error the first failing member raises alone. Spans (while
    a profiler runs, `utils.tracing`): `crilayla.decompress` around the
    call, `crilayla.parse` around the blobs' checks."""
    with tracing.span("crilayla.decompress"):
        parsed, error = [], None
        with tracing.span("crilayla.parse"):
            on, copied = tracing.enabled(), 0
            for blob in blobs:
                try:
                    parsed.append(parse(blob))
                except ValueError as exc:
                    error = exc
                    break
                if on:  # `parse`'s copies: bytes() of a blob not bytes,
                    # the payload's slice
                    copied += len(parsed[-1][0]) + (
                        0 if isinstance(blob, bytes) else len(blob))
            tracing.count("host_bytes", copied)
        outs = decompress_members(parsed, device=device)
    if None in outs:
        raise ValueError(MALFORMED)
    if error is not None:
        raise error
    return outs


def decompress_members(parsed, *, device="cuda") -> list:
    """C1 over parsed members [(payload, compressed_size, decompress_size)]
    in one launch: each member's prefix + payload, or None where its
    stream is malformed. A CPU device runs `_decompress_py` per member.
    Spans on a CUDA device: `crilayla.pack`, `crilayla.h2d`, C1's
    `c1.prepare` and `c1.launch`, `crilayla.wait` (the host blocked until
    C1 ends), `crilayla.d2h`, `crilayla.collect` (the members' bytes
    out)."""
    if not parsed:
        return []
    device = as_device(device)
    if device.type == "cpu":
        outs = []
        for p in parsed:
            try:
                outs.append(_decompress_py(*p))
            except ValueError:
                outs.append(None)
        return outs
    with tracing.span("crilayla.pack"):
        src, meta, out_size = pack_decompress(parsed)
        tracing.count("host_bytes", src.nbytes)
    with tracing.span("crilayla.h2d", h2d_bytes=src.nbytes):
        src = torch.from_numpy(src).to(device)
    out, status, _ = cuda_kernels.crilayla_decompress(src, meta, out_size)
    with tracing.span("crilayla.wait"):
        torch.cuda.current_stream(out.device).synchronize()
    with tracing.span("crilayla.d2h"):
        out, status = out.cpu().numpy(), status.cpu().numpy()
        if tracing.enabled():
            tracing.count("d2h_bytes", out.nbytes + status.nbytes)
            tracing.count("d2h_kept_bytes",
                          int((meta[:, 2] + 256)[status == 0].sum()))
    with tracing.span("crilayla.collect"):
        outs = [None if status[m] else out[o:o + ds + 256].tobytes()
                for m, (o, ds) in enumerate(zip(meta[:, 3], meta[:, 2]))]
        if tracing.enabled():
            tracing.count("host_bytes", sum(len(o) for o in outs if o))
    return outs


def pack_decompress(parsed) -> tuple:
    """C1's inputs for parsed members: (the payloads' bytes u8 [n], meta
    int64 [M, 4], the output's size)."""
    meta = np.zeros((len(parsed), 4), dtype=np.int64)
    src_off = out_off = 0
    for m, (payload, cs, ds) in enumerate(parsed):
        meta[m] = (src_off, cs, ds, out_off)
        src_off += cs + 256
        out_off += ds + 256
    src = np.empty(src_off, dtype=np.uint8)
    for (payload, cs, _), off in zip(parsed, meta[:, 0]):
        src[off:off + cs + 256] = np.frombuffer(payload, np.uint8,
                                                count=cs + 256)
    return src, meta, out_off


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
                raise ValueError(MALFORMED)
            acc = (acc << 8) | payload[pos]
            pos -= 1
            nbits += 8
        v = (acc >> (nbits - n)) & ((1 << n) - 1)
        nbits -= n
        # keep only the unread bits: an unmasked accumulator grows as long
        # as the stream, and every shift copies it (quadratic time)
        acc &= (1 << nbits) - 1
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
                            # a u32, as the JAX native's length
                            length = (length + byte) & 0xFFFFFFFF
                            if byte != 255:
                                break
            r = w + offset + 3
            if r >= len(out):
                raise ValueError(MALFORMED)
            length = (length + 3) & 0xFFFFFFFF
            while length and w >= base:
                out[w] = out[r]
                w -= 1
                r -= 1
                length -= 1
    return bytes(out)


def compress(data: bytes, *, device="cuda") -> bytes:
    """Parity with CriCodecs.CriLaylaCompress (greedy backward matcher)."""
    return compress_batch([data], device=device)[0]


def compress_batch(datas, *, device="cuda") -> list:
    """[compress(d) for d in datas] through `compress_members` on `device`;
    raises the ValueError of the first member it refuses."""
    outs = compress_members(datas, device=device)
    for out, data in zip(outs, datas):
        if out is None:
            raise ValueError(TOO_SMALL if len(data) < 0x101
                             else OVER_CAPACITY)
    return outs


def compress_members(datas, *, device="cuda") -> list:
    """C2 over the members, one wrapper call for each run of members in
    order whose bytes stay within C2_BUDGET (a larger member alone): each
    one's CRILAYLA blob, or None where the kernel refuses it (0x100 bytes
    or fewer, or over its work buffer's capacity). A CPU device runs
    `_compress_py` per member. Spans (while a profiler runs,
    `utils.tracing`): `crilayla.compress` around the call, counting its
    `members` and `source_bytes`; on a CUDA device, for each wrapper
    call, those `_compress_call` names."""
    with tracing.span("crilayla.compress"):
        datas = [bytes(d) for d in datas]
        if tracing.enabled():
            tracing.count("members", len(datas))
            tracing.count("source_bytes", sum(map(len, datas)))
        outs, i = [], 0
        while i < len(datas):
            j, held = i + 1, len(datas[i])
            while j < len(datas) and held + len(datas[j]) <= C2_BUDGET:
                held += len(datas[j])
                j += 1
            outs += _compress_call(datas[i:j], device)
            i = j
    return outs


#: bytes `assemble` makes a member besides two copies of its stream: the
#: size fields (4 + 4), the prefix slice (0x100) and its four
#: concatenations' results less the stream (12, 16, 16, 16 + 0x100)
ASSEMBLE_BYTES = 8 + 0x100 + 12 + 16 + 16 + 16 + 0x100


def _compress_call(datas, device) -> list:
    """`compress_members` of one wrapper call. Spans on a CUDA device:
    `crilayla.pack`, `crilayla.h2d`, C2's `c2.prepare` and `c2.launch`,
    `crilayla.wait` (the host blocked until C2 ends), `crilayla.d2h` (the
    whole work buffer, of which the streams are kept) and
    `crilayla.collect` (the streams' slices and `assemble`)."""
    device = as_device(device)
    if device.type == "cpu":
        return [_compress_py(d) if len(d) >= 0x101 else None for d in datas]
    with tracing.span("crilayla.pack"):
        src, meta, work_size = pack_compress(datas)
        caps = cuda_kernels.crilayla_work_cap(meta[:, 1])
        # the join and its copy
        tracing.count("host_bytes", 2 * src.nbytes)
    with tracing.span("crilayla.h2d", h2d_bytes=src.nbytes):
        src = torch.from_numpy(src).to(device)
    work, start, status, _ = cuda_kernels.crilayla_compress(src, meta,
                                                            work_size)
    with tracing.span("crilayla.wait"):
        torch.cuda.current_stream(work.device).synchronize()
    with tracing.span("crilayla.d2h"):
        work = work.cpu().numpy()
        start, status = start.cpu().numpy(), status.cpu().numpy()
        if tracing.enabled():
            tracing.count("d2h_bytes",
                          work.nbytes + start.nbytes + status.nbytes)
            tracing.count("d2h_kept_bytes",
                          int((caps - start)[status == 0].sum()))
    with tracing.span("crilayla.collect"):
        outs = []
        for m, data in enumerate(datas):
            if status[m]:
                outs.append(None)
                continue
            outs.append(assemble(data, work[meta[m, 2] + start[m]:
                                            meta[m, 2] + caps[m]].tobytes()))
        if tracing.enabled():
            ok = status == 0
            # `.tobytes()` and `assemble`: each stream three times
            tracing.count("host_bytes", 3 * int((caps - start)[ok].sum())
                          + ASSEMBLE_BYTES * int(ok.sum()))
    return outs


def assemble(data: bytes, stream: bytes) -> bytes:
    """The CRILAYLA blob of `data` from its compressed stream: the header,
    the stream and the 256-byte raw prefix."""
    return (MAGIC + (len(data) - 0x100).to_bytes(4, "little")
            + len(stream).to_bytes(4, "little") + stream + data[:0x100])


def pack_compress(datas) -> tuple:
    """C2's inputs for members (bytes): (their bytes u8 [n], meta int64
    [M, 3], the work buffer's size)."""
    lengths = np.array([len(d) for d in datas], dtype=np.int64)
    caps = cuda_kernels.crilayla_work_cap(lengths)
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    work = np.concatenate([[0], np.cumsum(caps)[:-1]])
    meta = np.ascontiguousarray(np.stack([starts, lengths, work], 1),
                                dtype=np.int64)
    src = np.frombuffer(b"".join(datas), dtype=np.uint8).copy()
    return src, meta, int(caps.sum())


def _compress_py(data: bytes) -> bytes:
    src_len = len(data)
    if src_len < 0x101:
        raise ValueError(TOO_SMALL)
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
    return assemble(data, bytes(work[m:]))
