"""PyTorch port, CRILAYLA (pycricodecs_tpu_torch/models/crilayla.py and
kernels C1 / C2 in csrc/crilayla.cu): the plain versions against the JAX
package's native core, `_decompress_py` in linear time on the 540,066-byte
member, numpy models of the kernels' stages (C1: the word-fed parse and the
pointer-jumping materialisation; C2: the tiled run-length search with its
carry combine and packed keys, the tile walks and their repair, the
scanned bit placement) against the plain versions and the JAX native, and
the batch functions against the single ones, errors included. On the CPU
every call runs the plain versions; the card's check is chip_smoke.py's
phase 19."""
import os
import time

import numpy as np
import pytest
import torch

from pycricodecs_tpu.models import crilayla as jax_crilayla
from pycricodecs_tpu_torch.models import crilayla
from pycricodecs_tpu_torch.ops import cuda_kernels as CK
from pycricodecs_tpu_torch.utils import signals
from tests import torch_port_helpers as H

ADX_BANK = os.path.join(H.FIXTURE_DIR, "adx", signals.ADX_BANK + ".adx")
# the kernels' geometry (csrc/crilayla.cu; test_model_geometry_is_the_kernels)
TILE = 4096          # kTile: a search CTA's, a tile walk's, an emit block's
WINDOW = 0x2000      # kWindow: deltas 3 .. 0x2002
PER_THREAD = 32      # kPerThread: a search thread's deltas
EMIT_THREADS = 256   # kEmitThreads
EMIT_PER = 16        # kEmitPer: an emitting thread's positions
CHUNK_BITS = 16384   # kChunkBits: C1's tile parse's stream bits


def _payloads():
    rng = np.random.default_rng(3)
    return [bytes(rng.integers(0, 256, 300, dtype=np.uint8)), b"\0" * 1000,
            b"abcdefgh" * 200, bytes(rng.integers(0, 4, 2000, dtype=np.uint8)),
            b"cpk fuzz corpus " * 64]


# -- the plain versions against the JAX package ---------------------------------

def test_linear_decompress_on_the_native_compressed_adx_bank():
    """The 10 s ADX stream (540,066 bytes), compressed by the JAX native:
    `_decompress_py` gives the native's bytes, in linear time (the
    unmasked accumulator took about a minute on a CPU; a 30 s bound leaves a
    wide margin for a loaded machine)."""
    with open(ADX_BANK, "rb") as f:
        raw = f.read()
    assert len(raw) == 540066
    blob = jax_crilayla.compress(raw)
    payload, cs, ds = crilayla.parse(blob)
    t0 = time.perf_counter()
    got = crilayla._decompress_py(payload, cs, ds)
    seconds = time.perf_counter() - t0
    assert got == jax_crilayla.decompress(blob) == raw
    assert seconds < 30, seconds


@pytest.mark.parametrize("i", range(5))
def test_compress_and_decompress_equal_the_native(i):
    data = _payloads()[i]
    blob = crilayla.compress(data, device="cpu")
    assert blob == jax_crilayla.compress(data)
    assert crilayla.decompress(blob, device="cpu") == data


@pytest.mark.parametrize("i", range(len(signals.crilayla_edge_payloads())))
def test_edge_payloads_equal_the_native(i):
    data = signals.crilayla_edge_payloads()[i]
    assert crilayla.compress(data, device="cpu") == \
        jax_crilayla.compress(data)


@pytest.mark.parametrize("data", [b"", b"x" * 0x100])
def test_small_inputs_are_refused(data):
    with pytest.raises(ValueError):
        jax_crilayla.compress(data)
    with pytest.raises(ValueError, match="more than 256 bytes"):
        crilayla.compress(data, device="cpu")
    assert crilayla.compress_members([data], device="cpu") == [None]


# -- C1: the word-fed parse and the pointer-jumping materialisation -------------

def c1_words(payload: bytes, cs: int, base: int = 0):
    """The stream's words as C1 reads them, the payload `base` bytes into a
    16-byte aligned buffer: word i is the 4 bytes at a0 - 4 i (a0 the word
    holding the payload's byte cs - 1), zero below the payload's first
    byte; stream bit b is bit (b + 8 sk) % 32 from the top of word
    (b + 8 sk) // 32. Returns (word(i), sk)."""
    buf = b"\x5a" * base + bytes(payload[:cs + 256])
    lo, top = base, base + cs
    a0 = (top - 1) & ~3

    def word(i):
        a = a0 - 4 * i
        if a + 4 <= lo:
            return 0
        v = int.from_bytes(buf[a:a + 4], "little")
        if a < lo:
            v &= ~((1 << (8 * (lo - a))) - 1) & 0xFFFFFFFF
        return v

    return word, a0 + 4 - top


def c1_decode(v: int):
    """decode(): (literal, width before a 255-run, length code, info)."""
    lit = not v >> 31
    l2, l3 = (v >> 16) & 3, (v >> 13) & 7
    width = 9 if lit else 16 if l2 != 3 else 19 if l3 != 7 else 24
    length = 0 if lit else l2 if l2 != 3 else 3 + l3 if l3 != 7 else \
        10 + ((v >> 8) & 31)
    info = 0x80000000 | ((v >> 23) & 0xFF) if lit else ((v >> 18) & 0x1FFF) + 3
    return lit, width, length, info


def c1_parse(payload: bytes, cs: int, ds: int, base: int = 0,
             chunk_bits: int = CHUNK_BITS, trace: dict = None):
    """C1's parse as its kernels run it. c1_spec: each chunk of chunk_bits
    stream bits parsed from its first bit, fed by words through a window
    (two words, o bits consumed), its tokens (output bytes, info, end bit),
    a bitmap of their starts with the tokens before each word, its exit.
    c1_repair: the true parse from bit 0, which meets a chunk's parse where
    it lands on one of its starts (the token's index from the bitmap) and
    jumps to that chunk's exit, and elsewhere parses tokens itself.
    c1_count / c1_offsets / c1_place / c1_finish: each chunk's true tokens
    (repair tokens, then its parse's from the meeting token), scanned for
    their first index and output position; the records of the tokens that
    start inside the output, the first back-reference past its end, the
    token that fills it and whether it read past the stream. Lengths are
    u32s, as the native's. Returns (records [(top position counted from
    the LZ region, literal byte or None, distance or None)],
    status, steps); `trace` gets the repair's own tokens and the chunks."""
    word, sk = c1_words(payload, cs, base)
    bits = 8 * cs
    nc = -(-bits // chunk_bits)
    nwords = chunk_bits // 32

    def bits32(x):
        g = x + 8 * sk
        return ((word(g >> 5) << 32 | word((g >> 5) + 1)) << (g & 31)
                >> 32) & 0xFFFFFFFF

    def token(v, more):
        lit, width, length, info = c1_decode(v)
        if not lit and length == 41:
            while True:
                x = more(width) >> 24
                width += 8
                length = (length + x) & 0xFFFFFFFF
                if x != 255:
                    break
        return ((1 if lit else (length + 3) & 0xFFFFFFFF), info), width

    spec = []
    for k in range(nc):
        s, e = k * chunk_bits, min((k + 1) * chunk_bits, bits)
        g = s + 8 * sk
        win = dict(i=(g >> 5) + 1, a=word(g >> 5), b=word((g >> 5) + 1),
                   o=g & 31)

        def view():
            return (((win["a"] << 32) | win["b"]) << win["o"] >> 32) \
                & 0xFFFFFFFF

        def consume(n):
            win["o"] += n
            if win["o"] >= 32:
                win["o"] -= 32
                win["i"] += 1
                win["a"], win["b"] = win["b"], word(win["i"])

        recs, bm, b = [], [0] * nwords, s
        while b < e:
            r = b - s
            bm[r >> 5] |= 1 << (r & 31)
            lit, width, length, info = c1_decode(view())
            consume(width)
            if not lit and length == 41:
                while True:
                    x = view() >> 24
                    consume(8)
                    width += 8
                    length = (length + x) & 0xFFFFFFFF
                    if x != 255:
                        break
            b += width
            recs.append(((1 if lit else (length + 3) & 0xFFFFFFFF), info, b))
        pre = list(np.cumsum([0] + [bin(x).count("1") for x in bm[:-1]]))
        spec.append(dict(recs=recs, bm=bm, pre=pre, exit=b, conv=-1,
                         rep=[]))
    b = 0
    while b < bits:
        k = b // chunk_bits
        c, r = spec[k], b - k * chunk_bits
        wd = c["bm"][r >> 5]
        if (wd >> (r & 31)) & 1:
            c["conv"] = c["pre"][r >> 5] + bin(
                wd & ((1 << (r & 31)) - 1)).count("1")
            b = c["exit"]
            continue
        (out, info), width = token(bits32(b), lambda n: bits32(b + n))
        b += width
        c["rep"].append((out, info, b))
    if trace is not None:
        trace["chunks"] = spec
        trace["repaired"] = sum(len(c["rep"]) for c in spec)
    true = [c["rep"] + (c["recs"][c["conv"]:] if c["conv"] >= 0 else [])
            for c in spec]
    counts = [len(t) for t in true]
    outs = [sum(x[0] for x in t) for t in true]
    tbase = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(int)
    obase = np.concatenate([[0], np.cumsum(outs)[:-1]]).astype(int)
    end = ds + 256
    under = sum(outs) < ds
    ntok = 0 if ds == 0 else sum(counts)
    first_bad, recs = None, {}
    for k, toks in enumerate(true):
        w, idx = end - 1 - obase[k], tbase[k]
        for out, info, stop in toks:
            if w < 256:
                break
            if not info & 0x80000000 and w + info >= end:
                first_bad = idx if first_bad is None else min(first_bad, idx)
            recs[idx] = (w - 256, info & 0xFF, None) \
                if info & 0x80000000 else (w - 256, None, info)
            w -= out
            if w < 256:
                ntok = idx + 1
                under |= stop > bits
            idx += 1
    bad = first_bad is not None and first_bad < ntok
    status = int(bad or under)
    steps = first_bad + 1 if bad else ntok
    return [recs[i] for i in range(ntok)] if not status else None, \
        status, steps


def c1_materialise(payload: bytes, cs: int, ds: int, recs, trace=None):
    """C1's materialisation: each output byte's token by a binary search of
    the records (top positions descending), a literal's byte, a copy byte at
    p pointing at p + k D (k = (w - p) // D + 1: the first source above its
    own token), then rounds of pointer jumping until a round changes
    nothing (at most ceil(log2 size)), then the gather. `trace` collects
    the rounds that changed something."""
    end = ds + 256
    out = np.zeros(end, np.uint8)
    out[:256] = np.frombuffer(payload, np.uint8, count=256, offset=cs)
    ptrs = np.arange(end)
    tops = np.array([-r[0] for r in recs])    # ascending for searchsorted
    p = np.arange(256, end)
    t = np.searchsorted(tops, -(p - 256), side="right") - 1
    for pi, ti in zip(p, t):
        w, lit, dist = recs[ti]
        w += 256
        if dist is None:
            assert pi == w
            out[pi] = lit
        else:
            ptrs[pi] = pi + ((w - pi) // dist + 1) * dist
    rounds = max(1, ds.bit_length())
    for r in range(rounds):
        nxt = ptrs[ptrs]
        if (nxt == ptrs).all():
            break
        if trace is not None:
            trace.append(r)
        ptrs = nxt
    assert (ptrs[ptrs] == ptrs).all()
    out = out[ptrs]
    return out.tobytes()


def c1_model(payload: bytes, cs: int, ds: int, base: int = 0, trace=None,
             chunk_bits: int = CHUNK_BITS):
    """C1 end to end: the output bytes, or None (status 1)."""
    recs, status, _ = c1_parse(payload, cs, ds, base, chunk_bits)
    if status:
        return None
    if trace is not None:
        trace.extend(recs)
    return c1_materialise(payload, cs, ds, recs)


@pytest.mark.parametrize("i", range(5))
def test_c1_model_equals_the_plain_version(i):
    """At every alignment of the payload in its 16-byte block, at the
    kernel's chunk and at chunks of 64 and 96 bits (many chunks, most of
    them starting off the token grid)."""
    data = _payloads()[i]
    blob = jax_crilayla.compress(data)
    payload, cs, ds = crilayla.parse(blob)
    want = crilayla._decompress_py(payload, cs, ds)
    assert want == data
    for base in range(16):
        for chunk in (CHUNK_BITS, 64, 96):
            assert c1_model(payload, cs, ds, base,
                            chunk_bits=chunk) == want


@pytest.mark.parametrize("i", range(len(signals.crilayla_edge_payloads())))
def test_c1_model_decodes_the_edge_payloads(i):
    """Every length escape, ties, kmax and the window's edge, as the JAX
    native wrote them; the model's token count is the native's parse's."""
    data = signals.crilayla_edge_payloads()[i]
    blob = jax_crilayla.compress(data)
    payload, cs, ds = crilayla.parse(blob)
    for chunk in (CHUNK_BITS, 64):
        recs, status, steps = c1_parse(payload, cs, ds, i, chunk)
        assert status == 0 and steps == len(recs)
        assert c1_materialise(payload, cs, ds, recs) == data == \
            crilayla._decompress_py(payload, cs, ds)


def test_c1_model_resolves_self_overlapping_copies_and_deep_chains():
    """A run of one byte is one copy at D = 3 of its own bytes (the period
    shortcut resolves it in one hop); a chain of copies, each of the one
    above it, needs several rounds of pointer jumping."""
    rng = np.random.default_rng(5)
    head = bytes(rng.integers(0, 256, 300, dtype=np.uint8))
    run = head + b"\x07" * 5000
    blob = jax_crilayla.compress(run)
    payload, cs, ds = crilayla.parse(blob)
    recs = []
    assert c1_model(payload, cs, ds, 3, recs) == run
    assert any(d == 3 and w - nxt[0] > 3
               for (w, _, d), nxt in zip(recs, recs[1:]))
    # the same 40 bytes at offsets that chain: each copy's source is the
    # copy above it
    unit = bytes(rng.integers(0, 256, 40, dtype=np.uint8))
    chain = bytearray(head)
    for _ in range(30):
        chain += bytes(rng.integers(0, 256, 7, dtype=np.uint8)) + unit
    blob = jax_crilayla.compress(bytes(chain))
    payload, cs, ds = crilayla.parse(blob)
    recs, status, _ = c1_parse(payload, cs, ds)
    rounds = []
    assert status == 0
    assert c1_materialise(payload, cs, ds, recs, rounds) == bytes(chain)
    assert len(rounds) >= 3


def test_c1_repair_meets_the_chunk_parses_on_a_real_stream():
    """The 10 s ADX stream as the JAX native compresses it (165 chunks):
    the true parse meets every chunk's parse and parses fewer than 1 in 20
    of the tokens itself (the serial part), and the model's bytes are the
    native's."""
    with open(ADX_BANK, "rb") as f:
        raw = f.read()
    payload, cs, ds = crilayla.parse(jax_crilayla.compress(raw))
    trace = {}
    recs, status, steps = c1_parse(payload, cs, ds, 5, trace=trace)
    chunks = trace["chunks"]
    assert status == 0 and steps == len(recs) and len(chunks) > 100
    assert all(c["conv"] >= 0 for c in chunks[:-1])
    assert 0 < trace["repaired"] < len(recs) // 20
    assert c1_materialise(payload, cs, ds, recs) == raw


def test_c1_model_flags_malformed_streams_as_the_plain_version():
    blob = bytearray(jax_crilayla.compress(b"abcdefgh" * 200))
    rng = np.random.default_rng(9)
    flagged = 0
    for k in range(40):
        bad = bytearray(blob)
        for _ in range(3):
            bad[16 + int(rng.integers(0, 40))] ^= int(rng.integers(1, 256))
        payload, cs, ds = crilayla.parse(bytes(bad))
        try:
            want = crilayla._decompress_py(payload, cs, ds)
        except ValueError:
            want = None
        assert c1_model(payload, cs, ds, k % 16,
                        chunk_bits=(CHUNK_BITS, 64, 96)[k % 3]) == want
        flagged += want is None
    assert flagged > 0
    # an all-ones stream: a back-reference past the output's end; a stream
    # cut short: an underrun
    for stream in (b"\xff" * 40, b"\x00" * 2):
        payload = stream + blob[-256:]
        assert c1_parse(payload, len(stream), 5000)[1] == 1
        with pytest.raises(ValueError):
            crilayla._decompress_py(payload, len(stream), 5000)


# -- C2: the search, the walk and the emission -----------------------------------

def c2_search(src: np.ndarray, tile: int = TILE, key_bits: int = 32,
              force_narrow: bool = False):
    """C2's search: per tile, the trailing runs (c2_summary), their carry
    combine up the member (c2_carry), then the run-length recurrence with
    its carry and the packed keys, K = L * 8192 + (0x1FFF - (delta - 3))
    modulo 2^key_bits on the narrow path (the kernel's u32 keys at 32), the
    exact 64-bit key of each thread's longest run (the smallest delta on a
    tie) on the wide path, taken where the carry plus the tile could
    reach 2^(key_bits - 13). Returns (best key u64 [len], how many deltas
    share the longest length [len], which tiles ran wide)."""
    L = len(src)
    nt = (L - 0x100 + tile - 1) // tile
    dr = np.arange(WINDOW)
    off = (0x1FFF - dr).astype(np.uint64)
    offi = off.astype(np.int64)
    layout = (np.arange(8)[:, None, None] * 1024
              + 32 * np.arange(PER_THREAD)[None, :, None]
              + np.arange(32)[None, None, :])          # [warp, j, lane]

    padded = np.concatenate([src, np.zeros(WINDOW + 3, np.uint8)])
    inside = L - 3 - dr                       # n + delta < L: n < inside

    def eq_rows(n):
        grid = np.lib.stride_tricks.sliding_window_view(
            padded[n[0] + 3:n[-1] + 3 + WINDOW], WINDOW)
        return (grid == src[n][:, None]) & (n[:, None] < inside[None, :])

    runs = np.zeros((nt, WINDOW), np.int64)
    for t in range(nt - 1):
        n0 = 0x100 + t * tile
        alive = np.ones(WINDOW, bool)
        for x in range(tile - 1, -1, -1):
            alive &= eq_rows(np.array([n0 + x]))[0]
            if not alive.any():
                break
            runs[t] += alive
    carry = np.zeros((nt, WINDOW), np.int64)
    c = np.zeros(WINDOW, np.int64)
    for t in range(nt):
        carry[t] = c
        c = np.where(runs[t] == tile, c + tile, runs[t])
    best = np.zeros(L, np.uint64)
    ties = np.zeros(L, np.int64)
    wide_tiles = []
    narrow_max = (1 << (key_bits - 13)) - 1
    for t in range(nt):
        n0 = 0x100 + t * tile
        cnt = min(tile, L - n0)
        wide = not force_narrow and carry[t].max() + cnt > narrow_max
        wide_tiles.append(wide)
        prev = carry[t]
        for x0 in range(0, cnt, 256):
            n = n0 + np.arange(x0, min(x0 + 256, cnt))
            eq = eq_rows(n)
            run = np.empty(eq.shape, np.int64)
            for i in range(len(n)):                        # the recurrence
                prev = run[i] = np.where(eq[i], prev + 1, 0)
            if wide:
                lw = run[:, layout]                        # [rows, 8, j, lane]
                bj = lw.argmax(axis=2)                     # first max: least j
                bl = lw.max(axis=2).astype(np.uint64)
                key = (bl << np.uint64(13)) | off[
                    layout[:, 0, :][None] + 32 * bj]
                best[n] = key.max(axis=2).max(axis=1)      # lanes, then warps
            else:
                # a max of the keys: per thread, lane and warp, or at once
                best[n] = ((run * 8192 + offi) & ((1 << key_bits) - 1)
                           ).max(axis=1).astype(np.uint64)
            top = run.max(axis=1)
            ties[n] = (run == top[:, None]).sum(axis=1)
    return best, ties, wide_tiles


def c2_walk(best: np.ndarray, tile: int = TILE):
    """C2's walk: each tile's greedy walk from its top (flags bit 0, its
    exit), then the true parse from the member's top, which records where
    it meets a tile's walk and jumps to that walk's exit, and walks (flags
    bit 1) only where they differ. Returns (the token mask [len], the
    repair's walked steps)."""
    L = len(best)
    nt = (L - 0x100 + tile - 1) // tile
    length = (best >> np.uint64(13)).astype(np.int64)
    step = np.where(length >= 3, length, 1)
    flags = np.zeros(L, np.uint8)
    texit, conv = np.zeros(nt, np.int64), np.zeros(nt, np.int64)
    for t in range(nt):
        n0 = 0x100 + t * tile
        p = min(n0 + tile, L) - 1
        while p >= n0:
            flags[p] |= 1
            p -= step[p]
        texit[t], conv[t] = p, n0 - 1
    p, walked = L - 1, 0
    while p >= 0x100:
        t = (p - 0x100) // tile
        if flags[p] & 1:
            conv[t] = p
            p = texit[t]
            continue
        flags[p] |= 2
        p -= step[p]
        walked += 1
    n = np.arange(L)
    cv = np.full(L, L, np.int64)
    cv[0x100:] = conv[(n[0x100:] - 0x100) // tile]
    tok = np.where(n <= cv, flags & 1, flags & 2).astype(bool)
    tok[:0x100] = False
    return tok, walked


def c2_width(length: int) -> int:
    if length < 3:
        return 9
    if length < 44:
        return 16 if length < 6 else 19 if length < 13 else 24
    return 24 + 8 * ((length - 44) // 255 + 1)


def c2_emit(data: bytes, best: np.ndarray, tok: np.ndarray,
            tile: int = TILE):
    """C2's emission: per tile its tokens' bits (c2_count), the tiles'
    first bits scanned from the top (c2_offsets, with start and status),
    then per tile each thread's 16 positions, a suffix scan over the
    threads and each code ORed at bit 8 cap - b0 - width of the
    little-endian bit array (c2_place). Returns the stream, or None
    (status 2)."""
    L = len(data)
    nt = (L - 0x100 + tile - 1) // tile
    cap = CK.crilayla_work_cap(L)
    length = (best >> np.uint64(13)).astype(np.int64)
    wd = np.array([c2_width(int(x)) for x in length]) * tok
    tbits = [int(wd[0x100 + t * tile:0x100 + (t + 1) * tile].sum())
             for t in range(nt)]
    toff = np.zeros(nt, np.int64)
    total = 0
    for t in range(nt - 1, -1, -1):
        toff[t] = total
        total += tbits[t]
    nb = (total + 7) // 8
    padded = (nb + 2 + 3) & ~3
    if nb > cap - 3 or padded > cap:
        return None
    bitarr = np.zeros(8 * cap, np.uint8)

    def put(a, value, n):
        bitarr[a:a + n] |= ((value >> np.arange(n)) & 1).astype(np.uint8)

    for t in range(nt):
        n0 = 0x100 + t * tile
        threads = -(-tile // EMIT_PER)       # EMIT_THREADS at the kernel's
        w = np.zeros(threads * EMIT_PER, np.int64)
        cnt = min(tile, L - n0)
        w[:cnt] = wd[n0:n0 + cnt]
        own = w.reshape(threads, EMIT_PER).sum(axis=1)
        above = np.cumsum(own[::-1])[::-1] - own           # the threads above
        for th in range(threads):
            b0 = int(toff[t] + above[th])
            for i in range(EMIT_PER - 1, -1, -1):
                x = th * EMIT_PER + i
                if not w[x]:
                    continue
                n = n0 + x
                a = 8 * cap - b0 - int(w[x])
                k, o = int(length[n]), 0x1FFF - int(best[n] & 0x1FFF)
                if k < 3:
                    put(a, data[n], 9)
                elif k < 6:
                    put(a, (1 << 15) | (o << 2) | (k - 3), 16)
                elif k < 13:
                    put(a, (1 << 18) | (o << 5) | (3 << 3) | (k - 6), 19)
                elif k < 44:
                    put(a, (1 << 23) | (o << 10) | (0x1F << 5) | (k - 13), 24)
                else:
                    q, r = divmod(k - 44, 255)
                    put(a, r, 8)
                    bitarr[a + 8:a + 8 + 8 * q] = 1
                    put(a + 8 + 8 * q, (1 << 23) | (o << 10) | 0x3FF, 24)
                b0 += int(w[x])
    work = np.packbits(bitarr, bitorder="little").tobytes()
    return work[cap - padded:]


def c2_finish(data: bytes, best: np.ndarray, ties: np.ndarray = None,
              tile: int = TILE, trace: list = None):
    """C2's walk and emission after its search: the blob, or None (over
    capacity); `trace` collects (n, length, offset, how many deltas share
    the longest length) per token."""
    tok, _ = c2_walk(best, tile)
    if trace is not None:
        for n in np.flatnonzero(tok)[::-1]:
            trace.append((int(n), int(best[n] >> np.uint64(13)),
                          0x1FFF - int(best[n] & np.uint64(0x1FFF)),
                          int(ties[n])))
    stream = c2_emit(data, best, tok, tile)
    return None if stream is None else crilayla.assemble(data, stream)


def c2_model(data: bytes, trace: list = None):
    """C2 end to end at the kernels' geometry: the blob, or None (0x100
    bytes or fewer, or over capacity)."""
    if len(data) < 0x101:
        return None
    best, ties, _ = c2_search(np.frombuffer(data, np.uint8))
    return c2_finish(data, best, ties, trace=trace)


def test_model_geometry_is_the_kernels():
    """The constants above are csrc/crilayla.cu's and the wrapper's."""
    import re
    path = os.path.join(os.path.dirname(CK.__file__), "..", "csrc",
                        "crilayla.cu")
    with open(path) as f:
        src = f.read()

    names = {"kWindow": WINDOW, "kTile": TILE, "kSearchThreads": 256,
             "kEmitThreads": EMIT_THREADS, "kChunkBits": CHUNK_BITS}

    def const(name):  # the expression, with C's integer division
        expr = re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)
        return eval(expr.replace("/", "//"), dict(names))

    assert (const("kTile"), const("kWindow"), const("kEmitThreads"),
            const("kEmitPer")) == (TILE, WINDOW, EMIT_THREADS, EMIT_PER)
    assert const("kWindow") // const("kSearchThreads") == PER_THREAD
    assert (CK.CRILAYLA_TILE, CK.CRILAYLA_WINDOW) == (TILE, WINDOW)
    assert const("kChunkBits") == CHUNK_BITS == CK.CRILAYLA_CHUNK_BITS
    assert CK.CRILAYLA_CHUNK_CAP == const("kChunkCap")
    for enum, n in (("kCFields", CK.CRILAYLA_CHUNK_FIELDS),
                    ("kMFields", CK.CRILAYLA_MEMBER_FIELDS)):
        body = re.search(r"enum \{([^}]*" + enum + r")", src).group(1)
        assert body.count(",") == n, enum


def test_c2_model_equals_the_plain_version_at_every_edge():
    """The edge payloads reach ties (more than one candidate at the
    longest length), matches cut at kmax, the window's last offset
    (0x1FFF) and every length escape; the model's bytes are
    `_compress_py`'s."""
    traces = []
    for data in signals.crilayla_edge_payloads():
        trace = []
        assert c2_model(data, trace) == crilayla._compress_py(data)
        traces += trace
    lengths = [t[1] for t in traces if t[1] >= 3]
    assert any(t[3] > 1 for t in traces if t[1] >= 3)           # ties
    assert any(t[1] == t[0] - 0xFF for t in traces)             # kmax + 1
    assert max(t[2] for t in traces if t[1] >= 3) == 0x1FFF     # window edge
    for lo, hi in ((3, 6), (6, 13), (13, 44), (44, 44 + 255),
                   (44 + 255, 44 + 510), (44 + 510, 1 << 30)):
        assert any(lo <= x < hi for x in lengths), (lo, hi)


@pytest.mark.parametrize("i", range(5))
def test_c2_model_equals_the_plain_version(i):
    data = _payloads()[i]
    assert c2_model(data) == crilayla._compress_py(data) == \
        jax_crilayla.compress(data)


def _long_runs():
    rng = np.random.default_rng(7)
    head = bytes(rng.integers(0, 256, 0x180, dtype=np.uint8))
    tail = bytes(rng.integers(0, 256, 200, dtype=np.uint8))
    return {"run": head + b"\x07" * 9000 + tail,
            "period3": head + (b"xyz" * 3100) + tail}


@pytest.mark.parametrize("name", ["run", "period3"])
def test_c2_model_carries_runs_across_tiles(name):
    """A run of one byte and a period-3 pattern that cross several tiles:
    at the kernel's tile (its carry combine), and at a 64-position tile with
    13 + 7-bit keys, where every run past 127 takes the wide path; the
    model's bytes are the JAX native's. Forcing the narrow path there cuts
    the lengths and changes the bytes: the switch is what keeps them."""
    data = _long_runs()[name]
    want = jax_crilayla.compress(data)
    src = np.frombuffer(data, np.uint8)
    best, ties, wide = c2_search(src)
    assert c2_finish(data, best, ties) == want and not any(wide)
    best, ties, wide = c2_search(src, tile=64, key_bits=20)
    assert sum(wide) > 3 and not all(wide)
    assert c2_finish(data, best, ties, tile=64) == want
    best, ties, _ = c2_search(src, tile=64, key_bits=20, force_narrow=True)
    assert c2_finish(data, best, ties, tile=64) != want


def test_c2_walk_repairs_where_the_tile_walks_differ():
    """The tile walks start at their tops; where a tile's walk and the true
    parse disagree, the repair walks until they meet. Every token mask is
    the plain greedy walk's."""
    walked = 0
    for data in signals.crilayla_edge_payloads()[3:] + list(
            _long_runs().values()):
        best, _, _ = c2_search(np.frombuffer(data, np.uint8))
        for tile in (TILE, 97):
            tok, w = c2_walk(best, tile)
            length = (best >> np.uint64(13)).astype(np.int64)
            want = np.zeros(len(data), bool)
            n = len(data) - 1
            while n >= 0x100:
                want[n] = True
                n -= length[n] if length[n] >= 3 else 1
            assert (tok == want).all()
            walked += w
    assert walked > 0


# -- the batch functions -----------------------------------------------------------

def test_batches_equal_the_single_calls():
    datas = _payloads() + signals.crilayla_edge_payloads()[:3]
    blobs = crilayla.compress_batch(datas, device="cpu")
    assert blobs == [crilayla.compress(d, device="cpu") for d in datas]
    assert crilayla.decompress_batch(blobs, device="cpu") == datas
    assert crilayla.compress_batch([], device="cpu") == []
    assert crilayla.decompress_batch([], device="cpu") == []


def _first_error(fn, items):
    for x in items:
        try:
            fn(x)
        except ValueError as exc:
            return str(exc)
    return None


@pytest.mark.parametrize("case", ["malformed", "bad_magic", "truncated",
                                  "implausible", "malformed_then_magic",
                                  "magic_then_malformed"])
def test_decompress_batch_raises_the_first_members_error(case):
    good = [jax_crilayla.compress(d) for d in _payloads()[:3]]
    # all-ones stream bits: a back-reference past the output's end
    malformed = good[2][:16] + b"\xff" * (len(good[2]) - 16)
    assert _first_error(jax_crilayla.decompress, [bytes(malformed)])
    bad = {
        "malformed": [bytes(malformed)],
        "bad_magic": [b"NOTLAYLA" + good[0][8:]],
        "truncated": [good[0][:-10]],
        "implausible": [good[0][:8] + (1 << 31).to_bytes(4, "little")
                        + good[0][12:]],
        "malformed_then_magic": [bytes(malformed), b"x" * 40],
        "magic_then_malformed": [b"x" * 40, bytes(malformed)],
    }[case]
    blobs = good[:1] + bad + good[1:]
    want = _first_error(jax_crilayla.decompress, blobs)
    assert want == _first_error(
        lambda b: crilayla.decompress(b, device="cpu"), blobs)
    with pytest.raises(ValueError) as exc:
        crilayla.decompress_batch(blobs, device="cpu")
    assert str(exc.value) == want
    parsed = []
    for b in blobs:
        try:
            parsed.append(crilayla.parse(b))
        except ValueError:
            break
    outs = crilayla.decompress_members(parsed, device="cpu")
    assert [o is None for o in outs] == [
        _first_error(jax_crilayla.decompress, [b]) is not None
        for b in blobs[:len(parsed)]]


def test_compress_batch_raises_the_first_refusal():
    datas = [b"a" * 300, b"tiny", b"b" * 400]
    assert crilayla.compress_members(datas, device="cpu")[1] is None
    with pytest.raises(ValueError, match="more than 256 bytes"):
        crilayla.compress_batch(datas, device="cpu")


@pytest.mark.parametrize("budget", [None, 1, 710])
def test_compress_members_calls_c2_per_budget(monkeypatch, budget):
    """compress_members makes one wrapper call for each run of members in
    order whose bytes stay within C2_BUDGET (all of them by default, each
    alone at a budget of 1, a member larger than the budget alone), and
    its blobs are the same at every budget."""
    datas = [b"a" * 300, b"tiny", b"b" * 400, b"c" * 900, b"d" * 290]
    want = [crilayla._compress_py(d) if len(d) > 0x100 else None
            for d in datas]
    if budget is not None:
        monkeypatch.setattr(crilayla, "C2_BUDGET", budget)
    calls = []
    call = crilayla._compress_call

    def counted(group, device):
        calls.append([len(d) for d in group])
        return call(group, device)

    monkeypatch.setattr(crilayla, "_compress_call", counted)
    assert crilayla.compress_members(datas, device="cpu") == want
    assert calls == {None: [[300, 4, 400, 900, 290]],
                     1: [[300], [4], [400], [900], [290]],
                     710: [[300, 4, 400], [900], [290]]}[budget]
    assert crilayla.compress_members([], device="cpu") == []


# -- the kernels' layouts, the plain versions per member, the wrappers' checks --------

def test_plain_versions_fill_the_kernels_outputs():
    """pack_compress / pack_decompress lay the members out where C2 and C1
    read and write them, and the CPU's members functions give each
    member's plain bytes (None where C2 refuses it)."""
    datas = _payloads()[:3] + [b"tiny"]
    src, meta, work_size = crilayla.pack_compress(datas)
    caps = CK.crilayla_work_cap(meta[:, 1])
    assert work_size == int(caps.sum())
    assert meta[:, 2].tolist() == [0] + np.cumsum(caps)[:-1].tolist()
    for m, data in enumerate(datas):
        assert src[meta[m, 0]:meta[m, 0] + meta[m, 1]].tobytes() == data
    blobs = crilayla.compress_members(datas, device="cpu")
    assert blobs == [crilayla._compress_py(d) for d in datas[:3]] + [None]
    for blob, cap in zip(blobs[:3], caps):
        assert len(blob[16:-0x100]) % 4 == cap % 4
        assert len(blob[16:-0x100]) <= cap
    parsed = [crilayla.parse(jax_crilayla.compress(d)) for d in datas[:3]]
    dsrc, dmeta, out_size = crilayla.pack_decompress(parsed)
    assert out_size == sum(ds + 256 for _, _, ds in parsed)
    for m, (payload, cs, ds) in enumerate(parsed):
        off = dmeta[m, 0]
        assert dsrc[off:off + cs + 256].tobytes() == payload[:cs + 256]
        assert dmeta[m, 1:3].tolist() == [cs, ds]
    assert dmeta[:, 3].tolist() == [0] + np.cumsum(
        [ds + 256 for _, _, ds in parsed])[:-1].tolist()
    assert crilayla.decompress_members(parsed, device="cpu") == datas[:3]


@pytest.mark.parametrize("which", ["tiles", "chunks"])
def test_part_tables_cover_every_member(which):
    """C2's tiles (positions 0x100 .. len in TILE steps; none at 0x100 bytes
    or fewer) and C1's chunks (the stream's 8 cs bits in CHUNK_BITS steps):
    each member's parts in order, starting at its first part."""
    sizes = np.array([0, 1, 0x100, 0x101, TILE + 0x100, TILE + 0x101,
                      CHUNK_BITS // 8, CHUNK_BITS // 8 + 1, 3 * TILE])
    if which == "tiles":
        first, table = CK.crilayla_tiles(sizes)
        want = [max(0, -(-(n - 0x100) // TILE)) for n in sizes]
    else:
        first, table = CK.crilayla_chunks(sizes)
        want = [-(-8 * n // CHUNK_BITS) for n in sizes]
    assert table.dtype == np.int32 and first.dtype == np.int64
    assert table.shape == (sum(want), 2)
    for m, count in enumerate(want):
        rows = table[first[m]:first[m] + count]
        assert rows[:, 0].tolist() == [m] * count
        assert rows[:, 1].tolist() == list(range(count))


def test_wrappers_refuse_cpu_tensors_and_bad_tables():
    src, meta, work_size = crilayla.pack_compress([b"a" * 300])
    with pytest.raises(ValueError, match="CUDA tensor"):
        CK.crilayla_compress(torch.from_numpy(src), meta, work_size)
    parsed = [crilayla.parse(jax_crilayla.compress(b"a" * 300))]
    dsrc, dmeta, out_size = crilayla.pack_decompress(parsed)
    with pytest.raises(ValueError, match="CUDA tensor"):
        CK.crilayla_decompress(torch.from_numpy(dsrc), dmeta, out_size)
    with pytest.raises(ValueError, match="past the output"):
        CK.check_crilayla_meta(dsrc.size, dmeta, (dmeta[:, 1] + 256,
                                                  dmeta[:, 2] + 256),
                               out_size - 1)
    with pytest.raises(ValueError, match="past the source"):
        CK.check_crilayla_meta(src.size - 1, meta, (
            meta[:, 1], CK.crilayla_work_cap(meta[:, 1])), work_size)
    with pytest.raises(ValueError, match="negative"):
        CK.check_crilayla_meta(src.size, -meta, (
            meta[:, 1], CK.crilayla_work_cap(meta[:, 1])), work_size)
    with pytest.raises(ValueError, match="int64 table"):
        CK.check_crilayla_meta(src.size, meta.astype(np.int32), (
            meta[:, 1], CK.crilayla_work_cap(meta[:, 1])), work_size)
