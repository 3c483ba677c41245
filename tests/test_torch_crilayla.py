"""PyTorch port, CRILAYLA (pycricodecs_tpu_torch/models/crilayla.py and
kernels C1 / C2 in csrc/crilayla.cu): the plain versions against the JAX
package's native core, `_decompress_py` in linear time on the 540,066-byte
member, numpy models of C1's warp copy and C2's parallel search and packed
key reduction (the kernels' designs, run here) against the plain versions,
and the batch functions against the single ones, errors included. On the
CPU every call runs the plain versions; the card's check is chip_smoke.py's
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
# the kernel's geometry (csrc/crilayla.cu)
THREADS = 1024
WINDOW = 0x2000
PER_THREAD = WINDOW // THREADS


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


# -- C1: the warp's piece copy ----------------------------------------------------

def c1_model(payload: bytes, cs: int, ds: int):
    """C1 as the kernel runs it: the bit reader of every lane, a literal
    by lane 0, a back-reference copied in pieces of at most
    min(distance, 32) bytes, each piece read by its lanes before any of
    them writes. Returns the output bytes, or None (status 1)."""
    src = np.frombuffer(payload, np.uint8)
    out = np.zeros(ds + 256, np.uint8)
    out[:256] = src[cs:cs + 256]
    state = dict(pos=cs - 1, acc=0, count=0, under=False)

    def get(n):
        while state["count"] < n:
            b = 0
            if state["pos"] < 0:
                state["under"] = True
            else:
                b = int(src[state["pos"]])
                state["pos"] -= 1
            state["acc"] = ((state["acc"] << 8) | b) & 0xFFFFFFFF
            state["count"] += 8
        v = (state["acc"] >> (state["count"] - n)) & ((1 << n) - 1)
        state["count"] -= n
        return v

    end, w = ds + 256, ds + 255
    while w >= 256:
        if state["under"]:
            return None
        if get(1) == 0:
            out[w] = get(8)
            w -= 1
            continue
        offset = get(13)
        length = get(2)
        if length == 3:
            length += get(3)
            if length == 10:
                length += get(5)
                if length == 41:
                    while True:
                        b = get(8)
                        length += b
                        if b != 255:
                            break
        r = w + offset + 3
        if r >= end:
            return None
        dist, left = offset + 3, length + 3
        while left > 0 and w >= 256:
            piece = min(left, dist, 32, w - 255)
            lanes = np.arange(piece)
            values = out[r - lanes].copy()            # every lane reads ...
            out[w - lanes] = values                   # ... then writes
            w, r, left = w - piece, r - piece, left - piece
    return None if state["under"] else out.tobytes()


@pytest.mark.parametrize("i", range(5))
def test_c1_model_equals_the_plain_version(i):
    data = _payloads()[i]
    blob = jax_crilayla.compress(data)
    payload, cs, ds = crilayla.parse(blob)
    assert c1_model(payload, cs, ds) == crilayla._decompress_py(
        payload, cs, ds) == data


def test_c1_model_flags_malformed_streams_as_the_plain_version():
    blob = bytearray(jax_crilayla.compress(b"abcdefgh" * 200))
    rng = np.random.default_rng(9)
    flagged = 0
    for _ in range(40):
        bad = bytearray(blob)
        for _ in range(3):
            bad[16 + int(rng.integers(0, 40))] ^= int(rng.integers(1, 256))
        payload, cs, ds = crilayla.parse(bytes(bad))
        try:
            want = crilayla._decompress_py(payload, cs, ds)
        except ValueError:
            want = None
        assert c1_model(payload, cs, ds) == want
        flagged += want is None
    assert flagged > 0


# -- C2: the parallel search and the packed-key reduction -------------------------

def c2_model(data: bytes, trace: list = None):
    """C2 as the kernel runs it: per greedy step, candidate i = n + 3 + t +
    u * 1024 for thread t and slot u; a thread extends a match only where
    the first byte agrees; key (k << 13) | (0x1FFF - (i - n - 3)); the max
    over each thread's slots, then over each warp's 32 lanes, then over the
    32 warps; thread 0's bit writer with the native's capacity refusals.
    Returns the blob, or None; `trace` collects (n, length, offset, how
    many candidates share the longest length)."""
    src = np.frombuffer(data, np.uint8)
    L = len(data)
    if L < 0x101:
        return None
    cap = CK.crilayla_work_cap(L)
    work = bytearray(cap)
    st = dict(m=cap - 1, d=0, T=0)

    def flush():
        while st["T"] >= 8:
            if st["m"] < 0:
                return False
            work[st["m"]] = (st["d"] >> (st["T"] - 8)) & 0xFF
            st["m"] -= 1
            st["T"] -= 8
            st["d"] &= (1 << st["T"]) - 1
        return True

    n = L - 1
    slots = (np.arange(THREADS)[None, :]
             + np.arange(PER_THREAD)[:, None] * THREADS)   # [u, t]
    while n >= 0x100:
        j = min(n + 3 + WINDOW, L)
        kmax = n - 0x100
        cand = n + 3 + slots
        valid = cand < j
        k = np.zeros(cand.shape, np.int64)
        alive = valid & (src[np.minimum(cand, L - 1)] == src[n])
        depth = 0
        while alive.any():
            k[alive] += 1
            depth += 1
            if depth > kmax:
                break
            alive &= src[np.clip(cand - depth, 0, L - 1)] == src[n - depth]
        keys = np.where(k > 0, (k.astype(np.uint64) << np.uint64(13))
                        | (0x1FFF - (cand - n - 3)).astype(np.uint64),
                        np.uint64(0))
        per_thread = keys.max(axis=0)                       # [1024]
        per_warp = per_thread.reshape(32, 32).max(axis=1)   # [32]
        best = int(per_warp.max())
        blen, boff = best >> 13, 0x1FFF - (best & 0x1FFF)
        if trace is not None:
            trace.append((n, blen, boff, int((k == blen).sum())))
        if blen < 3:
            st["d"] = (st["d"] << 9) | int(src[n])
            st["T"] += 9
        else:
            st["d"] = (((st["d"] << 1) | 1) << 13) | boff
            st["T"] += 14
            p = blen
            if p < 6:
                st["d"] = (st["d"] << 2) | (p - 3)
                st["T"] += 2
            elif p < 13:
                st["d"] = (((st["d"] << 2) | 3) << 3) | (p - 6)
                st["T"] += 5
            elif p < 44:
                st["d"] = (((st["d"] << 5) | 0x1F) << 5) | (p - 13)
                st["T"] += 10
            else:
                st["d"] = (st["d"] << 10) | 0x3FF
                st["T"] += 10
                p -= 44
                while True:
                    if not flush():
                        return None
                    if p < 255:
                        break
                    st["d"] = (st["d"] << 8) | 0xFF
                    st["T"] += 8
                    p -= 0xFF
                st["d"] = (st["d"] << 8) | p
                st["T"] += 8
        if not flush():
            return None
        n -= 1 if blen < 3 else blen
    m = st["m"]
    if st["T"]:
        if m < 0:
            return None
        work[m] = (st["d"] << (8 - st["T"])) & 0xFF
        m -= 1
    if m < 2:
        return None
    work[m] = 0
    m -= 1
    work[m] = 0
    while (cap - m) & 3:
        if m < 1:
            return None
        m -= 1
        work[m] = 0
    stream = bytes(work[m:])
    return (crilayla.MAGIC + (L - 0x100).to_bytes(4, "little")
            + len(stream).to_bytes(4, "little") + stream + data[:0x100])


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
