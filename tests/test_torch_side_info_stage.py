"""PyTorch port, kernel B1's warp design on the CPU.

B1 (pycricodecs_tpu_torch/csrc/hca_unpack.cu, hca_side_info_kernel) runs
one warp of up to 32 frames per CTA. Each frame's row holds the 16-byte
chunks from the boundary below its start that cover the bytes its side
info can reach (`DeviceUnpacker.side_info_max_bits`; the whole frame
when that exceeds it, and then every read tests the frame end), copied
whole where they lie inside `dec` and byte by byte, zeros outside, where
they do not. A lane reads its frame through B2's 64-bit bit buffer hi:lo
on the staged words turned big-endian as they are loaded, topped up after
every second symbol. Per channel the lane's scalefactor mode sets one width (6
absolute, db delta, 0 none), a delta code of all ones escapes to a 6-bit
value, and the loop over cs is the warp's; the lane writes its
scalefactors into a shared row of 132 bytes. Then the warp shares the
resolutions out: lane j takes bands 4j..4j+3 of each frame, with the
frame's noise level shuffled from the frame's lane, a 68-entry table of
the clamped resolutions and two byte masks, and stores whole 128-byte
lines. The five outputs are parts of one buffer
(`DeviceUnpacker.side_info_layout`).

A numpy model of exactly that arithmetic (u32 words, the CUDA funnel
shift) is held to the twin `side_info_plain`, to the JAX package's
DeviceUnpacker (its side-info phases, bit-exact with its Pallas kernel)
and to hca_frame._unpack_frames_py, on every HCA fixture, on random
frames, on key-search rows deciphered with wrong keys and on frames built
to hit each scalefactor mode, escapes at the frame end and the intensity
branches.

Tolerance: exact. err is compared on every row; sf, res, inten and the
cursor on the rows without err (the host reference raises on those).
"""
import dataclasses
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pycricodecs_tpu.ops import hca_frame as jax_frame
from pycricodecs_tpu.ops import hca_unpack_device as jax_unpack
from pycricodecs_tpu_torch.ops import hca_frame as port_frame
from pycricodecs_tpu_torch.ops import hca_tables as T
from pycricodecs_tpu_torch.ops import hca_unpack_device as U
from pycricodecs_tpu_torch.parallel import pipeline as P
from pycricodecs_tpu_torch.utils.crc import crc16
from tests import torch_port_helpers as H

M32 = 0xFFFFFFFF
LANES = 32
SF_STRIDE = 132
SMEM_MAX = 227 * 1024 - 1024
SECONDARY = 2
V200 = 0x0200
SOURCE = os.path.join(os.path.dirname(U.__file__), os.pardir, "csrc",
                      "hca_unpack.cu")


# -- the model --------------------------------------------------------------

def max_bits(up) -> int:
    """The most bits a frame's side info can take, counted symbol by
    symbol (the port's DeviceUnpacker.side_info_max_bits)."""
    bits = 32
    for c in range(up.C):
        bits += 9 + 11 * max(up.cs_counts[c] - 1, 0)
        if up.ctype[c] == SECONDARY:
            bits += 32 if up.version <= V200 else 55
        elif up.version <= V200:
            bits += 6 * max(up.hfr, 0)
    return bits


def geometry(up) -> dict:
    """b1_geometry of the kernel, at the bytes the host stages."""
    mb = max_bits(up)
    checked = mb > 8 * up.fs
    nbytes = up.fs if checked else (mb + 7) >> 3
    chunks = (15 + nbytes + 15) >> 4
    frames = LANES
    while frames > 1 and frames * (16 * chunks + SF_STRIDE) > SMEM_MAX:
        frames -= 1
    return dict(frames=frames, chunks=chunks, checked=checked)


def fsl(lo, hi, sh):
    """__funnelshift_l: the top 32 bits of (hi:lo) << (sh & 31)."""
    sh = np.asarray(sh) & 31
    return ((hi << sh) | (lo >> (32 - sh))) & M32


def stage(mem: np.ndarray, addr: int, N: int, fs: int, chunks: int):
    """Every frame's staged row, u8 [N, 16 * chunks]: chunk i of frame n
    is the 16 bytes at ((addr + n fs) & ~15) + 16 i of `mem`, copied whole
    when they lie inside dec = [addr, addr + N fs), else byte by byte with
    zeros outside dec."""
    a = ((addr + np.arange(N) * fs) & ~15)[:, None]
    q = a + np.arange(16 * chunks)[None, :]
    inside = (q >= addr) & (q < addr + N * fs)
    whole = inside.reshape(N, chunks, 16).all(-1).repeat(16, axis=1)
    byte = np.where(inside, mem[np.clip(q, 0, len(mem) - 1)], 0)
    return np.where(whole, mem[np.clip(q, 0, len(mem) - 1)], byte) \
        .astype(np.uint8)


class Lanes:
    """The lanes' bit buffers, numpy int64 per value, over every frame at
    once (each lane of a warp walks the same symbol loop)."""

    def __init__(self, rows: np.ndarray, base: np.ndarray, fs: int,
                 checked: bool):
        self.le = rows.view("<u4").astype(np.int64)   # memory order
        self.wl = self.le.shape[1] - 1
        self.ix = np.arange(rows.shape[0])
        self.nbits = 8 * fs
        self.checked = checked
        w0 = np.minimum(base >> 5, self.wl)
        sh = base & 31
        x1 = self.be(np.minimum(w0 + 1, self.wl))
        self.hi = fsl(x1, self.be(w0), sh)
        self.lo = (x1 << sh) & M32
        self.nbuf = 64 - sh
        self.widx = np.minimum(w0 + 2, self.wl)
        self.next = self.be(self.widx)
        # frame bytes 2-3, then past the 32-bit header
        self.packed_noise = (((self.hi >> 7) & 0x1FF) << 8) \
            - (self.hi & 0x7F)
        self.hi, self.lo = self.lo, np.zeros_like(self.lo)
        self.nbuf = self.nbuf - 32
        self.cur = np.full(rows.shape[0], 32, np.int64)

    def be(self, w):
        x = self.le[self.ix, w]
        return (((x & 0xFF) << 24) | ((x & 0xFF00) << 8)
                | ((x >> 8) & 0xFF00) | (x >> 24))

    def peek(self, count):
        assert (self.nbuf >= count).all()
        raw = fsl(self.hi, 0, count)     # hi >> (32 - count), 0 at count 0
        if not self.checked:
            return raw
        return np.where(self.cur + count <= self.nbits, raw, 0)

    def peek_after(self, skip, count):
        assert (self.nbuf >= skip + count).all()
        x = fsl(self.lo, self.hi, skip) >> (32 - count)
        if not self.checked:
            return x
        return np.where(self.cur + skip + count <= self.nbits, x, 0)

    def consume(self, n):
        assert (self.nbuf >= n).all()
        self.hi = fsl(self.lo, self.hi, n)
        self.lo = (self.lo << n) & M32
        self.nbuf = self.nbuf - n
        self.cur = self.cur + n

    def refill(self):
        assert (self.nbuf >= 1).all()
        low = self.nbuf < 32
        nb = np.where(low, self.nbuf, 1)
        self.hi = np.where(low, self.hi | (self.next >> nb), self.hi)
        self.lo = np.where(low, (self.next << (32 - nb)) & M32, self.lo)
        self.nbuf = np.where(low, self.nbuf + 32, self.nbuf)
        self.widx = np.where(low, np.minimum(self.widx + 1, self.wl),
                             self.widx)
        self.next = np.where(low, self.be(self.widx), self.next)


def sf_symbol(b: Lanes, w, expected, keep, half, value, err):
    """sf_symbol of the kernel: one branch-free scalefactor symbol."""
    d = b.peek(w)
    esc = d == expected
    vesc = b.peek_after(w, 6)
    test = (value & keep) + d - half
    err = err | (~esc & ((test < 0) | (test >= 64)))
    value = np.where(esc, vesc, test & 0x3F)
    b.consume(np.where(esc, w + 6, w))
    return value, err


def model_side_info(up, dec: np.ndarray, addr: int = 0, seed: int = 0):
    """The kernel on dec u8 [N, fs], placed at byte address `addr` of a
    memory of random bytes; returns the five outputs as the wrapper's
    views of one buffer."""
    rng = np.random.default_rng(seed)
    N, fs, C = dec.shape[0], up.fs, up.C
    g = geometry(up)
    mem = rng.integers(0, 256, addr + N * fs + 16 * g["chunks"] + 32,
                       dtype=np.uint8)
    mem[addr:addr + N * fs] = dec.reshape(-1)
    rows = stage(mem, addr, N, fs, g["chunks"])
    base = 8 * ((addr + np.arange(N) * fs) & 15)
    b = Lanes(rows, base, fs, g["checked"])
    err = np.zeros(N, bool)
    offsets = up.side_info_layout(N)
    out = rng.integers(0, 256, offsets[-1], dtype=np.uint8)   # torch.empty
    o_sf, o_res, o_in, o_cur, o_err, _ = offsets
    # the warp's per-CTA state: the resolution of curve positions -1..66
    # (clamped; every position below or above reads an end), each lane's
    # four ATH bands + 1
    tab = np.clip(np.concatenate([[15], T.INVERT_TABLE.astype(np.int64),
                                  [0]]), up.min_res, up.max_res)
    ath1 = up.ath.astype(np.int64).reshape(LANES, 4) + 1      # [lane, j]
    n_cta = -(-N // g["frames"])
    for c in range(C):
        cs, extra = up.cs_counts[c], up.extras[c]
        row = np.zeros((N, SF_STRIDE), np.uint8)     # zeroed each channel
        b.refill()
        db = b.peek(3)
        b.consume(3)
        is_abs, is_delta = db >= 6, (db >= 1) & (db <= 5)
        first = is_delta | (is_abs & (cs > 0))
        value = np.where(first, b.peek(6), 0)
        b.consume(np.where(first, 6, 0))
        row[:, 0] = value
        b.refill()
        w = np.where(is_abs, 6, np.where(is_delta, db, 0))
        expected = np.where(is_delta, (1 << db) - 1, -1)
        keep = np.where(is_delta, -1, 0)
        half = np.where(is_delta, ((1 << db) - 1) >> 1, 0)
        i = 1
        while i + 1 < cs:
            for j in (i, i + 1):
                value, err = sf_symbol(b, w, expected, keep, half, value,
                                       err)
                row[:, j] = value
            b.refill()
            i += 2
        if i < cs:
            value, err = sf_symbol(b, w, expected, keep, half, value, err)
            row[:, i] = value
        for i in range(extra):
            row[:, 127 - i] = row[:, cs - i]
        b.refill()
        inten = np.zeros((N, 8), np.int64)
        if up.ctype[c] == SECONDARY:
            v4 = b.peek(4)
            flag = v4 < 15
            if up.version <= V200:
                step = np.where(flag, 4, 0)
                b.consume(step)
                inten[:, 0] = v4
                for kk in range(1, 8):
                    inten[:, kk] = b.peek(step)
                    b.consume(step)
                    if kk == 3:
                        b.refill()
            else:
                b.consume(4)
                db2 = b.peek(2)
                b.consume(np.where(flag, 2, 0))
                b.refill()
                direct, delta = flag & (db2 == 3), flag & (db2 < 3)
                nb = np.where(delta, db2 + 1, 0)
                bmax = (2 << db2) - 1
                w3 = np.where(direct, 4, nb)
                expect3 = np.where(delta, bmax, -1)
                value3 = v4
                inten[:, 0] = np.where(flag, v4, 7)
                for kk in range(1, 8):
                    d = b.peek(w3)
                    esc = d == expect3
                    vesc = b.peek_after(w3, 4)
                    vnew = np.where(esc, vesc, value3 - (bmax >> 1) + d)
                    err = err | (delta & ((vnew > 15) | (vnew < 0)))
                    value3 = np.where(delta, vnew, value3)
                    inten[:, kk] = np.where(
                        direct, d, np.where(delta, value3, 7)) & 0xFF
                    b.consume(np.where(esc, w3 + 4, w3))
                    if kk == 4:
                        b.refill()
        elif up.version <= V200 and up.hfr > 0:
            for i in range(up.hfr):
                row[:, 128 - up.hfr + i] = b.peek(6)
                b.consume(6)
                if i & 1:
                    b.refill()
        idx = (np.arange(N) * C + c) * 8
        out[o_in + idx[:, None] + np.arange(8)] = inten
        # the warp's resolution pass, CTA by CTA: lane j, bands 4j..4j+3
        coded = up.coded[c]
        coded4 = (4 * np.arange(LANES)[:, None] + np.arange(4)) < coded
        lane = np.arange(LANES)
        for cta in range(n_cta):
            f0 = cta * g["frames"]
            here = min(g["frames"], N - f0)
            pn_lanes = b.packed_noise[f0:f0 + here]   # lane r's value
            for r in range(here):
                pn = pn_lanes[r] + 4 * lane            # the shuffle
                s = row[f0 + r, :128].reshape(LANES, 4).astype(np.int64)
                pos = ath1 + ((pn[:, None] + np.arange(4)) >> 8) \
                    - ((5 * s) >> 1)
                res = tab[np.clip(pos, -1, 66) + 1]
                res = np.where((s != 0) & coded4, res, 0)
                o = ((f0 + r) * C + c) * 128
                out[o_sf + o:o_sf + o + 128] = s.reshape(-1)
                out[o_res + o:o_res + o + 128] = res.reshape(-1)
    out[o_cur:o_cur + 4 * N] = b.cur.astype("<i4").view(np.uint8)
    out[o_err:o_err + N] = err
    return up.side_info_views(torch.from_numpy(out), N, offsets)


# -- the references ---------------------------------------------------------

def jax_side_info(ji, dec: np.ndarray):
    """The JAX DeviceUnpacker's side-info phases on dec (as its _unpack
    runs them off the TPU): sf, res, inten, cur, err as numpy."""
    u = jax_unpack.DeviceUnpacker(ji)
    N = dec.shape[0]

    def f(d):
        pad = jnp.zeros((N, u.wn * 4 - u.fs), jnp.uint8)
        le = jax.lax.bitcast_convert_type(
            jnp.concatenate([d, pad], 1).reshape(N, u.wn, 4), jnp.uint32)
        wa = ((le << 24) | ((le & jnp.uint32(0xFF00)) << 8)
              | ((le >> 8) & jnp.uint32(0xFF00)) | (le >> 24))
        anl = (d[:, 2].astype(jnp.int32) << 1) | (d[:, 3].astype(jnp.int32)
                                                  >> 7)
        packed_noise = (anl << 8) - (d[:, 3].astype(jnp.int32) & 0x7F)
        cur = jnp.full((N,), 32, jnp.int32)
        err = jnp.zeros((N,), bool)
        sf_ch, in_ch = [], []
        for c in range(u.C):
            sf_c, cur, err = u._scalefactors_channel(wa, cur, err, c)
            in_c, sf_c, cur, err = u._intensity_channel(wa, cur, err, c,
                                                        sf_c)
            sf_ch.append(sf_c)
            in_ch.append(in_c)
        sf = jnp.stack(sf_ch, 1)
        res = u._resolutions(sf, packed_noise, jnp.asarray(u.ath))
        return sf, res, jnp.stack(in_ch, 1), cur, err
    return [np.asarray(x) for x in jax.jit(f)(jnp.asarray(dec))]


def assert_side_info_equal(what, got, want) -> None:
    """err on every row, the other outputs on the rows without err."""
    got = [np.asarray(x) for x in got]
    want = [np.asarray(x) for x in want]
    np.testing.assert_array_equal(got[4], want[4], err_msg=f"{what}: err")
    ok = ~want[4].astype(bool)
    for name, a, b in zip(("sf", "res", "inten", "cur"), got[:4], want[:4]):
        np.testing.assert_array_equal(
            a[ok].astype(np.int64), b[ok].astype(np.int64),
            err_msg=f"{what}: {name}")


def port_info(ji):
    return port_frame.HcaInfo.from_arrays(dataclasses.asdict(ji))


def check_all(what, ji, dec, addr=0, jax_too=True, host=False):
    """Model against the twin, the JAX side-info phases and (frames with
    sync and CRC, no err) the host reference."""
    up = U.DeviceUnpacker(port_info(ji), device="cpu")
    got = model_side_info(up, dec, addr)
    twin = up.side_info_plain(torch.from_numpy(dec))
    assert_side_info_equal(f"{what} vs the twin", got, twin)
    if jax_too:
        assert_side_info_equal(f"{what} vs JAX", got, jax_side_info(ji, dec))
    if host:
        assert not got[4].any()
        ref = jax_frame._unpack_frames_py(ji, dec.tobytes())
        np.testing.assert_array_equal(got[0].numpy(), ref.scalefactors)
        np.testing.assert_array_equal(got[1].numpy(), ref.resolutions)
        np.testing.assert_array_equal(got[2].numpy(), ref.intensity)
    return got


# -- the configs --------------------------------------------------------------

def fixture_info(name):
    blob = H.load_fixtures()[1][name]
    return H.parse_both(blob)[0]


def relabel(name, version=None, frame_size=None, coded=None):
    ji = fixture_info(name)
    if version is not None:
        ji.version = version
        ji.init_derived()
    if frame_size is not None:
        ji.frame_size = frame_size
    if coded is not None:
        ji.coded_count = np.asarray(coded, np.int32)
    return ji


CONFIGS = {
    "q2": lambda: fixture_info("bank_q2_stereo_48k_10s"),
    "q4": lambda: fixture_info("q4_stereo_48k_1s"),
    "v3_q4": lambda: relabel("q4_stereo_48k_1s", version=0x0300),
    "6ch": lambda: fixture_info("q2_6ch_48k_1s"),
}


def test_geometry_matches_the_source():
    """The model's constants are the kernel's."""
    src = open(SOURCE).read()
    assert re.search(r"constexpr int kB1Lanes = 32;", src)
    assert re.search(r"constexpr int kSfStride = 132;", src)
    assert re.search(r"constexpr int kB1SmemMax = 227 \* 1024 - 1024;", src)
    assert "b1_geometry(checked ? fs : (max_bits + 7) >> 3)" in src
    up = U.DeviceUnpacker(port_info(CONFIGS["q2"]()), device="cpu")
    # the bank's side info reaches 272 of its 512 bytes: 18 chunks a row
    assert geometry(up) == dict(frames=32, chunks=18, checked=False)
    assert up.side_info_reach == 272
    for make in CONFIGS.values():
        up = U.DeviceUnpacker(port_info(make()), device="cpu")
        assert up.side_info_max_bits() == max_bits(up)
        assert up.side_info_reach == min(up.fs, (max_bits(up) + 7) >> 3)


def test_layout_parts_are_aligned():
    up = U.DeviceUnpacker(port_info(CONFIGS["q4"]()), device="cpu")
    for N in (0, 1, 13, 77):
        offsets = up.side_info_layout(N)
        assert all(o % 16 == 0 for o in offsets[:-1])
        views = up.side_info_views(
            torch.empty(offsets[-1], dtype=torch.uint8), N, offsets)
        assert [tuple(v.shape) for v in views] == [
            (N, 2, 128), (N, 2, 128), (N, 2, 8), (N,), (N,)]
        assert [v.dtype for v in views] == [torch.uint8] * 3 + [
            torch.int32, torch.bool]


@pytest.mark.parametrize("name", sorted(H.load_fixtures()[1]) + [
    "zero_coded"])
def test_fixture_frames(name):
    if name == "zero_coded":
        with open(os.path.join(H.FIXTURE_DIR, "keysearch",
                               "zero_coded_v2_stereo_48k_1s.hca"), "rb") as f:
            blob = f.read()
    else:
        blob = H.load_fixtures()[1][name]
    ji, pi = H.parse_both(blob)
    assert ji.ciph_type == 0            # the host reference deciphers too
    frames = H.frames_of(blob, pi)
    dec = np.ascontiguousarray(pi.cipher[frames])
    # JAX's device unpacker refuses a zero coded_count (the host takes it)
    check_all(name, ji, dec, addr=5, jax_too=name != "zero_coded",
              host=True)


@pytest.mark.parametrize("fs", [512, 515])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_random_frames(name, fs):
    """Random bytes behind a sync word, 2 whole warps + 13 frames."""
    ji = CONFIGS[name]()
    ji.frame_size = fs
    rng = np.random.default_rng(fs + len(name))
    dec = rng.integers(0, 256, (2 * LANES + 13, fs), dtype=np.uint8)
    dec[:, :2] = 0xFF
    dec[:4] = 0
    for addr in (0, 7):
        got = check_all(f"{name} fs {fs} at {addr}", ji, dec, addr,
                        jax_too=fs == 512 and addr == 0)
        assert 0 < int(got[4].sum()) < dec.shape[0]


def test_key_search_rows():
    """512 (key, frame) rows as find_key's phase 1 makes them: the
    enciphered bank stream's first two frames under 256 wrong keys."""
    with open(os.path.join(H.FIXTURE_DIR, "keysearch",
                           "expected.json")) as f:
        spec = json.load(f)["find_key"]
    plain = H.load_fixtures()[1][spec["stream"]]
    hs = H.header_size(plain)
    from pycricodecs_tpu_torch import crypt
    enc = crypt(plain, True, hs, spec["cipher"], spec["key"])
    keys = np.random.default_rng(spec["seed"]).integers(
        1, 1 << 63, 256).astype(np.uint64)
    ji, pi = H.parse_both(enc)
    up = U.DeviceUnpacker(pi, device="cpu")
    tables, tix = P._key_tables(pi, keys, 0, "cpu")
    first = torch.from_numpy(np.frombuffer(enc, np.uint8, count=2 * pi.
                                           frame_size, offset=hs).copy())
    rows = first.view(1, 2, -1).expand(len(keys), 2, -1).reshape(
        -1, pi.frame_size)
    dec = up.decipher(rows, tables, tix.repeat_interleave(2)).numpy()
    ji.cipher = np.arange(256, dtype=np.uint8)
    got = check_all("key rows", ji, np.ascontiguousarray(dec), addr=9)
    assert 100 < int(got[4].sum()) < 500


# -- frames built bit by bit --------------------------------------------------

class Bits:
    """MSB-first bit writer of one frame: sync, noise level, side info;
    zeros after it and a CRC16 in the last two bytes."""

    def __init__(self, rng):
        self.bits = []
        self.put(0xFFFF, 16)
        self.put(int(rng.integers(0, 512)), 9)
        self.put(int(rng.integers(0, 128)), 7)

    def put(self, v: int, n: int) -> None:
        self.bits += [(v >> (n - 1 - i)) & 1 for i in range(n)]

    def frame(self, fs: int, crc: bool = True) -> np.ndarray:
        bits = (self.bits + [0] * (8 * fs))[:8 * fs]
        out = np.packbits(np.array(bits, np.uint8))
        if crc:
            assert len(self.bits) <= 8 * (fs - 2)
            c = crc16(out[:-2].tobytes())
            out[-2:] = (c >> 8, c & 0xFF)
        return out


def put_scalefactors(bw: Bits, rng, db: int, cs: int) -> None:
    """One channel's scalefactors in mode db with values the decoder takes
    without error; delta runs escape where a step is too large."""
    bw.put(db, 3)
    if db == 0 or (db >= 6 and cs == 0):
        return
    if db >= 6:
        for _ in range(cs):
            bw.put(int(rng.integers(0, 64)), 6)
        return
    half = ((1 << db) - 1) >> 1
    value = int(rng.integers(0, 64))
    bw.put(value, 6)
    for _ in range(1, cs):
        if rng.random() < 0.2:
            value = int(rng.integers(0, 64))
            bw.put((1 << db) - 1, db)
            bw.put(value, 6)
            continue
        lo, hi = max(-half, -value), min(half, 63 - value)
        step = int(rng.integers(lo, hi + 1))
        bw.put(half + step, db)
        value += step


@pytest.mark.parametrize("cs", ["0", "1", "full"])
def test_every_scalefactor_mode(cs):
    """db 0-7 in channel 0 at cs 0, 1 and the full count, v2 intensities
    (one at 15) in channel 1, and the v2 HFR scales."""
    ji = fixture_info("q4_stereo_48k_1s")       # v2, coded 64/32, hfr 8
    if cs != "full":
        ji.coded_count = np.array([int(cs), int(cs)], np.int32)
    coded = [int(x) for x in ji.coded_count]
    rng = np.random.default_rng(len(cs))
    frames = []
    for db in range(8):
        for v4 in (int(rng.integers(0, 15)), 15):
            bw = Bits(rng)
            put_scalefactors(bw, rng, db, coded[0])
            for _ in range(ji.hfr_group_count):
                bw.put(int(rng.integers(0, 64)), 6)
            put_scalefactors(bw, rng, int(rng.integers(0, 8)), coded[1])
            bw.put(v4, 4)
            for _ in range(7):
                bw.put(int(rng.integers(0, 16)), 4)
            frames.append(bw.frame(ji.frame_size))
    dec = np.stack(frames)
    got = check_all(f"modes at cs {cs}", ji, dec, addr=3,
                    jax_too=cs != "0", host=True)
    assert (got[2][1::2, 1, 0] == 15).all()       # v2 intensity 15 kept


@pytest.mark.parametrize("db2", [0, 1, 2, 3])
def test_v3_intensity(db2):
    """The v3 intensity branches of a relabelled q4 stereo config: db2 0-3
    with escapes, values that leave [0, 15] (err), and v4 = 15 (all 7s)."""
    ji = relabel("q4_stereo_48k_1s", version=0x0300)
    coded = [int(x) for x in ji.coded_count]
    up = U.DeviceUnpacker(port_info(ji), device="cpu")
    rng = np.random.default_rng(db2)
    frames, bad = [], []
    for case in range(12):
        bw = Bits(rng)
        put_scalefactors(bw, rng, int(rng.integers(0, 8)), up.cs_counts[0])
        put_scalefactors(bw, rng, int(rng.integers(0, 8)), coded[1])
        v4 = 15 if case == 11 else int(rng.integers(0, 15))
        bw.put(v4, 4)
        bw.put(db2, 2)
        value, flagged = v4, False
        for _ in range(7):
            if db2 == 3:
                bw.put(int(rng.integers(0, 16)), 4)
                continue
            nb, bmax = db2 + 1, (2 << db2) - 1
            if rng.random() < 0.3:
                value = int(rng.integers(0, 16))
                bw.put(bmax, nb)
                bw.put(value, 4)
                continue
            code = int(rng.integers(0, bmax))
            if case < 8:            # keep the value inside [0, 15]
                lo = max(0, (bmax >> 1) - value)
                hi = min(bmax - 1, 15 - value + (bmax >> 1))
                code = int(rng.integers(lo, hi + 1))
            bw.put(code, nb)
            value += code - (bmax >> 1)
            flagged |= not 0 <= value <= 15
        bw.put(0, 32)
        frames.append(bw.frame(ji.frame_size))
        bad.append(flagged and v4 < 15 and db2 < 3)
    dec = np.stack(frames)
    got = check_all(f"v3 db2 {db2}", ji, dec, addr=11)
    np.testing.assert_array_equal(got[4].numpy(), bad)
    assert (got[2][11, 1] == 7).all()
    ok = ~got[4].numpy()
    ref = jax_frame._unpack_frames_py(ji, dec[ok].tobytes())
    np.testing.assert_array_equal(got[2].numpy()[ok], ref.intensity)
    np.testing.assert_array_equal(got[0].numpy()[ok], ref.scalefactors)


@pytest.mark.parametrize("code_crosses", [False, True])
def test_escape_at_the_frame_end(code_crosses):
    """A 40-byte relabel of q2 mono (coded 56, v2 HFR): its side info can
    pass the frame end (320 bits), so every read tests it. The last delta
    code is an escape: at bit 311 its 6-bit value crosses the end and reads
    0 while the cursor moves on by 11; at bit 317 (one earlier escape) the
    code itself crosses and reads as a delta of 0."""
    ji = relabel("q2_mono_48k_1s", frame_size=40, coded=[56])
    up = U.DeviceUnpacker(port_info(ji), device="cpu")
    assert geometry(up)["checked"]
    rng = np.random.default_rng(int(code_crosses))
    frames = []
    for _ in range(LANES + 5):
        bw = Bits(rng)
        bw.put(5, 3)                            # db 5: 5-bit deltas, half 15
        bw.put(int(rng.integers(20, 40)), 6)
        for i in range(1, 55):
            if code_crosses and i == 1:
                bw.put(31, 5)
                bw.put(int(rng.integers(20, 40)), 6)
            else:
                bw.put(15 + int(rng.integers(-1, 2)), 5)
        assert len(bw.bits) == (317 if code_crosses else 311)
        bw.put(31, 5)                           # the 55th: an escape
        bw.put(int(rng.integers(0, 64)), 6)
        frames.append(bw.frame(40, crc=False))
    got = check_all(f"escape, code crosses {code_crosses}", ji,
                    np.stack(frames), addr=1)
    assert (got[3].numpy() > 320).all()         # the cursor ran past the end
