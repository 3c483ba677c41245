"""PyTorch port, kernel B2's staged read on the CPU.

B2 (pycricodecs_tpu_torch/csrc/hca_unpack.cu, hca_coefficients_kernel) runs
one warp of up to 32 frames per CTA. The warp copies its frames and their
resolution rows into padded shared rows (16-byte copies, or bytes) and
turns the frame words big-endian; a lane reads its frame through a 64-bit
bit buffer hi:lo, topped up after every second symbol with one word
prefetched a top-up ahead, the staged word index clamped into the row and
the cursor never; a code is one funnel shift of hi, 0 as a whole past the
frame end; the prefix-code tables are one packed 16-byte row per
resolution (kVlcPacked, from `hca_unpack_device.vlc_packed`: the width, the
advance as a step base + (code >= thr), the value + 8 in 4 bits per code);
a lane keeps 16 int16 codes and stores them as two 16-byte vectors; the
bands of a 16-band group past coded_count read table row 0, which reads
nothing. A numpy model of exactly that arithmetic (u32 words, the CUDA
funnel-shift intrinsics) is held to `_Bits.peek` at every cursor and
count, and the whole kernel model to the twin `spectra_plain` and to the
JAX package's host unpacker.

Tolerance: exact (equal codes, int16 values and cursors).
"""
import re

import numpy as np
import pytest
import torch

from pycricodecs_tpu.ops import hca_frame as jax_frame
from pycricodecs_tpu_torch import _build
from pycricodecs_tpu_torch.ops import hca_unpack_device as U
from tests import torch_port_helpers as H

M32 = 0xFFFFFFFF
LANES = 32                 # kB2Lanes: one warp, one frame a lane
BUDGET = 48 * 1024 - 256   # kB2SmemBudget: 48 KB less the static table
SMS = 132                  # an H100's streaming multiprocessors
SMEM_PER_SM = 227 * 1024


def geometry(fs: int, C: int) -> dict:
    """b2_geometry of the kernel."""
    frame_stride = ((fs + 15) & ~15) + 16
    res_stride = C * 128 + 16
    per = frame_stride + res_stride
    frames = LANES
    while frames > 1 and frames * per > BUDGET:
        frames -= 1
    return dict(frames=frames, frame_stride=frame_stride,
                res_stride=res_stride, smem=frames * per)


def stage_rows(src: np.ndarray, rows: int, n: int, stride: int,
               fill: np.ndarray) -> np.ndarray:
    """stage_rows of the kernel on one CTA: `rows` rows of n bytes,
    contiguous in src, copied into a shared region of rows * stride bytes
    whose padding holds `fill` (whatever was there); 16-byte chunks
    i -> (row i // q, chunk i % q) when n is a multiple of 16, bytes
    otherwise."""
    dst = fill[:rows * stride].copy()
    if n % 16 == 0:
        q = n // 16
        for i in range(rows * q):
            r, j = divmod(i, q)
            dst[r * stride + 16 * j:r * stride + 16 * j + 16] = \
                src[r * n + 16 * j:r * n + 16 * j + 16]
    else:
        for r in range(rows):
            dst[r * stride:r * stride + n] = src[r * n:(r + 1) * n]
    return dst


def funnelshift_l(lo, hi, sh):
    """__funnelshift_l: the top 32 bits of (hi:lo) << (sh & 31)."""
    sh = sh & 31
    return ((hi << sh) | (lo >> (32 - sh))) & M32


class Reader:
    """Each lane's 64-bit bit buffer, numpy int64 per value (u32 words),
    on the staged row turned big-endian: the kernel's start at cur0 (word
    index min(cur0 >> 5, W), the cursor never clamped), a code (one funnel
    shift of hi, 0 past the frame end), a consume, and the top-up with the
    prefetched word after every second symbol."""

    def __init__(self, rows: np.ndarray, fs: int, cur0: np.ndarray):
        # rows u8 [n, frame_stride]: each frame's staged shared row
        self.words = rows.view(">u4").astype(np.int64)     # big-endian
        self.W = (fs + 3) >> 2
        self.nbits = fs * 8
        self.ix = np.arange(rows.shape[0])
        self.cur = cur0.astype(np.int64)
        w0 = np.minimum(np.maximum(self.cur, 0) >> 5, self.W)
        off = self.cur & 31
        a, b = self.word(w0), self.word(np.minimum(w0 + 1, self.W))
        self.hi = funnelshift_l(b, a, off)
        self.lo = (b << off) & M32
        self.nbuf = 64 - off
        self.widx = np.minimum(w0 + 2, self.W)
        self.next = self.word(self.widx)

    def word(self, w):
        return self.words[self.ix, w]

    def code(self, count):
        raw = funnelshift_l(self.hi, 0, count)      # hi >> (32 - count)
        return np.where(self.cur + count <= self.nbits, raw, 0)

    def consume(self, adv):
        self.cur = self.cur + adv
        self.hi = funnelshift_l(self.lo, self.hi, adv)
        self.lo = (self.lo << adv) & M32
        self.nbuf = self.nbuf - adv

    def refill(self):
        low = self.nbuf < 32
        nb = np.where(low, self.nbuf, 1)
        self.hi = np.where(low, self.hi | (self.next >> nb), self.hi)
        self.lo = np.where(low, (self.next << (32 - nb)) & M32, self.lo)
        self.nbuf = np.where(low, self.nbuf + 32, self.nbuf)
        self.widx = np.where(low, np.minimum(self.widx + 1, self.W),
                             self.widx)
        self.next = np.where(low, self.word(self.widx), self.next)


def staged(dec: np.ndarray, fs: int, C: int, seed: int = 0) -> np.ndarray:
    """Every frame's staged row u8 [n, frame_stride], CTA by CTA, the
    padding random (the kernel never initialises it)."""
    g = geometry(fs, C)
    rng = np.random.default_rng(seed)
    n = dec.shape[0]
    out = np.empty((n, g["frame_stride"]), np.uint8)
    flat = dec.reshape(-1)
    for f0 in range(0, n, g["frames"]):
        here = min(g["frames"], n - f0)
        fill = rng.integers(0, 256, here * g["frame_stride"], dtype=np.uint8)
        region = stage_rows(flat[f0 * fs:(f0 + here) * fs], here, fs,
                            g["frame_stride"], fill)
        out[f0:f0 + here] = region.reshape(here, g["frame_stride"])
    return out


def b2_model(dec: np.ndarray, res: np.ndarray, cur0: np.ndarray,
             coded, store: bool = True):
    """The whole kernel on frames u8 [n, fs], res u8 [n, C, 128], cur0
    [n]: (qc i16 [n, C, 8, 128] or None, end cursor i32 [n])."""
    n, fs = dec.shape
    C = res.shape[1]
    table = U.vlc_packed().astype(np.int64)
    rd = Reader(staged(dec, fs, C), fs, cur0)
    qc = np.zeros((n, C, 8, 128), np.int16) if store else None
    for s in range(8):
        for c in range(C):
            cc = int(coded[c])
            for kb in range(0, 128 if store else cc, 16):
                acc = np.zeros((n, 8), np.int64)
                for j in range(16 if kb < cc else 0):
                    # bands past coded_count read as resolution 0 (no-ops)
                    r = res[:, c, kb + j].astype(np.int64) * (kb + j < cc)
                    t = table[np.minimum(r, 15)]
                    count = t[:, 0] & 0xFF
                    big = (t[:, 0] >> 8) & 1
                    base = (t[:, 0] >> 12) & 0xF
                    thr = t[:, 0] >> 16
                    code = rd.code(count)        # 0 past the frame end
                    adv = base + (code >= thr)
                    mag = code >> 1
                    v_big = np.where(code & 1, -mag, mag)
                    vw = np.where(code & 8, t[:, 2], t[:, 1])
                    v_small = ((vw >> (4 * (code & 7))) & 15) - 8
                    v = np.where(big == 1, v_big, v_small)
                    acc[:, j >> 1] |= (v & 0xFFFF) << (16 * (j & 1))
                    rd.consume(adv)
                    if j & 1:
                        rd.refill()
                if store:
                    # the two 16-byte stores: eight u32 words, LE int16 pairs
                    qc[:, c, s, kb:kb + 16] = acc.astype("<u4").view(
                        "<i2").reshape(n, 16)
    return qc, rd.cur.astype(np.int32)


def _random_frames(rng, n, fs):
    fr = rng.integers(0, 256, (n, fs), dtype=np.uint8)
    fr[:, :2] = 0xFF
    return fr


@pytest.mark.parametrize("fs", [256, 515, 64])
def test_staged_read_equals_peek_at_every_cursor_and_count(fs):
    """Reader's first read at any cursor (past the end too) and count 0-25
    equals BitReader.peek: 0 as a whole past the frame end."""
    rng = np.random.default_rng(fs)
    dec = _random_frames(rng, 37, fs)          # 37: a ragged second CTA
    peek = U._Bits(torch.from_numpy(dec)).peek
    rows = staged(dec, fs, 2, seed=fs)
    for cur in range(0, fs * 8 + 70, 3 if fs > 64 else 1):
        cur0 = np.full(dec.shape[0], cur)
        rd = Reader(rows, fs, cur0)
        for count in range(26):
            got = rd.code(np.full(dec.shape[0], count))
            want = peek(torch.from_numpy(cur0), count).numpy()
            np.testing.assert_array_equal(got, want, err_msg=f"{cur} {count}")


@pytest.mark.parametrize("fs", [512, 515, 100])
def test_staged_walk_equals_peek(fs):
    """A walk of random (count <= 12, advance <= count) steps from random
    start cursors, topped up after every second step as the kernel does,
    through every word and far past the frame end (the word index clamped,
    the cursor not): every code equals peek at the walk's cursor, and the
    buffer never runs short."""
    rng = np.random.default_rng(fs + 1)
    n = 70
    dec = _random_frames(rng, n, fs)
    peek = U._Bits(torch.from_numpy(dec)).peek
    cur0 = rng.integers(0, fs * 8 + 40, n)
    cur0[:3] = (0, 31, 32)
    rd = Reader(staged(dec, fs, 1, seed=fs), fs, cur0)
    cur = cur0.astype(np.int64)
    steps = 0
    while cur.min() < fs * 8 + 64:
        count = rng.integers(0, 13, n)
        assert (rd.nbuf >= count).all()
        want = peek(torch.from_numpy(cur), torch.from_numpy(count)).numpy()
        np.testing.assert_array_equal(rd.code(count), want)
        adv = rng.integers(0, count + 1)
        rd.consume(adv)
        cur += adv
        np.testing.assert_array_equal(rd.cur, cur)
        steps += 1
        if steps % 2 == 0:
            rd.refill()
            assert (rd.nbuf >= 32).all() and (rd.nbuf <= 64).all()
    assert steps > 50


def test_stage_rows_places_every_frame_in_its_padded_row():
    """The padded-stride arithmetic: 16-byte chunk i lands in row i // q;
    each lane's row starts 16-byte aligned and reads back its frame; the
    lanes' 16-byte resolution reads cover all 32 banks every 8 lanes."""
    rng = np.random.default_rng(3)
    for fs, C in ((512, 2), (515, 1), (1536, 6), (256, 2)):
        g = geometry(fs, C)
        assert g["frame_stride"] % 16 == 0 and g["res_stride"] % 16 == 0
        assert g["frame_stride"] >= 4 * ((fs + 3) // 4 + 2)   # row[W + 1]
        here = g["frames"] - 3
        src = rng.integers(0, 256, here * fs, dtype=np.uint8)
        region = stage_rows(src, here, fs, g["frame_stride"],
                            np.zeros(g["frames"] * g["frame_stride"],
                                     np.uint8))
        rows = region.reshape(here, g["frame_stride"])
        np.testing.assert_array_equal(rows[:, :fs], src.reshape(here, fs))
        for c in range(C):
            for kb in range(0, 128, 16):
                banks = set()
                for lane in range(8):
                    word = (lane * g["res_stride"] + c * 128 + kb) // 4
                    banks |= {(word + i) % 32 for i in range(4)}
                assert len(banks) == 32


def test_bank_chunk_geometry_is_one_wave():
    """The HCA bank chunk (64 x 469 frames, fs 512, stereo): 32 frames and
    25.6 KB a CTA, 938 CTAs, 8 resident an SM: one wave on 132 SMs."""
    g = geometry(512, 2)
    assert g["frames"] == 32 and g["smem"] == 25600
    ctas = -(-64 * 469 // g["frames"])
    assert ctas == 938 and ctas <= SMS * (SMEM_PER_SM // g["smem"])
    # the largest frame still fits one CTA of one frame
    big = geometry(65535, 16)
    assert big["frames"] == 1 and big["smem"] <= SMEM_PER_SM


def test_packed_vlc_table_equals_value_and_advance_tables():
    """kVlcPacked (as generated into hca_tables.inc) read the kernel's way
    equals vlc_tables() (the former kVlcValue / kVlcAdvance) at every code
    a resolution 0-7 can read, its step advance equals max_bit(r) - (code
    < 2) at resolutions 8-15, and it carries max_bit and the >= 8 flag."""
    header = _build.tables_header()
    m = re.search(r"kVlcPacked\[64\] = \{([^}]*)\}", header)
    packed = np.array([int(x.strip().rstrip("u")) for x in
                       m.group(1).split(",")], np.int64).reshape(16, 4)
    np.testing.assert_array_equal(packed, U.vlc_packed().astype(np.int64))
    val, adv = U.vlc_tables()
    for r in range(16):
        count = int(U.max_bit(torch.tensor(r)))
        assert packed[r, 0] & 0xFF == count
        assert (packed[r, 0] >> 8) & 1 == (r >= 8)
        base, thr = (packed[r, 0] >> 12) & 0xF, packed[r, 0] >> 16
        for code in range(1 << count):
            a = base + (code >= thr)
            if r >= 8:
                assert a == count - (code >> 1 == 0), (r, code)
                continue
            v = ((packed[r, 1 + code // 8] >> (4 * (code % 8))) & 15) - 8
            assert (a, v) == (adv[r, code], val[r, code]), (r, code)


@pytest.mark.parametrize("channels,quality", [(2, 2), (1, 4), (6, 0)])
def test_b2_model_equals_twin_and_host_reference(channels, quality):
    """The kernel model on a real stream's frames equals the twin and the
    JAX package's host unpacker (qc), and its cursor-only mode gives the
    same end cursor."""
    blob = H.encode(channels, quality, seed=5 + channels, samples=5000)
    ji, pi = H.parse_both(blob)
    frames = H.frames_of(blob, pi).copy()
    up = U.DeviceUnpacker(pi, device="cpu")
    dec = torch.from_numpy(frames)
    _, res, _, cur, err = up.side_info(dec)
    assert not err.any()
    qc_t, end_t = up.spectra_plain(dec, res, cur)
    qc, end = b2_model(frames, res.numpy(), cur.numpy(), up.coded)
    np.testing.assert_array_equal(qc, qc_t.numpy())
    np.testing.assert_array_equal(end, end_t.numpy())
    ref = jax_frame._unpack_frames_py(
        ji, blob[H.header_size(blob):][:ji.frame_count * ji.frame_size])
    np.testing.assert_array_equal(qc, ref.qc)
    _, end_c = b2_model(frames, res.numpy(), cur.numpy(), up.coded,
                        store=False)
    np.testing.assert_array_equal(end_c, end_t.numpy())


@pytest.mark.parametrize("fs", [256, 515])
def test_b2_model_equals_twin_on_random_frames(fs):
    """Random bytes (most frames read past their end, cursors run far
    beyond fs * 8) at a frame size on and off 16 bytes, 45 frames (a
    ragged second CTA): qc and the unclamped end cursor equal the twin's."""
    blob = H.encode(2, 4, seed=11, samples=3000)
    _, pi = H.parse_both(blob)
    pi.frame_size = fs
    up = U.DeviceUnpacker(pi, device="cpu")
    frames = _random_frames(np.random.default_rng(fs), 45, fs)
    dec = torch.from_numpy(frames)
    _, res, _, cur, _ = up.side_info(dec)
    qc_t, end_t = up.spectra_plain(dec, res, cur)
    qc, end = b2_model(frames, res.numpy(), cur.numpy(), up.coded)
    np.testing.assert_array_equal(qc, qc_t.numpy())
    np.testing.assert_array_equal(end, end_t.numpy())
    assert (end_t.numpy() > fs * 8).any()
