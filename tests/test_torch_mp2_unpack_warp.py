"""PyTorch port, kernel B10's warp walk on the CPU: a numpy model.

B10 (pycricodecs_tpu_torch/csrc/mp2_unpack.cu) gives each Layer II frame
one warp, lane = subband. The warp stages the frame's bytes, from the
16-byte boundary below its start up to the largest Layer II frame (1,729
bytes), into shared memory as big-endian words (zeros past the input's
end), reads the header from that copy, and decodes the frame in four
exclusive warp scans of per-lane field widths (allocation, scfsi,
scalefactors, one granule's sample fields; for C = 2 a lane holds its
(sb, 0) and (sb, 1) slots, sb-major), each lane reading its own fields at
their positions, all 12 granules at base + g x granule_bits. A read of
n > 0 bits past the frame end is 0 and flags the lane; the frame's err is
a ballot. Grouped codes divide by 3, 5 and 9 with a multiply-high.

The model here does the same steps in numpy, over frames and 32 lanes:
the stage (slots no copy fills are poisoned), the funnel-shift read, the
scans, the per-lane extraction, the ballot. It is held byte for byte, err
included, to the twin `mp2_unpack_plain` and to the JAX package's host
unpacker (`mp2_frame.unpack`) on every AHX fixture (LSF mono, MPEG-1
stereo and joint stereo, the per-frame varying-bound stream, CRC, VBR),
on the VBR concatenation of the JAX tests, on seeded random frames of
every table behind valid headers (frame sizes off 16 bytes, frame counts
off whole CTAs), and on seeded frames cut inside the scalefactors and
inside the samples; a frame's end can fall in no earlier section (checked
over every legal header). Its division is checked over every 16-bit code.

Tolerance: exact (byte-equal outputs, equal flags).
"""
import numpy as np
import pytest
import torch

from pycricodecs_tpu.ops import mp2_frame as jax_frame
from pycricodecs_tpu_torch.ops import mp2_unpack_device as port_unpack
from tests import test_torch_ahx_unpack as AU
from tests import torch_port_helpers as H

TB = port_unpack.tables()
MAX_FRAME = 1729          # kMaxFrame
STAGE_BYTES = 1760        # kStageBytes
POISON = 0xA5


def div_small(v, n):
    """The kernel's div_small: v // n for n in {3, 5, 9}, any other n
    taking 9's constants."""
    m = np.where(n == 3, 0xAAAB, np.where(n == 5, 0xCCCD, 0xE38F))
    s = np.where(n == 3, 17, np.where(n == 5, 18, 19))
    return ((v * m) & 0xFFFFFFFF) >> s


def stage(frames: np.ndarray) -> tuple:
    """(words u64 [N, 440] big-endian, off [N]): each warp's staged copy;
    16-byte chunks from the boundary below the frame's start, bytes past
    the input's end zero, never-staged bytes POISON."""
    N, W = frames.shape
    flat = frames.reshape(-1)
    total = N * W
    start = np.arange(N, dtype=np.int64) * W
    a = start & ~15
    off = start - a
    chunks = (off + min(W, MAX_FRAME) + 15) >> 4
    idx = a[:, None] + np.arange(STAGE_BYTES)
    staged = np.arange(STAGE_BYTES)[None, :] < 16 * chunks[:, None]
    b = np.where(idx < total, flat[np.minimum(idx, total - 1)], 0)
    b = np.where(staged, b, POISON).astype(np.uint64)
    b = b.reshape(N, -1, 4)
    words = (b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8) | b[..., 3]
    return words, off


class Warp:
    """Per-lane reads from the staged words; err per (frame, lane)."""

    def __init__(self, words, base, nbits):
        self.w, self.base, self.nbits = words, base, nbits
        self.err = np.zeros((words.shape[0], 32), bool)

    def get(self, p, n):
        """n (0..16) bits at frame bit p, [N, 32] each."""
        over = (n > 0) & (p + n > self.nbits[:, None])
        self.err |= over
        ok = (n > 0) & ~over
        q = np.where(ok, self.base[:, None] + p, 0)
        k = q >> 5
        hi = np.take_along_axis(self.w, k, 1)
        lo = np.take_along_axis(self.w, k + 1, 1)
        both = (hi << np.uint64(32)) | lo
        sh = (64 - (q & 31) - np.maximum(n, 1)).astype(np.uint64)
        val = (both >> sh) & ((np.uint64(1) << n.astype(np.uint64))
                              - np.uint64(1))
        return np.where(ok, val.astype(np.int64), 0)


def scan(x):
    """Exclusive warp scan over lanes, and the warp's total."""
    inc = np.cumsum(x, axis=1)
    return inc - x, inc[:, -1:]


def warp_model(frames: np.ndarray, C: int):
    """B10 as the warps walk it: frames u8 [N, W] -> (codes, levels, sfidx,
    err, ends) with ends [N, 4] the cursor after each section."""
    N, W = frames.shape
    words, off = stage(frames)
    hq = 8 * off
    k = (hq >> 5)[:, None]
    both = ((np.take_along_axis(words, k, 1)[:, 0] << np.uint64(32))
            | np.take_along_axis(words, k + 1, 1)[:, 0])
    hw = ((both >> (32 - (hq & 31)).astype(np.uint64))
          & np.uint64(0xFFFFFFFF)).astype(np.int64)
    if W < 4:
        hw &= ~(0xFFFFFFFF >> (8 * W)) & 0xFFFFFFFF
    version, bri = (hw >> 19) & 3, (hw >> 12) & 0xF
    sri, mode = (hw >> 10) & 3, (hw >> 6) & 3
    nch = np.where(mode == 3, 1, 2)
    valid = ((((hw >> 21) & 0x7FF) == 0x7FF) & (((hw >> 17) & 3) == 2)
             & ((version == 2) | (version == 3)) & (bri != 0) & (bri != 15)
             & (sri != 3) & (nch == C))
    v1 = (version == 3).astype(np.int64)
    sri_c, bri_c = np.minimum(sri, 2), np.minimum(bri, 14)
    table = np.where(v1 == 1, TB["select"][sri_c, (nch == 1).astype(int),
                                           bri_c], 4)
    sblimit = np.where(valid, TB["sblimit"][table], 0)
    bound = np.where(mode == 1, np.minimum((((hw >> 4) & 3) + 1) * 4,
                                           sblimit), sblimit)
    size = (144 * TB["bitrate"][v1, bri_c] * 1000
            // TB["rate"][v1, sri_c] + ((hw >> 9) & 1))
    valid &= size <= W
    fr = Warp(words, 8 * off, np.where(valid, 8 * size, 0))
    cur = np.where((hw >> 16) & 1, 32, 48)[:, None]
    sb = np.arange(32)[None, :]
    two = C == 2
    own1 = two & (sb < bound[:, None])
    ends = []

    # section 1: allocation
    nb = np.where(sb < sblimit[:, None], TB["nbal"][table[:, None], sb], 0)
    wa1 = np.where(own1, nb, 0)
    pre, tot = scan(nb + wa1)
    p = cur + pre
    cur = cur + tot
    ends.append(cur[:, 0])
    i0 = fr.get(p, nb)
    i1 = np.where(own1, fr.get(p + nb, wa1), i0)
    n0 = TB["classes"][table[:, None], sb, i0]
    n1 = TB["classes"][table[:, None], sb, i1] if two else np.zeros_like(n0)
    # section 2: scfsi
    ws0, ws1 = np.where(n0 > 0, 2, 0), np.where(n1 > 0, 2, 0)
    pre, tot = scan(ws0 + ws1)
    p = cur + pre
    cur = cur + tot
    ends.append(cur[:, 0])
    s0, s1 = fr.get(p, ws0), fr.get(p + ws0, ws1)
    # section 3: scalefactors
    cnt = [np.where(n > 0, np.select([s == 0, s == 2], [3, 1], 2), 0)
           for n, s in ((n0, s0), (n1, s1))]
    pre, tot = scan(6 * (cnt[0] + cnt[1]))
    p = cur + pre
    cur = cur + tot
    ends.append(cur[:, 0])
    sfv = []
    for ch in range(2):
        c, s = cnt[ch], (s0, s1)[ch]
        r0 = fr.get(p, np.where(c > 0, 6, 0))
        r1 = fr.get(p + 6, np.where(c > 1, 6, 0))
        r2 = fr.get(p + 12, np.where(c > 2, 6, 0))
        sfv.append([r0, np.where((s == 0) | (s == 3), r1, r0),
                    np.where(s == 0, r2, np.where(s == 2, r0, r1))])
        p = p + 6 * c
    # section 4: one granule's sample fields, 12 granules
    at_t = table[:, None]
    gb0 = np.where(n0 > 0, TB["gbits"][at_t, sb, i0], 0)
    ub0 = np.where(n0 > 0, TB["ubits"][at_t, sb, i0], 0)
    gb1 = np.where(own1 & (n1 > 0), TB["gbits"][at_t, sb, i1], 0)
    ub1 = np.where(own1 & (n1 > 0), TB["ubits"][at_t, sb, i1], 0)
    wq0, wq1 = gb0 + 3 * ub0, gb1 + 3 * ub1
    intra, granule = scan(wq0 + wq1)
    ends.append((cur + 12 * granule)[:, 0])
    codes = np.zeros((N, C, 36, 32), np.int64)
    for g in range(12):
        val = []
        for ch, (n, gb, ub) in enumerate(((n0, gb0, ub0), (n1, gb1, ub1))):
            at = cur + g * granule + intra + (wq0 if ch else 0)
            vg = fr.get(at, gb)
            q1 = div_small(vg, n)
            q2 = div_small(q1, n)
            u = [fr.get(at + i * ub, ub) for i in range(3)]
            val.append([np.where(gb > 0, x, y) for x, y in
                        zip((vg - q1 * n, q1 - q2 * n, q2), u)])
        for ch in range(C):
            for kk in range(3):
                codes[:, ch, 3 * g + kk] = (np.where(own1, val[1][kk],
                                                     val[0][kk])
                                            if ch else val[0][kk])
    levels = np.stack([n0, n1][:C], 1)
    sfidx = np.stack([np.stack(sfv[ch], 1) for ch in range(C)], 1)
    err = fr.err.any(1) | ~valid
    keep = valid[:, None, None]
    return (np.where(keep[..., None], codes, 0).astype(np.uint16),
            np.where(keep, levels, 0).astype(np.int32),
            np.where(keep[..., None], sfidx, 0).astype(np.uint8),
            err, np.stack(ends, 1))


def twin(frames, C):
    return [t.numpy() for t in port_unpack.mp2_unpack_plain(
        torch.from_numpy(frames), C)]


def assert_model_is_twin(frames, C):
    got = warp_model(frames, C)
    for name, a, b in zip(("codes", "levels", "sfidx", "err"), got[:4],
                          twin(frames, C)):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    return got


def test_division_by_3_5_9_is_exact_for_every_code():
    v = np.arange(1 << 16, dtype=np.int64)
    for n in (3, 5, 9):
        np.testing.assert_array_equal(div_small(v, np.full_like(v, n)),
                                      v // n)


def test_no_legal_frame_ends_before_its_scalefactors():
    """Over every legal header (version, bitrate, rate, mode, bound, CRC),
    the largest allocation and scfsi sections end inside the smallest
    frame: a frame can be cut only in its scalefactors or its samples."""
    worst = -(1 << 30)
    for v1 in (0, 1):
        for bri in range(1, 15):
            for sri in range(3):
                for mode in range(4):
                    nch = 1 if mode == 3 else 2
                    table = TB["select"][sri, int(nch == 1), bri] if v1 else 4
                    sbl = TB["sblimit"][table]
                    size = 144 * TB["bitrate"][v1, bri] * 1000 \
                        // TB["rate"][v1, sri]
                    alloc = nch * int(TB["nbal"][table, :sbl].sum())
                    end2 = 48 + alloc + 2 * nch * sbl
                    worst = max(worst, end2 - 8 * size)
    assert worst < 0


@pytest.mark.parametrize("name", AU.AHX_NAMES + ["jax_vbr_test_stream"])
def test_model_matches_twin_and_host_unpacker(name):
    _, blobs = H.load_ahx_fixtures()
    blob = AU._vbr_stream() if name == "jax_vbr_test_stream" else blobs[name]
    off = H.mp2_offset(blob)
    hdr0, walk = jax_frame.scan_frames(blob, off)
    frames = AU._stack(walk)
    codes, levels, sfidx, err, _ = assert_model_is_twin(frames, hdr0.nch)
    host = jax_frame.unpack(blob, off)
    assert not err.any()
    np.testing.assert_array_equal(codes, host.codes)
    np.testing.assert_array_equal(levels, host.levels)
    np.testing.assert_array_equal(sfidx, host.sfidx)


def random_frames(rng, n, version, bri, sri, mode, crc=False, extra=1):
    """n random-byte frames behind valid headers (random padding bit and
    mode_ext), rows of the largest size + extra bytes."""
    w0 = ((0x7FF << 21) | (version << 19) | (2 << 17)
          | ((0 if crc else 1) << 16) | (bri << 12) | (sri << 10)
          | (mode << 6))
    hdr = jax_frame.parse_header(w0.to_bytes(4, "big"))
    fr = rng.integers(0, 256, (n, hdr.frame_size + extra), dtype=np.uint8)
    words = (w0 | (rng.integers(0, 2, n) << 9)
             | (rng.integers(0, 4, n) << 4)).astype(">u4")
    fr[:, :4] = words.view(np.uint8).reshape(-1, 4)
    return fr, hdr.nch


# (header fields, rows): every table, frame sizes off 16 and 4 bytes, frame
# counts off whole 4-warp CTAs
RANDOM = [
    (dict(version=2, bri=8, sri=2, mode=3), 37),             # LSF 16 kHz
    (dict(version=2, bri=10, sri=0, mode=3, crc=True), 42),  # LSF, CRC
    (dict(version=2, bri=14, sri=1, mode=0), 21),            # LSF stereo
    (dict(version=3, bri=10, sri=0, mode=0), 23),            # table a/b
    (dict(version=3, bri=10, sri=0, mode=1, crc=True), 45),  # joint
    (dict(version=3, bri=3, sri=1, mode=3), 30),             # table c
    (dict(version=3, bri=2, sri=2, mode=0), 17),             # table d
    (dict(version=3, bri=14, sri=2, mode=1), 9),             # 1,728 bytes
]


@pytest.mark.parametrize("kw,n", RANDOM)
def test_model_matches_twin_on_random_frames(kw, n):
    rng = np.random.default_rng(n)
    for extra in (1, 7):
        fr, C = random_frames(rng, n, **kw, extra=extra)
        fr[:2] = 0                                      # no header
        assert_model_is_twin(fr, C)
        # the same frames one byte into a row: every start off 16 bytes
        assert_model_is_twin(np.ascontiguousarray(
            np.pad(fr, ((0, 0), (1, 0)))[:, :-1]), C)


def test_rows_shorter_than_a_header_and_frames_of_other_counts():
    _, blobs = H.load_ahx_fixtures()
    _, mono = jax_frame.scan_frames(blobs["mp2_lsf_mono_24k_1s"], 0)
    _, stereo = jax_frame.scan_frames(blobs["mp2_stereo_44k_192k_1s"], 0)
    frames = AU._stack([mono[0], stereo[0], (0, b""), mono[1]])
    codes, levels, sfidx, err, _ = assert_model_is_twin(frames, 1)
    np.testing.assert_array_equal(err, [0, 1, 1, 0])
    for W in (1, 2, 3, 4, 5, 100):
        assert_model_is_twin(np.ascontiguousarray(frames[:, :W]), 1)
        assert_model_is_twin(np.ascontiguousarray(frames[:, :W]), 2)


# (header fields, section the end falls in): the smallest LSF stereo frames
# end inside their scalefactors, larger mono frames inside their samples
CUTS = [(dict(version=2, bri=1, sri=0, mode=0), 2),
        (dict(version=2, bri=2, sri=1, mode=1), 2),
        (dict(version=2, bri=4, sri=1, mode=3), 3),
        (dict(version=3, bri=1, sri=1, mode=0), 3)]


@pytest.mark.parametrize("kw,section", CUTS)
def test_frames_cut_inside_a_section(kw, section):
    """Frames whose size ends inside the scalefactors (section 2) or the
    samples (section 3): flagged exactly where the host unpacker raises,
    byte-equal to the twin, and the rest equal to the host's unpack."""
    rng = np.random.default_rng(section * 100 + kw["bri"])
    fr, C = random_frames(rng, 48, **kw)
    codes, levels, sfidx, err, ends = assert_model_is_twin(fr, C)
    sizes = [jax_frame.parse_header(bytes(r[:4])).frame_size for r in fr]
    nbits = 8 * np.asarray(sizes)
    inside = (nbits < ends[:, section]) & (
        nbits >= (ends[:, section - 1] if section else 0))
    assert inside.sum() >= 8
    assert (err[nbits < ends[:, 3]]).all() and not err[nbits >= ends[:, 3]] \
        .any()
    for i, row in enumerate(fr):
        frame = bytes(row[:sizes[i]])
        try:
            host = jax_frame.unpack(frame, 0)
        except ValueError as exc:
            assert "truncated" in str(exc) and err[i]
            continue
        assert not err[i]
        np.testing.assert_array_equal(codes[i], host.codes[0])
        np.testing.assert_array_equal(levels[i], host.levels[0])
        np.testing.assert_array_equal(sfidx[i], host.sfidx[0])
