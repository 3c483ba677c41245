"""PyTorch port, the packer kernel `hca_pack`'s warp design on the CPU.

`hca_pack` (pycricodecs_tpu_torch/csrc/hca_pack.cu) gives each frame a
warp. Each segment of the symbol sequence (the sync word with level and
boundary as two
16-bit symbols; per channel the delta width, the scalefactors, the intensity or
HFR scales; per subframe and channel the spectrum codes) gives lane l the
symbols 4l..4l+3; the lane concatenates them, a scan of the lanes' widths
gives each lane its bit offset, the symbols that end past fs * 8 are cut
(the kept ones are a prefix), and the lane ORs its bits into at most three
words of the frame's row. The CRC16 is the parity of the XOR over words of
word & M[j][w] (`hca_pack_device.crc_mask_table`, a copy of the JAX
package's `_crc_mask_table`). A numpy model of exactly that order is held
to the twin `pack_frames_plain`, whose own tests hold it to the JAX
package's packers; the mask table to the JAX package's, and the
mask-parity CRC to `_crc16_rows`.

Tolerance: exact (equal bytes).
"""
import numpy as np
import pytest
import torch

from pycricodecs_tpu.ops.hca_pack_device import _crc_mask_table
from pycricodecs_tpu_torch.ops import hca_pack_device as PP
from pycricodecs_tpu_torch.ops import hca_tables as T
import chip_smoke
from tests import torch_port_helpers  # noqa: F401  (one torch thread)
from tests.test_pack_device import CASES, _encode_tensors, _wav

M32 = 0xFFFFFFFF
LANES = 32


def _kw(info, fs=None):
    return dict(channels=int(info.channels),
                coded_counts=tuple(int(x) for x in info.coded_count),
                channel_types=tuple(int(x) for x in info.channel_type),
                hfr_group_count=int(info.hfr_group_count),
                frame_size=int(fs or info.frame_size))


def _mask(v, bits):
    return v & ((1 << bits) - 1)


class Row:
    """The frames' word rows [n, W + 2] (u32 as int64) and the writer's
    uniform bit position, segment by segment."""

    def __init__(self, n: int, fs: int):
        self.fs = fs
        self.W = -(-fs // 4)
        self.words = np.zeros((n, self.W + 2), np.int64)
        self.pos = np.zeros(n, np.int64)
        self.ix = np.arange(n)

    def emit(self, val, bits):
        """One segment: val, bits int64 [n, 32 lanes, 4] -> OR the kept
        bits into the rows (emit + place of the kernel)."""
        n = val.shape[0]
        acc = np.zeros((n, LANES), np.int64)
        tw = np.zeros((n, LANES), np.int64)
        cum = []
        for j in range(4):
            acc = (acc << bits[..., j]) | _mask(val[..., j], bits[..., j])
            tw = tw + bits[..., j]
            cum.append(tw)
        incl = np.cumsum(tw, axis=1)               # the shuffle scan
        off = self.pos[:, None] + incl - tw
        cut = np.zeros_like(tw)
        for j in range(4):
            cut = np.where(off + cum[j] <= self.fs * 8, cum[j], cut)
        for lane in range(LANES):
            k = cut[:, lane]
            go = k > 0
            if not go.any():
                continue
            v = acc[:, lane] >> (tw[:, lane] - k)
            o = off[:, lane]
            sh = o & 31
            t = [int(x) for x in v]
            for i in np.nonzero(go)[0]:
                tt = (t[i] << (64 - int(k[i]))) & ((1 << 64) - 1)
                w0 = (tt >> (32 + int(sh[i]))) & M32
                w1 = (tt >> int(sh[i])) & M32
                w2 = (tt << (32 - int(sh[i]))) & M32
                w = int(o[i]) >> 5
                for d, x in enumerate((w0, w1, w2)):
                    if x:
                        assert w + d < self.W, "a kept bit past the row"
                        self.words[i, w + d] |= x
        self.pos = self.pos + incl[:, -1]


def lanes(n, fill=0):
    return (np.full((n, LANES, 4), fill, np.int64),
            np.zeros((n, LANES, 4), np.int64))


def crc16_masked(words: np.ndarray, fs: int) -> np.ndarray:
    """The kernel's CRC: bit j = parity of XOR_w (word_w & M[j][w])."""
    M = PP.crc_mask_table(fs).astype(np.int64)          # [W, 16]
    W = M.shape[0]
    crc = np.zeros(words.shape[0], np.int64)
    for j in range(16):
        fold = np.zeros(words.shape[0], np.int64)
        for w in range(W):
            fold ^= words[:, w] & M[w, j]
        par = np.array([bin(int(x)).count("1") & 1 for x in fold])
        crc |= par << j
    return crc


def pack_model(level, boundary, sf, res, inten, hfr, db, quant, *,
               channels, coded_counts, channel_types, hfr_group_count,
               frame_size):
    """The kernel, one warp per frame, on numpy [1, n, ...] tensors ->
    u8 [1, n, frame_size]."""
    n = level.shape[1]
    C, fs, G = channels, frame_size, hfr_group_count
    lv, bd = level[0].astype(np.int64), boundary[0].astype(np.int64)
    sf, res = sf[0].astype(np.int64), res[0].astype(np.int64)
    inten, hfr = inten[0].astype(np.int64), hfr[0].astype(np.int64)
    db, q = db[0].astype(np.int64), quant[0].astype(np.int64)
    qs_val = T.QUANTIZE_SPECTRUM_VALUE.astype(np.int64).reshape(-1)
    qs_bits = T.QUANTIZE_SPECTRUM_BITS.astype(np.int64).reshape(-1)
    row = Row(n, fs)
    band = 4 * np.arange(LANES)[:, None] + np.arange(4)[None, :]  # [32, 4]
    val, bits = lanes(n)
    val[:, 0, 0] = 0xFFFF                                # sync word
    val[:, 0, 1] = ((lv & 0x1FF) << 7) | (bd & 0x7F)
    bits[:, 0, :2] = 16
    row.emit(val, bits)
    for c in range(C):
        cc = int(coded_counts[c])
        d = db[:, c][:, None, None]
        val, bits = lanes(n)
        val[:, 0, 0] = db[:, c]
        bits[:, 0, 0] = 3
        row.emit(val, bits)
        s = sf[:, c][:, band]                          # [n, 32, 4]
        prev = np.concatenate([s[:, :, :1], s[:, :, :-1]], axis=2)
        prev[:, 1:, 0] = s[:, :-1, 3]                  # __shfl_up byte 3
        ns = np.where(d == 0, 0, np.where(d == 6, cc, max(cc, 1)))
        maxd = np.where(d >= 1, (1 << np.maximum(d - 1, 0)) - 1, 0)
        escape = (1 << d) - 1
        delta = s - prev
        raw = (d == 6) | (band == 0)
        esc = np.abs(delta) > maxd
        val = np.where(raw, s, np.where(esc, (escape << 6) | s, maxd + delta))
        bits = np.where(raw, 6, np.where(esc, d + 6, d))
        bits = np.where(band < ns, bits, 0)
        row.emit(val, bits)
        if channel_types[c] == T.STEREO_SECONDARY:
            val, bits = lanes(n)
            val[:, :2] = inten[:, c].reshape(n, 2, 4)
            bits[:, :2] = 4
            row.emit(val, bits)
        elif G > 0:
            g_ok = band < G
            val = np.where(g_ok, hfr[:, c][:, np.minimum(band, G - 1)], 0)
            bits = np.where(g_ok, 6, 0)[None].repeat(n, 0)
            row.emit(val, bits)
    for s8 in range(8):
        for c in range(C):
            cc = int(coded_counts[c])
            rv = res[:, c][:, band]
            qv = q[:, c, s8][:, band]
            code = np.clip(qv + 8, 0, 15)
            idx = np.clip(rv, 0, 7) * 16 + code
            nz = qv != 0
            v_hi = np.where(nz, (np.abs(qv) << 1) | (qv < 0), 0)
            b_hi = rv - 4 + nz            # QUANTIZED_SPECTRUM_MAX_BITS - 1
            val = np.where(rv < 8, qs_val[idx], v_hi)
            bits = np.where(rv < 8, qs_bits[idx], b_hi)
            on = (band < cc) & (rv != 0) & (rv < 16)
            row.emit(np.where(on, val, 0), np.where(on, bits, 0))
    crc = crc16_masked(row.words, fs)
    words = row.words[:, :row.W]
    data = np.stack([(words >> s) & 0xFF for s in (24, 16, 8, 0)],
                    axis=-1).reshape(n, -1)[:, :fs].astype(np.uint8)
    data[:, fs - 2] = crc >> 8
    data[:, fs - 1] = crc & 0xFF
    return data[None]


def _twin(t, kw):
    return PP.pack_frames_plain(*[torch.from_numpy(np.array(a)) for a in t],
                                **kw).numpy()


def test_wide_code_width_is_res_minus_3():
    """The kernel takes QUANTIZED_SPECTRUM_MAX_BITS[res] = res - 3 for
    res 8..15 in closed form."""
    np.testing.assert_array_equal(
        T.QUANTIZED_SPECTRUM_MAX_BITS[8:].astype(np.int64),
        np.arange(8, 16) - 3)


@pytest.mark.parametrize("fs", [256, 512, 515, 1024, 1536, 8, 9, 138])
def test_crc_mask_table_equals_jax(fs):
    np.testing.assert_array_equal(PP.crc_mask_table(fs),
                                  _crc_mask_table(fs, -(-fs // 4)))


@pytest.mark.parametrize("fs", [256, 512, 515, 1024])
def test_mask_parity_crc_equals_byte_serial_crc(fs):
    rng = np.random.default_rng(fs)
    data = rng.integers(0, 256, (24, fs), dtype=np.uint8)
    data[0] = 0
    data[1, :fs - 2] = 0xFF
    W = -(-fs // 4)
    padded = np.zeros((24, 4 * W), np.uint8)
    padded[:, :fs] = data
    # garbage in the CRC slot and past fs must not count
    padded[:, fs - 2:] = rng.integers(0, 256, (24, 4 * W - fs + 2))
    words = padded.reshape(24, W, 4).astype(np.int64)
    words = ((words[..., 0] << 24) | (words[..., 1] << 16)
             | (words[..., 2] << 8) | words[..., 3])
    want = PP._crc16_rows(torch.from_numpy(data[:, :fs - 2])).numpy()
    np.testing.assert_array_equal(crc16_masked(words, fs), want)


@pytest.mark.parametrize("case", [CASES[1], CASES[3], CASES[4]],
                         ids=lambda c: f"ch{c['channels']}q{c['quality']}")
def test_warp_model_equals_twin_on_encoded_frames(case):
    wav = _wav(samples=case["samples"], channels=case["channels"],
               rate=case.get("rate", 44100), seed=case["seed"])
    info, F, tensors = _encode_tensors(wav, case["quality"])
    t = [np.array(a)[:, :6] for a in tensors]
    np.testing.assert_array_equal(pack_model(*t, **_kw(info)),
                                  _twin(t, _kw(info)))


@pytest.mark.parametrize("channels,quality,fs", [(2, 2, None), (1, 4, None),
                                                 (2, 0, None), (2, 4, 515)])
def test_warp_model_equals_twin_on_overflowing_frames(channels, quality, fs):
    """chip_smoke.py's random legal tensors: most frames overflow the
    writer, so the cut (a prefix of the symbols) decides the bytes; one
    config at a frame size off 16 and 4 bytes."""
    info, _, _ = _encode_tensors(_wav(samples=4096, channels=channels,
                                      rate=48000, seed=channels), quality)
    t = [x.numpy() for x in chip_smoke.random_pack_tensors(
        np.random.default_rng(channels + quality), info, 5, "cpu")]
    kw = _kw(info, fs)
    np.testing.assert_array_equal(pack_model(*t, **kw), _twin(t, kw))
    value, bits = PP._symbols(*[torch.from_numpy(a[0]) for a in t],
                              **{k: v for k, v in kw.items()
                                 if k not in ("channels", "frame_size")})
    assert bool((bits.sum(dim=1) > kw["frame_size"] * 8).any())


def test_warp_model_keeps_the_symbol_that_ends_in_the_crc_slot():
    info, _, _ = _encode_tensors(_wav(samples=4096, channels=2, rate=48000,
                                      seed=3), 0)
    tt, lead = chip_smoke.crc_slot_tensors(info, "cpu")
    t = [x.numpy() for x in tt]
    got = pack_model(*t, **_kw(info))
    np.testing.assert_array_equal(got, _twin(t, _kw(info)))
    k = min(lead, 8)
    fs = int(info.frame_size)
    assert got[0, 0, fs - 3] & ((1 << k) - 1) == (1 << k) - 1
