"""HCA frame unpacker on the device: deciphered frame bytes -> quantised
spectra, scalefactors, resolutions and intensities.

Counterpart of pycricodecs_tpu/ops/hca_unpack_device.py. Frames are serial
inside (each prefix code moves the bit cursor of the next) and independent
of each other, so both kernels run one frame per lane of a warp:

- `side_info` (kernel B1, csrc/hca_unpack.cu): per channel the scalefactor
  delta codes with escapes, the v3 HFR extension copy, the v2 HFR scales or
  the intensity values (v2 4-bit, v3 delta-coded with escapes), then the
  resolutions from scalefactors, ATH curve and noise level. Also the bit
  cursor where the spectra start and a per-frame error flag. A lane decodes
  its frame's symbols from a shared-memory copy, branch-free across the
  lanes' modes; the warp then computes the resolutions of its 32 frames
  together, four bands a lane, and stores whole 128-byte rows. The five
  outputs are views of one allocation (`side_info_layout`), made while the
  kernel runs.
- `coefficients` / `spectra` (kernel B2): 8 subframes x channels x
  coded_count prefix symbols from that cursor, and the unclamped cursor
  after the last one (the key search's end-of-frame rules); `spectra` can
  skip the spectra and return the cursor alone.
- `noise_maps` (v3 streams with min_resolution 0): the PNS fill's source
  band, scale index and mask per value, in plain PyTorch on the device, from
  B1's scalefactors and resolutions; kernel B3 adds the fill.

A coded_count of 0 (a v2 stereo secondary under base_band_count 0) needs no
special case: both kernels loop over the coded count at run time, and the
reads at cs_count 0 are the reference's (3 delta bits, and for delta bits
1-5 one 6-bit value into sf[0]). `decipher` takes the stream's own table or,
for the key search, one table per row.

Each has a plain PyTorch twin beside it (`side_info_plain`,
`spectra_plain`): vectorised across frames, sequential over symbols,
int64 arithmetic. A CUDA tensor goes to the kernel (or raises); a CPU tensor
goes to the twin. Error conditions the host reference raises on (scalefactor
delta out of range, v3 intensity out of range) come back as the `err` flag,
as in the JAX unpacker. Reference anchors: hca.cpp:1290-1355
(scalefactors), 1357-1434 (intensity), 1444-1494 (resolutions), 1513-1537
(prefix codes).
"""
from __future__ import annotations

import numpy as np
import torch

from . import cuda_kernels as ck
from . import hca_tables as T
from .hca_frame import HcaError
from ..utils.device import as_device

VERSION_V200 = 0x0200

# READ_BIT_TABLE / READ_VAL_TABLE rows (r = 0..7) packed 4 bits per code:
# lo word = codes 0..7, hi word = codes 8..15; VAL nibbles store value + 8.
# The same constants as the JAX unpacker (tests hold them equal to the
# reference tables).
_BIT_LO = [0x0, 0x2211, 0x33222222, 0x33333322,
           0x33333333, 0x33333333, 0x44333333, 0x44444433]
_BIT_HI = [0x0, 0x0, 0x0, 0x0,
           0x44333333, 0x44444433, 0x44444444, 0x44444444]
_VAL_LO = [0x88888888, 0x88887988, 0x6A779988, 0x5B6A7988,
           0xAA779988, 0xAA779988, 0x6A779988, 0x5B6A7988]
_VAL_HI = [0x88888888, 0x88888888, 0x88888888, 0x88888888,
           0x4C55BB66, 0x3D4C5B66, 0x2E3D4C5B, 0x1F2E3D4C]

#: kernel launches since import (or the last reset); see chip_smoke.py
SIDE_INFO_LAUNCHES = 0
COEFF_LAUNCHES = 0

# PNS noise LCG (hca.cpp:1616): x' = 0x343FD*x + 0x269EC3 mod 2^32. The map
# is affine, so the state after n draws is a 32-step square-and-multiply over
# these precomputed (a, b) = f^(2^k) pairs.
_MASK32 = 0xFFFFFFFF
_LCG_POWS = []
_a, _b = 0x343FD, 0x269EC3
for _k in range(32):
    _LCG_POWS.append((_a, _b))
    _b = (_a * _b + _b) & _MASK32
    _a = (_a * _a) & _MASK32
del _a, _b, _k


def _mul32(a: int, x: torch.Tensor) -> torch.Tensor:
    """(a * x) mod 2^32 for x in [0, 2^32), without int64 overflow."""
    hi = ((a >> 16) * x) & 0xFFFF
    return ((a & 0xFFFF) * x + (hi << 16)) & _MASK32


def lcg_jump(n_draws: torch.Tensor, seed: int = 1) -> torch.Tensor:
    """State after n_draws (mod 2^32) applications of the noise LCG to
    `seed` (mod 2^32; the JAX package's random_state), int64 in
    [0, 2^32)."""
    n = n_draws & _MASK32
    x = torch.full_like(n, int(seed) & _MASK32)
    for k, (a, b) in enumerate(_LCG_POWS):
        hit = ((n >> k) & 1) == 1
        x = torch.where(hit, (_mul32(a, x) + b) & _MASK32, x)
    return x


def vlc_tables():
    """(value i8 [8, 16], advance u8 [8, 16]) prefix-code tables for
    resolutions 0..7, unpacked from the nibble constants above."""
    val = np.zeros((8, 16), np.int8)
    adv = np.zeros((8, 16), np.uint8)
    for r in range(8):
        for code in range(16):
            sh = (code & 7) * 4
            vw, bw = ((_VAL_HI[r], _BIT_HI[r]) if code >= 8
                      else (_VAL_LO[r], _BIT_LO[r]))
            val[r, code] = ((vw >> sh) & 0xF) - 8
            adv[r, code] = (bw >> sh) & 0xF
    return val, adv


def vlc_packed() -> np.ndarray:
    """Kernel B2's folded prefix-code table, u32 [16, 4], one row per
    resolution r: [0] the code width max_bit(r) | (r >= 8) << 8 |
    base << 12 | thr << 16, [1] and [2] the value + 8 in 4 bits per code
    for codes 0..7 and 8..15 (the _VAL_LO/_VAL_HI words; 0 for r >= 8),
    [3] 0. At every code a resolution can read (below 1 << max_bit(r)) the
    advance is a step, base + (code >= thr): `vlc_tables()` for r <= 7,
    max_bit(r) - (code < 2) for r >= 8, 0 for r = 0 (thr 1, code 0)."""
    _, adv = vlc_tables()
    out = np.zeros((16, 4), np.uint32)
    for r in range(16):
        count = int(max_bit(torch.tensor(r)))
        if r >= 8:
            base, thr = count - 1, 2
        elif r == 0:
            base, thr = 0, 1
        else:
            a = [int(adv[r, code]) for code in range(1 << count)]
            base = a[0]
            thr = next((i for i, x in enumerate(a) if x != base), 1 << count)
            if a != [base + (i >= thr) for i in range(1 << count)]:
                raise AssertionError(f"resolution {r}: advance is no step")
        if r < 8:
            out[r, 1:3] = (_VAL_LO[r], _VAL_HI[r])
        out[r, 0] = count | (r >= 8) << 8 | base << 12 | thr << 16
    return out


def max_bit(r: torch.Tensor) -> torch.Tensor:
    """MAX_BIT_TABLE closed form: 0, 2,3,3,4,4,4,4, then r-3."""
    small = 2 + (r >= 2).long() + (r >= 4).long()
    return torch.where(r == 0, 0, torch.where(r < 8, small, r - 3))


class _Bits:
    """Vectorised BitReader.peek over a batch of frames (one cursor per
    frame): any read crossing the frame end, or of 0 bits, returns 0."""

    def __init__(self, dec: torch.Tensor):
        self.fs = dec.shape[1]
        self.nbits = self.fs * 8
        # 4 zero bytes past the end keep every 4-byte window in range
        self.d = torch.nn.functional.pad(dec.to(torch.int64), (0, 4))
        self.off = torch.arange(4, device=dec.device)

    def peek(self, cur: torch.Tensor, count) -> torch.Tensor:
        count = torch.as_tensor(count, dtype=torch.int64,
                                device=cur.device).expand_as(cur)
        bb = torch.clamp(cur >> 3, max=self.fs)
        b = torch.gather(self.d, 1, bb[:, None] + self.off)
        w = (b[:, 0] << 24) | (b[:, 1] << 16) | (b[:, 2] << 8) | b[:, 3]
        val = (w >> (32 - (cur & 7) - count)) & ((1 << count) - 1)
        ok = (count > 0) & (cur + count <= self.nbits)
        return torch.where(ok, val, 0)


class DeviceUnpacker:
    """Unpacker for one stream config (`HcaInfo`), on `device`.

    Call with uint8 [N, frame_size] stacked enciphered frames (sync and CRC
    already checked); returns (qc i16 [N, C, 8, 128], sf u8 [N, C, 128],
    res u8 [N, C, 128], inten u8 [N, C, 8], err bool [N]) on `device`."""

    def __init__(self, info, *, device):
        self.device = as_device(device)
        C = int(info.channels)
        self.C = C
        self.fs = int(info.frame_size)
        self.version = int(info.version)
        self.hfr = int(info.hfr_group_count)
        self.min_res = int(info.min_resolution)
        self.max_res = int(info.max_resolution)
        self.coded = [int(x) for x in np.asarray(info.coded_count)]
        self.ctype = [int(x) for x in np.asarray(info.channel_type)]
        if info.ms_stereo:
            raise ValueError("ms_stereo unsupported")  # parse rejects too
        self.ath = np.ascontiguousarray(info.ath, dtype=np.uint8)
        self.cipher = np.ascontiguousarray(info.cipher, dtype=np.uint8)
        # the substitution table on the device, or None for the identity
        self._cipher_t = None
        if not np.array_equal(self.cipher, np.arange(256, dtype=np.uint8)):
            self._cipher_t = torch.from_numpy(self.cipher.copy()).to(
                self.device)
        # static per-channel scalefactor counts (incl. the v3 HFR extension)
        self.cs_counts = []
        self.extras = []
        for c in range(C):
            cs = self.coded[c]
            extra = 0
            if not (self.ctype[c] == T.STEREO_SECONDARY or self.hfr <= 0
                    or self.version <= VERSION_V200):
                extra = self.hfr
                cs += extra
            # the config decides both: every frame of such a stream fails
            if cs > 128:
                # the JAX host unpacker raises this on every frame
                raise HcaError("Unpack error (scalefactor count)")
            if cs >= 128 and extra:
                # the extension copies sf[cs] = sf[128], past the channel's
                # row: the JAX Python unpacker raises IndexError, its native
                # one reads the next row; the port refuses the stream
                raise HcaError("cs_count == 128 with HFR extension")
            self.cs_counts.append(cs)
            self.extras.append(extra)
        self._coded = np.ascontiguousarray(self.coded, dtype=np.int32)
        # the bytes of a frame B1 reads at most (it stages only those)
        max_bits = self.side_info_max_bits()
        self.side_info_reach = min(self.fs, (max_bits + 7) >> 3)
        # B1's config (hca_side_info in csrc/hca_unpack.cu): fs, C,
        # version, hfr, min_res, max_res, max_bits, per channel coded, cs,
        # extra and type, then the ATH curve as 32 words of 4 bands
        self._side_info_cfg = np.concatenate([
            np.array([self.fs, C, self.version, self.hfr, self.min_res,
                      self.max_res, max_bits, *self.coded,
                      *self.cs_counts, *self.extras, *self.ctype], np.int32),
            self.ath.view("<i4")])
        self._side_info_cfg_ptr = ck.host_ptr(self._side_info_cfg)

    def side_info_max_bits(self) -> int:
        """The most bits a frame's side info can take: 32 header bits, per
        channel 3 + 6 + 11 (a delta code and its escape) per further
        scalefactor, then 32 v2 or 55 v3 intensity bits, or 6 per v2 HFR
        scale."""
        bits = 32
        for c in range(self.C):
            bits += 9 + 11 * max(self.cs_counts[c] - 1, 0)
            if self.ctype[c] == T.STEREO_SECONDARY:
                bits += 32 if self.version <= VERSION_V200 else 55
            elif self.version <= VERSION_V200:
                bits += 6 * max(self.hfr, 0)
        return bits

    # -- decipher -----------------------------------------------------------

    def decipher(self, frames: torch.Tensor, tables=None,
                 row_table=None) -> torch.Tensor:
        """Frame bytes (on this unpacker's device) through the 256-entry
        substitution table: the stream's own, or per row, with u8 tables
        [T, 256] and row_table i64 [N] (the table of each row of frames)."""
        if tables is not None:
            idx = row_table[:, None] * 256 + frames.long()
            return tables.reshape(-1)[idx]
        if self._cipher_t is None:
            return frames.contiguous()
        return self._cipher_t[frames.long()]

    # -- B1: side info ------------------------------------------------------

    def side_info(self, dec: torch.Tensor):
        """dec u8 [N, fs] deciphered frames -> (sf u8 [N, C, 128],
        res u8 [N, C, 128], inten u8 [N, C, 8], cur i32 [N], err bool [N])."""
        if dec.device.type == "cpu":
            return self.side_info_plain(dec)
        return self._side_info_cuda(dec)

    def _side_info_cuda(self, dec):
        global SIDE_INFO_LAUNCHES
        N = dec.shape[0]
        ck.check_cuda(dec, "dec", torch.uint8, (N, self.fs))
        offsets = self.side_info_layout(N)
        buf = torch.empty(offsets[-1], dtype=torch.uint8, device=dec.device)
        if N:
            p = buf.data_ptr()
            ck.launch("hca_side_info", dec,
                      dec.data_ptr(), N, self._side_info_cfg_ptr, p,
                      p + offsets[1], p + offsets[2], p + offsets[3],
                      p + offsets[4])
            SIDE_INFO_LAUNCHES += 1
        # the views are made while the kernel runs
        return self.side_info_views(buf, N, offsets)

    def side_info_layout(self, N: int) -> tuple:
        """Byte offsets of B1's five outputs in their one allocation (sf,
        res, inten, cur, err, and the end), each part on a 16-byte
        boundary (as `hca_side_info` in csrc/hca_unpack.cu requires)."""
        n_sf, n_in = N * self.C * 128, N * self.C * 8
        o_cur = 2 * n_sf + ((n_in + 15) & ~15)
        o_err = o_cur + ((4 * N + 15) & ~15)
        return 0, n_sf, 2 * n_sf, o_cur, o_err, o_err + N

    def side_info_views(self, buf, N: int, offsets):
        """(sf u8 [N, C, 128], res u8 [N, C, 128], inten u8 [N, C, 8],
        cur i32 [N], err bool [N]) on `buf` at `offsets`."""
        C = self.C
        _, o_res, o_in, o_cur, o_err, _ = offsets
        return (buf.as_strided((N, C, 128), (C * 128, 128, 1)),
                buf.as_strided((N, C, 128), (C * 128, 128, 1), o_res),
                buf.as_strided((N, C, 8), (C * 8, 8, 1), o_in),
                buf[o_cur:o_cur + 4 * N].view(torch.int32),
                buf[o_err:].view(torch.bool))

    def side_info_plain(self, dec: torch.Tensor):
        """Plain PyTorch twin of kernel B1 (mirrors the JAX unpacker's
        _sf_symbol / _inten3_symbol / _resolutions arithmetic)."""
        N, C, dev = dec.shape[0], self.C, dec.device
        peek = _Bits(dec).peek
        d2 = dec[:, 2].long()
        d3 = dec[:, 3].long()
        packed_noise = (((d2 << 1) | (d3 >> 7)) << 8) - (d3 & 0x7F)
        cur = torch.full((N,), 32, dtype=torch.int64, device=dev)
        err = torch.zeros((N,), dtype=torch.bool, device=dev)
        sf_ch, inten_ch = [], []
        for c in range(C):
            cs = self.cs_counts[c]
            sf = torch.zeros((N, 128), dtype=torch.int64, device=dev)
            db = peek(cur, 3)
            cur = cur + 3
            v0 = peek(cur, 6)
            is_abs = db >= 6
            is_delta = (db >= 1) & (db <= 5)
            # the delta branch reads its first value even at cs 0
            has_first = is_delta | (is_abs & (cs > 0))
            cur = cur + torch.where(has_first, 6, 0)
            sf[:, 0] = torch.where(has_first, v0, 0)
            expected = (1 << db) - 1
            half = expected >> 1
            dcount = torch.where(is_delta, db, 0)
            value = sf[:, 0]
            for i in range(1, cs):
                delta = peek(cur, dcount)
                vabs = peek(cur, 6)
                esc = is_delta & (delta == expected)
                vesc = peek(cur + dcount, 6)
                test = value + delta - half
                bad = is_delta & ~esc & ((test < 0) | (test >= 64))
                vdelta = torch.where(esc, vesc, (value - half + delta) & 0x3F)
                sf[:, i] = torch.where(is_abs, vabs,
                                       torch.where(is_delta, vdelta, 0))
                cur = cur + torch.where(
                    is_abs, 6, torch.where(is_delta,
                                           dcount + torch.where(esc, 6, 0),
                                           0))
                value = torch.where(is_delta, vdelta, value)
                err = err | bad
            for i in range(self.extras[c]):
                # hca.cpp:1352-1355 - i=0 copies sf[cs] (a zero)
                sf[:, 127 - i] = sf[:, cs - i]

            inten = torch.zeros((N, 8), dtype=torch.int64, device=dev)
            if self.ctype[c] == T.STEREO_SECONDARY:
                v4 = peek(cur, 4)
                flag = v4 < 15
                if self.version <= VERSION_V200:
                    # intensity[0] stored even when >= 15; the cursor
                    # advances only when < 15
                    step = torch.where(flag, 4, 0)
                    cur = cur + step
                    inten[:, 0] = v4
                    for k in range(1, 8):
                        inten[:, k] = torch.where(flag, peek(cur, 4), 0)
                        cur = cur + step
                else:
                    cur = cur + 4
                    db2 = peek(cur, 2)
                    cur = cur + torch.where(flag, 2, 0)
                    direct = flag & (db2 == 3)
                    delta_m = flag & (db2 < 3)
                    nb = torch.where(delta_m, db2 + 1, 0)
                    bmax = (2 << db2) - 1
                    value = v4
                    inten[:, 0] = torch.where(flag, v4, 7)
                    for k in range(1, 8):
                        v4d = torch.where(direct, peek(cur, 4), 0)
                        delta = torch.where(delta_m, peek(cur, nb), 0)
                        esc = delta_m & (delta == bmax)
                        vesc = peek(cur + nb, 4)
                        vnew = torch.where(esc, vesc,
                                           value - (bmax >> 1) + delta)
                        err = err | (delta_m & ((vnew > 15) | (vnew < 0)))
                        value = torch.where(delta_m, vnew, value)
                        vi = torch.where(direct, v4d,
                                         torch.where(delta_m, value, 7))
                        inten[:, k] = vi & 0xFF
                        cur = cur + torch.where(
                            direct, 4, torch.where(
                                delta_m, nb + torch.where(esc, 4, 0), 0))
            elif self.version <= VERSION_V200 and self.hfr > 0:
                for i in range(self.hfr):
                    sf[:, 128 - self.hfr + i] = peek(cur, 6)
                    cur = cur + 6
            sf_ch.append(sf)
            inten_ch.append(inten)
        sf = torch.stack(sf_ch, dim=1)                      # [N, C, 128]
        inten = torch.stack(inten_ch, dim=1)                # [N, C, 8]
        res = self._resolutions_plain(sf, packed_noise)
        return (sf.to(torch.uint8), res, inten.to(torch.uint8),
                cur.to(torch.int32), err)

    def _resolutions_plain(self, sf, packed_noise):
        """calc_resolutions (hca.cpp:1444-1494) on [N, C, 128] int64."""
        dev = sf.device
        k = torch.arange(128, device=dev)
        ath_t = torch.from_numpy(self.ath.astype(np.int64)).to(dev)
        invert = torch.from_numpy(T.INVERT_TABLE.astype(np.int64)).to(dev)
        coded = torch.tensor(self.coded, device=dev)[None, :, None]
        noise_level = ath_t + ((packed_noise[:, None, None] + k) >> 8)
        curve_pos = noise_level + 1 - ((5 * sf) >> 1)
        inv = invert[torch.clamp(curve_pos, 0, 65)]
        r = torch.where(curve_pos < 0, 15,
                        torch.where(curve_pos <= 65, inv, 0))
        r = torch.clamp(r, self.min_res, self.max_res)
        r = torch.where(sf > 0, r, 0)
        r = torch.where(k < coded, r, 0)
        return r.to(torch.uint8)

    # -- v3 PNS noise maps --------------------------------------------------

    def _noise_bands(self, sf: torch.Tensor, res: torch.Tensor):
        """(sf i64, noise bands, valid bands, their counts nc and vc) of
        frames' sf/res u8 [N, C, 128]: a coded band with a scalefactor is
        noise-filled at resolution 0 and valid (a fill source) above."""
        k = torch.arange(128, device=sf.device)
        coded = torch.tensor(self.coded, device=sf.device)[None, :, None]
        sf_i = sf.long()
        active = (sf_i > 0) & (k < coded)
        noise_f = active & (res < 1)
        valid_f = active & (res >= 1)
        return sf_i, noise_f, valid_f, noise_f.sum(-1), valid_f.sum(-1)

    def frame_draws(self, sf: torch.Tensor, res: torch.Tensor) -> torch.Tensor:
        """The noise LCG's draws in each frame of sf/res u8 [N, C, 128],
        i64 [N]: per subframe, nc for each channel with nc noise bands and
        a valid band (`noise_maps`'s count, every frame live)."""
        _, _, _, nc, vc = self._noise_bands(sf, res)
        return 8 * torch.where((nc > 0) & (vc > 0), nc, 0).sum(-1)

    def noise_maps(self, sf: torch.Tensor, res: torch.Tensor, B: int,
                   live=None, seed: int = 1, draws_before=None):
        """PNS noise fill maps (reconstruct_noise, hca.cpp:1602-1635) of the
        frames of B streams: sf/res u8 [N, C, 128], N = B * F frame-major
        per stream -> (src u8, sci u8, mask bool), each [N, C, 8, 128], on
        the device of sf. Each stream's LCG starts at `seed` (the JAX
        package's random_state, 1 in a stream decode). `live` (bool [N], or
        None for all): a frame not live draws nothing and gets no mask, so
        each stream's (or each key's) LCG advances only across its live
        frames, in frame order (the key search's rule, JAX
        pipeline.py:1147-1166). `draws_before` (i64 [B], or None for
        zeros): each stream's draws before its first frame here, so that a
        shard of a stream's frames continues its LCG where the frames
        before it left off (`frame_draws` counts them).

        The draw order is subframe-major, then channel, then noise slot; a
        (subframe, channel) with nc noise bands and vc > 0 valid bands takes
        nc draws. A band's draw ordinal is the frames-before prefix (per
        stream, so a padded tail frame moves no real frame) + s * NC + the
        channels-before prefix + its noise rank; the LCG state there is a
        closed-form jump from the seed. The drawn 15-bit value picks the
        (vc-1-j)-th valid band, found by a gather (the JAX package's one-hot
        select computes the same index). Plain PyTorch: the JAX package
        computes these maps in XLA, outside its kernels."""
        N, C, dev = sf.shape[0], self.C, sf.device
        k = torch.arange(128, device=dev)
        sf_i, noise_f, valid_f, nc, vc = self._noise_bands(sf, res)
        nrank = noise_f.long().cumsum(-1) - 1                  # [N, C, 128]
        vrank = valid_f.long().cumsum(-1) - 1
        draws = (nc > 0) & (vc > 0)
        if live is not None:
            draws = draws & live[:, None]
        nc_eff = torch.where(draws, nc, 0)
        NC = nc_eff.sum(-1)                                    # [N]
        pre_c = nc_eff.cumsum(-1) - nc_eff                     # exclusive
        per_frame = (8 * NC).view(B, -1)
        before = per_frame.cumsum(1) - per_frame
        if draws_before is not None:
            before = before + draws_before.to(dev).long()[:, None]
        before = before.reshape(N)
        s8 = torch.arange(8, device=dev)
        ordinal = (before[:, None, None, None]
                   + s8[None, None, :, None] * NC[:, None, None, None]
                   + pre_c[:, :, None, None]
                   + nrank[:, :, None, :])                     # [N, C, 8, 128]
        rand = lcg_jump(ordinal + 1, seed)                     # state at the draw
        vc4 = vc[:, :, None, None]
        j = ((rand & 0x7FFF) * vc4) >> 15
        target = (vc4 - 1 - j).clamp(min=0)                    # valid rank wanted
        # band of each valid rank (slot 128 collects the other bands)
        band_of = torch.zeros((N, C, 129), dtype=torch.int64, device=dev)
        band_of.scatter_(2, torch.where(valid_f, vrank, 128),
                         k.expand(N, C, 128).contiguous())
        has = vc4 > 0
        vb = torch.where(has, torch.gather(band_of, 2, target.view(N, C, -1))
                         .view(N, C, 8, 128), 0)
        sf_vb = torch.where(has, torch.gather(sf_i, 2, vb.view(N, C, -1))
                            .view(N, C, 8, 128), 0)
        sci = torch.clamp(sf_i[:, :, None, :] - sf_vb + 62, min=0)
        mask = noise_f & (vc > 0)[..., None]
        if live is not None:
            mask = mask & live[:, None, None]
        mask = mask[:, :, None, :].expand(N, C, 8, 128)
        src = torch.where(mask, vb, k)
        return (src.to(torch.uint8), sci.to(torch.uint8),
                mask.contiguous())

    # -- B2: coefficients ---------------------------------------------------

    def coefficients(self, dec: torch.Tensor, res: torch.Tensor,
                     cur: torch.Tensor) -> torch.Tensor:
        """dec u8 [N, fs], res u8 [N, C, 128], cur i32 [N] (from
        side_info) -> qc i16 [N, C, 8, 128], zero above coded_count."""
        return self.spectra(dec, res, cur)[0]

    def spectra(self, dec: torch.Tensor, res: torch.Tensor,
                cur: torch.Tensor, want_qc: bool = True):
        """Kernel B2: as `coefficients`, and the bit cursor after the last
        code, i32 [N], unclamped (reads past the frame end return 0 and
        still advance it, as BitReader does). want_qc=False is the
        cursor-only pass: qc comes back None and the kernel writes none."""
        if dec.device.type == "cpu":
            qc, end = self.spectra_plain(dec, res, cur)
            return (qc if want_qc else None), end
        return self._spectra_cuda(dec, res, cur, want_qc)

    def _spectra_cuda(self, dec, res, cur, want_qc):
        global COEFF_LAUNCHES
        N, C = dec.shape[0], self.C
        ck.check_cuda(dec, "dec", torch.uint8, (N, self.fs))
        ck.check_cuda(res, "res", torch.uint8, (N, C, 128))
        ck.check_cuda(cur, "cur", torch.int32, (N,))
        if res.data_ptr() % 16:
            res = res.clone()       # the kernel stages it in 16-byte copies
        qc = torch.empty((N, C, 8, 128), dtype=torch.int16,
                         device=dec.device) if want_qc else None
        end = torch.empty((N,), dtype=torch.int32, device=dec.device)
        if N == 0:
            return qc, end
        ck.launch("hca_coefficients", dec,
                  ck.ptr(dec), ck.ptr(res), ck.ptr(cur), N, self.fs, C,
                  ck.host_ptr(self._coded), ck.ptr(qc) if want_qc else None,
                  ck.ptr(end))
        COEFF_LAUNCHES += 1
        return qc, end

    def coefficients_plain(self, dec, res, cur):
        """Plain PyTorch twin of kernel B2's qc."""
        return self.spectra_plain(dec, res, cur)[0]

    def spectra_plain(self, dec, res, cur):
        """Plain PyTorch twin of kernel B2 (the JAX unpacker's _vlc_symbol
        in program order: subframe, channel, band): (qc, end cursor)."""
        N, C, dev = dec.shape[0], self.C, dec.device
        peek = _Bits(dec).peek
        val_np, adv_np = vlc_tables()
        val = torch.from_numpy(val_np.astype(np.int64).reshape(-1)).to(dev)
        adv_t = torch.from_numpy(adv_np.astype(np.int64).reshape(-1)).to(dev)
        r_all = res.long()
        bits_all = max_bit(r_all)
        cur = cur.long()
        qc = torch.zeros((N, C, 8, 128), dtype=torch.int16, device=dev)
        for s in range(8):
            for c in range(C):
                for k in range(self.coded[c]):
                    r = r_all[:, c, k]
                    nbits = bits_all[:, c, k]
                    code = peek(cur, nbits)
                    big = r > 7
                    v_big = (1 - ((code & 1) << 1)) * (code >> 1)
                    adv_big = nbits - (v_big == 0).long()
                    idx = torch.clamp(r, max=7) * 16 \
                        + torch.where(big, 0, code)
                    qc[:, c, s, k] = torch.where(big, v_big, val[idx]).to(
                        torch.int16)
                    cur = cur + torch.where(big, adv_big, adv_t[idx])
        return qc, cur.to(torch.int32)

    # -- full unpack --------------------------------------------------------

    def __call__(self, frames):
        """frames u8 [N, frame_size] (enciphered) -> (qc, sf, res, inten,
        err) on this unpacker's device."""
        if not torch.is_tensor(frames):
            frames = torch.from_numpy(np.require(frames, np.uint8, ["C", "W"]))
        frames = frames.to(self.device)
        dec = self.decipher(frames)
        sf, res, inten, cur, err = self.side_info(dec)
        qc = self.coefficients(dec, res, cur)
        return qc, sf, res, inten, err
