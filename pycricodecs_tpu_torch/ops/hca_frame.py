"""HCA header parse: the stream configuration every decode stage reads.

Behaviour parity: clHCA_DecodeHeader (hca.cpp:628-984). A codec has no
weights, so `HcaInfo` (the parsed config, its cipher table and ATH curve) is
all the state a decode carries.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np

from ..utils import hca_crypt
from ..utils.bitio import BitReader
from ..utils.crc import crc16, crc16_batch
from . import hca_tables as T

HCA_MASK = 0x7F7F7F7F

VERSION_V101 = 0x0101
VERSION_V200 = 0x0200
VERSION_V300 = 0x0300


class HcaError(ValueError):
    pass


@dataclass
class HcaInfo:
    version: int = 0
    header_size: int = 0
    channels: int = 0
    sample_rate: int = 0
    frame_count: int = 0
    encoder_delay: int = 0
    encoder_padding: int = 0
    frame_size: int = 0
    min_resolution: int = 1
    max_resolution: int = 15
    track_count: int = 1
    channel_config: int = 0
    stereo_type: int = 0
    total_band_count: int = 0
    base_band_count: int = 0
    stereo_band_count: int = 0
    bands_per_hfr_group: int = 0
    ms_stereo: int = 0
    vbr_max_frame_size: int = 0
    vbr_noise_level: int = 0
    ath_type: int = 0
    loop_flag: bool = False
    loop_start_frame: int = 0
    loop_end_frame: int = 0
    loop_start_delay: int = 0
    loop_end_padding: int = 0
    ciph_type: int = 0
    rva_volume: float = 1.0
    comment: str = ""
    hfr_group_count: int = 0
    keycode: int = 0

    # derived
    channel_type: np.ndarray = field(
        default_factory=lambda: np.zeros(0, dtype=np.uint8))
    coded_count: np.ndarray = field(
        default_factory=lambda: np.zeros(0, dtype=np.int32))
    ath: np.ndarray = field(
        default_factory=lambda: np.zeros(128, dtype=np.uint8))
    cipher: np.ndarray = field(
        default_factory=lambda: np.arange(256, dtype=np.uint8))

    def init_derived(self) -> None:
        self.channel_type = T.channel_types(
            self.channels, self.track_count, self.stereo_band_count,
            self.channel_config)
        self.coded_count = np.where(
            self.channel_type == T.STEREO_SECONDARY,
            self.base_band_count,
            self.base_band_count + self.stereo_band_count).astype(np.int32)
        self.ath = T.ath_curve(self.ath_type, self.sample_rate)
        self.cipher = hca_crypt.cipher_table(self.ciph_type, self.keycode)

    def set_key(self, keycode: int) -> None:
        self.keycode = keycode
        self.cipher = hca_crypt.cipher_table(self.ciph_type, keycode)

    _ARRAY_DTYPES = {"channel_type": np.uint8, "coded_count": np.int32,
                     "ath": np.uint8, "cipher": np.uint8}

    @classmethod
    def from_arrays(cls, d: dict) -> "HcaInfo":
        """Build from a field dict of plain values and numpy arrays (e.g.
        `dataclasses.asdict` of another HcaInfo with the same fields, such
        as the JAX package's), carrying the parsed config, cipher table and
        ATH curve across unchanged."""
        kw = {f.name: d[f.name] for f in dataclasses.fields(cls)}
        for name, dtype in cls._ARRAY_DTYPES.items():
            kw[name] = np.array(kw[name], dtype=dtype)
        return cls(**kw)


def _ceil2(a: int, b: int) -> int:
    return (a // b + (1 if a % b else 0)) if b >= 1 else 0


def parse_header(data: bytes) -> HcaInfo:
    if len(data) < 8:
        raise HcaError("Header too small")
    br = BitReader(data)
    info = HcaInfo()

    if (br.peek(32) & HCA_MASK) != 0x48434100:
        raise HcaError("Not an HCA header")
    br.skip(32)
    info.version = br.read(16)
    info.header_size = br.read(16)
    if info.version not in (0x0101, 0x0102, 0x0103, 0x0200, 0x0300):
        raise HcaError("Unknown HCA version")
    if len(data) < info.header_size:
        raise HcaError("Truncated header")
    if crc16(data[:info.header_size]):
        raise HcaError("Header checksum mismatch")
    size = info.header_size - 8

    if size >= 0x10 and (br.peek(32) & HCA_MASK) == 0x666D7400:  # fmt
        br.skip(32)
        info.channels = br.read(8)
        info.sample_rate = br.read(24)
        info.frame_count = br.read(32)
        info.encoder_delay = br.read(16)
        info.encoder_padding = br.read(16)
        if not (1 <= info.channels <= 16) or info.frame_count == 0 \
                or not (1 <= info.sample_rate <= 0x7FFFFF):
            raise HcaError("Bad fmt chunk")
        size -= 0x10
    else:
        raise HcaError("Missing fmt chunk")

    if size >= 0x10 and (br.peek(32) & HCA_MASK) == 0x636F6D70:  # comp
        br.skip(32)
        info.frame_size = br.read(16)
        info.min_resolution = br.read(8)
        info.max_resolution = br.read(8)
        info.track_count = br.read(8)
        info.channel_config = br.read(8)
        info.total_band_count = br.read(8)
        info.base_band_count = br.read(8)
        info.stereo_band_count = br.read(8)
        info.bands_per_hfr_group = br.read(8)
        info.ms_stereo = br.read(8)
        br.read(8)
        size -= 0x10
    elif size >= 0x0C and (br.peek(32) & HCA_MASK) == 0x64656300:  # dec
        br.skip(32)
        info.frame_size = br.read(16)
        info.min_resolution = br.read(8)
        info.max_resolution = br.read(8)
        info.total_band_count = br.read(8) + 1
        info.base_band_count = br.read(8) + 1
        info.track_count = br.read(4)
        info.channel_config = br.read(4)
        info.stereo_type = br.read(8)
        if info.stereo_type == 0:
            info.base_band_count = info.total_band_count
        info.stereo_band_count = info.total_band_count - info.base_band_count
        info.bands_per_hfr_group = 0
        size -= 0x0C
    else:
        raise HcaError("Missing comp/dec chunk")

    if size >= 0x08 and (br.peek(32) & HCA_MASK) == 0x76627200:  # vbr
        br.skip(32)
        info.vbr_max_frame_size = br.read(16)
        info.vbr_noise_level = br.read(16)
        if not (info.frame_size == 0
                and 8 < info.vbr_max_frame_size <= 0x1FF):
            raise HcaError("Bad vbr chunk")
        size -= 0x08

    if size >= 0x06 and (br.peek(32) & HCA_MASK) == 0x61746800:  # ath
        br.skip(32)
        info.ath_type = br.read(16)
    else:
        info.ath_type = 1 if info.version < VERSION_V200 else 0

    if size >= 0x10 and (br.peek(32) & HCA_MASK) == 0x6C6F6F70:  # loop
        br.skip(32)
        info.loop_start_frame = br.read(32)
        info.loop_end_frame = br.read(32)
        info.loop_start_delay = br.read(16)
        info.loop_end_padding = br.read(16)
        info.loop_flag = True
        if not (info.loop_start_frame <= info.loop_end_frame
                < info.frame_count):
            raise HcaError("Bad loop chunk")
        size -= 0x10

    if size >= 0x06 and (br.peek(32) & HCA_MASK) == 0x63697068:  # ciph
        br.skip(32)
        info.ciph_type = br.read(16)
        if info.ciph_type not in (0, 1, 56):
            raise HcaError("Bad cipher type")
        size -= 0x06

    if size >= 0x08 and (br.peek(32) & HCA_MASK) == 0x72766100:  # rva
        br.skip(32)
        info.rva_volume = np.frombuffer(
            np.uint32(br.read(32)).tobytes(), dtype=np.float32)[0]
        size -= 0x08

    if size >= 0x05 and (br.peek(32) & HCA_MASK) == 0x636F6D6D:  # comm
        br.skip(32)
        clen = br.read(8)
        if clen > size:
            raise HcaError("Bad comment chunk")
        info.comment = bytes(br.read(8) for _ in range(clen)).decode(
            "utf-8", errors="replace")
        size -= 0x05 + clen

    # validations (hca.cpp:842-977)
    if not (0x08 <= info.frame_size <= 0xFFFF):
        raise HcaError("Bad frame size")
    if info.version <= VERSION_V200:
        if info.min_resolution != 1 or info.max_resolution != 15:
            raise HcaError("Bad resolution range")
    else:
        if info.min_resolution > info.max_resolution \
                or info.max_resolution > 15:
            raise HcaError("Bad resolution range")
    if info.track_count == 0:
        info.track_count = 1
    if info.track_count > info.channels:
        raise HcaError("Bad track count")
    if (info.total_band_count > 128 or info.base_band_count > 128
            or info.stereo_band_count > 128
            or info.base_band_count + info.stereo_band_count > 128
            or info.bands_per_hfr_group > 128):
        raise HcaError("Bad band counts")
    info.hfr_group_count = _ceil2(
        info.total_band_count - info.base_band_count
        - info.stereo_band_count, info.bands_per_hfr_group)
    if info.ms_stereo:
        raise HcaError("MS stereo streams unsupported")  # as the reference
    info.init_derived()
    return info


# ---------------------------------------------------------------------------
# Key testing (clHCA_TestBlock analogue, hca.cpp:1004-1097)
# ---------------------------------------------------------------------------

def test_block(info: HcaInfo, frame: bytes, random_state: int = 1, *,
               device="cuda") -> int:
    """Statistically score one frame under info.cipher on `device`
    (clHCA_TestBlock, hca.cpp:1004-1097): pycricodecs_tpu.ops.hca_frame.
    test_block's score. 0 = silent/neutral, 1 = plausible, 2/3/clips =
    suspicious, negative = hard bitstream failure. The PNS noise state
    threads across calls in the reference; test_block_state carries it."""
    return test_block_state(info, frame, random_state, device=device)[0]


def test_block_state(info: HcaInfo, frame: bytes, random_state: int = 1, *,
                     device="cuda") -> tuple:
    """test_block and the advanced noise LCG state: (score, random_state),
    equal to pycricodecs_tpu.ops.hca_frame.test_block_state's.

    The host runs the key-independent checks first, in the reference's
    order: a frame whose body is all zero scores 0, a bad sync word or CRC
    -1, each before any launch; the rest is `score_frames` of the one
    frame. The state is unchanged on every early return. A frame longer
    than frame_size is cut to it; a shorter one reads zeros past its
    end."""
    fs = info.frame_size
    frame = bytes(frame[:fs])
    if all(b == 0 for b in frame[2:fs - 2]):
        return 0, random_state
    if not (frame[0] == 0xFF and frame[1] == 0xFF):
        return -1, random_state
    if crc16(frame):
        return -1, random_state
    row = np.zeros((1, fs), np.uint8)
    row[0, :len(frame)] = np.frombuffer(frame, np.uint8)
    scores, states = _score_rows(info, row, np.zeros(1, np.int64),
                                 random_state, device)
    return int(scores[0]), int(states[0])


def score_frames(info: HcaInfo, frames: bytes, random_state: int = 1, *,
                 device="cuda"):
    """test_block_state threaded over consecutive frames (len(frames) //
    frame_size of them, deciphered with info.cipher) in one pass on
    `device`: (scores i64 [n], the LCG state after each frame i64 [n]),
    equal to the fold `score, state = test_block_state(info, frame,
    state)` from random_state over the frames in order."""
    fs = info.frame_size
    n = len(frames) // fs
    fb = np.frombuffer(frames, np.uint8, count=n * fs).reshape(n, fs)
    # the key-independent checks: silent (0), then bad sync or CRC (-1)
    silent = ~fb[:, 2:fs - 2].any(axis=1)
    bad = (fb[:, 0] != 0xFF) | (fb[:, 1] != 0xFF) | (crc16_batch(fb) != 0)
    pre = np.where(silent, 1, np.where(bad, -1, 0)).astype(np.int64)
    return _score_rows(info, fb, pre, random_state, device)


def _score_rows(info: HcaInfo, fb: np.ndarray, pre: np.ndarray,
                random_state: int, device):
    """The device half of the key test of consecutive frames u8 [n, fs]
    with their host check pre i64 [n] (1 silent, -1 bad sync or CRC, 0
    passed): (scores i64 [n], the LCG state after each frame i64 [n]).

    Kernels B1 and B2 unpack every frame under the key search's status
    rules (an unpack error or a nonzero byte after the last code -1, a
    cursor past frame_size * 8 - 14 -6); the clean frames draw their PNS
    noise maps (min_resolution 0) in frame order from random_state, and
    each clean frame's float wave, decoded alone with a zero carry (kernel
    B4), is scored as the key search scores it."""
    import torch

    from ..parallel import pipeline
    from . import hca_kernels, hca_unpack_device

    n = fb.shape[0]
    states = np.full(n, random_state, np.int64)
    if n == 0:
        return np.zeros(0, np.int64), states
    # raises HcaError for a scalefactor count of 128 with the v3 HFR
    # extension, where the JAX test has no defined answer (IndexError)
    up = hca_unpack_device.DeviceUnpacker(info, device=device)
    dev = up.device
    table = torch.from_numpy(up.cipher[None].copy()).to(dev)
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    status, (qc, sf, res, inten) = pipeline._frame_status(
        up, torch.from_numpy(fb.copy()).to(dev),
        torch.from_numpy(pre).to(dev), table, zero, n, True)
    scores = torch.where(status[0] == 1, 0, status[0])
    live = status[0] == 1
    sel = live.nonzero().squeeze(1)
    k = int(sel.numel())
    if k:
        C = info.channels
        noise = None
        if info.min_resolution == 0:
            # the reference's TestBlock runs the full transform, PNS noise
            # included, with the LCG state threading across the clean
            # frames
            maps = up.noise_maps(sf, res, 1, live=live, seed=random_state)
            drawn = maps[2].view(n, -1).sum(dim=1).cumsum(0)
            # a frame before the first draw leaves the state as it was
            states = np.where(
                drawn.cpu().numpy() > 0,
                hca_unpack_device.lcg_jump(drawn, random_state).cpu().numpy(),
                random_state)
            noise = tuple(m[sel].view(k, 1, C, 8, 128) for m in maps)
        hfr, cfg = hca_kernels.transform_config(info)
        wave = hca_kernels.hca_decode_wave(
            qc[sel].view(k, 1, C, 8, 128), sf[sel].view(k, 1, C, 128),
            res[sel].view(k, 1, C, 128), inten[sel].view(k, 1, C, 8), hfr,
            noise=noise, **cfg)
        scores[sel] = pipeline._wave_scores(wave)
    return scores.cpu().numpy(), states
