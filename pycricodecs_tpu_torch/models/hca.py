"""HCA codec: stream constants, loop-point math shared by the WAV writers,
the frame cipher re-keying (`crypt`), the frame-range decode
(`decode_range`, `decode_frames_to_pcm`) and the single-file surface
(`decode` and the drop-in `HCA` class).

Counterpart of pycricodecs_tpu/models/hca.py. The single-file decode and
encode run one stream through the batch paths of parallel/pipeline.py
(`decode_batch`, `hca_encode_batch`), and a frame range through its device
half (`decode_rows`: kernels B1, B2 and B3), on `device`; each gives the
JAX package's bytes.
"""
from __future__ import annotations

import io

import numpy as np

from ..containers.chunk import CriHcaQuality, WavHeaderStruct
from ..ops import hca_frame
from ..utils import hca_crypt
from ..utils import wav as wavmod

SAMPLES_PER_FRAME = 1024
#: the key an enciphered stream is read with, and encrypt() uses, when none
#: is given (pycricodecs_tpu/utils/hca_crypt.py DEFAULT_KEY)
DEFAULT_KEY = 0xCF222F1FE0748978


def loop_points(info) -> tuple:
    """(looping, loop_start, loop_end) in output samples (hca.cpp:3372-3373)."""
    if not info.loop_flag:
        return False, 0, 0
    loop_start = (info.loop_start_frame * SAMPLES_PER_FRAME
                  + info.loop_start_delay - info.encoder_delay)
    loop_end = (info.loop_end_frame * SAMPLES_PER_FRAME
                + (SAMPLES_PER_FRAME - info.loop_end_padding)
                - info.encoder_delay)
    return True, loop_start, loop_end


def crypt(data: bytes, encrypt: bool, header_size: int, ciph_type: int,
          keycode: int, subkey: int = 0) -> bytes:
    """Encrypt/decrypt all frames (parity with CriCodecs.HcaCrypt; the JAX
    package's models.hca.crypt): encrypt enciphers with `ciph_type` under
    the key, decrypt deciphers with the stream's own cipher type; both
    re-stamp every frame CRC and the header's chunk masks and CRC."""
    data = bytearray(data)
    info = hca_frame.parse_header(bytes(data[:header_size]))
    use_type = ciph_type if encrypt else info.ciph_type
    keycode = hca_crypt.scramble_subkey(keycode, subkey)
    table = hca_crypt.cipher_table(use_type, keycode)
    if encrypt:
        table = hca_crypt.invert_cipher_table(table)
    fs = info.frame_size
    nbytes = info.frame_count * fs
    frames = np.frombuffer(bytes(data[header_size:header_size + nbytes]),
                           dtype=np.uint8).reshape(info.frame_count, fs)
    frames = hca_crypt.apply_cipher_frames(frames, table, restamp_crc=True)
    data[header_size:header_size + nbytes] = frames.tobytes()
    header = hca_crypt.crypt_header(data[:header_size],
                                    ciph_type if encrypt else 0)
    data[:header_size] = header
    return bytes(data)


def decode_range(data: bytes, start_frame: int, end_frame: int = -1,
                 key: int = 0, subkey: int = 0, *,
                 device="cuda") -> np.ndarray:
    """Decode the frames [start_frame, end_frame) of an HCA stream on
    `device` to interleaved PCM16 [samples, channels]: pycricodecs_tpu.
    models.hca.decode_range's samples.

    HCA is CBR and frame-seekable: the range decodes after a decoder reset,
    so (as in the reference, hca.h:90-92) its first frame lacks the previous
    frame's overlap history and its first 128 samples differ from a
    full-stream decode. No encoder delay or padding is trimmed. end_frame
    < 0 or past the frame count means the frame count; start_frame is
    clamped to [0, end_frame]; an empty range gives shape (0, channels)."""
    data = bytes(data)
    header_size = int.from_bytes(data[6:8], "big")
    info = hca_frame.parse_header(data[:header_size])
    info.set_key(hca_crypt.scramble_subkey(key, subkey))
    if end_frame < 0 or end_frame > info.frame_count:
        end_frame = info.frame_count
    start_frame = max(0, min(start_frame, end_frame))
    frames = data[header_size + start_frame * info.frame_size:
                  header_size + end_frame * info.frame_size]
    return decode_frames_to_pcm(info, frames, device=device)


def decode_frames_to_pcm(info: hca_frame.HcaInfo, frames: bytes,
                         random_state: int = 1, use_jax: bool = None, *,
                         device="cuda") -> np.ndarray:
    """Decode raw frame bytes of `info`'s stream (len(frames) // frame_size
    whole frames, deciphered with info.cipher) on `device` to interleaved
    PCM16 [frames * 1024, channels]: pycricodecs_tpu.models.hca.
    decode_frames_to_pcm's samples. The first frame has a zero overlap
    carry; the PNS noise generator of a v3 stream with min_resolution 0
    starts at `random_state`. A frame with a bad sync word or CRC, or one
    the unpacker flags, raises HcaError. use_jax is the JAX function's
    choice of engine; its engines give the same samples, and so does this
    function for every value."""
    import torch

    from ..ops import hca_unpack_device
    from ..parallel import pipeline
    from ..utils.crc import crc16_batch

    fs, C = info.frame_size, info.channels
    F = len(frames) // fs
    if F == 0:
        return np.zeros((0, C), dtype=np.int16)
    arr = np.frombuffer(frames, np.uint8, count=F * fs).reshape(F, fs)
    if not (arr[:, :2] == 0xFF).all():
        raise hca_frame.HcaError("Frame sync lost")
    if crc16_batch(arr).any():
        raise hca_frame.HcaError("Frame checksum mismatch")
    up = hca_unpack_device.DeviceUnpacker(info, device=device)
    pcm, err = pipeline.decode_rows(up, torch.from_numpy(arr.copy())[None],
                                    info, seed=random_state)
    if bool(err.any()):
        raise hca_frame.HcaError("Unpack error (device)")
    return pcm[0].cpu().numpy()


def decode(data: bytes, key: int = 0, subkey: int = 0, *,
           device="cuda") -> bytes:
    """HCA bytes -> WAV bytes on `device` (one stream through decode_batch):
    pycricodecs_tpu.models.hca.decode's bytes. A truncated stream decodes
    its whole frames; the samples past them are zero."""
    from ..parallel import pipeline
    return pipeline.decode_batch([data], key=key, subkey=subkey,
                                 device=device)[0]


class HCA:
    """Public HCA class mirroring PyCriCodecs.HCA (and the JAX package's
    HCA); decode and encode run on `device`."""

    def __init__(self, stream, key: int = 0, subkey: int = 0, *,
                 device="cuda") -> None:
        if isinstance(stream, str):
            with open(stream, "rb") as fh:
                raw = fh.read()
        else:
            raw = bytes(stream)
        if isinstance(key, str):
            key = int(key, 16)
        if isinstance(subkey, str):
            subkey = int(subkey, 16)
        self.key = key
        self.subkey = subkey
        self.device = device
        self.hcabytes: bytes = b""
        self._raw = raw
        self.encrypted = False
        self.filetype = ""
        self.hca: dict = {}
        self.looping = False
        # drop-in attributes reference users reach for (hca.py:55-75):
        # two independent cursors over the input and empty cipher tables
        self.stream = io.BytesIO(raw)
        self.hcastream = io.BytesIO(raw)
        self.enc_table = b""
        self.table = b""
        self._parse()

    # -- parsing ------------------------------------------------------------

    def _parse(self) -> None:
        raw = self._hca_buffer()
        sig = raw[:4] if len(raw) >= 4 else b""
        masked = bytes(b & 0x7F for b in sig)
        self.HcaSig = sig
        if masked == b"HCA\x00":
            self.filetype = "hca"
            self.encrypted = sig != b"HCA\x00"
            if self.encrypted and not self.key:
                self.key = DEFAULT_KEY
            if self.key < 0:
                raise ValueError("HCA key cannot be a negative.")
            if self.key > 0xFFFFFFFFFFFFFFFF:
                raise OverflowError(
                    "HCA key cannot exceed the maximum size of 8 bytes.")
            if self.subkey < 0:
                raise ValueError("HCA subkey cannot be a negative.")
            if self.subkey > 0xFFFF:
                raise OverflowError("HCA subkey cannot exceed 65535.")
            self.version = int.from_bytes(raw[4:6], "big")
            self.header_size = int.from_bytes(raw[6:8], "big")
            info = hca_frame.parse_header(raw[:self.header_size])
            if info.ciph_type == 1:
                self.encrypted = True
            self._info = info
            self.hca = dict(
                Encrypted=self.encrypted,
                Header=sig,
                version=hex(self.version),
                HeaderSize=self.header_size,
                ChannelCount=info.channels,
                SampleRate=info.sample_rate,
                FrameCount=info.frame_count,
                EncoderDelay=info.encoder_delay,
                EncoderPadding=info.encoder_padding,
                FrameSize=info.frame_size,
                MinResolution=info.min_resolution,
                MaxResolution=info.max_resolution,
                TrackCount=info.track_count,
                ChannelConfig=info.channel_config,
                TotalBandCount=info.total_band_count,
                BaseBandCount=info.base_band_count,
                StereoBandCount=info.stereo_band_count,
                BandsPerHfrGroup=info.bands_per_hfr_group,
                CipherType=info.ciph_type,
            )
            if info.loop_flag:
                self.looping = True
                self.hca.update(dict(
                    LoopStart=info.loop_start_frame,
                    LoopEnd=info.loop_end_frame,
                    LoopStartDelay=info.loop_start_delay,
                    LoopEndPadding=info.loop_end_padding,
                ))
        elif sig == b"RIFF":
            self.filetype = "wav"
            self._wav = wavmod.parse_wav(raw)
            self.looping = self._wav.looping
            # drop-in header attributes (the reference unpacks the fused
            # RIFF+fmt WavHeaderStruct, hca.py:197-232; version/header_size
            # come from reading bytes 4..8 as an HCA header even for WAVs)
            self.version = int.from_bytes(raw[4:6], "big")
            self.header_size = int.from_bytes(raw[6:8], "big")
            w = self._wav
            try:
                (self.riffSignature, self.riffSize, self.wave, self.fmt,
                 self.fmtSize, self.fmtType, self.fmtChannelCount,
                 self.fmtSamplingRate, self.fmtSamplesPerSec,
                 self.fmtSamplingSize, self.fmtBitCount) = \
                    WavHeaderStruct.unpack(raw[:WavHeaderStruct.size])
                if (self.wave, self.fmt) != (b"WAVE", b"fmt "):
                    raise ValueError
            except Exception:
                # fmt not at the canonical offset: fill from the real parser
                self.riffSignature, self.riffSize = b"RIFF", len(raw) - 8
                self.wave, self.fmt = b"WAVE", b"fmt "
                self.fmtSize, self.fmtType = 16, w.compression
                self.fmtChannelCount = w.channels
                self.fmtSamplingRate = w.sample_rate
                self.fmtSamplesPerSec = w.sample_rate * w.channels * 2
                self.fmtSamplingSize = w.channels * 2
                self.fmtBitCount = w.bit_depth
            self.dataSig = b"data"
            self.dataSize = w.num_samples * 2
            if w.looping:
                self.LoopCount = 1
                self.LoopStartSample = w.loop_start
                self.LoopEndSample = w.loop_end
        else:
            raise ValueError("Invalid HCA or WAV file.")

    def _hca_buffer(self) -> bytes:
        return self.hcabytes if self.hcabytes else self._raw

    # -- public API ---------------------------------------------------------

    def Pyparse_header(self) -> None:
        """Drop-in alias for the reference's header (re)parse (hca.py:78)."""
        return self._parse()

    def info(self) -> dict:
        if self.filetype == "hca":
            return self.hca
        # same key set as the reference's WAV info() (hca.py:243-245)
        return dict(RiffSignature=self.riffSignature.decode(),
                    riffSize=self.riffSize,
                    WaveSignature=self.wave.decode(),
                    fmtSignature=self.fmt.decode(), fmtSize=self.fmtSize,
                    fmtType=self.fmtType,
                    fmtChannelCount=self.fmtChannelCount,
                    fmtSamplingRate=self.fmtSamplingRate,
                    fmtSamplesPerSec=self.fmtSamplesPerSec,
                    fmtSamplingSize=self.fmtSamplingSize,
                    fmtBitCount=self.fmtBitCount,
                    dataSignature=self.dataSig.decode(),
                    dataSize=self.dataSize)

    def decode(self) -> bytes:
        if self.filetype == "wav":
            raise ValueError("Input type for decoding must be an HCA file.")
        return decode(self._hca_buffer(), key=self.key, subkey=self.subkey,
                      device=self.device)

    def encode(self, force_not_looping: bool = False, encrypt: bool = False,
               keyless: bool = False, quality_level=None) -> bytes:
        from ..parallel import pipeline

        if self.filetype == "hca":
            raise ValueError("Input type for encoding must be a WAV file.")
        if quality_level is None:
            quality_level = CriHcaQuality.High
        if quality_level not in list(CriHcaQuality):
            raise ValueError("Chosen quality level is not valid or is not the "
                             "appropiate enumeration value.")
        self.hcabytes = pipeline.hca_encode_batch(
            [self._raw], quality=quality_level.value,
            force_not_looping=bool(force_not_looping),
            device=self.device)[0]
        self.filetype = "hca"
        self.encrypted = False
        self._parse()
        if encrypt:
            if self.key == 0 and not keyless:
                self.key = DEFAULT_KEY
            # the reference passes `keyless` into the subkey slot here
            # (hca.py:273); the JAX package and the port call with keywords
            self.encrypt(self.key, keyless=keyless)
        return self.get_hca()

    def encrypt(self, keycode: int = None, subkey: int = 0,
                keyless: bool = False) -> None:
        if self.encrypted:
            raise ValueError("HCA is already encrypted.")
        if keycode is None:
            keycode = self.key or DEFAULT_KEY
        self.encrypted = True
        self.hcabytes = crypt(self._hca_buffer(), True, self.header_size,
                              1 if keyless else 56, keycode, subkey)
        self._parse()

    def decrypt(self, keycode: int = None, subkey: int = 0) -> None:
        if not self.encrypted:
            raise ValueError("HCA is already decrypted.")
        if keycode is None:
            keycode = self.key or DEFAULT_KEY
        self.encrypted = False
        self.hcabytes = crypt(self._hca_buffer(), False, self.header_size,
                              0, keycode, subkey)
        self._parse()

    def get_hca(self) -> bytes:
        return self._hca_buffer()

    def get_header(self) -> bytes:
        return self._hca_buffer()[:self.header_size]

    def get_frames(self):
        buf = self._hca_buffer()
        fs = self.hca["FrameSize"]
        for i in range(self.hca["FrameCount"]):
            off = self.header_size + i * fs
            yield (i, buf[off:off + fs])
