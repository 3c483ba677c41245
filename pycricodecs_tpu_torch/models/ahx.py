"""AHX container: MPEG Layer II audio in an ADX-style CRI header.

A copy of the container half of pycricodecs_tpu/models/ahx.py
(`AHX_TYPES`, `CRI_STRING`, `ahx_container`, `AHX.parse_header`) and of
the AHX rule of pycricodecs_tpu/utils/sniff.py; tests hold them equal.
`encode_mp2` is the JAX encode_mp2's f64 host lane (its default), byte for
byte, run by ops/mp2_encode_device.py on `device`; `decode_mp2` is the JAX
decode_mp2's f64 host lane (device=False), kernels B10 and `mp2_synth` on
`device`. The `AHX` class is the
single-file surface (parse_header, decode, encode, info): decode and
encode run the batch paths of parallel/pipeline.py and
ops/mp2_encode_device.py on `device`; decode, like the JAX package's
AHX.decode, zero-fills a stream whose frames hold fewer samples than its
header declares (ahx_decode_batch trims).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops import mp2_frame
from ..ops import mp2_tables
from ..utils.device import as_device

CRI_STRING = b"(c)CRI"
AHX_TYPES = (0x10, 0x11)


def ahx_container(stream: bytes, sample_rate: int, n_samples: int,
                  AhxVersion: int = 0x11) -> bytes:
    """Wrap a mono MPEG-2 LSF Layer II stream in the AHX (ADX-style)
    container (header layout mirrored by parse_header)."""
    header = bytearray(0x24)
    header[0:2] = b"\x80\x00"
    header[2:4] = (0x20).to_bytes(2, "big")     # data at 0x24
    header[4] = AhxVersion
    header[5] = 0                               # block size
    header[6] = 0                               # bit depth
    header[7] = 1                               # channels
    header[8:12] = sample_rate.to_bytes(4, "big")
    header[12:16] = n_samples.to_bytes(4, "big")
    header[16:18] = b"\x00\x00"                 # highpass
    header[18] = 0x06                           # AHX header version tag
    header[19] = 0x00                           # flags
    header[0x1E:0x24] = CRI_STRING
    footer = b"\x80\x01\x00\x0c" + b"AHXE(c)CRI\x00\x00"
    return bytes(header) + stream + footer


def decode_mp2(data: bytes, offset: int = 0, *, device="cuda",
               max_frames: Optional[int] = None):
    """Decode consecutive MPEG Layer II frames from `offset` on `device` ->
    (int16 [C, frames * 1152], sample_rate): pycricodecs_tpu.models.ahx.
    decode_mp2(data, offset, device=False, max_frames=max_frames)'s
    samples (its f64 host lane), untrimmed.

    The walk stops at the end of the data, a sync loss, a config change or
    an incomplete frame (mp2_frame.scan_frames); no complete frame raises
    ValueError, and so does a frame whose fields run past its end. Kernel
    B10 unpacks every frame, the synthesis kernel `mp2_synth` makes the
    PCM."""
    from ..ops import mp2_kernels, mp2_unpack_device
    from ..parallel import pipeline
    data = bytes(data)
    hdr0, walk = mp2_frame.scan_frames(data, offset, max_frames)
    C = hdr0.nch
    frames_np = pipeline._stack_mp2_frames([walk])
    _, F, fs_max = frames_np.shape
    frames = torch.from_numpy(frames_np).to(as_device(device))
    codes, levels, sfidx, err = mp2_unpack_device.mp2_unpack(
        frames.view(F, fs_max), C)
    pcm = mp2_kernels.mp2_decode_pcm(
        codes.view(1, F, C, 36, 32), levels.view(1, F, C, 32),
        sfidx.view(1, F, C, 3, 32))
    if bool(err.any()):
        raise ValueError("Layer II frame truncated mid-field.")
    return pcm[0].cpu().numpy(), hdr0.sample_rate


def encode_mp2(pcm, sample_rate: int, bitrate_kbps: Optional[int] = None,
               *, joint_bound: Optional[int] = None,
               device="cuda") -> bytes:
    """Encode int16 PCM ([N] mono or [C, N]) to MPEG Layer II on `device`:
    the bytes of pycricodecs_tpu.models.ahx.encode_mp2(pcm, sample_rate,
    bitrate_kbps, joint_bound=joint_bound) (its f64 host lane).

    joint_bound is keyword-only: the JAX function's fourth parameter is
    `device`, its bool choice between the f64 host lane and an f32 device
    lane whose bytes differ on some inputs, and a JAX call that passes it
    by position raises TypeError here (by keyword too: `device` is the
    torch device).

    MPEG-2 LSF for 16/22.05/24 kHz, MPEG-1 for 32/44.1/48 kHz; stereo as
    independent channels (mode 0) or, with joint_bound in {4, 8, 12, 16},
    joint (intensity) stereo; CBR with the standard padding-slot
    accumulator; greedy max-(SMR - SNR) allocation."""
    from ..ops import mp2_encode_device, mp2_encode_host
    pcm = np.asarray(pcm, dtype=np.int16)
    if pcm.ndim == 1:
        pcm = pcm[None, :]
    C, N = pcm.shape
    cfg = mp2_encode_host.configure(C, sample_rate, bitrate_kbps,
                                    joint_bound)
    if N == 0:
        raise ValueError(mp2_encode_host.EMPTY_STREAM)
    F = -(-N // mp2_frame.SAMPLES_PER_FRAME)
    x = np.zeros((1, C, F * mp2_frame.SAMPLES_PER_FRAME), np.int16)
    x[0, :, :N] = pcm
    return mp2_encode_device.encode_streams(
        torch.from_numpy(x).to(as_device(device)), cfg)[0]


def is_ahx(data: bytes) -> bool:
    """sniff(data) == "ahx": the ADX magic byte with an AHX encoding type."""
    return data[:1] == b"\x80" and len(data) > 4 and data[4] in AHX_TYPES


def parse_header(data: bytes) -> dict:
    """AHX.parse_header: data offset, type, channels, sample rate and total
    samples of an AHX header; ValueError if it is not one."""
    if len(data) < 0x18 or data[0] != 0x80 or data[1] != 0x00:
        raise ValueError("Invalid AHX file header.")
    data_offset = int.from_bytes(data[2:4], "big") + 4
    enc_type = data[4]
    if enc_type not in AHX_TYPES:
        raise ValueError("Not an AHX stream (ADX encoding type "
                         f"0x{enc_type:02x}).")
    channels = data[7]
    sample_rate = int.from_bytes(data[8:12], "big")
    total_samples = int.from_bytes(data[12:16], "big")
    if data_offset >= 12 and CRI_STRING not in data[:data_offset]:
        raise ValueError("CRI copyright string not found in AHX header.")
    return dict(data_offset=data_offset, type=enc_type,
                channels=channels, sample_rate=sample_rate,
                total_samples=total_samples)


def _read(data) -> bytes:
    if isinstance(data, str):
        with open(data, "rb") as fh:
            return fh.read()
    return bytes(data)


class AHX:
    """AHX (ADX-container MPEG-2 Layer II) decoder and encoder, the drop-in
    shape of the JAX package's AHX."""

    parse_header = staticmethod(parse_header)

    @staticmethod
    def decode(data, *, device="cuda") -> bytes:
        """AHX -> WAV (PCM16) on `device`: pycricodecs_tpu.models.ahx.
        AHX.decode's bytes (zero-filled to the declared sample count)."""
        from ..parallel import pipeline
        data = _read(data)
        parse_header(data)
        return pipeline._ahx_decode([data], as_device(device), "raise",
                                    zero_fill=True)[0]

    @staticmethod
    def encode(data, bitrate_kbps: Optional[int] = None,
               AhxVersion: int = 0x11, *, device="cuda") -> bytes:
        """WAV -> AHX on `device`: pycricodecs_tpu.models.ahx.AHX.encode's
        bytes. Input must be mono at an MPEG-2 LSF rate
        (16000/22050/24000 Hz); resample upstream if needed."""
        from ..utils import wav as wavmod
        wf = wavmod.parse_wav(_read(data))
        if wf.channels != 1:
            raise ValueError("AHX is mono; got "
                             f"{wf.channels} channels.")
        if wf.sample_rate not in mp2_tables.SAMPLE_RATES_V2:
            raise ValueError("AHX requires an MPEG-2 LSF sample rate "
                             f"(16000/22050/24000), got {wf.sample_rate}.")
        if AhxVersion not in AHX_TYPES:
            raise ValueError("AhxVersion must be 0x10 or 0x11.")
        pcm = wf.pcm16
        stream = encode_mp2(pcm, wf.sample_rate, bitrate_kbps, device=device)
        return ahx_container(stream, wf.sample_rate, len(pcm), AhxVersion)

    @staticmethod
    def info(data) -> dict:
        data = _read(data)
        info = parse_header(data)
        hdr = mp2_frame.parse_header(data, info["data_offset"])
        info.update(bitrate=hdr.bitrate, mpeg_version=hdr.version,
                    frame_size=hdr.frame_size, mode=hdr.mode)
        return info
