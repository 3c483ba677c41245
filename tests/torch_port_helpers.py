"""Shared inputs for the PyTorch port's parity tests (tests/test_torch_*.py).

Streams come from the JAX package's host encoders on seeded numpy signals;
the committed fixtures live in tests/data/torch_port/ (HCA) and
tests/data/torch_port/adx/ (ADX). The port runs on the CPU here, so every
kernel call takes its plain PyTorch twin.
"""
import dataclasses
import hashlib
import json
import os

import numpy as np
import torch

from pycricodecs_tpu.ops import hca_encode_host
from pycricodecs_tpu.ops import hca_frame as jax_frame
from pycricodecs_tpu.utils.wav import write_wav
from pycricodecs_tpu_torch.ops import hca_frame as port_frame
from tests.conftest import make_sine_pcm16

# small tensors: one intra-op thread per xdist worker is enough
torch.set_num_threads(1)

FIXTURE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "data", "torch_port")
KEY = 0xCF222F1FE0748978


def encode(channels=2, quality=2, seed=5, samples=12000, key=0,
           loop=None) -> bytes:
    """HCA v2.0 stream of a seeded sine+noise signal; `key` enciphers it
    (cipher type 56), `loop` = (start, end) sample loop points."""
    pcm = make_sine_pcm16(samples, channels, 48000, seed=seed)
    if loop is None:
        wav = write_wav(pcm, channels, 48000)
    else:
        wav = write_wav(pcm, channels, 48000, looping=True,
                        loop_start=loop[0], loop_end=loop[1])
    blob = hca_encode_host.encode(wav, quality=quality)
    if key:
        from pycricodecs_tpu.models import hca as hcamod
        h = hcamod.HCA(blob)
        h.encrypt(key)
        blob = h.get_hca()
    return blob


def header_size(blob: bytes) -> int:
    return int.from_bytes(blob[6:8], "big")


def parse_both(blob: bytes, key: int = 0):
    """(JAX HcaInfo, port HcaInfo) of a stream, keyed alike."""
    hs = header_size(blob)
    ji = jax_frame.parse_header(blob[:hs])
    pi = port_frame.parse_header(blob[:hs])
    if key:
        ji.set_key(key)
        pi.set_key(key)
    return ji, pi


def frames_of(blob: bytes, info) -> np.ndarray:
    """uint8 [frame_count, frame_size] frame bytes of a stream."""
    hs = header_size(blob)
    n = info.frame_count
    return np.frombuffer(blob, np.uint8, count=n * info.frame_size,
                         offset=hs).reshape(n, info.frame_size)


def assert_info_equal(got, ref) -> None:
    """Every HcaInfo field equal, arrays by value and dtype."""
    g, r = dataclasses.asdict(got), dataclasses.asdict(ref)
    assert g.keys() == r.keys()
    for name in r:
        if isinstance(r[name], np.ndarray):
            assert g[name].dtype == r[name].dtype, name
            np.testing.assert_array_equal(g[name], r[name], err_msg=name)
        else:
            assert g[name] == r[name], name


def repack_stream(blob: bytes, header: bytes = None,
                  zero_secondary: bool = False) -> bytes:
    """A plain stream's frames re-packed by the JAX package's
    hca_frame.pack_frame from their own unpack (the host reference), under
    `header` (default: the stream's own): level and boundary, scalefactors
    under each channel's own delta bits (bits 32-34 of the frame are the
    first channel's; a mono stream has no other), HFR scales, intensities
    and spectra. Each frame then ends in zero padding right after its last
    code, so the key test accepts it. zero_secondary: channel 1 is a stereo
    secondary re-packed with coded_count 0 under delta bits 3, i.e. with
    only the one 6-bit value the reader puts in sf[0]."""
    hs = header_size(blob)
    ji = jax_frame.parse_header(blob[:hs])
    assert ji.ciph_type == 0 and (ji.channels == 1 or zero_secondary)
    header = bytes(blob[:hs]) if header is None else bytes(header)
    ni = jax_frame.parse_header(header)
    fs, G = ji.frame_size, ji.hfr_group_count
    data = blob[hs:hs + ji.frame_count * fs]
    un = jax_frame._unpack_frames_py(ji, data)
    out = [header]
    for f in range(ji.frame_count):
        frame = data[f * fs:(f + 1) * fs]
        sf = un.scalefactors[f].copy()
        res = un.resolutions[f].copy()
        delta_bits = [frame[4] >> 5] * ji.channels
        if zero_secondary:
            sf[1, :] = 0
            sf[1, 0] = 1 + (f * 7) % 63
            res[1, :] = 0
            delta_bits[1] = 3
        out.append(jax_frame.pack_frame(
            ni, (frame[2] << 1) | (frame[3] >> 7), frame[3] & 0x7F, sf, res,
            un.intensity[f], sf[:, 128 - G:], delta_bits, un.qc[f]))
    return b"".join(out)


def zero_coded_stream(blob: bytes) -> bytes:
    """A v2.0 stereo stream whose secondary channel has coded_count 0,
    built from a plain v2.0 intensity-pair stream `blob`: its comp chunk
    edited to base_band_count 0 and stereo_band_count base + stereo (so the
    primary keeps its coded count and the intensity pair covers every band
    below total_band_count), the header CRC recomputed, and every frame
    re-packed (repack_stream with zero_secondary)."""
    from pycricodecs_tpu.utils.crc import crc16
    hs = header_size(blob)
    ji = jax_frame.parse_header(blob[:hs])
    assert ji.version == 0x0200 and list(ji.channel_type) == [1, 2]
    head = bytearray(blob[:hs])
    assert head[24:28] == b"comp"
    head[36] += head[35]                  # stereo_band_count += base
    head[35] = 0                          # base_band_count = 0
    head[hs - 2:hs] = crc16(bytes(head[:hs - 2])).to_bytes(2, "big")
    ni = jax_frame.parse_header(bytes(head))
    assert list(ni.coded_count) == [int(ji.coded_count[0]), 0]
    return repack_stream(blob, bytes(head), zero_secondary=True)


def load_fixtures():
    """(expected.json dict, name -> HCA bytes) of the committed fixtures."""
    with open(os.path.join(FIXTURE_DIR, "expected.json")) as f:
        expected = json.load(f)
    blobs = {}
    for name in expected:
        with open(os.path.join(FIXTURE_DIR, name + ".hca"), "rb") as f:
            blobs[name] = f.read()
    return expected, blobs


ADX_FIXTURE_DIR = os.path.join(FIXTURE_DIR, "adx")


def wav(samples=4000, channels=2, rate=48000, seed=0, lead_in=64,
        loop=None) -> bytes:
    """PCM16 WAV of a seeded sine+noise signal whose first `lead_in`
    samples are silent (so an ADX encode of it passes the decoders' strict
    CRI signature check); `loop` = (start, end) adds a smpl chunk."""
    pcm = make_sine_pcm16(samples, channels, rate, seed=seed)
    pcm[:lead_in * channels] = 0
    if loop is None:
        return write_wav(pcm, channels, rate)
    return write_wav(pcm, channels, rate, looping=True, loop_start=loop[0],
                     loop_end=loop[1])


AHX_FIXTURE_DIR = os.path.join(FIXTURE_DIR, "ahx")


def load_ahx_fixtures():
    """(ahx/expected.json dict, name -> AHX or bare Layer II bytes)."""
    with open(os.path.join(AHX_FIXTURE_DIR, "expected.json")) as f:
        expected = json.load(f)
    blobs = {}
    for name, e in expected.items():
        with open(os.path.join(AHX_FIXTURE_DIR, e["file"]), "rb") as f:
            blobs[name] = f.read()
    return expected, blobs


def mp2_offset(blob: bytes) -> int:
    """Where the Layer II frames of an AHX or bare stream start."""
    from pycricodecs_tpu.models.ahx import AHX
    return AHX.parse_header(blob)["data_offset"] if blob[:1] == b"\x80" \
        else 0


def load_adx_fixtures():
    """(adx/expected.json dict, name -> ADX bytes) of the ADX fixtures."""
    with open(os.path.join(ADX_FIXTURE_DIR, "expected.json")) as f:
        expected = json.load(f)
    blobs = {}
    for name in expected:
        with open(os.path.join(ADX_FIXTURE_DIR, name + ".adx"), "rb") as f:
            blobs[name] = f.read()
    return expected, blobs


def load_fixture(name: str) -> bytes:
    """One committed HCA fixture's bytes."""
    with open(os.path.join(FIXTURE_DIR, name + ".hca"), "rb") as f:
        return f.read()


BANK_FIXTURE_DIR = os.path.join(FIXTURE_DIR, "bank")


def load_bank_fixtures():
    """(bank/expected.json dict, entry -> file bytes) of the bank fixtures
    (mixed.acb, subkey.awb, bank.acb)."""
    with open(os.path.join(BANK_FIXTURE_DIR, "expected.json")) as f:
        expected = json.load(f)
    blobs = {}
    for name, e in expected.items():
        with open(os.path.join(BANK_FIXTURE_DIR, e["file"]), "rb") as f:
            blobs[name] = f.read()
    return expected, blobs


def outcome(fn, *args, **kw):
    """fn's result, or (exception type name, message) if it raised."""
    try:
        return fn(*args, **kw)
    except Exception as exc:      # compared, not swallowed
        return type(exc).__name__, str(exc)


def sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()
