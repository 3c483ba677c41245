"""Shared inputs for the PyTorch port's parity tests (tests/test_torch_*.py).

Streams come from the JAX package's host encoders on seeded numpy signals;
the committed fixtures live in tests/data/torch_port/ (HCA) and
tests/data/torch_port/adx/ (ADX). The port runs on the CPU here, so every
kernel call takes its plain PyTorch twin.
"""
import dataclasses
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
