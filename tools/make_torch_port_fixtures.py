#!/usr/bin/env python3
"""Write the HCA and ADX fixtures that carry real streams to the PyTorch
port's GPU check (chip_smoke.py), where neither JAX nor the encoder is
installed.

HCA (tests/data/torch_port/):

Encodes a WAV rebuilt by hca_wav() of pycricodecs_tpu_torch/utils/signals.py
with the JAX package's host encoder (pycricodecs_tpu.ops.hca_encode_host.
encode; its batched device encoder, parallel.hca_encode_batch(...,
device=True), agrees, which this script checks) and records, in
expected.json, the sha256 of the input WAV, of the HCA stream and of the WAV
that pycricodecs_tpu.parallel.decode_batch makes of it (its host and device
engines agree, which this script checks).

- bank_q2_stereo_48k_10s.hca: the bench.py stream (10 s stereo 48 kHz, the
  440 Hz + 991 Hz + noise signal, right channel delayed 480 samples),
  quality 2: the BASELINE config-5 bank member.
- 1 s streams covering the other transform branches: q4 stereo (intensity
  pair + HFR), q2 mono (HFR, no pair), q0 stereo (discrete pair), q2
  6-channel (two pairs, two unpaired channels) and a looping q2 stereo WAV
  (smpl loop 4000-40000: the loop chunk, the header padding and the
  replayed loop region of the encoder).

ADX (tests/data/torch_port/adx/, with its own expected.json): each stream is
pycricodecs_tpu.models.adx.encode of a WAV rebuilt by adx_wav() of
pycricodecs_tpu_torch/utils/signals.py (numpy only, so chip_smoke.py
rebuilds the same WAVs without JAX), and expected.json records per stream the encode keywords, the sha256 of the
input WAV, of the ADX (the JAX package's encode; its batch encoder agrees,
which this script checks) and of the WAV the JAX package decodes from it
(its device pipeline and its host decoder agree, which this script checks).
- adx_m3_bd4_stereo_48k_10s: the bench signal, default keywords (mode 3,
  4-bit, block 0x12, version 4): the bank member of bench_all configs 13/16;
- 1 s streams for the other branches: mode 2 (filter 2), mode 4, bit depth
  8, bit depth 5 at block 12, bit depth 2 at block 0xFF (1012 samples per
  block), versions 3 and 5, a looping stereo WAV (smpl chunk) and 6
  channels.
Every signal starts with 1024 silent samples, so the first block has a zero
scale word and the stream passes the decoders' strict 7-byte CRI signature
check (adx.cpp:345-348) at every geometry; without it the bench signal's
first scale word has a nonzero high byte and every decoder refuses it.

Usage: python3 tools/make_torch_port_fixtures.py
"""
import hashlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from pycricodecs_tpu_torch.utils.signals import (  # noqa: E402
    ADX_STREAMS, HCA_STREAMS, adx_wav, hca_wav)

OUT_DIR = os.path.join(ROOT, "tests", "data", "torch_port")
ADX_DIR = os.path.join(OUT_DIR, "adx")


def make_adx_streams() -> dict:
    """name -> (input WAV bytes, ADX bytes of the JAX package's encode)."""
    from pycricodecs_tpu.models import adx
    from pycricodecs_tpu.utils.wav import write_wav

    out = {}
    for name, (_, _, _, kw) in ADX_STREAMS.items():
        wav = adx_wav(name, write_wav)
        out[name] = (wav, adx.encode(wav, **kw))
    return out


def make_streams() -> dict:
    """name -> (input WAV bytes, HCA bytes of the JAX package's host
    encoder)."""
    from pycricodecs_tpu.ops import hca_encode_host
    from pycricodecs_tpu.utils.wav import write_wav

    out = {}
    for name, (_, _, quality, _) in HCA_STREAMS.items():
        wav = hca_wav(name, write_wav)
        out[name] = (wav, hca_encode_host.encode(wav, quality=quality))
    return out


def reference_sha256(blob: bytes, engine: str) -> str:
    """sha256 of the JAX package's WAV of one stream."""
    from pycricodecs_tpu import parallel
    return hashlib.sha256(
        parallel.decode_batch([blob], engine=engine)[0]).hexdigest()


def main() -> None:
    # CPU JAX without FMA contraction: the device engine is then bit-exact
    # with the host engine (as tests/conftest.py sets up)
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_cpu_max_isa=SSE4_2").strip()
    import jax
    jax.config.update("jax_platforms", "cpu")
    from pycricodecs_tpu import parallel

    os.makedirs(OUT_DIR, exist_ok=True)
    expected = {}
    for name, (wav, blob) in make_streams().items():
        channels, seconds, quality, loop = HCA_STREAMS[name]
        if parallel.hca_encode_batch([wav], quality=quality,
                                     device=True)[0] != blob:
            raise SystemExit(f"{name}: batch and host encoders disagree")
        with open(os.path.join(OUT_DIR, name + ".hca"), "wb") as f:
            f.write(blob)
        sha = reference_sha256(blob, "host")
        if reference_sha256(blob, "device") != sha:
            raise SystemExit(f"{name}: host and device engines disagree")
        expected[name] = {"channels": channels, "seconds": seconds,
                          "quality": quality, "loop": loop,
                          "wav_in_sha256": sha256(wav),
                          "hca_sha256": sha256(blob), "wav_sha256": sha}
        print(name, len(blob), sha)
    with open(os.path.join(OUT_DIR, "expected.json"), "w") as f:
        json.dump(expected, f, indent=1, sort_keys=True)
        f.write("\n")
    write_adx_fixtures()


def sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def write_adx_fixtures() -> None:
    from pycricodecs_tpu import parallel
    from pycricodecs_tpu.models import adx

    os.makedirs(ADX_DIR, exist_ok=True)
    expected = {}
    for name, (wav, blob) in make_adx_streams().items():
        channels, seconds, loop, kw = ADX_STREAMS[name]
        if parallel.adx_encode_batch([wav], device=True, **kw)[0] != blob:
            raise SystemExit(f"{name}: batch and single encoders disagree")
        dec = adx.decode(blob)
        if parallel.adx_decode_batch([blob], device=True)[0] != dec:
            raise SystemExit(f"{name}: device and host decoders disagree")
        with open(os.path.join(ADX_DIR, name + ".adx"), "wb") as f:
            f.write(blob)
        expected[name] = {"channels": channels, "seconds": seconds,
                          "loop": loop, "encode": kw,
                          "wav_in_sha256": sha256(wav),
                          "adx_sha256": sha256(blob),
                          "wav_sha256": sha256(dec)}
        print(name, len(blob), sha256(blob))
    with open(os.path.join(ADX_DIR, "expected.json"), "w") as f:
        json.dump(expected, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
