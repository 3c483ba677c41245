#!/usr/bin/env python3
"""Write the HCA fixtures that carry real streams to the PyTorch port's GPU
check (chip_smoke.py), where neither JAX nor the encoder is installed.

Encodes with the JAX package's host encoder (pycricodecs_tpu.ops.
hca_encode_host.encode) and records, in expected.json, the sha256 of the WAV
that pycricodecs_tpu.parallel.decode_batch makes of each stream (its host
and device engines agree, which this script checks).

- bank_q2_stereo_48k_10s.hca: the bench.py stream (10 s stereo 48 kHz, the
  440 Hz + 991 Hz + noise signal, right channel delayed 480 samples),
  quality 2: the BASELINE config-5 bank member.
- 1 s streams covering the other transform branches: q4 stereo (intensity
  pair + HFR), q2 mono (HFR, no pair), q0 stereo (discrete pair) and q2
  6-channel (two pairs, two unpaired channels).

Usage: python3 tools/make_torch_port_fixtures.py
"""
import hashlib
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIR = os.path.join(ROOT, "tests", "data", "torch_port")
SAMPLE_RATE = 48000

# name -> (channels, seconds, quality)
STREAMS = {
    "bank_q2_stereo_48k_10s": (2, 10.0, 2),
    "q4_stereo_48k_1s": (2, 1.0, 4),
    "q2_mono_48k_1s": (1, 1.0, 2),
    "q0_stereo_48k_1s": (2, 1.0, 0),
    "q2_6ch_48k_1s": (6, 1.0, 2),
}


def signal(channels: int, seconds: float) -> np.ndarray:
    """bench.py's test signal (seed 0), channel c delayed by 480*c samples;
    interleaved PCM16."""
    samples = int(SAMPLE_RATE * seconds)
    rng = np.random.default_rng(0)
    t = np.arange(samples) / SAMPLE_RATE
    sig = (0.4 * np.sin(2 * np.pi * 440 * t)
           + 0.1 * np.sin(2 * np.pi * 991 * t)
           + 0.02 * rng.standard_normal(samples))
    pcm = np.clip(sig * 32767, -32768, 32767).astype(np.int16)
    return np.stack([np.roll(pcm, 480 * c) for c in range(channels)],
                    1).reshape(-1)


def make_streams() -> dict:
    """name -> HCA bytes, encoded by the JAX package's host encoder."""
    sys.path.insert(0, ROOT)
    from pycricodecs_tpu.ops import hca_encode_host
    from pycricodecs_tpu.utils.wav import write_wav

    out = {}
    for name, (channels, seconds, quality) in STREAMS.items():
        wav = write_wav(signal(channels, seconds), channels, SAMPLE_RATE)
        out[name] = hca_encode_host.encode(wav, quality=quality)
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
    os.makedirs(OUT_DIR, exist_ok=True)
    expected = {}
    for name, blob in make_streams().items():
        with open(os.path.join(OUT_DIR, name + ".hca"), "wb") as f:
            f.write(blob)
        sha = reference_sha256(blob, "host")
        if reference_sha256(blob, "device") != sha:
            raise SystemExit(f"{name}: host and device engines disagree")
        channels, seconds, quality = STREAMS[name]
        expected[name] = {"channels": channels, "seconds": seconds,
                          "quality": quality, "wav_sha256": sha}
        print(name, len(blob), sha)
    with open(os.path.join(OUT_DIR, "expected.json"), "w") as f:
        json.dump(expected, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
