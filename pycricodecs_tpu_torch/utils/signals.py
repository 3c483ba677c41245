"""The deterministic test signals behind the port's fixtures (numpy only).

tools/make_torch_port_fixtures.py encodes these signals with the JAX
package to write tests/data/torch_port/; chip_smoke.py rebuilds the HCA and
ADX input WAVs from the same recipe on the GPU machine, which has no JAX,
and holds them to the hashes recorded there. The AHX fixtures are only
decoded there, so their signals (ahx_bank_pcm, tones) serve the fixture
tool and its regeneration test.
"""
from __future__ import annotations

import numpy as np

SAMPLE_RATE = 48000


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


HCA_BANK = "bank_q2_stereo_48k_10s"
# name -> (channels, seconds, quality, loop (start, end) or None)
HCA_STREAMS = {
    HCA_BANK: (2, 10.0, 2, None),
    "q4_stereo_48k_1s": (2, 1.0, 4, None),
    "q2_mono_48k_1s": (1, 1.0, 2, None),
    "q0_stereo_48k_1s": (2, 1.0, 0, None),
    "q2_6ch_48k_1s": (6, 1.0, 2, None),
    "q2_loop_stereo_48k_1s": (2, 1.0, 2, (4000, 40000)),
}


def hca_wav(name: str, write_wav) -> bytes:
    """The input WAV of an HCA fixture, from signal(); `write_wav` is the
    JAX package's or the port's (they are equal)."""
    channels, seconds, _, loop = HCA_STREAMS[name]
    pcm = signal(channels, seconds)
    if loop is None:
        return write_wav(pcm, channels, SAMPLE_RATE)
    return write_wav(pcm, channels, SAMPLE_RATE, looping=True,
                     loop_start=loop[0], loop_end=loop[1])


HCA_PNS = "pns_v3_mono_48k_1s"


def pns_wav(write_wav) -> bytes:
    """The input WAV of the v3 PNS fixture: bench.py's two tones without the
    noise, mono, 1 s. Their spectral leakage leaves small nonzero
    scalefactors in the high bands, which a v3 decode with min_resolution 0
    PNS-fills (the bench signal's noise floor leaves none)."""
    t = np.arange(SAMPLE_RATE) / SAMPLE_RATE
    sig = 0.4 * np.sin(2 * np.pi * 440 * t) + 0.1 * np.sin(2 * np.pi * 991 * t)
    pcm = np.clip(sig * 32767, -32768, 32767).astype(np.int16)
    return write_wav(pcm, 1, SAMPLE_RATE)


AHX_BANK = "ahx_bank_lsf_mono_22k_96k_10s"


def ahx_bank_pcm() -> np.ndarray:
    """bench_all.py's AHX bank signal (configs 8 and 11: _sine_wav(10, 1,
    sr=22050, seed=8)): mono PCM16 at 22,050 Hz, 10 s."""
    rate = 22050
    n = rate * 10
    rng = np.random.default_rng(8)
    t = np.arange(n) / rate
    sig = (0.4 * np.sin(2 * np.pi * 440 * t)
           + 0.1 * np.sin(2 * np.pi * 991 * t)
           + 0.02 * rng.standard_normal(n))
    return np.clip(sig * 4000, -32768, 32767).astype(np.int16)


def tones(seconds: float, channels: int, rate: int, seed: int) -> np.ndarray:
    """Three tones and noise, PCM16 [channels, n] (the signal of the JAX
    package's Layer II unpack tests)."""
    n = int(rate * seconds)
    t = np.arange(n) / rate
    rng = np.random.default_rng(seed)
    base = sum(a * np.sin(2 * np.pi * f * t + rng.uniform(0, 6))
               for f, a in ((197, 0.3), (1201, 0.2), (3333, 0.1)))
    base = base + 0.03 * rng.standard_normal(n)
    pcm = np.stack([base * (1 - 0.1 * c) for c in range(channels)], 0)
    return np.clip(pcm * 32767, -32768, 32767).astype(np.int16)


ADX_BANK = "adx_m3_bd4_stereo_48k_10s"
# Every ADX signal starts with this many silent samples, so the first block
# has a zero scale word and the stream passes the decoders' strict 7-byte CRI
# signature check (adx.cpp:345-348) at every geometry.
ADX_LEAD_IN = 1024
# name -> (channels, seconds, loop (start, end) or None, encode keywords)
ADX_STREAMS = {
    ADX_BANK: (2, 10.0, None, {}),
    "adx_m2_f2_stereo_1s": (2, 1.0, None,
                            {"encoding_mode": 2, "filter_": 2}),
    "adx_m4_stereo_1s": (2, 1.0, None, {"encoding_mode": 4}),
    "adx_bd8_stereo_1s": (2, 1.0, None, {"bit_depth": 8}),
    "adx_bd5_bs12_mono_1s": (1, 1.0, None,
                             {"bit_depth": 5, "block_size": 12}),
    "adx_bd2_bsff_stereo_1s": (2, 1.0, None,
                               {"bit_depth": 2, "block_size": 0xFF}),
    "adx_v3_stereo_1s": (2, 1.0, None, {"version": 3}),
    "adx_v5_stereo_1s": (2, 1.0, None, {"version": 5}),
    "adx_loop_stereo_1s": (2, 1.0, (4000, 40000), {}),
    "adx_6ch_1s": (6, 1.0, None, {}),
}


def adx_wav(name: str, write_wav) -> bytes:
    """The input WAV of an ADX fixture, from signal(); `write_wav` is the
    JAX package's or the port's (they are equal)."""
    channels, seconds, loop, _ = ADX_STREAMS[name]
    pcm = signal(channels, seconds)
    pcm[:ADX_LEAD_IN * channels] = 0
    if loop is None:
        return write_wav(pcm, channels, SAMPLE_RATE)
    return write_wav(pcm, channels, SAMPLE_RATE, looping=True,
                     loop_start=loop[0], loop_end=loop[1])
