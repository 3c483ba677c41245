"""The deterministic test signals behind the port's fixtures (numpy only).

tools/make_torch_port_fixtures.py encodes these signals with the JAX
package to write tests/data/torch_port/; chip_smoke.py rebuilds the HCA and
ADX input WAVs, and the container phase's cutscene (movie_frames,
movie_track), from the same recipe on the GPU machine, which has no JAX,
and holds them to the hashes recorded there. The AHX fixtures are only
decoded there, so their signals (ahx_bank_pcm, tones) serve the fixture
tool and its regeneration test.
"""
from __future__ import annotations

import os

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


# The container phase's cutscene: 60 s of VP9 at 30 fps as a game ships it
# in a USM. The frames are pseudo-random bytes (no decoder reads them): a
# 48 KB keyframe every 30 frames and 12 KB +- 2 KB otherwise, about 24 MB,
# 3.2 Mbit/s, a typical cutscene bitrate.
MOVIE = dict(seconds=60, fps=30, keyframe_every=30, keyframe_bytes=48 * 1024,
             frame_bytes=12 * 1024, jitter=2 * 1024, seed=19)
#: the USM key of the container phase's movies: below 2^56 (a 7-byte key)
MOVIE_KEY = 0x0019C0FFEE5EED19
#: the seeds of the movie's two 60 s, 48 kHz stereo voice tracks (tones())
MOVIE_TRACK_SEEDS = (1, 2)
#: the movie's subtitles, {language: [(start ms, duration ms, text)]}
MOVIE_SUBTITLES = {
    0: [(1000, 2500, "The gate is open."), (4000, 3000, "Run!"),
        (30000, 2000, "Where are we?"), (58000, 1500, "Home.")],
    1: [(1000, 2500, "Das Tor ist offen."), (4000, 3000, "Lauf!"),
        (30000, 2000, "Wo sind wir?"), (58000, 1500, "Zuhause.")],
}


def movie_frames() -> list:
    """The cutscene's frames (MOVIE), as bytes."""
    m = MOVIE
    n = m["seconds"] * m["fps"]
    rng = np.random.default_rng(m["seed"])
    sizes = m["frame_bytes"] + rng.integers(-m["jitter"], m["jitter"] + 1, n)
    sizes[::m["keyframe_every"]] = m["keyframe_bytes"]
    data = rng.bytes(int(sizes.sum()))
    ends = np.cumsum(sizes)
    return [data[e - s:e] for s, e in zip(sizes.tolist(), ends.tolist())]


def movie_track(seed: int, write_wav) -> bytes:
    """A voice track of the cutscene: tones(60 s, 2 channels, 48 kHz,
    seed) as a WAV; `write_wav` is the JAX package's or the port's."""
    pcm = tones(MOVIE["seconds"], 2, 48000, seed)
    return write_wav(pcm.T.reshape(-1), 2, 48000)


#: the container phase's sound archive: its members in the folder the
#: CPKs are built from (mode 0 takes the same members named 0..5 in this
#: order); bank.awb is 256 copies of the 10 s bank stream
ARCHIVE_MEMBERS = ("adx.usm", "bank.acb", "bank.awb", "hca.usm",
                   "mixed.acb", "subkey.awb")
#: how many copies of the 10 s bank WAV (hca_wav(HCA_BANK)) the compressed
#: archive holds
COMPRESSED_WAVS = 4


def compressed_archive_members(fixtures: str, write_wav) -> dict:
    """The container phase's compressed archive, {name: bytes}: bank.acb
    and mixed.acb, the 1 s ADX and HCA fixtures and the 10 s ADX bank
    stream from the fixture directory `fixtures` (tests/data/torch_port),
    and COMPRESSED_WAVS copies of the 10 s bank WAV."""
    def read(*parts):
        with open(os.path.join(fixtures, *parts), "rb") as f:
            return f.read()

    out = {name: read("bank", name) for name in ("bank.acb", "mixed.acb")}
    for name in sorted(os.listdir(os.path.join(fixtures, "adx"))):
        if name.endswith("_1s.adx") or name == ADX_BANK + ".adx":
            out[name] = read("adx", name)
    for name in sorted(os.listdir(fixtures)):
        if name.endswith("_1s.hca"):
            out[name] = read(name)
    wav = hca_wav(HCA_BANK, write_wav)
    for i in range(COMPRESSED_WAVS):
        out[f"wav_{i}.wav"] = wav
    return out


def crilayla_edge_payloads(seed: int = 19) -> list:
    """Small CRILAYLA inputs that reach the greedy matcher's edges: n at
    0x100 (257 and 258 bytes), ties between equal matches, a zero run past
    the 44 + 255 escapes, one repeat of every length escape (3-5, 6-12,
    13-43, 44 and up with one and two 255-runs), matches cut at kmax, and
    repeats at the window's edge (offset 0x1FFF, taken, and 0x2000, out of
    reach) in one payload just past 0x2000 bytes."""
    rng = np.random.default_rng(seed)

    def rand(n, hi=256):
        return bytearray(rng.integers(0, hi, n, dtype=np.uint8).tobytes())

    out = [bytes(rand(257)), bytes(rand(258)), bytes(rand(300, 4)),
           bytes(rand(4096, 3))]
    z = rand(1200)
    z[300:300 + 44 + 255 + 90] = bytes(44 + 255 + 90)
    out.append(bytes(z))
    esc = rand(300)
    for length in (3, 5, 6, 12, 13, 43, 44, 298, 299, 553, 554):
        block = rand(length)
        esc += block + rand(7) + block + rand(5)
    out.append(bytes(esc))
    # a period-5 pattern reaching back to byte 0x100: matches end at kmax
    out.append(bytes(rand(0x100) + bytearray(b"abcde" * 300)))
    # period-7 filler keeps the payload's greedy steps few (the plain
    # version's cost is a scan of the window per step); the two random
    # blocks and their copies are the matches under test
    edge = bytearray((b"0123456" * 1300)[:0x2000 + 700])
    hi = len(edge) - 140
    edge[hi - 60:hi + 40] = rand(100)
    edge[hi - 0x2002:hi - 0x2002 + 40] = edge[hi:hi + 40]
    edge[hi - 60 - 0x2003:hi - 60 - 0x2003 + 40] = edge[hi - 60:hi - 20]
    out.append(bytes(edge))
    return out


def crilayla_long_match_members() -> dict:
    """Two 1 MiB CRILAYLA inputs whose matches run past 2^19 bytes (C2's
    64-bit keys), {name: bytes}: a run of one byte and a period-3 pattern,
    each one match of nearly its whole length."""
    size = 1 << 20
    return {"run_1mib": b"\x5a" * size,
            "period3_1mib": (b"\x01\x80\xfe" * (size // 3 + 1))[:size]}


def crilayla_zero_blob(size: int) -> bytes:
    """A hand-made CRILAYLA blob of `size` output bytes whose stream is all
    zero bits: 9-bit zero literals, so it decompresses to size + 256 zero
    bytes (the prefix is zeros too). C1 parses chunks of 16,384 stream
    bits from their first bit; chunk k starts 16,384 k = 4k bits mod 9 past
    a token start, so about 8 chunks in 9 never meet the true parse, and
    C1's serial repair parses them."""
    cs = -(-9 * size // 8)
    return (b"CRILAYLA" + size.to_bytes(4, "little")
            + cs.to_bytes(4, "little") + bytes(cs + 256))


def crilayla_fill_blob(size: int, byte: int = 0xAB) -> bytes:
    """A hand-made CRILAYLA blob of `size` output bytes (47 to 2^32 - 1,
    the u32 decompress size): three literals of `byte`, then one copy at
    distance 3 of the other size - 3 bytes, its length a 255-run of about
    size / 255 stream bytes. It decompresses to the 256 zero bytes of its
    prefix and then size copies of `byte`."""
    if not 47 <= size < 1 << 32:
        raise ValueError("crilayla_fill_blob: size must be in [47, 2^32)")
    return _crilayla_copy_blob(size, byte, size - 47, b"")


def crilayla_wrap_blob(copy: int = 40, tail: bytes = bytes(range(1, 17)),
                       byte: int = 0xAB) -> bytes:
    """A hand-made CRILAYLA blob whose copy length passes 2^32 and wraps,
    as the JAX native's u32 length does: three literals of `byte`, one
    copy at distance 3 whose 255-run (about 16.84 MB of stream) sums to
    2^32 + copy - 44, so that the copy writes `copy` bytes (3 or more),
    then the literals of `tail`. Decompress size 3 + copy + len(tail); it
    decompresses to 256 zero bytes, `tail` reversed (the stream writes
    from the top down) and copy + 3 bytes of `byte`. A length that did not
    wrap would fill the output with `byte`."""
    if copy < 3:
        raise ValueError("crilayla_wrap_blob: a copy is 3 bytes or more")
    return _crilayla_copy_blob(3 + copy + len(tail), byte,
                               (1 << 32) + copy - 44, tail)


def _crilayla_copy_blob(size: int, byte: int, run: int, tail: bytes) -> bytes:
    """Three literals of `byte`, one copy at distance 3 whose length is
    44 + `run` (a 255-run and its last byte), then 9-bit literals of
    `tail`, as a CRILAYLA blob of `size` output bytes and a zero prefix."""
    q, r = divmod(run, 255)                # the 255-run: q bytes, then r
    lits = (byte << 18) | (byte << 9) | byte   # three '0' + 8-bit literals
    copy = (1 << 23) | 0x3FF       # '1', offset 0, length codes 3, 7, 31
    v = ((lits << 24 | copy) << 8 * q | ((1 << 8 * q) - 1)) << 8 | r
    for t in tail:
        v = v << 9 | t
    bits = 27 + 24 + 8 * q + 8 + 9 * len(tail)
    pad = -bits % 8
    stream = (v << pad).to_bytes((bits + pad) // 8, "big")[::-1]  # read
    # from the end
    return (b"CRILAYLA" + size.to_bytes(4, "little")
            + len(stream).to_bytes(4, "little") + stream + bytes(256))
