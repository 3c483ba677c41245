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
- pns_v3_mono_48k_1s.hca: the v3 PNS stream, a quality-0 mono encode of
  signals.pns_wav relabelled as v3.0 with min_resolution 0 (the relabel of
  tests/test_hca.py: for mono streams without HFR the v2 and v3 frame
  bitstreams coincide), so its resolution-0 bands are noise-filled;
  expected.json marks it "v3_pns" and records no encode of it.

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

AHX (tests/data/torch_port/ahx/, with its own expected.json): AHX and bare
MPEG Layer II streams from the JAX package's encoders, each recorded with
the sha256 of the WAV pycricodecs_tpu.parallel.ahx_decode_batch(...,
device=False) makes of it (the host lane; AHX.decode agrees where the
stream has no declared sample count beyond its frames, which this script
checks) and with the JAX device program's largest distance from it in
int16 LSB (mp2_kernels.decode_transform_device_batched, f32 matmuls):
- ahx_bank_lsf_mono_22k_96k_10s: bench_all configs 8/11's stream,
  AHX.encode of signals.ahx_bank_pcm at 96 kbps (MPEG-2 LSF, table 4,
  sblimit 30, 192 frames);
- 1 s streams, one per unpacker configuration: AHX 0x10 LSF mono 16 kHz,
  AHX 0x11 LSF mono 22.05 kHz, bare LSF mono 24 kHz, MPEG-1 stereo and
  joint stereo (bound 8) at 44.1 kHz 192 kbps, the hand-packed joint stream
  whose bound varies per frame (tests/test_mp2_unpack_pallas.py
  _joint_stream), a CRC-protected LSF stream (64 kbps frames rewritten as
  96 kbps frames with the protection bit cleared and a CRC word, unchecked by
  both packages, after the header), and a VBR stream (64 then 96 kbps).

Key search (tests/data/torch_port/keysearch/, with its own expected.json):
- "find_key": the full-width key search of chip_smoke.py (bench_all config
  6's traffic on the bank stream): bank_q2_stereo_48k_10s enciphered with
  cipher 56 under the test suite's key, candidates
  np.random.default_rng(0).integers(1, 1 << 63, 200000) as uint64 with the
  true key at index 100,000, max_frames 8; records the enciphered stream's,
  the candidates' (uint64 little-endian) and the scores' (int64
  little-endian) sha256 from pycricodecs_tpu.parallel.find_key;
- "zero_coded": zero_coded_v2_stereo_48k_1s.hca, q4_stereo_48k_1s re-packed
  with base_band_count 0 (tests/torch_port_helpers.py zero_coded_stream: the
  secondary's coded_count is 0), with the sha256 of the WAV that
  pycricodecs_tpu.parallel.decode_batch makes of it (host and device
  engines agree, which this script checks).

Banks (tests/data/torch_port/bank/, with its own expected.json), built with
the JAX package's builders (ACBBuilder, build_afs2, crypt):
- "mixed": mixed.acb, its AWB embedded, whose members are, in this order,
  (1) q4_stereo_48k_1s.hca; (2) an ADX that only the non-strict signature
  check accepts: the bench signal (signals.signal, stereo, 0.25 s) encoded
  without the ADX fixtures' 1,024 silent samples, so its first scale word
  has a nonzero high byte and the strict 7-byte check refuses it; (3) a
  mode 4 ADX (0.25 s stereo) with blocks patched to the scale words 13, 45
  (both 13 mod 32: a scale of 2^31) and 14 (2^30) and codes odd, even,
  zero and negative, which the JAX host decoders' int64 arithmetic and the
  int32 wrap decode differently; (4) an ADX cut inside its payload; (5)
  ahx11_lsf_mono_22k_1s.ahx; (6) that AHX with its first frame's sync word
  cleared, which the AHX decode refuses; (7) a 0x80 0x00 member whose ADX
  header fails (block size and bit depth 0); (8) a non-audio member.
  expected.json records the sha256 of every output of
  pycricodecs_tpu.parallel.decode_acb of it, and of decode_awb of its bank
  with decode_non_hca=False;
- "subkey": subkey.awb, build_afs2 with subkey 0x55AA of q4_stereo_48k_1s
  and q2_mono_48k_1s enciphered with cipher 56 under the test suite's key
  and that subkey, with the sha256 of every output of decode_awb(key=...);
- "bank": bank.acb, ACBBuilder of 256 copies of bank_q2_stereo_48k_10s.hca
  with embed_awb=False and Name "bank" (a few KB): chip_smoke.py writes the
  sibling bank.awb with the port's build_afs2 and holds it to the sha256
  that the JAX package's build_afs2 gives, recorded here.

Surfaces (tests/data/torch_port/surfaces/expected.json), the values
chip_smoke.py's phase 17 holds the port's remaining surfaces to, from the
JAX package:
- "decode_range": the sha256 of models.hca.decode_range's int16 samples
  (C order, [samples, channels]) of bank_q2_stereo_48k_10s over (0, -1),
  (100, 300), (468, -1) and (5, 5), and of the key search's enciphered
  stream under its key over (0, -1) and (100, 300);
- "decode_frames_to_pcm": the same of decode_frames_to_pcm of
  pns_v3_mono_48k_1s's frames at random_state 1 and 0x1234;
- "test_block_state": ops.hca_frame.test_block_state threaded from 1 over
  every frame of the enciphered stream under its key and three wrong
  keys: per key the sha256 of the (score, state) pairs as int64
  little-endian [frames, 2], the score counts and the last state;
- "decode_mp2": models.ahx.decode_mp2(device=False)'s int16 [C, N]
  samples' sha256, shape and rate for ahx_bank_lsf_mono_22k_96k_10s and
  mp2_joint8_44k_192k_1s;
- "awb_builder": containers.awb.AWBBuilder in list mode over the HCA
  fixtures (sorted by name): the bank's sha256;
- "graft_entry": __graft_entry__.entry()'s fn on its example args: the
  sha256 and shape of its pcm and whether any err is set.

Containers (tests/data/torch_port/containers/expected.json, written by
write_container_fixtures(); hashes only, never the large inputs, which
chip_smoke.py's phase 19 rebuilds from pycricodecs_tpu_torch/utils/
signals.py and holds to the input hashes recorded here), from the JAX
package:
- "movie": containers.ivf.build_ivf of signals.movie_frames() (1,800
  frames, fps 30/1), the two voice tracks signals.movie_track(seed,
  utils.wav.write_wav); containers.usm.USMBuilder(ivf, [both tracks],
  key=MOVIE_KEY, audio_codec="hca", encryptAudio=True,
  subtitles=MOVIE_SUBTITLES).build() and USMBuilder(ivf, [the first
  track], key=MOVIE_KEY, audio_codec="adx", encryptAudio=True).build();
  each USM's USM(usm, key=MOVIE_KEY).extract(dir, decode=True,
  key=MOVIE_KEY) as {relative path: sha256} of every written file;
- "ahx_decode": USM._decode_audio of the 10 s AHX bank stream;
- "archive": containers.cpk.CPKBuilder over a folder of
  signals.ARCHIVE_MEMBERS (bank.acb with bank.awb = containers.awb.
  build_afs2 of 256 copies of the 10 s bank stream, mixed.acb,
  subkey.awb, both USMs) in modes 1, 2 and 3, and in mode 0 over the same
  members named 0..5: each archive's sha256, each member's, and the
  tree CPK(archive).extract(dir) writes (modes 0 and 1 extract every
  member as it went in; modes 2 and 3 read their members at the TOC's
  FileOffset past 0x800, which the builder counts without the ITOC or
  GTOC that precede the content, so they extract other bytes: the JAX
  package's behaviour, held as it is);
- "compressed": CPKBuilder(compress=True, encrypt=True) (mode 1) over
  signals.compressed_archive_members (its CRILAYLA is the JAX package's
  native compress): the archive's sha256, each member's, and which members
  it stores compressed.
- "long_matches": models.crilayla.compress (the native) of each of
  signals.crilayla_long_match_members (1 MiB, matches past 2^19 bytes):
  the member's sha256 and size and the blob's sha256.

Usage: python3 tools/make_torch_port_fixtures.py [--keysearch | --bank |
--surfaces | --containers] (--keysearch writes only the key search
directory, --bank only the banks', --surfaces only the surfaces'
expected.json, --containers only the containers' expected.json (~1 min);
--bank, --surfaces and --containers read the fixtures above, so run them
after them.)
"""
import hashlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from pycricodecs_tpu_torch.utils.signals import (  # noqa: E402
    ADX_STREAMS, AHX_BANK, HCA_PNS, HCA_STREAMS, adx_wav, ahx_bank_pcm,
    hca_wav, pns_wav, tones)

OUT_DIR = os.path.join(ROOT, "tests", "data", "torch_port")
ADX_DIR = os.path.join(OUT_DIR, "adx")
AHX_DIR = os.path.join(OUT_DIR, "ahx")
KEYSEARCH_DIR = os.path.join(OUT_DIR, "keysearch")
BANK_DIR = os.path.join(OUT_DIR, "bank")
SURFACES_DIR = os.path.join(OUT_DIR, "surfaces")
CONTAINERS_DIR = os.path.join(OUT_DIR, "containers")
BANK_TRACKS = 256
SUBKEY = 0x55AA
ZERO_CODED = "zero_coded_v2_stereo_48k_1s"
KEYSEARCH = dict(stream="bank_q2_stereo_48k_10s", cipher=56,
                 key=0xCF222F1FE0748978, seed=0, candidates=200000,
                 true_index=100000, max_frames=8)


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
    wav = pns_wav(write_wav)
    out[HCA_PNS] = (wav, relabel_v3(hca_encode_host.encode(wav, quality=0)))
    return out


def relabel_v3(hca: bytes) -> bytes:
    """A mono v2.0 stream without HFR relabelled as v3.0 with
    min_resolution 0 (the header CRC rewritten), as tests/test_hca.py
    _relabel_v3 does."""
    from pycricodecs_tpu.utils.crc import crc16
    out = bytearray(hca)
    hs = int.from_bytes(hca[6:8], "big")
    assert out[4:6] == b"\x02\x00" and out[24:28] == b"comp"
    out[4:6] = b"\x03\x00"          # version 3.0
    out[30] = 0                      # comp chunk: min_resolution = 0
    out[hs - 2:hs] = crc16(bytes(out[:hs - 2])).to_bytes(2, "big")
    return bytes(out)


def crc_protected(mp2: bytes, bitrate_idx: int) -> bytes:
    """Every frame of an LSF mono stream moved into a frame of bitrate
    index `bitrate_idx` (no padding) with the protection bit cleared and a
    16-bit CRC word after the header; the old payload follows unchanged, so
    the frame decodes to the same samples. The CRC word is not checked by
    either package's decoder."""
    from pycricodecs_tpu.ops import mp2_frame
    _, walk = mp2_frame.scan_frames(mp2, 0)
    out = []
    for _, fr in walk:
        hdr = mp2_frame.parse_header(fr)
        w = mp2_frame.header_word(hdr.version, bitrate_idx, 0, 0, hdr.mode)
        w &= ~(1 << 16)                                  # CRC present
        size = mp2_frame.parse_header(w.to_bytes(4, "big")).frame_size
        body = w.to_bytes(4, "big") + b"\x00\x00" + fr[4:]
        assert len(body) <= size
        out.append(body + bytes(size - len(body)))
    return b"".join(out)


def make_ahx_streams() -> dict:
    """name -> (file name, stream bytes) of the AHX fixtures."""
    from pycricodecs_tpu.models.ahx import AHX, encode_mp2
    from pycricodecs_tpu.utils.wav import write_wav
    from tests.test_mp2_unpack_pallas import _joint_stream

    def ahx(pcm, rate, **kw):
        return AHX.encode(write_wav(pcm.reshape(-1), 1, rate), **kw)

    return {
        AHX_BANK: (AHX_BANK + ".ahx",
                   ahx(ahx_bank_pcm(), 22050, bitrate_kbps=96)),
        "ahx10_lsf_mono_16k_1s": ("ahx10_lsf_mono_16k_1s.ahx", ahx(
            tones(1.0, 1, 16000, 11), 16000, AhxVersion=0x10)),
        "ahx11_lsf_mono_22k_1s": ("ahx11_lsf_mono_22k_1s.ahx", ahx(
            tones(1.0, 1, 22050, 12), 22050, bitrate_kbps=64)),
        "mp2_lsf_mono_24k_1s": ("mp2_lsf_mono_24k_1s.mp2", encode_mp2(
            tones(1.0, 1, 24000, 13)[0], 24000)),
        "mp2_stereo_44k_192k_1s": ("mp2_stereo_44k_192k_1s.mp2", encode_mp2(
            tones(1.0, 2, 44100, 14), 44100, bitrate_kbps=192)),
        "mp2_joint8_44k_192k_1s": ("mp2_joint8_44k_192k_1s.mp2", encode_mp2(
            tones(1.0, 2, 44100, 15), 44100, bitrate_kbps=192,
            joint_bound=8)),
        "mp2_joint_varying_bound": ("mp2_joint_varying_bound.mp2",
                                    _joint_stream()),
        "mp2_crc_lsf_mono_22k_1s": ("mp2_crc_lsf_mono_22k_1s.mp2",
                                    crc_protected(encode_mp2(
                                        tones(1.0, 1, 22050, 16)[0], 22050,
                                        bitrate_kbps=64), 10)),
        "mp2_vbr_lsf_mono_22k_1s": ("mp2_vbr_lsf_mono_22k_1s.mp2",
                                    encode_mp2(tones(0.5, 1, 22050, 17)[0],
                                               22050, bitrate_kbps=64)
                                    + encode_mp2(tones(0.5, 1, 22050, 18)[0],
                                                 22050, bitrate_kbps=96)),
    }


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
    if "--keysearch" in sys.argv[1:]:
        write_keysearch_fixtures()
        return
    if "--bank" in sys.argv[1:]:
        write_bank_fixtures()
        return
    if "--surfaces" in sys.argv[1:]:
        write_surface_fixtures()
        return
    if "--containers" in sys.argv[1:]:
        write_container_fixtures()
        return
    from pycricodecs_tpu import parallel

    os.makedirs(OUT_DIR, exist_ok=True)
    expected = {}
    for name, (wav, blob) in make_streams().items():
        if name == HCA_PNS:
            channels, seconds, quality, loop = 1, 1.0, 0, None
        else:
            channels, seconds, quality, loop = HCA_STREAMS[name]
            if parallel.hca_encode_batch([wav], quality=quality,
                                         device=True)[0] != blob:
                raise SystemExit(f"{name}: batch and host encoders "
                                 f"disagree")
        with open(os.path.join(OUT_DIR, name + ".hca"), "wb") as f:
            f.write(blob)
        sha = reference_sha256(blob, "host")
        if reference_sha256(blob, "device") != sha:
            raise SystemExit(f"{name}: host and device engines disagree")
        expected[name] = {"channels": channels, "seconds": seconds,
                          "quality": quality, "loop": loop,
                          "wav_in_sha256": sha256(wav),
                          "hca_sha256": sha256(blob), "wav_sha256": sha}
        if name == HCA_PNS:
            expected[name]["v3_pns"] = True
        print(name, len(blob), sha)
    with open(os.path.join(OUT_DIR, "expected.json"), "w") as f:
        json.dump(expected, f, indent=1, sort_keys=True)
        f.write("\n")
    write_adx_fixtures()
    write_ahx_fixtures()
    write_keysearch_fixtures()
    write_bank_fixtures()
    write_surface_fixtures()
    write_container_fixtures()


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


def write_ahx_fixtures() -> None:
    import numpy as np

    from pycricodecs_tpu import parallel
    from pycricodecs_tpu.models.ahx import AHX
    from pycricodecs_tpu.ops import mp2_frame, mp2_kernels

    os.makedirs(AHX_DIR, exist_ok=True)
    expected = {}
    for name, (fname, blob) in make_ahx_streams().items():
        wav = parallel.ahx_decode_batch([blob], device=False)[0]
        offset = AHX.parse_header(blob)["data_offset"] \
            if fname.endswith(".ahx") else 0
        st = mp2_frame.unpack(blob, offset)
        if fname.endswith(".ahx") and AHX.decode(blob) != wav:
            raise SystemExit(f"{name}: AHX.decode and the batch decode "
                             f"disagree")
        host = mp2_kernels.decode_pcm16_host(st.codes, st.levels, st.sfidx)
        dev = mp2_kernels.decode_transform_device_batched(
            st.codes[None], st.levels[None], st.sfidx[None])[0]
        diff = np.abs(dev.astype(np.int32) - host.astype(np.int32))
        with open(os.path.join(AHX_DIR, fname), "wb") as f:
            f.write(blob)
        expected[name] = {"file": fname, "channels": st.header.nch,
                          "sample_rate": st.header.sample_rate,
                          "frames": st.nframes, "crc": st.header.crc,
                          "stream_sha256": sha256(blob),
                          "wav_sha256": sha256(wav),
                          "jax_device_max_lsb": int(diff.max()),
                          "jax_device_lsb_samples": int((diff > 0).sum())}
        print(name, len(blob), st.nframes, int(diff.max()))
    with open(os.path.join(AHX_DIR, "expected.json"), "w") as f:
        json.dump(expected, f, indent=1, sort_keys=True)
        f.write("\n")


def keysearch_candidates(spec: dict):
    """The full-width key search's candidates, uint64 [n]."""
    import numpy as np
    cands = np.random.default_rng(spec["seed"]).integers(
        1, 1 << 63, spec["candidates"]).astype(np.uint64)
    cands[spec["true_index"]] = spec["key"]
    return cands


def write_keysearch_fixtures() -> None:
    import numpy as np

    from pycricodecs_tpu import parallel
    from pycricodecs_tpu.models import hca as jax_hca
    from tests.torch_port_helpers import zero_coded_stream

    os.makedirs(KEYSEARCH_DIR, exist_ok=True)
    spec = dict(KEYSEARCH)
    with open(os.path.join(OUT_DIR, spec["stream"] + ".hca"), "rb") as f:
        plain = f.read()
    hs = int.from_bytes(plain[6:8], "big")
    enc = jax_hca.crypt(plain, True, hs, spec["cipher"], spec["key"])
    cands = keysearch_candidates(spec)
    scores = parallel.find_key(enc, cands, max_frames=spec["max_frames"])
    order = parallel.rank_keys(scores)
    if order[0] != spec["true_index"]:
        raise SystemExit("find_key: the true key does not rank first")
    spec.update(enciphered_sha256=sha256(enc),
                candidates_sha256=sha256(cands.astype("<u8").tobytes()),
                scores_sha256=sha256(scores.astype("<i8").tobytes()),
                true_score=int(scores[spec["true_index"]]),
                accepted=int((scores >= 0).sum()))
    print("find_key", spec)

    with open(os.path.join(OUT_DIR, "q4_stereo_48k_1s.hca"), "rb") as f:
        blob = zero_coded_stream(f.read())
    wav = parallel.decode_batch([blob], engine="host")[0]
    if parallel.decode_batch([blob], engine="device")[0] != wav:
        raise SystemExit(f"{ZERO_CODED}: host and device engines disagree")
    with open(os.path.join(KEYSEARCH_DIR, ZERO_CODED + ".hca"), "wb") as f:
        f.write(blob)
    zero = {"file": ZERO_CODED + ".hca", "source": "q4_stereo_48k_1s",
            "hca_sha256": sha256(blob), "wav_sha256": sha256(wav)}
    print(ZERO_CODED, len(blob), zero["wav_sha256"])
    with open(os.path.join(KEYSEARCH_DIR, "expected.json"), "w") as f:
        json.dump({"find_key": spec, "zero_coded": zero}, f, indent=1,
                  sort_keys=True)
        f.write("\n")



def _patch(blob: bytes, off: int, data: bytes) -> bytes:
    out = bytearray(blob)
    out[off:off + len(data)] = data
    return bytes(out)


def mixed_members() -> list:
    """(name, bytes) of mixed.acb's members, in bank order."""
    from pycricodecs_tpu.models import adx
    from pycricodecs_tpu.utils.wav import write_wav
    from pycricodecs_tpu_torch.utils.signals import SAMPLE_RATE, signal

    def read(*parts):
        with open(os.path.join(OUT_DIR, *parts), "rb") as f:
            return f.read()

    wav = write_wav(signal(2, 0.25), 2, SAMPLE_RATE)
    loose = adx.encode(wav)
    try:
        adx.parse_adx_header(loose)
    except ValueError:
        adx.parse_adx_header(loose, strict_cri_check=False)
    else:
        raise SystemExit("the non-strict ADX passes the strict check")
    m4 = adx.encode(wav, encoding_mode=4)
    h = adx.parse_adx_header(m4)
    start = h.data_offset + 4
    frame = h.block_size * h.channels
    # codes 1, 2, 3, 0, -1, -8, 0, -2, then the encoder's own
    for block, word in ((40, 13), (41, 45), (120, 14)):
        m4 = _patch(m4, start + block * frame,
                    word.to_bytes(2, "big") + bytes.fromhex("1230f80e"))
    ahx = read("ahx", "ahx11_lsf_mono_22k_1s.ahx")
    ahx_off = int.from_bytes(ahx[2:4], "big") + 4
    return [
        ("hca_q4_stereo_1s", read("q4_stereo_48k_1s.hca")),
        ("adx_non_strict", loose),
        ("adx_m4_scale13", m4),
        ("adx_truncated", loose[:start + 300 * frame + 7]),
        ("ahx11_1s", ahx),
        ("ahx_corrupt", _patch(ahx, ahx_off, b"\x00\x00")),
        ("adx_bad_header", b"\x80\x00\x00\x20" + bytes(36)),
        ("not_audio", b"not an audio member\n" * 4),
    ]


def write_bank_fixtures() -> None:
    from pycricodecs_tpu import parallel
    from pycricodecs_tpu.containers.acb import ACB, ACBBuilder
    from pycricodecs_tpu.containers.awb import AWB, build_afs2
    from pycricodecs_tpu.models import hca as jax_hca

    os.makedirs(BANK_DIR, exist_ok=True)
    members = mixed_members()
    acb = ACBBuilder([m for _, m in members], name="mixed").build()
    outs = parallel.decode_acb(acb)
    raw = parallel.decode_awb(ACB(acb).awb, decode_non_hca=False)
    with open(os.path.join(BANK_DIR, "mixed.acb"), "wb") as f:
        f.write(acb)
    expected = {"mixed": {
        "file": "mixed.acb", "members": [n for n, _ in members],
        "wav_sha256": [sha256(o) for o in outs],
        "raw": [o == m for o, m in zip(outs, ACB(acb).awb.getfiles())],
        "no_non_hca_sha256": [sha256(o) for o in raw]}}
    print("mixed", len(acb), expected["mixed"]["raw"])

    key = KEYSEARCH["key"]
    enc = []
    for name in ("q4_stereo_48k_1s", "q2_mono_48k_1s"):
        with open(os.path.join(OUT_DIR, name + ".hca"), "rb") as f:
            plain = f.read()
        hs = int.from_bytes(plain[6:8], "big")
        enc.append(jax_hca.crypt(plain, True, hs, 56, key, SUBKEY))
    awb = build_afs2(enc, subkey=SUBKEY)
    outs = parallel.decode_awb(awb, key=key)
    with open(os.path.join(BANK_DIR, "subkey.awb"), "wb") as f:
        f.write(awb)
    expected["subkey"] = {
        "file": "subkey.awb", "key": key, "subkey": SUBKEY,
        "members": ["q4_stereo_48k_1s", "q2_mono_48k_1s"],
        "wav_sha256": [sha256(o) for o in outs]}
    print("subkey", len(awb))

    with open(os.path.join(OUT_DIR, "bank_q2_stereo_48k_10s.hca"), "rb") as f:
        track = f.read()
    builder = ACBBuilder([track] * BANK_TRACKS, name="bank", embed_awb=False)
    acb = builder.build()
    if builder.awb_blob != build_afs2([track] * BANK_TRACKS):
        raise SystemExit("ACBBuilder's bank differs from build_afs2's")
    if list(AWB(builder.awb_blob).getfiles()) != [track] * BANK_TRACKS:
        raise SystemExit("the bank's members differ from the track")
    with open(os.path.join(BANK_DIR, "bank.acb"), "wb") as f:
        f.write(acb)
    expected["bank"] = {"file": "bank.acb", "name": "bank",
                        "tracks": BANK_TRACKS,
                        "member": "bank_q2_stereo_48k_10s.hca",
                        "acb_sha256": sha256(acb),
                        "awb_sha256": sha256(builder.awb_blob)}
    print("bank", len(acb), len(builder.awb_blob))
    with open(os.path.join(BANK_DIR, "expected.json"), "w") as f:
        json.dump(expected, f, indent=1, sort_keys=True)
        f.write("\n")



#: the wrong keys test_block_state is threaded under, beside the true key
WRONG_KEYS = (KEYSEARCH["key"] + 1, 1, 0xDEADBEEF)
RANGES = ((0, -1), (100, 300), (468, -1), (5, 5))
ENCIPHERED_RANGES = ((0, -1), (100, 300))
PNS_STATES = (1, 0x1234)
MP2_STREAMS = ("ahx_bank_lsf_mono_22k_96k_10s", "mp2_joint8_44k_192k_1s")


def pcm_record(pcm) -> dict:
    """sha256 (C order bytes) and shape of an int16 array."""
    import numpy as np
    pcm = np.ascontiguousarray(pcm)
    if pcm.dtype != np.int16:
        raise SystemExit(f"expected int16 samples, got {pcm.dtype}")
    return {"sha256": sha256(pcm.tobytes()), "shape": list(pcm.shape)}


def write_surface_fixtures() -> None:
    import numpy as np

    import __graft_entry__
    from pycricodecs_tpu.containers.awb import AWBBuilder
    from pycricodecs_tpu.models import ahx as jax_ahx
    from pycricodecs_tpu.models import hca as jax_hca
    from pycricodecs_tpu.ops import hca_frame

    os.makedirs(SURFACES_DIR, exist_ok=True)
    spec = dict(KEYSEARCH)
    with open(os.path.join(OUT_DIR, spec["stream"] + ".hca"), "rb") as f:
        plain = f.read()
    hs = int.from_bytes(plain[6:8], "big")
    enc = jax_hca.crypt(plain, True, hs, spec["cipher"], spec["key"])
    out = {"decode_range": {
        "stream": spec["stream"],
        "ranges": [[a, b, pcm_record(jax_hca.decode_range(plain, a, b))]
                   for a, b in RANGES],
        "enciphered_key": spec["key"],
        "enciphered_sha256": sha256(enc),
        "enciphered_ranges": [
            [a, b, pcm_record(jax_hca.decode_range(enc, a, b, spec["key"]))]
            for a, b in ENCIPHERED_RANGES]}}
    print("decode_range", out["decode_range"]["ranges"][0])

    with open(os.path.join(OUT_DIR, "pns_v3_mono_48k_1s.hca"), "rb") as f:
        pns = f.read()
    phs = int.from_bytes(pns[6:8], "big")
    info = hca_frame.parse_header(pns[:phs])
    out["decode_frames_to_pcm"] = {
        "stream": "pns_v3_mono_48k_1s",
        "random_states": [[s, pcm_record(jax_hca.decode_frames_to_pcm(
            info, pns[phs:], s))] for s in PNS_STATES]}

    keys = {}
    for key in (spec["key"],) + WRONG_KEYS:
        info = hca_frame.parse_header(enc[:hs])
        info.set_key(key)
        state, pairs = 1, []
        for f in range(info.frame_count):
            off = hs + f * info.frame_size
            score, state = hca_frame.test_block_state(
                info, enc[off:off + info.frame_size], state)
            pairs.append((score, state))
        scores = [p[0] for p in pairs]
        keys[f"0x{key:016X}"] = {
            "pairs_sha256": sha256(np.asarray(pairs, "<i8").tobytes()),
            "frames": len(pairs), "last_state": state,
            "score_counts": {str(v): scores.count(v)
                             for v in sorted(set(scores))}}
        print("test_block_state", hex(key), keys[f"0x{key:016X}"])
    out["test_block_state"] = {"stream": "enciphered", "start_state": 1,
                               "true_key": f"0x{spec['key']:016X}",
                               "keys": keys}

    mp2 = {}
    with open(os.path.join(AHX_DIR, "expected.json")) as f:
        ahx_expected = json.load(f)
    for name in MP2_STREAMS:
        with open(os.path.join(AHX_DIR, ahx_expected[name]["file"]),
                  "rb") as f:
            blob = f.read()
        offset = (jax_ahx.AHX.parse_header(blob)["data_offset"]
                  if blob[:1] == b"\x80" else 0)
        pcm, rate = jax_ahx.decode_mp2(blob, offset, device=False)
        mp2[name] = dict(pcm_record(pcm), offset=offset, sample_rate=rate)
    out["decode_mp2"] = mp2
    print("decode_mp2", mp2)

    import tempfile
    names = sorted(f for f in os.listdir(OUT_DIR) if f.endswith(".hca"))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "list.awb")
        AWBBuilder([os.path.join(OUT_DIR, n) for n in names]).build(path)
        with open(path, "rb") as f:
            awb = f.read()
    out["awb_builder"] = {"members": names, "sha256": sha256(awb)}

    fn, args = __graft_entry__.entry()
    pcm, err = (np.asarray(x) for x in fn(*args))
    out["graft_entry"] = dict(pcm_record(pcm), err_any=bool(err.any()))
    print("graft_entry", out["graft_entry"])
    with open(os.path.join(SURFACES_DIR, "expected.json"), "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")

def tree_sha256(root: str) -> dict:
    """{relative path with "/": sha256} of every file under root."""
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root).replace(os.sep, "/")] = \
                    sha256(f.read())
    return dict(sorted(out.items()))


def write_container_fixtures() -> None:
    import tempfile

    from pycricodecs_tpu.containers.awb import build_afs2
    from pycricodecs_tpu.containers.cpk import CPK, CPKBuilder
    from pycricodecs_tpu.containers.ivf import build_ivf
    from pycricodecs_tpu.containers.usm import USM, USMBuilder
    from pycricodecs_tpu.models import crilayla as jax_crilayla
    from pycricodecs_tpu.utils.wav import write_wav
    from pycricodecs_tpu_torch.utils import signals as S

    os.makedirs(CONTAINERS_DIR, exist_ok=True)
    key = S.MOVIE_KEY
    ivf = build_ivf(S.movie_frames(), fps_num=S.MOVIE["fps"], fps_den=1)
    tracks = [S.movie_track(seed, write_wav) for seed in S.MOVIE_TRACK_SEEDS]
    usms = {
        "hca": USMBuilder(ivf, tracks, key=key, audio_codec="hca",
                          encryptAudio=True,
                          subtitles=S.MOVIE_SUBTITLES).build(),
        "adx": USMBuilder(ivf, [tracks[0]], key=key, audio_codec="adx",
                          encryptAudio=True).build()}
    movie = {"ivf_sha256": sha256(ivf), "ivf_bytes": len(ivf),
             "track_sha256": [sha256(t) for t in tracks], "key": hex(key)}
    with tempfile.TemporaryDirectory() as tmp:
        for name, usm in usms.items():
            out = os.path.join(tmp, name)
            USM(usm, key=key).extract(out, decode=True, key=key)
            movie[name] = {"usm_sha256": sha256(usm), "usm_bytes": len(usm),
                           "extract": tree_sha256(out)}
            print(name, movie[name])
    with open(os.path.join(AHX_DIR, AHX_BANK + ".ahx"), "rb") as f:
        ahx = USM._decode_audio(f.read())
    out = {"movie": movie, "ahx_decode": {"stream": AHX_BANK + ".ahx",
                                          "wav_sha256": sha256(ahx)}}

    with open(os.path.join(BANK_DIR, "expected.json")) as f:
        bank = json.load(f)["bank"]
    with open(os.path.join(OUT_DIR, bank["member"]), "rb") as f:
        members = {"bank.awb": build_afs2([f.read()] * bank["tracks"])}
    for name in ("bank.acb", "mixed.acb", "subkey.awb"):
        with open(os.path.join(BANK_DIR, name), "rb") as f:
            members[name] = f.read()
    members["hca.usm"], members["adx.usm"] = usms["hca"], usms["adx"]
    archive = {"members": {n: sha256(members[n])
                           for n in S.ARCHIVE_MEMBERS}, "modes": {}}
    compressed_in = S.compressed_archive_members(OUT_DIR, write_wav)
    with tempfile.TemporaryDirectory() as tmp:
        named, numbered = os.path.join(tmp, "named"), os.path.join(tmp, "ids")
        os.makedirs(named)
        os.makedirs(numbered)
        for i, n in enumerate(S.ARCHIVE_MEMBERS):
            for path in (os.path.join(named, n), os.path.join(numbered,
                                                             str(i))):
                with open(path, "wb") as f:
                    f.write(members[n])
        for mode in (0, 1, 2, 3):
            path = os.path.join(tmp, f"mode{mode}.cpk")
            CPKBuilder(numbered if mode == 0 else named, path, CpkMode=mode)
            with open(path, "rb") as f:
                blob = f.read()
            out_dir = os.path.join(tmp, f"out{mode}")
            CPK(path).extract(out_dir)
            archive["modes"][str(mode)] = {"sha256": sha256(blob),
                                           "bytes": len(blob),
                                           "extract": tree_sha256(out_dir)}
            print("archive mode", mode, archive["modes"][str(mode)])
        src = os.path.join(tmp, "compress_in")
        os.makedirs(src)
        for n, data in compressed_in.items():
            with open(os.path.join(src, n), "wb") as f:
                f.write(data)
        path = os.path.join(tmp, "compressed.cpk")
        CPKBuilder(src, path, compress=True, encrypt=True)
        with open(path, "rb") as f:
            blob = f.read()
        toc = CPK(path).tables["TOC"]
        packed = sorted(CPK._cell(toc["FileName"], i)
                        for i in range(len(toc["FileName"]))
                        if CPK._cell(toc["ExtractSize"], i)
                        > CPK._cell(toc["FileSize"], i))
    out["archive"] = archive
    out["compressed"] = {"sha256": sha256(blob), "bytes": len(blob),
                         "members": {n: sha256(d)
                                     for n, d in compressed_in.items()},
                         "stored_compressed": packed}
    print("compressed", out["compressed"]["sha256"], len(blob), packed)
    out["long_matches"] = {
        n: {"member_sha256": sha256(d), "bytes": len(d),
            "blob_sha256": sha256(jax_crilayla.compress(d))}
        for n, d in S.crilayla_long_match_members().items()}
    print("long_matches", out["long_matches"])
    with open(os.path.join(CONTAINERS_DIR, "expected.json"), "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
