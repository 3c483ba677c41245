"""PyTorch port, the USM container (pycricodecs_tpu_torch/containers/usm.py)
against the JAX package's: the key schedule and the three masks for int and
hex keys (one above 2^56), USMBuilder's bytes (ADX and HCA audio, keys,
encryptAudio, subtitles, alpha, two tracks, append_stream), demux outputs
and metadata (the reference-built file's resync included), extract trees
with and without decode=True, `_decode_audio` and its None cases, the
hostile CRID names, mutated USMs; and a failed launch under
extract(decode=True) raises instead of writing raw files. The audio codecs
run their plain versions here (device="cpu")."""
import enum
import os
import struct

import numpy as np
import pytest

from pycricodecs_tpu.containers import usm as jax_usm
from pycricodecs_tpu.containers.ivf import build_ivf
from pycricodecs_tpu.models import adx as jax_adx
from pycricodecs_tpu.models import hca as jax_hca
from pycricodecs_tpu.models.ahx import AHX as JaxAHX
from pycricodecs_tpu.ops import hca_encode_host
from pycricodecs_tpu.utils.wav import write_wav
from pycricodecs_tpu_torch.containers import usm as port_usm
from tests.conftest import make_sine_pcm16
from tests.test_fuzz import N_MUTATIONS, _mutate

KEYS = [0x1234ABCD5678, 0xFEDCBA9876543210, 0x00FFFFFFFFFFFFFF, 1 << 56,
        "1234ABCD5678", "fedcba9876543210", "0"]


def _fake_ivf(nframes=12, seed=11):
    rng = np.random.default_rng(seed)
    frames = []
    for i in range(nframes):
        body = bytes(rng.integers(0, 255, 400 + 37 * i).astype(np.uint8))
        if i % 6 == 0:
            body = b"\x82I\x83B" + body
        frames.append(body)
    return build_ivf(frames, fps_num=2997, fps_den=100)


def _wav(seed, channels=2, rate=48000, samples=6000):
    return write_wav(make_sine_pcm16(samples, channels, rate, seed=seed),
                     channels, rate)


def _tree(root) -> dict:
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _outcome(fn, *args, **kw):
    try:
        return "ok", fn(*args, **kw)
    except Exception as exc:  # the type is what the two must share
        return "raised", type(exc).__name__


# -- key schedule and masks -------------------------------------------------------

@pytest.mark.parametrize("key", KEYS)
def test_init_key_equal(key):
    for got, want in zip(port_usm.init_key(key), jax_usm.init_key(key)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("key", ["1" * 17, 1.5, None, b"\x01"])
def test_init_key_errors_equal(key):
    assert _outcome(port_usm.init_key, key)[1] == \
        _outcome(jax_usm.init_key, key)[1]


@pytest.mark.parametrize("key", KEYS[:4])
@pytest.mark.parametrize("size", [0x40, 0x240, 0x241, 0x247, 0x400, 5000])
def test_masks_equal(key, size):
    vm1, vm2, am = jax_usm.init_key(key)
    data = np.random.default_rng(size).integers(0, 256, size,
                                                dtype=np.uint8).tobytes()
    assert port_usm.video_mask_encrypt(data, vm1, vm2) == \
        jax_usm.video_mask_encrypt(data, vm1, vm2)
    assert port_usm.video_mask_decrypt(bytearray(data), vm1, vm2) == \
        jax_usm.video_mask_decrypt(bytearray(data), vm1, vm2)
    for word_mode in (True, False):
        assert port_usm.audio_mask(data, am, word_mode) == \
            jax_usm.audio_mask(data, am, word_mode)
    if (size - 0x40) % 8 == 0:      # decrypt covers whole 8-byte words
        enc = port_usm.video_mask_encrypt(data, vm1, vm2)
        assert bytes(port_usm.video_mask_decrypt(bytearray(enc), vm1,
                                                 vm2)) == data


def test_drop_in_mask_aliases_equal():
    key = 0x1234567890ABCDEF
    data = np.random.default_rng(4).integers(0, 256, 3000,
                                             dtype=np.uint8).tobytes()
    blob = jax_usm.USMBuilder(_fake_ivf(2)).build()
    got, want = port_usm.USM(blob, device="cpu"), jax_usm.USM(blob)
    got.init_key(key)
    want.init_key(key)
    assert got.VideoMask(data) == want.VideoMask(data)
    assert got.AudioMask(data) == want.AudioMask(data)


# -- USMBuilder ------------------------------------------------------------------

BUILDS = {
    "video_only": lambda: (_fake_ivf(), {}),
    "video_key": lambda: (_fake_ivf(), {"key": 0x1234567890ABCDEF}),
    "hca": lambda: (_fake_ivf(), {"audio": [_wav(9)], "audio_codec": "hca"}),
    "hca_key": lambda: (_fake_ivf(), {"audio": [_wav(9)],
                                      "audio_codec": "hca",
                                      "key": 0x0019C0FFEE5EED19}),
    "hca_key_encrypt": lambda: (_fake_ivf(), {
        "audio": [_wav(9)], "audio_codec": "hca", "key": 0xFEDCBA9876543210,
        "encryptAudio": True}),
    "hca_two_tracks_subtitles": lambda: (_fake_ivf(), {
        "audio": [_wav(21), _wav(22)], "audio_codec": "hca",
        "subtitles": {0: [(0, 1500, "Hello world"), (2000, 1000, "Two")],
                      1: [(0, 1500, "Bonjour le monde")]}}),
    "adx": lambda: (_fake_ivf(), {"audio": [_wav(31, rate=32000)],
                                  "audio_codec": "adx"}),
    "adx_key_encrypt": lambda: (_fake_ivf(), {
        "audio": [_wav(31, rate=32000)], "audio_codec": "ADX",
        "key": "fedcba9876543210", "encryptAudio": True}),
    "adx_stream_alpha": lambda: (_fake_ivf(4), {
        "audio": jax_adx.encode(_wav(32, 1, 32000, 4000)),
        "audio_codec": "adx", "key": 0x1234ABCD5678,
        "alpha": _fake_ivf(9, seed=12), "subtitles": [(0, 500, "list")]}),
    "hca_stream": lambda: (_fake_ivf(), {
        "audio": [hca_encode_host.encode(_wav(41), quality=2)],
        "audio_codec": "hca"}),
}


def _build_both(name, tmp_path=None):
    video, kw = BUILDS[name]()
    got = _outcome(lambda: port_usm.USMBuilder(video, device="cpu",
                                               **kw).build())
    want = _outcome(lambda: jax_usm.USMBuilder(video, **kw).build())
    return got, want, kw


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_builder_bytes_equal(name):
    got, want, _ = _build_both(name)
    assert got == want and want[0] == "ok"


def test_builder_from_paths_and_append_stream(tmp_path):
    vp = tmp_path / "deep" / "v.ivf"
    vp.parent.mkdir()
    vp.write_bytes(_fake_ivf())
    ap = tmp_path / "deep" / "a.wav"
    ap.write_bytes(_wav(3, 1, 32000, 4000))
    blobs = []
    for mod, kw in ((port_usm, {"device": "cpu"}), (jax_usm, {})):
        b = mod.USMBuilder(str(vp), [str(ap)], audio_codec="hca", **kw)
        b.append_stream(_wav(62, 1, 32000, 4000))
        b.append_stream(_wav(63, 1, 32000, 4000))
        blobs.append(b.build())
        assert b.get_usm() == blobs[-1]
    assert blobs[0] == blobs[1]


@pytest.mark.parametrize("case", ["crid_input", "not_ivf", "encrypt_no_key",
                                  "bad_codec", "adx_below_960hz",
                                  "alpha_not_ivf"])
def test_builder_errors_equal(case):
    ivf = _fake_ivf(3)
    args, kw = {
        "crid_input": ((b"CRID" + bytes(60),), {}),
        "not_ivf": ((b"RIFF" + bytes(60),), {}),
        "encrypt_no_key": ((ivf, [_wav(1)]), {"encryptAudio": True}),
        "bad_codec": ((ivf, [_wav(1)]), {"audio_codec": "ahx"}),
        "adx_below_960hz": ((ivf, [_wav(63, 1, 800, 2048)]), {}),
        "alpha_not_ivf": ((ivf,), {"alpha": b"RIFF" + bytes(60)}),
    }[case]
    got = _outcome(lambda: port_usm.USMBuilder(*args, device="cpu",
                                               **kw).build())
    want = _outcome(lambda: jax_usm.USMBuilder(*args, **kw).build())
    assert got == want and want[0] == "raised"


# -- demux and metadata ----------------------------------------------------------

def _plain(x):
    """A UTF payload with each package's type enum as its (name, value)."""
    if isinstance(x, enum.Enum):
        return x.name, x.value
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    return x


def _demux(mod, blob, key=False, **kw):
    u = mod.USM(blob, key=key, **kw)
    u.demux()
    return ({k: bytes(v) for k, v in u.output.items()},
            _plain(u.get_metadata()), u.codec)


@pytest.mark.parametrize("name", ["video_key", "hca_key_encrypt",
                                  "hca_two_tracks_subtitles",
                                  "adx_key_encrypt", "adx_stream_alpha"])
def test_demux_and_metadata_equal(name):
    (_, blob), _, kw = _build_both(name)
    key = kw.get("key", False)
    got = _demux(port_usm, blob, key, device="cpu")
    assert got == _demux(jax_usm, blob, key)
    assert got[0]                                       # streams came out


def _short_write_audio_headers(blob: bytes) -> bytes:
    """The reference builder's file: its AUDIO_HEADER metadata chunks
    (@SFA, ctype 3) declare `padding` in their size but never write it."""
    out, off = bytearray(), 0
    while off < len(blob):
        tag = blob[off:off + 4]
        size = int.from_bytes(blob[off + 4:off + 8], "big")
        pad = int.from_bytes(blob[off + 10:off + 12], "big")
        ctype = blob[off + 15] & 3
        end = off + 8 + size
        chunk = blob[off:end]
        if tag == b"@SFA" and ctype == 3 and pad:
            chunk = chunk[:-pad]
        out += chunk
        off = end
    return bytes(out)


def test_demux_resyncs_over_the_reference_builders_short_chunks():
    (_, blob), _, _ = _build_both("hca_two_tracks_subtitles")
    short = _short_write_audio_headers(blob)
    assert len(short) < len(blob)
    got = _demux(port_usm, short, device="cpu")
    assert got == _demux(jax_usm, short)
    assert got[0] == _demux(port_usm, blob, device="cpu")[0]


def test_sbt_to_srt_equal():
    recs = b""
    for i, (lang, text) in enumerate([(0, b"Hello\x00\x00"), (1, b"Hallo"),
                                      (0, b"World\x00\x00")]):
        recs += struct.pack("<IIIII", lang, 1000, 1000 * (i + 1) + 3601000,
                            500, len(text)) + text
    got = port_usm.USM.__new__(port_usm.USM).sbt_to_srt(bytearray(recs))
    assert got == jax_usm.USM.__new__(jax_usm.USM).sbt_to_srt(bytearray(recs))


def test_not_a_usm_raises_alike():
    assert _outcome(port_usm.USM, b"RIFF" + bytes(60), device="cpu") == \
        _outcome(jax_usm.USM, b"RIFF" + bytes(60))


def test_mutated_usms_demux_alike():
    rng = np.random.default_rng(8)
    ivf = build_ivf([b"\x82I\x83B" + b"v" * 200, b"w" * 300], fps_num=30,
                    fps_den=1)
    blob = jax_usm.USMBuilder(ivf, key=0x1234567890AB).build()
    for k in range(N_MUTATIONS):
        mutated = _mutate(rng, blob)
        assert _outcome(_demux, port_usm, mutated, device="cpu") == \
            _outcome(_demux, jax_usm, mutated), k


# -- extract ------------------------------------------------------------------------

@pytest.mark.parametrize("name,decode", [
    ("hca", False), ("hca", True), ("hca_key_encrypt", True),
    ("hca_two_tracks_subtitles", True), ("adx", True),
    ("adx_key_encrypt", False), ("adx_key_encrypt", True),
    ("adx_stream_alpha", True), ("video_only", True)])
def test_extract_trees_equal(tmp_path, name, decode):
    (_, blob), _, kw = _build_both(name)
    key = kw.get("key", False)
    hca_key = int(key, 16) if isinstance(key, str) else (key or 0)
    path = tmp_path / "movie.usm"
    path.write_bytes(blob)
    port_usm.USM(str(path), key=key, device="cpu").extract(
        str(tmp_path / "port"), decode=decode, key=hca_key)
    jax_usm.USM(str(path), key=key).extract(str(tmp_path / "jax"),
                                            decode=decode, key=hca_key)
    got = _tree(tmp_path / "port")
    assert got == _tree(tmp_path / "jax") and got
    if decode and kw.get("audio"):
        assert any(n.endswith(".wav") for n in got)


def test_extract_of_unlisted_chunks_equal(tmp_path):
    blob = bytearray(jax_usm.USMBuilder(_fake_ivf()).build())
    payload = b"user data"
    blob += struct.pack(">4sIBBHBBBBIIII", b"@USR", 0x18 + len(payload), 0,
                        0x18, 0, 0, 0, 0, 0, 0, 0, 0, 0) + payload
    for mod, kw in ((port_usm, {"device": "cpu"}), (jax_usm, {})):
        mod.USM(bytes(blob), **kw).extract(
            str(tmp_path / mod.__name__.split(".")[0]), decode=True)
    assert _tree(tmp_path / "pycricodecs_tpu_torch") == \
        _tree(tmp_path / "pycricodecs_tpu")


class _EvilCrid:
    def __init__(self, victim):
        self.victim = victim

    def get_payload(self):
        return [{"filename": (None, "x.usm")},
                {"filename": (None, str(self.victim))},   # POSIX absolute
                {"filename": (None, "../../victim.bin")}]


class _DupCrid:
    def get_payload(self):
        return [{"filename": (None, "x.usm")},
                {"filename": (None, "track")},
                {"filename": (None, "track")}]


@pytest.mark.parametrize("crid", ["evil", "dup"])
def test_hostile_crid_names_equal(tmp_path, crid):
    ivf = build_ivf([b"\x82I\x83B" + b"v" * 200, b"w" * 100])
    blob = jax_usm.USMBuilder(ivf, audio=[_wav(5, 1, 32000, 3000)],
                              audio_codec="hca").build()
    victim = tmp_path / "victim.bin"
    victim.write_bytes(b"precious")
    trees = []
    for mod, kw in ((port_usm, {"device": "cpu"}), (jax_usm, {})):
        u = mod.USM(blob, **kw)
        u.demux()
        u.CRIDObj = _EvilCrid(victim) if crid == "evil" else _DupCrid()
        out = tmp_path / ("out." + mod.__name__.split(".")[0])
        u.extract(dirname=str(out))
        trees.append(_tree(out))
    assert trees[0] == trees[1] and trees[0]
    assert victim.read_bytes() == b"precious"


# -- _decode_audio --------------------------------------------------------------------

def _hca_enciphered():
    plain = hca_encode_host.encode(_wav(15, 2, 48000, 8192), quality=2)
    hs = int.from_bytes(plain[6:8], "big")
    return jax_hca.crypt(plain, True, hs, 56, 0xCF222F1FE0748978, 0xBEEF)


@pytest.mark.parametrize("case", ["ahx", "adx", "not_audio", "truncated",
                                  "hca_subkey", "hca_wrong_subkey", "wav"])
def test_decode_audio_equal(case):
    pcm = make_sine_pcm16(22050, 1, 22050, seed=14)
    key = 0xCF222F1FE0748978
    data, kw = {
        "ahx": lambda: (JaxAHX.encode(write_wav(pcm, 1, 22050),
                                      bitrate_kbps=96), {}),
        "adx": lambda: (jax_adx.encode(write_wav(pcm, 1, 22050)), {}),
        "not_audio": lambda: (b"\x00" * 64, {}),
        "truncated": lambda: (b"\x80\x00\xff", {}),
        "hca_subkey": lambda: (_hca_enciphered(),
                               {"key": key, "subkey": 0xBEEF}),
        "hca_wrong_subkey": lambda: (_hca_enciphered(),
                                     {"key": key, "subkey": 0x1234}),
        "wav": lambda: (write_wav(pcm, 1, 22050), {}),
    }[case]()
    got = port_usm.USM._decode_audio(data, device="cpu", **kw)
    want = jax_usm.USM._decode_audio(data, **kw)
    assert got == want
    assert (want is None) == (case in ("not_audio", "truncated",
                                       "hca_wrong_subkey", "wav"))


@pytest.mark.parametrize("codec", ["hca", "adx"])
def test_a_failed_launch_under_extract_decode_raises(tmp_path, monkeypatch,
                                                     codec):
    """A kernel's build or launch failure (RuntimeError) propagates out of
    extract(decode=True): the JAX package's catch-all would write the raw
    payload with a warning and exit 0."""
    from pycricodecs_tpu_torch.models import adx as port_adx
    from pycricodecs_tpu_torch.models import hca as port_hca

    (_, blob), _, _ = _build_both(codec)

    def failed_launch(*args, **kw):
        raise RuntimeError("hca_transform: CUDA launch failed with error 700")

    monkeypatch.setattr(port_hca if codec == "hca" else port_adx, "decode",
                        failed_launch)
    with pytest.raises(RuntimeError, match="launch failed"):
        port_usm.USM(blob, device="cpu").extract(str(tmp_path / "x"),
                                                 decode=True)
    assert not any(n.endswith((".sfa", ".wav"))
                   for n in _tree(tmp_path / "x"))


WRAPPER_ERROR = "src: expected a CUDA tensor, got cpu"


@pytest.mark.parametrize("codec", ["hca", "adx"])
def test_a_wrappers_value_error_under_extract_decode_raises(tmp_path,
                                                            monkeypatch,
                                                            codec):
    """A kernel wrapper's ValueError for a wrong tensor (check_cuda's)
    raised inside the decode propagates out of extract(decode=True); only
    the decoders' bad-stream errors become a raw payload."""
    from pycricodecs_tpu_torch.ops import adx_kernels
    from pycricodecs_tpu_torch.parallel import pipeline

    (_, blob), _, _ = _build_both(codec)

    def wrong_tensor(*args, **kw):
        raise ValueError(WRAPPER_ERROR)

    if codec == "hca":
        monkeypatch.setattr(pipeline, "decode_rows", wrong_tensor)
    else:
        monkeypatch.setattr(adx_kernels, "adx_decode_device", wrong_tensor)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        port_usm.USM(blob, device="cpu").extract(str(tmp_path / "x"),
                                                 decode=True)
    assert not any(n.endswith((".sfa", ".wav"))
                   for n in _tree(tmp_path / "x"))


def test_a_wrappers_value_error_under_decode_audio_of_ahx_raises(
        monkeypatch):
    from pycricodecs_tpu_torch.ops import mp2_kernels

    pcm = make_sine_pcm16(22050, 1, 22050, seed=14)
    data = JaxAHX.encode(write_wav(pcm, 1, 22050), bitrate_kbps=96)
    assert port_usm.USM._decode_audio(data, device="cpu") == \
        jax_usm.USM._decode_audio(data)

    def wrong_tensor(*args, **kw):
        raise ValueError(WRAPPER_ERROR)

    monkeypatch.setattr(mp2_kernels, "mp2_decode_pcm", wrong_tensor)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        port_usm.USM._decode_audio(data, device="cpu")


def test_decode_audio_of_an_ahx_frame_past_its_end_is_none():
    """A bad AHX stream whose error comes after the host's parse (a frame
    whose fields run past its end) is None, as in the JAX package, while
    AHX.decode raises for it."""
    from pycricodecs_tpu_torch.models.ahx import AHX as PortAHX
    from tests import torch_port_helpers as H
    from tests.test_torch_surfaces import _truncated_frame

    _, blobs = H.load_ahx_fixtures()
    data = _truncated_frame(blobs["ahx11_lsf_mono_22k_1s"])
    with pytest.raises(ValueError, match="truncated mid-field"):
        PortAHX.decode(data, device="cpu")
    assert jax_usm.USM._decode_audio(data) is None
    assert port_usm.USM._decode_audio(data, device="cpu") is None
