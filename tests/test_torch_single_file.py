"""PyTorch port, the single-file surfaces on the CPU (kernels' twins):
models.adx.decode / encode and the ADX class, encode_batch, the HCA class
(HCA or WAV input, info, decode, encode at every quality, encrypt,
decrypt, the drop-in accessors) and models.hca.decode, and the AHX class
(parse_header, decode, encode, info) give the JAX package's bytes, values and
errors on the committed fixtures and on patched streams. AHX.decode
zero-fills to the declared sample count as the JAX single-file AHX.decode
does (ahx_decode_batch trims).
"""
import numpy as np
import pytest

from pycricodecs_tpu import parallel as jax_parallel
from pycricodecs_tpu.containers.chunk import CriHcaQuality as JQ
from pycricodecs_tpu.models import adx as jax_adx
from pycricodecs_tpu.models import ahx as jax_ahx
from pycricodecs_tpu.models import hca as jax_hca
import pycricodecs_tpu_torch as port
from pycricodecs_tpu_torch.containers.chunk import CriHcaQuality as PQ
from pycricodecs_tpu_torch.models import adx as port_adx
from pycricodecs_tpu_torch.models import hca as port_hca
from tests import torch_port_helpers as H

ADX_EXPECTED, ADX_BLOBS = H.load_adx_fixtures()
# the twin runs the recurrence sample by sample: three 1 s streams (mode 4,
# looping, 6 channels); tests/test_torch_adx_fixtures.py decodes them all
ADX_SMALL = ["adx_6ch_1s", "adx_loop_stereo_1s", "adx_m4_stereo_1s"]
HCA_EXPECTED, HCA_BLOBS = H.load_fixtures()
HCA_SMALL = sorted(n for n in HCA_EXPECTED if HCA_EXPECTED[n]["seconds"] < 2)
AHX_EXPECTED, AHX_BLOBS = H.load_ahx_fixtures()
AHX_SMALL = sorted(n for n in AHX_EXPECTED
                   if AHX_EXPECTED[n]["file"].endswith(".ahx")
                   and "bank" not in n)


# -- ADX -----------------------------------------------------------------------

@pytest.mark.parametrize("name", ADX_SMALL)
def test_adx_decode_equals_jax(name):
    blob = ADX_BLOBS[name]
    got = port_adx.decode(blob, device="cpu")
    assert got == jax_adx.decode(blob)
    assert H.sha256(got) == ADX_EXPECTED[name]["wav_sha256"]
    assert port.ADX.decode(blob, device="cpu") == got
    assert port_adx.decode(blob, False, device="cpu") == got


def test_adx_decode_strictness_and_errors_equal():
    blob = jax_adx.encode(H.wav(3000, 2, seed=7, lead_in=0))
    assert H.outcome(port_adx.decode, blob, device="cpu") == \
        H.outcome(jax_adx.decode, blob)
    assert port_adx.decode(blob, strict_cri_check=False, device="cpu") == \
        jax_adx.decode(blob, strict_cri_check=False)
    for bad in (blob[:10], b"\x80\x00" + blob[2:4] + b"\x11" + blob[5:]):
        got = H.outcome(port_adx.decode, bad, device="cpu")
        assert isinstance(got, tuple) and got == H.outcome(jax_adx.decode,
                                                           bad)


ENCODE_CASES = {
    "defaults": ((), {}),
    "positional": ((8, 0x12, 2, 0x1F4, 3, 3), {}),
    "m4_v5_no_loop": ((), dict(encoding_mode=4, version=5,
                               force_not_looping=True)),
    "scale_fix_bd8": ((), dict(bit_depth=8, scale_fix=True)),
}


@pytest.mark.parametrize("case", sorted(ENCODE_CASES))
def test_adx_encode_equals_jax(case):
    args, kw = ENCODE_CASES[case]
    wav = H.wav(5000, 2, 44100, seed=8, loop=(500, 4000))
    got = port_adx.encode(wav, *args, device="cpu", **kw)
    assert got == jax_adx.encode(wav, *args, **kw)


def test_adx_class_encode_and_encode_batch_equal_jax():
    wavs = [H.wav(3000, 1, seed=9), H.wav(2000, 2, 32000, seed=10)]
    camel = dict(BitDepth=5, Blocksize=12, Encoding=2, AdxVersion=3,
                 Highpass_Frequency=800, Filter=1)
    for w in wavs:
        assert port.ADX.encode(w, device="cpu", **camel) == \
            jax_adx.ADX.encode(w, **camel)
    kw = dict(bit_depth=8, encoding_mode=4)
    assert port.encode_batch(wavs, device="cpu", **kw) == \
        jax_parallel.encode_batch(wavs, **kw)
    assert port.encode_batch([], device="cpu") == []


# -- HCA -----------------------------------------------------------------------

@pytest.mark.parametrize("name", HCA_SMALL)
def test_hca_info_and_decode_equal_jax(name):
    blob = HCA_BLOBS[name]
    got, ref = port.HCA(blob, device="cpu"), jax_hca.HCA(blob)
    assert got.info() == ref.info()
    wav = got.decode()
    assert wav == ref.decode()
    assert H.sha256(wav) == HCA_EXPECTED[name]["wav_sha256"]
    assert port_hca.decode(blob, device="cpu") == wav
    assert got.get_header() == ref.get_header()
    assert list(got.get_frames()) == list(ref.get_frames())
    for attr in ("version", "header_size", "looping", "encrypted",
                 "filetype", "HcaSig"):
        assert getattr(got, attr) == getattr(ref, attr), attr


def test_hca_decode_truncated_and_enciphered_streams_equal_jax():
    blob = HCA_BLOBS["q4_stereo_48k_1s"]
    hs = H.header_size(blob)
    fs = jax_hca.HCA(blob).info()["FrameSize"]
    for cut in (blob[:hs + 10 * fs + 17], blob[:hs + 3 * fs]):
        assert port_hca.decode(cut, device="cpu") == jax_hca.decode(cut)
    enc = jax_hca.crypt(blob, True, hs, 56, port_hca.DEFAULT_KEY, 0x1234)
    for key, subkey in ((0, 0x1234), (hex(port_hca.DEFAULT_KEY)[2:], "1234")):
        got = port.HCA(enc, key=key, subkey=subkey, device="cpu")
        ref = jax_hca.HCA(enc, key=key, subkey=subkey)
        assert got.key == ref.key == port_hca.DEFAULT_KEY
        assert got.info() == ref.info() and got.encrypted
        assert got.decode() == ref.decode() == jax_hca.decode(blob)


def test_hca_wav_input_info_equal_jax():
    for wav in (H.wav(3000, 2, seed=11), H.wav(2000, 1, seed=12,
                                                loop=(100, 1500))):
        got, ref = port.HCA(wav, device="cpu"), jax_hca.HCA(wav)
        assert got.info() == ref.info()
        assert got.filetype == ref.filetype == "wav"
        assert got.looping == ref.looping
        assert getattr(got, "LoopStartSample", None) == \
            getattr(ref, "LoopStartSample", None)
    assert port_hca.DEFAULT_KEY == jax_hca.DEFAULT_KEY


@pytest.mark.parametrize("quality", [q.name for q in PQ])
def test_hca_encode_every_quality_equals_jax(quality):
    wav = H.wav(6000, 2, seed=13)
    got = port.HCA(wav, device="cpu").encode(quality_level=PQ[quality])
    assert got == jax_hca.HCA(wav).encode(quality_level=JQ[quality])


def test_hca_encode_encrypt_decrypt_equal_jax():
    wav = H.wav(4000, 1, seed=14, loop=(500, 3000))
    for kw in (dict(encrypt=True), dict(encrypt=True, keyless=True),
               dict(force_not_looping=True)):
        got, ref = port.HCA(wav, device="cpu"), jax_hca.HCA(wav)
        assert got.encode(**kw) == ref.encode(**kw)
        assert got.info() == ref.info() and got.key == ref.key
        if kw.get("encrypt"):
            got.decrypt()
            ref.decrypt()
            assert got.get_hca() == ref.get_hca()
    got = port.HCA(wav, key=0x1122334455667788, device="cpu")
    ref = jax_hca.HCA(wav, key=0x1122334455667788)
    got.encode()
    ref.encode()
    got.encrypt(subkey=7)
    ref.encrypt(subkey=7)
    assert got.get_hca() == ref.get_hca()
    # decode() reads with the instance's subkey (0), not the 7 of encrypt
    assert H.outcome(got.decode)[0] == "HcaError"
    assert isinstance(H.outcome(ref.decode), tuple)
    assert port.HCA(got.get_hca(), key=got.key, subkey=7,
                    device="cpu").decode() == \
        jax_hca.HCA(ref.get_hca(), key=ref.key, subkey=7).decode()


def test_hca_errors_equal_jax():
    blob, wav = HCA_BLOBS["q2_mono_48k_1s"], H.wav(1000, 1)
    cases = [
        (lambda m, **d: m.HCA(wav, **d).decode(), {}),
        (lambda m, **d: m.HCA(blob, **d).encode(), {}),
        (lambda m, **d: m.HCA(wav, **d).encode(quality_level=3), {}),
        (lambda m, **d: m.HCA(blob, key=-1, **d), {}),
        (lambda m, **d: m.HCA(blob, key=1 << 64, **d), {}),
        (lambda m, **d: m.HCA(blob, subkey=1 << 16, **d), {}),
        (lambda m, **d: m.HCA(blob, **d).decrypt(), {}),
        (lambda m, **d: m.HCA(b"OggS" + bytes(40), **d), {}),
    ]
    for fn, _ in cases:
        got = H.outcome(fn, port, device="cpu")
        ref = H.outcome(fn, jax_hca)
        assert isinstance(got, tuple) and got == ref


# -- AHX -----------------------------------------------------------------------

@pytest.mark.parametrize("name", AHX_SMALL)
def test_ahx_decode_and_info_equal_jax(name):
    blob = AHX_BLOBS[name]
    got = port.AHX.decode(blob, device="cpu")
    assert got == jax_ahx.AHX.decode(blob)
    assert H.sha256(got) == AHX_EXPECTED[name]["wav_sha256"]
    assert port.AHX.info(blob) == jax_ahx.AHX.info(blob)
    assert port.AHX.parse_header(blob) == jax_ahx.AHX.parse_header(blob)


def _declared(blob: bytes, total: int) -> bytes:
    out = bytearray(blob)
    out[12:16] = total.to_bytes(4, "big")
    return bytes(out)


def test_ahx_decode_zero_fills_to_the_declared_count():
    blob = AHX_BLOBS["ahx11_lsf_mono_22k_1s"]
    frames = AHX_EXPECTED["ahx11_lsf_mono_22k_1s"]["frames"]
    for total in (frames * 1152 + 5000, 1000, 0):
        d = _declared(blob, total)
        got = port.AHX.decode(d, device="cpu")
        assert got == jax_ahx.AHX.decode(d)
        n = (len(got) - 44) // 2
        assert n == (total or frames * 1152)
        if total > frames * 1152:
            pcm = np.frombuffer(got[44:], np.int16)
            assert not pcm[frames * 1152:].any()
            batch = port.ahx_decode_batch([d], device="cpu")[0]
            assert (len(batch) - 44) // 2 == frames * 1152
            assert batch[44:] == got[44:44 + 2 * frames * 1152]


def test_ahx_errors_equal_jax(tmp_path):
    blob = AHX_BLOBS["ahx10_lsf_mono_16k_1s"]
    path = tmp_path / "a.ahx"
    path.write_bytes(blob)
    assert port.AHX.decode(str(path), device="cpu") == \
        jax_ahx.AHX.decode(str(path))
    assert port.AHX.info(str(path)) == jax_ahx.AHX.info(str(path))
    bare = AHX_BLOBS["mp2_lsf_mono_24k_1s"]
    no_cri = blob.replace(b"(c)CRI", b"(c)XYZ")
    for bad in (bare, no_cri, blob[:0x10], blob[:2] + b"\x00\x20\x03" +
                blob[5:]):
        got = H.outcome(port.AHX.decode, bad, device="cpu")
        assert isinstance(got, tuple)
        assert got == H.outcome(jax_ahx.AHX.decode, bad)
        assert H.outcome(port.AHX.info, bad) == \
            H.outcome(jax_ahx.AHX.info, bad)
    wav = H.wav(5000, 1, 22050)
    assert port.AHX.encode(wav, 64, device="cpu") == \
        jax_ahx.AHX.encode(wav, 64)
    assert H.outcome(port.AHX.encode, wav, 64, 0x12, device="cpu") == \
        H.outcome(jax_ahx.AHX.encode, wav, 64, 0x12)
