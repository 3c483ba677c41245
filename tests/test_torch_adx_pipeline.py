"""PyTorch port, the batched ADX entry points on the CPU (kernels' twins):
adx_decode_batch and adx_encode_batch are byte-equal to
pycricodecs_tpu.parallel.adx_decode_batch / adx_encode_batch and to
pycricodecs_tpu.models.adx.decode / encode.

One mixed decode call covers modes 2/3/4, several geometries (spb > 256
included, which the JAX device path sends to the host), versions 3/4/5,
sample rates and highpass values sharing a launch, looping, a truncated
stream, an early EOF block and a zero-sample stream. Encode covers every
keyword and a WAV shorter than one block; decoding the port's encode gives
the JAX decode. Also: errors, and the launch counters stay 0 on the CPU.
"""
import numpy as np
import pytest

from pycricodecs_tpu import parallel as jax_parallel
from pycricodecs_tpu.models import adx as jax_adx
from pycricodecs_tpu_torch import parallel as port_parallel
from pycricodecs_tpu_torch.ops import cuda_kernels
from tests import torch_port_helpers as H


def _patch(blob: bytes, off: int, data: bytes) -> bytes:
    out = bytearray(blob)
    out[off:off + len(data)] = data
    return bytes(out)


def _payload_start(blob: bytes) -> int:
    return jax_adx.parse_adx_header(blob).data_offset + 4


def _mixed_streams():
    m3 = jax_adx.encode(H.wav(6000, 2, seed=21))
    start = _payload_start(m3)
    return {
        "m3_v4_stereo": m3,
        "m3_hp1000_32k": jax_adx.encode(H.wav(5000, 2, 32000, seed=22),
                                        highpass_frequency=1000),
        "m2_f1": jax_adx.encode(H.wav(4000, 2, seed=23), encoding_mode=2,
                                filter_=1),
        "m4_mono_44k": jax_adx.encode(H.wav(5000, 1, 44100, seed=24),
                                      encoding_mode=4),
        "bd8": jax_adx.encode(H.wav(3000, 2, seed=25), bit_depth=8),
        "bd5_bs12": jax_adx.encode(H.wav(3000, 1, seed=26), bit_depth=5,
                                   block_size=12),
        "bd2_bsff": jax_adx.encode(H.wav(4000, 2, seed=27, lead_in=1012),
                                   bit_depth=2, block_size=0xFF),
        "v3": jax_adx.encode(H.wav(3000, 2, seed=28), version=3),
        "v5": jax_adx.encode(H.wav(3000, 2, seed=29), version=5),
        "looping": jax_adx.encode(H.wav(8000, 2, seed=30,
                                        loop=(1000, 6000))),
        "6ch_22k": jax_adx.encode(H.wav(2500, 6, 22050, seed=31)),
        "truncated": m3[:start + 40 * 36 + 7],
        "eof_early": _patch(m3, start + 60 * 36, b"\x80\x01"),
        "zero_samples": _patch(m3, 12, bytes(4)),
    }


STREAM_NAMES = sorted(_mixed_streams())


@pytest.fixture(scope="module")
def mixed():
    streams = _mixed_streams()
    blobs = [streams[n] for n in STREAM_NAMES]
    return dict(blobs=blobs,
                port=port_parallel.adx_decode_batch(blobs, device="cpu"),
                jax=jax_parallel.adx_decode_batch(blobs))


@pytest.mark.parametrize("name", STREAM_NAMES)
def test_mixed_decode_matches_jax(mixed, name):
    i = STREAM_NAMES.index(name)
    got = mixed["port"][i]
    assert isinstance(got, bytes)
    assert got == mixed["jax"][i], "differs from parallel.adx_decode_batch"
    assert got == jax_adx.decode(mixed["blobs"][i]), \
        "differs from models.adx.decode"


def test_mixed_decode_cases_are_meaningful(mixed):
    out = dict(zip(STREAM_NAMES, mixed["port"]))
    assert out["looping"][36:40] == b"smpl"
    assert len(out["zero_samples"]) == 44
    for name in ("truncated", "eof_early"):
        pcm = np.frombuffer(out[name][44:], np.int16)
        assert len(pcm) == 2 * 6000
        assert pcm[:2000].any() and not pcm[-2000:].any(), name
    h = jax_adx.parse_adx_header(_mixed_streams()["bd2_bsff"])
    assert h.samples_per_block > 256


def _outcome(fn, *args, **kw):
    """Bytes, or (exception type name, message)."""
    try:
        return fn(*args, **kw)
    except Exception as exc:      # compared, not swallowed
        return type(exc).__name__, str(exc)


def test_decode_bad_header_raises_like_jax():
    good = _mixed_streams()["v3"]
    bad = _patch(good, 4, b"\x07")                   # encoding mode 7
    for blobs in ([bad], [good, bad]):
        got = _outcome(port_parallel.adx_decode_batch, blobs, device="cpu")
        ref = _outcome(jax_parallel.adx_decode_batch, blobs)
        assert got == ref == ("ValueError",
                              "Invalid/Unknown encoding mode found.")


ENCODE_KW = {
    "defaults": {},
    "m2_f1": dict(encoding_mode=2, filter_=1),
    "m4": dict(encoding_mode=4),
    "bd8": dict(bit_depth=8),
    "bd5_bs12": dict(bit_depth=5, block_size=12),
    "bd2_bsff": dict(bit_depth=2, block_size=0xFF),
    "v3": dict(version=3),
    "v5_no_loop": dict(version=5, force_not_looping=True),
    "scale_fix": dict(scale_fix=True),
    "hp1000_m3": dict(highpass_frequency=1000),
}


def _encode_inputs():
    return [H.wav(4000, 2, seed=41, lead_in=1024),
            H.wav(6000, 1, 44100, seed=42, lead_in=1024, loop=(700, 5000)),
            H.wav(1500, 6, 22050, seed=43, lead_in=1024),
            H.wav(10, 1, seed=44, lead_in=0)]      # shorter than one block


@pytest.mark.parametrize("kw", sorted(ENCODE_KW))
def test_encode_matches_jax_and_roundtrips(kw):
    wavs = _encode_inputs()
    args = ENCODE_KW[kw]
    got = port_parallel.adx_encode_batch(wavs, device="cpu", **args)
    assert got == jax_parallel.adx_encode_batch(wavs, **args), \
        "differs from parallel.adx_encode_batch"
    assert got == [jax_adx.encode(w, **args) for w in wavs], \
        "differs from models.adx.encode"
    for blob in got:
        back = _outcome(port_parallel.adx_decode_batch, [blob], device="cpu")
        assert back == _outcome(jax_parallel.adx_decode_batch, [blob])


def test_encode_bad_wav_raises_like_jax():
    wavs = [H.wav(400, 2), b"RIFF" + bytes(40)]
    got = _outcome(port_parallel.adx_encode_batch, wavs, device="cpu")
    ref = _outcome(jax_parallel.adx_encode_batch, wavs)
    assert got == ref and got[0] == "WavError"
    got = _outcome(port_parallel.adx_encode_batch, wavs[:1], device="cpu",
                   filter_=4)
    assert got == _outcome(jax_parallel.adx_encode_batch, wavs[:1],
                           filter_=4)
    assert got[0] == "ValueError"


def test_adx_launch_counters_stay_zero_on_cpu():
    blob = jax_adx.encode(H.wav(2000, 2, seed=45))
    port_parallel.adx_decode_batch([blob], device="cpu")
    port_parallel.adx_encode_batch([H.wav(2000, 2, seed=45)], device="cpu")
    assert cuda_kernels.ADX_DECODE_LAUNCHES == 0
    assert cuda_kernels.ADX_ENCODE_LAUNCHES == 0
