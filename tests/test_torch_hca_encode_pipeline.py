"""PyTorch port, the batched HCA encode on the CPU (kernels' twins):
`hca_encode_batch(..., device="cpu")` is byte-equal to
pycricodecs_tpu.parallel.hca_encode_batch(..., device=True) and to the JAX
package's host encoder, over mono, stereo and 6/8 channels, qualities 0-4,
a mixed (channels, rate) batch of unequal lengths, a WAV shorter than a
frame, and a looping WAV with and without force_not_looping. Also: the
committed fixtures, the round trip through the port's decode, the frame
cipher (`crypt`), errors, and the launch counters staying 0 on the CPU.
"""
import hashlib

import numpy as np
import pytest

from pycricodecs_tpu import parallel as jax_parallel
from pycricodecs_tpu.models import hca as jax_hca
from pycricodecs_tpu.ops import hca_encode_host as JH
from pycricodecs_tpu.utils.wav import write_wav
import pycricodecs_tpu_torch as port
from pycricodecs_tpu_torch.ops import cuda_kernels
from pycricodecs_tpu_torch.ops import hca_frame as port_frame
from pycricodecs_tpu_torch.utils import signals
from pycricodecs_tpu_torch.utils.wav import write_wav as port_write_wav
from tests import torch_port_helpers as H
from tests.conftest import make_sine_pcm16


def _wav(samples, channels, rate=48000, seed=0, loop=None):
    pcm = make_sine_pcm16(samples, channels, rate, seed=seed)
    if loop is None:
        return write_wav(pcm, channels, rate)
    return write_wav(pcm, channels, rate, looping=True, loop_start=loop[0],
                     loop_end=loop[1])


# one call, four (channels, rate) groups, unequal lengths, a WAV shorter
# than one frame
MIXED = [
    ("stereo_12k", 12000, 2, 48000),
    ("mono_8k", 8000, 1, 48000),
    ("6ch_6k", 6000, 6, 48000),
    ("stereo_5k", 5000, 2, 48000),
    ("stereo_44k", 9000, 2, 44100),
    ("stereo_500", 500, 2, 48000),
    ("8ch_4k", 4096, 8, 48000),
]


@pytest.mark.parametrize("quality", [0, 1, 2, 3, 4])
def test_mixed_batch_matches_jax_batch_and_host(quality):
    wavs = [_wav(n, ch, rate, seed=i) for i, (_, n, ch, rate)
            in enumerate(MIXED)]
    got = port.hca_encode_batch(wavs, quality=quality, device="cpu")
    ref = jax_parallel.hca_encode_batch(wavs, quality=quality, device=True)
    for (name, *_), g, r, w in zip(MIXED, got, ref, wavs):
        assert g == r, name
        assert g == JH.encode(w, quality=quality), name


@pytest.mark.parametrize("force_not_looping", [False, True])
def test_looping_wav_matches_jax(force_not_looping):
    wavs = [_wav(30000, 2, seed=3, loop=(4000, 20000)),
            _wav(20000, 2, seed=4, loop=(1500, 9000))]
    got = port.hca_encode_batch(wavs, quality=2, device="cpu",
                                force_not_looping=force_not_looping)
    ref = jax_parallel.hca_encode_batch(
        wavs, quality=2, device=True, force_not_looping=force_not_looping)
    assert got == ref
    for g, w in zip(got, wavs):
        assert g == JH.encode(w, quality=2,
                              force_not_looping=force_not_looping)
    hs = H.header_size(got[0])
    info = port_frame.parse_header(got[0][:hs])
    assert info.loop_flag is (not force_not_looping)


@pytest.mark.parametrize("quality", [0, 4])
def test_full_scale_noise_matches_host(quality):
    """Full-scale white noise: the hardest rate control the encoder meets
    (it still needs no top-band zeroing at these budgets)."""
    rng = np.random.default_rng(quality)
    pcm = np.clip(rng.standard_normal(2 * 20000) * 32767, -32768,
                  32767).astype(np.int16)
    wav = write_wav(pcm, 2, 48000)
    got = port.hca_encode_batch([wav], quality=quality, device="cpu")[0]
    assert got == JH.encode(wav, quality=quality)


def test_bad_wav_raises_like_jax():
    good = _wav(4000, 2)
    for bad in (b"RIFX" + good[4:], good[:20]):
        with pytest.raises(ValueError) as ref:
            jax_parallel.hca_encode_batch([good, bad], device=True)
        with pytest.raises(ValueError) as got:
            port.hca_encode_batch([good, bad], device="cpu")
        assert str(got.value) == str(ref.value)


def test_empty_batch():
    assert port.hca_encode_batch([], device="cpu") == []


@pytest.mark.parametrize("name", sorted(signals.HCA_STREAMS))
def test_fixture_encodes_to_the_committed_stream(name):
    expected, blobs = H.load_fixtures()
    wav = signals.hca_wav(name, port_write_wav)
    assert hashlib.sha256(wav).hexdigest() == expected[name]["wav_in_sha256"]
    got = port.hca_encode_batch([wav], quality=expected[name]["quality"],
                                device="cpu")[0]
    assert got == blobs[name]
    assert hashlib.sha256(got).hexdigest() == expected[name]["hca_sha256"]


def test_signal_table_matches_the_fixtures():
    expected, _ = H.load_fixtures()
    # beside the encode fixtures: the v3 PNS stream, a relabelled encode of
    # signals.pns_wav that is only decoded
    assert sorted([*signals.HCA_STREAMS, signals.HCA_PNS]) == sorted(expected)
    assert [n for n, e in expected.items() if e.get("v3_pns")] == \
        [signals.HCA_PNS]
    assert hashlib.sha256(signals.pns_wav(port_write_wav)).hexdigest() == \
        expected[signals.HCA_PNS]["wav_in_sha256"]
    for name, (channels, seconds, quality, loop) in \
            signals.HCA_STREAMS.items():
        e = expected[name]
        assert (e["channels"], e["seconds"], e["quality"]) == \
            (channels, seconds, quality), name
        assert e["loop"] == (list(loop) if loop else None), name


@pytest.mark.parametrize("quality", [1, 4])
def test_round_trip_through_the_port_decode(quality):
    wavs = [_wav(9000, 2, seed=5), _wav(7000, 1, seed=6),
            _wav(30000, 2, seed=7, loop=(4000, 20000))]
    hcas = port.hca_encode_batch(wavs, quality=quality, device="cpu")
    got = port.decode_batch(hcas, device="cpu")
    ref = jax_parallel.decode_batch(hcas, engine="host")
    assert got == ref


@pytest.mark.parametrize("ciph_type,subkey", [(0, 0), (1, 0), (56, 0),
                                              (56, 0x1234)])
def test_crypt_matches_jax_both_ways(ciph_type, subkey):
    plain = port.hca_encode_batch([_wav(9000, 2, seed=8)], quality=2,
                                  device="cpu")[0]
    hs = H.header_size(plain)
    enc = port.crypt(plain, True, hs, ciph_type, H.KEY, subkey)
    assert enc == jax_hca.crypt(plain, True, hs, ciph_type, H.KEY, subkey)
    if ciph_type:
        assert enc != plain
    dec = port.crypt(enc, False, hs, ciph_type, H.KEY, subkey)
    assert dec == jax_hca.crypt(enc, False, hs, ciph_type, H.KEY, subkey)
    assert dec == plain
    # the enciphered stream decodes to the plain one's WAV with the key
    want = port.decode_batch([plain], device="cpu")[0]
    assert port.decode_batch([enc], key=H.KEY, subkey=subkey,
                             device="cpu")[0] == want


def test_launch_counters_stay_zero_on_cpu():
    port.hca_encode_batch([_wav(5000, 2, seed=9)], quality=1, device="cpu")
    assert cuda_kernels.MDCT_LAUNCHES == 0
    assert cuda_kernels.PACK_LAUNCHES == 0


def test_default_device_needs_a_card():
    with pytest.raises((RuntimeError, AssertionError)):
        port.hca_encode_batch([_wav(4000, 2)])
