"""PyTorch port, the ADX fixtures that chip_smoke.py holds the card to
(tests/data/torch_port/adx/): every recorded hash is the JAX package's
(input WAV rebuilt from the port's signal recipe by either package's WAV
writer, its encode, its decode), and the port on the CPU reproduces each.
"""
import hashlib

import pytest

from pycricodecs_tpu import parallel as jax_parallel
from pycricodecs_tpu.models import adx as jax_adx
from pycricodecs_tpu.utils import wav as jax_wav
from pycricodecs_tpu_torch import parallel as port_parallel
from pycricodecs_tpu_torch.utils import signals
from pycricodecs_tpu_torch.utils import wav as port_wav
from tests import torch_port_helpers as H


def _sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def test_adx_signal_table_matches_the_fixtures():
    expected, _ = H.load_adx_fixtures()
    assert sorted(signals.ADX_STREAMS) == sorted(expected)
    for name, (channels, seconds, loop, kw) in signals.ADX_STREAMS.items():
        e = expected[name]
        assert (e["channels"], e["seconds"], e["encode"]) == \
            (channels, seconds, kw), name
        assert e["loop"] == (list(loop) if loop else None), name


@pytest.mark.parametrize("name", sorted(H.load_adx_fixtures()[0]))
def test_adx_fixture_hashes_match_jax_and_port(name):
    expected, blobs = H.load_adx_fixtures()
    e, blob = expected[name], blobs[name]
    wav = signals.adx_wav(name, jax_wav.write_wav)
    assert wav == signals.adx_wav(name, port_wav.write_wav)
    assert _sha(wav) == e["wav_in_sha256"]
    assert _sha(blob) == e["adx_sha256"]
    assert _sha(jax_adx.encode(wav, **e["encode"])) == e["adx_sha256"]
    assert _sha(jax_parallel.adx_decode_batch([blob])[0]) == e["wav_sha256"]
    got = port_parallel.adx_decode_batch([blob], device="cpu")[0]
    assert _sha(got) == e["wav_sha256"]
    got = port_parallel.adx_encode_batch([wav], device="cpu", **e["encode"])
    assert _sha(got[0]) == e["adx_sha256"]
