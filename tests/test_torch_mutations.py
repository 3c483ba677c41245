"""PyTorch port, seeded byte mutations of the committed fixtures through
the JAX package's and the port's host code (CPU): each case gives the same
result, or raises an exception of the same class, in both.

Targets: the HCA header parse, `parse_adx_header`, the @UTF reader, the AWB
reader and `parse_wav` (ten mutations a case), and `AHX.decode`,
`models.hca.decode` and `crilayla.decompress` with the port on the CPU
(its kernels' plain versions; one mutation a case). A mutation flips,
zeroes or saturates one to four bytes (inside the header for the parsers
of headers), or cuts the data short. The ADX full decode is left out: the
port's plain B7 takes seconds a stream here.
"""
import dataclasses
from enum import Enum

import numpy as np
import pytest

from pycricodecs_tpu.containers import awb as jax_awb
from pycricodecs_tpu.containers import utf as jax_utf
from pycricodecs_tpu.models import adx as jax_adx
from pycricodecs_tpu.models import ahx as jax_ahx
from pycricodecs_tpu.models import crilayla as jax_crilayla
from pycricodecs_tpu.models import hca as jax_hca
from pycricodecs_tpu.ops import hca_frame as jax_frame
from pycricodecs_tpu.utils import wav as jax_wav
from pycricodecs_tpu_torch.containers import awb as port_awb
from pycricodecs_tpu_torch.containers import utf as port_utf
from pycricodecs_tpu_torch.models import adx as port_adx
from pycricodecs_tpu_torch.models import ahx as port_ahx
from pycricodecs_tpu_torch.models import crilayla as port_crilayla
from pycricodecs_tpu_torch.models import hca as port_hca
from pycricodecs_tpu_torch.ops import hca_frame as port_frame
from pycricodecs_tpu_torch.utils import wav as port_wav
from tests import torch_port_helpers as H

_, ADX = H.load_adx_fixtures()
_, BANK = H.load_bank_fixtures()
HCA = H.load_fixture("q2_loop_stereo_48k_1s")


def mutate(data: bytes, seed: int, span: int = None) -> bytes:
    """One seeded mutation of `data`: one to four bytes of its first `span`
    flipped (kinds 0, 1) or set to 0x00 / 0xFF (kind 2), or the data cut
    at a random length (kind 3)."""
    rng = np.random.default_rng(seed)
    b = bytearray(data)
    kind = int(rng.integers(0, 4))
    if kind == 3:
        return bytes(b[:int(rng.integers(0, len(b)))])
    hi = len(b) if span is None else min(span, len(b))
    for _ in range(int(rng.integers(1, 5))):
        i = int(rng.integers(0, hi))
        b[i] = (b[i] ^ int(rng.integers(1, 256)) if kind < 2
                else int(rng.choice([0, 0xFF])))
    return bytes(b)


def outcome(fn, data):
    """("ok", fn(data)) or ("raise", its exception's class name)."""
    try:
        return "ok", fn(data)
    except Exception as exc:   # noqa: BLE001 - the class is the result
        return "raise", type(exc).__name__


def same(a, b) -> bool:
    """a (JAX) equals b (port): the packages' enums and dataclasses are
    their own classes, so those compare by name and value."""
    if isinstance(a, Enum):
        return (isinstance(b, Enum) and type(a).__name__ == type(b).__name__
                and (a.name, a.value) == (b.name, b.value))
    if dataclasses.is_dataclass(a):
        return dataclasses.is_dataclass(b) and same(
            dataclasses.asdict(a), dataclasses.asdict(b))
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return isinstance(b, (list, tuple)) and len(a) == len(b) and all(
            same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and np.array_equal(a, b))
    return type(a) is type(b) and a == b


def _utf(mod):
    def read(data):
        u = mod.UTF(data)
        return u.table, u.get_payload()
    return read


def _awb(mod):
    def read(data):
        a = mod.AWB(data)
        return a.subkey, a.ids, a.ofs, [bytes(m) for m in a.getfiles()]
    return read


ADX_BLOB = ADX["adx_loop_stereo_1s"]
WAV_BLOB = H.wav(600, 2, loop=(100, 500))

#: name -> (input, bytes a mutation may touch, JAX reader, port reader)
PARSERS = {
    "hca_parse_header": (HCA, 96, jax_frame.parse_header,
                         port_frame.parse_header),
    "parse_adx_header": (ADX_BLOB, 64, jax_adx.parse_adx_header,
                         port_adx.parse_adx_header),
    "utf": (BANK["bank"], None, _utf(jax_utf), _utf(port_utf)),
    "awb": (BANK["subkey"], 96, _awb(jax_awb), _awb(port_awb)),
    "parse_wav": (WAV_BLOB, 128, jax_wav.parse_wav, port_wav.parse_wav),
}
PER_CASE = 10


@pytest.mark.parametrize("seed", range(30))
@pytest.mark.parametrize("name", sorted(PARSERS))
def test_parsers_agree_on_mutations(name, seed):
    data, span, jax_fn, port_fn = PARSERS[name]
    for k in range(PER_CASE):
        m = mutate(data, 1000 * seed + k, span)
        want, got = outcome(jax_fn, m), outcome(port_fn, m)
        assert want[0] == got[0] and same(want[1], got[1]), (k, want, got)


@pytest.mark.parametrize("name", sorted(PARSERS))
def test_the_parser_mutations_reach_both_outcomes(name):
    data, span, jax_fn, _ = PARSERS[name]
    kinds = {outcome(jax_fn, mutate(data, 1000 * s + k, span))[0]
             for s in range(30) for k in range(PER_CASE)}
    assert kinds == {"ok", "raise"}


CRILAYLA_BLOB = jax_crilayla.compress(
    bytes(np.random.default_rng(3).integers(0, 256, 400, dtype=np.uint8))
    + b"\x11\x22\x33" * 300)
AHX_BLOB = H.load_ahx_fixtures()[1]["ahx10_lsf_mono_16k_1s"]

#: name -> (input, bytes a mutation may touch, JAX decode, port decode)
DECODERS = {
    "ahx_decode": (AHX_BLOB, None, jax_ahx.AHX.decode,
                   lambda d: port_ahx.AHX.decode(d, device="cpu")),
    "hca_decode": (HCA, None, jax_hca.decode,
                   lambda d: port_hca.decode(d, device="cpu")),
    "crilayla_decompress": (CRILAYLA_BLOB, None, jax_crilayla.decompress,
                            lambda d: port_crilayla.decompress(
                                d, device="cpu")),
}


@pytest.mark.parametrize("seed", range(20))
@pytest.mark.parametrize("name", sorted(DECODERS))
def test_decoders_agree_on_mutations(name, seed):
    data, span, jax_fn, port_fn = DECODERS[name]
    m = mutate(data, seed, span)
    want, got = outcome(jax_fn, m), outcome(port_fn, m)
    assert want[0] == got[0] and same(want[1], got[1]), (want[0], got[0])
