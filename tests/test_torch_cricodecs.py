"""PyTorch port: CRILAYLA and the CriCodecs drop-in module on the CPU.

pycricodecs_tpu_torch.models.crilayla (on the CPU its kernels' plain
versions, copies of the JAX package's pure-Python halves) against
pycricodecs_tpu.models.crilayla (its native core here): the payloads of tests/test_crilayla.py, compressed and
decompressed alike, with its bad-magic, truncation and size errors; and
pycricodecs_tpu_torch.cricodecs against pycricodecs_tpu.cricodecs: the
seven functions' positional signatures (less the port's keyword-only
`device`) and each one's output on a small input.
"""
import inspect
import subprocess
import sys

import numpy as np
import pytest

from pycricodecs_tpu import cricodecs as jax_cc
from pycricodecs_tpu.models import crilayla as jax_crilayla
from pycricodecs_tpu_torch import cricodecs as port_cc
from pycricodecs_tpu_torch.models import crilayla
from tests import torch_port_helpers as H

FUNCTIONS = ("AdxDecode", "AdxEncode", "HcaDecode", "HcaEncode", "HcaCrypt",
             "CriLaylaDecompress", "CriLaylaCompress")


def _payloads():
    """tests/test_crilayla.py's payloads."""
    rng = np.random.default_rng(7)
    text = (b"the quick brown fox jumps over the lazy dog. " * 100)
    rep = bytes(rng.integers(0, 8, 600).astype(np.uint8)) * 5
    noisy = bytes(rng.integers(0, 256, 4096).astype(np.uint8))
    mixed = text + noisy[:512] + text[:1024]
    return {"text": text, "repetitive": rep, "noisy": noisy, "mixed": mixed}


@pytest.mark.parametrize("name", ["text", "repetitive", "noisy", "mixed"])
def test_compress_equals_jax(name):
    data = _payloads()[name]
    assert crilayla.compress(data, device="cpu") == \
        jax_crilayla.compress(data)


@pytest.mark.parametrize("name", ["text", "repetitive", "noisy", "mixed"])
def test_decompress_equals_jax(name):
    data = _payloads()[name]
    comp = jax_crilayla.compress(data)
    out = crilayla.decompress(comp, device="cpu")
    assert out == jax_crilayla.decompress(comp) == data


def test_incompressible_roundtrip():
    """Incompressible data (which crashes the reference) roundtrips, and
    compresses to the JAX package's bytes."""
    rng = np.random.default_rng(9)
    noisy = bytes(rng.integers(0, 256, 2048).astype(np.uint8))
    comp = crilayla.compress(noisy, device="cpu")
    assert comp == jax_crilayla.compress(noisy)
    assert crilayla.decompress(comp, device="cpu") == noisy


def test_medium_mixed_payload_equals_jax():
    """tests/test_crilayla.py's medium payload, its noise cut to keep the
    pure-Python matcher quick."""
    rng = np.random.default_rng(11)
    text = (b"structured segment with repeating tokens " * 400)
    noise = bytes(rng.integers(0, 256, 2000).astype(np.uint8))
    data = (text + noise + text[:5000] + noise[:600])
    comp = crilayla.compress(data, device="cpu")
    assert comp == jax_crilayla.compress(data)
    assert crilayla.decompress(comp, device="cpu") == data


def _error(fn, blob):
    try:
        fn(blob)
    except ValueError as exc:
        return str(exc)
    return None


@pytest.mark.parametrize("case", ["implausible", "bad_magic", "truncated",
                                  "short_input", "malformed"])
def test_errors_equal_jax(case):
    """A hostile size, a bad magic, a truncated blob, too short an input to
    compress and a stream that reads past its start raise ValueError with
    the JAX package's message."""
    good = jax_crilayla.compress(_payloads()["text"])
    if case == "implausible":
        blob = (b"CRILAYLA" + (0xFFFFFFFF).to_bytes(4, "little")
                + (64).to_bytes(4, "little") + b"\x00" * (64 + 256))
    elif case == "bad_magic":
        blob = b"CRILAYLB" + good[8:]
    elif case == "truncated":
        blob = good[:-10]
    elif case == "malformed":
        # a 4-byte stream of match flags whose offsets point past the end
        blob = (b"CRILAYLA" + (4096).to_bytes(4, "little")
                + (4).to_bytes(4, "little") + b"\xff" * 4 + b"\x00" * 256)
    if case == "short_input":
        got = _error(lambda b: crilayla.compress(b, device="cpu"),
                     b"x" * 200)
        want = _error(jax_crilayla._compress_py, b"x" * 200)
    else:
        got = _error(lambda b: crilayla.decompress(b, device="cpu"), blob)
        want = _error(jax_crilayla.decompress, blob)
    assert got is not None and got == want


@pytest.mark.parametrize("name", FUNCTIONS)
def test_signatures_equal_the_jax_module(name):
    sig = inspect.signature(getattr(port_cc, name))
    params = [p for p in sig.parameters.values() if p.name != "device"]
    want = inspect.signature(getattr(jax_cc, name))
    assert [(p.name, p.kind, p.default) for p in params] == \
        [(p.name, p.kind, p.default) for p in want.parameters.values()]
    if "device" in sig.parameters:
        dev = sig.parameters["device"]
        assert dev.kind == inspect.Parameter.KEYWORD_ONLY
        assert dev.default == "cuda"
    else:
        assert name == "HcaCrypt"


@pytest.fixture(scope="module")
def inputs():
    adx_wav = H.wav(samples=1500, channels=2, seed=3)
    hca_wav = H.wav(samples=3000, channels=2, seed=4, lead_in=0)
    plain = jax_cc.HcaEncode(hca_wav, 0, 2)
    return dict(adx_wav=adx_wav, adx=jax_cc.AdxEncode(adx_wav),
                hca_wav=hca_wav, plain=plain, hs=H.header_size(plain),
                keyed=jax_cc.HcaCrypt(plain, 1, H.header_size(plain), 56,
                                      H.KEY, 0x1234))


@pytest.mark.parametrize("name", FUNCTIONS)
def test_each_function_equals_the_jax_one(inputs, name):
    i = inputs
    text = _payloads()["mixed"]
    cases = {
        "AdxDecode": ((i["adx"],), True),
        "AdxEncode": ((i["adx_wav"], 4, 0x12, 2, 0x1F4, 0, 4, True), True),
        "HcaDecode": ((i["keyed"], i["hs"], H.KEY, 0x1234), True),
        "HcaEncode": ((i["hca_wav"], 1, 1), True),
        "HcaCrypt": ((i["keyed"], 0, i["hs"], 56, H.KEY, 0x1234), False),
        "CriLaylaDecompress": ((jax_crilayla.compress(text),), True),
        "CriLaylaCompress": ((text,), True),
    }
    args, on_device = cases[name]
    kw = {"device": "cpu"} if on_device else {}
    got = getattr(port_cc, name)(*args, **kw)
    assert got == getattr(jax_cc, name)(*args)
    assert isinstance(got, bytes) and len(got) > 16


def test_new_modules_import_neither_jax_nor_the_jax_package():
    """The mesh, CRILAYLA and CriCodecs modules and the port's graft entry
    (with dryrun_multichip) import no jax and nothing of pycricodecs_tpu,
    in a fresh interpreter."""
    code = ("import sys; "
            "import pycricodecs_tpu_torch.parallel.mesh, "
            "pycricodecs_tpu_torch.models.crilayla, "
            "pycricodecs_tpu_torch.cricodecs, __graft_entry_torch__; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'pycricodecs_tpu.')) "
            "or m == 'pycricodecs_tpu']; "
            "assert not bad, bad")
    root = H.FIXTURE_DIR.rsplit("/tests/", 1)[0]
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True,
                   timeout=120)
