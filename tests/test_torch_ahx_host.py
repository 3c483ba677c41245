"""PyTorch port: the host pieces of the AHX decode are copies of the JAX
package's, equal on every fixture (tests/data/torch_port/ahx/):
mp2_tables (decode half), mp2_frame.parse_header / scan_frames,
models/ahx.parse_header and the AHX rule of utils/sniff.
"""
import hashlib
import re

import numpy as np
import pytest

from pycricodecs_tpu.models import ahx as jax_ahx
from pycricodecs_tpu.ops import mp2_frame as jax_frame
from pycricodecs_tpu.ops import mp2_tables as jax_tables
from pycricodecs_tpu.utils.sniff import sniff
from pycricodecs_tpu_torch.models import ahx as port_ahx
from pycricodecs_tpu_torch.ops import mp2_frame as port_frame
from pycricodecs_tpu_torch.ops import mp2_tables as port_tables
from tests import torch_port_helpers as H

AHX_NAMES = sorted(H.load_ahx_fixtures()[0])


def _sniffs_ahx(data: bytes) -> bool:
    """The JAX pipeline's test: sniff(data) == "ahx", False where sniff
    raises."""
    try:
        return sniff(data) == "ahx"
    except ValueError:
        return False


def test_tables_equal():
    assert port_tables.ALLOC_TABLES == jax_tables.ALLOC_TABLES
    assert port_tables.TABLE_SELECT == jax_tables.TABLE_SELECT
    assert port_tables.GROUP_BITS == jax_tables.GROUP_BITS
    for name in ("BITRATES_V1_L2", "BITRATES_V2_L2", "SAMPLE_RATES_V1",
                 "SAMPLE_RATES_V2", "SYNTH_WINDOW_INT"):
        assert getattr(port_tables, name) == getattr(jax_tables, name), name
    for n in range(1, 65536):
        assert port_tables.code_bits(n) == jax_tables.code_bits(n)


@pytest.mark.parametrize("table", ["scalefactors", "synthesis_matrixing",
                                   "synth_window"])
def test_float64_tables_equal_bit_for_bit(table):
    got = getattr(port_tables, table)()
    ref = getattr(jax_tables, table)(np.float64)
    assert got.dtype == np.float64 and got.shape == ref.shape
    np.testing.assert_array_equal(got.view(np.int64), ref.view(np.int64))


@pytest.mark.parametrize("name", AHX_NAMES)
def test_fixture_parses_like_jax(name):
    expected, blobs = H.load_ahx_fixtures()
    blob = blobs[name]
    assert hashlib.sha256(blob).hexdigest() == expected[name]["stream_sha256"]
    assert port_ahx.is_ahx(blob) == _sniffs_ahx(blob)
    off = 0
    if port_ahx.is_ahx(blob):
        info = port_ahx.parse_header(blob)
        assert info == jax_ahx.AHX.parse_header(blob)
        off = info["data_offset"]
    ph, pw = port_frame.scan_frames(blob, off)
    jh, jw = jax_frame.scan_frames(blob, off)
    assert tuple(ph) == tuple(jh) and pw == jw
    assert len(pw) == expected[name]["frames"]
    assert ph.crc == expected[name]["crc"]
    for pos, fr in pw:
        assert tuple(port_frame.parse_header(fr)) == \
            tuple(jax_frame.parse_header(fr))
    assert port_frame.scan_frames(blob, off, max_frames=3)[1] == \
        jax_frame.scan_frames(blob, off, max_frames=3)[1]


def test_every_header_word_parses_like_jax():
    """Every value of the version, layer, CRC, bitrate, rate, padding and
    mode fields (bits 9-20, sync fixed) with rotating low bits, and random
    words: the same header or the same error."""
    rng = np.random.default_rng(0)
    hi = np.arange(1 << 12, dtype=np.int64) << 9
    words = (0x7FF << 21) | hi | (np.arange(1 << 12) * 37 % 512)
    words = np.concatenate([words, rng.integers(0, 1 << 32, 4000)])
    for w in words.tolist():
        data = int(w).to_bytes(4, "big")
        try:
            ref = jax_frame.parse_header(data)
        except ValueError as exc:
            with pytest.raises(ValueError, match=re.escape(str(exc))):
                port_frame.parse_header(data)
            continue
        assert tuple(port_frame.parse_header(data)) == tuple(ref)


@pytest.mark.parametrize("data", [
    b"", b"\x80", b"\x80\x00\x00\x20\x11", b"\x80\x00" + b"\x00" * 40,
    b"\x80\x00\x00\x20\x03\x12\x04\x01" + b"\x00" * 40,
    b"\x80\x00\x00\x20\x10\x00\x00\x01" + b"\x00" * 40,
    b"\x80\x00\x00\x08\x11\x00\x00\x01" + b"\x00" * 40,
    b"\x7f\x00\x00\x20\x11" + b"\x00" * 40, b"RIFF" + b"\x00" * 40,
    b"\x80\x01\x00\x20\x11" + b"\x00" * 40,
])
def test_ahx_header_rules_match_on_bad_input(data):
    assert port_ahx.is_ahx(data) == _sniffs_ahx(data)
    try:
        ref = jax_ahx.AHX.parse_header(data)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            port_ahx.parse_header(data)
        assert str(got.value) == str(exc)
        return
    assert port_ahx.parse_header(data) == ref


def test_scan_frames_errors_match():
    for data in (b"", b"\xff\xf5\xa0\xc4" + b"\xff" * 8, b"\x00" * 64):
        with pytest.raises(ValueError) as ref:
            jax_frame.scan_frames(data, 0)
        with pytest.raises(ValueError) as got:
            port_frame.scan_frames(data, 0)
        assert str(got.value) == str(ref.value)
