"""PyTorch port, CRILAYLA's hand-made edge streams on the CPU:
`signals.crilayla_fill_blob` (three literals and one long copy, the shape
of the 2^32 - 1 member that tools/check_crilayla_limits.py decompresses on
the card), `signals.crilayla_wrap_blob` (a copy whose 255-run sums past
2^32, so its u32 length wraps, as the JAX native's, to a few bytes) and
`signals.crilayla_zero_blob` (all zero bits: C1's chunk
parses start off phase, so its serial repair parses most of the stream,
the stream chip_smoke.py times at 1 MiB). The port's plain version equals
the JAX package's decompress and the known bytes; the numpy model of C1's
kernels (tests/test_torch_crilayla.py) decodes both, records positions
below the decompress size (what lets C1 take any u32 size), and repairs
about 8 chunks in 9 of the zero stream.
"""
import numpy as np
import pytest

from pycricodecs_tpu.models import crilayla as jax_crilayla
from pycricodecs_tpu_torch.models import crilayla
from pycricodecs_tpu_torch.ops import cuda_kernels as CK
from pycricodecs_tpu_torch.utils import signals
from tests.test_torch_crilayla import c1_model, c1_parse


@pytest.mark.parametrize("size", [47, 48, 301, 70_000])
def test_fill_blob_equals_jax_and_its_known_bytes(size):
    blob = signals.crilayla_fill_blob(size, 0x3C)
    want = bytes(256) + b"\x3c" * size
    assert jax_crilayla.decompress(blob) == want
    assert crilayla.decompress(blob, device="cpu") == want


def test_fill_blob_at_the_largest_u32_size():
    """The card's edge member: decompress size 2^32 - 1, its copy's
    length a run of 16,843,008 bytes of 255, accepted by the header
    checks."""
    blob = signals.crilayla_fill_blob((1 << 32) - 1)
    payload, cs, ds = crilayla.parse(blob)
    assert ds == (1 << 32) - 1 and cs == 16_843_016
    assert len(blob) == 16 + cs + 256 and payload[cs:] == bytes(256)
    assert payload[2:cs - 7] == b"\xff" * (cs - 9)   # the run, read last
    with pytest.raises(ValueError, match="range|size"):
        signals.crilayla_fill_blob(1 << 32)


def test_wrap_blob_equals_jax_and_its_known_bytes():
    """The copy's length wraps to 40 bytes and the 16 literals after it
    are read: the port's plain version (its Python loop reads the 16.84 MB
    run, about 12 s) gives the JAX native's bytes."""
    tail = bytes(range(1, 17))
    blob = signals.crilayla_wrap_blob(40, tail, 0xAB)
    payload, cs, ds = crilayla.parse(blob)
    assert ds == 3 + 40 + 16 and cs > ((1 << 32) - 44) // 255
    want = bytes(256) + tail[::-1] + b"\xab" * 43
    assert jax_crilayla.decompress(blob) == want
    assert crilayla.decompress(blob, device="cpu") == want


def test_zero_blob_equals_jax_at_64_kib():
    blob = signals.crilayla_zero_blob(1 << 16)
    want = bytes((1 << 16) + 256)
    assert jax_crilayla.decompress(blob) == want
    assert crilayla.decompress(blob, device="cpu") == want


def test_c1_model_repairs_most_of_the_zero_stream():
    size = 1 << 16
    payload, cs, ds = crilayla.parse(signals.crilayla_zero_blob(size))
    trace = {}
    recs, status, steps = c1_parse(payload, cs, ds, trace=trace)
    assert status == 0 and steps == size
    chunks = trace["chunks"]
    met_at_start = sum(c["conv"] == 0 for c in chunks)
    assert len(chunks) == -(-8 * cs // CK.CRILAYLA_CHUNK_BITS)
    # chunk k starts 4k bits mod 9 into a literal: one in nine meets at once
    assert met_at_start == sum(k % 9 == 0 for k in range(len(chunks)))
    assert trace["repaired"] > 0.85 * size
    assert c1_model(payload, cs, ds) == bytes(size + 256)


def test_c1_model_records_positions_below_the_decompress_size():
    size = 100_000
    payload, cs, ds = crilayla.parse(signals.crilayla_fill_blob(size, 7))
    recs, status, steps = c1_parse(payload, cs, ds)
    assert status == 0 and steps == 4
    assert [r[0] for r in recs] == [size - 1, size - 2, size - 3, size - 4]
    assert [r[2] for r in recs] == [None, None, None, 3]
    assert c1_model(payload, cs, ds) == bytes(256) + b"\x07" * size
