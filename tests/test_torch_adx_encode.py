"""PyTorch port, ADX encode on the CPU: kernel B8's plain twin
(adx_encode_plain) equals adx_encode_serial_pallas in interpret mode, and
its blocks (scale words + adx_pack) equal the JAX host packer's; at
spb == 1, which the serial Pallas kernel refuses, it equals the encoder that
pycricodecs_tpu.models.adx.encode runs (the native library).
"""
import ctypes

import numpy as np
import pytest
import torch

from pycricodecs_tpu import native
from pycricodecs_tpu.models import adx as jax_adx
from pycricodecs_tpu.ops import adx_kernels as JK
from pycricodecs_tpu_torch import parallel as port_parallel
from pycricodecs_tpu_torch.ops import adx_kernels as PK
from tests import torch_port_helpers as H
from tests.conftest import make_sine_pcm16


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# tests/test_adx.py::test_adx_encode_serial_pallas_matches_scan's cases
@pytest.mark.parametrize("mode,bd,bs,sfix", [
    (3, 4, 0x12, False), (4, 4, 0x12, False), (2, 4, 0x12, False),
    (3, 8, 0x12, False), (3, 2, 0x12, False),
    (3, 5, 12, False), (3, 11, 13, False),
    (3, 4, 0x12, True), (4, 12, 0x12, True),
])
def test_encode_twin_matches_serial_pallas(mode, bd, bs, sfix):
    """Zero-residual blocks (lane 2 starts silent from zero history), odd
    lane count, odd block count; the twin's blocks equal the JAX host
    packer's on the kernel's outputs."""
    spb = (bs - 2) * 8 // bd
    nb, L = 37, 3
    rng = np.random.default_rng(bd * 10 + mode)
    pcm = np.stack([
        make_sine_pcm16(nb * spb, 1, 32000, seed=bd + mode + c)
        for c in range(L)]).reshape(L, nb, spb).astype(np.int32)
    pcm[0, 5:8] = 0
    pcm[1, 20:22] = rng.integers(-30000, 30000, (2, spb))
    pcm[2, :4] = 0                          # zero-residual blocks
    if mode == 2:
        c0 = np.full(L, int(jax_adx.STATIC_COEFFICIENTS[2]), np.int32)
        c1 = np.full(L, int(jax_adx.STATIC_COEFFICIENTS[3]), np.int32)
    else:
        a, b = jax_adx.calculate_coefficients(0x1F4, 32000)
        c0 = np.full(L, a, np.int32)
        c1 = np.full(L, b, np.int32)
    h1 = pcm[:, 0, 0].copy()
    h2 = np.asarray([0, 3, 0], np.int32)
    kw = dict(spb=spb, encoding_mode=mode, bit_depth=bd, scale_fix=sfix)
    codes, sraw, zero, conv = JK.adx_encode_serial_pallas(
        pcm, c0, c1, h1, h2, interpret=True, **kw)
    assert bool(np.asarray(conv))
    want = [np.asarray(x) for x in (codes, sraw, zero)]
    got = PK.adx_encode_plain(*_t(pcm.astype(np.int16), c0, c1, h1, h2),
                              bit_depth=bd, encoding_mode=mode,
                              scale_fix=sfix)
    for name, g, w in zip(("codes", "scale_raw", "zero"), got, want):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert want[2][2, :4].all() and not want[2].all()

    filter_ = 1 if mode == 2 else 0
    blocks = PK.adx_encode_device(
        *_t(pcm.astype(np.int16), c0, c1, h1, h2), block_size=bs,
        bit_depth=bd, encoding_mode=mode, filter_=filter_, scale_fix=sfix)
    host = jax_adx._assemble_payload(
        want[0], want[1], want[2], frames=nb, channels=L, block_size=bs,
        bit_depth=bd, encoding_mode=mode, filter_=filter_)
    np.testing.assert_array_equal(blocks.numpy(), np.moveaxis(host, 0, 1))


def _native_encode_blocks(pcm, c0, c1, h1, h2, *, block_size, bit_depth,
                          encoding_mode):
    """The raw blocks pycricodecs_tpu.models.adx.encode computes (its native
    single-call encoder, cri_adx_encode_blocks), as [C, nb, block_size]."""
    lib = native.load()
    assert lib is not None, "the native library builds with g++"
    C, nb, spb = pcm.shape
    x = np.ascontiguousarray(pcm.reshape(C, nb * spb), dtype=np.int16)
    out = np.empty((nb, C, block_size), dtype=np.uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.cri_adx_encode_blocks(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), np.int32(nb),
        np.int32(C), np.int32(block_size), np.int32(bit_depth),
        np.int32(encoding_mode), np.int32(0), np.int32(c0), np.int32(c1),
        np.ascontiguousarray(h1, np.int32).ctypes.data_as(i32p),
        np.ascontiguousarray(h2, np.int32).ctypes.data_as(i32p),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), np.int32(0),
        np.int32(0))
    return np.moveaxis(out, 0, 1)


def test_encode_spb1_follows_the_public_encoder():
    """Block size 3 at 8 bits is the only spb == 1 geometry. The public
    encoder (native) takes the residual range over the block's one sample
    and, after a zero block, carries h2 = the new h1. adx_encode_numpy and
    adx_encode_scan both add a second residual (their prev2 column
    broadcasts), so they find fewer zero blocks; the port follows the public
    encoder."""
    L, B = 4, 400
    c0, c1 = jax_adx.calculate_coefficients(0x1F4, 48000)
    t = np.arange(B)
    rng = np.random.default_rng(0)
    pcm = np.stack([(60 + 40 * np.sin(2 * np.pi * t / (37 + 11 * lane))
                     + rng.normal(0, 3, B)).astype(np.int32)
                    for lane in range(L)])[:, :, None]
    h1 = pcm[:, 0, 0].copy()
    lanes = (np.full(L, c0, np.int32), np.full(L, c1, np.int32), h1, h1)
    kw = dict(spb=1, encoding_mode=3, bit_depth=8)
    public = _native_encode_blocks(pcm, c0, c1, h1, h1, block_size=3,
                                   bit_depth=8, encoding_mode=3)
    got = PK.adx_encode_device(*_t(pcm.astype(np.int16), *lanes),
                               block_size=3, bit_depth=8, encoding_mode=3)
    np.testing.assert_array_equal(got.numpy(), public)
    codes, sraw, zero = PK.adx_encode_plain(*_t(pcm, *lanes), bit_depth=8,
                                            encoding_mode=3)
    native_lanes = JK.adx_encode_host(pcm, *lanes, **kw)
    for g, w in zip((codes, sraw, zero), native_lanes):
        np.testing.assert_array_equal(g.numpy(), w)
    # the JAX package's other engines differ here: lane 0, block 18 is a
    # zero block for the public encoder and not for them
    for other in (JK.adx_encode_numpy(pcm, *lanes, **kw),
                  JK.adx_encode_scan(pcm, *lanes, **kw)):
        z = np.asarray(other[2])
        assert zero[0, 18] and not z[0, 18]
        assert not np.array_equal(np.asarray(other[0]), codes.numpy())


def test_encode_batch_block_size_3_raises_like_jax():
    """At block size 3 the EOF block's length field (block_size - 4) is
    negative: every engine of the JAX package, and the port, raises in
    stream assembly after encoding."""
    src = H.wav(300, 1)
    with pytest.raises(OverflowError) as ref:
        jax_adx.encode(src, bit_depth=8, block_size=3)
    with pytest.raises(OverflowError) as got:
        port_parallel.adx_encode_batch([src], bit_depth=8, block_size=3,
                                       device="cpu")
    assert str(got.value) == str(ref.value)
