"""PyTorch port, ADX codec building blocks on the CPU: adx_unpack and
adx_pack equal the JAX package's adx_unpack_device and adx_pack_device, and
kernel B7's plain twin (adx_decode_plain, unpack fused in) equals
adx_decode_serial_pallas in interpret mode, including mode 2 predictors 4-7
and mode 4's `1 << 31` scale, which wraps in int32 on both.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pycricodecs_tpu.models import adx as jax_adx
from pycricodecs_tpu.ops import adx_kernels as JK
from pycricodecs_tpu_torch.ops import adx_kernels as PK
from pycricodecs_tpu_torch.ops import cuda_kernels

STATIC = tuple(int(x) for x in jax_adx.STATIC_COEFFICIENTS)
# (bit depth, block size): every code width path of both unpackers
GEOMETRIES = [(2, 0x12), (4, 0x12), (5, 12), (8, 0x12), (11, 13), (12, 0x12)]
COEF = (7400, -3342)


def _blocks(rng, L, nb, bs) -> np.ndarray:
    """Random raw blocks; the first blocks of lanes 0/1 carry a mode 4
    scale word of 13 (1 << 31) and a mode 2 predictor of 7."""
    raw = rng.integers(0, 256, (L, nb, bs), dtype=np.uint8)
    raw[0, 0, :2] = (0x00, 0x0D)
    raw[1, 0, :2] = (0xE0, 0x10)
    return raw


def _lanes(L, coef=COEF):
    return (torch.full((L,), coef[0], dtype=torch.int32),
            torch.full((L,), coef[1], dtype=torch.int32))


@pytest.mark.parametrize("mode", [2, 3, 4])
@pytest.mark.parametrize("bd,bs", GEOMETRIES)
def test_unpack_equals_jax_unpack_device(bd, bs, mode):
    rng = np.random.default_rng(bd * 31 + mode)
    raw = _blocks(rng, 3, 7, bs)
    words = (raw[..., 0].astype(np.int32) << 8) | raw[..., 1]
    if mode == 2:
        assert (words >> 13 >= 4).any()
    ref = JK.adx_unpack_device(jnp.asarray(raw), block_size=bs, bit_depth=bd,
                               encoding_mode=mode, coef=COEF,
                               static_coefficients=STATIC)
    got = PK.adx_unpack(torch.from_numpy(raw), *_lanes(3), bit_depth=bd,
                        encoding_mode=mode)
    for name, g, r in zip(("q", "s", "a0", "a1"), got, ref):
        r = np.asarray(r)
        assert g.dtype == torch.int32, name
        assert tuple(g.shape) == r.shape, name
        np.testing.assert_array_equal(g.numpy(), r, err_msg=name)
    if mode == 4:
        assert int(got[1][0, 0]) == -(1 << 31)


@pytest.mark.parametrize("mode", [2, 3, 4])
@pytest.mark.parametrize("bd,bs", GEOMETRIES)
def test_pack_equals_jax_pack_device(bd, bs, mode):
    rng = np.random.default_rng(bd * 17 + mode)
    spb = (bs - 2) * 8 // bd
    codes = rng.integers(-(1 << (bd - 1)), 1 << (bd - 1),
                         (3, 9, spb)).astype(np.int32)
    scale_raw = rng.integers(-1, 0x2000, (3, 9)).astype(np.int32)
    zero = rng.random((3, 9)) < 0.25
    field = PK.scale_field(torch.from_numpy(scale_raw),
                           torch.from_numpy(zero), encoding_mode=mode,
                           filter_=3)
    if mode == 2:
        want = np.where(zero, 0, (3 << 13) | (scale_raw & 0x1FFF))
    else:
        want = np.where(zero, 0, scale_raw & 0xFFFF)
    np.testing.assert_array_equal(field.numpy(), want)
    ref = np.asarray(JK.adx_pack_device(jnp.asarray(codes),
                                        jnp.asarray(field.numpy()),
                                        block_size=bs, bit_depth=bd))
    got = PK.adx_pack(torch.from_numpy(codes), field, block_size=bs,
                      bit_depth=bd)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), ref)
    # and unpack inverts pack
    back = PK.adx_unpack(got, *_lanes(3), bit_depth=bd, encoding_mode=3)[0]
    np.testing.assert_array_equal(back.numpy(), codes)


# tests/test_adx.py::test_adx_decode_serial_pallas_matches_scan's cases, on
# raw blocks, plus mode 4 with every scale word 13 mod 32 (1 << 31)
@pytest.mark.parametrize("mode,bd,bs,wrap", [
    (3, 4, 0x12, False), (4, 4, 0x12, False), (2, 4, 0x12, False),
    (3, 8, 0x12, False), (3, 11, 13, False), (4, 4, 0x12, True),
])
def test_decode_twin_matches_serial_pallas(mode, bd, bs, wrap):
    """Odd lane count, saturating history, clamp saturation; the JAX side
    unpacks with adx_unpack_device and decodes with the serial Pallas
    kernel in interpret mode."""
    nb, L = 41, 3
    rng = np.random.default_rng(mode * 7 + bd)
    raw = _blocks(rng, L, nb, bs)
    if wrap:
        raw[:, :, 0] = rng.integers(0, 8, (L, nb)) << 5
        raw[:, :, 1] = 13 + (rng.integers(0, 8, (L, nb)) << 5)
    h1 = np.asarray([0, 100, -31000], np.int32)
    h2 = np.asarray([0, -40, 32000], np.int32)
    q, s, a0, a1 = JK.adx_unpack_device(
        jnp.asarray(raw), block_size=bs, bit_depth=bd, encoding_mode=mode,
        coef=COEF, static_coefficients=STATIC)
    want, conv = JK.adx_decode_serial_pallas(
        q, s, a0, a1, jnp.asarray(h1), jnp.asarray(h2), interpret=True)
    assert bool(np.asarray(conv))
    want = np.asarray(want)
    got = PK.adx_decode_device(torch.from_numpy(raw), torch.from_numpy(h1),
                               torch.from_numpy(h2), *_lanes(L),
                               bit_depth=bd, encoding_mode=mode)
    assert got.dtype == torch.int16 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert (np.abs(want.astype(np.int32)) >= 32767).any()   # clamps hit
    if wrap:
        assert (np.asarray(s) == -(1 << 31)).all()
        # the JAX host decoder multiplies in int64 and does not wrap: the
        # JAX engines disagree here, and the port follows the device kernel
        rep = [np.repeat(np.asarray(x)[..., None], q.shape[2], 2).reshape(
            L, -1) for x in (s, a0, a1)]
        host = JK.adx_decode_numpy(np.asarray(q).reshape(L, -1), *rep, h1,
                                   h2).reshape(want.shape)
        assert not np.array_equal(host, want)


def test_decode_mode2_predictors_4_to_7_decode_with_zero_coefficients():
    """The port follows the JAX device unpack: a mode 2 scale word with
    predictor 4-7 (only corrupt or random data has one) predicts from
    a0 = a1 = 0. The JAX host demux raises IndexError on it instead."""
    raw = np.zeros((1, 2, 0x12), np.uint8)
    raw[0, :, 0] = 0x80          # predictor 4, scale 1
    raw[0, :, 2:] = 0x11         # every code 1
    h = torch.tensor([1000], dtype=torch.int32)
    pcm = PK.adx_decode_plain(torch.from_numpy(raw), h, h, *_lanes(1),
                              bit_depth=4, encoding_mode=2)
    assert (pcm.numpy() == 1).all()
    from tests.torch_port_helpers import wav
    blob = bytearray(jax_adx.encode(wav(2000, 1), encoding_mode=2))
    hdr = jax_adx.parse_adx_header(bytes(blob))
    blob[hdr.data_offset + 4 + 3 * 0x12] |= 0x80   # block 3: predictor 4+
    with pytest.raises(IndexError):
        jax_adx.decode(bytes(blob), use_jax=True)


def test_cuda_wrappers_refuse_cpu_tensors_and_count_nothing():
    raw = torch.zeros((2, 3, 0x12), dtype=torch.uint8)
    lane = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_kernels.adx_decode(raw, lane, lane, lane, lane, bit_depth=4,
                                encoding_mode=3)
    pcm = torch.zeros((2, 3, 32), dtype=torch.int16)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_kernels.adx_encode(pcm, lane, lane, lane, lane,
                                block_size=0x12, bit_depth=4,
                                encoding_mode=3, filter_=0, scale_fix=False)
    PK.adx_decode_device(raw, lane, lane, lane, lane, bit_depth=4,
                         encoding_mode=3)
    PK.adx_encode_device(pcm, lane, lane, lane, lane, block_size=0x12,
                         bit_depth=4, encoding_mode=3)
    assert cuda_kernels.ADX_DECODE_LAUNCHES == 0
    assert cuda_kernels.ADX_ENCODE_LAUNCHES == 0
