"""PyTorch port, the bank entry points on the CPU (kernels' twins):
decode_awb and decode_acb equal pycricodecs_tpu.parallel.decode_awb /
decode_acb byte for byte on every member kind (HCA, ADX accepted only by
the non-strict check, a mode 4 ADX whose blocks leave int32, a truncated
ADX, AHX, a corrupt AHX, an ADX whose header fails, a non-audio member),
with and without decode_non_hca, under a bank subkey, and through a
sibling AWB; and on the fixtures in tests/data/torch_port/bank/, their
recorded hashes.

B7's host arithmetic: the twin with wrap=False equals the JAX host
decoders (the native cri_adx_decode_blocks that models.adx.decode,
parallel.adx_decode_batch and decode_awb run, and the int64 numpy oracle
adx_decode_numpy) on random mode 4 blocks, scale words 13 mod 32 among
them; adx_kernels.adx_decode_host takes int32 scale lanes, which cannot
hold 2^31, so it is held to the twin on the scale words it represents.
"""
import hashlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pycricodecs_tpu import parallel as jax_parallel
from pycricodecs_tpu.containers.acb import ACB as JaxACB
from pycricodecs_tpu.containers.acb import ACBBuilder
from pycricodecs_tpu.containers.awb import build_afs2 as jax_build_afs2
from pycricodecs_tpu.models import adx as jax_adx
from pycricodecs_tpu.ops import adx_kernels as JK
import pycricodecs_tpu_torch as port
from pycricodecs_tpu_torch.containers.acb import ACB
from pycricodecs_tpu_torch.containers.awb import AWB, build_afs2
from pycricodecs_tpu_torch.ops import adx_kernels as PK
from pycricodecs_tpu_torch.ops import cuda_kernels
from tests import torch_port_helpers as H

EXPECTED, BLOBS = H.load_bank_fixtures()
MIXED = EXPECTED["mixed"]["members"]
STATIC = tuple(int(x) for x in jax_adx.STATIC_COEFFICIENTS)


def sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


@pytest.fixture(scope="module")
def mixed():
    acb = BLOBS["mixed"]
    return dict(port=port.decode_acb(acb, device="cpu"),
                jax=jax_parallel.decode_acb(acb),
                port_raw=port.decode_awb(ACB(acb).awb, decode_non_hca=False,
                                         device="cpu"),
                members=list(ACB(acb).awb.getfiles()))


@pytest.mark.parametrize("name", MIXED)
def test_mixed_acb_member_equals_jax_decode_acb(mixed, name):
    i = MIXED.index(name)
    got = mixed["port"][i]
    assert isinstance(got, bytes)
    assert got == mixed["jax"][i]
    assert sha(got) == EXPECTED["mixed"]["wav_sha256"][i]
    assert (got == mixed["members"][i]) == EXPECTED["mixed"]["raw"][i]
    if not EXPECTED["mixed"]["raw"][i]:
        assert got[:4] == b"RIFF"


@pytest.mark.parametrize("name", MIXED)
def test_mixed_without_non_hca_decode(mixed, name):
    i = MIXED.index(name)
    got = mixed["port_raw"][i]
    assert sha(got) == EXPECTED["mixed"]["no_non_hca_sha256"][i]
    assert (got[:4] == b"RIFF") == name.startswith("hca")
    if not name.startswith("hca"):
        assert got == mixed["members"][i]


def test_mixed_acb_exercises_the_host_arithmetic(mixed):
    """The mode 4 member decodes differently under the int32 wrap; the
    non-strict member fails the strict check."""
    m4 = mixed["members"][MIXED.index("adx_m4_scale13")]
    wrap = port.adx_decode_batch([m4], device="cpu", strict_cri_check=False,
                                 wrap=True)[0]
    assert wrap != mixed["port"][MIXED.index("adx_m4_scale13")]
    loose = mixed["members"][MIXED.index("adx_non_strict")]
    with pytest.raises(ValueError, match="Criware"):
        port.ADX.decode(loose, device="cpu")


def test_decode_awb_refuses_a_positional_third_argument(mixed):
    """The third positional parameter is the mesh, as in the JAX
    decode_awb: the meshless JAX call decode_awb(awb, 0, None) works alike
    (the non-HCA decode stays on), and a bool there, the old
    decode_non_hca slot, raises TypeError (decode_non_hca is keyword-
    only)."""
    got = port.decode_awb(ACB(BLOBS["mixed"]).awb, 0, None, device="cpu")
    assert got == mixed["jax"]
    with pytest.raises(TypeError):
        port.decode_awb(ACB(BLOBS["mixed"]).awb, 0, False, device="cpu")


@pytest.mark.parametrize("kw", [{}, dict(decode_non_hca=False)],
                         ids=["default", "no_non_hca"])
def test_decode_awb_keyword_calls_equal_the_meshless_jax_calls(mixed, kw):
    got = port.decode_awb(ACB(BLOBS["mixed"]).awb, 0, device="cpu", **kw)
    want = jax_parallel.decode_awb(JaxACB(BLOBS["mixed"]).awb, 0, None, **kw)
    assert got == want
    assert got == (mixed["jax"] if not kw else mixed["port_raw"])


def test_subkey_awb_equals_jax():
    e = EXPECTED["subkey"]
    blob = BLOBS["subkey"]
    assert AWB(blob).subkey == e["subkey"]
    got = port.decode_awb(blob, key=e["key"], device="cpu")
    assert [sha(w) for w in got] == e["wav_sha256"]
    assert got == jax_parallel.decode_awb(blob, key=e["key"])
    # without the bank's subkey the streams decipher to noise and fail
    with pytest.raises(ValueError):
        port.decode_batch(list(AWB(blob).getfiles()), key=e["key"],
                          device="cpu")


def test_bank_acb_and_its_sibling_awb(tmp_path):
    """bank.acb names a sibling bank.awb; the port's build_afs2 of the 256
    tracks is the recorded bank, and the ACB opened by path finds it."""
    e = EXPECTED["bank"]
    assert sha(BLOBS["bank"]) == e["acb_sha256"]
    track = H.load_fixture(e["member"].removesuffix(".hca"))
    awb = build_afs2([track] * e["tracks"])
    assert sha(awb) == e["awb_sha256"]
    (tmp_path / "bank.acb").write_bytes(BLOBS["bank"])
    (tmp_path / "bank.awb").write_bytes(awb)
    acb = ACB(str(tmp_path / "bank.acb"))
    assert acb.awb.numfiles == e["tracks"]
    assert acb.awb.getfile_atindex(e["tracks"] - 1) == track


def test_decode_acb_by_path_through_a_sibling_awb(tmp_path):
    tracks = [H.load_fixture("q2_mono_48k_1s"), H.wav(3000, 1, seed=3)]
    builder = ACBBuilder(tracks, name="side", embed_awb=False)
    (tmp_path / "side.acb").write_bytes(builder.build())
    (tmp_path / "side.awb").write_bytes(builder.awb_blob)
    path = str(tmp_path / "side.acb")
    got = port.decode_acb(path, device="cpu")
    assert got == jax_parallel.decode_acb(path)
    assert got[0][:4] == b"RIFF" and got[1][:4] == b"RIFF"
    assert port.decode_acb(ACB(path), device="cpu") == got


def _adx_members():
    m3 = jax_adx.encode(H.wav(3000, 2, seed=11))
    h = jax_adx.parse_adx_header(m3)
    no_rate = bytearray(m3)
    no_rate[8:12] = bytes(4)                      # 0 Hz: no coefficients
    m2 = bytearray(jax_adx.encode(H.wav(2000, 1, seed=12), encoding_mode=2))
    return {
        "m3": m3,
        "m3_cut_in_signature": m3[:h.data_offset + 2],
        "m3_no_payload": m3[:h.data_offset + 4],
        "m3_no_rate": bytes(no_rate),
        "m4_mono": jax_adx.encode(H.wav(2500, 1, 44100, seed=13),
                                  encoding_mode=4),
        "m2": bytes(m2),
        "bd8": jax_adx.encode(H.wav(2000, 2, seed=14), bit_depth=8),
        "short": b"\x80\x00\x00\x20",
        "ahx_magic_only": b"\x80\x00\x00\x20\x11",
    }


@pytest.mark.parametrize("decode_non_hca", [True, False])
def test_adx_only_bank_equals_jax(decode_non_hca):
    members = list(_adx_members().values())
    blob = build_afs2(members)
    got = port.decode_awb(blob, decode_non_hca=decode_non_hca, device="cpu")
    assert got == jax_parallel.decode_awb(blob, decode_non_hca=decode_non_hca)
    raw = list(AWB(blob).getfiles())
    kinds = [g[:4] == b"RIFF" for g in got]
    if decode_non_hca:
        assert kinds == [True, False, True, False, True, True, True, False,
                         False]
    else:
        assert got == raw


def test_empty_and_single_kind_banks():
    assert port.decode_awb(build_afs2([]), device="cpu") == [] == \
        jax_parallel.decode_awb(jax_build_afs2([]))
    for members in ([H.load_fixture("q4_stereo_48k_1s")],
                    [H.load_ahx_fixtures()[1]["ahx11_lsf_mono_22k_1s"]],
                    [_adx_members()["m3"]]):
        blob = build_afs2(members)
        awb = AWB(blob)
        assert port.decode_awb(awb, device="cpu") == \
            jax_parallel.decode_awb(blob)


def _probe() -> bytes:
    """The 1 s mode 4 stereo fixture with channel 0's block 200 given the
    scale word 13 and first codes 1, 1."""
    d = bytearray(H.load_adx_fixtures()[1]["adx_m4_stereo_1s"])
    h = jax_adx.parse_adx_header(bytes(d))
    off = h.data_offset + 4 + 200 * 2 * 18
    d[off:off + 3] = b"\x00\x0d\x11"
    return bytes(d)


def test_mode4_scale13_probe_gives_the_jax_host_answer():
    d = _probe()
    want = jax_adx.decode(d, strict_cri_check=False)
    assert jax_parallel.adx_decode_batch([d])[0] == want
    assert port.adx_decode_batch([d], device="cpu")[0] == want
    assert port.ADX.decode(d, device="cpu") == want
    from pycricodecs_tpu_torch.models import adx as port_adx
    assert port_adx.decode(d, strict_cri_check=False, device="cpu") == want
    assert port.decode_awb(build_afs2([d]), device="cpu")[0] == want
    assert jax_parallel.decode_awb(jax_build_afs2([d]))[0] == want
    wrap = port.adx_decode_batch([d], device="cpu", wrap=True)[0]
    assert wrap == jax_parallel.adx_decode_batch([d], device=True)[0]
    a = np.frombuffer(want[44:], np.int16).astype(np.int32)
    b = np.frombuffer(wrap[44:], np.int16).astype(np.int32)
    diff = np.flatnonzero(a != b)
    assert len(diff) > 0 and a[diff[0]] == 32767 and b[diff[0]] == -32768


def test_mode2_predictors_4_to_7_in_a_bank_decode_with_zero_coefficients():
    """The JAX host decoders have no defined answer here (the numpy demux
    raises IndexError, the native decoder reads past its table); the port
    predicts from a0 = a1 = 0, the JAX device path's answer."""
    blob = bytearray(jax_adx.encode(H.wav(2000, 1), encoding_mode=2))
    hdr = jax_adx.parse_adx_header(bytes(blob))
    blob[hdr.data_offset + 4 + 3 * 0x12] |= 0x80   # block 3: predictor 4+
    blob = bytes(blob)
    got = port.decode_awb(build_afs2([blob]), device="cpu")[0]
    assert got == port.adx_decode_batch([blob], device="cpu", wrap=True)[0]
    assert got == jax_parallel.adx_decode_batch([blob], device=True)[0]


def _mode4_blocks(rng, L, nb, bd, words):
    """Random mode 4 blocks at bit depth bd; scale words drawn from
    `words`, about a quarter 13 mod 32 when `words` allows it."""
    bs = 0x12 if bd in (2, 4, 8) else (13 if bd == 11 else 32)
    raw = rng.integers(0, 256, (L, nb, bs), dtype=np.uint8)
    w = rng.choice(words, (L, nb))
    raw[..., 0], raw[..., 1] = w >> 8, w & 0xFF
    return raw, bs


def _host_oracle(raw, bd, h1, h2, coef):
    """The JAX int64 oracle: the JAX unpack's codes, its scales with the
    wrapped 2^31 made positive, adx_decode_numpy."""
    L, nb, bs = raw.shape
    q, s, a0, a1 = JK.adx_unpack_device(
        jnp.asarray(raw), block_size=bs, bit_depth=bd, encoding_mode=4,
        coef=coef, static_coefficients=STATIC)
    q = np.asarray(q)
    spb = q.shape[2]
    s = np.asarray(s).astype(np.int64)
    s[s == -(1 << 31)] = 1 << 31
    lanes = [np.repeat(np.asarray(x)[..., None], spb, 2).reshape(L, -1)
             for x in (s, a0, a1)]
    return JK.adx_decode_numpy(q.reshape(L, -1), *lanes, h1,
                               h2).reshape(L, nb, spb), q, lanes


@pytest.mark.parametrize("bd", [4, 15])
def test_host_twin_equals_the_jax_host_decoders(bd):
    rng = np.random.default_rng(bd)
    L, nb = 5, 40
    words = np.concatenate([np.arange(0, 64), 13 + 32 * np.arange(64)])
    raw, bs = _mode4_blocks(rng, L, nb, bd, words)
    ws = (raw[..., 0].astype(np.int32) << 8) | raw[..., 1]
    assert 0.2 < ((ws & 31) == 13).mean() < 0.8
    h1 = np.asarray([0, 100, -31000, 32767, -32768], np.int32)
    h2 = np.asarray([0, -40, 32000, 5, 7], np.int32)
    coef = jax_adx.calculate_coefficients(500, 48000)
    want, q, lanes = _host_oracle(raw, bd, h1, h2, coef)
    c = [torch.full((L,), v, dtype=torch.int32) for v in coef]
    args = (torch.from_numpy(raw), torch.from_numpy(h1), torch.from_numpy(h2),
            *c)
    got = PK.adx_decode_device(*args, bit_depth=bd, encoding_mode=4,
                               wrap=False)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (np.abs(want.astype(np.int32)) >= 32767).any()
    wrap = PK.adx_decode_plain(*args, bit_depth=bd, encoding_mode=4)
    assert not np.array_equal(wrap.numpy(), want)
    # the native decoder of models.adx.decode (int64 scale 2^31) agrees
    import ctypes
    from pycricodecs_tpu import native
    lib = native.load()
    assert lib is not None
    for lane in range(L):
        payload = np.ascontiguousarray(raw[lane][:, None])
        out = np.empty((nb * q.shape[2], 1), np.int16)
        i32p = ctypes.POINTER(ctypes.c_int32)
        st = np.asarray(STATIC, np.int32)
        hh1, hh2 = h1[lane:lane + 1].copy(), h2[lane:lane + 1].copy()
        lib.cri_adx_decode_blocks(
            payload.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            np.int32(nb), np.int32(1), np.int32(bs), np.int32(bd),
            np.int32(4), np.int32(coef[0]), np.int32(coef[1]),
            st.ctypes.data_as(i32p), hh1.ctypes.data_as(i32p),
            hh2.ctypes.data_as(i32p),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), np.int32(1))
        np.testing.assert_array_equal(out[:, 0], want[lane].reshape(-1))


@pytest.mark.parametrize("bd", [4, 15])
def test_host_twin_equals_adx_decode_host_where_int32_holds_the_scale(bd):
    """Scale words 14..31 mod 32 (2^30 down to 2^13) overflow int32 in
    q * scale at these bit depths, yet fit an int32 scale lane."""
    rng = np.random.default_rng(100 + bd)
    L, nb = 3, 30
    words = np.asarray([w for w in range(0, 256) if (w & 31) != 13])
    raw, bs = _mode4_blocks(rng, L, nb, bd, words)
    h = np.zeros(L, np.int32)
    coef = jax_adx.calculate_coefficients(1000, 44100)
    want, q, lanes = _host_oracle(raw, bd, h, h, coef)
    host = JK.adx_decode_host(q.reshape(L, -1),
                              *[x.astype(np.int32) for x in lanes], h, h)
    np.testing.assert_array_equal(host.reshape(want.shape), want)
    c = [torch.full((L,), v, dtype=torch.int32) for v in coef]
    got = PK.adx_decode_plain(torch.from_numpy(raw), torch.from_numpy(h),
                              torch.from_numpy(h), *c, bit_depth=bd,
                              encoding_mode=4, wrap=False)
    np.testing.assert_array_equal(got.numpy(), want)
    wrap = PK.adx_decode_plain(torch.from_numpy(raw), torch.from_numpy(h),
                               torch.from_numpy(h), *c, bit_depth=bd,
                               encoding_mode=4)
    assert not np.array_equal(wrap.numpy(), want)


@pytest.mark.parametrize("mode", [2, 3])
def test_host_and_wrap_twins_agree_outside_mode_4(mode):
    rng = np.random.default_rng(mode)
    raw = rng.integers(0, 256, (4, 20, 32), dtype=np.uint8)
    h = torch.tensor([0, 1000, -32768, 32767], dtype=torch.int32)
    c = (torch.full((4,), 7400, dtype=torch.int32),
         torch.full((4,), -3342, dtype=torch.int32))
    outs = [PK.adx_decode_plain(torch.from_numpy(raw), h, h, *c,
                                bit_depth=15, encoding_mode=mode, wrap=w)
            for w in (True, False)]
    assert torch.equal(*outs)


def test_bank_launch_counters_stay_zero_on_cpu():
    before = (cuda_kernels.ADX_DECODE_LAUNCHES,
              cuda_kernels.ADX_DECODE_HOST_LAUNCHES)
    port.decode_acb(BLOBS["mixed"], device="cpu")
    assert before == (0, 0) == (cuda_kernels.ADX_DECODE_LAUNCHES,
                                cuda_kernels.ADX_DECODE_HOST_LAUNCHES)
    raw = torch.zeros((1, 1, 0x12), dtype=torch.uint8)
    lane = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_kernels.adx_decode(raw, lane, lane, lane, lane, bit_depth=4,
                                encoding_mode=4, wrap=False)


def test_bank_fixtures_stay_small():
    total = sum(os.path.getsize(os.path.join(H.BANK_FIXTURE_DIR, n))
                for n in os.listdir(H.BANK_FIXTURE_DIR))
    assert total < 200_000
