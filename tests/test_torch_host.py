"""PyTorch port: the host pieces it carries as copies (the GPU machine has no
JAX, and importing any pycricodecs_tpu module imports jax) must equal their
pycricodecs_tpu originals exactly: tables, header parse, cipher, CRC, WAV
writer, loop points, the encoder's configuration, timeline and header, and
the frame re-keying. Also: the port never imports jax or pycricodecs_tpu.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from pycricodecs_tpu.models import hca as jax_model
from pycricodecs_tpu.ops import hca_encode_host as jax_enc
from pycricodecs_tpu.ops import hca_tables as jax_tables
from pycricodecs_tpu.ops import hca_unpack_device as jax_unpack
from pycricodecs_tpu.utils import crc as jax_crc
from pycricodecs_tpu.utils import hca_crypt as jax_crypt
from pycricodecs_tpu.utils import wav as jax_wav
from pycricodecs_tpu_torch.models import hca as port_model
from pycricodecs_tpu_torch.ops import hca_encode_host as port_enc
from pycricodecs_tpu_torch.ops import hca_frame as port_frame
from pycricodecs_tpu_torch.ops import hca_tables as port_tables
from pycricodecs_tpu_torch.ops import hca_unpack_device as port_unpack
from pycricodecs_tpu_torch.utils import crc as port_crc
from pycricodecs_tpu_torch.utils import hca_crypt as port_crypt
from pycricodecs_tpu_torch.utils import wav as port_wav
from tests import torch_port_helpers as H

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TABLES = ["SCALING_TABLE", "RANGE_TABLE", "SCALE_CONVERSION_TABLE",
          "INTENSITY_RATIO_TABLE", "IMDCT_SIN", "IMDCT_COS", "IMDCT_WINDOW",
          "INVERT_TABLE", "ATH_BASE_CURVE", "QUANTIZER_INVERSE_STEP_SIZE",
          "INTENSITY_RATIO_BOUNDS", "QUANTIZER_DEAD_ZONE",
          "QUANTIZER_SCALING_TABLE", "DCT4_SIN_FLAT", "DCT4_COS_FLAT",
          "SHUFFLE_TABLE", "SCALE_TO_RESOLUTION_CURVE",
          "QUANTIZE_SPECTRUM_BITS", "QUANTIZE_SPECTRUM_VALUE",
          "VALID_CHANNEL_MAPPINGS", "DEFAULT_CHANNEL_MAPPING",
          "QUANTIZED_SPECTRUM_MAX_BITS"]


@pytest.mark.parametrize("name", TABLES)
def test_table_equal(name):
    got, ref = getattr(port_tables, name), getattr(jax_tables, name)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


def test_scalar_constants_equal():
    for name in ("MDCT_BITS", "DISCRETE", "STEREO_PRIMARY",
                 "STEREO_SECONDARY"):
        assert getattr(port_tables, name) == getattr(jax_tables, name), name


@pytest.mark.parametrize("ath_type,rate", [(0, 48000), (1, 8000),
                                            (1, 44100), (1, 48000),
                                            (1, 96000)])
def test_ath_curve_equal(ath_type, rate):
    got = port_tables.ath_curve(ath_type, rate)
    ref = jax_tables.ath_curve(ath_type, rate)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


def test_channel_types_equal():
    for ch in range(1, 9):
        for tracks in range(1, ch + 1):
            for sbc in (0, 32):
                for cfg in range(4):
                    np.testing.assert_array_equal(
                        port_tables.channel_types(ch, tracks, sbc, cfg),
                        jax_tables.channel_types(ch, tracks, sbc, cfg))


def test_vlc_tables_equal_reference_tables():
    """The unpack kernel's prefix-code tables equal the JAX unpacker's packed
    constants and, on every reachable code, the reference READ tables."""
    for name in ("_BIT_LO", "_BIT_HI", "_VAL_LO", "_VAL_HI"):
        assert getattr(port_unpack, name) == getattr(jax_unpack, name)
    val, adv = port_unpack.vlc_tables()
    for r in range(8):
        for code in range(1 << int(jax_tables.MAX_BIT_TABLE[r])):
            assert val[r, code] == jax_tables.READ_VAL_TABLE[r * 16 + code]
            assert adv[r, code] == jax_tables.READ_BIT_TABLE[r * 16 + code]


def _v1_stream():
    from tests.test_hca import _make_v1_dec_header
    return _make_v1_dec_header(H.encode(1, 0, seed=91))


def _v3_stream():
    from tests.test_hca import _relabel_v3
    return _relabel_v3(H.encode(1, 0, seed=77, samples=24576))


STREAMS = {
    "q2_stereo": lambda: H.encode(2, 2, seed=1),
    "q4_stereo_hfr": lambda: H.encode(2, 4, seed=2),
    "q0_6ch": lambda: H.encode(6, 0, seed=3),
    "keyed": lambda: H.encode(2, 2, seed=4, key=H.KEY),
    "looped": lambda: H.encode(2, 2, seed=5, samples=30000,
                               loop=(4000, 20000)),
    "v1_dec_header": _v1_stream,
    "v3_min_res_0": _v3_stream,
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_parse_header_equal(name):
    blob = STREAMS[name]()
    key = H.KEY if name == "keyed" else 0
    ji, pi = H.parse_both(blob, key)
    H.assert_info_equal(pi, ji)
    if name == "keyed":
        assert ji.ciph_type == 56
    if name == "looped":
        assert ji.loop_flag


@pytest.mark.parametrize("name", sorted(H.load_fixtures()[0]))
def test_parse_fixture_header_and_from_arrays(name):
    """The port's parse equals the JAX package's on every fixture, and
    HcaInfo.from_arrays carries a JAX HcaInfo across unchanged."""
    blob = H.load_fixtures()[1][name]
    ji, pi = H.parse_both(blob)
    H.assert_info_equal(pi, ji)
    carried = port_frame.HcaInfo.from_arrays(dataclasses.asdict(ji))
    H.assert_info_equal(carried, pi)
    ji.set_key(H.KEY)
    pi.set_key(H.KEY)
    H.assert_info_equal(
        port_frame.HcaInfo.from_arrays(dataclasses.asdict(ji)), pi)


def test_parse_header_errors_match():
    blob = H.encode(2, 2, seed=6)
    hs = H.header_size(blob)
    bad_crc = bytearray(blob[:hs])
    bad_crc[hs - 1] ^= 1
    for data in (blob[:4], b"XXXX" + blob[4:hs], bytes(bad_crc)):
        with pytest.raises(ValueError) as ref:
            from pycricodecs_tpu.ops import hca_frame as jax_frame
            jax_frame.parse_header(data)
        with pytest.raises(port_frame.HcaError) as got:
            port_frame.parse_header(data)
        assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("ciph_type", [0, 1, 56])
@pytest.mark.parametrize("key", [0, 1, 0xCF222F1FE0748978,
                                 0x0123456789ABCDEF])
def test_cipher_table_equal(ciph_type, key):
    np.testing.assert_array_equal(port_crypt.cipher_table(ciph_type, key),
                                  jax_crypt.cipher_table(ciph_type, key))


def test_scramble_subkey_equal():
    for key in (0, 1, H.KEY):
        for sub in (0, 1, 0x1234, 0xFFFF, 0x10001):
            assert port_crypt.scramble_subkey(key, sub) == \
                jax_crypt.scramble_subkey(key, sub)


def test_crc16_batch_equal():
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (64, 203), dtype=np.uint8)
    np.testing.assert_array_equal(port_crc.crc16_batch(frames),
                                  jax_crc.crc16_batch(frames))
    blob = H.encode(2, 2, seed=7)
    ji, _ = H.parse_both(blob)
    real = H.frames_of(blob, ji)
    assert not port_crc.crc16_batch(real).any()
    assert port_crc.crc16(blob[:H.header_size(blob)]) == 0


@pytest.mark.parametrize("looping", [False, True])
def test_write_wav_equal(looping):
    pcm = np.random.default_rng(1).integers(-32768, 32768, 3000,
                                            dtype=np.int16)
    args = (pcm, 2, 44100)
    kw = dict(looping=looping, loop_start=100, loop_end=1200)
    assert port_wav.write_wav(*args, **kw) == jax_wav.write_wav(*args, **kw)


def test_loop_points_equal():
    blob = STREAMS["looped"]()
    ji, pi = H.parse_both(blob)
    assert port_model.loop_points(pi) == jax_model.loop_points(ji)
    assert port_model.SAMPLES_PER_FRAME == jax_model.SAMPLES_PER_FRAME


def test_port_imports_neither_jax_nor_the_jax_package():
    code = ("import sys, pycricodecs_tpu_torch, pycricodecs_tpu_torch.parallel,"
            " pycricodecs_tpu_torch.ops.cuda_kernels,"
            " pycricodecs_tpu_torch.ops.adx_kernels,"
            " pycricodecs_tpu_torch.models.adx,"
            " pycricodecs_tpu_torch.utils.wav,"
            " pycricodecs_tpu_torch.utils.bitio,"
            " pycricodecs_tpu_torch.utils.signals,"
            " pycricodecs_tpu_torch.ops.hca_encode_host,"
            " pycricodecs_tpu_torch.ops.hca_encode_device,"
            " pycricodecs_tpu_torch.ops.hca_pack_device,"
            " pycricodecs_tpu_torch.models.hca,"
            " pycricodecs_tpu_torch.utils.hca_crypt,"
            " pycricodecs_tpu_torch._build; "
            "assert 'jax' not in sys.modules, 'jax'; "
            "assert 'pycricodecs_tpu' not in sys.modules, 'pycricodecs_tpu'")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_dct4_stage_tables_equal():
    for stage in range(8):
        for got, ref in zip(port_tables.dct4_stage_tables(stage),
                            jax_tables.dct4_stage_tables(stage)):
            np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("channels", range(1, 9))
def test_calculate_bitrate_equal(channels):
    for rate in (8000, 22050, 44100, 48000, 96000):
        for quality in range(-1, 7):
            assert port_enc.calculate_bitrate(channels, rate, quality) == \
                jax_enc.calculate_bitrate(channels, rate, quality)


# (samples, channels, rate, quality, loop points or None, force_not_looping)
ENCODE_CONFIGS = {
    "stereo_q2": (12000, 2, 48000, 2, None, False),
    "mono_q4_44k": (9000, 1, 44100, 4, None, False),
    "6ch_q0": (5000, 6, 48000, 0, None, False),
    "8ch_q3_16k": (4096, 8, 16000, 3, None, False),
    "short_q1": (300, 2, 48000, 1, None, False),
    "empty_q2": (0, 2, 48000, 2, None, False),
    "loop_q2": (30000, 2, 48000, 2, (4000, 20000), False),
    "loop_late_8k": (5857, 4, 8000, 3, (1289, 5460), False),
    "loop_forced_off": (30000, 2, 48000, 2, (4000, 20000), True),
}


@pytest.mark.parametrize("name", sorted(ENCODE_CONFIGS))
def test_encode_config_timeline_and_header_equal(name):
    samples, ch, rate, quality, loop, fnl = ENCODE_CONFIGS[name]
    pcm = np.random.default_rng(samples).integers(
        -32768, 32768, samples * ch, dtype=np.int16)
    kw = {} if loop is None else dict(looping=True, loop_start=loop[0],
                                      loop_end=loop[1])
    wav = jax_wav.write_wav(pcm, ch, rate, **kw)
    jw, pw = jax_wav.parse_wav(wav), port_wav.parse_wav(wav)
    jc = jax_enc.init_encode(jw, quality, jw.looping and not fnl)
    pc = port_enc.init_encode(pw, quality, pw.looping and not fnl)
    H.assert_info_equal(pc.info, jc.info)
    for field in ("post_samples", "buffer_pre_samples",
                  "sample_count_per_channel", "input_sample_count",
                  "hfr_band_count"):
        assert getattr(pc, field) == getattr(jc, field), field
    np.testing.assert_array_equal(port_enc.build_timeline(pc, pw),
                                  jax_enc.build_timeline(jc, jw))
    assert port_enc.pack_header(pc.info) == jax_enc.pack_header(jc.info)


def test_init_encode_refuses_like_jax():
    wav = jax_wav.write_wav(np.zeros(90, np.int16), 9, 48000)
    with pytest.raises(Exception) as ref:
        jax_enc.init_encode(jax_wav.parse_wav(wav), 2, False)
    with pytest.raises(Exception) as got:
        port_enc.init_encode(port_wav.parse_wav(wav), 2, False)
    assert type(got.value).__name__ == type(ref.value).__name__
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("ciph_type", [1, 56])
def test_crypt_helpers_equal(ciph_type):
    table = jax_crypt.cipher_table(ciph_type, H.KEY)
    np.testing.assert_array_equal(port_crypt.invert_cipher_table(table),
                                  jax_crypt.invert_cipher_table(table))
    frames = np.random.default_rng(ciph_type).integers(
        0, 256, (9, 200), dtype=np.uint8)
    np.testing.assert_array_equal(
        port_crypt.apply_cipher_frames(frames, table),
        jax_crypt.apply_cipher_frames(frames, table))
    blob = H.encode(2, 2, seed=40, samples=30000, loop=(4000, 20000))
    hs = H.header_size(blob)
    for value in (0, ciph_type):
        assert port_crypt.crypt_header(bytearray(blob[:hs]), value) == \
            jax_crypt.crypt_header(bytearray(blob[:hs]), value)
