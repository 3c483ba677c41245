"""PyTorch port, ADX host pieces: the copies the port carries (the GPU
machine has no JAX) equal their pycricodecs_tpu originals exactly: header
parse with every error path, payload slicing, history, coefficients, WAV
parsing, encode preparation and stream assembly.
"""
import dataclasses

import numpy as np
import pytest

from pycricodecs_tpu.models import adx as jax_adx
from pycricodecs_tpu.utils import wav as jax_wav
from pycricodecs_tpu_torch.models import adx as port_adx
from pycricodecs_tpu_torch.utils import wav as port_wav
from tests import torch_port_helpers as H

DEFAULTS = dict(bit_depth=4, block_size=0x12, encoding_mode=3,
                highpass_frequency=0x1F4, filter_=0, version=4,
                force_not_looping=False)


def _adx(**kw) -> bytes:
    src = kw.pop("src", None) or H.wav(3000, 2, seed=3)
    return jax_adx.encode(src, **kw)


STREAMS = {
    "m3_v4_stereo": lambda: _adx(),
    "m2_f1": lambda: _adx(encoding_mode=2, filter_=1),
    "m4": lambda: _adx(encoding_mode=4),
    "v3": lambda: _adx(version=3),
    "v5": lambda: _adx(version=5),
    "bd8": lambda: _adx(bit_depth=8),
    "bd2_bsff": lambda: _adx(src=H.wav(3000, 2, seed=3, lead_in=1012),
                             bit_depth=2, block_size=0xFF),
    "mono_loop": lambda: _adx(src=H.wav(6000, 1, seed=4,
                                        loop=(1000, 5000))),
    "stereo_loop_v3": lambda: _adx(src=H.wav(6000, 2, seed=5,
                                             loop=(500, 4000)), version=3),
    "6ch_44k": lambda: _adx(src=H.wav(2000, 6, 44100, seed=6)),
}


def _raises_alike(fn_jax, fn_port, *args, **kw):
    """Both raise: same exception type and message."""
    with pytest.raises(Exception) as ref:
        fn_jax(*args, **kw)
    with pytest.raises(Exception) as got:
        fn_port(*args, **kw)
    assert type(got.value).__name__ == type(ref.value).__name__
    assert str(got.value) == str(ref.value)


def _assert_header_equal(got, ref):
    g, r = dataclasses.asdict(got), dataclasses.asdict(ref)
    assert g.keys() == r.keys()
    for name in r:
        if isinstance(r[name], np.ndarray):
            assert g[name].dtype == r[name].dtype, name
            np.testing.assert_array_equal(g[name], r[name], err_msg=name)
        else:
            assert g[name] == r[name], name
    assert got.samples_per_block == ref.samples_per_block


def test_constants_equal():
    np.testing.assert_array_equal(port_adx.STATIC_COEFFICIENTS,
                                  jax_adx.STATIC_COEFFICIENTS)
    assert port_adx.STATIC_COEFFICIENTS.dtype == \
        jax_adx.STATIC_COEFFICIENTS.dtype
    assert port_adx._ERRORS == jax_adx._ERRORS
    assert port_adx.CRI_STRING == jax_adx.CRI_STRING


@pytest.mark.parametrize("rate", [8000, 22050, 44100, 48000, 96000])
@pytest.mark.parametrize("highpass", [0, 1, 0x1F4, 4000, 30000, 0xFFFF])
def test_calculate_coefficients_equal(rate, highpass):
    assert port_adx.calculate_coefficients(highpass, rate) == \
        jax_adx.calculate_coefficients(highpass, rate)


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_parse_adx_header_equal(name):
    """The port always runs the strict 7-byte signature check."""
    blob = STREAMS[name]()
    ref = jax_adx.parse_adx_header(blob, strict_cri_check=True)
    got = port_adx.parse_adx_header(blob)
    _assert_header_equal(got, ref)
    assert got.looping == ("loop" in name)


def _patched(blob: bytes, **at) -> bytes:
    out = bytearray(blob)
    for off, val in at.items():
        out[int(off[1:])] = val
    return bytes(out)


def _error_inputs():
    base = STREAMS["m3_v4_stereo"]()
    loop = STREAMS["mono_loop"]()
    h = jax_adx.parse_adx_header(loop)
    # loop_count word of the mono v4 stream (base 20 + 4 + 2 * 4)
    many_loops = bytearray(loop)
    many_loops[34:36] = (200).to_bytes(2, "big")
    strict_only = bytearray(base)
    strict_only[jax_adx.parse_adx_header(base).data_offset + 4] = 1
    assert h.looping
    return {
        "short (-1)": base[:19],
        "signature (-1)": _patched(base, b0=0x7F),
        "ahx mode (-2)": _patched(base, b4=0x10),
        "version 6 (-2)": _patched(base, b18=6),
        "block_size 0 (-2)": _patched(base, b5=0),
        "bit_depth 0 (-2)": _patched(base, b6=0),
        "encrypted (-3)": _patched(base, b19=8),
        "mode 5 (-4)": _patched(base, b4=5),
        "version 2 (-5)": _patched(base, b18=2),
        "bit_depth 3 (-6)": _patched(base, b6=3),
        "bit_depth 16 (-6)": _patched(base, b5=0x22, b6=16),
        "no channels (-7)": _patched(base, b7=0),
        "loop count (-8)": bytes(many_loops),
        "cri string (-9)": _patched(
            base, **{f"b{jax_adx.parse_adx_header(base).data_offset - 2}":
                     0}),
        "strict 7th byte (-9)": bytes(strict_only),
    }


@pytest.mark.parametrize("case", sorted(_error_inputs()))
def test_parse_adx_header_errors_equal(case):
    data = _error_inputs()[case]
    _raises_alike(jax_adx.parse_adx_header, port_adx.parse_adx_header, data)
    if case.startswith("strict"):
        # only the 7th byte (the first block's scale high byte) is wrong
        jax_adx.parse_adx_header(data, strict_cri_check=False)


def _payload_cases():
    base = STREAMS["m3_v4_stereo"]()
    h = jax_adx.parse_adx_header(base)
    start = h.data_offset + 4
    frame = h.block_size * h.channels
    eof_mid = bytearray(base)
    eof_mid[start + 5 * frame:start + 5 * frame + 2] = b"\x80\x01"
    no_samples = bytearray(base)
    no_samples[12:16] = bytes(4)
    return {"whole": base, "truncated": base[:start + 7 * frame + 11],
            "eof_mid": bytes(eof_mid), "no_samples": bytes(no_samples),
            "no_payload": base[:start + 1],
            "bd2_bsff": STREAMS["bd2_bsff"](),
            "6ch": STREAMS["6ch_44k"]()}


@pytest.mark.parametrize("case", sorted(_payload_cases()))
def test_payload_blocks_and_history_equal(case):
    blob = _payload_cases()[case]
    h = jax_adx.parse_adx_header(blob)
    ph = port_adx.parse_adx_header(blob)
    ref = jax_adx._payload_blocks(blob, h)
    got = port_adx._payload_blocks(blob, ph)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    for g, r in zip(port_adx._history_init(ph), jax_adx._history_init(h)):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)
    if case == "eof_mid":
        assert ref.shape[0] == 5


@pytest.mark.parametrize("version", [3, 4, 5])
def test_history_init_equal(version):
    blob = _adx(version=version)
    got = port_adx._history_init(port_adx.parse_adx_header(blob))
    ref = jax_adx._history_init(jax_adx.parse_adx_header(blob))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


def _riff(chunks) -> bytes:
    body = b"WAVE" + b"".join(
        tag + len(data).to_bytes(4, "little") + data
        + (b"\0" if len(data) & 1 else b"") for tag, data in chunks)
    return b"RIFF" + len(body).to_bytes(4, "little") + body


def _fmt(compression, channels, rate, bits, extensible_sub=None) -> bytes:
    align = channels * ((bits + 7) // 8)
    out = (compression.to_bytes(2, "little") + channels.to_bytes(2, "little")
           + rate.to_bytes(4, "little") + (rate * align).to_bytes(4, "little")
           + align.to_bytes(2, "little") + bits.to_bytes(2, "little"))
    if extensible_sub is not None:
        out += ((22).to_bytes(2, "little") + bits.to_bytes(2, "little")
                + bytes(4) + extensible_sub.to_bytes(4, "little") + bytes(12))
    return out


def _smpl(start, end) -> bytes:
    body = bytearray(36 + 24)
    body[28:32] = (1).to_bytes(4, "little")
    body[44:48] = start.to_bytes(4, "little")
    body[48:52] = end.to_bytes(4, "little")
    return bytes(body)


def _wav_cases():
    rng = np.random.default_rng(11)
    i16 = rng.integers(-32768, 32768, 600, dtype=np.int16).tobytes()
    u8 = rng.integers(0, 256, 600, dtype=np.uint8).tobytes()
    b24 = rng.integers(0, 256, 900, dtype=np.uint8).tobytes()
    i32 = rng.integers(-2**31, 2**31, 600, dtype=np.int64).astype(
        np.int32).tobytes()
    f32 = rng.uniform(-1.5, 1.5, 600).astype("<f4").tobytes()
    f64 = rng.uniform(-1.5, 1.5, 600).astype("<f8").tobytes()
    return {
        "pcm16": _riff([(b"fmt ", _fmt(1, 2, 44100, 16)), (b"data", i16)]),
        "pcm8": _riff([(b"fmt ", _fmt(1, 1, 8000, 8)), (b"data", u8)]),
        "pcm24": _riff([(b"fmt ", _fmt(1, 3, 48000, 24)), (b"data", b24)]),
        "pcm32": _riff([(b"fmt ", _fmt(1, 2, 48000, 32)), (b"data", i32)]),
        "float32": _riff([(b"fmt ", _fmt(3, 2, 48000, 32)), (b"data", f32)]),
        "float64": _riff([(b"fmt ", _fmt(3, 1, 48000, 64)), (b"data", f64)]),
        "extensible_pcm16": _riff([(b"fmt ", _fmt(0xFFFE, 2, 48000, 16, 1)),
                                   (b"data", i16)]),
        "extensible_float": _riff([(b"fmt ", _fmt(0xFFFE, 2, 48000, 32, 3)),
                                   (b"data", f32)]),
        "smpl_and_odd_chunk": _riff([(b"LIST", b"odd"),
                                     (b"fmt ", _fmt(1, 2, 32000, 16)),
                                     (b"smpl", _smpl(10, 200)),
                                     (b"data", i16)]),
        "data_size_past_end": _riff([(b"fmt ", _fmt(1, 2, 44100, 16)),
                                     (b"data", i16)])[:-100],
        "error_not_riff": b"RIFX" + bytes(60),
        "error_no_fmt": _riff([(b"data", i16)]),
        "error_no_data": _riff([(b"fmt ", _fmt(1, 2, 44100, 16))]),
        "error_compression": _riff([(b"fmt ", _fmt(2, 2, 44100, 16)),
                                    (b"data", i16)]),
        "error_float_bits": _riff([(b"fmt ", _fmt(3, 2, 44100, 16)),
                                   (b"data", i16)]),
        "error_short_smpl": _riff([(b"fmt ", _fmt(1, 2, 44100, 16)),
                                   (b"smpl", bytes(20)), (b"data", i16)]),
    }


@pytest.mark.parametrize("case", sorted(_wav_cases()))
def test_parse_wav_equal(case):
    data = _wav_cases()[case]
    if case.startswith("error"):
        _raises_alike(jax_wav.parse_wav, port_wav.parse_wav, data)
        return
    ref = jax_wav.parse_wav(data)
    got = port_wav.parse_wav(data)
    for field in ("channels", "sample_rate", "looping", "loop_start",
                  "loop_end", "bit_depth", "compression", "num_samples"):
        assert getattr(got, field) == getattr(ref, field), field
    assert got.pcm16.dtype == ref.pcm16.dtype
    np.testing.assert_array_equal(got.pcm16, ref.pcm16)


ENCODE_KW = {
    "defaults": {},
    "m2_f3": dict(encoding_mode=2, filter_=3),
    "m4_v5_no_loop": dict(encoding_mode=4, version=5,
                          force_not_looping=True),
    "bd8_v3": dict(bit_depth=8, version=3),
    "bd5_bs12": dict(bit_depth=5, block_size=12),
    "bd2_bsff": dict(bit_depth=2, block_size=0xFF),
}
PREP_WAVS = {
    "stereo": lambda: H.wav(3001, 2, seed=7),
    "mono_loop": lambda: H.wav(5000, 1, seed=8, loop=(300, 4000)),
    "6ch_short": lambda: H.wav(5, 6, 22050, seed=9, lead_in=0),
}


def _prep_slots_equal(got, ref):
    for slot in port_adx._EncodePrep.__slots__:
        g, r = getattr(got, slot), getattr(ref, slot)
        if slot == "wav":
            np.testing.assert_array_equal(g.pcm16, r.pcm16)
            assert (g.looping, g.loop_start, g.loop_end) == \
                (r.looping, r.loop_start, r.loop_end)
        elif isinstance(r, np.ndarray):
            assert g.dtype == r.dtype and g.shape == r.shape, slot
            np.testing.assert_array_equal(g, r, err_msg=slot)
        else:
            assert g == r, slot


@pytest.mark.parametrize("src", sorted(PREP_WAVS))
@pytest.mark.parametrize("kw", sorted(ENCODE_KW))
def test_encode_prep_and_assembly_equal(kw, src):
    data = PREP_WAVS[src]()
    args = dict(DEFAULTS, **ENCODE_KW[kw])
    ref = jax_adx._encode_prep(data, **args)
    got = port_adx._encode_prep(data, **args)
    _prep_slots_equal(got, ref)

    rng = np.random.default_rng(12)
    C, F, spb = ref.blocks.shape
    bd = args["bit_depth"]
    codes = rng.integers(-(1 << (bd - 1)), 1 << (bd - 1), (C, F, spb))
    scale_raw = rng.integers(-1, 0x2000, (C, F)).astype(np.int32)
    zero = rng.random((C, F)) < 0.2
    pkw = dict(frames=F, channels=C, block_size=args["block_size"],
               bit_depth=bd, encoding_mode=args["encoding_mode"],
               filter_=args["filter_"])
    payload = jax_adx._assemble_payload(codes, scale_raw, zero, **pkw)
    skw = dict(bit_depth=bd, block_size=args["block_size"],
               encoding_mode=args["encoding_mode"],
               highpass_frequency=args["highpass_frequency"],
               version=args["version"])
    assert port_adx._assemble_stream(got, payload, **skw) == \
        jax_adx._assemble_stream(ref, payload, **skw)


ENCODE_ERRORS = {
    "channels (-10)": (lambda: H.wav(400, 2), {}),  # patched below
    "bit_depth (-11)": (lambda: H.wav(400, 2), dict(bit_depth=16)),
    "block_size (-12)": (lambda: H.wav(400, 2), dict(block_size=2)),
    "mode (-13)": (lambda: H.wav(400, 2), dict(encoding_mode=5)),
    "highpass (-14)": (lambda: H.wav(400, 2),
                       dict(highpass_frequency=0x10000)),
    "filter (-15)": (lambda: H.wav(400, 2), dict(filter_=4)),
    "version (-16)": (lambda: H.wav(400, 2), dict(version=6)),
    "geometry (-17)": (lambda: H.wav(400, 2), dict(bit_depth=3)),
    "samples (-18)": (lambda: H.wav(400, 2)[:44], {}),
    "not a wav": (lambda: b"RIFF" + bytes(40), {}),
}


@pytest.mark.parametrize("case", sorted(ENCODE_ERRORS))
def test_encode_prep_errors_equal(case):
    make, kw = ENCODE_ERRORS[case]
    data = bytearray(make())
    if case.startswith("channels"):
        data[22:24] = (256).to_bytes(2, "little")   # 256 channels
        data[32:34] = (512).to_bytes(2, "little")
    _raises_alike(jax_adx._encode_prep, port_adx._encode_prep, bytes(data),
                  **dict(DEFAULTS, **kw))

