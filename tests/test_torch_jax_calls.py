"""PyTorch port, JAX calls run on the port (CPU, the kernels' plain
versions): each gives the JAX package's bytes or raises TypeError, and
never binds a value to a different parameter.

- models.adx.decode takes the JAX order (data, use_jax, strict_cri_check):
  use_jax None or false gives the JAX host decoders' answer, true the JAX
  device scan's (B7's int32 wrap), with its IndexError on a mode 2
  predictor 4-7; a broken signature raises ValueError under every lane.
- models.adx.encode takes use_jax 9th and scale_fix 10th; every use_jax
  gives the JAX bytes (the JAX engines agree).
- models.ahx.encode_mp2: joint_bound is keyword-only, so a JAX call that
  passes `device` 4th raises TypeError (the JAX device lane's bytes differ
  from its host lane's, which the port holds).
- decode_awb / decode_acb / encode_batch_device take their first argument
  by the JAX name; models.hca.decode_frames_to_pcm takes use_jax 4th; the
  Layer II tables take dtype.
- A JAX bool `device` raises TypeError at every entry point
  (utils.device.as_device).
"""
import hashlib

import numpy as np
import pytest

from pycricodecs_tpu import parallel as jax_parallel
from pycricodecs_tpu.containers.acb import ACB as JaxACB
from pycricodecs_tpu.containers.acb import ACBBuilder
from pycricodecs_tpu.models import adx as jax_adx
from pycricodecs_tpu.models import ahx as jax_ahx
from pycricodecs_tpu.models import hca as jax_hca
from pycricodecs_tpu.ops import hca_encode_device as jax_hed
from pycricodecs_tpu.ops import hca_encode_host as jax_heh
from pycricodecs_tpu.ops import mp2_tables as jax_tables
from pycricodecs_tpu.utils.wav import write_wav
import pycricodecs_tpu_torch as port
from pycricodecs_tpu_torch.containers.acb import ACB
from pycricodecs_tpu_torch.models import adx as port_adx
from pycricodecs_tpu_torch.models import ahx as port_ahx
from pycricodecs_tpu_torch.models import crilayla as port_crilayla
from pycricodecs_tpu_torch.models import hca as port_hca
from pycricodecs_tpu_torch.ops import hca_encode_device as port_hed
from pycricodecs_tpu_torch.ops import mp2_tables as port_tables
from pycricodecs_tpu_torch.parallel import make_mesh, measure_d2h_bandwidth
from pycricodecs_tpu_torch.utils import signals
from pycricodecs_tpu_torch.utils.device import as_device
from tests import torch_port_helpers as H

_, ADX = H.load_adx_fixtures()
_, BANK = H.load_bank_fixtures()
#: an ACB with its AWB embedded: two 1 s HCA streams
SMALL_ACB = ACBBuilder([H.load_fixture("q2_mono_48k_1s"),
                        H.load_fixture("q4_stereo_48k_1s")],
                       name="small").build()


def sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _broken_signature(name: str = "adx_m3_bd4_stereo_48k_10s") -> bytes:
    """An ADX fixture (the 10 s bank stream by default) with the first
    block's scale high byte set to 0x01: the reference's 7-byte CRI check
    (its 7th byte) fails."""
    d = bytearray(ADX[name])
    h = jax_adx.parse_adx_header(bytes(d))
    d[h.data_offset + 4] = 0x01
    return bytes(d)


def _mode4_probe() -> bytes:
    """test_torch_bank.py's probe: the 1 s mode 4 fixture with channel 0's
    block 200 given the scale word 13 (2^31) and codes 1, 1."""
    d = bytearray(ADX["adx_m4_stereo_1s"])
    h = jax_adx.parse_adx_header(bytes(d))
    off = h.data_offset + 4 + 200 * 2 * 18
    d[off:off + 3] = b"\x00\x0d\x11"
    return bytes(d)


def _mode2_predictor_4() -> bytes:
    blob = bytearray(jax_adx.encode(H.wav(2000, 1), encoding_mode=2))
    hdr = jax_adx.parse_adx_header(bytes(blob))
    blob[hdr.data_offset + 4 + 3 * 0x12] |= 0x80   # block 3: predictor 4+
    return bytes(blob)


# -- models.adx.decode -------------------------------------------------------

@pytest.mark.parametrize("use_jax", [None, False, True])
def test_adx_decode_broken_signature_raises_under_every_lane(use_jax):
    d = _broken_signature()
    with pytest.raises(ValueError, match="copyright"):
        jax_adx.decode(d, use_jax)
    with pytest.raises(ValueError, match="copyright"):
        port_adx.decode(d, use_jax, device="cpu")


def test_adx_decode_second_positional_is_use_jax():
    """decode(d, False) is the JAX call that used to turn the check off;
    the third positional is strict_cri_check."""
    d = _broken_signature("adx_v5_stereo_1s")
    with pytest.raises(ValueError):
        port_adx.decode(d, False, device="cpu")
    loose = port_adx.decode(d, False, False, device="cpu")
    assert loose[:4] == b"RIFF"
    assert loose == jax_adx.decode(d, False, False)


@pytest.fixture(scope="module")
def probe():
    d = _mode4_probe()
    return d, {u: jax_adx.decode(d, u, False) for u in (None, False, True)}


@pytest.mark.parametrize("use_jax", [None, False, True])
def test_adx_decode_use_jax_gives_that_lanes_bytes(probe, use_jax):
    d, want = probe
    assert port_adx.decode(d, use_jax, False, device="cpu") == want[use_jax]


def test_adx_decode_use_jax_by_keyword(probe):
    d, want = probe
    assert port_adx.decode(d, use_jax=True, strict_cri_check=False,
                           device="cpu") == want[True]


def test_the_probe_separates_the_jax_lanes(probe):
    _, want = probe
    assert sha(want[None])[:8] == "96e4522a"
    assert sha(want[True])[:8] == "3d77dbcd"
    assert want[False] == want[None]


@pytest.mark.parametrize("use_jax", [None, True])
def test_adx_decode_plain_stream_equal_under_both_lanes(use_jax):
    d = ADX["adx_v5_stereo_1s"]
    want = jax_adx.decode(d, use_jax)
    assert want == jax_adx.decode(d, not use_jax)
    assert port_adx.decode(d, use_jax, device="cpu") == want


def test_adx_decode_device_lane_raises_on_mode2_predictor_4():
    """The JAX device scan's demux raises IndexError; the port raises it
    with use_jax true and keeps its zero-coefficient answer otherwise."""
    blob = _mode2_predictor_4()
    with pytest.raises(IndexError):
        jax_adx.decode(blob, True)
    with pytest.raises(IndexError):
        port_adx.decode(blob, True, device="cpu")
    assert port_adx.decode(blob, device="cpu") == \
        port.adx_decode_batch([blob], device="cpu", wrap=True)[0]


# -- models.adx.encode -------------------------------------------------------

@pytest.fixture(scope="module")
def m4_wav():
    return signals.adx_wav("adx_m4_stereo_1s", write_wav)


@pytest.fixture(scope="module")
def short_wav():
    return H.wav(4000, 2)


@pytest.mark.parametrize("args", [
    (4, 0x12, 3, 500, 0, 4, False, True),
    (4, 0x12, 3, 500, 0, 4, False, None, True),
    (4, 0x12, 3, 500, 0, 4, False, True, True),
    (4, 0x12, 4, 500, 0, 5, False, False, False),
], ids=["use_jax_9th", "scale_fix_10th", "both", "mode4_v5"])
def test_adx_encode_jax_positional_calls(short_wav, args):
    want = jax_adx.encode(short_wav, *args)
    assert port_adx.encode(short_wav, *args, device="cpu") == want


def test_adx_encode_nine_argument_call_is_the_default_stream(m4_wav):
    """The JAX call encode(wav, ..., False, True) gives the JAX default
    stream (59b099f5fbd4...), not the scale_fix one (8f61841bae93...)."""
    got = port_adx.encode(m4_wav, 4, 0x12, 3, 500, 0, 4, False, True,
                          device="cpu")
    assert got == jax_adx.encode(m4_wav, 4, 0x12, 3, 500, 0, 4, False, True)
    assert sha(got)[:12] == "59b099f5fbd4"


# -- models.ahx.encode_mp2 ---------------------------------------------------

def test_encode_mp2_refuses_the_jax_fourth_positional():
    pcm = signals.tones(1.0, 1, 22050, 3)[0]
    assert sha(jax_ahx.encode_mp2(pcm, 22050, 96, False))[:12] == \
        "f06f9afbc9be"
    for device in (False, True):
        with pytest.raises(TypeError):
            port_ahx.encode_mp2(pcm, 22050, 96, device)
        with pytest.raises(TypeError, match="engine choice"):
            port_ahx.encode_mp2(pcm, 22050, 96, device=device)
    assert port_ahx.encode_mp2(pcm, 22050, 96, device="cpu") == \
        jax_ahx.encode_mp2(pcm, 22050, 96)


def test_encode_mp2_joint_bound_by_keyword():
    pcm = signals.tones(0.5, 2, 44100, 15)
    want = jax_ahx.encode_mp2(pcm, 44100, 192, joint_bound=8)
    assert port_ahx.encode_mp2(pcm, 44100, 192, joint_bound=8,
                               device="cpu") == want


def test_the_jax_device_lane_differs_from_its_host_lane():
    """Why the port takes no JAX `device=True` here: on this input the JAX
    f32 device lane gives other bytes than its f64 host lane."""
    pcm = signals.tones(0.5, 2, 32000, 2)
    assert jax_ahx.encode_mp2(pcm, 32000, 128, True) != \
        jax_ahx.encode_mp2(pcm, 32000, 128, False)


# -- the bank entry points and encode_batch_device ---------------------------

def test_decode_awb_by_the_jax_keyword():
    e, _ = H.load_bank_fixtures()
    key = e["subkey"]["key"]
    want = jax_parallel.decode_awb(awb_obj_or_bytes=BANK["subkey"], key=key)
    assert port.decode_awb(awb_obj_or_bytes=BANK["subkey"], key=key,
                           device="cpu") == want


def test_decode_acb_by_the_jax_keyword_and_positions():
    want = jax_parallel.decode_acb(acb_obj_or_bytes=SMALL_ACB)
    assert port.decode_acb(acb_obj_or_bytes=SMALL_ACB, device="cpu") == want
    assert port.decode_acb(ACB(SMALL_ACB), 0, None, device="cpu") == \
        jax_parallel.decode_acb(JaxACB(SMALL_ACB), 0, None)


@pytest.fixture(scope="module")
def hca_wavs():
    return [H.wav(3000, 2, seed=s) for s in (1, 2)]


def test_encode_batch_device_by_the_jax_keyword(hca_wavs):
    got = port_hed.encode_batch_device(wav_blobs=hca_wavs, quality=2,
                                       device="cpu")
    assert got == [jax_heh.encode(w, quality=2) for w in hca_wavs]


def test_encode_batch_device_refuses_the_jax_mesh_position(hca_wavs):
    with pytest.raises(TypeError):
        port_hed.encode_batch_device(hca_wavs, 2, False, None)


def test_encode_batch_device_mixed_formats_raise_as_in_jax(hca_wavs):
    mixed = [hca_wavs[0], H.wav(3000, 1)]
    with pytest.raises(ValueError, match="uniform"):
        jax_hed.encode_batch_device(mixed)
    with pytest.raises(ValueError, match="uniform"):
        port_hed.encode_batch_device(mixed, device="cpu")


# -- models.hca.decode_frames_to_pcm, the Layer II tables -------------------

@pytest.mark.parametrize("use_jax", [None, False, True])
def test_decode_frames_to_pcm_use_jax_4th(use_jax):
    blob = H.load_fixture("q2_mono_48k_1s")
    ji, pi = H.parse_both(blob)
    frames = blob[H.header_size(blob):]
    want = jax_hca.decode_frames_to_pcm(ji, frames, 1, use_jax)
    got = port_hca.decode_frames_to_pcm(pi, frames, 1, use_jax, device="cpu")
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", ["analysis_window", "scalefactors",
                                  "synthesis_matrixing", "analysis_matrix"])
def test_mp2_tables_take_dtype(name, dtype):
    want = getattr(jax_tables, name)(dtype)
    got = getattr(port_tables, name)(dtype)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


# -- a JAX bool device -------------------------------------------------------

ENTRY_POINTS = {
    "decode_batch": lambda d: port.decode_batch([], device=d),
    "adx_decode_batch": lambda d: port.adx_decode_batch([], device=d),
    "adx_encode_batch": lambda d: port.adx_encode_batch([], device=d),
    "hca_encode_batch": lambda d: port.hca_encode_batch([], device=d),
    "ahx_decode_batch": lambda d: port.ahx_decode_batch([], device=d),
    "ahx_encode_batch": lambda d: port.ahx_encode_batch([], device=d),
    "decode_awb": lambda d: port.decode_awb(BANK["subkey"], device=d),
    "decode_acb": lambda d: port.decode_acb(SMALL_ACB, device=d),
    "adx.decode": lambda d: port_adx.decode(ADX["adx_v5_stereo_1s"],
                                            device=d),
    "hca.decode": lambda d: port_hca.decode(H.load_fixture("q2_mono_48k_1s"),
                                            device=d),
    "crilayla.decompress": lambda d: port_crilayla.decompress(
        signals.crilayla_zero_blob(64), device=d),
    "measure_d2h_bandwidth": lambda d: measure_d2h_bandwidth(device=d),
    "make_mesh": lambda d: make_mesh((1, 1), devices=[d]),
}


@pytest.mark.parametrize("device", [True, False, np.bool_(True)],
                         ids=["True", "False", "numpy_True"])
@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_a_jax_bool_device_raises_type_error(entry, device):
    with pytest.raises(TypeError, match="engine choice"):
        ENTRY_POINTS[entry](device)


def test_as_device_takes_torch_devices_and_names():
    import torch
    assert as_device("cpu") == torch.device("cpu")
    assert as_device(torch.device("cuda", 1)) == torch.device("cuda", 1)
    with pytest.raises(RuntimeError):
        as_device("nonsense")
