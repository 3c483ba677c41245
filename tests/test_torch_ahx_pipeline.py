"""PyTorch port: the batched AHX / MPEG Layer II decode on the CPU,
byte-equal to pycricodecs_tpu.parallel.ahx_decode_batch(device=False).

One mixed call covers AHX 0x10 and 0x11, bare LSF and MPEG-1 streams, mono
and stereo (two groups), joint stereo with a per-frame bound, CRC, VBR, a
stream with a truncated frame and garbage bytes; the error modes; the trim
to min(frames * 1152, total samples) where AHX.decode zero-pads instead; the
container's sample rate; the committed fixtures' hashes and their
regeneration.
"""
import hashlib
import importlib.util
import os

import numpy as np
import pytest

from pycricodecs_tpu import parallel as jax_parallel
from pycricodecs_tpu.models.ahx import AHX
from pycricodecs_tpu.ops import mp2_frame as jax_frame
from pycricodecs_tpu_torch import parallel as port_parallel
from pycricodecs_tpu_torch.ops import cuda_kernels
from tests import torch_port_helpers as H

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AHX_NAMES = sorted(H.load_ahx_fixtures()[0])


def _truncated_frame(blob: bytes) -> bytes:
    """The stream with its last frame's bitrate lowered (its bytes cut to
    the new size), so that frame's fields cross its end."""
    off = H.mp2_offset(blob)
    _, walk = jax_frame.scan_frames(blob, off)
    pos, fr = walk[-1]
    w = int.from_bytes(fr[:4], "big")
    w = (w & ~(0xF << 12)) | (1 << 12)                  # lowest bitrate
    size = jax_frame.parse_header(w.to_bytes(4, "big")).frame_size
    return blob[:pos] + w.to_bytes(4, "big") + fr[4:size]


@pytest.fixture(scope="module")
def bank():
    _, blobs = H.load_ahx_fixtures()
    names = AHX_NAMES + ["truncated_frame", "garbage"]
    streams = [blobs[n] for n in AHX_NAMES]
    streams += [_truncated_frame(blobs["ahx11_lsf_mono_22k_1s"]),
                np.random.default_rng(1).integers(0, 256, 3000,
                                                  dtype=np.uint8).tobytes()]
    port = port_parallel.ahx_decode_batch(streams, device="cpu",
                                          on_error="isolate")
    ref = jax_parallel.ahx_decode_batch(streams, device=False,
                                        on_error="isolate")
    return dict(names=names, streams=streams, port=port, ref=ref)


@pytest.mark.parametrize("name", AHX_NAMES + ["truncated_frame", "garbage"])
def test_mixed_call_stream_matches_jax(bank, name):
    i = bank["names"].index(name)
    assert bank["port"][i] == bank["ref"][i]
    if name in ("truncated_frame", "garbage"):
        assert bank["port"][i] is None
    else:
        assert bank["port"][i][:4] == b"RIFF"


@pytest.mark.parametrize("name", AHX_NAMES)
def test_fixture_wav_hash(name):
    expected, blobs = H.load_ahx_fixtures()
    got = port_parallel.ahx_decode_batch([blobs[name]], device="cpu")[0]
    assert hashlib.sha256(got).hexdigest() == expected[name]["wav_sha256"]


@pytest.mark.parametrize("bad", ["truncated_frame", "garbage"])
def test_raise_mode_raises_like_jax(bank, bad):
    streams = [bank["streams"][0], bank["streams"][bank["names"].index(bad)]]
    with pytest.raises(ValueError) as ref:
        jax_parallel.ahx_decode_batch(streams, device=False)
    with pytest.raises(ValueError) as got:
        port_parallel.ahx_decode_batch(streams, device="cpu")
    assert str(got.value) == str(ref.value)


def test_trims_to_the_frames_where_ahx_decode_zero_fills():
    """A stream cut after 5 frames declares more samples than it holds:
    ahx_decode_batch (and the port) trims to min(frames * 1152, total);
    AHX.decode zero-fills to the declared count (ROADMAP Queue C)."""
    _, blobs = H.load_ahx_fixtures()
    blob = blobs["ahx_bank_lsf_mono_22k_96k_10s"]
    info = AHX.parse_header(blob)
    _, walk = jax_frame.scan_frames(blob, info["data_offset"])
    cut = blob[:walk[5][0] + 100]
    got = port_parallel.ahx_decode_batch([cut], device="cpu")[0]
    assert got == jax_parallel.ahx_decode_batch([cut], device=False)[0]
    pcm = np.frombuffer(got[44:], np.int16)
    assert len(pcm) == 5 * 1152 < info["total_samples"]
    single = AHX.decode(cut)
    assert len(single) - 44 == 2 * info["total_samples"]
    assert single[44:len(got)] == got[44:]


def test_container_rate_and_zero_total():
    """The AHX header's rate wins over the frames'; total_samples 0 keeps
    every frame."""
    _, blobs = H.load_ahx_fixtures()
    blob = bytearray(blobs["ahx11_lsf_mono_22k_1s"])
    blob[8:12] = (44100).to_bytes(4, "big")
    blob[12:16] = bytes(4)
    got = port_parallel.ahx_decode_batch([bytes(blob)], device="cpu")[0]
    assert got == jax_parallel.ahx_decode_batch([bytes(blob)],
                                                device=False)[0]
    assert int.from_bytes(got[24:28], "little") == 44100
    assert len(got) - 44 == 2 * 20 * 1152


def test_argument_checks_and_empty_batch():
    assert port_parallel.ahx_decode_batch([], device="cpu") == []
    with pytest.raises(ValueError, match="on_error"):
        port_parallel.ahx_decode_batch([], device="cpu", on_error="skip")


def test_launch_counters_stay_zero_on_cpu():
    _, blobs = H.load_ahx_fixtures()
    port_parallel.ahx_decode_batch([blobs["mp2_joint_varying_bound"]],
                                   device="cpu")
    assert cuda_kernels.MP2_UNPACK_LAUNCHES == 0
    assert cuda_kernels.MP2_SYNTH_LAUNCHES == 0


def test_ahx_fixtures_regenerate_byte_identically():
    spec = importlib.util.spec_from_file_location(
        "make_torch_port_fixtures",
        os.path.join(ROOT, "tools", "make_torch_port_fixtures.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    expected, blobs = H.load_ahx_fixtures()
    made = tool.make_ahx_streams()
    assert sorted(made) == sorted(expected)
    for name, (fname, blob) in made.items():
        assert fname == expected[name]["file"]
        assert blob == blobs[name], name
