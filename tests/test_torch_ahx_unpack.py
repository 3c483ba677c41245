"""PyTorch port: kernel B10's plain twin `mp2_unpack_plain` on the CPU.

Held byte for byte to the JAX package's host unpacker
(pycricodecs_tpu.ops.mp2_frame.unpack, its SoA tensors) on every fixture
of tests/data/torch_port/ahx/ (LSF mono 16/22.05/24 kHz, MPEG-1 stereo and
joint stereo, the per-frame varying-bound stream, a CRC-protected stream,
a VBR stream), to the JAX B10 kernel itself (Mp2DeviceUnpacker in Pallas
interpret mode) on one LSF mono stream, and to the host unpacker's errors:
it flags exactly the frames the host raises on.
"""
import numpy as np
import pytest
import torch

from pycricodecs_tpu.ops import mp2_frame as jax_frame
from pycricodecs_tpu.ops import mp2_unpack_device as jax_unpack
from pycricodecs_tpu_torch.ops import cuda_kernels
from pycricodecs_tpu_torch.ops import mp2_unpack_device as port_unpack
from pycricodecs_tpu_torch.parallel import pipeline as port_pipeline
from tests import torch_port_helpers as H

AHX_NAMES = sorted(H.load_ahx_fixtures()[0])


def _vbr_stream() -> bytes:
    """The VBR concatenation of the JAX package's
    test_ahx_batch_vbr_stream_keeps_host_unpack (64 then 96 kbps)."""
    from pycricodecs_tpu.models import ahx as jax_ahx
    from tests.test_mp2_unpack_pallas import _pcm
    return (jax_ahx.encode_mp2(_pcm(0.25, 1, 22050, 5)[0], 22050,
                               bitrate_kbps=64)
            + jax_ahx.encode_mp2(_pcm(0.25, 1, 22050, 6)[0], 22050,
                                 bitrate_kbps=96))


def _stack(walk, fs_max=None) -> np.ndarray:
    fs_max = fs_max or max(len(fr) for _, fr in walk)
    frames = np.zeros((len(walk), fs_max), np.uint8)
    for i, (_, fr) in enumerate(walk):
        frames[i, :len(fr)] = np.frombuffer(fr, np.uint8)
    return frames


def _unpack(frames, channels):
    return [t.numpy() for t in port_unpack.mp2_unpack(
        torch.from_numpy(frames), channels)]


@pytest.mark.parametrize("name", AHX_NAMES + ["jax_vbr_test_stream"])
def test_twin_matches_host_unpacker(name):
    _, blobs = H.load_ahx_fixtures()
    blob = _vbr_stream() if name == "jax_vbr_test_stream" else blobs[name]
    off = H.mp2_offset(blob)
    hdr0, walk = jax_frame.scan_frames(blob, off)
    for use_native in (True, False):
        host = jax_frame.unpack(blob, off, use_native=use_native)
        codes, levels, sfidx, err = _unpack(_stack(walk), hdr0.nch)
        assert not err.any()
        assert codes.dtype == np.uint16 and levels.dtype == np.int32
        np.testing.assert_array_equal(codes, host.codes)
        np.testing.assert_array_equal(levels, host.levels)
        np.testing.assert_array_equal(sfidx, host.sfidx)
    assert (levels > 0).any()


def test_twin_matches_the_jax_b10_kernel():
    """Mp2DeviceUnpacker in interpret mode on the LSF mono 22.05 kHz
    stream (its outputs stop at sblimit; the twin's are zero above)."""
    _, blobs = H.load_ahx_fixtures()
    blob = blobs["ahx11_lsf_mono_22k_1s"]
    hdr0, walk = jax_frame.scan_frames(blob, H.mp2_offset(blob))
    up = jax_unpack.Mp2DeviceUnpacker(hdr0)
    frames = _stack(walk, up.fs_max)
    jc, jl, js, je = (np.asarray(x) for x in up(frames, interpret=True))
    codes, levels, sfidx, err = _unpack(frames, 1)
    SB = hdr0.sblimit
    np.testing.assert_array_equal(err, je)
    np.testing.assert_array_equal(codes[..., :SB], jc)
    np.testing.assert_array_equal(levels[..., :SB], jl)
    np.testing.assert_array_equal(sfidx[..., :SB], js)
    assert not codes[..., SB:].any() and not levels[..., SB:].any()


def _host_raises(frame: bytes, use_native: bool) -> bool:
    try:
        jax_frame.unpack(frame, 0, use_native=use_native)
    except ValueError as exc:
        assert "truncated" in str(exc)
        return True
    return False


@pytest.mark.parametrize("name", ["ahx_bank_lsf_mono_22k_96k_10s",
                                  "mp2_stereo_44k_192k_1s",
                                  "mp2_joint_varying_bound",
                                  "mp2_crc_lsf_mono_22k_1s"])
def test_twin_flags_exactly_the_frames_the_host_raises_on(name):
    """Three frames in four rewritten to a random smaller bitrate (their
    bytes cut to the new size): some fields now cross the frame end. The
    flags equal the host unpacker's raises, frame by frame, and the other
    frames unpack alike."""
    _, blobs = H.load_ahx_fixtures()
    blob = blobs[name]
    hdr0, walk = jax_frame.scan_frames(blob, H.mp2_offset(blob))
    rng = np.random.default_rng(len(name))
    cut = []
    for i, (_, fr) in enumerate(walk[:48]):
        if i % 4 == 3:
            cut.append(fr)
            continue
        h = jax_frame.parse_header(fr)
        w = int.from_bytes(fr[:4], "big")
        for _ in range(20):
            bri = int(rng.integers(1, (w >> 12) & 0xF))
            w2 = (w & ~(0xF << 12)) | (bri << 12)
            h2 = jax_frame.parse_header(w2.to_bytes(4, "big"))
            if h2.nch == h.nch:
                break
        cut.append(w2.to_bytes(4, "big") + fr[4:h2.frame_size])
    frames = _stack([(0, fr) for fr in cut])
    codes, levels, sfidx, err = _unpack(frames, hdr0.nch)
    raises = np.array([_host_raises(fr, True) for fr in cut])
    np.testing.assert_array_equal(
        raises, [_host_raises(fr, False) for fr in cut])
    np.testing.assert_array_equal(err, raises)
    assert raises.any() and not raises.all()
    for i in np.nonzero(~raises)[0]:
        host = jax_frame.unpack(cut[i], 0)
        np.testing.assert_array_equal(codes[i], host.codes[0])
        np.testing.assert_array_equal(levels[i], host.levels[0])
        np.testing.assert_array_equal(sfidx[i], host.sfidx[0])


def test_frames_without_a_header_of_this_channel_count_are_flagged():
    _, blobs = H.load_ahx_fixtures()
    _, mono = jax_frame.scan_frames(blobs["mp2_lsf_mono_24k_1s"], 0)
    _, stereo = jax_frame.scan_frames(blobs["mp2_stereo_44k_192k_1s"], 0)
    frames = _stack([mono[0], stereo[0], (0, b""), (0, b"\xff\xfb\x90\x00"),
                     (0, b"\xff\xfd\xf0\x00" + mono[1][1][4:]), mono[1]])
    codes, levels, sfidx, err = _unpack(frames, 1)
    np.testing.assert_array_equal(err, [0, 1, 1, 1, 1, 0])
    for i in (1, 2, 3, 4):
        assert not codes[i].any() and not levels[i].any() \
            and not sfidx[i].any()
    # a frame shorter than its header says (the row is cut) is flagged too
    codes, levels, sfidx, err = _unpack(frames[:1, :100], 1)
    assert err.all() and not levels.any()


def test_stacking_pads_each_frame_and_stream():
    _, blobs = H.load_ahx_fixtures()
    walks = [jax_frame.scan_frames(blobs[n], H.mp2_offset(blobs[n]))[1]
             for n in ("mp2_vbr_lsf_mono_22k_1s", "ahx11_lsf_mono_22k_1s")]
    got = port_pipeline._stack_mp2_frames(walks)
    fs_max = max(len(fr) for w in walks for _, fr in w)
    assert got.shape == (2, max(len(w) for w in walks), fs_max)
    for b, walk in enumerate(walks):
        np.testing.assert_array_equal(got[b, :len(walk)],
                                      _stack(walk, fs_max))
        assert not got[b, len(walk):].any()


def test_cpu_tensors_never_launch():
    before = cuda_kernels.MP2_UNPACK_LAUNCHES
    port_unpack.mp2_unpack(torch.zeros((2, 700), dtype=torch.uint8), 1)
    assert cuda_kernels.MP2_UNPACK_LAUNCHES == before == 0
    with pytest.raises(ValueError, match="CUDA"):
        cuda_kernels.mp2_unpack(torch.zeros((2, 700), dtype=torch.uint8), 1)
