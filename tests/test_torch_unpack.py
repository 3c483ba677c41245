"""PyTorch port: the unpack kernels' plain twins (B1 side info, B2 spectra)
on the CPU, against the JAX package byte for byte.

Real streams are held to pycricodecs_tpu.ops.hca_frame._unpack_frames_py
(the reference the JAX device unpacker's own tests use). Random-byte frames
with a valid sync word, which hit the error rules, are held to the JAX
DeviceUnpacker (its XLA-scan path on the CPU): err on every frame, the
outputs on every frame without error.
"""
import dataclasses

import numpy as np
import pytest
import torch

from pycricodecs_tpu.ops import hca_frame as jax_frame
from pycricodecs_tpu.ops import hca_unpack_device as jax_unpack
from pycricodecs_tpu_torch.ops import hca_frame as port_frame
from pycricodecs_tpu_torch.ops import hca_unpack_device as port_unpack
from tests import torch_port_helpers as H


def _port_unpack(pi, frames):
    up = port_unpack.DeviceUnpacker(pi, device="cpu")
    qc, sf, res, inten, err = up(frames)
    return qc.numpy(), sf.numpy(), res.numpy(), inten.numpy(), err.numpy()


@pytest.mark.parametrize("quality", [0, 2, 4])
@pytest.mark.parametrize("channels", [1, 2, 4, 6, 8])
def test_unpack_matches_host_reference(quality, channels):
    blob = H.encode(channels, quality, seed=quality * 8 + channels,
                    samples=6000)
    ji, pi = H.parse_both(blob)
    ref = jax_frame._unpack_frames_py(
        ji, blob[H.header_size(blob):][:ji.frame_count * ji.frame_size])
    qc, sf, res, inten, err = _port_unpack(pi, H.frames_of(blob, pi))
    assert not err.any()
    np.testing.assert_array_equal(qc, ref.qc)
    np.testing.assert_array_equal(sf, ref.scalefactors)
    np.testing.assert_array_equal(res, ref.resolutions)
    np.testing.assert_array_equal(inten, ref.intensity)


def test_unpack_encrypted_stream():
    blob = H.encode(2, 2, seed=31, key=H.KEY)
    ji, pi = H.parse_both(blob, key=H.KEY)
    assert ji.ciph_type == 56
    ref = jax_frame._unpack_frames_py(
        ji, blob[H.header_size(blob):][:ji.frame_count * ji.frame_size])
    qc, sf, res, inten, err = _port_unpack(pi, H.frames_of(blob, pi))
    assert not err.any()
    np.testing.assert_array_equal(qc, ref.qc)
    np.testing.assert_array_equal(sf, ref.scalefactors)
    np.testing.assert_array_equal(res, ref.resolutions)
    np.testing.assert_array_equal(inten, ref.intensity)


def _v3_hfr_info():
    """A v3.0 intensity-pair + HFR config (no encoder makes one): exercises
    the v3 scalefactor extension and the delta-coded intensity branch."""
    blob = H.load_fixtures()[1]["q4_stereo_48k_1s"]
    ji, _ = H.parse_both(blob)
    ji.version = 0x0300
    ji.init_derived()
    return ji


CONFIGS = {
    "q2_stereo": lambda: H.parse_both(
        H.load_fixtures()[1]["bank_q2_stereo_48k_10s"])[0],
    "q4_stereo": lambda: H.parse_both(
        H.load_fixtures()[1]["q4_stereo_48k_1s"])[0],
    "v3_stereo_hfr": _v3_hfr_info,
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_unpack_random_bytes_matches_jax_device_unpacker(name):
    ji = CONFIGS[name]()
    pi = port_frame.HcaInfo.from_arrays(dataclasses.asdict(ji))
    rng = np.random.default_rng(7)
    frames = rng.integers(0, 256, (256, ji.frame_size), dtype=np.uint8)
    frames[:, :2] = 0xFF
    frames[:8] = 0                      # padding frames decode cleanly
    qc_j, sf_j, res_j, inten_j, err_j = [
        np.asarray(x) for x in
        jax_unpack.DeviceUnpacker(ji)(frames, ji.cipher, ji.ath)[:5]]
    qc, sf, res, inten, err = _port_unpack(pi, frames)
    np.testing.assert_array_equal(err, err_j)
    assert not err[:8].any()
    assert 0 < err.sum() < len(err)     # both rules and clean frames hit
    ok = ~err
    np.testing.assert_array_equal(qc[ok], qc_j[ok])
    np.testing.assert_array_equal(sf[ok], sf_j[ok])
    np.testing.assert_array_equal(res[ok], res_j[ok])
    np.testing.assert_array_equal(inten[ok], inten_j[ok])


def test_decipher_is_a_table_lookup():
    blob = H.encode(2, 2, seed=9, key=H.KEY)
    _, pi = H.parse_both(blob, key=H.KEY)
    up = port_unpack.DeviceUnpacker(pi, device="cpu")
    frames = H.frames_of(blob, pi)
    got = up.decipher(torch.from_numpy(frames.copy()))
    np.testing.assert_array_equal(got.numpy(), pi.cipher[frames])


def test_unpacker_rejects_like_jax():
    """The JAX device unpacker refuses a zero coded_count (its host unpacker
    takes it); the port's unpacker takes it, as its kernels loop over the
    coded count at run time. Both refuse the v3 extension at 128
    scalefactors, with the same message (the port's is an HcaError)."""
    ji, pi = H.parse_both(H.encode(2, 4, seed=10))
    for mutate in (lambda i: setattr(i, "coded_count",
                                     np.array([0, 32], np.int32)),
                   lambda i: (setattr(i, "version", 0x0300),
                              setattr(i, "coded_count",
                                      np.array([125, 32], np.int32)))):
        mutate(ji)
        mutate(pi)
        with pytest.raises(ValueError) as ref:
            jax_unpack.DeviceUnpacker(ji)
        if "zero coded_count" in str(ref.value):
            up = port_unpack.DeviceUnpacker(pi, device="cpu")
            assert up.coded == [0, 32]
            continue
        with pytest.raises(port_frame.HcaError) as got:
            port_unpack.DeviceUnpacker(pi, device="cpu")
        assert str(got.value) == str(ref.value)
