"""PyTorch port: the twins of kernels B4 (DCT-IV + windowed overlap-add)
and B5 (DCT-IV) and the float-wave decode `hca_decode_wave` on the CPU,
against the JAX package.

B4's twin `imdct_ola_plain` is held to pycricodecs_tpu.ops.pallas_kernels.
imdct_ola_pallas and B5's twin `imdct_butterflies` (the CPU branch of
`imdct`) to imdct_pallas, both run in interpret mode as tests/test_pallas.py
runs them, with T not a multiple of their 256-row tile. `hca_decode_wave`
is held to the JAX hca_kernels.hca_decode_wave on frames unpacked by the
JAX host reference, without noise (the bank stream, intensity pair; the q4
stereo stream, HFR) and with the v3 PNS fixture's noise maps.

Tolerance: equal f32 values (np.array_equal, so +0.0 and -0.0 count as
equal: B4's docstring allows sign-of-zero differences; no other difference
is allowed).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pycricodecs_tpu.ops import hca_frame as jax_frame
from pycricodecs_tpu.ops import hca_kernels as jax_kernels
from pycricodecs_tpu.ops import pallas_kernels
from pycricodecs_tpu_torch.ops import hca_kernels as port_kernels
from pycricodecs_tpu_torch.utils.signals import HCA_PNS
from tests import torch_port_helpers as H


def _spectra(shape, seed):
    """Random spectra with extremes: large and tiny magnitudes, zeros of
    both signs, a denormal."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 3000).astype(np.float32)
    flat = x.reshape(-1)
    flat[::97] = 0.0
    flat[1::97] = -0.0
    flat[2::211] = 1.0e30
    flat[3::211] = -1.0e30
    flat[4::307] = 1.0e-40
    x[0, 0] = 0.0                           # an all-zero row
    return x


def _equal(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == np.float32
    assert np.array_equal(a, b)             # -0.0 == +0.0; NaN would fail


@pytest.mark.parametrize("R,T", [(3, 300), (1, 8), (2, 37)])
def test_imdct_ola_twin_matches_pallas_interpret(R, T):
    x = _spectra((R, T, 128), seed=R * 1000 + T)
    ref = np.asarray(pallas_kernels.imdct_ola_pallas(jnp.asarray(x),
                                                     interpret=True))
    got = port_kernels.imdct_ola(torch.from_numpy(x)).numpy()
    _equal(got, ref)
    _equal(port_kernels.imdct_ola_plain(torch.from_numpy(x)).numpy(), ref)
    assert np.abs(got).max() > 1.0e29       # the extremes went through


@pytest.mark.parametrize("shape", [(300, 128), (4, 77, 128), (128,)])
def test_imdct_twin_matches_pallas_interpret(shape):
    x = _spectra((1,) + shape if len(shape) == 1 else shape,
                 seed=len(shape)).reshape(shape)
    ref = np.asarray(pallas_kernels.imdct_pallas(jnp.asarray(x),
                                                 interpret=True))
    got = port_kernels.imdct(torch.from_numpy(x)).numpy()
    _equal(got, ref)


def _unpacked(name, F):
    """(JAX info, port info, UnpackedFrames of the first F frames)."""
    blob = H.load_fixtures()[1][name]
    ji, pi = H.parse_both(blob)
    data = blob[H.header_size(blob):][:F * ji.frame_size]
    return ji, pi, jax_frame._unpack_frames_py(ji, data)


def _jax_wave(ji, un, B, F, noise):
    hfr = jax_kernels.build_hfr_map(
        ji.total_band_count, ji.base_band_count, ji.stereo_band_count,
        ji.bands_per_hfr_group, ji.hfr_group_count, ji.version)
    C = ji.channels
    kw = {}
    if noise:
        kw = {k: getattr(un, k).reshape(B, F, C, 8, 128)
              for k in ("noise_src", "noise_sci", "noise_mask")}
    return np.asarray(jax_kernels.hca_decode_wave(
        un.qc.reshape(B, F, C, 8, 128), un.scalefactors.reshape(B, F, C, 128),
        un.resolutions.reshape(B, F, C, 128), un.intensity.reshape(B, F, C, 8),
        np.asarray(hfr.band_is_hfr), np.asarray(hfr.src_band),
        np.asarray(hfr.group_of), np.int32(hfr.zero_band),
        base_band=int(ji.base_band_count),
        total_band=int(ji.total_band_count),
        stereo_pairs=(jax_kernels.stereo_pairs_of(ji.channel_type)
                      if ji.stereo_band_count > 0 else ()),
        apply_hfr=bool(ji.bands_per_hfr_group > 0 and ji.hfr_group_count > 0),
        hfr_group_count=int(ji.hfr_group_count), **kw))


def _port_wave(pi, un, B, F, noise):
    C = pi.channels
    hfr, cfg = port_kernels.transform_config(pi)
    t = [torch.from_numpy(np.ascontiguousarray(a)).view(B, F, C, *a.shape[2:])
         for a in (un.qc, un.scalefactors, un.resolutions, un.intensity)]
    maps = None
    if noise:
        maps = tuple(torch.from_numpy(np.ascontiguousarray(a)).view(
            B, F, C, 8, 128) for a in (un.noise_src.astype(np.uint8),
                                       un.noise_sci, un.noise_mask))
    return port_kernels.hca_decode_wave(*t, hfr, noise=maps, **cfg).numpy()


@pytest.mark.parametrize("name,B,F", [("bank_q2_stereo_48k_10s", 2, 6),
                                      ("q4_stereo_48k_1s", 3, 4),
                                      ("q2_6ch_48k_1s", 1, 5)])
def test_decode_wave_matches_jax(name, B, F):
    ji, pi, un = _unpacked(name, B * F)
    got = _port_wave(pi, un, B, F, noise=False)
    assert got.shape == (B, pi.channels, F * 8, 128)
    _equal(got, _jax_wave(ji, un, B, F, noise=False))
    assert np.abs(got).max() > 0.1          # real audio


def test_decode_wave_with_pns_noise_matches_jax():
    ji, pi, un = _unpacked(HCA_PNS, 12)
    assert un.noise_mask.any()
    got = _port_wave(pi, un, 2, 6, noise=True)
    _equal(got, _jax_wave(ji, un, 2, 6, noise=True))
    assert not np.array_equal(got, _port_wave(pi, un, 2, 6, noise=False))
