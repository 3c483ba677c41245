"""PyTorch port: the decode transform's plain twins (kernel B3's reference)
on the CPU, against the JAX package byte for byte.

Random but legal spectra (qc in +-127, sf < 64, res < 16, intensity < 16)
for the five fixture configs - discrete pair (q0 stereo), intensity pair
(q2 stereo), intensity pair + HFR (q4 stereo), HFR mono (q2 mono) and two
pairs + two unpaired channels (q2 6ch) - go through
pycricodecs_tpu.ops.hca_kernels.hca_decode_transform_batched (its jnp path,
as the JAX device engine runs it on the CPU) and through the port.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pycricodecs_tpu.ops import hca_kernels as jax_kernels
from pycricodecs_tpu_torch.ops import hca_kernels as port_kernels
from tests import torch_port_helpers as H

CONFIGS = ["q0_stereo_48k_1s", "bank_q2_stereo_48k_10s", "q4_stereo_48k_1s",
           "q2_mono_48k_1s", "q2_6ch_48k_1s"]
B, F = 3, 5


def _config(name):
    ji, pi = H.parse_both(H.load_fixtures()[1][name])
    hfr, cfg = port_kernels.transform_config(pi)
    return ji, pi, hfr, cfg


def _inputs(C, seed):
    rng = np.random.default_rng(seed)
    qc = rng.integers(-127, 128, (B, F, C, 8, 128), dtype=np.int16)
    sf = rng.integers(0, 64, (B, F, C, 128), dtype=np.uint8)
    res = rng.integers(0, 16, (B, F, C, 128), dtype=np.uint8)
    inten = rng.integers(0, 16, (B, F, C, 8), dtype=np.uint8)
    return qc, sf, res, inten


def _jax_transform(args, ji):
    """The JAX package's transform, configured by its own helpers."""
    qc, sf, res, inten = args
    hfr = jax_kernels.build_hfr_map(
        ji.total_band_count, ji.base_band_count, ji.stereo_band_count,
        ji.bands_per_hfr_group, ji.hfr_group_count, ji.version)
    apply_hfr = bool(ji.bands_per_hfr_group > 0 and ji.hfr_group_count > 0)
    return np.asarray(jax_kernels.hca_decode_transform_batched(
        qc, sf, res, inten, np.zeros((1,) * 5, np.int32),
        np.zeros((1,) * 5, np.uint8), np.zeros((1,) * 5, bool),
        np.asarray(hfr.band_is_hfr), np.asarray(hfr.src_band),
        np.asarray(hfr.group_of), np.int32(hfr.zero_band),
        base_band=int(ji.base_band_count),
        total_band=int(ji.total_band_count),
        stereo_pairs=(jax_kernels.stereo_pairs_of(ji.channel_type)
                      if ji.stereo_band_count > 0 else ()),
        apply_noise=False, apply_hfr=apply_hfr,
        hfr_group_count=int(ji.hfr_group_count), use_pallas=False,
        hfr_static=jax_kernels.hfr_static_of(hfr) if apply_hfr else None))


def _port_transform(args, hfr, cfg):
    t = [torch.from_numpy(a) for a in args]
    return port_kernels.hca_decode_transform_batched(*t, hfr, **cfg).numpy()


@pytest.mark.parametrize("name", CONFIGS)
def test_transform_matches_jax(name):
    ji, pi, hfr, cfg = _config(name)
    args = _inputs(pi.channels, seed=len(name))
    got = _port_transform(args, hfr, cfg)
    assert got.shape == (B, F, 8, 128, pi.channels)
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, _jax_transform(args, ji))
    assert np.abs(got.astype(np.int32)).max() > 1000   # non-trivial output


@pytest.mark.parametrize("name", CONFIGS)
def test_transform_matches_native_host_transform(name):
    """Per stream, against the JAX package's C++ transform."""
    from pycricodecs_tpu import native
    if native.load() is None:
        pytest.skip("native core unavailable")
    _ji, pi, hfr, cfg = _config(name)
    args = _inputs(pi.channels, seed=len(name) + 1)
    got = _port_transform(args, hfr, cfg)
    for b in range(B):
        ref = jax_kernels.hca_decode_transform_host(
            *(a[b] for a in args), None, None, None,
            np.asarray(hfr.band_is_hfr), np.asarray(hfr.src_band),
            np.asarray(hfr.group_of), int(hfr.zero_band),
            apply_noise=False, **cfg)
        np.testing.assert_array_equal(got[b], ref)


def test_build_hfr_map_and_pairs_equal():
    for name in CONFIGS:
        ji, pi, hfr, _cfg = _config(name)
        ref = jax_kernels.build_hfr_map(
            ji.total_band_count, ji.base_band_count, ji.stereo_band_count,
            ji.bands_per_hfr_group, ji.hfr_group_count, ji.version)
        for got_f, ref_f in zip(hfr, ref):
            np.testing.assert_array_equal(got_f, ref_f)
        assert port_kernels.stereo_pairs_of(pi.channel_type) == \
            jax_kernels.stereo_pairs_of(ji.channel_type)
    v3 = jax_kernels.build_hfr_map(128, 32, 32, 8, 8, 0x0300)
    for got_f, ref_f in zip(port_kernels.build_hfr_map(128, 32, 32, 8, 8,
                                                       0x0300), v3):
        np.testing.assert_array_equal(got_f, ref_f)


def test_imdct_and_overlap_add_twins_equal():
    rng = np.random.default_rng(3)
    spec = (rng.standard_normal((4, 6, 128)) * 100).astype(np.float32)
    dct = port_kernels.imdct_butterflies(torch.from_numpy(spec))
    ref = jax_kernels._imdct_butterflies(jnp.asarray(spec))
    np.testing.assert_array_equal(dct.numpy(), np.asarray(ref))
    wave = port_kernels.window_overlap_add(dct)
    np.testing.assert_array_equal(
        wave.numpy(), np.asarray(jax_kernels._window_overlap_add(ref)))


def test_quantize_pcm16_saturates_and_truncates():
    wave = torch.tensor([0.5, -0.5, 1.5, -1.5, 1e10, -1e10, 3.0e-5, -3.0e-5,
                         0.99999, -0.99999], dtype=torch.float32)
    got = port_kernels.quantize_pcm16(wave).numpy()
    scaled = np.asarray(jnp.asarray(wave.numpy()) * jnp.float32(32768.0))
    ref = np.clip(np.asarray(jnp.asarray(scaled).astype(jnp.int32)),
                  -32768, 32767).astype(np.int16)
    np.testing.assert_array_equal(got, ref)
