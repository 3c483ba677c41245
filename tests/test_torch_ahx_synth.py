"""PyTorch port: the Layer II synthesis twin `synthesize_plain` (the
reference of kernel mp2_synth) on the CPU.

Held byte for byte to the JAX package's host lane,
mp2_kernels.decode_pcm16_host, which runs the native f64 V-FIFO synthesis
(cri_mp2_synthesize, built with g++ on first use); the native core must
load, so that lane is the one compared. Against the JAX device program
(decode_transform_device_batched: f32 matmuls) it is within 1 LSB, and the
number of differing samples equals the count recorded in the fixtures'
expected.json.
"""
import numpy as np
import pytest
import torch

from pycricodecs_tpu import native
from pycricodecs_tpu.ops import mp2_frame as jax_frame
from pycricodecs_tpu.ops import mp2_kernels as jax_kernels
from pycricodecs_tpu.ops import mp2_tables as jax_tables
from pycricodecs_tpu_torch.ops import cuda_kernels
from pycricodecs_tpu_torch.ops import mp2_kernels as port_kernels
from tests import torch_port_helpers as H

AHX_NAMES = sorted(H.load_ahx_fixtures()[0])


@pytest.fixture(scope="module", autouse=True)
def native_lane():
    assert native.load() is not None, "the native host lane must load"


def _host_soa(name):
    _, blobs = H.load_ahx_fixtures()
    blob = blobs[name]
    return jax_frame.unpack(blob, H.mp2_offset(blob))


def _synth(codes, levels, sfidx):
    """The twin on one stream's SoA tensors [F, C, ...] -> [C, F*1152]."""
    return port_kernels.mp2_decode_pcm(
        *(torch.from_numpy(np.ascontiguousarray(a))[None]
          for a in (codes, levels, sfidx)))[0].numpy()


@pytest.mark.parametrize("name", AHX_NAMES)
def test_twin_equals_the_host_lane(name):
    st = _host_soa(name)
    got = _synth(st.codes, st.levels, st.sfidx)
    ref = jax_kernels.decode_pcm16_host(st.codes, st.levels, st.sfidx)
    assert got.dtype == np.int16 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    assert np.abs(got.astype(np.int32)).max() > 1000


@pytest.mark.parametrize("name", ["ahx_bank_lsf_mono_22k_96k_10s",
                                  "mp2_joint8_44k_192k_1s"])
def test_twin_within_one_lsb_of_the_jax_device_program(name):
    expected, _ = H.load_ahx_fixtures()
    st = _host_soa(name)
    got = _synth(st.codes, st.levels, st.sfidx)
    dev = jax_kernels.decode_transform_device_batched(
        st.codes[None], st.levels[None], st.sfidx[None])[0]
    diff = np.abs(got.astype(np.int32) - dev.astype(np.int32))
    assert diff.max() == expected[name]["jax_device_max_lsb"] <= 1
    assert (diff > 0).sum() == expected[name]["jax_device_lsb_samples"] > 0


def test_twin_equals_the_host_lane_on_random_codes():
    """Random levels from the allocation tables (0 included), codes below
    them, scalefactor indices 0..62, stereo, several streams and lengths."""
    rng = np.random.default_rng(5)
    classes = np.unique(np.concatenate(
        [np.concatenate(t) for t in jax_tables.ALLOC_TABLES.values()]))
    B, F, C = 3, 7, 2
    levels = rng.choice(classes, (B, F, C, 32)).astype(np.int32)
    codes = (rng.random((B, F, C, 36, 32))
             * np.maximum(levels, 1)[..., None, :]).astype(np.uint16)
    codes[np.broadcast_to(levels[..., None, :] == 0, codes.shape)] = 0
    sfidx = rng.integers(0, 63, (B, F, C, 3, 32), dtype=np.uint8)
    got = port_kernels.mp2_decode_pcm(
        torch.from_numpy(codes), torch.from_numpy(levels),
        torch.from_numpy(sfidx)).numpy()
    assert got.shape == (B, C, F * 1152)
    for b in range(B):
        np.testing.assert_array_equal(got[b], jax_kernels.decode_pcm16_host(
            codes[b], levels[b], sfidx[b]))
    assert (np.abs(got.astype(np.int32)) == 32768).any()  # the clamp is hit


def test_cpu_tensors_never_launch():
    st = _host_soa("mp2_joint_varying_bound")
    _synth(st.codes, st.levels, st.sfidx)
    assert cuda_kernels.MP2_SYNTH_LAUNCHES == 0
    with pytest.raises(ValueError, match="CUDA"):
        cuda_kernels.mp2_synth(*(torch.from_numpy(a)[None] for a in (
            st.codes, st.levels, st.sfidx)))
