"""PyTorch port, the frame-range decode: `models.hca.decode_range` and
`decode_frames_to_pcm` on the CPU (kernels B1-B3 through their twins) give
the JAX package's samples, shape and dtype on every HCA fixture over full,
middle, empty, clamped and reversed ranges, on an enciphered stream with
and without a subkey, on data cut mid-frame, and on the v3 PNS fixture at
several noise seeds; a bad CRC or sync word raises in both packages. The
seeded LCG jump (`lcg_jump(n, seed)`) equals the generator run step by
step.
"""
import numpy as np
import pytest
import torch

from pycricodecs_tpu.models import hca as jax_hca
from pycricodecs_tpu.ops import hca_frame as jax_frame
from pycricodecs_tpu_torch.models import hca as port_hca
from pycricodecs_tpu_torch.ops import hca_frame as port_frame
from pycricodecs_tpu_torch.ops import hca_unpack_device as port_unpack
from tests import torch_port_helpers as H

NAMES = sorted(H.load_fixtures()[0])
SUBKEY = 0x55AA
# (start, end): the whole stream, a middle range, start == end, end past
# the frame count, end = -1 from the middle, start > end, start < 0
RANGES = [(0, -1), (3, 11), (5, 5), (40, 10_000), (30, -1), (9, 4),
          (-3, 2)]


def _assert_same(got, ref):
    assert got.dtype == ref.dtype == np.int16
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("name", NAMES)
def test_decode_range_matches_jax_on_every_fixture(name):
    blob = H.load_fixture(name)
    for start, end in RANGES:
        ref = jax_hca.decode_range(blob, start, end)
        got = port_hca.decode_range(blob, start, end, device="cpu")
        _assert_same(got, ref)


def test_empty_range_has_the_channel_axis():
    blob = H.load_fixture("pns_v3_mono_48k_1s")
    got = port_hca.decode_range(blob, 5, 5, device="cpu")
    assert got.shape == (0, 1) and got.dtype == np.int16
    assert jax_hca.decode_range(blob, 5, 5).shape == (0, 1)


@pytest.mark.parametrize("subkey", [0, SUBKEY])
def test_decode_range_of_an_enciphered_stream(subkey):
    plain = H.load_fixture("q4_stereo_48k_1s")
    hs = H.header_size(plain)
    enc = jax_hca.crypt(plain, True, hs, 56, H.KEY, subkey)
    for start, end in ((0, -1), (10, 20)):
        ref = jax_hca.decode_range(enc, start, end, H.KEY, subkey)
        got = port_hca.decode_range(enc, start, end, H.KEY, subkey,
                                    device="cpu")
        _assert_same(got, ref)
        # the same range of the plain stream: the keys were right
        _assert_same(got, jax_hca.decode_range(plain, start, end))


def test_decode_range_of_data_cut_mid_frame():
    blob = H.load_fixture("q2_mono_48k_1s")
    ji, _ = H.parse_both(blob)
    cut = blob[:H.header_size(blob) + 12 * ji.frame_size + 77]
    for start, end in ((0, -1), (4, 20), (12, -1)):
        ref = jax_hca.decode_range(cut, start, end)
        got = port_hca.decode_range(cut, start, end, device="cpu")
        _assert_same(got, ref)
    assert port_hca.decode_range(cut, 0, -1, device="cpu").shape == \
        (12 * 1024, 1)


@pytest.mark.parametrize("random_state", [1, 7, 0xFFFFFFFF])
def test_decode_frames_to_pcm_pns_seeds(random_state):
    blob = H.load_fixture("pns_v3_mono_48k_1s")
    ji, pi = H.parse_both(blob)
    assert pi.min_resolution == 0
    frames = blob[H.header_size(blob):]
    ref = jax_hca.decode_frames_to_pcm(ji, frames, random_state)
    got = port_hca.decode_frames_to_pcm(pi, frames, random_state,
                                        device="cpu")
    _assert_same(got, ref)


def test_the_noise_seed_changes_the_pns_samples():
    blob = H.load_fixture("pns_v3_mono_48k_1s")
    _, pi = H.parse_both(blob)
    frames = blob[H.header_size(blob):]
    a = port_hca.decode_frames_to_pcm(pi, frames, 1, device="cpu")
    b = port_hca.decode_frames_to_pcm(pi, frames, 7, device="cpu")
    assert not np.array_equal(a, b)


@pytest.mark.parametrize("fault", ["crc", "sync"])
def test_a_bad_frame_raises_in_both_packages(fault):
    blob = bytearray(H.load_fixture("q4_stereo_48k_1s"))
    ji, _ = H.parse_both(bytes(blob))
    at = H.header_size(blob) + 6 * ji.frame_size
    if fault == "crc":
        blob[at + 40] ^= 0x10
    else:
        blob[at] = 0x00
    with pytest.raises(jax_frame.HcaError):
        jax_hca.decode_range(bytes(blob), 0, -1)
    with pytest.raises(port_frame.HcaError):
        port_hca.decode_range(bytes(blob), 0, -1, device="cpu")
    # a range that leaves the bad frame out decodes
    _assert_same(port_hca.decode_range(bytes(blob), 0, 6, device="cpu"),
                 jax_hca.decode_range(bytes(blob), 0, 6))


def test_lcg_jump_matches_the_generator_step_by_step():
    seeds = (1, 0, 7, 0x1234, 0xFFFFFFFF, 1 << 40)
    counts = (0, 1, 2, 3, 17, 1000)
    for seed in seeds:
        x, states = seed, []
        for n in range(max(counts) + 1):
            states.append(x & 0xFFFFFFFF)
            x = (0x343FD * x + 0x269EC3) & 0xFFFFFFFF
        got = port_unpack.lcg_jump(torch.tensor(counts), seed)
        assert got.tolist() == [states[n] for n in counts]
    # the default seed is 1, as before the seed was a parameter
    assert port_unpack.lcg_jump(torch.tensor([5])).tolist() == \
        port_unpack.lcg_jump(torch.tensor([5]), 1).tolist()
