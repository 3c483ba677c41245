"""PyTorch port: the v3 PNS noise fill on the CPU, against the JAX package.

The fixture is tests/data/torch_port/pns_v3_mono_48k_1s.hca, a quality-0
mono stream relabelled as v3.0 with min_resolution 0 (the relabel of
tests/test_hca.py), whose resolution-0 bands are noise-filled. Held equal:
- `DeviceUnpacker.noise_maps` to the JAX DeviceUnpacker._noise (XLA) and,
  under the mask, to the host unpacker's maps; B1's twin passes
  min_resolution 0 through to the resolutions;
- `lcg_jump` to the JAX _lcg_jump;
- B3's twin with noise maps to the JAX jnp transform with apply_noise;
- `decode_batch` of [v2 stream, v3 PNS stream] to the JAX host engine and
  models.hca.decode.
Tolerance 0 throughout.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pycricodecs_tpu import parallel as jax_parallel
from pycricodecs_tpu.models import hca as jax_hca
from pycricodecs_tpu.ops import hca_frame as jax_frame
from pycricodecs_tpu.ops import hca_kernels as jax_kernels
from pycricodecs_tpu.ops import hca_unpack_device as jax_unpack
from pycricodecs_tpu_torch import parallel as port_parallel
from pycricodecs_tpu_torch.ops import hca_kernels as port_kernels
from pycricodecs_tpu_torch.ops import hca_unpack_device as port_unpack
from pycricodecs_tpu_torch.utils.signals import HCA_PNS
from tests import torch_port_helpers as H


@pytest.fixture(scope="module")
def pns():
    expected, blobs = H.load_fixtures()
    assert expected[HCA_PNS]["v3_pns"]
    blob = blobs[HCA_PNS]
    ji, pi = H.parse_both(blob)
    assert pi.version == 0x0300 and pi.min_resolution == 0
    frames = H.frames_of(blob, pi)
    up = port_unpack.DeviceUnpacker(pi, device="cpu")
    qc, sf, res, inten, err = up(frames)
    assert not err.any()
    ref = jax_frame._unpack_frames_py(
        ji, blob[H.header_size(blob):][:ji.frame_count * ji.frame_size])
    return dict(blob=blob, ji=ji, pi=pi, frames=frames, up=up, qc=qc, sf=sf,
                res=res, inten=inten, ref=ref)


def test_b1_twin_passes_min_resolution_zero(pns):
    ref = pns["ref"]
    np.testing.assert_array_equal(pns["res"].numpy(), ref.resolutions)
    np.testing.assert_array_equal(pns["sf"].numpy(), ref.scalefactors)
    np.testing.assert_array_equal(pns["qc"].numpy(), ref.qc)
    assert pns["up"].min_res == 0
    assert (pns["res"].numpy()[pns["sf"].numpy() > 0] == 0).any()


def test_noise_maps_equal_the_jax_device_unpacker(pns):
    src, sci, mask = pns["up"].noise_maps(pns["sf"], pns["res"], 1)
    jup = jax_unpack.DeviceUnpacker(pns["ji"])
    jsrc, jsci, jmask = (np.asarray(a) for a in jup._noise(
        jnp.asarray(pns["sf"].numpy()), jnp.asarray(pns["res"].numpy()), 1))
    assert src.dtype == torch.uint8 and sci.dtype == torch.uint8
    np.testing.assert_array_equal(src.numpy(), jsrc)
    np.testing.assert_array_equal(sci.numpy(), jsci)
    np.testing.assert_array_equal(mask.numpy(), jmask)
    assert mask.sum() > 1000


def test_noise_maps_equal_the_host_unpacker_under_the_mask(pns):
    ref = pns["ref"]
    src, sci, mask = (m.numpy() for m in pns["up"].noise_maps(
        pns["sf"], pns["res"], 1))
    np.testing.assert_array_equal(mask, ref.noise_mask)
    np.testing.assert_array_equal(np.where(mask, src, 0),
                                  np.where(mask, ref.noise_src, 0))
    np.testing.assert_array_equal(np.where(mask, sci, 0),
                                  np.where(mask, ref.noise_sci, 0))


def test_noise_maps_batch_keeps_each_stream_from_seed_one(pns):
    """Two streams of different lengths stacked frame-major with a padded
    tail: each stream's maps equal its own maps alone, and the batch equals
    the JAX _noise with B = 2."""
    n = pns["pi"].frame_count
    cut = n - 9
    stack = np.zeros((2, n, pns["pi"].frame_size), np.uint8)
    stack[0] = pns["frames"]
    stack[1, :cut] = pns["frames"][9:]
    up = pns["up"]
    _, sf, res, _, err = up(stack.reshape(2 * n, -1))
    assert not err.any()
    got = [m.view(2, n, 1, 8, 128) for m in up.noise_maps(sf, res, 2)]
    alone = up.noise_maps(sf[n:n + cut], res[n:n + cut], 1)
    for g, a in zip(got, alone):
        np.testing.assert_array_equal(g[1, :cut].numpy(), a.numpy())
    jup = jax_unpack.DeviceUnpacker(pns["ji"])
    ref = jup._noise(jnp.asarray(sf.numpy()), jnp.asarray(res.numpy()), 2)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.reshape(2 * n, 1, 8, 128).numpy(),
                                      np.asarray(r))


def test_lcg_jump_equals_jax():
    rng = np.random.default_rng(4)
    n = np.concatenate([np.arange(70), rng.integers(0, 2**32, 2000),
                        [2**32 - 1, 2**31, 2**31 - 1]]).astype(np.int64)
    got = port_unpack.lcg_jump(torch.from_numpy(n)).numpy()
    ref = np.asarray(jax_unpack._lcg_jump(jnp.asarray(n.astype(np.uint32))))
    np.testing.assert_array_equal(got, ref.astype(np.int64))
    # the serial chain for the first draws
    x, chain = 1, []
    for _ in range(70):
        chain.append(x)
        x = (0x343FD * x + 0x269EC3) & 0xFFFFFFFF
    np.testing.assert_array_equal(got[:70], chain)


def _jax_transform(args, noise, ji):
    qc, sf, res, inten = args
    hfr = jax_kernels.build_hfr_map(
        ji.total_band_count, ji.base_band_count, ji.stereo_band_count,
        ji.bands_per_hfr_group, ji.hfr_group_count, ji.version)
    apply_hfr = bool(ji.bands_per_hfr_group > 0 and ji.hfr_group_count > 0)
    return np.asarray(jax_kernels.hca_decode_transform_batched(
        qc, sf, res, inten, *noise,
        np.asarray(hfr.band_is_hfr), np.asarray(hfr.src_band),
        np.asarray(hfr.group_of), np.int32(hfr.zero_band),
        base_band=int(ji.base_band_count),
        total_band=int(ji.total_band_count),
        stereo_pairs=(jax_kernels.stereo_pairs_of(ji.channel_type)
                      if ji.stereo_band_count > 0 else ()),
        apply_noise=True, apply_hfr=apply_hfr,
        hfr_group_count=int(ji.hfr_group_count), use_pallas=False,
        hfr_static=jax_kernels.hfr_static_of(hfr) if apply_hfr else None))


@pytest.mark.parametrize("name", [HCA_PNS, "q4_stereo_48k_1s",
                                  "q2_6ch_48k_1s"])
def test_transform_twin_with_random_maps_matches_jax(name):
    """Random legal spectra and maps; q4 stereo has HFR (its source is the
    noise-filled band) and an intensity pair, 6ch two pairs. Legal as in a
    stream: a masked band has resolution 0 and so no code (the JAX jnp path
    selects the fill where the port adds it to the band's +0.0)."""
    ji, pi = H.parse_both(H.load_fixtures()[1][name])
    hfr, cfg = port_kernels.transform_config(pi)
    B, F, C = 2, 4, pi.channels
    rng = np.random.default_rng(len(name))
    res = rng.integers(0, 16, (B, F, C, 128), dtype=np.uint8)
    silent = (res == 0)[..., None, :]
    qc = rng.integers(-127, 128, (B, F, C, 8, 128), dtype=np.int16)
    args = (np.where(silent, 0, qc).astype(np.int16),
            rng.integers(0, 64, (B, F, C, 128), dtype=np.uint8), res,
            rng.integers(0, 16, (B, F, C, 8), dtype=np.uint8))
    noise = (rng.integers(0, 128, (B, F, C, 8, 128), dtype=np.uint8),
             rng.integers(0, 128, (B, F, C, 8, 128), dtype=np.uint8),
             silent & (rng.random((B, F, C, 8, 128)) < 0.6))
    got = port_kernels.hca_decode_transform_batched(
        *(torch.from_numpy(a) for a in args), hfr,
        noise=tuple(torch.from_numpy(a) for a in noise), **cfg).numpy()
    np.testing.assert_array_equal(got, _jax_transform(args, noise, ji))
    plain = port_kernels.hca_decode_transform_batched(
        *(torch.from_numpy(a) for a in args), hfr, **cfg).numpy()
    assert (got != plain).any()          # the noise term changed the output


def test_transform_twin_with_real_maps_matches_jax(pns):
    n = pns["pi"].frame_count
    maps = pns["up"].noise_maps(pns["sf"], pns["res"], 1)
    args = [t.view(1, n, *t.shape[1:]) for t in
            (pns["qc"], pns["sf"], pns["res"], pns["inten"])]
    noise = [m.view(1, n, 1, 8, 128) for m in maps]
    hfr, cfg = port_kernels.transform_config(pns["pi"])
    got = port_kernels.hca_decode_transform_batched(*args, hfr, noise=noise,
                                                    **cfg).numpy()
    ref = _jax_transform([a.numpy() for a in args],
                         [m.numpy() for m in noise], pns["ji"])
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("on_error", ["raise", "isolate"])
def test_decode_batch_v2_and_pns_streams_match_jax(pns, on_error):
    ok = H.encode(2, 2, seed=23, samples=10000)
    got = port_parallel.decode_batch([ok, pns["blob"]], device="cpu",
                                     on_error=on_error)
    ref = jax_parallel.decode_batch([ok, pns["blob"]], engine="host",
                                    on_error=on_error)
    assert got == ref
    assert got[1] == jax_hca.decode(pns["blob"])
    expected, _ = H.load_fixtures()
    import hashlib
    assert hashlib.sha256(got[1]).hexdigest() == \
        expected[HCA_PNS]["wav_sha256"]


def test_pns_stream_from_another_seed_decodes_like_jax():
    """A second PNS stream (the JAX suite's quiet-tail fixture: one frame of
    noise bands), three copies in one chunk."""
    from tests.test_hca import _relabel_v3
    v3 = _relabel_v3(H.encode(1, 0, seed=77, samples=24576))
    got = port_parallel.decode_batch([v3] * 3, device="cpu")
    assert got == [jax_hca.decode(v3)] * 3
