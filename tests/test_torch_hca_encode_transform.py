"""PyTorch port, HCA encode analysis: the port's `hca_encode_transform`
equals the JAX package's on every output (f32 compared as its bits) over the
device-packer test matrix; its float64 HFR scales equal `_host_hfr_scales`
(and `hfr_scales_device` wherever that one's guard is clear); its rate
control with a starved bit budget takes the reference's top-band-zeroing
fallback exactly as the JAX package's numpy encoder does.
"""
import numpy as np
import pytest
import torch

from pycricodecs_tpu.ops import hca_encode_device as JD
from pycricodecs_tpu.ops import hca_encode_host as JH
from pycricodecs_tpu.ops import hca_frame as jax_frame
from pycricodecs_tpu.ops import hca_hfr_device as JHFR
from pycricodecs_tpu.utils import wav as jax_wav
from pycricodecs_tpu.utils.wav import write_wav
from pycricodecs_tpu_torch.ops import hca_encode_device as PD
from pycricodecs_tpu_torch.ops import hca_frame as port_frame
from tests import torch_port_helpers  # noqa: F401  (one torch thread)
from tests.test_pack_device import CASES, _wav

NAMES = ("sf", "res", "intensity", "quant", "level", "boundary",
         "delta_bits", "ga", "gs")


def _case_id(c):
    return (f"ch{c['channels']}q{c['quality']}r{c.get('rate', 44100)}"
            f"{'loop' if c.get('loop') else ''}")


def _config(case):
    """(JAX EncConfig, padded PCM [1, C, Fp*1024], transform keywords)."""
    w = jax_wav.parse_wav(_wav(samples=case["samples"],
                               channels=case["channels"],
                               rate=case.get("rate", 44100),
                               seed=case["seed"],
                               loop=case.get("loop", False)))
    cfg = JH.init_encode(w, case["quality"], w.looping)
    info = cfg.info
    Fp = -(-info.frame_count // 16) * 16
    pcm = np.zeros((1, info.channels, Fp * 1024), np.int16)
    tl = JH.build_timeline(cfg, w)
    pcm[0, :, :tl.shape[1]] = tl
    kw = PD.encode_config(info, cfg)
    return cfg, pcm, kw


def _transform_kw(kw):
    return {k: v for k, v in kw.items()
            if k not in ("hfr_counts", "hfr_counts2")}


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_transform_matches_jax(case):
    cfg, pcm, kw = _config(case)
    tkw = _transform_kw(kw)
    ref = [np.asarray(x) for x in JD.hca_encode_transform(pcm, **tkw)]
    got = [x.numpy() for x in
           PD.hca_encode_transform(torch.from_numpy(pcm), **tkw)]
    assert (ref[4] >= 0).all(), "rate-control fallback in test input"
    for name, g, r in zip(NAMES, got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype, name
        if r.dtype == np.float32:
            g, r = g.view(np.uint32), r.view(np.uint32)
        np.testing.assert_array_equal(g, r, err_msg=name)


@pytest.mark.parametrize("case", [c for c in CASES if c["quality"] >= 2
                                  or c["channels"] == 1], ids=_case_id)
def test_hfr_scales_match_host_and_guarded_device(case):
    cfg, pcm, kw = _config(case)
    info = cfg.info
    out = JD.hca_encode_transform(pcm, **_transform_kw(kw))
    ga, gs = np.array(out[7]), np.array(out[8])
    got = PD.hfr_scales(torch.from_numpy(ga), torch.from_numpy(gs),
                        counts=kw["hfr_counts"], counts2=kw["hfr_counts2"],
                        channel_types=kw["channel_types"]).numpy()
    host = JD._host_hfr_scales(info, cfg, ga, gs)
    np.testing.assert_array_equal(got, host)
    counts, counts2 = JHFR._group_counts(info, int(cfg.hfr_band_count))
    assert (tuple(counts), tuple(counts2)) == (kw["hfr_counts"],
                                               kw["hfr_counts2"])
    dev, guard = JHFR.hfr_scales_device(
        ga, gs, counts=tuple(counts), counts2=tuple(counts2),
        channel_types=kw["channel_types"])
    clear = ~np.asarray(guard)
    np.testing.assert_array_equal(got[clear], np.asarray(dev)[clear])


def test_hfr_scales_cover_groups_and_secondaries():
    """Random group sums (zeros included) on a 6-channel HFR config: every
    scale equals the JAX package's float64 host normalisation."""
    w = jax_wav.parse_wav(_wav(samples=4096, channels=6, seed=2))
    cfg = JH.init_encode(w, 4, False)
    info = cfg.info
    assert info.hfr_group_count > 1 and 2 in info.channel_type
    kw = PD.encode_config(info, cfg)
    rng = np.random.default_rng(11)
    shape = (2, 5, 6, info.hfr_group_count)
    ga = (rng.random(shape) * 40).astype(np.float32)
    gs = (rng.random(shape) * 3).astype(np.float32)
    gs[0, 0] = 0.0
    ga[1, 1] = 0.0
    got = PD.hfr_scales(torch.from_numpy(ga), torch.from_numpy(gs),
                        counts=kw["hfr_counts"], counts2=kw["hfr_counts2"],
                        channel_types=kw["channel_types"]).numpy()
    np.testing.assert_array_equal(got, JD._host_hfr_scales(info, cfg, ga, gs))


def _noise_stages(quality=2, seed=7):
    """Full-scale stereo white noise through the JAX host encoder's stages:
    (info, cfg, timeline [C, F*1024], spectra [F, C, 8, 128], intensity
    [F, C, 8], sf [F, C, 128], scaled [F, C, 8, 128])."""
    rng = np.random.default_rng(seed)
    pcm = np.clip(rng.standard_normal((12000, 2)) * 32767,
                  -32768, 32767).astype(np.int16)
    w = jax_wav.parse_wav(write_wav(pcm.reshape(-1), 2, 48000))
    cfg = JH.init_encode(w, quality, False)
    info = cfg.info
    tl = JH.build_timeline(cfg, w)
    timeline = np.zeros((info.channels, info.frame_count * 1024), np.int16)
    timeline[:, :tl.shape[1]] = tl
    spec = JH.run_mdct(timeline)
    intensity = np.zeros((info.frame_count, 2, 8), np.uint8)
    JH.encode_intensity_stereo(info, spec, intensity)
    sf = JH.calc_scalefactors(info, spec)
    return (info, cfg, timeline, spec, intensity, sf,
            JH.scale_spectra(info, spec, sf))


def _noise_tensors(quality=2, seed=7):
    """(info, cfg, sf [F, C, 128], scaled [F, C, 8, 128]) of the noise."""
    info, cfg, _, _, _, sf, scaled = _noise_stages(quality, seed)
    return info, cfg, sf, scaled


def _port_rate_control(info, cfg, sf, scaled, avail):
    kw = PD.encode_config(info, cfg)
    coded = np.zeros((info.channels, 128), bool)
    for c in range(info.channels):
        coded[c, :info.coded_count[c]] = True
    sf_t = torch.from_numpy(sf.astype(np.int32))
    cost = PD.band_cost_table(torch.from_numpy(scaled),
                              torch.from_numpy(coded))
    db, hl = PD.delta_lengths(sf_t, kw["coded_counts"], kw["channel_types"],
                              kw["hfr_group_count"])
    level, boundary = PD.rate_control(
        sf_t, cost, db, hl, avail,
        top_band=info.base_band_count + info.stereo_band_count,
        coded_counts=kw["coded_counts"], channel_types=kw["channel_types"],
        hfr_group_count=kw["hfr_group_count"])
    return [t.numpy() for t in (level, boundary, sf_t, db, hl)]


def _numpy_rate_control(info, sf, scaled, avail):
    """The JAX package's numpy rate control with its fallback loop (as
    tests/test_hca.py drives it): level, boundary, sf, delta_bits,
    header_len."""
    db, hl = JH.calc_delta_lengths(info, sf)
    sf_py, db_py, hl_py = sf.copy(), db.copy(), hl.copy()
    level_py = JH.binary_search_level(info, sf_py, scaled, hl_py, avail)
    for fidx in np.nonzero(level_py < 0)[0]:
        highest = info.base_band_count + info.stereo_band_count - 1
        while level_py[fidx] < 0:
            highest -= 2
            assert highest >= 0
            sf_py[fidx, :, highest + 1] = 0
            sf_py[fidx, :, highest + 2] = 0
            d1, h1 = JH.calc_delta_lengths(info, sf_py[fidx:fidx + 1])
            db_py[fidx], hl_py[fidx] = d1[0], h1[0]
            level_py[fidx] = JH.binary_search_level(
                info, sf_py[fidx:fidx + 1], scaled[fidx:fidx + 1],
                hl_py[fidx:fidx + 1], avail)[0]
    bnd_py = np.zeros(level_py.shape[0], np.int32)
    nz = level_py != 0
    bnd_py[nz] = JH.binary_search_boundary(
        info, sf_py[nz], scaled[nz], hl_py[nz], avail, level_py[nz])
    return level_py, bnd_py, sf_py, db_py, hl_py


@pytest.mark.parametrize("quality,divisor", [(2, 3), (0, 4), (4, 2), (2, 1),
                                             (2, 2)])
def test_rate_control_and_fallback_match_numpy_encoder(quality, divisor):
    """With the full budget no frame fails; with 1/divisor of it frames
    fail the level search and take the fallback (hca.cpp:2816-2828), all
    of them at the starved budgets. Levels, boundaries, the zeroed
    scalefactors and the recomputed delta and header lengths equal the JAX
    package's numpy encoder."""
    info, cfg, sf, scaled = _noise_tensors(quality)
    avail = info.frame_size * 8 // divisor
    ref = _numpy_rate_control(info, sf, scaled, avail)
    first = JH.binary_search_level(info, sf, scaled,
                                   JH.calc_delta_lengths(info, sf)[1], avail)
    if divisor == 1:
        assert (first >= 0).all()
    elif divisor > 2:
        assert (first < 0).all(), "budget not starved enough"
    got = _port_rate_control(info, cfg, sf, scaled, avail)
    for name, g, r in zip(("level", "boundary", "sf", "delta_bits",
                           "header_len"), got, ref):
        np.testing.assert_array_equal(g, r, err_msg=name)


def test_rate_control_without_room_raises_like_the_reference():
    info, cfg, sf, scaled = _noise_tensors(2, seed=8)
    with pytest.raises(port_frame.HcaError, match="Unknown Encoding error"):
        _port_rate_control(info, cfg, sf, scaled, 40)


@pytest.mark.parametrize("quality,divisor", [(2, 3), (0, 4), (4, 2)])
def test_starved_fallback_frames_match_jax(quality, divisor):
    """Whole frames at a starved bit budget: the port's hca_encode_frames
    (transform with the fallback, float64 HFR scales, packer) equals the
    JAX package's host encoder stages with the same fallback, then its
    resolutions, quantize_spectra and pack_frame, byte for byte."""
    info, cfg, timeline, spec, intensity, sf, scaled = _noise_stages(quality)
    avail = info.frame_size * 8 // divisor
    hfr = JH.calc_hfr_scales(info, cfg, spec, scaled, sf)
    level, boundary, sf_py, db, _ = _numpy_rate_control(info, sf, scaled,
                                                        avail)
    assert (sf_py != sf).any(), "fallback not reached"
    band = np.arange(128)
    noise = np.where(band[None, None, :] < boundary[:, None, None],
                     level[:, None, None] - 1, level[:, None, None])
    res = JH.calc_resolution_enc(sf_py.astype(np.int64), noise)
    for c in range(info.channels):
        res[:, c, info.coded_count[c]:] = 0
    quant = JH.quantize_spectra(info, scaled, res)
    want = b"".join(
        jax_frame.pack_frame(info, int(level[f]), int(boundary[f]), sf_py[f],
                             res[f], intensity[f], hfr[f], db[f], quant[f])
        for f in range(info.frame_count))
    got = PD.hca_encode_frames(torch.from_numpy(timeline[None]),
                               **PD.encode_config(info, cfg), avail=avail)
    assert got.numpy().tobytes() == want
