"""PyTorch port: a model of kernel B3's tiled walk on the CPU.

B3 (pycricodecs_tpu_torch/csrc/hca_transform.cu) runs one CTA per (stream
b, unit, tile of 31 subframes), a warp per unit channel: a unit is a
discrete channel or an intensity primary with its secondary, lane l owns
subframe 31 * tile - 1 + l of the stream's T = F * 8, lane 0 being the
halo whose DCT is only the carry into lane 1 (a zero carry before the
stream's first subframe). The spectra are staged lanes over bands, each
step gathering from the row the previous step left (dequantise; PNS from
the raw dequantised bands; HFR from the noise-filled bands; the zero band;
intensity), then each unit channel's DCT-IV runs as the generated slot
schedule, the carry is handed to the next lane and the overlap-add
quantised; last the rows 1..31 are stored by one of three plans (whole
rows, 32-bit channel pairs, 16-bit values). `b3_model` is that walk in torch, one rounded f32 op per value as
the kernel's _rn intrinsics, the stores through the kernel's own halfword
addresses; it is held byte for byte to `decode_transform_plain` and to the
JAX package's `hca_decode_transform_batched` (its jnp path) for the five
fixture configs, T below, at and above multiples of 31, F = 1, B = 1, and
random and real PNS maps.
"""
import numpy as np
import pytest
import torch

from pycricodecs_tpu.ops import hca_kernels as jax_kernels
from pycricodecs_tpu_torch.ops import hca_kernels as K
from pycricodecs_tpu_torch.ops import hca_tables as T
from tests import torch_port_helpers as H
from tests.test_torch_imdct_schedule import run_schedule

OUT = 31                     # subframes a CTA writes (kOut)
CONFIGS = ["q0_stereo_48k_1s", "bank_q2_stereo_48k_10s", "q4_stereo_48k_1s",
           "q2_mono_48k_1s", "q2_6ch_48k_1s"]
SC = torch.from_numpy(np.asarray(T.SCALE_CONVERSION_TABLE, np.float32))
SCALING = torch.from_numpy(np.asarray(T.SCALING_TABLE, np.float32))
RANGE = torch.from_numpy(np.asarray(T.RANGE_TABLE, np.float32))
RATIO = torch.from_numpy(np.asarray(T.INTENSITY_RATIO_TABLE, np.float32))
WIN = torch.from_numpy(np.asarray(T.IMDCT_WINDOW, np.float32))


def units_of(C, stereo_pairs):
    """The kernel's units, in its order: (c0, c1 or -1) per channel that is
    no secondary."""
    partner = [-1] * C
    for p, s in stereo_pairs:
        partner[p] = s
    secondary = {s for _, s in stereo_pairs}
    return [(c, partner[c]) for c in range(C) if c not in secondary]


def store_plan(C, c0, c1):
    """[32 lanes, 4 bands, nch] halfword offsets inside an output row of
    128 * C values that the kernel's store writes, by its choice of plan."""
    nch = 2 if c1 >= 0 else 1
    lane = torch.arange(32)[:, None, None]
    e = torch.arange(4)[None, :, None]
    ch = torch.arange(nch)[None, None, :]
    if nch == C and (nch == 1 or c0 == 0):          # whole rows
        return 8 * lane + 2 * e + ch if nch == 2 else 4 * lane + e + 0 * ch
    chan = torch.tensor([c0, c1][:nch])[None, None, :]
    if nch == 2 and c1 == c0 + 1 and c0 % 2 == 0 and C % 2 == 0:
        return (4 * lane + e) * C + c0 + ch         # 32-bit (c0, c1) words
    return (4 * lane + e) * C + chan                # 16-bit values


def b3_model(qc, sf, res, inten, hfr, *, base_band, total_band,
             stereo_pairs, apply_hfr, hfr_group_count, noise=None):
    """B3 as the kernel walks it; arguments and result as
    hca_decode_transform_batched (CPU tensors)."""
    B, F, C = qc.shape[:3]
    Tn = F * 8
    tiles = -(-Tn // OUT)
    t = (torch.arange(tiles)[:, None] * OUT - 1
         + torch.arange(32)[None, :])                      # [tiles, 32]
    valid = (t >= 0) & (t < Tn)
    tc = t.clamp(0, Tn - 1)
    f, s = tc // 8, tc % 8
    band = torch.arange(128)
    hsrc = torch.from_numpy(hfr.src_band.astype(np.int64))
    hgrp = torch.from_numpy(hfr.group_of.astype(np.int64))
    his = torch.from_numpy(hfr.band_is_hfr)
    flat = torch.full((B * Tn * 128 * C,), -1, dtype=torch.int32)
    written = torch.zeros_like(flat)
    for c0, c1 in units_of(C, stereo_pairs):
        chans = [c0] + ([c1] if c1 >= 0 else [])
        # 1. the rows each lane stages: [B, tiles, 32, 128]
        sfr = [sf[:, f, c].long() for c in chans]
        v = [SCALING[sfr[i]] * RANGE[res[:, f, c].long()]
             * qc[:, f, c, s].float() for i, c in enumerate(chans)]
        # 2. PNS, gathering from the raw row
        if noise is not None:
            src, sci, mask = noise
            for i, c in enumerate(chans):
                g = torch.gather(v[i], -1, src[:, f, c, s].long())
                term = torch.where(mask[:, f, c, s],
                                   SC[sci[:, f, c, s].long()] * g, 0.0)
                v[i] = v[i] + term
        # 3. HFR (the primary), gathering from the noise-filled row
        if apply_hfr:
            gsf = sfr[0][..., 128 - hfr_group_count + hgrp]
            hsc = SC[torch.clamp(gsf - sfr[0][..., hsrc] + 63, min=0)]
            v[0] = torch.where(his, hsc * v[0][..., hsrc], v[0])
            v[0] = torch.where(band == int(hfr.zero_band), 0.0, v[0])
        # 4. intensity: the secondary from the primary's final value
        if c1 >= 0:
            rl = RATIO[inten[:, f, c1, s].long()][..., None]
            sel = (band >= base_band) & (band < total_band)
            v[1] = torch.where(sel, v[0] * (2.0 - rl), v[1])
            v[0] = torch.where(sel, v[0] * rl, v[0])
        for i, c in enumerate(chans):
            x = torch.where(valid[None, :, :, None], v[i], 0.0)
            # 5. lanes over subframes: DCT, carry to lane + 1, overlap-add
            y = run_schedule(x)
            carry = torch.where((t >= 0)[None, :, :, None], y[..., :64], 0.0)
            prev = torch.cat([carry[:, :, :1], carry[:, :, :-1]], 2)
            p = torch.arange(64)
            d = y[..., 127 - p]
            lo = WIN[63 - p] * d + WIN[64 + p] * prev      # wave[63 - p]
            hi = WIN[64 + p] * d - WIN[63 - p] * prev      # wave[64 + p]
            wave = torch.cat([torch.flip(lo, [-1]), hi], -1)
            pcm = torch.clamp(torch.trunc(wave * 32768.0), -32768.0,
                              32767.0).to(torch.int32)
            # 6. rows 1..31 below T, through the kernel's store plan
            keep = valid.clone()
            keep[:, 0] = False
            off = store_plan(C, c0, c1)[..., i].reshape(128)   # band 4l + e
            rows = (torch.arange(B)[:, None] * Tn + t[keep][None, :])
            addr = (rows[..., None] * 128 * C + off).reshape(-1)
            flat[addr] = pcm[:, keep].reshape(-1)
            written[addr] += 1
    assert bool((written == 1).all()), "a value stored twice or never"
    return flat.to(torch.int16).view(B, F, 8, 128, C)


def _config(name):
    ji, pi = H.parse_both(H.load_fixtures()[1][name])
    hfr, cfg = K.transform_config(pi)
    return ji, pi, hfr, cfg


def _inputs(rng, B, F, C, legal_noise):
    """Random spectra and PNS maps. legal_noise: a masked band has
    resolution 0 and so no code, as in a stream (the JAX jnp path selects
    the fill where the port adds it to the band's +0.0)."""
    res = rng.integers(0, 16, (B, F, C, 128), dtype=np.uint8)
    qc = rng.integers(-127, 128, (B, F, C, 8, 128), dtype=np.int16)
    mask = rng.random((B, F, C, 8, 128)) < 0.4
    if legal_noise:
        silent = (res == 0)[..., None, :]
        qc = np.where(silent, 0, qc).astype(np.int16)
        mask = silent & mask
    args = (qc, rng.integers(0, 64, (B, F, C, 128), dtype=np.uint8), res,
            rng.integers(0, 16, (B, F, C, 8), dtype=np.uint8))
    noise = (rng.integers(0, 128, (B, F, C, 8, 128), dtype=np.uint8),
             rng.integers(0, 128, (B, F, C, 8, 128), dtype=np.uint8), mask)
    return args, noise


def _jax(args, noise, ji):
    qc, sf, res, inten = args
    hfr = jax_kernels.build_hfr_map(
        ji.total_band_count, ji.base_band_count, ji.stereo_band_count,
        ji.bands_per_hfr_group, ji.hfr_group_count, ji.version)
    apply_hfr = bool(ji.bands_per_hfr_group > 0 and ji.hfr_group_count > 0)
    nz = noise if noise is not None else (np.zeros((1,) * 5, np.uint8),
                                          np.zeros((1,) * 5, np.uint8),
                                          np.zeros((1,) * 5, bool))
    return np.asarray(jax_kernels.hca_decode_transform_batched(
        qc, sf, res, inten, *nz,
        np.asarray(hfr.band_is_hfr), np.asarray(hfr.src_band),
        np.asarray(hfr.group_of), np.int32(hfr.zero_band),
        base_band=int(ji.base_band_count),
        total_band=int(ji.total_band_count),
        stereo_pairs=(jax_kernels.stereo_pairs_of(ji.channel_type)
                      if ji.stereo_band_count > 0 else ()),
        apply_noise=noise is not None, apply_hfr=apply_hfr,
        hfr_group_count=int(ji.hfr_group_count), use_pallas=False,
        hfr_static=jax_kernels.hfr_static_of(hfr) if apply_hfr else None))


def _check(name, B, F, seed, noise_kind):
    ji, pi, hfr, cfg = _config(name)
    rng = np.random.default_rng(seed)
    args, noise = _inputs(rng, B, F, pi.channels, noise_kind == "legal")
    nz = None if noise_kind is None else noise
    t_args = [torch.from_numpy(a) for a in args]
    t_nz = None if nz is None else tuple(torch.from_numpy(m) for m in nz)
    got = b3_model(*t_args, hfr, noise=t_nz, **cfg)
    plain = K.decode_transform_plain(*t_args, hfr, noise=t_nz, **cfg)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    if noise_kind != "random":      # the JAX jnp path takes legal maps
        np.testing.assert_array_equal(got.numpy(), _jax(args, nz, ji))
    assert np.abs(got.numpy().astype(np.int32)).max() > 1000


# T = F * 8 against tiles of 31: 8 (F = 1, one ragged tile), 24 (below),
# 32 (one tile and one), 248 (exactly 8 tiles), 64 (two tiles and two)
@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("B,F", [(1, 1), (2, 3), (1, 4), (2, 31), (1, 8)])
def test_model_matches_twin_and_jax(name, B, F):
    _check(name, B, F, seed=len(name) * 100 + F, noise_kind=None)


@pytest.mark.parametrize("name", ["pns_v3_mono_48k_1s", "q4_stereo_48k_1s",
                                  "q2_6ch_48k_1s"])
@pytest.mark.parametrize("kind", ["legal", "random"])
def test_model_with_pns_maps(name, kind):
    """q4 stereo: HFR takes the noise-filled band; 6ch: two pairs and two
    unpaired channels; random maps (any band masked) against the twin."""
    _check(name, 2, 5, seed=len(name) + len(kind), noise_kind=kind)


def test_model_with_the_fixtures_real_maps():
    from pycricodecs_tpu_torch.ops import hca_unpack_device as U
    name = "pns_v3_mono_48k_1s"
    ji, pi, hfr, cfg = _config(name)
    blob = H.load_fixtures()[1][name]
    up = U.DeviceUnpacker(pi, device="cpu")
    n = pi.frame_count
    frames = torch.from_numpy(H.frames_of(blob, pi).copy())
    qc, sf, res, inten, err = up(frames)
    assert not bool(err.any())
    maps = up.noise_maps(sf, res, 1)
    assert int(maps[2].sum()) > 0
    args = [x.view(1, n, *x.shape[1:]) for x in (qc, sf, res, inten)]
    noise = tuple(m.view(1, n, 1, 8, 128) for m in maps)
    got = b3_model(*args, hfr, noise=noise, **cfg)
    np.testing.assert_array_equal(
        got.numpy(), K.decode_transform_plain(*args, hfr, noise=noise,
                                              **cfg).numpy())
    np.testing.assert_array_equal(
        got.numpy(), _jax([a.numpy() for a in args],
                          [m.numpy() for m in noise], ji))


@pytest.mark.parametrize("C,pairs", [
    (1, ()), (2, ()), (2, ((0, 1),)), (6, ((0, 1), (4, 5))),
    (5, ((1, 2),)), (4, ((2, 3),)), (3, ((0, 2),)),
])
def test_store_plans_cover_every_value_once(C, pairs):
    """Across a stream's units the three plans write every (band, channel)
    halfword of a row exactly once; odd, shifted and non-adjacent pairs
    fall back to 16-bit values."""
    hits = torch.zeros(128 * C, dtype=torch.int32)
    for c0, c1 in units_of(C, pairs):
        plan = store_plan(C, c0, c1)
        for i, c in enumerate([c0, c1][:plan.shape[-1]]):
            off = plan[..., i].reshape(128)
            np.testing.assert_array_equal(
                off.numpy(), np.arange(128) * C + c)   # band k, channel c
            hits[off] += 1
    assert bool((hits == 1).all())


def test_hfr_sources_are_never_hfr_bands():
    """The kernel gathers an HFR band's source from the noise-filled row;
    that is the twin's pre-HFR value only while no source band is itself
    an HFR band. Checked for the fixture configs and every header the
    map builder takes in a sweep of band counts."""
    maps = [_config(n)[2] for n in CONFIGS]
    for total in (64, 96, 127, 128):
        for base in (0, 8, 25, 40):
            for stereo in (0, 8, 20):
                for per_group in (1, 3, 8):
                    for groups in (1, 4, 9):
                        for version in (0x0200, 0x0300):
                            maps.append(K.build_hfr_map(
                                total, base, stereo, per_group, groups,
                                version))
    for m in maps:
        assert not m.band_is_hfr[m.src_band[m.band_is_hfr]].any()
