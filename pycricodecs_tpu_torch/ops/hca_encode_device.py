"""Batched HCA encode on one device: PCM16 -> quantised spectra -> frames.

Counterpart of pycricodecs_tpu/ops/hca_encode_device.py (reference
hca.cpp:2470-2963). One call encodes a group of streams that share
(channels, sample rate), as tensors [B streams, F frames, C channels,
8 subframes, 128 bands]:

1. `hca_mdct`: encoder window fold + DCT-IV (kernel B6, csrc/hca_encode.cu,
   on a CUDA tensor; its twin `mdct_plain` on a CPU tensor);
2. the analysis, plain PyTorch: intensity stereo, scalefactors, scaled
   spectra, HFR group sums, delta lengths, the per-band cost table and the
   fixed-trip level and boundary searches, resolutions and quantisation;
3. `rate_control` runs the reference's top-band-zeroing fallback
   (hca_encode_host.py:790-815 of the JAX package) on the frames whose level
   search failed, on the device; the JAX package sent those streams to its
   host encoder instead;
4. `hfr_scales`: the HFR scale normalisation in real float64 (the JAX
   device path needed Dekker pairs and a guard-band reroute only because the
   TPU has no float64);
5. the frame packer (hca_pack_device.pack_frames, kernel B9's work inside
   csrc/hca_pack.cu).

Exactness: every float value is one rounded IEEE multiply, add, subtract or
divide, as separate PyTorch ops in the JAX order (no addcmul, matmul or
reduction over floats; the order-sensitive band sums are left folds of
single adds), so a CPU run is bit-equal to the JAX package and a CUDA run
to the CPU run. Keep torch.compile off this path.
"""
from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch

from . import cuda_kernels
from . import hca_encode_host as H
from . import hca_frame
from . import hca_pack_device
from . import hca_tables as T
from .hca_kernels import _table
from ..utils import wav as wavmod
from ..utils.device import as_device

f32 = torch.float32
i32 = torch.int32

# int tables precomputed with the reference's float64 semantics
_SHIFT_DOWN_UB = np.trunc(T.QUANTIZER_INVERSE_STEP_SIZE.astype(np.float64)
                          + 0.5 - 8).astype(np.int32)
_SHIFT_DOWN_Q = np.trunc(T.QUANTIZER_INVERSE_STEP_SIZE.astype(np.float64)
                         + 0.5).astype(np.int32)
# python floats that are exact float32 values, so a comparison or select
# against them means the same in float32 and float64
_SQRT2_2_F32 = float(np.float32(np.sqrt(2.0) / 2.0))
_LIM = float(np.float32(0.9999999))


# ---------------------------------------------------------------------------
# MDCT: plain twin of kernel B6
# ---------------------------------------------------------------------------

def dct4(x: torch.Tensor) -> torch.Tensor:
    """Exact-order DCT-IV over the last axis (hca.cpp:2481-2527); the JAX
    package's `_dct4`. x f32 [..., 128]."""
    shape = x.shape
    lead = shape[:-1]
    dev = x.device
    sin7, cos7 = T.dct4_stage_tables(7)
    sin7 = _table(sin7[:64], dev)
    cos7 = _table(cos7[:64], dev)
    a = x[..., 0::2]
    b = torch.flip(x, dims=[-1])[..., 0::2]           # x[127 - 2k]
    even = a * cos7 + b * sin7
    odd = a * sin7 - b * cos7
    temp = torch.stack([even, odd], dim=-1).reshape(shape)
    for stage in range(6):
        block_count = 1 << stage
        bhs_bits = 5 - stage
        bhs = 1 << bhs_bits
        sin, cos = T.dct4_stage_tables(bhs_bits)
        sin = _table(sin, dev)
        cos = _table(cos, dev)
        g = temp.reshape(*lead, block_count, 2, bhs, 2)
        fe, fo = g[..., 0, :, 0], g[..., 0, :, 1]
        be, bo = g[..., 1, :, 0], g[..., 1, :, 1]
        a2 = fe - be
        b2 = fo - bo
        ne = fe + be
        no = fo + bo
        nbe = a2 * cos + b2 * sin
        nbo = a2 * sin - b2 * cos
        front = torch.stack([ne, no], dim=-1)         # [..., bc, bhs, 2]
        back = torch.stack([nbe, nbo], dim=-1)
        temp = torch.stack([front, back], dim=-3).reshape(shape)
    out = temp[..., _table(T.SHUFFLE_TABLE.astype(np.int64), dev)]
    return out * 0.125


def mdct_plain(pcm: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of kernel B6: PCM16 [B, C, T*128] -> spectra f32
    [B, C, T, 128] (hca.cpp:2529-2553; the JAX package's `_mdct` on
    pcm / 32768). Each 128-sample block folds with the previous one of its
    stream channel; a stream's first block folds with zeros."""
    B, C, total = pcm.shape
    Tn = total // 128
    wave = (pcm.to(f32) * (1.0 / 32768.0)).reshape(B, C, Tn, 128)
    w = _table(T.IMDCT_WINDOW, pcm.device)
    prev = torch.cat([torch.zeros_like(wave[:, :, :1]), wave[:, :, :-1]],
                     dim=2)
    a = torch.flip(w[:64], dims=[0]) * (-wave[..., 64:])
    b = (-w[64:]) * torch.flip(wave[..., :64], dims=[-1])
    first = a - b
    c = w[:64] * prev[..., :64]
    d = (-torch.flip(w[64:], dims=[0])) * torch.flip(prev[..., 64:], dims=[-1])
    second = c - d
    return dct4(torch.cat([first, second], dim=-1))


def hca_mdct(pcm: torch.Tensor) -> torch.Tensor:
    """Encoder MDCT of PCM16 [B, C, T*128] -> f32 [B, C, T, 128]: kernel B6
    on a CUDA tensor, the plain twin on a CPU tensor."""
    if pcm.device.type == "cpu":
        return mdct_plain(pcm)
    return cuda_kernels.hca_mdct(pcm)


# ---------------------------------------------------------------------------
# Analysis stages (hca_encode_transform of the JAX package)
# ---------------------------------------------------------------------------

def _scan_band_sum(values: torch.Tensor) -> torch.Tensor:
    """Exact sequential f32 sum over the last axis, a left fold of single
    adds (the reference order; a reduction kernel's order is not fixed)."""
    out = torch.zeros(values.shape[:-1], dtype=f32, device=values.device)
    for i in range(values.shape[-1]):
        out = out + values[..., i]
    return out


def encode_intensity(spectra, base_band, total_band, pairs):
    """EncodeIntensityStereo (hca.cpp:2561-2609) on spectra f32
    [..., C, 8, 128], updated in place; returns (spectra, intensity u8
    [..., C, 8])."""
    dev = spectra.device
    intensity = torch.zeros(spectra.shape[:-2] + (8,), dtype=torch.uint8,
                            device=dev)
    if not pairs:
        return spectra, intensity
    bounds = _table(T.INTENSITY_RATIO_BOUNDS[1:13], dev)
    band = torch.arange(128, device=dev)
    sel = (band >= base_band) & (band < total_band)
    for (p, s) in pairs:
        l = spectra[..., p, :, :]
        r = spectra[..., s, :, :]
        lb = l[..., base_band:total_band]
        rb = r[..., base_band:total_band]
        e_l = _scan_band_sum(lb.abs())
        e_r = _scan_band_sum(rb.abs())
        e_t = _scan_band_sum((lb + rb).abs()) * 2.0
        e_lr = e_r + e_l
        stored = (2.0 * e_l) / e_lr
        ratio = e_lr / e_t
        ratio = torch.where(ratio < 0.5, 0.5, ratio)
        ratio = torch.where(ratio > _SQRT2_2_F32, _SQRT2_2_F32, ratio)
        st = stored[..., None]
        quant = 1 + torch.where(torch.isnan(st), False,
                                bounds >= st).sum(dim=-1)
        has_energy = (e_r > 0) | (e_l > 0)
        quant = torch.where(has_energy, quant, 0)
        ratio = torch.where(has_energy, ratio, 1.0)
        new_l = torch.where(sel, (l + r) * ratio[..., None], l)
        new_r = torch.where(sel, 0.0, r)
        spectra[..., p, :, :] = new_l
        spectra[..., s, :, :] = new_r
        intensity[..., s, :] = quant.to(torch.uint8)
    return spectra, intensity


def find_scale_factor(values: torch.Tensor) -> torch.Tensor:
    """FindScaleFactor (hca.cpp:2611-2623): the count of SCALING_TABLE
    entries <= value, at most 63; i32 of f32 values."""
    table = _table(T.SCALING_TABLE, values.device)
    idx = torch.searchsorted(table, values.to(f32).contiguous(), right=True)
    return torch.clamp(idx, max=63).to(i32)


def calc_resolution(sf, noise):
    """CalculateResolution (hca.cpp:2752-2761) on i32/i64 tensors."""
    curve = torch.clamp(noise - (5 * sf) // 2 + 2, 0, 58)
    res = _table(T.SCALE_TO_RESOLUTION_CURVE.astype(np.int64),
                 sf.device)[curve.long()]
    return torch.where(sf == 0, 0, res)


def hfr_sums(spectra, scaled, *, hfr_group_count, bands_per_hfr_group,
             hfr_band_count, total_band, channel_types):
    """HFR group |.| sums (hca.cpp:2656-2706) in the exact order: band-major,
    subframe-minor. Returns (ga, gs) f32 [..., C, max(G, 1)]."""
    lead = spectra.shape[:-2]
    C = spectra.shape[-3]
    dev = spectra.device
    G = max(hfr_group_count, 1)
    ga = torch.zeros(lead + (G,), dtype=f32, device=dev)
    gs = torch.zeros(lead + (G,), dtype=f32, device=dev)
    if hfr_group_count == 0:
        return ga, gs
    start = total_band - hfr_band_count     # stereo + base band counts
    capped = min(hfr_band_count, total_band - hfr_band_count)

    def fold(x, cols):
        block = x[..., cols].abs()                    # [..., C, 8, n]
        flat = torch.movedim(block, -1, -2).reshape(lead + (len(cols) * 8,))
        return _scan_band_sum(flat)

    band = start
    band2 = 0
    for g in range(hfr_group_count):
        cols = []
        for _ in range(bands_per_hfr_group):
            if band >= 128:
                break
            cols.append(band)
            band += 1
        if cols:
            ga[..., g] = fold(spectra, cols)
        cols2 = []
        for _ in range(bands_per_hfr_group):
            if band2 >= capped:
                break
            cols2.append(start - band2 - 1)
            band2 += 1
        if cols2:
            gs[..., g] = fold(scaled, cols2)
    for c in range(C):
        if channel_types[c] == T.STEREO_SECONDARY:
            ga[..., c, :] = 0.0
            gs[..., c, :] = 0.0
    return ga, gs


def group_counts(info, hfr_band_count: int):
    """(count, count2) per HFR group: the divisors of the group averages,
    from calc_hfr_scales' band walk (hca_hfr_device._group_counts of the
    JAX package)."""
    G = info.hfr_group_count
    bpg = info.bands_per_hfr_group
    start = info.stereo_band_count + info.base_band_count
    capped = min(hfr_band_count, info.total_band_count - hfr_band_count)
    counts, counts2 = [], []
    band = 0
    band2 = 0
    for _ in range(G):
        n = 0
        for _ in range(bpg):
            if start + band >= 128:
                break
            band += 1
            n += 8
        counts.append(n)
        n2 = 0
        for _ in range(bpg):
            if band2 >= capped:
                break
            band2 += 1
            n2 += 8
        counts2.append(n2)
    return counts, counts2


def hfr_scales(ga, gs, *, counts, counts2, channel_types):
    """HFR scales (hca.cpp:2689-2706) from the group sums f32 [..., C, G']:
    average (an f32 division), normalise in float64, FindScaleFactor.
    The JAX package's `_host_hfr_scales`, on the device. i32 [..., C, G']."""
    scales = torch.zeros(ga.shape, dtype=i32, device=ga.device)
    for g, (n, n2) in enumerate(zip(counts, counts2)):
        if n == 0:
            continue
        avg = ga[..., g] / float(n)
        if n2:
            avg2 = (gs[..., g] / float(n2)).to(torch.float64)
            factor = torch.clamp(
                torch.ones_like(avg2) / torch.clamp(avg2, min=1e-300),
                max=math.sqrt(2.0))
            upd = (avg.to(torch.float64) * factor).to(f32)
            avg = torch.where(avg2 > 0.0, upd, avg)
        scales[..., g] = find_scale_factor(avg)
    for c, t in enumerate(channel_types):
        if t == T.STEREO_SECONDARY:
            scales[..., c, :] = 0
    return scales


def delta_lengths(sf, coded_counts, channel_types, hfr_group_count):
    """CalculateOptimalDeltaLength + frame header length (hca.cpp:2708-2750).
    sf i32 [..., C, 128] -> (delta_bits, header_len) i32 [..., C]."""
    lead = sf.shape[:-2]
    C = sf.shape[-2]
    delta_bits = torch.zeros(lead + (C,), dtype=i32, device=sf.device)
    header_len = torch.zeros(lead + (C,), dtype=i32, device=sf.device)
    for c in range(C):
        cc = int(coded_counts[c])
        s = sf[..., c, :cc]
        empty = (s == 0).all(dim=-1)
        deltas = (s[..., 1:] - s[..., :-1]).abs()
        min_len = torch.full(lead, 3 + 6 * cc, dtype=i32, device=sf.device)
        min_bits = torch.full(lead, 6, dtype=i32, device=sf.device)
        for db in range(1, 6):
            max_delta = (1 << (db - 1)) - 1
            length = 9 + torch.where(deltas > max_delta, db + 6,
                                     db).sum(dim=-1)
            upd = length < min_len
            min_len = torch.where(upd, length, min_len)
            min_bits = torch.where(upd, db, min_bits)
        hlv = torch.where(empty, 3, min_len)
        if channel_types[c] == T.STEREO_SECONDARY:
            hlv = hlv + 32
        elif hfr_group_count > 0:
            hlv = hlv + 6 * hfr_group_count
        delta_bits[..., c] = torch.where(empty, 0, min_bits)
        header_len[..., c] = hlv
    return delta_bits, header_len


def band_cost_table(scaled, coded_mask):
    """Bit cost of each band at every resolution r in 0..15 (the search-time
    half of CalculateUsedBits, hca.cpp:2763-2790): u8 [..., C, 128, 16].

    One pass over the scaled spectra per resolution; each search step then
    only gathers [..., C, 128] costs. Costs are <= 96, so bytes hold them."""
    dev = scaled.device
    a = scaled.abs()
    qsb = _table(T.QUANTIZE_SPECTRUM_BITS.astype(np.int64), dev).reshape(-1)
    costs = [torch.zeros(scaled.shape[:-2] + (128,), dtype=torch.uint8,
                         device=dev)]
    for r in range(1, 16):
        if r >= 8:
            dead = float(T.QUANTIZER_DEAD_ZONE[r])
            extra = (a >= dead).sum(dim=-2)
            cost = 8 * (int(T.QUANTIZED_SPECTRUM_MAX_BITS[r]) - 1) + extra
        else:
            # the f32 arithmetic of CalculateUsedBits: ssi from the f32
            # table, shift_up = ssi + 1 in f32, shift_down truncated in f64
            ssi = float(T.QUANTIZER_INVERSE_STEP_SIZE[r])
            shift_up = float(np.float32(np.float32(ssi) + np.float32(1.0)))
            q = (scaled * ssi + shift_up).to(i32) - int(_SHIFT_DOWN_UB[r])
            cost = qsb[r * 16 + torch.clamp(q, 0, 15).long()].sum(dim=-2)
        costs.append(cost.to(torch.uint8))
    table = torch.stack(costs, dim=-1)                  # [..., C, 128, 16]
    return torch.where(coded_mask[..., None], table, 0).to(torch.uint8)


def used_bits(cost, sf, header_sum, noise_level, eval_boundary):
    """CalculateUsedBits (hca.cpp:2763-2790) from the cost table: i32 [...].

    cost u8 [..., C, 128, 16]; sf i32 [..., C, 128]; header_sum = 48 + the
    channels' header lengths, noise_level and eval_boundary i32 [...]."""
    band = torch.arange(128, device=sf.device)
    nl = noise_level[..., None, None]
    noise = torch.where(band < eval_boundary[..., None, None], nl - 1, nl)
    res = calc_resolution(sf, noise)
    bits = torch.gather(cost, -1, res.long()[..., None])[..., 0]
    return (header_sum + bits.to(i32).sum(dim=(-2, -1))).to(i32)


def search_level(sf, cost, header_len, avail):
    """BinarySearchLevel (hca.cpp:2792-2807) as a fixed trip of 8 halvings
    ([0, 255] collapses in 8); -1 where no level fits. i32 [...]."""
    zeros = torch.zeros(sf.shape[:-2], dtype=i32, device=sf.device)
    header_sum = 48 + header_len.sum(dim=-1)
    low, high, mid_value = zeros, torch.full_like(zeros, 255), zeros
    for _ in range(8):
        active = low != high
        mid = (low + high) // 2
        mv = used_bits(cost, sf, header_sum, mid, zeros)
        mid_value = torch.where(active, mv, mid_value)
        go_up = active & (mv > avail)
        low = torch.where(go_up, mid + 1, low)
        high = torch.where(active & ~go_up, mid, high)
    fail = (low == 255) & (mid_value > avail)
    return torch.where(fail, -1, low)


def search_boundary(sf, cost, header_len, avail, noise_level):
    """BinarySearchBoundary (hca.cpp:2834-2850) as a fixed trip of 7
    halvings (|high - low| goes 127 -> 1 in 7). i32 [...]."""
    header_sum = 48 + header_len.sum(dim=-1)
    low = torch.zeros(sf.shape[:-2], dtype=i32, device=sf.device)
    high = torch.full_like(low, 127)
    for _ in range(7):
        active = (high - low).abs() > 1
        mid = (low + high) // 2
        mv = used_bits(cost, sf, header_sum, noise_level, mid)
        over = active & (avail < mv)
        high = torch.where(over, mid - 1, high)
        low = torch.where(active & ~over, mid, low)
    hi_val = used_bits(cost, sf, header_sum, noise_level, high)
    res_eq = torch.where(low < 127, low, -1)
    res_neq = torch.where(hi_val > avail, low, high)
    return torch.where(low == high, res_eq, res_neq)


def rate_control(sf, cost, delta_bits, header_len, avail, *, top_band,
                 coded_counts, channel_types, hfr_group_count):
    """Noise level and evaluation boundary per frame (hca.cpp:2792-2866).

    Frames whose level search fails run the reference's fallback
    (hca.cpp:2816-2828): zero the scalefactors of two bands at a time, from
    band `top_band` - 1 (base + stereo band count - 1) down, and recompute
    that frame's delta lengths and level until it fits; HcaError when no
    band is left. sf, delta_bits and header_len are updated in place for
    those frames. Returns (level, boundary) i32 [...]."""
    level = search_level(sf, cost, header_len, avail)
    failed = level < 0
    if bool(failed.any()):
        idx = failed.nonzero(as_tuple=True)
        f_sf, f_cost = sf[idx], cost[idx]
        f_db, f_hl, f_level = delta_bits[idx], header_len[idx], level[idx]
        highest = top_band - 1
        while True:
            active = f_level < 0
            if not bool(active.any()):
                break
            highest -= 2
            if highest < 0:
                raise hca_frame.HcaError("Unknown Encoding error.")
            cut = active[:, None, None] & (
                (torch.arange(128, device=sf.device) == highest + 1)
                | (torch.arange(128, device=sf.device) == highest + 2))
            f_sf = torch.where(cut, 0, f_sf)
            db1, hl1 = delta_lengths(f_sf, coded_counts, channel_types,
                                     hfr_group_count)
            f_db = torch.where(active[:, None], db1, f_db)
            f_hl = torch.where(active[:, None], hl1, f_hl)
            f_level = torch.where(active, search_level(f_sf, f_cost, f_hl,
                                                       avail), f_level)
        sf[idx], delta_bits[idx], header_len[idx] = f_sf, f_db, f_hl
        level[idx] = f_level
    boundary = torch.where(
        level > 0,
        search_boundary(sf, cost, header_len, avail, torch.clamp(level, min=0)),
        0)
    return level, boundary


def quantize(sf, scaled, level, boundary, coded_mask):
    """Resolutions (hca.cpp:2868-2876) and QuantizeSpectra (:2878-2892):
    (res i32 [..., C, 128], quant i32 [..., C, 8, 128])."""
    dev = sf.device
    band = torch.arange(128, device=dev)
    lv = level[..., None, None]
    noise = torch.where(band < boundary[..., None, None], lv - 1, lv)
    res = torch.where(coded_mask, calc_resolution(sf, noise), 0)
    res_c = torch.clamp(res, 0, 15).long()
    ssi = _table(T.QUANTIZER_INVERSE_STEP_SIZE, dev)[res_c]
    shift_up = ssi + 1.0
    shift_down = _table(_SHIFT_DOWN_Q, dev)[res_c]
    quant = ((scaled * ssi[..., None, :] + shift_up[..., None, :]).to(i32)
             - shift_down[..., None, :])
    quant = torch.where(coded_mask[:, None, :], quant, 0)
    return res, quant


def hca_encode_transform(pcm, *, base_band, total_band, pairs, coded_counts,
                         channel_types, hfr_group_count, bands_per_hfr_group,
                         hfr_band_count, frame_size, avail=None):
    """PCM16 [B, C, F*1024] -> per-frame encode tensors (sf u8, res u8,
    intensity u8, quant i16, level i32, boundary i32, delta_bits i32,
    ga f32, gs f32), as the JAX package's hca_encode_transform, except that
    frames whose level search fails take the top-band-zeroing fallback here
    (`rate_control`) instead of carrying level -1. `avail` is the bit budget
    per frame, frame_size * 8 unless given (a smaller one drives the
    fallback)."""
    B, C, total = pcm.shape
    F = total // 1024
    dev = pcm.device
    coded = np.zeros((C, 128), dtype=bool)
    for c in range(C):
        coded[c, :coded_counts[c]] = True
    coded_mask = torch.from_numpy(coded).to(dev)

    spectra = hca_mdct(pcm)                              # [B, C, T, 128]
    spectra = torch.movedim(spectra.reshape(B, C, F, 8, 128), 1,
                            2).contiguous()              # [B, F, C, 8, 128]
    spectra, intensity = encode_intensity(spectra, base_band, total_band,
                                          pairs)

    sf = find_scale_factor(spectra.abs().amax(dim=-2))   # [B, F, C, 128]
    sf = torch.where(coded_mask, sf, 0)
    qs = _table(T.QUANTIZER_SCALING_TABLE, dev)[sf.long()]
    ans = spectra * qs[..., None, :]
    ans = torch.where(ans > _LIM, _LIM, ans)
    ans = torch.where(ans < -_LIM, -_LIM, ans)
    scaled = torch.where((sf == 0)[..., None, :], 0.0, ans)
    scaled = torch.where(coded_mask[:, None, :], scaled, 0.0)
    del ans

    ga, gs = hfr_sums(spectra, scaled, hfr_group_count=hfr_group_count,
                      bands_per_hfr_group=bands_per_hfr_group,
                      hfr_band_count=hfr_band_count, total_band=total_band,
                      channel_types=channel_types)
    del spectra
    delta_bits, header_len = delta_lengths(sf, coded_counts, channel_types,
                                           hfr_group_count)
    cost = band_cost_table(scaled, coded_mask)
    level, boundary = rate_control(
        sf, cost, delta_bits, header_len,
        frame_size * 8 if avail is None else avail,
        top_band=total_band - hfr_band_count, coded_counts=coded_counts,
        channel_types=channel_types, hfr_group_count=hfr_group_count)
    del cost
    res, quant = quantize(sf, scaled, level, boundary, coded_mask)
    return (sf.to(torch.uint8), res.to(torch.uint8), intensity,
            quant.to(torch.int16), level, boundary, delta_bits, ga, gs)


def hca_encode_frames(pcm, *, base_band, total_band, pairs, coded_counts,
                      channel_types, hfr_group_count, bands_per_hfr_group,
                      hfr_band_count, frame_size, hfr_counts, hfr_counts2,
                      avail=None):
    """PCM16 [B, C, F*1024] -> frame bytes u8 [B, F, frame_size]: the
    transform, the float64 HFR scales and the frame packer, all on the
    device of `pcm`; `avail` as in hca_encode_transform."""
    sf, res, intensity, quant, level, boundary, delta_bits, ga, gs = \
        hca_encode_transform(
            pcm, base_band=base_band, total_band=total_band, pairs=pairs,
            coded_counts=coded_counts, channel_types=channel_types,
            hfr_group_count=hfr_group_count,
            bands_per_hfr_group=bands_per_hfr_group,
            hfr_band_count=hfr_band_count, frame_size=frame_size,
            avail=avail)
    scales = hfr_scales(ga, gs, counts=hfr_counts, counts2=hfr_counts2,
                        channel_types=channel_types)
    return hca_pack_device.pack_frames(
        level, boundary, sf, res, intensity, scales, delta_bits, quant,
        channels=pcm.shape[1], coded_counts=coded_counts,
        channel_types=channel_types, hfr_group_count=hfr_group_count,
        frame_size=frame_size)


def encode_config(info, cfg: H.EncConfig) -> dict:
    """Keyword arguments of hca_encode_frames for a stream configuration."""
    C = info.channels
    pairs = tuple((c, c + 1) for c in range(C - 1)
                  if info.channel_type[c] == T.STEREO_PRIMARY) \
        if info.stereo_band_count > 0 else ()
    counts, counts2 = group_counts(info, int(cfg.hfr_band_count))
    return dict(
        base_band=int(info.base_band_count),
        total_band=int(info.total_band_count),
        pairs=pairs,
        coded_counts=tuple(int(x) for x in info.coded_count),
        channel_types=tuple(int(x) for x in info.channel_type),
        hfr_group_count=int(info.hfr_group_count),
        bands_per_hfr_group=int(info.bands_per_hfr_group),
        hfr_band_count=int(cfg.hfr_band_count),
        frame_size=int(info.frame_size),
        hfr_counts=tuple(counts), hfr_counts2=tuple(counts2))


def stack_timelines(cfgs, wavs) -> np.ndarray:
    """The streams' PCM timelines as i16 [B, C, Fmax * 1024], zero padded
    to the longest stream."""
    C = cfgs[0].info.channels
    fmax = max(cfg.info.frame_count for cfg in cfgs)
    pcm = np.zeros((len(cfgs), C, fmax * 1024), dtype=np.int16)
    for b, (w, cfg) in enumerate(zip(wavs, cfgs)):
        tl = H.build_timeline(cfg, w)
        pcm[b, :, :tl.shape[1]] = tl
    return pcm


def assemble(cfgs, frames: np.ndarray) -> List[bytes]:
    """Per stream: header bytes + its frames of u8 [B, Fmax, frame_size]."""
    return [H.pack_header(cfg.info)
            + frames[b, :cfg.info.frame_count].tobytes()
            for b, cfg in enumerate(cfgs)]


def encode_batch_device(wav_blobs: Sequence, quality: int = 1,
                        force_not_looping: bool = False, *,
                        device="cuda", devices=None) -> List[bytes]:
    """Encode WAV blobs that share (channels, sample_rate) to HCA v2.0
    bytes on `device`, or over `devices` (a mesh's dp axis): the JAX
    package's encode_batch_device, byte for byte, and its ValueError for
    mixed formats. Its `mesh` and `pack` are not carried: `devices` takes
    the mesh's place (keyword-only), and the frames are packed on the
    device. hca_encode_batch calls `encode_wavs` with the WAVs it parsed."""
    wavs = [wavmod.parse_wav(bytes(b)) for b in wav_blobs]
    return encode_wavs(wavs, quality, force_not_looping, device=device,
                       devices=devices)


def encode_wavs(wavs: Sequence, quality: int = 1,
                force_not_looping: bool = False, *, device="cuda",
                devices=None) -> List[bytes]:
    """encode_batch_device of parsed WAVs (utils.wav.WavFile): the streams
    shard over `devices` in order, one equal shard a device, silent
    streams padding the last ones (as the JAX function pads its stream
    axis to the mesh), and every shard's kernels are enqueued before the
    first fetch. Streams of different lengths are frame-padded; only the
    packed frames come back from the device."""
    from ..parallel.mesh import shard_rows

    devices = [as_device(device)] if devices is None else list(devices)
    cfgs = [H.init_encode(w, quality, w.looping and not force_not_looping)
            for w in wavs]
    info0 = cfgs[0].info
    if any((c.info.channels, c.info.sample_rate)
           != (info0.channels, info0.sample_rate) for c in cfgs[1:]):
        raise ValueError("encode_batch_device requires uniform channel "
                         "count and sample rate")
    kw = encode_config(info0, cfgs[0])
    pcm = stack_timelines(cfgs, wavs)
    frames = [hca_encode_frames(torch.from_numpy(p).to(d), **kw)
              for d, p in zip(devices, shard_rows(pcm, len(devices)))]
    host = [f.cpu().numpy() for f in frames]
    return assemble(cfgs, host[0] if len(host) == 1 else np.concatenate(host))
