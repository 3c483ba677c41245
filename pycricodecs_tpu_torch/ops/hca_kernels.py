"""HCA decode transform: unpacked spectra -> interleaved PCM16.

Counterpart of pycricodecs_tpu/ops/hca_kernels.py (clHCA_DecodeBlock_transform,
hca.cpp:1207-1233): dequantise -> v3 PNS noise add -> HFR reconstruction
(static source-band map) -> intensity stereo -> IMDCT (7 add/sub + 7 twiddle
stages) -> windowed overlap-add -> PCM16.

`hca_decode_transform_batched` launches kernel B3 (csrc/hca_transform.cu,
wrapper in cuda_kernels.py) on CUDA tensors and runs the plain twins below
on CPU tensors. The key search's float-wave decode `hca_decode_wave` runs
`reconstruct_spectra` (plain PyTorch, as the JAX package leaves it to XLA)
and then `imdct_ola`: kernel B4 (csrc/hca_imdct.cu) on CUDA, its twin
`imdct_ola_plain` on the CPU; `imdct` is kernel B5, the DCT-IV alone. The
twins keep the JAX reference's op order: every float value is one rounded
fp32 multiply, add or subtract, as separate PyTorch ops (no addcmul, matmul
or reduction), so the CPU run is byte-equal to the JAX package and the
kernel is byte-equal to the twins.

Shapes: B streams, F frames, C channels, 8 subframes, 128 bands.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from . import cuda_kernels
from . import hca_tables as T


class HfrMap(NamedTuple):
    """Static high-frequency-reconstruction map for one stream config."""
    band_is_hfr: np.ndarray   # bool [128]
    src_band: np.ndarray      # int32 [128] lowband source (identity elsewhere)
    group_of: np.ndarray      # int32 [128]
    zero_band: int            # band zeroed after reconstruction (-1 = none)


def build_hfr_map(total_band_count: int, base_band_count: int,
                  stereo_band_count: int, bands_per_hfr_group: int,
                  hfr_group_count: int, version: int) -> HfrMap:
    """Precompute the highband<-lowband walk (hca.cpp:1638-1683)."""
    is_hfr = np.zeros(128, dtype=bool)
    src = np.arange(128, dtype=np.int32)
    group_of = np.zeros(128, dtype=np.int32)
    zero_band = -1
    if bands_per_hfr_group > 0 and hfr_group_count > 0:
        start_band = stereo_band_count + base_band_count
        highband = start_band
        lowband = start_band - 1
        if version <= 0x0200:
            group_limit = hfr_group_count
        else:
            group_limit = (hfr_group_count if hfr_group_count >= 0
                           else hfr_group_count + 1) >> 1
        for group in range(hfr_group_count):
            lowband_sub = 1 if group < group_limit else 0
            for _ in range(bands_per_hfr_group):
                if highband >= total_band_count or lowband < 0:
                    break
                is_hfr[highband] = True
                src[highband] = lowband
                group_of[highband] = group
                highband += 1
                lowband -= lowband_sub
        zero_band = highband - 1
    return HfrMap(is_hfr, src, group_of, zero_band)


def stereo_pairs_of(channel_type: np.ndarray) -> Tuple[Tuple[int, int], ...]:
    """(primary, secondary) channel index pairs (adjacent by construction)."""
    pairs = []
    for c in range(len(channel_type) - 1):
        if channel_type[c] == T.STEREO_PRIMARY:
            pairs.append((c, c + 1))
    return tuple(pairs)


def transform_config(info):
    """(HfrMap, keyword config) of hca_decode_transform_batched for a
    stream config (`HcaInfo`)."""
    hfr = build_hfr_map(info.total_band_count, info.base_band_count,
                        info.stereo_band_count, info.bands_per_hfr_group,
                        info.hfr_group_count, info.version)
    cfg = dict(base_band=int(info.base_band_count),
               total_band=int(info.total_band_count),
               stereo_pairs=(stereo_pairs_of(info.channel_type)
                             if info.stereo_band_count > 0 else ()),
               apply_hfr=bool(info.bands_per_hfr_group > 0
                              and info.hfr_group_count > 0),
               hfr_group_count=int(info.hfr_group_count))
    return hfr, cfg


def _table(arr, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


# ---------------------------------------------------------------------------
# Plain twins of kernel B3
# ---------------------------------------------------------------------------

def reconstruct_spectra(qc, sf, res, inten, hfr_map, *, base_band,
                        total_band, stereo_pairs, apply_hfr,
                        hfr_group_count, noise=None):
    """Dequantise + PNS noise add + HFR + intensity stereo -> f32
    [B, F, C, 8, 128]. `noise`: None, or the (src, sci, mask) maps
    [B, F, C, 8, 128] of a v3 PNS stream."""
    dev = qc.device
    C = qc.shape[2]
    sf_l = sf.long()
    gain = _table(T.SCALING_TABLE, dev)[sf_l] \
        * _table(T.RANGE_TABLE, dev)[res.long()]              # [B, F, C, 128]
    spectra = gain[..., None, :] * qc.float()               # [B,F,C,8,128]
    if noise is not None:
        # the JAX fused path's additive term (pallas_kernels.py:377-380),
        # added everywhere: +0.0 where the mask is clear
        src, sci, mask = noise
        gathered = torch.gather(spectra, -1, src.long())
        fill = _table(T.SCALE_CONVERSION_TABLE, dev)[sci.long()] * gathered
        spectra = spectra + torch.where(mask, fill, 0.0)

    secondary = torch.zeros((C,), dtype=torch.bool, device=dev)
    for (_p, s) in stereo_pairs:
        secondary[s] = True
    not_sec = ~secondary[:, None, None]                     # [C, 1, 1]
    if apply_hfr:
        src = _table(hfr_map.src_band.astype(np.int64), dev)
        grp = _table(hfr_map.group_of.astype(np.int64), dev)
        # sci = hfr_scale(group) - sf[lowband] + 63, clamped at 0
        g_scale = sf_l[..., 128 - hfr_group_count + grp]
        sci = torch.clamp(g_scale - sf_l[..., src] + 63, min=0)
        fill = _table(T.SCALE_CONVERSION_TABLE, dev)[sci][..., None, :] \
            * spectra[..., src]
        # secondary channels skip HFR (their high bands come from intensity)
        mask = _table(hfr_map.band_is_hfr, dev) & not_sec
        spectra = torch.where(mask, fill, spectra)
        zero = (torch.arange(128, device=dev) == int(hfr_map.zero_band)) \
            & not_sec
        spectra = torch.where(zero, 0.0, spectra)

    if stereo_pairs:
        band = torch.arange(128, device=dev)
        sel = (band >= base_band) & (band < total_band)
        ratio_table = _table(T.INTENSITY_RATIO_TABLE, dev)
        for (p, s) in stereo_pairs:
            ratio_l = ratio_table[inten[..., s, :].long()][..., None]
            ratio_r = 2.0 - ratio_l
            l_spec = spectra[..., p, :, :]
            new_l = torch.where(sel, l_spec * ratio_l, l_spec)
            new_r = torch.where(sel, l_spec * ratio_r, spectra[..., s, :, :])
            spectra[..., p, :, :] = new_l
            spectra[..., s, :, :] = new_r
    return spectra


def imdct_butterflies(spec):
    """DCT-IV via the reference's 7+7 stage network; spec [..., 128] f32."""
    lead = spec.shape[:-1]
    sin_t = _table(T.IMDCT_SIN, spec.device)
    cos_t = _table(T.IMDCT_COS, spec.device)
    x = spec
    # part 1: add/sub tree (hca.cpp:1906-1935)
    count1, count2 = 1, 64
    for _ in range(T.MDCT_BITS):
        g = x.reshape(*lead, count1, count2, 2)
        a = g[..., 0]
        b = g[..., 1]
        x = torch.cat([a + b, a - b], dim=-1).reshape(*lead, 128)
        count1 <<= 1
        count2 >>= 1
    # part 2: twiddle stages (hca.cpp:1937-1972)
    count1, count2 = 64, 1
    for i in range(T.MDCT_BITS):
        sin = sin_t[i].reshape(count1, count2)
        cos = cos_t[i].reshape(count1, count2)
        g = x.reshape(*lead, count1, 2, count2)
        s1 = g[..., 0, :]
        s2 = g[..., 1, :]
        first = s1 * sin - s2 * cos
        second = torch.flip(s1 * cos + s2 * sin, dims=[-1])
        x = torch.cat([first, second], dim=-1).reshape(*lead, 128)
        count1 >>= 1
        count2 <<= 1
    return x


def window_overlap_add(dct):
    """Windowed overlap-add over the time axis; dct [..., T, 128] f32."""
    w = _table(T.IMDCT_WINDOW, dct.device)
    p_first = torch.flip(w[64:], dims=[0]) \
        * torch.flip(dct[..., :64], dims=[-1])
    p_second = torch.flip(w[:64], dims=[0]) * dct[..., :64]
    prev = torch.cat([p_first, p_second], dim=-1)
    zeros = torch.zeros_like(prev[..., :1, :])
    prev = torch.cat([zeros, prev[..., :-1, :]], dim=-2)
    first = w[:64] * dct[..., 64:] + prev[..., :64]
    second = w[64:] * torch.flip(dct[..., 64:], dims=[-1]) - prev[..., 64:]
    return torch.cat([first, second], dim=-1)


def imdct_ola_plain(spec_t):
    """Plain PyTorch twin of kernel B4: f32 [R, T, 128] spectra -> wave."""
    return window_overlap_add(imdct_butterflies(spec_t))


def imdct_ola(spec_t):
    """DCT-IV + windowed overlap-add over each row's T subframes, a zero
    carry into its first: f32 [R, T, 128] -> f32 [R, T, 128]. A CUDA input
    launches kernel B4, a CPU input runs imdct_ola_plain."""
    if spec_t.device.type == "cpu":
        return imdct_ola_plain(spec_t)
    return cuda_kernels.hca_imdct_ola(spec_t)


def imdct(spec):
    """DCT-IV of every 128-value row, f32 [..., 128]. A CUDA input
    launches kernel B5, a CPU input runs imdct_butterflies."""
    if spec.device.type == "cpu":
        return imdct_butterflies(spec)
    return cuda_kernels.hca_imdct(spec)


def quantize_pcm16(wave):
    """f32 wave -> i16: truncate toward zero, saturate (XLA's f32->s32)."""
    scaled = wave * 32768.0
    return torch.clamp(torch.trunc(scaled), -32768.0, 32767.0).to(
        torch.int16)


def decode_transform_plain(qc, sf, res, inten, hfr_map, *, base_band,
                           total_band, stereo_pairs, apply_hfr,
                           hfr_group_count, noise=None):
    """Plain PyTorch twin of kernel B3 (same arguments and result as
    hca_decode_transform_batched)."""
    B, F, C = qc.shape[0], qc.shape[1], qc.shape[2]
    spectra = reconstruct_spectra(
        qc, sf, res, inten, hfr_map, base_band=base_band,
        total_band=total_band, stereo_pairs=stereo_pairs,
        apply_hfr=apply_hfr, hfr_group_count=hfr_group_count, noise=noise)
    dct = imdct_butterflies(spectra)                        # [B,F,C,8,128]
    dct_t = torch.movedim(dct, 2, 1).reshape(B, C, F * 8, 128)
    pcm = quantize_pcm16(window_overlap_add(dct_t))         # [B, C, T, 128]
    return torch.movedim(pcm.reshape(B, C, F, 8, 128), 1, 4).contiguous()


def hca_decode_transform_batched(qc, sf, res, inten, hfr_map, *, base_band,
                                 total_band, stereo_pairs, apply_hfr,
                                 hfr_group_count, noise=None):
    """Spectra -> interleaved PCM16 for a batch of streams.

    qc      : int16 [B, F, C, 8, 128]
    sf, res : uint8 [B, F, C, 128]
    inten   : uint8 [B, F, C, 8]
    hfr_map : HfrMap of the config (build_hfr_map)
    noise   : None, or the PNS maps (src u8, sci u8, mask bool)
              [B, F, C, 8, 128] (DeviceUnpacker.noise_maps) of a v3 stream
              with min_resolution 0
    returns : int16 [B, F, 8, 128, C] (frame-major interleaved samples)

    A CUDA input launches kernel B3; a CPU input runs the plain twins."""
    cfg = dict(base_band=int(base_band), total_band=int(total_band),
               stereo_pairs=tuple(stereo_pairs), apply_hfr=bool(apply_hfr),
               hfr_group_count=int(hfr_group_count), noise=noise)
    if qc.device.type == "cpu":
        return decode_transform_plain(qc, sf, res, inten, hfr_map, **cfg)
    return cuda_kernels.hca_transform(qc, sf, res, inten, hfr_map, **cfg)


def hca_decode_wave(qc, sf, res, inten, hfr_map, *, base_band, total_band,
                    stereo_pairs, apply_hfr, hfr_group_count, noise=None):
    """Float-domain decode, no PCM16 quantisation (the JAX package's
    hca_kernels.hca_decode_wave): the key tester inspects this wave. Inputs
    as hca_decode_transform_batched; returns f32 [B, C, F * 8, 128], each
    stream's frames in time order with a zero carry into its first."""
    B, F, C = qc.shape[0], qc.shape[1], qc.shape[2]
    spectra = reconstruct_spectra(
        qc, sf, res, inten, hfr_map, base_band=int(base_band),
        total_band=int(total_band), stereo_pairs=tuple(stereo_pairs),
        apply_hfr=bool(apply_hfr), hfr_group_count=int(hfr_group_count),
        noise=noise)                                        # [B,F,C,8,128]
    spec_t = torch.movedim(spectra, 2, 1).reshape(B * C, F * 8, 128)
    return imdct_ola(spec_t.contiguous()).view(B, C, F * 8, 128)
