"""MPEG Layer II encode of a batch of streams on one device (AHX encode).

Computes, byte for byte, what the JAX package's f64 host lane computes
(pycricodecs_tpu/models/ahx.py::encode_mp2 with device=False, the lane
AHX.encode and ahx_encode_batch run by default), for a group of streams of
one configuration (ops/mp2_encode_host.EncodeConfig):

1. analysis: PCM16 -> subband samples S f64 [B, C, F*36, 32], with the
   part peaks max |S| over each 12-row part, f64 [B, F, C, 3, 32], and the
   frame peaks max |S| over each 36-row frame, f64 [B, F, C, 32] (kernel
   K1 `mp2_analysis`; twins mp2_kernels.analyze_plain, `part_peaks_plain`,
   `frame_peaks_plain`; a fixed summation order, see analyze_plain; a max
   is exact in any order);
2. on the host, with numpy: need_db = 20 log10(max(frame peak, 1e-9)).
   The reference takes numpy's log10; CUDA's float64 log10 differs from it
   in the last bit on 5.8 % of values (PERF.md §6), and such a bit can
   flip an allocation tie, so this one transcendental is numpy's on every
   device;
3. scalefactors (from the part peaks), scfsi, the joint-stereo mid signal,
   the greedy allocation and the quantisation (kernel K2 `mp2_allocate`,
   one pass; twin `allocate_plain`);
4. the frames (kernel K3 `mp2_pack`, twin `pack_plain`): every byte of
   each frame at its CBR offset, no CRC;
5. on the host: each stream cut to its own frame count.

The JAX package's device encoder (ops/mp2_encode_device.py there) is not
the reference: it ranks by an f32 proxy and quantises by an f32
reciprocal, so its bytes differ from the host lane. This module replaces it
in function. A stream shorter than its group's longest is padded at its
tail with silence and cut back to its own ceil(N / 1152) frames: exact, as
the analysis reads only past samples and every frame is allocated alone.

Outputs of K2 (all 32 subbands; alloc and codes are 0 past sblimit): alloc
u8 [B, F, C, 32] as transmitted (joint subbands carry channel 0's index in
channel 1), scfsi u8 [B, F, C, 32], sfidx u8 [B, F, C, 3, 32], codes u16
[B, F, C, 36, 32].
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from . import cuda_kernels
from . import mp2_kernels
from . import mp2_tables as T
from .mp2_encode_host import MAX_CLASSES, EncodeConfig

ROWS = 36                 # subband rows a frame
#: scalefactor bits a (channel, subband) by scfsi
SF_BITS = (18, 12, 6, 12)
#: scalefactors transmitted by scfsi
N_SF = (3, 2, 1, 2)


def device_tables(cfg: EncodeConfig, device) -> tuple:
    """The class tables K2 reads: (itab i32 [32 * 16 + 32 * 17 + 32]:
    levels, bits and ncls; snr f64 [32 * 16]) on `device`."""
    itab = np.concatenate([cfg.levels_tbl.reshape(-1),
                           cfg.bits_tbl.reshape(-1), cfg.ncls])
    return (torch.from_numpy(itab.astype(np.int32)).to(device),
            torch.from_numpy(cfg.snr_tbl.reshape(-1).copy()).to(device))


# -- K1's peaks ---------------------------------------------------------------

def part_peaks_plain(S: torch.Tensor) -> torch.Tensor:
    """Twin of K1's part peaks: S f64 [B, C, F*36, 32] -> max |S| over each
    12-row part, f64 [B, F, C, 3, 32] (models/ahx.py:170's peaks)."""
    B, C, Tn, _ = S.shape
    F = Tn // ROWS
    return S.abs().view(B, C, F, 3, 12, 32).amax(4).permute(0, 2, 1, 3, 4) \
        .contiguous()


def frame_peaks_plain(S: torch.Tensor) -> torch.Tensor:
    """Twin of K1's frame peaks: S f64 [B, C, F*36, 32] -> max |S| over each
    frame's rows, f64 [B, F, C, 32]."""
    B, C, Tn, _ = S.shape
    F = Tn // ROWS
    return S.abs().view(B, C, F, ROWS, 32).amax(3).permute(0, 2, 1, 3) \
        .contiguous()


def analysis(pcm: torch.Tensor) -> tuple:
    """PCM16 i16 [B, C, F*1152] -> (S, part peaks, frame peaks): kernel K1
    on a CUDA tensor, its twins on a CPU tensor."""
    if pcm.device.type == "cpu":
        S = mp2_kernels.analyze_plain(pcm)
        return S, part_peaks_plain(S), frame_peaks_plain(S)
    return cuda_kernels.mp2_analysis(pcm)


def need_db_host(peaks: torch.Tensor) -> torch.Tensor:
    """20 log10(max(peak, 1e-9)) with numpy on the host, back on the peaks'
    device (the reference's arithmetic: models/ahx.py:192)."""
    p = peaks.cpu().numpy()
    return torch.from_numpy(20.0 * np.log10(np.maximum(p, 1e-9))).to(
        peaks.device)


# -- K2: allocation and quantisation -----------------------------------------

def _sf_indices(peak: torch.Tensor, sf63: torch.Tensor) -> torch.Tensor:
    """Tightest scalefactor index with sf >= peak - 1e-12 (int64)."""
    cnt = (sf63 >= (peak - 1e-12)[..., None]).sum(-1)
    return cnt.clamp(min=1) - 1


def allocate_plain(S: torch.Tensor, part_peaks: torch.Tensor,
                   need_db: torch.Tensor, budgets: torch.Tensor,
                   cfg: EncodeConfig):
    """Twin of K2: S f64 [B, C, F*36, 32], its part peaks f64
    [B, F, C, 3, 32], need_db f64 [B, F, C, 32], budgets i32 [F] ->
    (alloc u8 [B, F, C, 32], scfsi u8 [B, F, C, 32], sfidx u8
    [B, F, C, 3, 32], codes u16 [B, F, C, 36, 32]), models/ahx.py:170-283's
    arithmetic, every frame advanced in lockstep."""
    B, C, Tn, _ = S.shape
    F = Tn // ROWS
    N = B * F
    dev = S.device
    SB, bound, joint = cfg.sblimit, cfg.bound, cfg.joint
    sf_t = torch.from_numpy(T.scalefactors()).to(dev)
    Sf = S.view(B, C, F, ROWS, 32).permute(0, 2, 1, 3, 4).reshape(
        N, C, ROWS, 32)
    sfidx = _sf_indices(part_peaks.reshape(N, C, 3, 32), sf_t[:63])
    sf_val = sf_t[sfidx]
    if joint:
        Sj = (Sf[:, 0] + Sf[:, 1]) * 0.5                      # [N, 36, 32]
        peaks_j = Sj.abs().view(N, 3, 12, 32).amax(2)
        sf_val_j = sf_t[_sf_indices(peaks_j, sf_t[:63])]      # [N, 3, 32]
    eq01 = sfidx[:, :, 0] == sfidx[:, :, 1]
    eq12 = sfidx[:, :, 1] == sfidx[:, :, 2]
    scfsi = torch.zeros((N, C, 32), dtype=torch.int64, device=dev)
    scfsi[eq01 & eq12] = 2
    scfsi[eq01 & ~eq12] = 1
    scfsi[~eq01 & eq12] = 3
    sf_bits = torch.tensor(SF_BITS, device=dev)[scfsi]       # [N, C, 32]

    def tb(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    bits_tbl = tb(cfg.bits_tbl[:SB].astype(np.int64))        # [SB, 17]
    snr_tbl = tb(cfg.snr_tbl[:SB])                           # [SB, 16]
    ncls = tb(cfg.ncls[:SB].astype(np.int64))
    sb_ix = torch.arange(SB, device=dev)
    first_cost = 2 + sf_bits[:, :, :SB]                      # [N, C, SB]
    need = need_db.reshape(N, C, 32)[:, :, :SB].clone()
    eligible = torch.ones((C, SB), dtype=torch.bool, device=dev)
    if joint:
        first_cost[:, 0, bound:] = (4 + sf_bits[:, 0, bound:SB]
                                    + sf_bits[:, 1, bound:SB])
        need[:, 0, bound:] = torch.maximum(need[:, 0, bound:],
                                           need[:, 1, bound:])
        eligible[1, bound:] = False
    budget = budgets.to(dev).long().repeat(B)[:, None, None]  # [N, 1, 1]
    alloc = torch.zeros((N, C, SB), dtype=torch.int64, device=dev)
    spent = torch.zeros((N, 1, 1), dtype=torch.int64, device=dev)
    rows = torch.arange(N, device=dev)
    while N:
        cost = (bits_tbl[sb_ix, alloc + 1] - bits_tbl[sb_ix, alloc]
                + torch.where(alloc == 0, first_cost, 0))
        gain = need - snr_tbl[sb_ix, torch.minimum(alloc, ncls - 1)]
        ok = ((alloc + 1 < ncls) & (gain > -60.0) & eligible
              & (spent + cost <= budget))
        flat = torch.where(ok, gain, -torch.inf).reshape(N, C * SB)
        best = flat.argmax(1)                                # first maximum
        active = torch.isfinite(flat[rows, best])
        if not bool(active.any()):
            break
        fsel, bsel = rows[active], best[active]
        spent.view(N)[fsel] += cost.reshape(N, C * SB)[fsel, bsel]
        alloc.view(N, C * SB)[fsel, bsel] += 1

    # quantise: codes = clip(floor(((s / sf) * n + n - 1) / 2 + .5), 0, n - 1),
    # the / 2 as K2's * 0.5 (the same correctly rounded value)
    levels_tbl = tb(cfg.levels_tbl[:SB].astype(np.int64))
    nf = levels_tbl[sb_ix, alloc].double()[:, :, None, :]    # [N, C, 1, SB]
    S_q = Sf[..., :SB].clone()
    sf_src = sf_val[..., :SB].clone()                        # [N, C, 3, SB]
    if joint:
        S_q[:, 0, :, bound:] = Sj[:, :, bound:SB]
        sf_src[:, 0, :, bound:] = sf_val_j[:, :, bound:SB]
    sfq = sf_src[:, :, torch.arange(ROWS, device=dev) // 12, :]
    q = torch.floor(((S_q / sfq) * nf + nf - 1) * 0.5 + 0.5)
    q = torch.minimum(torch.maximum(q, torch.zeros_like(q)), nf - 1)
    codes = torch.zeros((N, C, ROWS, 32), dtype=torch.int32, device=dev)
    codes[..., :SB] = torch.where(nf > 0, q, 0.0).to(torch.int32)
    alloc_tx = torch.zeros((N, C, 32), dtype=torch.uint8, device=dev)
    alloc_tx[..., :SB] = alloc.to(torch.uint8)
    if joint:
        alloc_tx[:, 1, bound:SB] = alloc_tx[:, 0, bound:SB]
    return (alloc_tx.view(B, F, C, 32), scfsi.to(torch.uint8).view(B, F, C, 32),
            sfidx.to(torch.uint8).view(B, F, C, 3, 32),
            codes.to(torch.uint16).view(B, F, C, ROWS, 32))


def allocate(S, part_peaks, need_db, budgets, cfg: EncodeConfig):
    """K2 on CUDA tensors, its twin on CPU tensors."""
    if S.device.type == "cpu":
        return allocate_plain(S, part_peaks, need_db, budgets, cfg)
    return cuda_kernels.mp2_allocate(
        S, part_peaks, need_db, budgets, *device_tables(cfg, S.device),
        sblimit=cfg.sblimit, bound=cfg.bound, joint=cfg.joint)


# -- K3: the frame packer ------------------------------------------------------

def frame_offsets(frame_sizes: np.ndarray) -> np.ndarray:
    """Byte offset of each frame in its stream, and the total: i64 [F + 1]."""
    return np.concatenate([[0], np.cumsum(frame_sizes)]).astype(np.int64)


def class_bits(cfg: EncodeConfig) -> tuple:
    """(group bits, code bits) i64 [32, 16] of each (subband, allocation
    index): a grouped class's one field, an ungrouped class's three."""
    gbits = np.zeros((32, MAX_CLASSES), np.int64)
    ubits = np.zeros((32, MAX_CLASSES), np.int64)
    for (sb, i), n in np.ndenumerate(cfg.levels_tbl):
        if n:
            gbits[sb, i] = T.GROUP_BITS.get(int(n), 0)
            ubits[sb, i] = 0 if gbits[sb, i] else T.code_bits(int(n))
    return gbits, ubits


def pack_tables(cfg: EncodeConfig, device) -> torch.Tensor:
    """The tables K3 reads: ctab i32 [3 * 32 * 16 + 32] (levels, group
    bits and code bits by (subband, allocation index), nbal) on `device`."""
    gbits, ubits = class_bits(cfg)
    ctab = np.concatenate([cfg.levels_tbl.reshape(-1), gbits.reshape(-1),
                           ubits.reshape(-1), cfg.nbal])
    return torch.from_numpy(ctab.astype(np.int32)).to(device)


def _excl(x: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum over the last axis (the kernel's warp scan over
    lanes = subbands)."""
    return torch.cumsum(x, -1) - x


def pack_plain(alloc, scfsi, sfidx, codes, cfg: EncodeConfig,
               pads: torch.Tensor, frame_sizes: np.ndarray) -> torch.Tensor:
    """Twin of K3: K2's outputs [B, F, ...] and the frame plan -> the
    streams' bytes u8 [B, sum(frame_sizes)], each frame at its offset,
    in mp2_frame.pack_frame's field order (the bytes of the JAX package's
    pack_frames). The fields are disjoint, so a byte is the sum of the
    fields' parts in it."""
    B, F, C = alloc.shape[:3]
    dev = alloc.device
    N = B * F
    SB, bound = cfg.sblimit, cfg.bound
    offs = frame_offsets(frame_sizes)
    total = int(offs[-1])
    fs_bits = torch.from_numpy(np.asarray(frame_sizes, np.int64) * 8).to(
        dev).repeat(B)                                            # [N]
    start = (torch.arange(B, device=dev)[:, None] * total
             + torch.from_numpy(offs[:-1]).to(dev)[None, :]).reshape(N) * 8
    lane = torch.arange(32, device=dev)
    live = lane < SB
    nch = torch.where(lane < bound, C, 1) * live                 # [32]
    nbal = torch.from_numpy(cfg.nbal.astype(np.int64)).to(dev)
    a = alloc.reshape(N, C, 32).long()
    s = scfsi.reshape(N, C, 32).long()
    sfv = sfidx.reshape(N, C, 3, 32).long()
    out = torch.zeros(B * total + 8, dtype=torch.int64, device=dev)
    k5 = torch.arange(5, device=dev)

    def add(pos, width, value, ok):
        """Place fields [N, ...] at bit pos of their frame: those that fit
        it (a longer one is dropped, as pack_frame's BitWriter drops it),
        each as its parts in the 5 bytes from its first."""
        pos, width, value, ok = torch.broadcast_tensors(
            *(torch.as_tensor(t, device=dev) for t in (pos, width, value, ok)))
        lead = (N,) + (1,) * (pos.dim() - 1)
        ok = ok & (pos + width <= fs_bits.view(lead))
        bit = (start.view(lead) + pos)[ok]
        width = width[ok]
        v40 = (value[ok] & ((1 << width) - 1)) << (40 - (bit & 7) - width)
        out.index_add_(0, ((bit >> 3)[:, None] + k5).reshape(-1),
                       ((v40[:, None] >> (32 - 8 * k5)) & 0xFF).reshape(-1))

    # header: the frame's padding bit
    add(torch.zeros(N, dtype=torch.int64, device=dev), 32,
        cfg.header_base | (pads.to(dev).long().repeat(B) << 9), True)
    # allocation: nbal bits a (sb, ch < nch[sb])
    aoff = 32 + _excl(nbal * nch)                                 # [32]
    ch = torch.arange(C, device=dev)[:, None]                     # [C, 1]
    add((aoff + ch * nbal)[None], nbal, a, (ch < nch)[None])
    pos = 32 + int((nbal * nch).sum())
    # scfsi: 2 bits a (sb, ch < C) with alloc > 0
    act = (a > 0) & live                                          # [N, C, 32]
    w = 2 * act                                                   # [N, C, 32]
    lane_off = _excl(w.sum(1))[:, None, :] + torch.cumsum(w, 1) - w
    add(pos + lane_off, 2, s, act)
    pos = pos + w.sum((1, 2))[:, None, None]                      # [N, 1, 1]
    # scalefactors: 1-3 six-bit fields a (sb, ch) by scfsi
    nsf = torch.tensor(N_SF, device=dev)[s] * act                 # [N, C, 32]
    w = 6 * nsf
    base = pos + _excl(w.sum(1))[:, None, :] + torch.cumsum(w, 1) - w
    second = torch.where(s == 1, sfv[:, :, 2], sfv[:, :, 1])
    add(base, 6, sfv[:, :, 0], act)
    add(base + 6, 6, second, act & (nsf >= 2))
    add(base + 12, 6, sfv[:, :, 2], act & (nsf == 3))
    pos = pos + w.sum((1, 2))[:, None, None]
    # samples: 12 granules, each (sb, ch < nch[sb]) one grouped field or
    # three code_bits fields
    gbits, ubits = class_bits(cfg)
    on = (ch < nch)[None]                                         # [1, C, 32]
    n = torch.from_numpy(cfg.levels_tbl.astype(np.int64)).to(dev)[lane, a] \
        * on                                                      # [N, C, 32]
    gb = torch.from_numpy(gbits).to(dev)[lane, a] * on
    ub = torch.from_numpy(ubits).to(dev)[lane, a] * on
    w = torch.where(gb > 0, gb, 3 * ub)                           # [N, C, 32]
    slot = _excl(w.sum(1))[:, None, :] + torch.cumsum(w, 1) - w
    gran = w.sum((1, 2))[:, None, None, None]                     # [N,1,1,1]
    gr = torch.arange(12, device=dev)[None, None, :, None]
    off = pos[..., None] + gr * gran + slot[:, :, None, :]        # [N,C,12,32]
    cd = codes.reshape(N, C, 12, 3, 32).long()
    v0, v1, v2 = cd[:, :, :, 0], cd[:, :, :, 1], cd[:, :, :, 2]
    n4, gb4, ub4 = n[:, :, None], gb[:, :, None], ub[:, :, None]
    add(off, gb4, v0 + n4 * (v1 + n4 * v2), gb4 > 0)
    unq = (n4 > 0) & (gb4 == 0)
    for k, v in enumerate((v0, v1, v2)):
        add(off + k * ub4, ub4, v, unq)

    return out[:B * total].to(torch.uint8).view(B, total)


def pack(alloc, scfsi, sfidx, codes, cfg: EncodeConfig, pads: np.ndarray,
         frame_sizes: np.ndarray) -> torch.Tensor:
    """K3 on CUDA tensors, its twin on CPU tensors."""
    dev = alloc.device
    pads_t = torch.from_numpy(np.ascontiguousarray(pads, np.int32)).to(dev)
    if dev.type == "cpu":
        return pack_plain(alloc, scfsi, sfidx, codes, cfg, pads_t,
                          frame_sizes)
    offs = frame_offsets(frame_sizes)
    return cuda_kernels.mp2_pack(
        alloc, scfsi, sfidx, codes, pads_t, torch.from_numpy(offs).to(dev),
        pack_tables(cfg, dev), sblimit=cfg.sblimit, bound=cfg.bound,
        header_base=cfg.header_base, total=int(offs[-1]),
        max_frame=int(np.max(frame_sizes)))


# -- the encode ----------------------------------------------------------------

def encode_from_spectra(S: torch.Tensor, cfg: EncodeConfig,
                        frames: Optional[Sequence[int]] = None,
                        peaks: Optional[tuple] = None) -> List[bytes]:
    """Stages 2-5 on given spectra S f64 [B, C, F*36, 32] (on their
    device) and their (part, frame) peaks as K1 gives them: one Layer II
    stream per row, cut to `frames[b]` frames (default all F). Without
    peaks, spectra on the CPU get them from the twins; spectra on the card
    take them from K1 (`encode_streams`), never from a plain reduction."""
    B, C, Tn, _ = S.shape
    F = Tn // ROWS
    if B * F == 0:
        return [b""] * B
    if peaks is None:
        if S.device.type != "cpu":
            raise ValueError("encode_from_spectra: spectra on the card need "
                             "their peaks from kernel K1 (mp2_analysis)")
        peaks = (part_peaks_plain(S), frame_peaks_plain(S))
    data = _allocate_and_pack(S, cfg, peaks).cpu().numpy()
    return _cut(data, cfg, F, frames)


def _allocate_and_pack(S: torch.Tensor, cfg: EncodeConfig,
                       peaks: tuple) -> torch.Tensor:
    """Stages 2-4 on S and its (part, frame) peaks: the streams' bytes u8
    [B, total] on S's device (the need_db round trip to the host
    synchronises S's device)."""
    pads, frame_sizes, budgets = cfg.frame_plan(S.shape[2] // ROWS)
    part, frame = peaks
    need = need_db_host(frame)
    out = allocate(S, part, need, torch.from_numpy(budgets).to(S.device), cfg)
    return pack(*out, cfg, pads, frame_sizes)


def _cut(data: np.ndarray, cfg: EncodeConfig, F: int,
         frames: Optional[Sequence[int]]) -> List[bytes]:
    """Stage 5: rows of stream bytes u8 [>= B, total] of F frames each ->
    stream b cut to frames[b] frames (default F), for each b."""
    offs = frame_offsets(cfg.frame_plan(F)[1])
    frames = [F] * data.shape[0] if frames is None else list(frames)
    return [data[b, :offs[f]].tobytes() for b, f in enumerate(frames)]


def encode_streams(pcm: torch.Tensor, cfg: EncodeConfig,
                   frames: Optional[Sequence[int]] = None) -> List[bytes]:
    """PCM16 i16 [B, C, F*1152] (each stream's tail zero-padded, on the
    device the work runs on) -> one Layer II stream per row, cut to
    `frames[b]` frames (default all F)."""
    return encode_streams_sharded([pcm], cfg, frames)


def encode_streams_sharded(shards: Sequence[torch.Tensor], cfg: EncodeConfig,
                           frames: Optional[Sequence[int]] = None
                           ) -> List[bytes]:
    """encode_streams over stream shards: PCM16 i16 [Bs, C, F*1152] on
    each shard's own device, the shards' rows in stream order -> one
    Layer II stream per entry of frames (rows past them are padding,
    dropped; default: every row, all F frames). Every shard's K1 is
    enqueued before the first need_db fetch, and every shard's K2 and K3
    before the first fetch of frames."""
    B, F = sum(p.shape[0] for p in shards), shards[0].shape[2] // (ROWS * 32)
    if B * F == 0:
        return [b""] * (B if frames is None else len(frames))
    spectra = [analysis(pcm) for pcm in shards]
    data = [_allocate_and_pack(S, cfg, (part, frame))
            for S, part, frame in spectra]
    data = [d.cpu().numpy() for d in data]
    return _cut(data[0] if len(data) == 1 else np.concatenate(data), cfg, F,
                frames)
