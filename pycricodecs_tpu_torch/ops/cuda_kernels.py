"""ctypes bindings of the port's hand-written CUDA kernels.

Wrappers and launch counters here: B3 `hca_transform` (csrc/hca_transform.cu,
replaces pallas_kernels.transform_fused_pallas), B7 `adx_decode` and B8
`adx_encode` (csrc/adx_codec.cu, replace adx_kernels.adx_decode_serial_pallas
and adx_encode_serial_pallas), B6 `hca_mdct` (csrc/hca_encode.cu, replaces
pallas_kernels.mdct_enc_pallas), the frame packer `hca_pack`
(csrc/hca_pack.cu, carries hca_pack_device._scatter_segments_pallas, B9),
B10 `mp2_unpack` (csrc/mp2_unpack.cu, replaces mp2_unpack_device.
Mp2DeviceUnpacker._unpack) and the Layer II synthesis `mp2_synth`
(csrc/mp2_synth.cu, the fixed-order f64 lane; no Pallas kernel), B4
`hca_imdct_ola` and B5 `hca_imdct` (csrc/hca_imdct.cu, replace
pallas_kernels.imdct_ola_pallas and imdct_pallas), and the Layer II
encoder's K1 `mp2_analysis` (csrc/mp2_analysis.cu; the spectra and their
part and frame peaks), K2 `mp2_allocate` and K3 `mp2_pack`
(csrc/mp2_encode.cu), which replace the JAX package's numpy host lane of
the encode (no Pallas kernel), and CRILAYLA's C1 `crilayla_decompress` and
C2 `crilayla_compress` (csrc/crilayla.cu), which replace the JAX package's
native host lane (cricore.cpp cri_layla_decompress and cri_layla_compress;
no Pallas kernel).
The unpack kernels B1/B2 are wrapped in
hca_unpack_device.py with the helpers below. A wrapper checks its inputs,
allocates the outputs, launches on the current stream of its input's
device with that device current (`launch`), raises if the launch failed and
counts the launch.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from ..models.adx import STATIC_COEFFICIENTS, samples_per_block
from ..utils import tracing

#: launches since import (or the last reset), per kernel
TRANSFORM_LAUNCHES = 0
ADX_DECODE_LAUNCHES = 0
ADX_DECODE_HOST_LAUNCHES = 0
ADX_ENCODE_LAUNCHES = 0
MDCT_LAUNCHES = 0
PACK_LAUNCHES = 0
MP2_UNPACK_LAUNCHES = 0
MP2_SYNTH_LAUNCHES = 0
IMDCT_OLA_LAUNCHES = 0
IMDCT_LAUNCHES = 0
MP2_ANALYSIS_LAUNCHES = 0
MP2_ALLOCATE_LAUNCHES = 0
MP2_PACK_LAUNCHES = 0
CRILAYLA_DECOMPRESS_LAUNCHES = 0
CRILAYLA_COMPRESS_LAUNCHES = 0


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    """Device pointer of a tensor."""
    return ctypes.c_void_p(t.data_ptr())


def host_ptr(a: np.ndarray) -> ctypes.c_void_p:
    """Host pointer of a contiguous numpy array (kept alive by the caller)."""
    return ctypes.c_void_p(a.ctypes.data)


def launch(kernel: str, t: torch.Tensor, *args) -> None:
    """Call the built library's launcher `kernel` with args and the current
    stream of t's device, with t's device current on this host thread: the
    launchers read their device's attributes (SM count, shared-memory
    limits, occupancy) through cudaGetDevice, and a shard on a second card
    may be enqueued from a thread whose current device is another. Raises
    if the launch failed.

    The guard is the one `torch.cuda.device` makes (exchange the current
    device, exchange it back) without the context manager's Python layers:
    PyTorch's private API, checked on torch 2.11.0+cu128."""
    fn = getattr(_build.load(), kernel)
    prev = torch._C._cuda_exchangeDevice(t.get_device())
    try:
        rc = fn(*args, stream_ptr(t))
    finally:
        torch._C._cuda_maybeExchangeDevice(prev)
    if rc:
        raise launch_failed(kernel, rc)


def stream_ptr(t: torch.Tensor) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on the tensor's device, as a raw
    handle (the call torch.cuda.current_stream(...).cuda_stream makes,
    without building a Stream object, a few microseconds of host time a
    launch). It is PyTorch's private API, checked on torch 2.11.0+cu128."""
    return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(t.get_device()))


def check_cuda(t: torch.Tensor, name: str, dtype: torch.dtype,
               shape: tuple) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of this dtype/shape."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def check_aligned(t: torch.Tensor, name: str, align: int = 16) -> None:
    """Raise unless the tensor's data starts on an `align`-byte boundary
    (the kernels read it as vectors of that many bytes)."""
    if t.data_ptr() % align:
        raise ValueError(f"{name}: data is not {align}-byte aligned")


def launch_failed(kernel: str, rc: int) -> RuntimeError:
    return RuntimeError(f"{kernel}: CUDA launch failed with error {rc}")


def hca_transform(qc, sf, res, inten, hfr_map, *, base_band, total_band,
                  stereo_pairs, apply_hfr, hfr_group_count,
                  noise=None) -> torch.Tensor:
    """Kernel B3: qc i16 [B, F, C, 8, 128], sf/res u8 [B, F, C, 128],
    inten u8 [B, F, C, 8], optional PNS maps noise = (src u8, sci u8,
    mask bool) [B, F, C, 8, 128] (CUDA) -> PCM i16 [B, F, 8, 128, C]."""
    global TRANSFORM_LAUNCHES
    B, F, C = qc.shape[0], qc.shape[1], qc.shape[2]
    check_cuda(qc, "qc", torch.int16, (B, F, C, 8, 128))
    check_cuda(sf, "sf", torch.uint8, (B, F, C, 128))
    check_cuda(res, "res", torch.uint8, (B, F, C, 128))
    check_cuda(inten, "inten", torch.uint8, (B, F, C, 8))
    noise_ptrs = [None, None, None]
    if noise is not None:
        for name, t, dt in zip(("noise_src", "noise_sci", "noise_mask"),
                               noise, (torch.uint8, torch.uint8, torch.bool)):
            check_cuda(t, name, dt, (B, F, C, 8, 128))
        noise_ptrs = [ptr(t) for t in noise]
    out = torch.empty((B, F, 8, 128, C), dtype=torch.int16, device=qc.device)
    if B * F == 0:
        return out
    partner = np.full(C, -1, dtype=np.int32)
    for (p, s) in stereo_pairs:
        partner[p] = s
    hfr_is = np.ascontiguousarray(hfr_map.band_is_hfr, dtype=np.int32)
    hfr_src = np.ascontiguousarray(hfr_map.src_band, dtype=np.int32)
    hfr_group = np.ascontiguousarray(hfr_map.group_of, dtype=np.int32)
    launch("hca_transform", qc,
           ptr(qc), ptr(sf), ptr(res), ptr(inten), *noise_ptrs, B, F, C,
           int(base_band), int(total_band), int(bool(apply_hfr)),
           int(hfr_group_count), int(hfr_map.zero_band) if apply_hfr else -1,
           host_ptr(partner), host_ptr(hfr_is), host_ptr(hfr_src),
           host_ptr(hfr_group), ptr(out))
    TRANSFORM_LAUNCHES += 1
    return out


def _check_adx(L, nb, block_size, bit_depth, encoding_mode, lanes) -> int:
    """Raise unless the geometry is one the ADX kernels take; return spb."""
    if not 2 <= bit_depth <= 15:
        raise ValueError(f"bit_depth {bit_depth} not in 2..15")
    if not 3 <= block_size <= 255:
        raise ValueError(f"block_size {block_size} not in 3..255")
    if encoding_mode not in (2, 3, 4):
        raise ValueError(f"encoding_mode {encoding_mode} not in (2, 3, 4)")
    spb = samples_per_block(block_size, bit_depth)
    if spb < 1:
        raise ValueError(f"block_size {block_size} holds no "
                         f"{bit_depth}-bit code")
    for name, t in lanes.items():
        check_cuda(t, name, torch.int32, (L,))
    return spb


def adx_decode(payload, h1, h2, c0, c1, *, bit_depth, encoding_mode,
               wrap: bool = True) -> torch.Tensor:
    """Kernel B7: raw ADX blocks u8 [L, nb, block_size], history h1/h2 and
    mode 3/4 coefficients c0/c1 i32 [L] (CUDA) -> PCM i16 [L, nb, spb].
    wrap=True launches its XLA-wrap instance (counted in
    ADX_DECODE_LAUNCHES), wrap=False its host-arithmetic instance (counted
    in ADX_DECODE_HOST_LAUNCHES); see adx_kernels.adx_decode_plain."""
    global ADX_DECODE_LAUNCHES, ADX_DECODE_HOST_LAUNCHES
    L, nb, bs = payload.shape
    check_cuda(payload, "payload", torch.uint8, (L, nb, bs))
    spb = _check_adx(L, nb, bs, bit_depth, encoding_mode,
                     dict(h1=h1, h2=h2, c0=c0, c1=c1))
    out = torch.empty((L, nb, spb), dtype=torch.int16, device=payload.device)
    if L * nb == 0:
        return out
    static = np.ascontiguousarray(STATIC_COEFFICIENTS, dtype=np.int32)
    launch("adx_decode", payload,
           ptr(payload), ptr(h1), ptr(h2), ptr(c0), ptr(c1), L, nb, bs,
           int(bit_depth), int(encoding_mode), int(bool(wrap)),
           host_ptr(static), ptr(out))
    if wrap:
        ADX_DECODE_LAUNCHES += 1
    else:
        ADX_DECODE_HOST_LAUNCHES += 1
    return out


def adx_encode(pcm, c0, c1, h1, h2, *, block_size, bit_depth, encoding_mode,
               filter_, scale_fix) -> torch.Tensor:
    """Kernel B8: PCM i16 [L, nb, spb], coefficients c0/c1 and history h1/h2
    i32 [L] (CUDA) -> raw ADX blocks u8 [L, nb, block_size]."""
    global ADX_ENCODE_LAUNCHES
    L, nb, spb = pcm.shape
    want = _check_adx(L, nb, block_size, bit_depth, encoding_mode,
                      dict(c0=c0, c1=c1, h1=h1, h2=h2))
    check_cuda(pcm, "pcm", torch.int16, (L, nb, want))
    if filter_ not in (0, 1, 2, 3):
        raise ValueError(f"filter_ {filter_} not in 0..3")
    out = torch.empty((L, nb, block_size), dtype=torch.uint8,
                      device=pcm.device)
    if L * nb == 0:
        return out
    launch("adx_encode", pcm,
           ptr(pcm), ptr(c0), ptr(c1), ptr(h1), ptr(h2),
           ptr(_divisor_table(pcm.device)), L, nb, int(block_size),
           int(bit_depth), int(encoding_mode), int(filter_),
           int(bool(scale_fix)), ptr(out))
    ADX_ENCODE_LAUNCHES += 1
    return out


#: device -> B8's division table on it (adx_kernels.divisor_table)
_DIVISOR_TABLES: dict = {}


def _divisor_table(device: torch.device) -> torch.Tensor:
    """B8's exact-division table as an int32 CUDA tensor, built once per
    device."""
    if device not in _DIVISOR_TABLES:
        from .adx_kernels import divisor_table
        _DIVISOR_TABLES[device] = torch.from_numpy(divisor_table()).to(device)
    return _DIVISOR_TABLES[device]


def _adx_plan(entry: str, L: int, nb: int, block_size: int,
              bit_depth: int) -> tuple:
    plan = (ctypes.c_int * 3)()
    rc = getattr(_build.load(), entry)(int(L), int(nb), int(block_size),
                                       int(bit_depth), plan)
    if rc:
        raise launch_failed(entry, rc)
    return tuple(plan)


def adx_decode_plan(L: int, nb: int, *, block_size: int,
                    bit_depth: int) -> tuple:
    """Kernel B7's launch geometry for such a call on the current CUDA
    device: (lanes per CTA, blocks per chunk, dynamic shared bytes)."""
    return _adx_plan("adx_decode_plan", L, nb, block_size, bit_depth)


def adx_encode_plan(L: int, nb: int, *, block_size: int,
                    bit_depth: int) -> tuple:
    """Kernel B8's launch geometry for such a call on the current CUDA
    device: (lanes per CTA, blocks per chunk, dynamic shared bytes)."""
    return _adx_plan("adx_encode_plan", L, nb, block_size, bit_depth)


def hca_mdct(pcm) -> torch.Tensor:
    """Kernel B6: PCM16 i16 [B, C, T*128] (CUDA) -> spectra f32
    [B, C, T, 128]."""
    global MDCT_LAUNCHES
    B, C, total = pcm.shape
    if total % 128:
        raise ValueError(f"pcm: length {total} is not a multiple of 128")
    Tn = total // 128
    check_aligned(pcm, "pcm")
    check_cuda(pcm, "pcm", torch.int16, (B, C, total))
    out = torch.empty((B, C, Tn, 128), dtype=torch.float32,
                      device=pcm.device)
    if B * C * Tn == 0:
        return out
    launch("hca_mdct", pcm, ptr(pcm), B * C * Tn, Tn, ptr(out))
    MDCT_LAUNCHES += 1
    return out


def mp2_unpack(frames, channels: int):
    """Kernel B10: Layer II frames u8 [N, fs_max] (CUDA), each zero-padded
    -> (codes u16 [N, C, 36, 32], levels i32 [N, C, 32], sfidx u8
    [N, C, 3, 32], err bool [N]). The kernel writes every output byte."""
    global MP2_UNPACK_LAUNCHES
    N, W = frames.shape
    C = int(channels)
    check_aligned(frames, "frames")
    check_cuda(frames, "frames", torch.uint8, (N, W))
    if C not in (1, 2):
        raise ValueError(f"channels {C} not in (1, 2)")
    dev = frames.device
    if N * W == 0:   # no frame, or frames without a header: zeros, err set
        return (torch.zeros((N, C, 36, 32), dtype=torch.uint16, device=dev),
                torch.zeros((N, C, 32), dtype=torch.int32, device=dev),
                torch.zeros((N, C, 3, 32), dtype=torch.uint8, device=dev),
                torch.ones((N,), dtype=torch.bool, device=dev))
    # one allocation for the four outputs (each part starts on a 16-byte
    # boundary: 2,304, 128 and 96 bytes a frame and channel)
    buf = torch.empty(N * (C * (2304 + 128 + 96) + 1), dtype=torch.uint8,
                      device=dev)
    parts = torch.split(buf, [N * C * 2304, N * C * 128, N * C * 96, N])
    codes = parts[0].view(torch.uint16).view(N, C, 36, 32)
    levels = parts[1].view(torch.int32).view(N, C, 32)
    sfidx = parts[2].view(N, C, 3, 32)
    err = parts[3].view(torch.bool)
    launch("mp2_unpack", frames, ptr(frames), N, W, C, ptr(codes),
           ptr(levels), ptr(sfidx), ptr(err))
    MP2_UNPACK_LAUNCHES += 1
    return codes, levels, sfidx, err


def mp2_synth(codes, levels, sfidx) -> torch.Tensor:
    """The Layer II synthesis kernel: codes u16 [B, F, C, 36, 32], levels
    i32 [B, F, C, 32], sfidx u8 [B, F, C, 3, 32] (CUDA) -> PCM i16
    [B, C, F * 1152]."""
    global MP2_SYNTH_LAUNCHES
    B, F, C = codes.shape[:3]
    # the kernel reads codes as 32-bit pairs, levels as int2 and sfidx as
    # 16-bit pairs: 8-byte alignment covers all three
    for name, t in (("codes", codes), ("levels", levels), ("sfidx", sfidx)):
        check_aligned(t, name, 8)
    check_cuda(codes, "codes", torch.uint16, (B, F, C, 36, 32))
    check_cuda(levels, "levels", torch.int32, (B, F, C, 32))
    check_cuda(sfidx, "sfidx", torch.uint8, (B, F, C, 3, 32))
    out = torch.empty((B, C, F * 1152), dtype=torch.int16,
                      device=codes.device)
    if B * F * C == 0:
        return out
    launch("mp2_synth", codes, ptr(codes), ptr(levels), ptr(sfidx), B, F,
           C, ptr(out))
    MP2_SYNTH_LAUNCHES += 1
    return out


def hca_pack(level, boundary, sf, res, intensity, hfr_scales, delta_bits,
             quant, *, channels, coded_counts, channel_types,
             hfr_group_count, frame_size) -> torch.Tensor:
    """HCA frame packer (B9's placement inside): level/boundary i32 [B, F],
    sf/res u8 [B, F, C, 128], intensity u8 [B, F, C, 8], hfr_scales i32
    [B, F, C, G'], delta_bits i32 [B, F, C], quant i16 [B, F, C, 8, 128]
    (CUDA) -> frame bytes u8 [B, F, frame_size]."""
    global PACK_LAUNCHES
    B, F = level.shape
    C = int(channels)
    Gp = hfr_scales.shape[-1]
    check_cuda(level, "level", torch.int32, (B, F))
    check_cuda(boundary, "boundary", torch.int32, (B, F))
    check_cuda(sf, "sf", torch.uint8, (B, F, C, 128))
    check_cuda(res, "res", torch.uint8, (B, F, C, 128))
    check_cuda(intensity, "intensity", torch.uint8, (B, F, C, 8))
    check_cuda(hfr_scales, "hfr_scales", torch.int32, (B, F, C, Gp))
    check_cuda(delta_bits, "delta_bits", torch.int32, (B, F, C))
    check_cuda(quant, "quant", torch.int16, (B, F, C, 8, 128))
    if not 0 <= hfr_group_count <= Gp:
        raise ValueError(f"hfr_group_count {hfr_group_count} not in "
                         f"0..{Gp}")
    out = torch.empty((B, F, frame_size), dtype=torch.uint8,
                      device=level.device)
    if B * F == 0:
        return out
    coded = np.ascontiguousarray(coded_counts, dtype=np.int32)
    ctype = np.ascontiguousarray(channel_types, dtype=np.int32)
    if coded.shape != (C,) or ctype.shape != (C,):
        raise ValueError("coded_counts/channel_types: one per channel")
    # the kernel reads these as u32 / 8-byte vectors
    sf, res, intensity, quant = (t if t.data_ptr() % 16 == 0 else t.clone()
                                 for t in (sf, res, intensity, quant))
    # frame sizes under 8 have no mask table: the launch refuses them
    masks = (ptr(_crc_masks(int(frame_size), level.device))
             if frame_size >= 8 else None)
    launch("hca_pack", level,
           ptr(level), ptr(boundary), ptr(sf), ptr(res), ptr(intensity),
           ptr(hfr_scales), ptr(delta_bits), ptr(quant), masks, B * F, C, Gp,
           int(hfr_group_count), int(frame_size), host_ptr(coded),
           host_ptr(ctype), ptr(out))
    PACK_LAUNCHES += 1
    return out


#: (frame size, device) -> the packer's CRC masks on it
_CRC_MASKS: dict = {}


def _crc_masks(fs: int, device: torch.device) -> torch.Tensor:
    """`hca_pack`'s CRC16 masks for frame size fs, transposed to i32
    [16, ceil(fs / 4)] on the device, built once per (fs, device)."""
    key = (fs, device)
    if key not in _CRC_MASKS:
        from .hca_pack_device import crc_mask_table
        m = np.ascontiguousarray(crc_mask_table(fs).T).view(np.int32)
        _CRC_MASKS[key] = torch.from_numpy(m).to(device)
    return _CRC_MASKS[key]


def hca_imdct_ola(spec_t) -> torch.Tensor:
    """Kernel B4: spectra f32 [R, T, 128] (CUDA), T subframes in time order
    per row -> wave f32 [R, T, 128]: DCT-IV and windowed overlap-add, a
    zero carry into each row's first subframe."""
    global IMDCT_OLA_LAUNCHES
    if spec_t.dim() != 3:
        raise ValueError(f"spec_t: expected [R, T, 128], got "
                         f"{tuple(spec_t.shape)}")
    R, Tn = spec_t.shape[0], spec_t.shape[1]
    check_cuda(spec_t, "spec_t", torch.float32, (R, Tn, 128))
    check_aligned(spec_t, "spec_t")
    out = torch.empty((R, Tn, 128), dtype=torch.float32,
                      device=spec_t.device)
    if R * Tn == 0:
        return out
    launch("hca_imdct_ola", spec_t, ptr(spec_t), R, Tn, ptr(out))
    IMDCT_OLA_LAUNCHES += 1
    return out


def hca_imdct(spec) -> torch.Tensor:
    """Kernel B5: DCT-IV of every 128-value row, f32 [..., 128] (CUDA) ->
    f32 of the same shape."""
    global IMDCT_LAUNCHES
    if spec.dim() < 1 or spec.shape[-1] != 128:
        raise ValueError(f"spec: expected [..., 128], got "
                         f"{tuple(spec.shape)}")
    check_cuda(spec, "spec", torch.float32, tuple(spec.shape))
    check_aligned(spec, "spec")
    out = torch.empty_like(spec)
    rows = spec.numel() // 128
    if rows == 0:
        return out
    launch("hca_imdct", spec, ptr(spec), rows, ptr(out))
    IMDCT_LAUNCHES += 1
    return out


def mp2_analysis(pcm):
    """Kernel K1: PCM i16 [B, C, F * 1152] (CUDA) -> (subband samples S f64
    [B, C, F * 36, 32], part peaks max |S| over each 12-row part f64
    [B, F, C, 3, 32], frame peaks max |S| over each 36-row frame f64
    [B, F, C, 32])."""
    global MP2_ANALYSIS_LAUNCHES
    if pcm.dim() != 3 or pcm.shape[-1] % 1152:
        raise ValueError(f"pcm: expected [B, C, F * 1152] (whole frames), "
                         f"got {tuple(pcm.shape)}")
    B, C, N = pcm.shape
    check_aligned(pcm, "pcm")
    check_cuda(pcm, "pcm", torch.int16, (B, C, N))
    F = N // 1152
    dev = pcm.device
    S = torch.empty((B, C, F * 36, 32), dtype=torch.float64, device=dev)
    part = torch.empty((B, F, C, 3, 32), dtype=torch.float64, device=dev)
    frame = torch.empty((B, F, C, 32), dtype=torch.float64, device=dev)
    if B * C * F == 0:
        return S, part, frame
    launch("mp2_analysis", pcm, ptr(pcm), B, C, F * 36, ptr(S),
           ptr(part), ptr(frame))
    MP2_ANALYSIS_LAUNCHES += 1
    return S, part, frame


def mp2_allocate(S, part_peaks, need_db, budgets, itab, snr, *,
                 sblimit: int, bound: int, joint: bool):
    """Kernel K2: S f64 [B, C, F * 36, 32] (16-byte aligned: streamed with
    16-byte copies), its part peaks f64 [B, F, C, 3, 32], need_db f64
    [B, F, C, 32], budgets i32 [F], the class tables itab i32 [1088]
    (levels [32, 16], bits [32, 17], ncls [32]) and snr f64 [512] (CUDA)
    -> (alloc u8 [B, F, C, 32], scfsi u8 [B, F, C, 32], sfidx u8
    [B, F, C, 3, 32], codes u16 [B, F, C, 36, 32]); every byte written."""
    global MP2_ALLOCATE_LAUNCHES
    if S.dim() != 4 or S.shape[2] % 36 or S.shape[3] != 32:
        raise ValueError(f"S: expected [B, C, F * 36, 32], got "
                         f"{tuple(S.shape)}")
    B, C, T = S.shape[:3]
    F = T // 36
    check_aligned(S, "S")
    check_cuda(S, "S", torch.float64, (B, C, T, 32))
    if C not in (1, 2):
        raise ValueError(f"channels {C} not in (1, 2)")
    check_cuda(part_peaks, "part_peaks", torch.float64, (B, F, C, 3, 32))
    check_cuda(need_db, "need_db", torch.float64, (B, F, C, 32))
    check_cuda(budgets, "budgets", torch.int32, (F,))
    check_cuda(itab, "itab", torch.int32, (32 * 16 + 32 * 17 + 32,))
    check_cuda(snr, "snr", torch.float64, (32 * 16,))
    if not 1 <= bound <= sblimit <= 32:
        raise ValueError(f"bound {bound} / sblimit {sblimit} out of range")
    if joint and C != 2:
        raise ValueError("joint stereo needs two channels")
    dev = S.device
    alloc = torch.empty((B, F, C, 32), dtype=torch.uint8, device=dev)
    scfsi = torch.empty((B, F, C, 32), dtype=torch.uint8, device=dev)
    sfidx = torch.empty((B, F, C, 3, 32), dtype=torch.uint8, device=dev)
    codes = torch.empty((B, F, C, 36, 32), dtype=torch.uint16, device=dev)
    if B * F == 0:
        return alloc, scfsi, sfidx, codes
    launch("mp2_allocate", S,
           ptr(S), ptr(part_peaks), B, F, C, int(sblimit), int(bound),
           int(bool(joint)), ptr(need_db), ptr(budgets), ptr(itab), ptr(snr),
           ptr(alloc), ptr(scfsi), ptr(sfidx), ptr(codes))
    MP2_ALLOCATE_LAUNCHES += 1
    return alloc, scfsi, sfidx, codes


def mp2_pack(alloc, scfsi, sfidx, codes, pads, offs, ctab, *, sblimit: int,
             bound: int, header_base: int, total: int,
             max_frame: int) -> torch.Tensor:
    """Kernel K3: K2's outputs [B, F, ...] (codes, alloc, scfsi and sfidx
    16-byte aligned: staged with 16-byte copies), padding bits i32 [F],
    frame byte offsets i64 [F + 1] and the class tables ctab i32 [1568]
    (levels, group bits, code bits [32, 16], nbal [32]) (CUDA), with
    offs[F] = total and the largest frame size max_frame -> the streams'
    bytes u8 [B, total]; every byte written."""
    global MP2_PACK_LAUNCHES
    B, F, C = alloc.shape[:3]
    for t, name in ((codes, "codes"), (alloc, "alloc"), (scfsi, "scfsi"),
                    (sfidx, "sfidx")):
        check_aligned(t, name)
    check_cuda(codes, "codes", torch.uint16, (B, F, C, 36, 32))
    check_cuda(alloc, "alloc", torch.uint8, (B, F, C, 32))
    check_cuda(scfsi, "scfsi", torch.uint8, (B, F, C, 32))
    check_cuda(sfidx, "sfidx", torch.uint8, (B, F, C, 3, 32))
    check_cuda(pads, "pads", torch.int32, (F,))
    check_cuda(offs, "offs", torch.int64, (F + 1,))
    check_cuda(ctab, "ctab", torch.int32, (3 * 32 * 16 + 32,))
    if C not in (1, 2):
        raise ValueError(f"channels {C} not in (1, 2)")
    if not 1 <= bound <= sblimit <= 32:
        raise ValueError(f"bound {bound} / sblimit {sblimit} out of range")
    if max_frame > 1729:
        raise ValueError(f"max_frame {max_frame} past Layer II's 1,729")
    out = torch.empty((B, total), dtype=torch.uint8, device=alloc.device)
    if B * F == 0:
        return out
    launch("mp2_pack", alloc,
           ptr(alloc), ptr(scfsi), ptr(sfidx), ptr(codes), ptr(pads),
           ptr(offs), B, F, C, int(sblimit), int(bound), int(header_base),
           ptr(ctab), int(total), int(max_frame), ptr(out))
    MP2_PACK_LAUNCHES += 1
    return out


def check_crilayla_meta(src_size: int, meta: np.ndarray, spans,
                        out_size: int) -> None:
    """Raise unless every member's input span [off, off + in) lies in the
    source and its output span [out, out + span) in the output; `spans` =
    (in, out) per member, computed from meta by the caller."""
    ins, outs = spans
    if meta.dtype != np.int64 or meta.ndim != 2:
        raise ValueError("meta: expected an int64 table [M, k]")
    if (meta < 0).any():
        raise ValueError("meta: negative offset or size")
    if (meta[:, 0] + ins > src_size).any():
        raise ValueError("meta: a member reads past the source")
    out_off = meta[:, -1]
    if (out_off + outs > out_size).any():
        raise ValueError("meta: a member writes past the output")


#: C2's tile: positions a search CTA, a tile walk and an emission block
#: take (kTile in csrc/crilayla.cu)
CRILAYLA_TILE = 4096
#: C2's offsets per position: delta in [3, 0x2002] (kWindow)
CRILAYLA_WINDOW = 0x2000
#: C1's chunk: stream bits a tile parse takes (kChunkBits), the tokens that
#: can start in one (kChunkCap), its start bitmap's words, its int64 fields
#: and a member's (kCFields, kMFields)
CRILAYLA_CHUNK_BITS = 16384
CRILAYLA_CHUNK_CAP = CRILAYLA_CHUNK_BITS // 9 + 2
CRILAYLA_CHUNK_FIELDS = 8
CRILAYLA_MEMBER_FIELDS = 3


def _parts(counts: np.ndarray) -> tuple:
    """(each member's first part i64 [M], the table i32 [P, 2] of (member,
    part index)) for members of `counts` parts (C1's chunks, C2's tiles)."""
    counts = np.asarray(counts, np.int64)
    first = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    member = np.repeat(np.arange(len(counts)), counts)
    index = np.arange(int(counts.sum())) - np.repeat(first, counts)
    return first, np.ascontiguousarray(np.stack([member, index], 1),
                                       dtype=np.int32)


def crilayla_chunks(compressed_sizes: np.ndarray) -> tuple:
    """C1's chunks for members of these compressed sizes: (each member's
    first chunk i64 [M], the table i32 [C, 2] of (member, chunk index))."""
    bits = 8 * np.asarray(compressed_sizes, np.int64)
    return _parts((bits + CRILAYLA_CHUNK_BITS - 1) // CRILAYLA_CHUNK_BITS)


def crilayla_decompress(src, meta: np.ndarray, out_size: int):
    """Kernel C1: the members' payloads in one u8 buffer src (CUDA) and a
    host int64 table meta [M, 4] (payload offset, compressed size,
    decompress size, output offset; the output spans ascend) -> (out u8
    [out_size] with member m at out[meta[m, 3]:][:decompress size + 256],
    status i32 [M] (0, or 1 for a malformed stream), steps i64 [M] (tokens
    decoded)). Any u32 decompress size: a token record holds its output
    position counted from the LZ region, in 32 bits. Scratch on the card:
    about 17 bytes an output byte (`rec` 8, `ptrs` 8, `out` 1) and 31 a
    stream byte; `CPK.extract` bounds it by batching
    (`containers.cpk.C1_BUDGET`). Spans (`utils.tracing`): `c1.prepare`
    (checks, tables, allocations), `c1.launch`."""
    global CRILAYLA_DECOMPRESS_LAUNCHES
    with tracing.span("c1.prepare"):
        check_cuda(src, "src", torch.uint8, (src.numel(),))
        M = meta.shape[0]
        check_crilayla_meta(src.numel(), meta, (meta[:, 1] + 256,
                                                meta[:, 2] + 256), out_size)
        if M > 1 and (meta[1:, 3] < meta[:-1, 3] + meta[:-1, 2]
                      + 256).any():
            raise ValueError("meta: the output spans must ascend without "
                             "overlap")
        dev = src.device
        out = torch.empty(out_size, dtype=torch.uint8, device=dev)
        status = torch.empty(M, dtype=torch.int32, device=dev)
        steps = torch.empty(M, dtype=torch.int64, device=dev)
        if M == 0:
            return out, status, steps
        first, chunks = crilayla_chunks(meta[:, 1])
        C = chunks.shape[0]
        meta_t = torch.from_numpy(np.ascontiguousarray(
            np.concatenate([meta, first[:, None]], 1),
            dtype=np.int64)).to(dev)
        chunks_t = torch.from_numpy(chunks).to(dev)

        def alloc(n, dtype=torch.int64):
            return torch.empty(max(n, 1), dtype=dtype, device=dev)

        cap = max(C, 1) * CRILAYLA_CHUNK_CAP
        words = max(C, 1) * (CRILAYLA_CHUNK_BITS // 32)
        srec, send, rrec, rend = (alloc(cap) for _ in range(4))
        bitmap, pre = alloc(words, torch.int32), alloc(words, torch.int32)
        cv = alloc(C * CRILAYLA_CHUNK_FIELDS)
        mv = alloc(M * CRILAYLA_MEMBER_FIELDS)
        rec, ntok = alloc(out_size), alloc(M)
        ptrs = alloc(out_size)
        # pointer jumping: a chain visits each token once, so 2^rounds above
        # the longest output is enough
        rounds = max(1, int(meta[:, 2].max()).bit_length())
        changed = alloc(rounds, torch.int32)
    with tracing.span("c1.launch"):
        launch("crilayla_decompress", src, ptr(src), ptr(meta_t), M,
               ptr(chunks_t), C, ptr(out), ptr(status), ptr(steps),
               ptr(srec), ptr(send), ptr(rrec), ptr(rend), ptr(bitmap),
               ptr(pre), ptr(cv), ptr(mv), ptr(rec), ptr(ntok), ptr(ptrs),
               ptr(changed), int(out_size), rounds)
    CRILAYLA_DECOMPRESS_LAUNCHES += 1
    return out, status, steps


def crilayla_work_cap(length):
    """C2's work buffer for a member of `length` bytes: congruent to it mod
    4 (the stream's padding), with room for 9 bits a byte."""
    return length + ((length // 2 + 0x403) & ~3)


def crilayla_tiles(lengths: np.ndarray) -> tuple:
    """C2's tiles for members of these lengths: (each member's first tile
    i64 [M], the table i32 [G, 2] of (member, tile index)); a member of
    0x100 bytes or fewer has none."""
    lengths = np.asarray(lengths, np.int64)
    return _parts(np.where(lengths > 0x100, (lengths - 0x100 + CRILAYLA_TILE
                                             - 1) // CRILAYLA_TILE, 0))


def crilayla_compress(src, meta: np.ndarray, work_size: int):
    """Kernel C2: the members in one u8 buffer src (CUDA) and a host int64
    table meta [M, 3] (offset, length, work offset) -> (work u8
    [work_size] with member m's stream at work[meta[m, 2] + start[m]:]
    [:crilayla_work_cap(length) - start[m]], start i64 [M], status i32 [M]
    (0; 1 for 0x100 bytes or fewer; 2 over capacity), steps i64 [M]
    (tokens)). Bytes of work outside the streams are undefined. Members
    are below 2^32 bytes (a run's carry is a u32). Scratch on the card:
    about 19.5 bytes a source byte (`best` 8, `run` 8, `flags` 1, the
    zeroed work buffer 1.5, the source 1); callers bound it by batching
    (`models.crilayla.C2_BUDGET`). Spans (`utils.tracing`): `c2.prepare`
    (checks, tables, allocations), `c2.launch`."""
    global CRILAYLA_COMPRESS_LAUNCHES
    with tracing.span("c2.prepare"):
        check_cuda(src, "src", torch.uint8, (src.numel(),))
        M = meta.shape[0]
        check_crilayla_meta(src.numel(), meta,
                            (meta[:, 1], crilayla_work_cap(meta[:, 1])),
                            work_size)
        if M and int(meta[:, 1].max()) >= 1 << 32:
            raise ValueError("meta: C2 takes members below 2^32 bytes")
        dev = src.device
        # zeroed: the codes are ORed in; a 32-bit word past the last byte
        work = torch.zeros(work_size + 4, dtype=torch.uint8,
                           device=dev)[:work_size]
        start = torch.empty(M, dtype=torch.int64, device=dev)
        status = torch.empty(M, dtype=torch.int32, device=dev)
        steps = torch.empty(M, dtype=torch.int64, device=dev)
        if M == 0:
            return work, start, status, steps
        first, tiles = crilayla_tiles(meta[:, 1])
        G = tiles.shape[0]
        meta_t = torch.from_numpy(np.ascontiguousarray(
            np.concatenate([meta, first[:, None]], 1),
            dtype=np.int64)).to(dev)
        tiles_t = torch.from_numpy(tiles).to(dev)
        best = torch.empty(max(src.numel(), 1), dtype=torch.int64,
                           device=dev)
        run = torch.empty(max(G, 1) * CRILAYLA_WINDOW, dtype=torch.int32,
                          device=dev)  # u32 to the kernel
        flags = torch.empty(max(src.numel(), 1), dtype=torch.uint8,
                            device=dev)
        tilev = torch.empty(5 * max(G, 1), dtype=torch.int64, device=dev)
    with tracing.span("c2.launch"):
        launch("crilayla_compress", src, ptr(src), ptr(meta_t), M,
               ptr(tiles_t), G, ptr(work), ptr(start), ptr(status),
               ptr(steps), ptr(best), ptr(run), ptr(flags), ptr(tilev))
    CRILAYLA_COMPRESS_LAUNCHES += 1
    return work, start, status, steps
