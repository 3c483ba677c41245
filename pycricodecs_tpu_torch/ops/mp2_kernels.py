"""MPEG Layer II synthesis (codes -> PCM16) and analysis (PCM16 -> subband
samples), each in a fixed f64 order.

Computes exactly what the JAX package's host lane computes
(mp2_kernels.decode_pcm16_host, which runs the native V-FIFO synthesis
cri_mp2_synthesize, pycricodecs_tpu/native/cricore.cpp:3026-3139), in
float64, one rounded operation at a time:

- dequantise: s = ((2c + 1 - n) / n) * sf, 0 where n == 0, with the
  scalefactor row (sample row) // 12;
- matrixing per 32-sample row t: V[t][q] = s[0] * nt[0][q], then
  V[t][q] += s[k] * nt[k][q] for k = 1..31 in order (nt = N.T);
- window: o[j] = D[j] * V[t][j], + D[32 + j] * V[t-1][32 + j], then for
  m = 1..7: + D[64m + j] * V[t-2m][j], + D[64m + 32 + j] * V[t-2m-1][32 + j];
  V before the stream start is 0;
- PCM: floor(o * 32768 + 0.5), clamped to int16.

The JAX package's device program instead runs two f32 matmuls (within
1 LSB of this lane); a matmul fixes no summation order, so the port has its
own kernel `mp2_synth` (csrc/mp2_synth.cu, wrapper cuda_kernels.mp2_synth)
and `synthesize_plain` is its twin: the same elementwise f64 operations in
the same order, vectorised over time, with no matmul or reduction.
"""
from __future__ import annotations

import numpy as np
import torch

from . import cuda_kernels
from . import mp2_tables as T

HALO = 15            # rows of V before a row that its window reads


def _tables(device):
    """(sf [64], nt [32, 64], dwin [512]) float64 on `device`."""
    return (torch.from_numpy(T.scalefactors()).to(device),
            torch.from_numpy(np.ascontiguousarray(
                T.synthesis_matrixing().T)).to(device),
            torch.from_numpy(T.synth_window()).to(device))


def synthesize_plain(codes: torch.Tensor, levels: torch.Tensor,
                     sfidx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of mp2_synth: codes u16 [B, F, C, 36, 32], levels
    i32 [B, F, C, 32], sfidx u8 [B, F, C, 3, 32] -> PCM i16 [B, C, F*1152]
    (channel-major per stream)."""
    B, F, C = codes.shape[:3]
    sf_t, nt, dwin = _tables(codes.device)
    n = levels.double()[:, :, :, None, :]                   # [B,F,C,1,32]
    part = torch.arange(36, device=codes.device) // 12
    sf = sf_t[sfidx.long()][:, :, :, part, :]               # [B,F,C,36,32]
    c = codes.to(torch.int32).double()
    s = torch.where(n > 0, ((2.0 * c + 1.0 - n) / n) * sf, 0.0)
    s = s.permute(0, 2, 1, 3, 4).reshape(B, C, F * 36, 32)  # rows in time
    # matrixing: left fold over k of single multiplies and adds
    v = s[..., 0:1] * nt[0]
    for k in range(1, 32):
        v = v + s[..., k:k + 1] * nt[k]                     # [B, C, T, 64]
    Tn = F * 36
    v = torch.nn.functional.pad(v, (0, 0, HALO, 0))          # V[t] at t + 15
    even = lambda m: v[..., 15 - 2 * m:15 - 2 * m + Tn, :32]       # noqa: E731
    odd = lambda m: v[..., 14 - 2 * m:14 - 2 * m + Tn, 32:]        # noqa: E731
    o = dwin[0:32] * even(0)
    o = o + dwin[32:64] * odd(0)
    for m in range(1, 8):
        o = o + dwin[64 * m:64 * m + 32] * even(m)
        o = o + dwin[64 * m + 32:64 * m + 64] * odd(m)
    y = torch.floor(o * 32768.0 + 0.5).clamp(-32768.0, 32767.0)
    return y.to(torch.int16).reshape(B, C, Tn * 32)


def analyze_plain(pcm: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of mp2_analysis's spectra: PCM i16 [B, C, N], N a
    multiple of 32 -> subband samples f64 [B, C, N / 32, 32] (the kernel
    takes whole frames, N a multiple of 1152; the peaks' twins are in
    mp2_encode_device)."""
    B, C, N = pcm.shape
    Tn = N // 32
    dev = pcm.device
    win = torch.from_numpy(T.analysis_window()).to(dev)
    M = torch.from_numpy(T.analysis_matrix()).to(dev)
    x = pcm.double() / 32768.0
    xp = torch.nn.functional.pad(x, (512, 0))
    x32r = xp.reshape(B, C, Tn + 16, 32).flip(-1)            # block-reversed
    Y = torch.zeros((B, C, Tn, 64), dtype=torch.float64, device=dev)
    for h in range(2):
        for r in range(8):
            w = win[32 * h + 64 * r:32 * h + 64 * r + 32]
            s0 = 16 - h - 2 * r                # +16: one extra zero block
            Y[..., 32 * h:32 * h + 32] = (Y[..., 32 * h:32 * h + 32]
                                          + w * x32r[..., s0:s0 + Tn, :])
    S = Y[..., 0:1] * M[:, 0]
    for q in range(1, 64):
        S = S + Y[..., q:q + 1] * M[:, q]                    # [B, C, T, 32]
    return S


def mp2_decode_pcm(codes: torch.Tensor, levels: torch.Tensor,
                   sfidx: torch.Tensor) -> torch.Tensor:
    """The synthesis of a batch: mp2_synth on CUDA tensors, its twin on CPU
    tensors (same arguments and result as synthesize_plain)."""
    if codes.device.type == "cpu":
        return synthesize_plain(codes, levels, sfidx)
    return cuda_kernels.mp2_synth(codes, levels, sfidx)
