"""ADX block-ADPCM codec on the device: kernels B7 (decode) and B8 (encode)
and their plain PyTorch twins.

Counterpart of pycricodecs_tpu/ops/adx_kernels.py:
- adx_unpack (raw block bytes -> codes, scales, coefficients) and adx_pack
  (codes + scale fields -> raw block bytes) mirror adx_unpack_device and
  adx_pack_device;
- adx_decode_plain is the twin of kernel B7 (csrc/adx_codec.cu
  adx_decode_kernel, replacing adx_decode_serial_pallas): adx_unpack, then
  the clamped AR(2) recurrence
      s_t = clamp16(q_t * scale + ((a0 * s_{t-1}) >> 12)
                    + ((a1 * s_{t-2}) >> 12))
  serial in time and vectorised over lanes (one lane per stream channel);
- adx_encode_plain is the twin of kernel B8 (adx_encode_kernel, replacing
  adx_encode_serial_pallas): per block the residual min/max against the
  original samples, the zero-block early-out, the scale choice and the
  quantisation against the simulated decoder, mirroring adx_encode_scan;
  adx_pack then writes the block bytes, which B8 writes itself;
- divisor_table is B8's alone: the (multiplier, shift) rows with which the
  kernel divides by a per-block divisor exactly as C `/` does. The twins
  divide with torch.div(..., rounding_mode="trunc").

All arithmetic is int32 with the wrap of the device kernels (no int64
promotion): in mode 4, `1 << ((12 - scale) & 31)` can be 1 << 31 and
`q * scale` wraps as XLA's int32 does. Shifts are arithmetic and division
truncates toward zero (C `/`, torch rounding_mode="trunc"). The decode
takes `wrap=False` for the JAX host decoders' arithmetic instead
(native/cricore.cpp cri_adx_decode_blocks, int64): mode 4's scale is 2^k
exactly, 2^31 included, and `q * scale` does not wrap; the product is held
to +-QS_LIMIT, past which the clamp to int16 gives the exact sum's rail (a
prediction is under 2^17 in magnitude), so the recurrence stays int32.

adx_decode_device / adx_encode_device run the kernel on a CUDA tensor and
the twin on a CPU tensor; nothing else picks between them.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.adx import STATIC_COEFFICIENTS, samples_per_block
from . import cuda_kernels

MAX_S16 = 0x7FFF
I32 = torch.int32
#: B7's host arithmetic: the bound on q * scale (csrc/adx_codec.cu kQsLimit)
QS_LIMIT = 1 << 24


def _table(values, device) -> torch.Tensor:
    return torch.tensor(values, dtype=I32, device=device)


def _pow2_table(device, wrap: bool = True) -> torch.Tensor:
    """1 << k for k in 0..31: int32, k = 31 INT32_MIN as XLA wraps; or,
    with wrap=False, int64 and exact."""
    if not wrap:
        return torch.tensor([1 << k for k in range(32)], dtype=torch.int64,
                            device=device)
    return _table([(1 << k) - (1 << 32) * (k == 31) for k in range(32)],
                  device)


def _static_tables(device):
    """(a0, a1) per mode-2 predictor 0..7; predictors 4..7 have no entry in
    STATIC_COEFFICIENTS and get 0, as the JAX device unpack gives."""
    tab = [int(x) for x in STATIC_COEFFICIENTS] + [0] * 8
    return _table(tab[0:16:2], device), _table(tab[1:16:2], device)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def adx_unpack(payload: torch.Tensor, c0: torch.Tensor, c1: torch.Tensor, *,
               bit_depth: int, encoding_mode: int, wrap: bool = True):
    """Raw blocks u8 [L, nb, block_size] -> (q i32 [L, nb, spb], s, a0, a1
    i32 [L, nb]); c0/c1 i32 [L] are the lanes' mode 3/4 coefficients. With
    wrap=False mode 4's s is int64 and exact (2^31 positive).

    Each block is a 2-byte big-endian scale word and `spb` codes of
    `bit_depth` bits, MSB first, sign-extended (adx.cpp:380-414)."""
    L, nb, bs = payload.shape
    dev = payload.device
    spb = samples_per_block(bs, bit_depth)
    p = payload.to(I32)
    scale_raw = (p[..., 0] << 8) | p[..., 1]
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=dev)
    bits = (payload[..., 2:, None] >> shifts) & 1          # [L, nb, db, 8]
    bits = bits.reshape(L, nb, -1)[..., :spb * bit_depth]
    bits = bits.reshape(L, nb, spb, bit_depth)
    q = torch.zeros((L, nb, spb), dtype=I32, device=dev)
    for k in range(bit_depth):
        q = (q << 1) | bits[..., k].to(I32)
    signbit = 1 << (bit_depth - 1)
    q = torch.where((q & signbit) != 0, q - (1 << bit_depth), q)

    if encoding_mode == 4:
        s = _pow2_table(dev, wrap)[((12 - scale_raw) & 31).long()]
        a0 = c0.to(I32)[:, None].expand(L, nb)
        a1 = c1.to(I32)[:, None].expand(L, nb)
    elif encoding_mode == 2:
        predictor = (scale_raw >> 13).long()                # 0..7
        s = (scale_raw & 0x1FFF) + 1
        t0, t1 = _static_tables(dev)
        a0, a1 = t0[predictor], t1[predictor]
    else:
        s = scale_raw + 1
        a0 = c0.to(I32)[:, None].expand(L, nb)
        a1 = c1.to(I32)[:, None].expand(L, nb)
    return q, s, a0, a1


def adx_decode_plain(payload: torch.Tensor, h1: torch.Tensor,
                     h2: torch.Tensor, c0: torch.Tensor, c1: torch.Tensor, *,
                     bit_depth: int, encoding_mode: int,
                     wrap: bool = True) -> torch.Tensor:
    """Plain PyTorch twin of kernel B7: raw blocks u8 [L, nb, block_size],
    history h1/h2 i32 [L], coefficients c0/c1 i32 [L] -> PCM i16
    [L, nb, spb]. Same per-sample op order as adx_decode_scan. wrap=True
    is the XLA device path's int32 arithmetic, wrap=False the JAX host
    decoders' (the module docstring)."""
    q, s, a0, a1 = adx_unpack(payload, c0, c1, bit_depth=bit_depth,
                              encoding_mode=encoding_mode, wrap=wrap)
    L, nb, spb = q.shape
    if wrap:
        qs = q * s[..., None]                   # int32, wraps like XLA
    else:
        qs = (q.long() * s[..., None].long()).clamp(
            -QS_LIMIT, QS_LIMIT).to(I32)
    out = torch.empty((L, nb, spb), dtype=torch.int16, device=q.device)
    p1, p2 = h1.to(I32), h2.to(I32)
    for b in range(nb):
        a0b, a1b, qsb = a0[:, b], a1[:, b], qs[:, b]
        col = []
        for t in range(spb):
            v = qsb[:, t] + ((a0b * p1) >> 12) + ((a1b * p2) >> 12)
            v = v.clamp(-MAX_S16 - 1, MAX_S16)
            p2, p1 = p1, v
            col.append(v)
        if col:
            out[:, b] = torch.stack(col, 1)
    return out


def adx_decode_device(payload: torch.Tensor, h1: torch.Tensor,
                      h2: torch.Tensor, c0: torch.Tensor, c1: torch.Tensor,
                      *, bit_depth: int, encoding_mode: int,
                      wrap: bool = True) -> torch.Tensor:
    """Raw blocks -> PCM i16 [L, nb, spb]: kernel B7 for CUDA tensors, its
    twin for CPU tensors (counterpart of adx_decode_device_pipeline)."""
    fn = cuda_kernels.adx_decode if payload.is_cuda else adx_decode_plain
    return fn(payload, h1, h2, c0, c1, bit_depth=bit_depth,
              encoding_mode=encoding_mode, wrap=wrap)


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------

def _tdiv(a: torch.Tensor, b) -> torch.Tensor:
    """C truncating division."""
    return torch.div(a, b, rounding_mode="trunc")


#: the largest divisor kernel B8 meets: limit + 1 of the scale choice at bit
#: depth 15 (the chain's own divisors stop at 8192, mode 4's 1 << 13)
DIV_MAX = 1 << 14


def _signed_magic(d: int):
    """(multiplier, shift) of signed division by the constant 2 <= d < 2^31
    (Granlund-Montgomery; Hacker's Delight, 2nd ed., figure 10-1): for every
    int32 n, trunc(n / d) = ((mulhi(M, n) + (n if M < 0 else 0)) >> s)
    + (1 if n < 0 else 0), M read as int32."""
    two31 = 1 << 31
    anc = two31 - 1 - two31 % d
    p = 31
    q1, r1 = divmod(two31, anc)
    q2, r2 = divmod(two31, d)
    while True:
        p += 1
        q1, r1 = 2 * q1, 2 * r1
        if r1 >= anc:
            q1, r1 = q1 + 1, r1 - anc
        q2, r2 = 2 * q2, 2 * r2
        if r2 >= d:
            q2, r2 = q2 + 1, r2 - d
        delta = d - r2
        if not (q1 < delta or (q1 == delta and r1 == 0)):
            break
    m = (q2 + 1) & 0xFFFFFFFF
    return m - (1 << 32) * (m >> 31), p - 32


def divisor_table() -> np.ndarray:
    """Kernel B8's exact-division table, int32 [DIV_MAX + 1, 4]: row d holds
    (mul, add, shift, fix) with which the kernel divides any int32 n by d,
    as C `/` does:
        q = mulhi(n, mul) + (n & add)      (32-bit wrap)
        q = q >> shift                     (arithmetic)
        q = q + ((n >>> 31) & fix)         (1 for a negative n)
    d >= 2: the signed magic pair, add = -1 where mul < 0, fix = 1; d = 1:
    mul 0, add -1, shift 0, fix 0 (q = n). Row 0 is unused."""
    tab = np.zeros((DIV_MAX + 1, 4), np.int32)
    tab[1] = (0, -1, 0, 0)
    for d in range(2, DIV_MAX + 1):
        m, s = _signed_magic(d)
        tab[d] = (m, -1 if m < 0 else 0, s, 1)
    return tab


def _scale_from_minmax(minimum, maximum, limit: int, scale_fix: bool):
    """Reference scale choice (adx.cpp:236-238): C truncating division, then
    the reference's assignment to `unsigned short` wraps mod 65536 BEFORE
    the 0x1000 cap (scale_fix caps without the wrap)."""
    scale = torch.maximum(_tdiv(maximum, limit), _tdiv(minimum, -(limit + 1)))
    if not scale_fix:
        scale = scale & 0xFFFF
    return scale.clamp(max=0x1000)


def _ilog2_plus1(scale: torch.Tensor) -> torch.Tensor:
    """floor(log2(scale)) + 1 for 1 <= scale < 2^24, 0 for scale == 0
    (frexp's exponent of the exact f32 value; 32 - clz(scale) in the
    kernel). The encoder's scale is at most 0x1000."""
    return torch.frexp(scale.to(torch.float32)).exponent.to(I32)


def adx_encode_plain(pcm: torch.Tensor, c0: torch.Tensor, c1: torch.Tensor,
                     h1: torch.Tensor, h2: torch.Tensor, *, bit_depth: int,
                     encoding_mode: int, scale_fix: bool = False):
    """Plain PyTorch twin of kernel B8's arithmetic: PCM [L, B, spb] (int16
    or int32 values), c0/c1/h1/h2 i32 [L] -> (codes i32 [L, B, spb],
    scale_raw i32 [L, B], zero bool [L, B]). Mirrors adx_encode_scan, and at
    spb == 1 the public encoder (pass 1 over the block's own residual; a
    zero block carries h2 = the new h1)."""
    pcm = pcm.to(I32)
    L, B, spb = pcm.shape
    dev = pcm.device
    limit = (1 << (bit_depth - 1)) - 1
    c0, c1 = c0.to(I32), c1.to(I32)
    h1, h2 = h1.to(I32), h2.to(I32)
    codes = torch.zeros((L, B, spb), dtype=I32, device=dev)
    scale_raws = torch.zeros((L, B), dtype=I32, device=dev)
    zeros = torch.zeros((L, B), dtype=torch.bool, device=dev)
    for b in range(B):
        block = pcm[:, b]
        # pass 1: residuals against the original-sample prediction
        prev1 = torch.cat([h1[:, None], block[:, :-1]], 1)
        prev2 = torch.cat([h2[:, None], h1[:, None], block[:, :-2]],
                          1)[:, :spb]
        resid = ((block << 12) - c0[:, None] * prev1
                 - c1[:, None] * prev2) >> 12
        minimum = resid.amin(1).clamp(max=0)
        maximum = resid.amax(1).clamp(min=0)
        zero = (minimum == 0) & (maximum == 0)

        scale = _scale_from_minmax(minimum, maximum, limit, scale_fix)
        if encoding_mode == 4:
            power = _ilog2_plus1(scale)
            scale_eff = _pow2_table(dev)[power.long()]
            scale_raw = 12 - power
        elif encoding_mode == 2:
            scale_raw = scale & 0x1FFF          # the packer ORs filter << 13
            scale_eff = scale
        else:
            scale_raw = scale
            scale_eff = scale
        scale_eff = scale_eff.clamp(min=1)

        # pass 2: serial quantisation with simulated-decoder feedback
        q1, q2 = h1, h2
        col = []
        if scale_fix:
            # decoder-exact arithmetic
            eff = scale_eff if encoding_mode == 4 else scale + 1
            half = eff >> 1
            for t in range(spb):
                pred = ((c0 * q1) >> 12) + ((c1 * q2) >> 12)
                d = block[:, t] - pred
                d = torch.where(d > 0, d + half, d - half)
                d = _tdiv(d, eff).clamp(-limit - 1, limit)
                sim = (d * eff + pred).clamp(-MAX_S16 - 1, MAX_S16)
                q2, q1 = q1, sim
                col.append(d)
        else:
            half = scale_eff >> 1
            x12 = block << 12
            for t in range(spb):
                # int32 sums wrap mod 2^32, so the grouping of the adds
                # does not change a bit
                p = c0 * q1 + c1 * q2
                d = (x12[:, t] - p) >> 12
                d = torch.where(d > 0, d + half, d - half)
                d = _tdiv(d, scale_eff).clamp(-limit - 1, limit)
                sim = ((((d << 12) * scale_eff) + p) >> 12).clamp(
                    -MAX_S16 - 1, MAX_S16)
                q2, q1 = q1, sim
                col.append(d)
        codes[:, b] = torch.where(zero[:, None], 0, torch.stack(col, 1))
        scale_raws[:, b] = torch.where(zero, 0, scale_raw)
        zeros[:, b] = zero
        # history carried out: originals on a zero block (the reference's
        # early return, adx.cpp:231-234), the simulated decoder otherwise
        n1 = torch.where(zero, block[:, -1], q1)
        n2 = torch.where(zero, block[:, -2] if spb >= 2 else n1, q2)
        h1, h2 = n1, n2
    return codes, scale_raws, zeros


def scale_field(scale_raw: torch.Tensor, zero: torch.Tensor, *,
                encoding_mode: int, filter_: int) -> torch.Tensor:
    """The 16-bit scale word of each block (adx_kernels.py:1357-1361)."""
    if encoding_mode == 2:
        field = (filter_ << 13) | (scale_raw & 0x1FFF)
    else:
        field = scale_raw & 0xFFFF
    return torch.where(zero, 0, field)


def adx_pack(codes: torch.Tensor, field: torch.Tensor, *, block_size: int,
             bit_depth: int) -> torch.Tensor:
    """codes i32 [L, nb, spb] + scale words i32 [L, nb] -> raw blocks u8
    [L, nb, block_size]: the big-endian scale word, then the codes MSB
    first; bits past spb * bit_depth stay zero (adx_pack_device)."""
    L, nb, spb = codes.shape
    dev = codes.device
    db = block_size - 2
    shifts = torch.arange(bit_depth - 1, -1, -1, dtype=I32, device=dev)
    bits = ((codes.to(I32)[..., None] >> shifts) & 1).reshape(L, nb, -1)
    bits = torch.nn.functional.pad(bits, (0, db * 8 - spb * bit_depth))
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=I32,
                           device=dev)
    data = (bits.reshape(L, nb, db, 8) * weights).sum(-1, dtype=I32)
    sf = field.to(I32) & 0xFFFF
    out = torch.cat([(sf >> 8)[..., None], (sf & 0xFF)[..., None], data], -1)
    return out.to(torch.uint8)


def adx_encode_blocks_plain(pcm: torch.Tensor, c0: torch.Tensor,
                            c1: torch.Tensor, h1: torch.Tensor,
                            h2: torch.Tensor, *, block_size: int,
                            bit_depth: int, encoding_mode: int,
                            filter_: int = 0,
                            scale_fix: bool = False) -> torch.Tensor:
    """Plain twin of kernel B8 as a whole: adx_encode_plain, the scale
    words, adx_pack -> raw blocks u8 [L, nb, block_size]."""
    codes, scale_raw, zero = adx_encode_plain(
        pcm, c0, c1, h1, h2, bit_depth=bit_depth,
        encoding_mode=encoding_mode, scale_fix=scale_fix)
    field = scale_field(scale_raw, zero, encoding_mode=encoding_mode,
                        filter_=filter_)
    return adx_pack(codes, field, block_size=block_size, bit_depth=bit_depth)


def adx_encode_device(pcm: torch.Tensor, c0: torch.Tensor, c1: torch.Tensor,
                      h1: torch.Tensor, h2: torch.Tensor, *, block_size: int,
                      bit_depth: int, encoding_mode: int, filter_: int = 0,
                      scale_fix: bool = False) -> torch.Tensor:
    """PCM i16 [L, nb, spb] -> raw blocks u8 [L, nb, block_size]: kernel B8
    (quantise and pack in one pass) for CUDA tensors, its twin for CPU
    tensors (counterpart of adx_encode_device_pipeline)."""
    fn = (cuda_kernels.adx_encode if pcm.is_cuda
          else adx_encode_blocks_plain)
    return fn(pcm, c0, c1, h1, h2, block_size=block_size,
              bit_depth=bit_depth, encoding_mode=encoding_mode,
              filter_=filter_, scale_fix=scale_fix)
