"""PyTorch port, kernel B8's exact division and chain arithmetic on the CPU.

B8 (pycricodecs_tpu_torch/csrc/adx_codec.cu, adx_encode_kernel) divides by
a per-block divisor with a row of `divisor_table()`. Its quotient sequence,
`div_exact` in the source, is emulated here in numpy int64 with the
kernel's 32-bit wrap and held to C truncating division (torch.div,
rounding_mode="trunc") for every divisor 1..16384. A torch model of the
kernel's per-block arithmetic (the staged t >= 2 ranges, r0/r1 from the
carried history, the table division, c1 * q2 one step early, the factor
scale_eff << 12) is held to the unchanged twin, adx_encode_blocks_plain.
"""
import numpy as np
import pytest
import torch

from pycricodecs_tpu_torch.ops import adx_kernels as PK

I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1
TABLE = PK.divisor_table()


def _wrap(x: np.ndarray) -> np.ndarray:
    """int64 values -> the int32 they wrap to."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def kernel_quotient(n: np.ndarray, d: np.ndarray) -> np.ndarray:
    """The kernel's quotient of int32 n by d (div_exact), in int64:
        q = mulhi(n, mul) + (n & add)      __mulhi, 32-bit wrapping add
        q = q >> shift                     arithmetic
        q = q + ((n >>> 31) & fix)         (uint32)n >> 31, wrapping add
    with (mul, add, shift, fix) = divisor_table()[d]."""
    mul, add, shift, fix = (TABLE[d, j].astype(np.int64)[..., None]
                            for j in range(4))
    hi = (n * mul) >> 32              # |n * mul| < 2^62: exact in int64
    q = _wrap(hi + (n & add)) >> shift
    return _wrap(q + (((n & 0xFFFFFFFF) >> 31) & fix))


DIV_RANGES = [(lo, lo + 1024) for lo in range(1, PK.DIV_MAX + 1, 1024)]


@pytest.mark.parametrize("lo,hi", DIV_RANGES)
def test_kernel_division_is_c_truncation(lo, hi):
    """Every divisor of the range against INT32_MIN, INT32_MIN + 1, -1, 0, 1,
    INT32_MAX, k*d - 1, k*d, k*d + 1 for k in -64..64, and 3,000 seeded
    random int32 values."""
    d = np.arange(lo, hi, dtype=np.int64)
    fixed = np.broadcast_to(np.array(
        [I32_MIN, I32_MIN + 1, -1, 0, 1, I32_MAX], np.int64), (len(d), 6))
    k = np.arange(-64, 65, dtype=np.int64)
    near = (k[None, :, None] * d[:, None, None]
            + np.array([-1, 0, 1])).reshape(len(d), -1)
    rand = np.random.default_rng(lo).integers(I32_MIN, I32_MAX + 1,
                                              (len(d), 3000))
    n = np.concatenate([fixed, near, rand], 1)
    got = kernel_quotient(n, d)
    want = torch.div(torch.from_numpy(n.astype(np.int32)),
                     torch.from_numpy(d.astype(np.int32))[:, None],
                     rounding_mode="trunc")
    np.testing.assert_array_equal(got, want.numpy().astype(np.int64))


@pytest.mark.parametrize("d,mul,shift", [
    (2, 0x80000001, 0), (3, 0x55555556, 0), (5, 0x66666667, 1),
    (6, 0x2AAAAAAB, 0), (7, 0x92492493, 2), (9, 0x38E38E39, 1),
    (10, 0x66666667, 2), (11, 0x2E8BA2E9, 1), (12, 0x2AAAAAAB, 1),
    (25, 0x51EB851F, 3), (125, 0x10624DD3, 3), (625, 0x68DB8BAD, 8),
])
def test_divisor_table_rows(d, mul, shift):
    """Rows of the table equal the signed magic numbers of Hacker's
    Delight's table 10-1; add is -1 exactly where mul is negative as int32,
    fix is 1 for d >= 2; d = 1 is the identity row."""
    assert TABLE.dtype == np.int32 and TABLE.shape == (PK.DIV_MAX + 1, 4)
    m = np.int64(mul) - (1 << 32) * (mul >> 31)
    assert tuple(TABLE[d]) == (m, -1 if m < 0 else 0, shift, 1)
    assert tuple(TABLE[1]) == (0, -1, 0, 0)


def _quotient_t(n: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """kernel_quotient on int32 tensors (d per lane)."""
    got = kernel_quotient(n.long().numpy()[:, None], d.long().numpy())
    return torch.from_numpy(got[:, 0].astype(np.int32))


def b8_model(pcm, c0, c1, h1, h2, *, block_size, bit_depth, encoding_mode,
             filter_, scale_fix):
    """The kernel's per-block arithmetic in torch (int32 with wrap), lanes
    vectorised: the staged t >= 2 ranges, r0/r1 from the carried history,
    the scale from two table divisions; the chain as the kernel orders it
    (x - c1 * q2 formed ahead, the rounded dividend clamped to the bounds
    that clamp the quotient, the table division, the factor
    scale_eff << 12); then adx_pack."""
    x = pcm.to(torch.int32)
    L, nb, spb = x.shape
    limit = (1 << (bit_depth - 1)) - 1
    lim = torch.full((L,), limit, dtype=torch.int32)
    a0, a1 = c0[:, None, None], c1[:, None, None]
    if spb > 2:
        r = ((x[:, :, 2:] << 12) - a0 * x[:, :, 1:-1] - a1 * x[:, :, :-2]) >> 12
        pmn, pmx = r.amin(2).clamp(max=0), r.amax(2).clamp(min=0)
    else:
        pmn = pmx = torch.zeros((L, nb), dtype=torch.int32)
    codes = torch.zeros((L, nb, spb), dtype=torch.int32)
    fields = torch.zeros((L, nb), dtype=torch.int32)
    for b in range(nb):
        xs = x[:, b]
        r0 = ((xs[:, 0] << 12) - c0 * h1 - c1 * h2) >> 12
        mn, mx = torch.minimum(pmn[:, b], r0), torch.maximum(pmx[:, b], r0)
        if spb >= 2:
            r1 = ((xs[:, 1] << 12) - c0 * xs[:, 0] - c1 * h1) >> 12
            mn, mx = torch.minimum(mn, r1), torch.maximum(mx, r1)
        zero = (mn == 0) & (mx == 0)
        scale = torch.maximum(_quotient_t(mx, lim),
                              -_quotient_t(mn, lim + 1))
        if not scale_fix:
            scale = scale & 0xFFFF
        scale = scale.clamp(max=0x1000)
        if encoding_mode == 4:
            power = torch.frexp(scale.float()).exponent.to(torch.int32)
            scale_eff, scale_raw = torch.ones_like(power) << power, 12 - power
        elif encoding_mode == 2:
            scale_eff, scale_raw = scale, scale & 0x1FFF
        else:
            scale_eff, scale_raw = scale, scale
        scale_eff = scale_eff.clamp(min=1)
        eff = scale_eff if encoding_mode == 4 else scale + 1
        dv = eff if scale_fix else scale_eff
        dv = torch.where(zero, 1, dv)          # a zero block divides nothing
        half = dv >> 1
        fac = eff if scale_fix else scale_eff << 12
        hi = (limit + 1) * dv - 1 - half
        lo = half + 1 - (limit + 2) * dv
        q1, q2 = h1, h2
        c1q2 = (c1 * q2) >> 12 if scale_fix else c1 * q2
        col = []
        for t in range(spb):
            if scale_fix:
                c0q1 = (c0 * q1) >> 12
                pred = c0q1 + c1q2
                d = (xs[:, t] - c1q2) - c0q1
                c1q2 = (c1 * q1) >> 12
            else:
                pred = c0 * q1 + c1q2
                d = ((-c0) * q1 + ((xs[:, t] << 12) - c1q2)) >> 12
                c1q2 = c1 * q1
            r = torch.where(d > 0, torch.minimum(d, hi) + half,
                            torch.maximum(d, lo) - half)
            q = _quotient_t(r, dv)
            y = q * fac + pred
            sim = (y if scale_fix else y >> 12).clamp(-32768, 32767)
            q2, q1 = q1, sim
            col.append(q)
        codes[:, b] = torch.where(zero[:, None], 0, torch.stack(col, 1))
        fields[:, b] = PK.scale_field(scale_raw, zero,
                                      encoding_mode=encoding_mode,
                                      filter_=filter_)
        h1, h2 = (torch.where(zero, xs[:, -1], q1),
                  torch.where(zero, xs[:, -2] if spb >= 2 else xs[:, -1], q2))
    return PK.adx_pack(codes, fields, block_size=block_size,
                       bit_depth=bit_depth)


@pytest.mark.parametrize("mode,bd,bs,sfix,nb,loud", [
    (3, 4, 0x12, False, 12, False), (4, 4, 0x12, False, 12, False),
    (2, 4, 0x12, False, 12, False), (3, 5, 0x12, False, 12, False),
    (3, 8, 3, False, 40, False), (3, 2, 255, False, 2, False),
    (3, 2, 0x12, False, 12, True), (4, 2, 0x12, True, 12, True),
    (4, 12, 0x12, True, 12, False), (3, 4, 0x12, True, 12, False),
    (2, 15, 0x12, True, 12, True), (2, 7, 13, False, 12, False),
])
def test_kernel_model_matches_twin(mode, bd, bs, sfix, nb, loud):
    """Odd spb (25), spb 1 and 1,012, loud PCM at bit depth 2 (the u16 wrap
    and the 0x1000 cap), bit depth 15 (divisor 16384), zero blocks."""
    spb = (bs - 2) * 8 // bd
    L = 6
    rng = np.random.default_rng(bd * 100 + bs + mode)
    if loud:
        pcm = rng.choice(np.array([-32768, 32767]), (L, nb * spb))
    else:
        t = np.arange(nb * spb)
        pcm = np.stack([(rng.uniform(100, 20000) * np.sin(
            2 * np.pi * rng.uniform(0.001, 0.2) * t)
            + rng.normal(0, 40, nb * spb)) for _ in range(L)])
    pcm = np.clip(pcm, -32768, 32767).astype(np.int16).reshape(L, nb, spb)
    pcm[0, : nb // 2] = 0                     # zero blocks from zero history
    c = np.array([[int(rng.integers(-8192, 8192)), int(rng.integers(-4096,
                                                                   4096))]
                  for _ in range(L)], np.int32)
    h = rng.integers(-32768, 32768, (2, L)).astype(np.int32)
    h[:, 0] = 0
    args = [torch.from_numpy(np.ascontiguousarray(a))
            for a in (pcm, c[:, 0], c[:, 1], h[0], h[1])]
    kw = dict(block_size=bs, bit_depth=bd, encoding_mode=mode,
              filter_=2 if mode == 2 else 0, scale_fix=sfix)
    want = PK.adx_encode_blocks_plain(*args, **kw)
    got = b8_model(*args, **kw)
    assert bool((want[0, : nb // 2] == 0).all())
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    if loud and not sfix:
        x = args[0].to(torch.int32)
        r = (x[:, :, 2:] << 12) - x[:, :, 1:-1] * args[1][:, None, None]
        r = (r - x[:, :, :-2] * args[2][:, None, None]) >> 12
        assert int(r.abs().max()) > 0xFFFF      # the u16 wrap is reached
