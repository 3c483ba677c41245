"""PyTorch port, kernel B7's staged decode on the CPU.

B7 (pycricodecs_tpu_torch/csrc/adx_codec.cu, adx_decode_kernel) walks each
CTA's lanes in chunks of K blocks (`adx_decode_plan`, from the shared
`chunk_plan`, mirrored here). Its staging warps copy a chunk's raw block
bytes into shared memory, take each block's scale word to (s, a0, a1) by
mode and write q * s (int32, wrapping) per code, extracted MSB first from a
3-byte window whose bits past the code are masked off; its chain thread
carries (p1, p2) from block to block and chunk to chunk, with a1 * p2 >> 12
formed one step early. A torch model of exactly that order is held to the
twin `adx_decode_plain` and to the JAX `adx_decode_serial_pallas` in
interpret mode (after `adx_unpack_device`; at spb 1,012, past that
kernel's budget, to the reference scan `adx_decode_scan`), as
tests/test_torch_adx_divide.py holds B8's model.

Tolerance: equal int16 samples.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pycricodecs_tpu.models import adx as jax_adx
from pycricodecs_tpu.ops import adx_kernels as JK
from pycricodecs_tpu_torch.ops import adx_kernels as PK

STATIC = tuple(int(x) for x in jax_adx.STATIC_COEFFICIENTS)
SMS = 132                  # an H100's streaming multiprocessors
BUDGET = 100 * 1024        # kSmemBudget
MAX_LANES, MAX_CHUNK = 32, 64


def _r16(n: int) -> int:
    return (n + 15) & ~15


def dec_geometry(G: int, K: int, spb: int, bs: int) -> dict:
    """dec_geometry of the kernel: per-lane strides and shared bytes."""
    raw = _r16(K * bs) + 16
    qs = K * ((spb + 7) & ~7) * 4 + 16
    out = _r16(K * spb * 2) + 16
    return dict(G=G, K=K, raw_stride=raw, qs_stride=qs, out_stride=out,
                smem=G * (raw + 2 * (qs + out + K * 8)))


def decode_plan(L: int, nb: int, bs: int, bd: int, sms: int = SMS) -> dict:
    """chunk_plan with B7's geometry (adx_decode_plan)."""
    spb = (bs - 2) * 8 // bd
    G = min(MAX_LANES, -(-L // sms))
    while G > 1 and dec_geometry(G, 1, spb, bs)["smem"] > BUDGET:
        G = (G + 1) // 2
    K = min(nb, MAX_CHUNK)
    while K > 1 and dec_geometry(G, K, spb, bs)["smem"] > BUDGET:
        K -= 1
    if K >= 8:
        K &= ~7
    return dec_geometry(G, K, spb, bs)


def stage_block(raw: torch.Tensor, k: int, bs: int, bd: int, mode: int,
                c0, c1):
    """The stagers' work on block k of a staged chunk raw u8 [L, stride]:
    (q * s i32 [L, spb], a0, a1 i32 [L])."""
    spb = (bs - 2) * 8 // bd
    r = raw.to(torch.int32)
    blk = k * bs
    scale_raw = (r[:, blk] << 8) | r[:, blk + 1]
    if mode == 2:
        pred = (scale_raw >> 13).long()
        s = (scale_raw & 0x1FFF) + 1
        tab = list(STATIC) + [0] * 8
        a0 = torch.tensor(tab[0:16:2], dtype=torch.int32)[pred]
        a1 = torch.tensor(tab[1:16:2], dtype=torch.int32)[pred]
    else:
        if mode == 4:
            # 1u << ((12 - scale_raw) & 31), read back as int32
            e = ((12 - scale_raw) & 31).long()
            s = torch.tensor([(1 << j) - (1 << 32) * (j == 31)
                              for j in range(32)], dtype=torch.int32)[e]
        else:
            s = scale_raw + 1
        a0, a1 = c0, c1
    o = torch.arange(spb) * bd
    c = blk + 2 + (o >> 3)
    w = (r[:, c] << 16) | (r[:, c + 1] << 8) | r[:, c + 2]
    v = ((w >> (24 - (o & 7) - bd)) & ((1 << bd) - 1)).to(torch.int32)
    q = torch.where((v & (1 << (bd - 1))) != 0, v - (1 << bd), v)
    return q * s[:, None], a0, a1


def b7_model(payload, h1, h2, c0, c1, *, bit_depth, encoding_mode,
             sms=SMS):
    """B7 as the kernel orders it: u8 [L, nb, bs] -> i16 [L, nb, spb]."""
    L, nb, bs = payload.shape
    bd = bit_depth
    spb = (bs - 2) * 8 // bd
    plan = decode_plan(L, nb, bs, bd, sms)
    K = plan["K"]
    out = torch.empty((L, nb, spb), dtype=torch.int16)
    p1, p2 = h1.clone(), h2.clone()
    for k0 in range(0, nb, K):
        kc = min(K, nb - k0)
        # the raw tile; its padding is whatever shared memory held (zeros
        # here): bits read from it are masked off
        raw = torch.zeros((L, plan["raw_stride"]), dtype=torch.uint8)
        raw[:, :kc * bs] = payload[:, k0:k0 + kc].reshape(L, -1)
        for k in range(kc):
            qs, a0, a1 = stage_block(raw, k, bs, bd, encoding_mode, c0, c1)
            a1p2 = (a1 * p2) >> 12
            for t in range(spb):
                x = (qs[:, t] + ((a0 * p1) >> 12) + a1p2).clamp(-32768,
                                                                32767)
                a1p2 = (a1 * p1) >> 12
                p2, p1 = p1, x
                out[:, k0 + k, t] = x.to(torch.int16)
    return out


def _jax_decode(raw, h1, h2, coef, bd, mode):
    """The JAX decode: adx_unpack_device, then the serial Pallas kernel in
    interpret mode; at spb 1,012, past that kernel's VMEM budget
    (adx_kernels._resolve_serial_engine), the reference scan
    adx_decode_scan, whose per-sample order the kernels share."""
    bs = raw.shape[2]
    q, s, a0, a1 = JK.adx_unpack_device(
        jnp.asarray(raw), block_size=bs, bit_depth=bd, encoding_mode=mode,
        coef=coef, static_coefficients=STATIC)
    hist = jnp.asarray(h1), jnp.asarray(h2)
    L, nb, spb = q.shape
    if spb > 768:
        per = [jnp.repeat(v, spb, axis=1) for v in (s, a0, a1)]
        return np.asarray(JK.adx_decode_scan(q.reshape(L, -1), *per,
                                             *hist)).reshape(L, nb, spb)
    pcm, conv = JK.adx_decode_serial_pallas(q, s, a0, a1, *hist,
                                            interpret=True)
    assert bool(np.asarray(conv))
    return np.asarray(pcm)


# (mode, bit depth, block size, lanes, blocks): bit depths 2/4/5/8/11/12/15;
# spb 64, 32, 25 (odd), 1, 8, 10, 8, 1,012; L 133 leaves the last CTA with
# one lane (G 2); one block; one chunk plus 3 (K 64 -> 67 blocks)
CASES = [
    (3, 2, 0x12, 5, 9), (3, 4, 0x12, 133, 3), (2, 5, 0x12, 4, 11),
    (3, 8, 3, 3, 70), (4, 11, 13, 3, 10), (4, 12, 0x12, 3, 12),
    (2, 15, 0x12, 4, 10), (3, 2, 255, 2, 3), (4, 4, 0x12, 3, 1),
    (3, 4, 0x12, 2, 67), (2, 4, 0x12, 3, 67), (4, 5, 12, 6, 5),
]


@pytest.mark.parametrize("mode,bd,bs,L,nb", CASES)
def test_b7_model_matches_twin_and_pallas(mode, bd, bs, L, nb):
    """Random block bytes: mode 2 draws predictors 4-7, mode 4 scale words
    13 mod 32 (1 << 31, which wraps); history on the rails."""
    rng = np.random.default_rng(mode * 1000 + bd * 37 + bs + L + nb)
    raw = rng.integers(0, 256, (L, nb, bs), dtype=np.uint8)
    raw[0, 0, :2] = (0x00, 0x0D)                # mode 4: 1 << 31
    raw[-1, -1, :2] = (0xE0 | (bd & 0x1F), 0x10)   # mode 2: predictor 7
    if mode == 4:
        raw[1, :, 1] = (raw[1, :, 1] & 0xE0) | 13
    words = (raw[..., 0].astype(np.int32) << 8) | raw[..., 1]
    if mode == 2:
        assert (words >> 13 >= 4).any() and (words >> 13 < 4).any()
    h = rng.integers(-32768, 32768, (2, L)).astype(np.int32)
    h[:, 0] = (32767, -32768)
    coef = (int(rng.integers(-8192, 8192)), int(rng.integers(-4096, 4096)))
    args = [torch.from_numpy(raw), torch.from_numpy(h[0]),
            torch.from_numpy(h[1]),
            torch.full((L,), coef[0], dtype=torch.int32),
            torch.full((L,), coef[1], dtype=torch.int32)]
    kw = dict(bit_depth=bd, encoding_mode=mode)
    got = b7_model(*args, **kw)
    want = PK.adx_decode_plain(*args, **kw)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(
        got.numpy(), _jax_decode(raw, h[0], h[1], coef, bd, mode))
    assert (np.abs(want.numpy().astype(np.int32)) >= 32767).any()


@pytest.mark.parametrize("L,nb,bs,bd,G,K", [
    (512, 15000, 0x12, 4, 4, 56),      # the ADX bank
    (133, 3, 0x12, 4, 2, 3),           # ragged last CTA, one chunk
    (600, 67, 0x12, 4, 5, 48),         # five lanes a CTA shrink K
    (3, 10, 255, 2, 1, 8),             # spb 1,012 shrinks K
    (600, 10, 255, 2, 5, 1),           # ... to 1 at G 5
    (4224, 10, 255, 2, 8, 1),          # ... and G from 32 to 8
    (3, 70, 3, 8, 1, 64),              # spb 1
])
def test_decode_plan(L, nb, bs, bd, G, K):
    """The plan's G and K on a 132-SM card, inside the shared budget."""
    p = decode_plan(L, nb, bs, bd)
    assert (p["G"], p["K"]) == (G, K)
    assert p["smem"] <= BUDGET
    assert all(p[k] % 16 == 0 for k in ("raw_stride", "qs_stride",
                                         "out_stride"))
