"""PyTorch port: a model of the Layer II synthesis kernel's tiled walk on
the CPU.

mp2_synth (pycricodecs_tpu_torch/csrc/mp2_synth.cu) gives each block a
segment of 9 tiles of 64 rows of one (stream, channel) and walks them in
order, carrying the last 15 V rows from tile to tile; a segment after the
first starts from V rows recomputed from the 16 rows before it (S rows
48..63 of the tile before), the first from zeros. Per tile: dequantise;
matrixing with k folded in order; the window, each of four warps taking 16
consecutive rows of its 32 columns through a 16-slot ring of V[.][j] and
V[.][32 + j] whose slots are (V row) % 16. `synth_model` is that walk in
torch f64, one rounded op per value as the kernel's _rn intrinsics, and is
held bit for bit to `synthesize_plain` and to the JAX package's host lane
(`decode_pcm16_host`, the native f64 V-FIFO synthesis) on the AHX fixtures
and on random codes, C = 1 and C = 2, T at and off multiples of the tile
and of the segment. The kernel's quotient (2c + 1 - n) / n for a Layer II
class n is a reciprocal from a table, a product and an exact remainder
correction; it is held here, in exact rational arithmetic, to the
correctly rounded quotient for every class and every |a| < n.
"""
from fractions import Fraction

import numpy as np
import pytest
import torch

from pycricodecs_tpu import native
from pycricodecs_tpu.ops import mp2_frame as jax_frame
from pycricodecs_tpu.ops import mp2_kernels as jax_kernels
from pycricodecs_tpu.ops import mp2_tables as jax_tables
from pycricodecs_tpu_torch.ops import mp2_kernels as MK
from tests import torch_port_helpers as H

TILE, HALO, SEG_TILES, PROLOGUE = 64, 15, 9, 48    # the kernel's constants
SF, NT, DWIN = MK._tables("cpu")


def dequantise(codes, levels, sfidx):
    """S [B, C, T, 32]: ((2c + 1 - n) / n) * sf, 0 where n == 0."""
    B, F, C = codes.shape[:3]
    n = levels.double()[:, :, :, None, :]
    sf = SF[sfidx.long()][:, :, :, torch.arange(36) // 12, :]
    c = codes.to(torch.int32).double()
    s = torch.where(n > 0, ((2.0 * c + 1.0 - n) / n) * sf, 0.0)
    return s.permute(0, 2, 1, 3, 4).reshape(B, C, F * 36, 32)


def matrixing(S):
    """V rows of S rows [..., R, 32] -> [..., R, 64], k folded in order."""
    v = S[..., 0:1] * NT[0]
    for k in range(1, 32):
        v = v + S[..., k:k + 1] * NT[k]
    return v


def synth_model(codes, levels, sfidx):
    """mp2_synth as the kernel walks it; arguments and result as
    synthesize_plain."""
    B, F, C = codes.shape[:3]
    Tn = F * 36
    tiles = -(-Tn // TILE)
    segs = -(-tiles // SEG_TILES)
    S_all = dequantise(codes, levels, sfidx)
    S_all = torch.nn.functional.pad(S_all, (0, 0, 0, tiles * TILE - Tn))
    out = torch.full((B, C, Tn, 32), -1, dtype=torch.int32)
    written = torch.zeros_like(out)
    de = torch.stack([DWIN[64 * m:64 * m + 32] for m in range(8)])
    dd = torch.stack([DWIN[64 * m + 32:64 * m + 64] for m in range(8)])
    w = torch.arange(4)
    for seg in range(segs):
        V = torch.zeros((B, C, TILE + HALO, 64), dtype=torch.float64)
        if seg:
            t0 = (seg * SEG_TILES - 1) * TILE
            V[:, :, HALO + PROLOGUE:] = matrixing(
                S_all[:, :, t0 + PROLOGUE:t0 + TILE])
            V[:, :, :HALO] = V[:, :, TILE:].clone()
        for tile in range(seg * SEG_TILES,
                          min((seg + 1) * SEG_TILES, tiles)):
            t0 = tile * TILE
            V[:, :, HALO:] = matrixing(S_all[:, :, t0:t0 + TILE])
            # the ring, the four warps side by side: [B, C, 4, 32] a slot
            E = [None] * 16
            O = [None] * 16
            for i in range(15):
                E[i] = V[:, :, 16 * w + i, :32]
                O[i] = V[:, :, 16 * w + i, 32:]
            for i in range(16):
                u, sl = 16 * w + 15 + i, (15 + i) % 16
                E[sl] = V[:, :, u, :32]
                O[sl] = V[:, :, u, 32:]
                o = de[0] * E[sl]
                o = o + dd[0] * O[(sl + 15) % 16]
                for m in range(1, 8):
                    o = o + de[m] * E[(sl + 16 - 2 * m) % 16]
                    o = o + dd[m] * O[(sl + 15 - 2 * m) % 16]
                y = torch.floor(o * 32768.0 + 0.5).clamp(-32768.0, 32767.0)
                t = t0 + 16 * w + i
                ok = t < Tn
                out[:, :, t[ok]] = y[:, :, ok].to(torch.int32)
                written[:, :, t[ok]] += 1
            V[:, :, :HALO] = V[:, :, TILE:].clone()
    assert bool((written == 1).all()), "a sample written twice or never"
    return out.to(torch.int16).reshape(B, C, Tn * 32)


@pytest.fixture(scope="module", autouse=True)
def native_lane():
    assert native.load() is not None, "the native host lane must load"


def _host(codes, levels, sfidx):
    """The JAX host lane per stream: [B, C, T * 32]."""
    return np.stack([jax_kernels.decode_pcm16_host(codes[b], levels[b],
                                                   sfidx[b])
                     for b in range(codes.shape[0])])


def _check(codes, levels, sfidx):
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in (codes, levels, sfidx)]
    got = synth_model(*t).numpy()
    np.testing.assert_array_equal(got, MK.synthesize_plain(*t).numpy())
    np.testing.assert_array_equal(got, _host(codes, levels, sfidx))
    return got


@pytest.mark.parametrize("name", sorted(H.load_ahx_fixtures()[0]))
def test_model_matches_twin_and_host_lane_on_fixtures(name):
    """The 10 s bank stream is 108 tiles: 12 segments, each after the first
    starting from its recomputed halo."""
    blob = H.load_ahx_fixtures()[1][name]
    st = jax_frame.unpack(blob, H.mp2_offset(blob))
    got = _check(st.codes[None], st.levels[None], st.sfidx[None])
    assert np.abs(got.astype(np.int32)).max() > 1000


# T = F * 36 rows: 36 (one short tile), 576 (one whole segment), 612 (a
# second segment of one ragged tile), 1,440 (three segments, ragged), and
# 684 with C = 2
@pytest.mark.parametrize("B,F,C", [(2, 1, 1), (1, 16, 2), (2, 17, 1),
                                   (1, 40, 1), (2, 19, 2)])
def test_model_matches_twin_and_host_lane_on_random_codes(B, F, C):
    rng = np.random.default_rng(B * 1000 + F * 10 + C)
    classes = np.unique(np.concatenate(
        [np.concatenate(t) for t in jax_tables.ALLOC_TABLES.values()]))
    levels = rng.choice(classes, (B, F, C, 32)).astype(np.int32)
    codes = (rng.random((B, F, C, 36, 32))
             * np.maximum(levels, 1)[..., None, :]).astype(np.uint16)
    codes[np.broadcast_to(levels[..., None, :] == 0, codes.shape)] = 0
    sfidx = rng.integers(0, 63, (B, F, C, 3, 32), dtype=np.uint8)
    got = _check(codes, levels, sfidx)
    assert (np.abs(got.astype(np.int32)) == 32768).any()  # the clamp is hit


def test_halo_share_and_shared_memory():
    """A segment's recomputed halo is at most 3 % of its matrixing, and S
    and V together let four blocks share an SM's 228 KB (1 KB a block
    reserved)."""
    assert (TILE - PROLOGUE) / (SEG_TILES * TILE) <= 0.03
    assert TILE - PROLOGUE >= HALO and PROLOGUE % 8 == 0
    smem = (TILE * 32 + (TILE + HALO) * 64) * 8
    assert 4 * (smem + 1024) <= 228 * 1024


def kernel_quotient(a: int, n: int) -> float:
    """mp2_synth's quotient for a Layer II class n and |a| < n: y = RN(1/n)
    (kMp2Recip), q = RN(a * y), r = RN(a - q * n) and RN(q + r * y), the two
    last as fused multiply-adds (exact products, one rounding); float() of
    a Fraction rounds to the nearest double, ties to even."""
    y = 1.0 / n
    q = float(Fraction(a) * Fraction(y))
    r = float(Fraction(a) - Fraction(q) * n)
    assert Fraction(r) == Fraction(a) - Fraction(q) * n   # exact remainder
    return float(Fraction(r) * Fraction(y) + Fraction(q))


def test_reciprocal_table_is_every_class():
    from pycricodecs_tpu_torch import _build
    classes = {int(x) for t in jax_tables.ALLOC_TABLES.values() for r in t
               for x in r if x > 0}
    assert classes <= set(_build.MP2_RECIP_N)
    for i, n in enumerate(_build.MP2_RECIP_N):     # the kernel's index
        assert i == {5: 0, 9: 1}.get(n, bin(n).count("1"))
        assert n in (5, 9) or (n & (n + 1)) == 0


@pytest.mark.parametrize("n", [3, 5, 7, 9, 15, 31, 63, 127, 255, 511, 1023,
                               2047, 4095, 8191, 16383, 32767, 65535])
def test_kernel_quotient_is_correctly_rounded(n):
    """Every integer |a| < n: the kernel's reciprocal, product and
    remainder correction give a / n correctly rounded, bit for bit."""
    got = np.array([kernel_quotient(a, n) for a in range(1 - n, n)])
    want = np.arange(1 - n, n, dtype=np.float64) / np.float64(n)
    np.testing.assert_array_equal(got.view(np.int64), want.view(np.int64))
