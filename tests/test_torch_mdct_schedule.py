"""PyTorch port, kernel B6's generated window fold and DCT-IV on the CPU.

B6 (pycricodecs_tpu_torch/csrc/hca_encode.cu) stages a warp's 32 rows of
PCM plus the row before them (the halo) into shared memory with 16-byte
copies, folds each row with its left neighbour's (zeros where row % T is
0), and runs the encoder's DCT-IV as the slot schedule that
`_build.mdct_schedule()` makes and `_build.mdct_source()` emits as
straight-line CUDA (hca_mdct.inc). Here a torch model of that walk (the
33-row stage, built chunk by chunk as the copies fill it, the unstaged
rows poisoned; the row % T zero fold; the fold 8 values at a time; the
schedule slot by slot with one rounded f32 op per value, as the kernel's
_rn intrinsics) is held to the twin `mdct_plain`, to the JAX `_mdct` and
to `mdct_enc_pallas` in interpret mode, on seeded numpy PCM: T = 1,
T = 33 (tiles that cross a stream channel), row counts off a multiple of
32, both rails, all-zero blocks. A last test parses the generated source
and holds every fold line, butterfly and literal to the schedule and the
tables, so the tested schedule is the one the card runs.

Tolerance: exact, f32 compared as its int32 bits (+0.0 and -0.0 differ).
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pycricodecs_tpu.ops import hca_encode_device as jax_enc
from pycricodecs_tpu.ops import hca_tables as jax_tables
from pycricodecs_tpu.ops import pallas_kernels
from pycricodecs_tpu_torch import _build
from pycricodecs_tpu_torch.ops import hca_encode_device as port_enc
from pycricodecs_tpu_torch.ops import hca_tables as T
from tests import torch_port_helpers  # noqa: F401  (one torch thread)

PRE, STAGES, OUT_SLOT = _build.mdct_schedule()
SIN = torch.from_numpy(np.asarray(T.DCT4_SIN_FLAT, np.float32))
COS = torch.from_numpy(np.asarray(T.DCT4_COS_FLAT, np.float32))
WIN = np.asarray(T.IMDCT_WINDOW, np.float32)
SCALE = np.float32(1.0 / 32768.0)
IN_STRIDE = 136            # int16 values per staged row (272 bytes)
POISON = 12345             # what a never-staged stage slot holds here


def stage_tiles(rows: np.ndarray) -> np.ndarray:
    """The warps' int16 stages, [tiles, 33, IN_STRIDE]: stage row s of
    tile t holds row 32 t - 1 + s, filled as the kernel's 16-byte chunks
    c = 0 .. 16 (n + 1) - 1 land (chunk c -> stage row c >> 4, values
    8 (c & 15) ..), skipping the halo of the first tile; every slot no
    chunk fills holds POISON."""
    R = rows.shape[0]
    flat = rows.reshape(-1)
    tiles = -(-R // 32)
    st = np.full((tiles, 33, IN_STRIDE), POISON, np.int16)
    for t in range(tiles):
        r0 = 32 * t
        n = min(32, R - r0)
        for c in range(16 if r0 == 0 else 0, (n + 1) * 16):
            src = (r0 - 1) * 128 + 8 * c
            st[t, c >> 4, 8 * (c & 15):8 * (c & 15) + 8] = flat[src:src + 8]
    return st


def wave(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32) * torch.tensor(SCALE)


def run_schedule(v: torch.Tensor) -> torch.Tensor:
    """mdct_slots then mdct_order on f32 [..., 128] fold outputs."""
    v = v.clone()
    a = torch.tensor([o[0] for o in PRE])
    b = torch.tensor([o[1] for o in PRE])
    tw = torch.tensor([o[2] for o in PRE])
    va, vb = v[..., a], v[..., b]
    sn, cs = SIN[tw], COS[tw]
    v[..., a] = va * cs + vb * sn
    v[..., b] = va * sn - vb * cs
    for ops in STAGES:
        fe, fo, be, bo, tw = (torch.tensor([o[i] for o in ops])
                              for i in range(5))
        a, b, c, d = v[..., fe], v[..., fo], v[..., be], v[..., bo]
        e, f = a - c, b - d
        sn, cs = SIN[tw], COS[tw]
        v = v.clone()
        v[..., fe] = a + c
        v[..., fo] = b + d
        v[..., be] = e * cs + f * sn
        v[..., bo] = e * sn - f * cs
    return v[..., torch.tensor(OUT_SLOT)]


def b6_model(pcm: np.ndarray) -> np.ndarray:
    """B6 as the kernel walks it: PCM16 [B, C, T*128] -> f32 [B, C, T, 128]."""
    B, C, total = pcm.shape
    Tn = total // 128
    rows = pcm.reshape(-1, 128)
    R = rows.shape[0]
    st = torch.from_numpy(stage_tiles(rows)[..., :128])     # [tiles, 33, 128]
    tiles = st.shape[0]
    lane_row = torch.arange(tiles)[:, None] * 32 + torch.arange(32)
    keep = (lane_row % Tn != 0)[..., None]
    own = wave(st[:, 1:])                                    # lane l: row l + 1
    prev = wave(torch.where(keep, st[:, :32], 0))            # and row l
    nw = torch.from_numpy(-WIN)
    w = torch.from_numpy(WIN)
    v = torch.empty((tiles, 32, 128), dtype=torch.float32)
    for m in range(8):                       # 8 fold outputs a chunk pair
        h, l = own[..., 8 * (8 + m):8 * (9 + m)], own[..., 8 * (7 - m):8 * (8 - m)]
        j = 8 * m + torch.arange(8)
        v[..., j] = h * nw[63 - j] - torch.flip(l, [-1]) * nw[64 + j]
        h, l = prev[..., 8 * m:8 * (m + 1)], prev[..., 8 * (15 - m):8 * (16 - m)]
        v[..., 64 + j] = h * w[j] - torch.flip(l, [-1]) * nw[127 - j]
    y = run_schedule(v) * torch.tensor(np.float32(0.125))
    return y.reshape(-1, 128)[:R].numpy().reshape(B, C, Tn, 128)


def pcm_case(B, C, Tn, seed) -> np.ndarray:
    """Seeded PCM16 with both rails, an all-zero block and a silent
    stream channel's first block."""
    rng = np.random.default_rng(seed)
    pcm = rng.integers(-32768, 32768, (B, C, Tn * 128), dtype=np.int16)
    pcm[0, 0, :6] = (-32768, 32767, -32768, 32767, 0, -1)
    pcm[-1, -1, -128:] = -32768
    pcm[0, -1, :128] = 0
    if Tn > 2:
        pcm[-1, 0, 128:256] = 0                              # all-zero block
    return pcm


def bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


# (B, C, T): T = 1 (every row folds with zeros), T = 33 (tiles cross into a
# new stream channel), rows 40 / 132 / 99 (ragged last warp), one row
CASES = [(3, 1, 1), (1, 1, 1), (2, 2, 33), (1, 1, 40), (3, 3, 11),
         (1, 2, 32), (5, 1, 7)]


@pytest.mark.parametrize("B,C,Tn", CASES)
def test_model_matches_twin_xla_and_pallas(B, C, Tn):
    pcm = pcm_case(B, C, Tn, seed=B * 100 + C * 10 + Tn)
    got = b6_model(pcm)
    twin = port_enc.mdct_plain(torch.from_numpy(pcm)).numpy()
    np.testing.assert_array_equal(bits(got), bits(twin))
    pallas = pallas_kernels.mdct_enc_pallas(pcm, interpret=True)
    np.testing.assert_array_equal(bits(got), bits(pallas))
    w = (jnp.asarray(pcm).astype(jnp.float32)
         * jnp.float32(1.0 / 32768.0)).reshape(B, C, Tn, 128)
    window = jnp.asarray(jax_tables.IMDCT_WINDOW)
    xla = jax.jit(lambda x: jax_enc._mdct(x, window))(w)
    np.testing.assert_array_equal(bits(got), bits(xla))


def test_signed_zeros_of_silence_and_rails():
    """Silent rows fold to signed zeros (w * -0.0 and -w * +0.0 are -0.0)
    that the stages sum back to +0.0: the model gives the twin's bits, an
    all-+0.0 spectrum, where the block and the one before it are silent;
    and rows of only -32768 or 32767 after silence match too."""
    pcm = np.zeros((1, 2, 5 * 128), np.int16)
    pcm[0, 1, 256:384] = -32768
    pcm[0, 1, 384:512] = 32767
    got = b6_model(pcm)
    twin = port_enc.mdct_plain(torch.from_numpy(pcm)).numpy()
    np.testing.assert_array_equal(bits(got), bits(twin))
    assert (bits(twin[0, 0]) == 0).all() and (bits(twin[0, 1, :2]) == 0).all()
    assert (twin[0, 1, 2:] != 0).any()


def test_stage_poison_never_reaches_a_kept_row():
    """The stage model's never-staged slots hold POISON; a kept row that
    read one would differ from the twin. Rows 1 .. 31 of the first tile's
    stage are staged, its halo row is not."""
    rows = np.arange(40 * 128, dtype=np.int64).astype(np.int16).reshape(40,
                                                                         128)
    st = stage_tiles(rows)
    assert (st[0, 0] == POISON).all() and (st[:, :, 128:] == POISON).all()
    np.testing.assert_array_equal(st[0, 1:, :128], rows[:32])
    np.testing.assert_array_equal(st[1, :9, :128], rows[31:40])
    assert (st[1, 9:] == POISON).all()


def test_generated_source_is_the_schedule():
    """Every fold line, pre-rotation and stage butterfly of hca_mdct.inc,
    in order, names the schedule's slots and its literals' bits;
    mdct_order names out_slot."""
    src = _build.mdct_source()
    fold, rest = src.split("mdct_slots")
    slots, order = rest.split("mdct_order")

    def f32(lit: str) -> int:
        return int(np.float32(float.fromhex(lit)).view(np.int32))

    loads = re.findall(r"(cur|prev)\((\d+), h\); \1\((\d+), l\);", fold)
    assert loads == ([("cur", str(8 + m), str(7 - m)) for m in range(8)]
                     + [("prev", str(m), str(15 - m)) for m in range(8)])
    lines = re.findall(r"v\[(\d+)\] = __fsub_rn\(__fmul_rn\(h\[(\d)\], (\S+)f"
                       r"\), __fmul_rn\(l\[(\d)\], (\S+)f\)\);", fold)
    assert len(lines) == 128
    for j, (vj, he, a, le, b) in enumerate(lines):
        k = j % 64
        assert (int(vj), int(he), int(le)) == (j, k % 8, 7 - k % 8)
        wa, wb = ((-WIN[63 - k], -WIN[64 + k]) if j < 64
                  else (WIN[k], -WIN[127 - k]))
        assert (f32(a), f32(b)) == (bits(wa), bits(wb))

    pre = re.findall(
        r"a = v\[(\d+)\]; b = v\[(\d+)\]; v\[(\d+)\] = __fadd_rn\(__fmul_rn"
        r"\(a, (\S+)f\), __fmul_rn\(b, (\S+)f\)\); v\[(\d+)\] = __fsub_rn\("
        r"__fmul_rn\(a, (\S+)f\), __fmul_rn\(b, (\S+)f\)\);", slots)
    assert len(pre) == 64
    for (a, b, a2, cs, sn, b2, sn2, cs2), (sa, sb, tw) in zip(pre, PRE):
        assert [int(a), int(b), int(a2), int(b2)] == [sa, sb, sa, sb]
        assert cs == cs2 and sn == sn2
        assert f32(cs) == bits(COS[tw].numpy())
        assert f32(sn) == bits(SIN[tw].numpy())
    bfly = re.findall(
        r"a = v\[(\d+)\]; b = v\[(\d+)\]; c = v\[(\d+)\]; d = v\[(\d+)\]; "
        r"e = __fsub_rn\(a, c\); f = __fsub_rn\(b, d\); v\[(\d+)\] = "
        r"__fadd_rn\(a, c\); v\[(\d+)\] = __fadd_rn\(b, d\); v\[(\d+)\] = "
        r"__fadd_rn\(__fmul_rn\(e, (\S+)f\), __fmul_rn\(f, (\S+)f\)\); "
        r"v\[(\d+)\] = __fsub_rn\(__fmul_rn\(e, (\S+)f\), __fmul_rn\(f, "
        r"(\S+)f\)\);", slots)
    ops = [op for stage in STAGES for op in stage]
    assert len(bfly) == len(ops) == 6 * 32
    for m, (fe, fo, be, bo, tw) in zip(bfly, ops):
        assert [int(m[i]) for i in (0, 1, 2, 3, 4, 5, 6, 9)] == [
            fe, fo, be, bo, fe, fo, be, bo]
        assert m[7] == m[11] and m[8] == m[10]
        assert f32(m[7]) == bits(COS[tw].numpy())
        assert f32(m[8]) == bits(SIN[tw].numpy())
    got = re.findall(r"y\[(\d+)\] = v\[(\d+)\];", order)
    assert [(int(j), int(s)) for j, s in got] == list(enumerate(OUT_SLOT))
    assert sorted(OUT_SLOT) == list(range(128))
    # every slot is written once a stage: the stages are permutations
    for stage in STAGES:
        assert sorted(s for op in stage for s in op[:4]) == list(range(128))
    assert sorted(s for op in PRE for s in op[:2]) == list(range(128))
