"""PyTorch port, the DCT-IV slot schedule of kernels B4 and B5 on the CPU.

B4 and B5 (pycricodecs_tpu_torch/csrc/hca_imdct.cu) run the DCT-IV as the
slot schedule that `_build.dct4_schedule()` makes and `_build.dct4_source()`
emits as straight-line CUDA: in-place butterflies on a row's 128 slots, the
results named in logical order at the end. Here that same schedule runs in
torch (one rounded f32 op per value, as the kernel's _rn intrinsics) and is
held to B5's twin `imdct_butterflies` and to the JAX `imdct_pallas` in
interpret mode; a torch model of B4 as the kernel walks it (a warp per 31
subframes of a row, lane 0 recomputing the subframe before as the carry, a
zero carry before a row's first subframe, the overlap-add two outputs per
carried value) is held to `imdct_ola_plain` and the JAX `imdct_ola_pallas`
in interpret mode. A last test parses the generated source and holds every
butterfly and twiddle literal to the schedule and the tables, so the tested
schedule is the one the card runs.

Tolerance: equal bits (f32 viewed as int32), except that +0.0 and -0.0
count as equal, as tests/test_torch_imdct.py allows.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pycricodecs_tpu.ops import pallas_kernels
from pycricodecs_tpu_torch import _build
from pycricodecs_tpu_torch.ops import hca_kernels as K
from pycricodecs_tpu_torch.ops import hca_tables as T

STAGES, SLOT_OF = _build.dct4_schedule()
SIN = torch.from_numpy(np.asarray(T.IMDCT_SIN, np.float32).reshape(-1))
COS = torch.from_numpy(np.asarray(T.IMDCT_COS, np.float32).reshape(-1))
WIN = torch.from_numpy(np.asarray(T.IMDCT_WINDOW, np.float32))
OLA_OUT = 31      # B4: subframes a warp writes (kOlaOut)


def run_schedule(x: torch.Tensor) -> torch.Tensor:
    """dct4_slots then dct4_order on f32 [..., 128]."""
    v = x.clone()
    for ops in STAGES:
        a = torch.tensor([o[0] for o in ops])
        b = torch.tensor([o[1] for o in ops])
        tw = torch.tensor([o[2] for o in ops])
        va, vb = v[..., a], v[..., b]
        if ops[0][2] < 0:
            na, nb = va + vb, va - vb
        else:
            sn, cs = SIN[tw], COS[tw]
            na, nb = va * sn - vb * cs, va * cs + vb * sn
        v = v.clone()
        v[..., a] = na
        v[..., b] = nb
    return v[..., torch.tensor(SLOT_OF)]


def b4_model(x: torch.Tensor) -> torch.Tensor:
    """B4 as the kernel walks it, f32 [R, T, 128] -> [R, T, 128]."""
    R, Tn, _ = x.shape
    tiles = -(-Tn // OLA_OUT)
    t = (torch.arange(tiles)[:, None] * OLA_OUT - 1
         + torch.arange(32)[None, :])                      # [tiles, 32]
    ok = (t >= 0) & (t < Tn)
    rows = torch.where(ok[None, :, :, None], x[:, t.clamp(0, Tn - 1)], 0.0)
    y = run_schedule(rows)                                 # [R, tiles, 32, 128]
    carry = torch.where((t >= 0)[None, :, :, None], y[..., :64], 0.0)
    prev = torch.cat([carry[:, :, :1], carry[:, :, :-1]], 2)   # lane l - 1
    p = torch.arange(64)
    d = y[..., 127 - p]
    lo = WIN[63 - p] * d + WIN[64 + p] * prev              # wave[63 - p]
    hi = WIN[64 + p] * d - WIN[63 - p] * prev              # wave[64 + p]
    wave = torch.cat([torch.flip(lo, [-1]), hi], -1)
    out = torch.empty_like(x)
    keep = ok.clone()
    keep[:, 0] = False                                     # the halo lane
    out[:, t[keep]] = wave[:, keep]
    return out


def spectra(shape, kind: str, seed: int) -> np.ndarray:
    """Seeded f32 rows: normal values, or with signed zeros, huge or tiny
    and subnormal magnitudes mixed in."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 3000).astype(np.float32)
    flat = x.reshape(-1)
    if kind in ("zeros", "mixed"):
        flat[::5] = 0.0
        flat[1::7] = -0.0
        x.reshape(-1, 128)[0] = 0.0                        # an all-zero row
        x.reshape(-1, 128)[-1] = -0.0
    if kind in ("huge", "mixed"):
        flat[2::11] = rng.choice([1.0e30, -1.0e30, 1.0e34, -1.0e34],
                                 flat[2::11].shape)
    if kind in ("tiny", "mixed"):
        sub = rng.integers(1, 1 << 23, flat[3::13].shape).astype(np.uint32)
        sign = rng.integers(0, 2, sub.shape).astype(np.uint32) << 31
        flat[3::13] = (sub | sign).view(np.float32)        # subnormals
        flat[4::17] = rng.choice([1.0e-30, -1.0e-30, 1.2e-38], flat[4::17]
                                 .shape)
    return x


def bits_equal(got: np.ndarray, want: np.ndarray) -> None:
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    assert not np.isnan(want).any()
    g = np.where(got == 0, 0, got.view(np.int32))
    w = np.where(want == 0, 0, want.view(np.int32))
    np.testing.assert_array_equal(g, w)


KINDS = ["normal", "zeros", "huge", "tiny", "mixed"]


@pytest.mark.parametrize("kind", KINDS)
def test_schedule_matches_twin_and_pallas(kind):
    x = spectra((300, 128), kind, seed=KINDS.index(kind))
    got = run_schedule(torch.from_numpy(x)).numpy()
    bits_equal(got, K.imdct_butterflies(torch.from_numpy(x)).numpy())
    bits_equal(got, np.asarray(pallas_kernels.imdct_pallas(
        jnp.asarray(x), interpret=True)))


@pytest.mark.parametrize("R,Tn,kind", [
    (3, 300, "mixed"), (1, 1, "normal"), (2, 31, "zeros"), (2, 32, "huge"),
    (1, 62, "tiny"), (4, 37, "mixed"),
])
def test_b4_model_matches_twin_and_pallas(R, Tn, kind):
    """T of 1, one tile, one tile plus one, two tiles, a ragged tile."""
    x = spectra((R, Tn, 128), kind, seed=R * 1000 + Tn)
    got = b4_model(torch.from_numpy(x)).numpy()
    bits_equal(got, K.imdct_ola_plain(torch.from_numpy(x)).numpy())
    bits_equal(got, np.asarray(pallas_kernels.imdct_ola_pallas(
        jnp.asarray(x), interpret=True)))


def test_generated_source_is_the_schedule():
    """Every butterfly line of hca_dct4.inc, in order, names the schedule's
    slots and its twiddles' bits; dct4_order names slot_of."""
    src = _build.dct4_source()
    body = src.split("dct4_order")[0]
    addsub = re.compile(r"a = v\[(\d+)\]; b = v\[(\d+)\]; v\[(\d+)\] = "
                        r"__fadd_rn\(a, b\); v\[(\d+)\] = __fsub_rn\(a, b\);")
    twid = re.compile(
        r"a = v\[(\d+)\]; b = v\[(\d+)\]; v\[(\d+)\] = __fsub_rn\(__fmul_rn"
        r"\(a, (\S+)f\), __fmul_rn\(b, (\S+)f\)\); v\[(\d+)\] = __fadd_rn\("
        r"__fmul_rn\(a, (\S+)f\), __fmul_rn\(b, (\S+)f\)\);")
    lines = [ln.strip() for ln in body.splitlines()
             if ln.strip().startswith("a = v[")]
    ops = [op for stage in STAGES for op in stage]
    assert len(lines) == len(ops) == 14 * 64
    for ln, (a, b, tw) in zip(lines, ops):
        if tw < 0:
            m = addsub.fullmatch(ln)
            assert m and [int(g) for g in m.groups()] == [a, b, a, b], ln
        else:
            m = twid.fullmatch(ln)
            assert m, ln
            assert [int(m.group(i)) for i in (1, 2, 3, 6)] == [a, b, a, b]
            sn, cs = (np.float32(float.fromhex(m.group(i))) for i in (4, 7))
            assert sn.view(np.int32) == SIN[tw].numpy().view(np.int32)
            assert cs.view(np.int32) == COS[tw].numpy().view(np.int32)
            assert m.group(5) == m.group(7) and m.group(4) == m.group(8)
    order = re.findall(r"y\[(\d+)\] = v\[(\d+)\];", src)
    assert [(int(l), int(s)) for l, s in order] == list(enumerate(SLOT_OF))
    assert sorted(SLOT_OF) == list(range(128))
