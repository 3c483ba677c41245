"""PyTorch port, the tile of kernel K1 `mp2_analysis` on the CPU: a numpy
model of its CTA.

K1 (pycricodecs_tpu_torch/csrc/mp2_analysis.cu) walks tiles of 72 blocks
(two whole frames) of one (stream, channel) row with 6 warps, a warp per
12-row part. A tile stages its PCM and the 15 blocks before it as
doubles: chunk i (8 samples, 16 bytes, zeros outside the row) goes to lane
i % 32, which writes its four 16-byte pieces in the rotated order
(e + i / 2) % 4. Warp w owns rows 12w .. 12w + 11; per half h of q:
- fold: lane m walks, for each parity p, rows base + 2i (base = 12w + p,
  i < 6) with 13 samples xw[k] (staged row base + 1 - h + 2k, sample
  31 - m) and its 8 taps C[32h + m + 64r]: Y = 0.0, then
  Y += C[..r] * xw[i + 7 - r] for r = 0..7; the warp keeps Y q-major,
  Yq[q - 32h][t - 12w], rows of 14 doubles;
- matrixing: lane (rg = lane / 16, kg = lane % 16) adds
  Y[12w + 6rg + i][q] * Mt[q][2kg + j] to its 6 x 2 sums, q in order, the
  first product alone; its 6 Y values are three 16-byte words of Yq, its
  2 Mt values one.
Epilogue: S; each lane's max |S| over its 6 rows, the xor shuffle 16
(across rg), lanes rg = 0 write the part peak; the frame peak is the max
of the frame's three parts (through shared memory). A warp reads only the
Y rows it folded (warp barriers inside a tile).

The model runs exactly those index maps and that operation order (numpy
float64, one rounding per operation) and is held bit for bit (int64
views) to the twins `analyze_plain`, `part_peaks_plain` and
`frame_peaks_plain`, and to the JAX host lane's part and frame peaks
(models/ahx.py:170-192's reductions) of the same spectra, on random PCM of
1-9 frames (odd frame counts end in half a tile), mono and stereo, every
row's first tile reading the zero halo. It also counts the shared-memory wavefronts of each warp access of
the design by the bank model (a bank is 4 bytes, 32 banks; a wavefront
serves one word a bank, words equal across lanes once) and holds them to
the design's counts, with the alignment of its 16-byte loads. The port's
part peaks of the JAX `analyze_fast` spectra equal the JAX lane's own
reduction of them.

Tolerance: exact (bits), and the wavefront counts.
"""
import numpy as np
import pytest
import torch

from pycricodecs_tpu.ops import mp2_kernels as jax_kernels
from pycricodecs_tpu_torch.ops import mp2_encode_device as E
from pycricodecs_tpu_torch.ops import mp2_kernels as MK
from pycricodecs_tpu_torch.ops import mp2_tables as T

FRAMES, WARPS, HALO, YSTRIDE = 2, 6, 15, 14
TILE = 36 * FRAMES
WROWS = TILE // WARPS
STAGED = TILE + HALO
LANES = np.arange(32)
WARP = np.arange(WARPS)
RG, KG = LANES >> 4, LANES & 15
R2, K16, I6, J2 = np.arange(2), np.arange(16), np.arange(6), np.arange(2)


def fold_rows(warp, h, p):
    """Warp `warp`'s base row of parity p and its 13 staged sample rows."""
    base = WROWS * warp + p
    return base, base + 1 - h + 2 * np.arange(13)


def stage(pcm_row: np.ndarray, t0: int) -> np.ndarray:
    """The tile's staged doubles [87 * 32], written as the kernel's lanes
    write them (each piece exactly once)."""
    T_rows = pcm_row.size // 32
    xs = np.full(STAGED * 32, np.nan)
    written = np.zeros(STAGED * 32, np.int64)
    for i in range(STAGED * 4):
        j = t0 - HALO + (i >> 2)
        v = (pcm_row[j * 32 + (i & 3) * 8:j * 32 + (i & 3) * 8 + 8]
             if 0 <= j < T_rows else np.zeros(8, np.int16))
        rot = (i >> 1) & 3
        for e in range(4):
            c = (e + rot) & 3
            for s in (2 * c, 2 * c + 1):
                xs[i * 8 + s] = float(v[s]) * 2.0 ** -15
                written[i * 8 + s] += 1
    assert (written == 1).all()
    return xs


def k1_model(pcm: np.ndarray):
    """PCM i16 [B, C, F * 1152] -> (S [B, C, F * 36, 32], part peaks
    [B, F, C, 3, 32], frame peaks [B, F, C, 32]), tile by tile as K1."""
    B, C, N = pcm.shape
    Tn = N // 32
    F = Tn // 36
    win = T.analysis_window()
    Mt = np.ascontiguousarray(T.analysis_matrix().T)          # [64, 32]
    S = np.full((B * C, Tn, 32), np.nan)
    part = np.full((B, F, C, 3, 32), np.nan)
    frame = np.full((B, F, C, 32), np.nan)
    rows = pcm.reshape(B * C, N)
    ycol = 6 * R2[:, None] + I6                               # [rg, i]
    for row in range(B * C):
        b, c = divmod(row, C)
        for tt in range(-(-F // FRAMES)):
            t0 = TILE * tt
            xs = stage(rows[row], t0)
            pk = np.full((3 * FRAMES, 32), np.nan)
            for warp in WARP:
                if FRAMES * tt + warp // 3 >= F:
                    continue                                   # past the end
                acc = np.zeros((2, 16, 6, 2))                 # rg, kg, i, j
                for h in range(2):
                    Yq = np.full(32 * YSTRIDE, np.nan)
                    q = 32 * h + LANES
                    w = win[q[:, None] + 64 * np.arange(8)]    # [32, 8]
                    for p in range(2):
                        base, srows = fold_rows(warp, h, p)
                        xw = xs[srows[:, None] * 32 + 31 - LANES]  # [13,32]
                        for i in range(6):
                            y = np.zeros(32)
                            for r in range(8):
                                y = y + w[:, r] * xw[i + 7 - r]
                            Yq[LANES * YSTRIDE + p + 2 * i] = y
                    for qq in range(32):
                        yv = Yq[qq * YSTRIDE + ycol]                 # rg, i
                        mv = Mt[32 * h + qq, 2 * K16[:, None] + J2]  # kg, j
                        prod = yv[:, None, :, None] * mv[None, :, None, :]
                        acc = prod if (h == 0 and qq == 0) else acc + prod
                pm = np.abs(acc).max(2)                        # [rg, kg, j]
                pm = np.maximum(pm, pm[R2 ^ 1])                # xor 16
                prt = warp                                     # tile's part
                f = FRAMES * tt + prt // 3
                for rg in range(2):
                    if f < F:
                        t = t0 + WROWS * warp + 6 * rg + I6[None, :, None]
                        k = 2 * K16[:, None, None] + J2        # [kg, 1, j]
                        S[row, t, k] = acc[rg]
                if f < F:
                    part[b, f, c, prt % 3, 2 * K16[:, None] + J2] = pm[0]
                pk[prt, 2 * K16[:, None] + J2] = pm[0]
            for fr in range(FRAMES):
                f = FRAMES * tt + fr
                if f < F:
                    frame[b, f, c] = pk[3 * fr:3 * fr + 3].max(0)
    return S.reshape(B, C, Tn, 32), part, frame


def bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float64)).view(np.int64)


def random_pcm(rng, B, C, F) -> np.ndarray:
    n = F * 1152
    t = np.arange(n)
    x = np.stack([np.stack([
        rng.uniform(0, 0.9) * np.sin(2 * np.pi * rng.uniform(0.001, 0.45) * t)
        + rng.uniform(0, 0.3) * rng.standard_normal(n) for _ in range(C)])
        for _ in range(B)])
    x[0, :, : n // 3] = 0.0
    return np.clip(np.round(x * 32767), -32768, 32767).astype(np.int16)


@pytest.mark.parametrize("B,C,F", [(1, 1, 1), (2, 1, 2), (1, 2, 3),
                                   (2, 2, 5), (1, 1, 9)])
def test_k1_model_equals_the_twins_and_the_jax_peaks(B, C, F):
    rng = np.random.default_rng(100 * B + 10 * C + F)
    pcm = random_pcm(rng, B, C, F)
    S, part, frame = k1_model(pcm)
    S_t = MK.analyze_plain(torch.from_numpy(pcm))
    np.testing.assert_array_equal(bits(S), bits(S_t.numpy()))
    np.testing.assert_array_equal(bits(part),
                                  bits(E.part_peaks_plain(S_t).numpy()))
    np.testing.assert_array_equal(bits(frame),
                                  bits(E.frame_peaks_plain(S_t).numpy()))
    for b in range(B):
        # the JAX host lane's reductions (models/ahx.py:170-192)
        peaks = np.abs(S[b]).reshape(C, F, 3, 12, 32).max(axis=3)
        np.testing.assert_array_equal(bits(part[b].transpose(1, 0, 2, 3)),
                                      bits(peaks))
        np.testing.assert_array_equal(bits(frame[b].transpose(1, 0, 2)),
                                      bits(peaks.max(axis=2)))


def test_part_peaks_of_the_jax_spectra_equal_the_jax_lane():
    rng = np.random.default_rng(7)
    pcm = random_pcm(rng, 1, 2, 5)[0]
    S = jax_kernels.analyze_fast(pcm / 32768.0)                # [C, F*36, 32]
    ref = np.abs(S).reshape(2, 5, 3, 12, 32).max(axis=3)
    got = E.part_peaks_plain(torch.from_numpy(S)[None])[0]
    np.testing.assert_array_equal(bits(got.permute(1, 0, 2, 3).numpy()),
                                  bits(ref))


def test_every_y_row_is_folded_once_by_its_warp_from_inside_the_stage():
    for h in range(2):
        for warp in WARP:
            seen = np.zeros(TILE, np.int64)
            for p in range(2):
                base, srows = fold_rows(warp, h, p)
                assert srows.min() >= 0 and srows.max() < STAGED
                seen[base + 2 * np.arange(6)] += 1
            # exactly the rows its matrixing reads, each at its own column
            assert (np.flatnonzero(seen) == WROWS * warp
                    + np.arange(WROWS)).all()
            assert seen.max() == 1
    cols = 6 * R2[:, None] + I6
    assert sorted(cols.ravel()) == list(range(WROWS)) and WROWS < YSTRIDE


def wavefronts(byte_addrs, width: int) -> int:
    """Wavefronts of one warp access: the distinct `width`-byte words it
    touches, grouped by bank; a bank serves one 4-byte word a wavefront,
    and words equal across lanes are served once."""
    words = {(a // 4 + k) for a in np.unique(byte_addrs)
             for k in range(width // 4)}
    per_bank = {}
    for wd in words:
        per_bank.setdefault(wd % 32, set()).add(wd)
    return max(len(v) for v in per_bank.values())


def test_the_designs_shared_memory_accesses_take_their_wavefronts():
    # staging: a warp's 16-byte raw loads and rotated 16-byte stores, lanes
    # on neighbouring chunks (quarter-warps apart in time): 4 wavefronts
    for first in range(0, STAGED * 4 - 32, 32):
        i = first + LANES
        assert sum(wavefronts(i[g:g + 8] * 16, 16)
                   for g in range(0, 32, 8)) == 4
        for e in range(4):
            addr = i * 64 + ((e + ((i >> 1) & 3)) & 3) * 16
            assert sum(wavefronts(addr[g:g + 8], 16)
                       for g in range(0, 32, 8)) == 4
    xs_off, y_off = 0, STAGED * 32 * 8
    mt_off = y_off + WARPS * 32 * YSTRIDE * 8
    assert y_off % 16 == 0 and mt_off % 16 == 0
    for h in range(2):
        for warp in WARP:
            yq = y_off + warp * 32 * YSTRIDE * 8
            for p in range(2):
                base, srows = fold_rows(warp, h, p)
                for r in srows:                               # fold loads
                    assert wavefronts(xs_off + (r * 32 + 31 - LANES) * 8,
                                      8) == 2
                for i in range(6):                            # Yq stores
                    assert wavefronts(yq + (LANES * YSTRIDE + p + 2 * i) * 8,
                                      8) == 4
            for qq in range(32):                              # matrixing
                row0 = yq + (qq * YSTRIDE + 6 * RG) * 8
                for v in range(3):                            # Y: 16 bytes
                    assert (row0 + 16 * v).min() % 16 == 0
                    assert wavefronts(row0 + 16 * v, 16) == 1
                addr = mt_off + ((32 * h + qq) * 32 + 2 * KG) * 8   # Mt
                assert addr.min() % 16 == 0 and wavefronts(addr, 16) == 2


def test_k1_refuses_partial_frames():
    from pycricodecs_tpu_torch.ops import cuda_kernels as K
    before = K.MP2_ANALYSIS_LAUNCHES
    with pytest.raises(ValueError, match="whole frames"):
        K.mp2_analysis(torch.zeros((1, 1, 1152 + 32), dtype=torch.int16))
    assert K.MP2_ANALYSIS_LAUNCHES == before
