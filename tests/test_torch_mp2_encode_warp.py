"""PyTorch port, the warps of kernels K2 `mp2_allocate` and K3 `mp2_pack` on
the CPU: numpy models.

K2 (pycricodecs_tpu_torch/csrc/mp2_encode.cu) gives each (stream, frame)
one warp, lane = subband, a slot per channel (for C = 2 the lane's (sb, 0)
and (sb, 1)), and reads K1's part peaks, need_db and S. A lane's
scalefactor index is the count of scalefactors >= peak - 1e-12 less one,
found by bisection over the 63 strictly decreasing scalefactors (held here
to the reference's count on every scalefactor, its neighbours one ulp
away, and random peaks); at joint subbands the mid signal's part peaks
come from S. Each greedy step, a lane offers its best ok slot (slot 0
first, so it wins a tie) as (gain, flat index ch * sblimit + sb); a 5-step
xor butterfly keeps the larger gain, the lower index on a tie, so every
lane ends with numpy's argmax (its first maximum); the step stops when no
lane offers one (every gain -inf); the chosen slot's cost comes from its
lane by a shuffle. The quantisation reads S one (channel, 12-row part)
block at a time from a per-warp ring (channel 0's block holds channel 1's
rows beside it in a joint configuration, for the mid signal) and takes
((s / sf) * n + n - 1) * 0.5 + 0.5, the reference's / 2 as a multiply. The
model runs those steps lane by lane in numpy (the butterfly as its 5
rounds of partner exchanges, the ring's blocks in the kernel's fetch
order) on its own reading of models/ahx.py's arithmetic and is held
byte-equal to the twin `allocate_plain` (alloc, scfsi, sfidx, codes) on
analysed random signals of mono, stereo and joint bounds 4-16 and every
allocation table, and, fed the JAX `analyze_fast` spectra of an
encode_mp2 call (recorded by a monkeypatch), packed by the twin, to that
call's bytes; the butterfly alone is held to np.argmax on random gains
full of ties and -inf.

K3 is a persistent grid of warps, each walking frames w, w + warps, ...
with (stream, frame) stepped incrementally; a warp packs its frame with
lane = subband: the header from lane 0, the allocation laid out by a
frame-independent warp scan, the scfsi, scalefactor and sample sections
by one exclusive warp scan (Hillis-Steele, 5 shuffle-up rounds) of the
lanes' three widths packed as 8, 11 and 12 bits. A lane builds its fields
of a section as one run (a field that would pass the frame end dropped
whole, and every later one with it); where the whole sample section fits
the frame, a slot's fields of a granule are one value. The run goes into
a zeroed big-endian word buffer: its first word and a last one it covers
in part by OR, the words between (no other lane touches them) by plain
stores. The frame goes out at its byte offset: the bytes before the first
4-byte boundary and after the last one by lanes one at a time, the rest as
aligned 4-byte stores built by a funnel shift and a byte swap. The model
does exactly that (checking that no plainly stored word is touched by
another lane, that no byte outside the frame is written and that the walk
writes every byte of a 0xA5-poisoned batch once) and is held to the JAX
package's `pack_frame` / `pack_frames` on random alloc/scfsi/sfidx/codes
of every table and mode (mono, stereo, joint bounds 4-16, the 1,728-byte
frames of 32 kHz 384 kbps stereo), and so is the twin `pack_plain`; on
frames whose fields run past their end, model and twin agree, and hold
pack_frame's bits up to the first field that does not fit and zeros
after it.

Tolerance: exact (bytes, indices).
"""
import numpy as np
import pytest
import torch

from pycricodecs_tpu.models import ahx as jax_ahx
from pycricodecs_tpu.ops import mp2_frame as jax_frame
from pycricodecs_tpu.ops import mp2_kernels as jax_kernels
from pycricodecs_tpu_torch.ops import mp2_encode_device as E
from pycricodecs_tpu_torch.ops import mp2_encode_host as EH
from pycricodecs_tpu_torch.ops import mp2_kernels as MK
from pycricodecs_tpu_torch.ops import mp2_tables as T

SF = T.scalefactors()
# (channels, rate, kbps, joint bound): every allocation table, mono,
# stereo, joint bounds 4-16
CONFIGS = [
    (1, 22050, 96, None), (1, 16000, 32, None), (2, 24000, 160, None),
    (1, 48000, 32, None), (2, 32000, 48, None), (2, 48000, 384, None),
    (1, 32000, 320, None), (2, 44100, 192, None), (2, 44100, 192, 4),
    (2, 48000, 256, 8), (2, 32000, 128, 12), (2, 44100, 320, 16),
    (2, 32000, 384, None),      # 1,728-byte frames: Layer II's largest
]
IDS = [f"{c}ch-{r}-{k}-j{j}" for c, r, k, j in CONFIGS]


# -- K2 ---------------------------------------------------------------------------

def butterfly(g: np.ndarray, i: np.ndarray):
    """The warp argmax: lanes' (gain, index) pairs [32] -> every lane's
    result after 5 xor rounds (larger gain, lower index on a tie)."""
    g, i = g.copy(), i.copy()
    lanes = np.arange(32)
    for d in (16, 8, 4, 2, 1):
        og, oi = g[lanes ^ d], i[lanes ^ d]
        take = (og > g) | ((og == g) & (oi < i))
        g, i = np.where(take, og, g), np.where(take, oi, i)
    return g, i


@pytest.mark.parametrize("C,sblimit", [(1, 8), (1, 30), (2, 12), (2, 27),
                                       (2, 30)])
def test_butterfly_is_numpys_first_argmax(C, sblimit):
    rng = np.random.default_rng(sblimit * C)
    for _ in range(300):
        flat = rng.choice([-np.inf, -3.5, 0.0, 1.25, 7.0], C * sblimit,
                          p=[0.4, 0.15, 0.15, 0.15, 0.15])
        g = np.full(32, -np.inf)
        i = np.full(32, 0x7FFFFFFF)
        for sb in range(sblimit):            # a lane's best slot, slot 0 first
            for c in range(C):
                v = flat[c * sblimit + sb]
                if v != -np.inf and v > g[sb]:
                    g[sb], i[sb] = v, c * sblimit + sb
        gw, iw = butterfly(g, i)
        assert (gw == gw[0]).all() and (iw == iw[0]).all()
        if np.isfinite(flat).any():
            assert iw[0] == np.argmax(flat) and gw[0] == flat.max()
        else:
            assert iw[0] == 0x7FFFFFFF


def sf_index(peak):
    """K2's bisection: the count of SF[0..62] >= peak - 1e-12, less one,
    floored at 0 (peak [32] -> [32])."""
    thr = peak - 1e-12
    cnt = np.zeros(peak.shape, np.int64)
    for step in (32, 16, 8, 4, 2, 1):
        probe = np.minimum(cnt + step - 1, 62)
        cnt = np.where((cnt + step <= 63) & (SF[probe] >= thr), cnt + step,
                       cnt)
    return np.maximum(cnt, 1) - 1


def ring_blocks(C, joint):
    """The quantisation's blocks in K2's fetch order: (channel, part, rows
    of S the ring holds, as (channel, first row) pairs)."""
    return [(c, p, [(c, 12 * p)] + ([(1, 12 * p)] if joint and c == 0
                                    else []))
            for c in range(C) for p in range(3)]


def k2_model(Sf, part, need, budget, cfg):
    """One frame: Sf f64 [C, 36, 32], K1's part peaks f64 [C, 3, 32], need
    f64 [C, 32], budget -> (alloc as transmitted [C, 32], scfsi [C, 32],
    sfidx [C, 3, 32], codes [C, 36, 32]), lane by lane as the kernel
    orders it."""
    C = Sf.shape[0]
    SB, bound, joint = cfg.sblimit, cfg.bound, cfg.joint
    lanes = np.arange(32)
    live = lanes < SB
    shared = joint & (lanes >= bound)

    sfi = np.stack([np.stack([sf_index(part[c, p]) for p in range(3)])
                    for c in range(C)])                          # [C, 3, 32]
    e01, e12 = sfi[:, 0] == sfi[:, 1], sfi[:, 1] == sfi[:, 2]
    sc = np.where(e01, np.where(e12, 2, 1), np.where(e12, 3, 0))
    sfb = np.where(sc == 2, 6, np.where(sc == 0, 18, 12))
    fc = 2 + sfb
    nd = need.copy()
    sfj = np.zeros((3, 32), np.int64)
    if joint:
        mid = (Sf[0] + Sf[1]) * 0.5
        sfj = np.stack([sf_index(np.abs(mid[12 * p:12 * p + 12]).max(0))
                        for p in range(3)])
        fc[0] = np.where(shared, 4 + sfb[0] + sfb[1], fc[0])
        nd[0] = np.where(shared, np.where(nd[1] > nd[0], nd[1], nd[0]),
                         nd[0])
    ncls = np.where(live, cfg.ncls, 0)
    al = np.zeros((C, 32), np.int64)
    spent = 0
    while True:
        g = np.full(32, -np.inf)
        i = np.full(32, 0x7FFFFFFF)
        cost = np.zeros((C, 32), np.int64)
        for c in range(C):
            for sb in range(32):
                a = al[c, sb]
                if not live[sb] or a + 1 >= ncls[sb] or (c == 1 and
                                                         shared[sb]):
                    continue
                cost[c, sb] = (cfg.bits_tbl[sb, a + 1] - cfg.bits_tbl[sb, a]
                               + (fc[c, sb] if a == 0 else 0))
                gain = nd[c, sb] - cfg.snr_tbl[sb, a]        # a < ncls - 1
                if gain > -60.0 and spent + cost[c, sb] <= budget and \
                        gain > g[sb]:
                    g[sb], i[sb] = gain, c * SB + sb
        _, iw = butterfly(g, i)
        if iw[0] == 0x7FFFFFFF:
            break
        c_b, owner = divmod(int(iw[0]), SB)
        spent += cost[c_b, owner]            # the shuffle from the owner lane
        al[c_b, owner] += 1
    codes = np.zeros((C, 36, 32), np.uint16)
    for c, p, held in ring_blocks(C, joint):
        ring = np.concatenate([Sf[ch, r0:r0 + 12] for ch, r0 in held])
        n = np.where(live, cfg.levels_tbl[lanes, al[c]], 0).astype(float)
        mid = shared & (c == 0)
        x = np.where(mid, (ring[:12] + ring[12:24]) * 0.5, ring[:12]) \
            if len(held) == 2 else ring[:12]
        sf = SF[np.where(mid, sfj[p], sfi[c, p])]
        t = ((x / sf) * n + n - 1.0) * 0.5 + 0.5
        q = np.minimum(np.maximum(np.floor(t), 0.0), n - 1.0)
        codes[c, 12 * p:12 * p + 12] = np.where(n > 0, q, 0.0).astype(
            np.uint16)
    alloc = np.where(live, al, 0)
    if joint:
        alloc[1] = np.where(shared, alloc[0], alloc[1])
    return alloc, sc, sfi, codes


def test_sf_index_bisection_is_the_reference_count():
    sf = SF[:63]
    ulp = np.spacing(sf)
    probes = np.concatenate([
        sf, sf + 1e-12, sf + 1e-12 + ulp, sf + 1e-12 - ulp, sf - ulp,
        sf + ulp, [0.0, 1e-300, 5e-7, 2.0, 2.5, 1e6],
        np.exp(np.random.default_rng(3).uniform(np.log(1e-8), np.log(4.0),
                                                20000))])
    for chunk in np.array_split(probes, 1 + probes.size // 32):
        peak = np.zeros(32)
        peak[:chunk.size] = chunk
        np.testing.assert_array_equal(sf_index(peak),
                                      jax_ahx._sf_indices(peak))


@pytest.mark.parametrize("cfg_key", CONFIGS, ids=IDS)
def test_k2_model_equals_allocate_plain(cfg_key):
    C, rate, kbps, jb = cfg_key
    cfg = EH.configure(C, rate, kbps, jb)
    rng = np.random.default_rng(kbps + C)
    B, F = 2, 3
    n = F * 1152
    t = np.arange(n)
    pcm = np.stack([np.stack([
        rng.uniform(0, 0.7) * np.sin(2 * np.pi * rng.uniform(0.002, 0.4) * t)
        + rng.uniform(0, 0.2) * rng.standard_normal(n) for _ in range(C)])
        for _ in range(B)])
    pcm[0, :, n // 2:] = 0.0
    pcm = np.clip(np.round(pcm * 32767), -32768, 32767).astype(np.int16)
    S = MK.analyze_plain(torch.from_numpy(pcm))
    part = E.part_peaks_plain(S)
    need = E.need_db_host(E.frame_peaks_plain(S))
    _, _, budgets = cfg.frame_plan(F)
    got = E.allocate_plain(S, part, need, torch.from_numpy(budgets), cfg)
    Sn = S.numpy().reshape(B, C, F, 36, 32)
    for b in range(B):
        for f in range(F):
            want = k2_model(Sn[b, :, f], part[b, f].numpy(),
                            need[b, f].numpy(), budgets[f], cfg)
            for name, g, w in zip(("alloc", "scfsi", "sfidx", "codes"), got,
                                  want):
                np.testing.assert_array_equal(
                    g[b, f].numpy().astype(np.int64), w.astype(np.int64),
                    err_msg=f"{name} stream {b} frame {f}")


@pytest.mark.parametrize("cfg_key", CONFIGS, ids=IDS)
def test_k2_model_on_the_jax_spectra_gives_encode_mp2s_bytes(cfg_key,
                                                             monkeypatch):
    C, rate, kbps, jb = cfg_key
    cfg = EH.configure(C, rate, kbps, jb)
    rng = np.random.default_rng(kbps * 3 + C)
    n = 3 * 1152 - 100
    t = np.arange(n)
    pcm = np.stack([
        rng.uniform(0.1, 0.7) * np.sin(2 * np.pi * rng.uniform(0.002, 0.4) * t)
        + rng.uniform(0, 0.2) * rng.standard_normal(n) for _ in range(C)])
    pcm = np.clip(np.round(pcm * 32767), -32768, 32767).astype(np.int16)
    recorded = []
    analyze = jax_kernels.analyze_fast

    def record(x):
        recorded.append(analyze(x))
        return recorded[-1]

    monkeypatch.setattr(jax_kernels, "analyze_fast", record)
    ref = jax_ahx.encode_mp2(pcm if C == 2 else pcm[0], rate,
                             bitrate_kbps=kbps, joint_bound=jb)
    S = torch.from_numpy(recorded[0])[None]                   # [1, C, T, 32]
    F = S.shape[2] // 36
    part = E.part_peaks_plain(S)
    need = E.need_db_host(E.frame_peaks_plain(S))
    pads, sizes, budgets = cfg.frame_plan(F)
    Sn = S.numpy().reshape(C, F, 36, 32)
    frames = [k2_model(Sn[:, f], part[0, f].numpy(), need[0, f].numpy(),
                       budgets[f], cfg) for f in range(F)]
    out = [torch.from_numpy(np.stack([fr[k] for fr in frames]).astype(
        np.uint8 if k < 3 else np.uint16))[None] for k in range(4)]
    twin = E.allocate_plain(S, part, need, torch.from_numpy(budgets), cfg)
    for name, a, b in zip(("alloc", "scfsi", "sfidx", "codes"), out, twin):
        assert torch.equal(a, b), name
    got = E.pack_plain(*out, cfg, torch.from_numpy(pads), sizes)
    assert got.numpy()[0].tobytes() == ref


# -- K3 ---------------------------------------------------------------------------

def warp_scan(x: np.ndarray):
    """Exclusive Hillis-Steele scan over 32 lanes, and the total."""
    s = x.copy()
    for d in (1, 2, 4, 8, 16):
        up = np.concatenate([np.zeros(d, s.dtype), s[:-d]])   # shfl_up
        s = s + np.where(np.arange(32) >= d, up, 0)
    return s - x, int(s[31])


def word_count(max_frame: int) -> int:
    """K3's word buffer a warp, in 32-bit words: the largest frame's and
    one more, rounded up to 16 bytes (the launcher's nw4, times 4)."""
    return 4 * (((max_frame + 3) // 4 + 1 + 3) // 4)


class Words:
    """A warp's zeroed big-endian word buffer and who wrote each word: a
    word a lane stores plainly must be one no other lane touches."""

    def __init__(self, n: int):
        self.w = [0] * n
        self.plain = {}
        self.ored = {}

    def store(self, i: int, v: int, lane: int) -> None:
        assert self.w[i] == 0 and i not in self.plain, (i, lane)
        self.plain[i] = lane
        self.w[i] = int(v)

    def atomic_or(self, i: int, v: int, lane: int) -> None:
        self.ored.setdefault(i, set()).add(lane)
        self.w[i] |= int(v)

    def check_owners(self) -> None:
        for i, lane in self.plain.items():
            assert i not in self.ored, (i, lane, self.ored[i])


class Run:
    """A lane's run of fields in one section: their bits, how many, where
    the next field starts; a field that would pass fs_bits is dropped whole
    (every later one then passes it too)."""

    def __init__(self, pos: int, fs_bits: int):
        self.bits, self.n, self.end, self.fs_bits = 0, 0, int(pos), fs_bits

    def append(self, v: int, w: int) -> None:
        w = int(w)
        self.end += w
        if self.end > self.fs_bits:
            return
        self.bits = (self.bits << w) | (int(v) & ((1 << w) - 1))
        self.n += w


def emit(words: Words, p: int, run: Run, max_words: int, lane: int) -> None:
    """K3's emit: the run left-aligned in 128 bits at bit p % 32 of its
    first word; its first word and a last one it covers in part ORed, the
    words between stored."""
    if run.n == 0:
        return
    p = int(p)
    span = (p & 31) + run.n
    assert span <= 32 * max_words <= 128, (span, max_words)
    x = run.bits << (128 - span)
    for j in range(max_words):
        if 32 * j >= span:
            break
        wv = (x >> (96 - 32 * j)) & 0xFFFFFFFF
        if j > 0 and 32 * j + 32 <= span:
            words.store((p >> 5) + j, wv, lane)
        else:
            words.atomic_or((p >> 5) + j, wv, lane)


def slot_bits(v, n, g, u) -> int:
    """A slot's three codes of a granule as its fields' bits: one grouped
    field of g bits, or three of u bits (each masked to its width; the
    first two joined in 32 bits, then the third)."""
    m = (1 << int(g or u)) - 1
    if g:
        return ((v[0] + int(n) * (v[1] + int(n) * v[2])) % (1 << 32)) & m
    top = ((v[0] & m) << int(u)) | (v[1] & m)
    assert top < 1 << 32
    return (top << int(u)) | (v[2] & m)


def k3_words(alloc, scfsi, sfidx, codes, cfg, pad, fs, n_words) -> list:
    """One frame's word buffer as K3's warp builds it: the header by lane
    0; the allocation laid out by the frame-independent scan, the scfsi,
    scalefactor and sample sections by one warp scan of the lanes' three
    widths packed as 8, 11 and 12 bits; a lane's fields of a section as one
    run (a lane's channel slots in order) put in by `emit`; the samples
    slot by slot where the whole section fits the frame, else field by
    field."""
    C = alloc.shape[0]
    fs_bits = 8 * fs
    words = Words(n_words)
    lanes = np.arange(32)
    live = lanes < cfg.sblimit
    nch = np.where(live, np.where(lanes < cfg.bound, C, 1), 0)
    a = np.where(live, alloc.astype(np.int64), 0)
    s = scfsi.astype(np.int64)
    if fs_bits >= 32:
        words.store(0, cfg.header_base | (pad << 9), 0)
    nb = cfg.nbal.astype(np.int64)
    apos, atot = warp_scan(nb * nch)
    act = a > 0
    nsf = np.where(act, np.array([3, 2, 1, 2])[s], 0)
    gbits, ubits = E.class_bits(cfg)
    n = np.zeros((C, 32), np.int64)
    g = np.zeros((C, 32), np.int64)
    u = np.zeros((C, 32), np.int64)
    for sb in range(32):
        for c in range(C):
            if c < nch[sb]:
                i = a[c, sb] & 15
                n[c, sb] = cfg.levels_tbl[sb, i]
                g[c, sb], u[c, sb] = gbits[sb, i], ubits[sb, i]
    wq = np.where(n > 0, np.where(g > 0, g, 3 * u), 0)
    ws, wf, wqs = 2 * act.sum(0), 6 * nsf.sum(0), wq.sum(0)
    assert ws.sum() < 1 << 8 and wf.sum() < 1 << 11 and wqs.sum() < 1 << 12
    off, tot = warp_scan(ws | wf << 8 | wqs << 19)
    sf0 = 32 + atot + (tot & 0xFF)
    pos = sf0 + ((tot >> 8) & 0x7FF)
    gran, intra = tot >> 19, off >> 19
    for sb in range(32):
        run = Run(32 + apos[sb], fs_bits)
        for c in range(C):
            if c < nch[sb]:
                run.append(a[c, sb], nb[sb])
        emit(words, 32 + apos[sb], run, 2, sb)
    for sb in range(32):
        p = 32 + atot + (off[sb] & 0xFF)
        run = Run(p, fs_bits)
        for c in range(C):
            if act[c, sb]:
                run.append(s[c, sb], 2)
        emit(words, p, run, 2, sb)
    for sb in range(32):
        p = sf0 + ((off[sb] >> 8) & 0x7FF)
        run = Run(p, fs_bits)
        for c in range(C):
            if nsf[c, sb]:
                run.append(sfidx[c, 0, sb], 6)
            if nsf[c, sb] >= 2:
                run.append(sfidx[c, 2 if s[c, sb] == 1 else 1, sb], 6)
            if nsf[c, sb] == 3:
                run.append(sfidx[c, 2, sb], 6)
        emit(words, p, run, 3, sb)
    if pos + 12 * gran <= fs_bits:
        # every field fits: a lane's slots of a granule as one run, each
        # slot's fields as one value
        for gr in range(12):
            for sb in range(32):
                p = pos + gr * gran + intra[sb]
                run = Run(p, fs_bits)
                for c in range(C):
                    v = [int(codes[c, 3 * gr + k, sb]) for k in range(3)]
                    run.bits = (run.bits << int(wq[c, sb])) | slot_bits(
                        v, n[c, sb], g[c, sb], u[c, sb])
                    run.n += int(wq[c, sb])
                emit(words, p, run, 4 if C == 2 else 3, sb)
        words.check_owners()
        return words.w
    for gr in range(12):
        for sb in range(32):
            p = pos + gr * gran + intra[sb]
            run = Run(p, fs_bits)
            for c in range(C):
                if not n[c, sb]:
                    continue
                v0, v1, v2 = (int(codes[c, 3 * gr + k, sb]) for k in range(3))
                if g[c, sb]:
                    run.append(v0 + n[c, sb] * (v1 + n[c, sb] * v2),
                               g[c, sb])
                else:
                    for v in (v0, v1, v2):
                        run.append(v, u[c, sb])
            assert run.n <= 48 * C
            emit(words, p, run, 4 if C == 2 else 3, sb)
    words.check_owners()
    return words.w


def k3_store(words: list, out: bytearray, dst: int, fs: int) -> None:
    """K3's store of a frame's fs bytes at out[dst:]: the bytes before
    dst's first 4-byte boundary and after the last one by lanes one at a
    time, the rest as aligned 4-byte stores, each the funnel shift of two
    words by 8 * (head bytes) and a byte swap (little-endian store)."""
    h = min((4 - dst % 4) % 4, fs)
    nw = (fs - h) >> 2
    t0 = h + 4 * nw
    assert h <= 32 and fs - t0 <= 32             # a lane a byte
    byte = lambda i: (words[i >> 2] >> (24 - 8 * (i & 3))) & 0xFF  # noqa
    for lane in range(h):
        out[dst + lane] = byte(lane)
    for lane in range(fs - t0):
        out[dst + t0 + lane] = byte(t0 + lane)
    for k in range(nw):
        hi_lo = (words[k] << 32) | words[k + 1]
        v = ((hi_lo << (8 * h)) >> 32) & 0xFFFFFFFF  # __funnelshift_l
        at = dst + h + 4 * k
        assert at % 4 == 0
        swapped = int.from_bytes(v.to_bytes(4, "little"), "big")  # byte_perm
        out[at:at + 4] = swapped.to_bytes(4, "little")


def k3_model(alloc, scfsi, sfidx, codes, cfg, pad, fs, dst=0,
             max_frame=None) -> bytes:
    """One frame's bytes as K3's warp builds and stores them, at byte dst
    of a 0xA5-poisoned buffer; checks that nothing outside the frame is
    written."""
    max_frame = fs if max_frame is None else max_frame
    words = k3_words(alloc, scfsi, sfidx, codes, cfg, pad, fs,
                     word_count(max_frame))
    out = bytearray(b"\xa5" * (dst + fs + 8))
    k3_store(words, out, dst, fs)
    assert out[:dst] == b"\xa5" * dst and out[dst + fs:] == b"\xa5" * 8
    return bytes(out[dst:dst + fs])


def k3_walk(alloc, scfsi, sfidx, codes, cfg, pads, sizes, warps) -> bytes:
    """A [B, F] batch as the persistent kernel walks it with `warps` warps
    in its grid: warp w packs frames w, w + warps, ..., (b, f) stepped
    incrementally, each frame stored at b * total + offs[f] of a
    0xA5-poisoned [B, total] buffer."""
    B, F = alloc.shape[:2]
    offs = E.frame_offsets(sizes)
    total = int(offs[-1])
    n_words = word_count(int(np.max(sizes)))
    out = bytearray(b"\xa5" * (B * total))
    written = np.zeros(B * total, np.int64)
    db, df = divmod(warps, F)
    for w in range(min(warps, B * F)):
        gid, (b, f) = w, divmod(w, F)
        while gid < B * F:
            assert (b, f) == divmod(gid, F)
            fs = int(offs[f + 1] - offs[f])
            words = k3_words(alloc[b, f], scfsi[b, f], sfidx[b, f],
                             codes[b, f], cfg, int(pads[f]), fs, n_words)
            dst = b * total + int(offs[f])
            k3_store(words, out, dst, fs)
            written[dst:dst + fs] += 1
            gid += warps
            b, f = b + db, f + df
            if f >= F:
                b, f = b + 1, f - F
    assert (written == 1).all()
    return bytes(out)


def frame_bits(alloc, scfsi, cfg) -> int:
    """The bits one frame's fields take ([C, 32] alloc and scfsi)."""
    gbits, ubits = E.class_bits(cfg)
    bits = 32 + cfg.nbal_bits
    for sb in range(cfg.sblimit):
        for c in range(cfg.channels):
            a = int(alloc[c, sb])
            if a:
                bits += 2 + 6 * (3, 2, 1, 2)[scfsi[c, sb]]
                if c == 0 or sb < cfg.bound:
                    bits += 12 * (gbits[sb, a] or 3 * ubits[sb, a])
    return bits


def random_frames(rng, cfg, F, overflow=False):
    """Random legal K2 outputs [F, ...] for cfg: allocations drawn per
    subband's classes (the alloc as transmitted), dropped at random until
    the frame's fields fit its smallest size, codes below their class.
    With overflow, every slot is allocated (a class from the upper half of
    its subband's) and nothing is dropped: the fields run past the frame
    end."""
    C = cfg.channels
    SB = cfg.sblimit
    fs_bits = 8 * int(cfg.frame_plan(1)[1][0])
    alloc = np.zeros((F, C, 32), np.uint8)
    for sb in range(SB):
        low = max(1, cfg.ncls[sb] // 2) if overflow else 0
        alloc[:, :, sb] = rng.integers(low, cfg.ncls[sb], (F, C)) * \
            (overflow | (rng.random((F, C)) < 0.6))
    scfsi = rng.integers(0, 4, (F, C, 32)).astype(np.uint8)
    for f in range(F):
        if cfg.joint:
            alloc[f, 1, cfg.bound:SB] = alloc[f, 0, cfg.bound:SB]
        while not overflow and frame_bits(alloc[f], scfsi[f], cfg) > fs_bits:
            sb = rng.integers(0, SB)
            alloc[f, :, sb] = 0 if sb >= cfg.bound else \
                alloc[f, :, sb] * (rng.random(C) < 0.5)
    sfidx = rng.integers(0, 63, (F, C, 3, 32)).astype(np.uint8)
    lv = cfg.levels_tbl[np.arange(32), alloc.astype(np.int64)]   # [F, C, 32]
    codes = (rng.random((F, C, 36, 32)) * np.maximum(lv, 1)[:, :, None, :]) \
        .astype(np.uint16)
    return alloc, scfsi, sfidx, codes


@pytest.mark.parametrize("cfg_key", CONFIGS, ids=IDS)
def test_k3_model_and_twin_equal_pack_frame(cfg_key):
    C, rate, kbps, jb = cfg_key
    cfg = EH.configure(C, rate, kbps, jb)
    rng = np.random.default_rng(kbps * 7 + C)
    F = 5
    pads, sizes, _ = cfg.frame_plan(F)
    alloc, scfsi, sfidx, codes = random_frames(rng, cfg, F)
    SB = cfg.sblimit
    want = []
    for f in range(F):
        hdr = jax_frame.parse_header(
            (cfg.header_base | (int(pads[f]) << 9)).to_bytes(4, "big"))
        want.append(jax_frame.pack_frame(
            hdr, cfg.bitrate_idx, cfg.sr_idx, alloc[f, :, :SB],
            scfsi[f, :, :SB], sfidx[f, :, :, :SB], codes[f, :, :, :SB]))
        # at byte offsets 1..5: every head of 0-3 bytes before a 4-byte
        # boundary
        assert k3_model(alloc[f], scfsi[f], sfidx[f], codes[f], cfg,
                        int(pads[f]), int(sizes[f]), dst=f + 1,
                        max_frame=int(sizes.max())) == want[f]
    twin = E.pack_plain(*(torch.from_numpy(x)[None] for x in
                          (alloc, scfsi, sfidx, codes)), cfg,
                        torch.from_numpy(pads), sizes)
    assert twin.numpy()[0].tobytes() == b"".join(want)
    assert twin.numpy()[0].tobytes() == jax_frame.pack_frames(
        jax_frame.parse_header(cfg.header_base.to_bytes(4, "big")),
        cfg.bitrate_idx, cfg.sr_idx, alloc[:, :, :SB], scfsi[:, :, :SB],
        sfidx[:, :, :, :SB], codes[:, :, :, :SB], pads, sizes)


@pytest.mark.parametrize("warps", [5, 64])
@pytest.mark.parametrize("cfg_key", CONFIGS, ids=IDS)
def test_k3_walk_into_poisoned_streams_equals_pack_frames(cfg_key, warps):
    """The persistent walk (5 warps: 21 frames, not a multiple; 64: more
    warps than frames) fills every byte of a 0xA5-poisoned [B, total]
    buffer with the twin's bytes and, stream by stream, pack_frames'."""
    C, rate, kbps, jb = cfg_key
    cfg = EH.configure(C, rate, kbps, jb)
    rng = np.random.default_rng(kbps * 11 + C + warps)
    B, F = 3, 7
    pads, sizes, _ = cfg.frame_plan(F)
    parts = [random_frames(rng, cfg, F) for _ in range(B)]
    alloc, scfsi, sfidx, codes = (np.stack(x) for x in zip(*parts))
    got = k3_walk(alloc, scfsi, sfidx, codes, cfg, pads, sizes, warps)
    twin = E.pack_plain(*(torch.from_numpy(x) for x in
                          (alloc, scfsi, sfidx, codes)), cfg,
                        torch.from_numpy(pads), sizes)
    assert got == twin.numpy().tobytes()
    total = len(got) // B
    SB = cfg.sblimit
    for b in range(B):
        assert got[b * total:(b + 1) * total] == jax_frame.pack_frames(
            jax_frame.parse_header(cfg.header_base.to_bytes(4, "big")),
            cfg.bitrate_idx, cfg.sr_idx, alloc[b, :, :, :SB],
            scfsi[b, :, :, :SB], sfidx[b, :, :, :, :SB],
            codes[b, :, :, :, :SB], pads, sizes)


def field_widths(alloc, scfsi, cfg):
    """The widths of one frame's fields in pack_frame's order."""
    gbits, ubits = E.class_bits(cfg)
    SB, bound, C = cfg.sblimit, cfg.bound, cfg.channels
    slots = [(sb, c) for sb in range(SB) for c in range(C if sb < bound
                                                        else 1)]
    widths = [32] + [int(cfg.nbal[sb]) for sb, _ in slots]
    act = [(sb, c) for sb in range(SB) for c in range(C) if alloc[c, sb]]
    widths += [2] * len(act)
    widths += [6] * sum((3, 2, 1, 2)[scfsi[c, sb]] for sb, c in act)
    for _ in range(12):
        for sb, c in slots:
            a = int(alloc[c, sb])
            if cfg.levels_tbl[sb, a]:
                widths += [gbits[sb, a]] if gbits[sb, a] else [ubits[sb, a]] * 3
    return widths


@pytest.mark.parametrize("cfg_key", CONFIGS, ids=IDS)
def test_k3_drops_fields_past_the_frame_end_whole(cfg_key):
    """Frames whose fields run past their end: the model equals the twin;
    both hold pack_frame's bits before the first field that does not fit
    and zeros from there (that field and every later one dropped whole:
    pack_frame's BitWriter, which keeps its position on a drop, may still
    write a later, narrower field there; every frame the encoder makes
    fits, where the three agree). Where even these allocations fit the
    configuration's frames (its highest rates), the frames are cut to 3/4
    of the bytes the fields take."""
    C, rate, kbps, jb = cfg_key
    cfg = EH.configure(C, rate, kbps, jb)
    rng = np.random.default_rng(kbps * 13 + C)
    F = 4
    pads, sizes, _ = cfg.frame_plan(F)
    alloc, scfsi, sfidx, codes = random_frames(rng, cfg, F, overflow=True)
    need = np.array([sum(field_widths(alloc[f], scfsi[f], cfg))
                     for f in range(F)])
    sizes = np.where(need > 8 * sizes, sizes, 3 * need // 32)
    twin = E.pack_plain(*(torch.from_numpy(x)[None] for x in
                          (alloc, scfsi, sfidx, codes)), cfg,
                        torch.from_numpy(pads), sizes).numpy()[0]
    offs = E.frame_offsets(sizes)
    SB = cfg.sblimit
    for f in range(F):
        fs = int(sizes[f])
        got = k3_model(alloc[f], scfsi[f], sfidx[f], codes[f], cfg,
                       int(pads[f]), fs, dst=3, max_frame=fs)
        assert got == twin[offs[f]:offs[f + 1]].tobytes()
        ends = np.cumsum(field_widths(alloc[f], scfsi[f], cfg))
        first = int(np.argmax(ends > 8 * fs))
        assert ends[-1] > 8 * fs and first > 0     # the drop branch runs
        cut = int(ends[first - 1])                 # where the drop starts
        hdr = jax_frame.parse_header(
            (cfg.header_base | (int(pads[f]) << 9)).to_bytes(4, "big"))
        ref = jax_frame.pack_frame(
            hdr, cfg.bitrate_idx, cfg.sr_idx, alloc[f, :, :SB],
            scfsi[f, :, :SB], sfidx[f, :, :, :SB], codes[f, :, :, :SB])
        bits = np.unpackbits(np.frombuffer(got, np.uint8))
        ref_bits = np.unpackbits(np.frombuffer(ref, np.uint8))
        np.testing.assert_array_equal(bits[:cut], ref_bits[:cut])
        assert not bits[cut:].any()


def test_pack_frame_and_header_word_copies_equal_jax():
    from pycricodecs_tpu_torch.ops import mp2_frame as port_frame
    rng = np.random.default_rng(5)
    for cfg_key in CONFIGS:
        cfg = EH.configure(*cfg_key)
        pads, sizes, _ = cfg.frame_plan(2)
        alloc, scfsi, sfidx, codes = random_frames(rng, cfg, 2)
        SB = cfg.sblimit
        hdr = port_frame.parse_header(cfg.header_base.to_bytes(4, "big"))
        args = (cfg.bitrate_idx, cfg.sr_idx, alloc[1, :, :SB],
                scfsi[1, :, :SB], sfidx[1, :, :, :SB], codes[1, :, :, :SB])
        assert port_frame.pack_frame(hdr, *args) == jax_frame.pack_frame(
            jax_frame.parse_header(cfg.header_base.to_bytes(4, "big")), *args)
        for padding in (0, 1):
            assert port_frame.header_word(
                cfg.version, cfg.bitrate_idx, cfg.sr_idx, padding, cfg.mode,
                cfg.mode_ext) == jax_frame.header_word(
                cfg.version, cfg.bitrate_idx, cfg.sr_idx, padding, cfg.mode,
                cfg.mode_ext)
