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

K3 gives each frame one warp, lane = subband: the header from lane 0, and
each of the four sections laid out by one exclusive warp scan of the lanes'
field widths (Hillis-Steele: 5 shuffle-up rounds), each field ORed into a
zeroed big-endian 32-bit word buffer (split over two words where it
crosses one), then the frame's bytes read out of the words. The model does
exactly that and is held to the JAX package's `pack_frame` on random
alloc/scfsi/sfidx/codes of every table and mode (mono, stereo, joint
bounds 4-16), and so is the twin `pack_plain`.

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


def k3_model(alloc, scfsi, sfidx, codes, cfg, pad, fs):
    """One frame's bytes as K3's warp writes them."""
    C = alloc.shape[0]
    words = np.zeros(fs // 4 + 2, np.uint64)
    fs_bits = fs * 8

    def put(pos, w, v):
        if w <= 0 or pos + w > fs_bits:
            return
        v = int(v) & ((1 << w) - 1)
        i, bit = pos >> 5, pos & 31
        if bit + w <= 32:
            words[i] |= np.uint64(v << (32 - bit - w))
        else:
            words[i] |= np.uint64(v >> (bit + w - 32))
            words[i + 1] |= np.uint64((v << (64 - bit - w)) & 0xFFFFFFFF)

    lanes = np.arange(32)
    live = lanes < cfg.sblimit
    nch = np.where(live, np.where(lanes < cfg.bound, C, 1), 0)
    put(0, 32, cfg.header_base | (pad << 9))
    nb = cfg.nbal.astype(np.int64)
    off, tot = warp_scan(nb * nch)
    for sb in range(32):
        for c in range(nch[sb]):
            put(32 + off[sb] + c * nb[sb], nb[sb], alloc[c, sb])
    pos = 32 + tot
    a = np.where(live, alloc, 0)
    act = a > 0
    off, tot = warp_scan(2 * act.sum(0))
    for sb in range(32):
        p = pos + off[sb]
        for c in range(C):
            if act[c, sb]:
                put(p, 2, scfsi[c, sb])
                p += 2
    pos += tot
    nsf = np.where(act, np.array([3, 2, 1, 2])[scfsi], 0)
    off, tot = warp_scan(6 * nsf.sum(0))
    for sb in range(32):
        p = pos + off[sb]
        for c in range(C):
            if not nsf[c, sb]:
                continue
            s = scfsi[c, sb]
            put(p, 6, sfidx[c, 0, sb])
            if nsf[c, sb] >= 2:
                put(p + 6, 6, sfidx[c, 2 if s == 1 else 1, sb])
            if nsf[c, sb] == 3:
                put(p + 12, 6, sfidx[c, 2, sb])
            p += 6 * nsf[c, sb]
    pos += tot
    gbits, ubits = E.class_bits(cfg)
    n = np.zeros((2, 32), np.int64)
    g = np.zeros((2, 32), np.int64)
    u = np.zeros((2, 32), np.int64)
    for sb in range(32):
        for c in range(nch[sb]):
            n[c, sb] = cfg.levels_tbl[sb, a[c, sb]]
            g[c, sb] = gbits[sb, a[c, sb]]
            u[c, sb] = ubits[sb, a[c, sb]]
    wq = np.where(n > 0, np.where(g > 0, g, 3 * u), 0)
    intra, gran = warp_scan(wq.sum(0))
    for gr in range(12):
        for sb in range(32):
            o = pos + gr * gran + intra[sb]
            for c in range(nch[sb]):
                if n[c, sb]:
                    v0, v1, v2 = (int(codes[c, 3 * gr + k, sb])
                                  for k in range(3))
                    if g[c, sb]:
                        put(o, g[c, sb], v0 + n[c, sb] * (v1 + n[c, sb] * v2))
                    else:
                        for k, v in enumerate((v0, v1, v2)):
                            put(o + k * u[c, sb], u[c, sb], v)
                o += wq[c, sb]
    return b"".join(int(w).to_bytes(4, "big") for w in words)[:fs]


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


def random_frames(rng, cfg, F):
    """Random legal K2 outputs [F, ...] for cfg: allocations drawn per
    subband's classes (the alloc as transmitted), dropped at random until
    the frame's fields fit its smallest size, codes below their class."""
    C = cfg.channels
    SB = cfg.sblimit
    fs_bits = 8 * int(cfg.frame_plan(1)[1][0])
    alloc = np.zeros((F, C, 32), np.uint8)
    for sb in range(SB):
        alloc[:, :, sb] = rng.integers(0, cfg.ncls[sb], (F, C)) * \
            (rng.random((F, C)) < 0.6)
    scfsi = rng.integers(0, 4, (F, C, 32)).astype(np.uint8)
    for f in range(F):
        if cfg.joint:
            alloc[f, 1, cfg.bound:SB] = alloc[f, 0, cfg.bound:SB]
        while frame_bits(alloc[f], scfsi[f], cfg) > fs_bits:
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
        assert k3_model(alloc[f], scfsi[f], sfidx[f], codes[f], cfg,
                        int(pads[f]), int(sizes[f])) == want[f]
    twin = E.pack_plain(*(torch.from_numpy(x)[None] for x in
                          (alloc, scfsi, sfidx, codes)), cfg,
                        torch.from_numpy(pads), sizes)
    assert twin.numpy()[0].tobytes() == b"".join(want)
    assert twin.numpy()[0].tobytes() == jax_frame.pack_frames(
        jax_frame.parse_header(cfg.header_base.to_bytes(4, "big")),
        cfg.bitrate_idx, cfg.sr_idx, alloc[:, :, :SB], scfsi[:, :, :SB],
        sfidx[:, :, :, :SB], codes[:, :, :, :SB], pads, sizes)


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
