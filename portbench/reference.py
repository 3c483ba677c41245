"""Plain reference of CRILAYLA for the benchmark, in torch and numpy only.

It imports neither jax, pycricodecs_tpu nor pycricodecs_tpu_torch, and
takes nothing the port made but the outputs it judges. Every function runs
on any torch device: the CPU in the tests, the card after a run's window.

The format (CriCodecs crilayla.cpp): a blob is "CRILAYLA", the u32
decompress size (the member's bytes less 0x100), the u32 stream size, the
stream, and the member's first 0x100 bytes. The stream is read from its
last byte down, each byte from its top bit. Its tokens fill the member
from its last byte down to byte 0x100:

- 0 and 8 bits: one literal byte;
- 1, a 13-bit offset and a length code: a copy of `length` bytes from
  `offset + 3` bytes above, byte by byte downwards (lengths 3-5: 2 bits;
  6-12: 2 + 3; 13-43: 2 + 3 + 5; 44 and up: 2 + 3 + 5 bits of ones, then
  bytes of 255 and a last byte below 255, summed).

After the tokens come the last byte's unused bits, two zero bytes and
zero bytes until the stream's size is a multiple of 4. CriLaylaCompress
writes the greedy parse: at each position n, over the candidates
d = 3 .. 0x2002 with n + d inside the member, the longest run of equal
bytes going down from n and n + d, not below byte 0x100; the smallest d
on ties; a literal where the longest is below 3.

`verify_compress` judges a compressor's blobs without compressing: it
parses each stream and holds every token to the greedy rule at its
position, which fixes the blob byte for byte (the length code is a
prefix code, and each token's position follows from those before it).
`compress_plain` is the greedy compressor itself, searching every
candidate at every position (the control runs it with a shorter window);
`decompress_plain` decodes (the control stops its copies' pointer jumping
early).
"""
from __future__ import annotations

import math

import numpy as np
import torch

MAGIC = b"CRILAYLA"
PREFIX = 0x100
HEADER = 16
WINDOW = 0x2000          # candidates d = 3 .. WINDOW + 2
PAD = 8                  # zero bytes after each stream in a parse's layout
HASH_P = 2147483647      # 2^31 - 1, a prime; products of two residues fit int64
HASH_B = 1000003
#: gram lengths of the candidate indexes (`_no_better`), the largest at or
#: below a query's threshold is used
LEVELS = [3, 4, 5, 6, 7, 8]
while LEVELS[-1] < 1 << 31:
    LEVELS.append(LEVELS[-1] * 5 // 4 + 1)
#: candidates expanded at once (`_no_better`)
CHUNK = 1 << 25


def work_cap(n: int) -> int:
    """The compressor's work buffer for n bytes (a stream never exceeds it
    under the greedy parse)."""
    return n + ((n // 2 + 0x403) & ~3)


def _u8(data: bytes, device) -> torch.Tensor:
    return torch.frombuffer(bytearray(data), dtype=torch.uint8).to(device) \
        if data else torch.zeros(0, dtype=torch.uint8, device=device)


def _reach(nxt: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """Bool mask of every index reached from `starts` by following nxt
    (int32 or int64, nxt[i] = i for a sink): pointer doubling, where round
    k adds the positions 2^k to 2^(k+1) - 1 steps on, and stops once a
    round adds nothing new."""
    mark = torch.zeros(nxt.numel(), dtype=torch.bool, device=nxt.device)
    mark[starts] = True
    cur = nxt
    for _ in range(64):
        new = cur[mark.nonzero().squeeze(1)]
        if bool(mark[new].all()):
            break
        mark[new] = True
        cur = cur[cur]
    return mark


# --------------------------------------------------------------------------
# parse


def _parse(streams: list, sizes: list, device) -> dict:
    """The tokens of each stream (the payload's stream bytes) of a member of
    `sizes[m]` bytes, as the decompressor reads them, up to the one that
    fills the member. Returns {"ok": [bool], and per token of
    the filled members, in reading order: "m" (member), "n" (the member's
    byte where the token starts), "lit", "val" (literal byte), "d" (copy
    distance, offset + 3), "len" (bytes written)}. A member is not ok
    where its stream ends before the member is filled, a token runs past
    the byte 0x100, or the bits after the last token are not the padding
    the format fixes."""
    M = len(streams)
    cs = np.array([len(s) for s in streams], np.int64)
    region = cs + PAD
    base = np.concatenate([[0], np.cumsum(region)[:-1]]).astype(np.int64)
    nbytes = int(region.sum())
    if 8 * nbytes >= 1 << 31:
        raise ValueError("_parse: split the streams below 2^28 bytes")
    buf = np.zeros(nbytes + 8, np.uint8)
    for s, b in zip(streams, base):
        buf[b:b + len(s)] = np.frombuffer(s, np.uint8)[::-1]
    rev = torch.from_numpy(buf).to(device)
    b64 = rev.to(torch.int64)
    # bits 8j .. 8j + 39 of the reading order, big-endian
    win = ((b64[:-4] << 32) | (b64[1:-3] << 24) | (b64[2:-2] << 16)
           | (b64[3:-1] << 8) | b64[4:])[:nbytes]
    del b64
    base_t = torch.from_numpy(base).to(device)
    sink_byte = torch.repeat_interleave(
        base_t + torch.from_numpy(cs).to(device),
        torch.from_numpy(region).to(device))
    j_all = torch.arange(nbytes, device=device)
    nxt = torch.empty(8 * nbytes, dtype=torch.int32, device=device)
    long_pos, long_len = [], []
    for s in range(8):
        w = ((win << s) >> 8) & 0xFFFFFFFF
        tl = _head_bits(w)
        is_long = tl == 0
        if bool(is_long.any()):
            j = is_long.nonzero().squeeze(1)
            byte = ((win << s) >> 32) & 0xFF
            free = (byte != 255).nonzero().squeeze(1)
            # j + 3 past the last byte only for positions in the padding
            e = free[torch.searchsorted(free, j + 3).clamp(
                max=free.numel() - 1)]
            run = (e - (j + 3)).clamp(min=0)
            tl[j] = 24 + 8 * (run + 1)
            long_pos.append(8 * j + s)
            long_len.append((44 + 255 * run + byte[e]) & 0xFFFFFFFF)
            del byte, free
        k = 8 * j_all + s
        nxt.view(nbytes, 8)[:, s] = torch.minimum(k + tl, 8 * sink_byte).to(
            torch.int32)
    del sink_byte, j_all
    long_pos = torch.cat(long_pos) if long_pos else torch.zeros(
        0, dtype=torch.int64, device=device)
    long_len = torch.cat(long_len) if long_len else long_pos.clone()
    order = torch.argsort(long_pos)
    long_pos, long_len = long_pos[order], long_len[order]

    mark = _reach(nxt, 8 * base_t)
    del nxt
    tok = mark.nonzero().squeeze(1)
    del mark
    m = torch.searchsorted(8 * base_t, tok, right=True) - 1
    end_bit = 8 * (base_t + torch.from_numpy(cs).to(device))
    tok, m = tok[tok < end_bit[m]], m[tok < end_bit[m]]
    j, s = tok >> 3, tok & 7
    w = ((win[j] << s) >> 8) & 0xFFFFFFFF
    lit = (w >> 31) == 0
    tl = _head_bits(w)
    f2, f3, f5 = (w >> 16) & 3, (w >> 13) & 7, (w >> 8) & 31
    length = torch.where(f2 < 3, f2 + 3, torch.where(
        f3 < 7, f3 + 6, f5 + 13))
    is_long = tl == 0
    if bool(is_long.any()):
        at = torch.searchsorted(long_pos, tok[is_long])
        ll = long_len[at]
        length[is_long] = ll
        tl[is_long] = 24 + 8 * ((ll - 44) // 255 + 1)
    out_len = torch.where(lit, 1, length)
    val = (w >> 23) & 0xFF
    d = ((w >> 18) & 0x1FFF) + 3

    size = torch.tensor(sizes, dtype=torch.int64, device=device)
    cum = torch.cumsum(out_len, 0)
    first = torch.searchsorted(m, torch.arange(M, device=device))
    before_member = torch.where(first > 0, cum[(first - 1).clamp(min=0)], 0)
    before = cum - out_len - before_member[m]
    need = size - PREFIX
    real = before < need[m]
    filled = torch.zeros(M, dtype=torch.int64, device=device).index_add_(
        0, m[real], out_len[real])
    last_end = torch.zeros(M, dtype=torch.int64, device=device)
    last_end.scatter_reduce_(0, m[real], tok[real] + tl[real] - 8 * base_t[
        m[real]], "amax", include_self=True)
    filled, last_end = filled.cpu().numpy(), last_end.cpu().numpy()
    ok = [False] * M
    for i in range(M):
        kend = int(last_end[i])
        x = -(-kend // 8)
        if (filled[i] != sizes[i] - PREFIX or kend > 8 * cs[i]
                or 4 * (-(-(x + 2) // 4)) != cs[i]):
            continue
        tail = buf[base[i] + kend // 8: base[i] + cs[i]].copy()
        if kend % 8:
            tail[0] &= (1 << (8 - kend % 8)) - 1
        ok[i] = not tail.any()
    keep = real & torch.from_numpy(np.array(ok)).to(device)[m]
    n = size[m] - 1 - before
    return {"ok": ok, "m": m[keep], "n": n[keep],
            "lit": lit[keep], "val": val[keep], "d": d[keep],
            "len": out_len[keep]}


def _head_bits(w: torch.Tensor) -> torch.Tensor:
    """Bits of the token whose first 32 bits are w (0 for a length that
    goes on into bytes of 255)."""
    flag, f2 = w >> 31, (w >> 16) & 3
    f3, f5 = (w >> 13) & 7, (w >> 8) & 31
    return torch.where(flag == 0, 9, torch.where(f2 < 3, 16, torch.where(
        f3 < 7, 19, torch.where(f5 < 31, 24, 0))))


def _header_ok(data: bytes, blob) -> bool:
    """Whether the blob's header, sizes and raw prefix are data's."""
    if blob is None or blob[:8] != MAGIC:
        return False
    ds = int.from_bytes(blob[8:12], "little")
    cs = int.from_bytes(blob[12:16], "little")
    return (ds == len(data) - PREFIX and len(blob) == HEADER + cs + PREFIX
            and blob[HEADER + cs:] == data[:PREFIX])


def _batches(sizes: list, limit: int) -> list:
    """Index runs whose sizes sum to at most limit (a larger one alone)."""
    out, cur, held = [], [], 0
    for i, s in enumerate(sizes):
        if cur and held + s > limit:
            out.append(cur)
            cur, held = [], 0
        cur.append(i)
        held += s
    if cur:
        out.append(cur)
    return out


# --------------------------------------------------------------------------
# compress: judge


def verify_compress(datas: list, blobs: list, device="cpu") -> list:
    """For each member (bytes) and the blob a compressor returned for it
    (bytes, or None for a refusal): whether the blob is the one
    CriLaylaCompress writes. A member of 0x100 bytes or fewer has none
    (None is right); any other has one within its work buffer, since no
    token spends more than 9 bits a byte."""
    device = torch.device(device)
    if len(blobs) != len(datas):
        return [False] * len(datas)
    ok = [False] * len(datas)
    todo = []
    for i, (data, blob) in enumerate(zip(datas, blobs)):
        if len(data) <= PREFIX:
            ok[i] = blob is None
        elif _header_ok(data, blob):
            todo.append(i)
    streams = {i: blobs[i][HEADER:len(blobs[i]) - PREFIX] for i in todo}
    for group in _batches([len(streams[i]) + PAD for i in todo], 1 << 27):
        idx = [todo[g] for g in group]
        for i, good in zip(idx, _verify_group(
                [datas[i] for i in idx], [streams[i] for i in idx],
                device)):
            ok[i] = good
    return ok


def _verify_group(datas: list, streams: list, device) -> list:
    sizes = [len(d) for d in datas]
    tok = _parse(streams, sizes, device)
    good = torch.tensor(tok["ok"], dtype=torch.bool, device=device)
    D = torch.cat([_u8(d, device) for d in datas])
    start = torch.tensor(np.concatenate([[0], np.cumsum(sizes)[:-1]]),
                         dtype=torch.int64, device=device)
    size = torch.tensor(sizes, dtype=torch.int64, device=device)
    m, n, lit, val, d, L = (tok[k] for k in ("m", "n", "lit", "val", "d",
                                             "len"))
    g = start[m] + n
    bad = torch.zeros_like(lit)
    # literals hold their byte; copies stay inside the member and above
    # 0x100, hold equal bytes, and end where the run ends (or at 0x100)
    bad |= lit & (D[g] != val)
    cp = ~lit
    bad |= cp & ((n + d > size[m] - 1) | (L > n - (PREFIX - 1)))
    bad |= cp & (n - L >= PREFIX) & (
        D[(g - L).clamp(min=0)] == D[(g - L + d).clamp(max=D.numel() - 1)])
    ci = cp.nonzero().squeeze(1)
    ci = ci[~bad[ci]]
    for sub in _split_by_total(ci, L[ci], CHUNK):
        r = L[sub]
        t = torch.repeat_interleave(sub, r)
        off = torch.arange(int(r.sum()), device=device) - \
            torch.repeat_interleave(torch.cumsum(r, 0) - r, r)
        p = g[t] - off
        bad[t[D[p] != D[p + d[t]]]] = True
    good[m[bad]] = False
    keep = ~bad & good[m]
    worse = _no_better(D, start, size, m[keep], n[keep], lit[keep], d[keep],
                       L[keep])
    good &= ~worse
    return good.cpu().tolist()


def _split_by_total(idx: torch.Tensor, weight: torch.Tensor,
                    limit: int) -> list:
    """idx cut into runs whose weights sum to about limit at most (a
    heavier single one alone)."""
    if idx.numel() == 0:
        return []
    cum = torch.cumsum(weight, 0)
    cut = (cum // limit).cpu().numpy()
    edges = np.flatnonzero(np.diff(cut)) + 1
    return list(torch.tensor_split(idx, torch.from_numpy(edges)))


def _hashes(D: torch.Tensor) -> tuple:
    """(prefix sums H of D[j] B^j mod P, B^-j mod P) for gram hashes."""
    T = D.numel()
    pw, ipw = _powers(HASH_B, T, D.device), _powers(
        pow(HASH_B, HASH_P - 2, HASH_P), T, D.device)
    H = torch.zeros(T + 1, dtype=torch.int64, device=D.device)
    torch.cumsum(D.to(torch.int64) * pw % HASH_P, 0, out=H[1:])
    return H, ipw


def _powers(b: int, T: int, device) -> torch.Tensor:
    out = torch.ones(max(T, 1), dtype=torch.int64, device=device)
    n, cur = 1, b % HASH_P
    while n < T:
        k = min(n, T - n)
        out[n:n + k] = out[:k] * cur % HASH_P
        cur = cur * cur % HASH_P
        n += k
    return out


def _gram(H, ipw, end: torch.Tensor, q) -> torch.Tensor:
    """Hash of the q bytes ending at `end` (both tensors or q an int)."""
    lo = end - q + 1
    return (H[end + 1] - H[lo]) % HASH_P * ipw[lo] % HASH_P


def _no_better(D, start, size, m, n, lit, d, L) -> torch.Tensor:
    """Bool [members]: a member where some token is not the greedy choice,
    given that each copy's run is exactly its length: a literal where some
    candidate runs 3 bytes or more, a copy where a nearer candidate runs
    as far or a farther one further. Each such question is a query (the
    token's byte, a run threshold q, a range of candidates), grouped by
    the largest of LEVELS at or below q. A group's candidates are checked
    at q by hash: all of them where the group is small (`_scan`), those
    whose gram of the level's length matches where it is large
    (`_indexed`); a hash match is checked by the bytes themselves."""
    device = D.device
    M = size.numel()
    worse = set()
    if n.numel() == 0:
        return torch.zeros(M, dtype=torch.bool, device=device)
    H, ipw = _hashes(D)
    dmax = torch.minimum(torch.full_like(n, WINDOW + 2), size[m] - 1 - n)
    cap = n - (PREFIX - 1)                # the longest run from n
    q = torch.cat([torch.full_like(n[lit], 3), L[~lit], L[~lit] + 1])
    lo = torch.cat([torch.full_like(n[lit], 3), torch.full_like(n[~lit], 3),
                    d[~lit] + 1])
    hi = torch.cat([dmax[lit], d[~lit] - 1, dmax[~lit]])
    qm = torch.cat([m[lit], m[~lit], m[~lit]])
    qg = torch.cat([(start[m] + n)[lit], (start[m] + n)[~lit],
                    (start[m] + n)[~lit]])
    qcap = torch.cat([cap[lit], cap[~lit], cap[~lit]])
    live = (q <= qcap) & (lo <= hi)
    q, lo, hi, qm, qg = q[live], lo[live], hi[live], qm[live], qg[live]
    levels = torch.tensor(LEVELS, device=device)
    level = torch.searchsorted(levels, q, right=True) - 1
    T = D.numel()
    for li in level.unique().tolist():
        sel = (level == li).nonzero().squeeze(1)
        sq, sg, sm = q[sel], qg[sel], qm[sel]
        slo, shi = sg + lo[sel], sg + hi[sel]
        if int((shi - slo + 1).sum()) <= T:
            hits = _scan(H, ipw, sq, sg, slo, shi)
        else:
            hits = _indexed(H, ipw, LEVELS[li], sq, sg, slo, shi, T)
        # a hash match is a better candidate only if its bytes match too;
        # one confirmed a member is enough
        for t, x in hits:
            for mi, q_, g_, xi in zip(sm[t].tolist(), sq[t].tolist(),
                                      sg[t].tolist(), x.tolist()):
                if mi not in worse and torch.equal(
                        D[xi - q_ + 1:xi + 1], D[g_ - q_ + 1:g_ + 1]):
                    worse.add(mi)
    out = torch.zeros(M, dtype=torch.bool, device=device)
    out[list(worse)] = True
    return out


def _expand(counts: torch.Tensor, first: torch.Tensor, part):
    """(query of each item, item index) for queries `part` with counts
    items each, numbered from first[query]."""
    c = counts[part]
    t = torch.repeat_interleave(part, c)
    k = first[t] + torch.arange(int(c.sum()), device=c.device) - \
        torch.repeat_interleave(torch.cumsum(c, 0) - c, c)
    return t, k


def _scan(H, ipw, sq, sg, slo, shi):
    """Hash hits [(query, position)] of every candidate in each query's
    range (few queries)."""
    count = shi - slo + 1
    for part in _split_by_total(torch.arange(sq.numel(), device=sq.device),
                                count, CHUNK):
        t, x = _expand(count, slo, part)
        hit = _gram(H, ipw, x, sq[t]) == _gram(H, ipw, sg[t], sq[t])
        yield t[hit], x[hit]


def _indexed(H, ipw, G, sq, sg, slo, shi, T):
    """Hash hits [(query, position)] through a sorted index of the G-gram
    hashes of every position some query's range covers (many queries):
    only candidates whose G-gram matches are checked at q."""
    device = sq.device
    cover = torch.zeros(T + 1, dtype=torch.int32, device=device)
    cover.index_add_(0, slo, torch.ones_like(slo, dtype=torch.int32))
    cover.index_add_(0, shi + 1, -torch.ones_like(shi, dtype=torch.int32))
    xs = (torch.cumsum(cover, 0)[:T] > 0).nonzero().squeeze(1)
    del cover
    keys = torch.sort((_gram(H, ipw, xs, G) << 31) | xs).values
    del xs
    kg = _gram(H, ipw, sg, G) << 31
    first = torch.searchsorted(keys, kg | slo)
    count = torch.searchsorted(keys, kg | shi, right=True) - first
    for part in _split_by_total(torch.arange(sq.numel(), device=device),
                                count, CHUNK):
        if int(count[part].sum()) == 0:
            continue
        t, k = _expand(count, first, part)
        x = keys[k] & ((1 << 31) - 1)
        hit = _gram(H, ipw, x, sq[t]) == _gram(H, ipw, sg[t], sq[t])
        yield t[hit], x[hit]


# --------------------------------------------------------------------------
# compress: the greedy compressor


def _running_max(x: torch.Tensor, width: int = 4096) -> torch.Tensor:
    """torch.cummax(x, 0).values of a 1-D tensor of values >= -1, taken as
    rows of `width` (a scan a row runs in parallel; a single long row runs
    on one thread block on CUDA) and the rows' maxima carried down."""
    n = x.numel()
    rows = -(-n // width)
    pad = torch.full((rows * width - n,), -1, dtype=x.dtype, device=x.device)
    local = torch.cummax(torch.cat([x, pad]).view(rows, width), 1).values
    carry = torch.cummax(local[:, -1], 0).values
    local[1:] = torch.maximum(local[1:], carry[:-1, None])
    return local.view(-1)[:n]


def compress_plain(datas: list, window: int = WINDOW, device="cpu") -> list:
    """The blob CriLaylaCompress writes for each member (bytes) over the
    candidates d = 3 .. window + 2 (None for 0x100 bytes or fewer, or a
    stream past the work buffer). Members are taken together, in runs of
    up to 2^28 bytes: every position's longest run is searched for every
    candidate (one run-length scan a candidate), then each member's greedy
    walk is followed from its top by pointer doubling, and its tokens are
    written as bits."""
    device = torch.device(device)
    out = [None] * len(datas)
    todo = [i for i, d in enumerate(datas) if len(d) > PREFIX]
    for group in _batches([len(datas[i]) for i in todo], 1 << 28):
        idx = [todo[g] for g in group]
        for i, blob in zip(idx, _compress_group([datas[i] for i in idx],
                                                window, device)):
            out[i] = blob
    return out


def _compress_group(datas: list, window: int, device) -> list:
    sizes = np.array([len(d) for d in datas], np.int64)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    T = int(sizes.sum())
    D = torch.cat([_u8(d, device) for d in datas])
    ar = torch.arange(T, dtype=torch.int32, device=device)
    counts = torch.from_numpy(sizes).to(device)
    local = ar - torch.repeat_interleave(
        torch.from_numpy(starts).to(device), counts).to(torch.int32)
    room = torch.repeat_interleave(counts, counts).to(torch.int32) - local
    floor = local >= PREFIX              # a run stops below byte 0x100
    del local, counts
    best = torch.zeros(T, dtype=torch.int32, device=device)
    bestd = torch.zeros(T, dtype=torch.int32, device=device)
    for d in range(3, window + 3):
        k = T - d
        if k <= 0:
            break
        eq = (D[:k] == D[d:]) & floor[:k] & (room[:k] > d)
        run = ar[:k] - _running_max(torch.where(eq, -1, ar[:k]))
        better = run > best[:k]
        best[:k] = torch.where(better, run, best[:k])
        bestd[:k] = torch.where(better, d, bestd[:k])
        del eq, run, better
    del room, ar
    # the walks: each position steps down by its token; position 0xFF of a
    # member (reached exactly, since no run passes 0x100) is where it ends
    step = torch.where(best >= 3, best, 1).to(torch.int64)
    nxt = torch.arange(T, device=device) - step
    nxt[~floor] = torch.nonzero(~floor).squeeze(1)
    top = torch.from_numpy(starts + sizes - 1).to(device)
    mark = _reach(nxt, top) & floor
    del nxt, step
    pos = mark.nonzero().squeeze(1)
    m = torch.searchsorted(torch.from_numpy(starts).to(device), pos,
                           right=True) - 1
    order = torch.argsort(m * (T + 1) + (T - pos))  # members, each top-down
    pos, m = pos[order], m[order]
    lit = best[pos] < 3
    L = best[pos].to(torch.int64)
    off = (bestd[pos] - 3).to(torch.int64)
    val = D[pos].to(torch.int64)
    head = torch.where(lit, val, torch.where(
        L < 6, (1 << 15) | (off << 2) | (L - 3), torch.where(
            L < 13, (1 << 18) | (off << 5) | (3 << 3) | (L - 6), torch.where(
                L < 44, (1 << 23) | (off << 10) | (0x1F << 5) | (L - 13),
                (1 << 23) | (off << 10) | 0x3FF))))
    hl = torch.where(lit, 9, torch.where(L < 6, 16, torch.where(L < 13, 19,
                                                                24)))
    long_ = ~lit & (L >= 44)
    ext = torch.where(long_, (L - 44) // 255 + 1, 0)
    nbits = hl + 8 * ext
    M = len(datas)
    member_bits = torch.zeros(M, dtype=torch.int64, device=device
                              ).index_add_(0, m, nbits)
    # each member's bits start on a byte of a shared buffer
    member_bytes = (member_bits + 7) // 8
    mbase = torch.cumsum(member_bytes, 0) - member_bytes
    within = torch.cumsum(nbits, 0) - nbits
    first = torch.searchsorted(m, torch.arange(M, device=device))
    within = within - within[first.clamp(max=max(len(m) - 1, 0))][m]
    startb = 8 * mbase[m] + within
    total = int(member_bytes.sum())
    bits = torch.zeros(8 * total + 8, dtype=torch.uint8, device=device)
    for b in range(24):
        s = hl > b
        bits[startb[s] + b] = ((head[s] >> (hl[s] - 1 - b)) & 1).to(
            torch.uint8)
    if bool(long_.any()):
        t = long_.nonzero().squeeze(1)
        r = ext[t]
        tt = torch.repeat_interleave(t, r)
        e = torch.arange(int(r.sum()), device=device) - \
            torch.repeat_interleave(torch.cumsum(r, 0) - r, r)
        byte = torch.where(e < ext[tt] - 1, 255, (L[tt] - 44) % 255)
        p = startb[tt] + 24 + 8 * e
        for b in range(8):
            bits[p + b] = ((byte >> (7 - b)) & 1).to(torch.uint8)
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8,
                           device=device)
    packed = (bits[:8 * total].view(total, 8) * weights).sum(1).to(
        torch.uint8).cpu().numpy()
    out = []
    for i, (data, x, at) in enumerate(zip(datas, member_bytes.tolist(),
                                          mbase.tolist())):
        cs = 4 * (-(-(x + 2) // 4))
        if cs > work_cap(len(data)):
            out.append(None)
            continue
        stream = bytes(cs - x) + packed[at:at + x][::-1].tobytes()
        out.append(MAGIC + (len(data) - PREFIX).to_bytes(4, "little")
                   + cs.to_bytes(4, "little") + stream + data[:PREFIX])
    return out


# --------------------------------------------------------------------------
# decompress


def decompress_plain(blobs: list, rounds: int = None, device="cpu") -> list:
    """Each blob's member bytes (None where its stream does not parse to a
    filled member). Copies are resolved by pointer jumping, `rounds`
    rounds (None: enough for any chain)."""
    device = torch.device(device)
    out = [None] * len(blobs)
    heads = []
    for i, blob in enumerate(blobs):
        if blob is None or blob[:8] != MAGIC:
            continue
        ds = int.from_bytes(blob[8:12], "little")
        cs = int.from_bytes(blob[12:16], "little")
        if len(blob) != HEADER + cs + PREFIX:
            continue
        heads.append((i, ds + PREFIX, blob[HEADER:HEADER + cs],
                      blob[HEADER + cs:]))
    for group in _batches([ds for _, ds, _, _ in heads], 1 << 27):
        part = [heads[g] for g in group]
        for (i, _, _, _), data in zip(part, _decode_group(part, rounds,
                                                          device)):
            out[i] = data
    return out


def _decode_group(part: list, rounds, device) -> list:
    sizes = [ds for _, ds, _, _ in part]
    tok = _parse([s for _, _, s, _ in part], sizes, device)
    start = torch.tensor(np.concatenate([[0], np.cumsum(sizes)[:-1]]),
                         dtype=torch.int64, device=device)
    T = int(sum(sizes))
    val = torch.zeros(T, dtype=torch.uint8, device=device)
    ptr = torch.arange(T, device=device)
    for (_, _, _, prefix), s in zip(part, start.tolist()):
        val[s:s + PREFIX] = _u8(prefix, device)
    m, n, lit, v, d, L = (tok[k] for k in ("m", "n", "lit", "val", "d",
                                           "len"))
    g = start[m] + n
    val[g[lit]] = v[lit].to(torch.uint8)
    ci = (~lit).nonzero().squeeze(1)
    for sub in _split_by_total(ci, L[ci], CHUNK):
        r = L[sub]
        t = torch.repeat_interleave(sub, r)
        off = torch.arange(int(r.sum()), device=device) - \
            torch.repeat_interleave(torch.cumsum(r, 0) - r, r)
        p = g[t] - off
        ptr[p] = p + d[t]
    full = max(1, math.ceil(math.log2(max(T, 2)))) + 1
    for _ in range(full if rounds is None else rounds):
        ptr = ptr[ptr]
    res = val[ptr].cpu().numpy()
    return [res[s:s + z].tobytes() if ok else None
            for s, z, ok in zip(start.tolist(), sizes, tok["ok"])]
