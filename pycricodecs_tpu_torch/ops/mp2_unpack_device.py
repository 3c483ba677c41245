"""MPEG Audio Layer II frame unpacker on the device: kernel B10.

Counterpart of pycricodecs_tpu/ops/mp2_unpack_device.py
(`Mp2DeviceUnpacker._unpack`), with the semantics of the host unpacker
mp2_frame._read_side_info / _frame_field_layout: bit allocation (one field
per channel below the joint-stereo bound, one shared field above it),
scfsi, scalefactors, then 12 granules of sample codes (grouped 3/5/9-level
codes split by integer division; shared fields go to both channels).

Frames go in as uint8 [N, fs_max], each zero-padded; every frame is read
with its own header (CRC flag, padding and so its size, table and sblimit,
joint-stereo bound), so one launch serves every stream of a channel count,
VBR streams included. A read that crosses the frame's end returns 0 and
sets the frame's `err` flag (the host unpacker raises there); a frame whose
header is not a Layer II header of this channel count, or whose size
exceeds the row, comes back all zero with `err` set. Subbands at or above
sblimit are zero.

`mp2_unpack` launches the kernel (csrc/mp2_unpack.cu, wrapper
cuda_kernels.mp2_unpack) on a CUDA tensor and runs `mp2_unpack_plain`, its
plain PyTorch twin, on a CPU tensor: vectorised over frames, sequential over
the side-info fields, vectorised over the 12 granules (their field layout
repeats), int64 arithmetic.
"""
from __future__ import annotations

import numpy as np
import torch

from . import cuda_kernels
from . import mp2_tables as T

GRANULES = 12
MAX_SBLIMIT = max(len(t) for t in T.ALLOC_TABLES.values())


def tables() -> dict:
    """The kernel's constant tables as numpy arrays (also written into the
    generated kernel header by _build.py)."""
    nbal = np.zeros((5, 32), np.int64)
    classes = np.zeros((5, 32, 16), np.int64)
    # per allocation index: bits of the one grouped code, or of each of the
    # three ungrouped codes, of a granule (0: no field)
    gbits = np.zeros((5, 32, 16), np.int64)
    ubits = np.zeros((5, 32, 16), np.int64)
    sblimit = np.zeros(5, np.int64)
    for t, rows in T.ALLOC_TABLES.items():
        sblimit[t] = len(rows)
        for sb, cl in enumerate(rows):
            nbal[t, sb] = (len(cl) - 1).bit_length()
            classes[t, sb, :len(cl)] = cl
            for i, n in enumerate(cl[1:], 1):
                if n in T.GROUP_BITS:
                    gbits[t, sb, i] = T.GROUP_BITS[n]
                else:
                    ubits[t, sb, i] = T.code_bits(n)
    bitrate = np.zeros((2, 16), np.int64)      # [version == 3, bri] kbps
    bitrate[0, :15] = T.BITRATES_V2_L2
    bitrate[1, :15] = T.BITRATES_V1_L2
    rate = np.ones((2, 4), np.int64)           # [version == 3, sri] Hz
    rate[0, :3] = T.SAMPLE_RATES_V2
    rate[1, :3] = T.SAMPLE_RATES_V1
    select = np.asarray(T.TABLE_SELECT, np.int64)   # [sri, mono, bri]
    return dict(nbal=nbal, classes=classes, gbits=gbits, ubits=ubits,
                sblimit=sblimit, bitrate=bitrate, rate=rate, select=select)


class _Reader:
    """MSB-first reads at one cursor per frame: a read of n > 0 bits that
    crosses the frame's end returns 0 and flags the frame."""

    def __init__(self, frames: torch.Tensor, nbits: torch.Tensor):
        self.W = frames.shape[1]
        self.d = torch.nn.functional.pad(frames.long(), (0, 3))
        self.off = torch.arange(3, device=frames.device)
        self.nbits = nbits
        self.err = torch.zeros_like(nbits, dtype=torch.bool)

    def peek(self, cur, n):
        """n (< 17) bits at cur; any shape [N, ...] of cur and n."""
        bb = torch.clamp(cur >> 3, max=self.W)
        flat = (bb[..., None] + self.off).reshape(bb.shape[0], -1)
        b = torch.gather(self.d, 1, flat).view(*bb.shape, 3)
        w = (b[..., 0] << 16) | (b[..., 1] << 8) | b[..., 2]
        return (w >> (24 - (cur & 7) - n)) & ((1 << n) - 1)

    def read(self, cur, n):
        """(value, cursor after) of a read of n bits at cur, [N] each."""
        nb = self.nbits.view(-1, *([1] * (cur.dim() - 1)))
        over = (n > 0) & (cur + n > nb)
        self.err |= over.reshape(cur.shape[0], -1).any(1)
        val = torch.where((n > 0) & ~over, self.peek(cur, n), 0)
        return val, cur + n


def mp2_unpack_plain(frames: torch.Tensor, channels: int):
    """Plain PyTorch twin of kernel B10: frames u8 [N, fs_max] -> (codes u16
    [N, C, 36, 32], levels i32 [N, C, 32], sfidx u8 [N, C, 3, 32],
    err bool [N])."""
    N, W = frames.shape
    C = int(channels)
    dev = frames.device
    tb = {k: torch.from_numpy(v).to(dev) for k, v in tables().items()}
    d = frames.long()
    if W < 4:
        d = torch.nn.functional.pad(d, (0, 4 - W))
    w = (d[:, 0] << 24) | (d[:, 1] << 16) | (d[:, 2] << 8) | d[:, 3]
    version = (w >> 19) & 3
    bri = (w >> 12) & 0xF
    sri = (w >> 10) & 3
    mode = (w >> 6) & 3
    nch = torch.where(mode == 3, 1, 2)
    valid = ((((w >> 21) & 0x7FF) == 0x7FF) & (((w >> 17) & 3) == 2)
             & ((version == 2) | (version == 3)) & (bri != 0) & (bri != 15)
             & (sri != 3) & (nch == C))
    v1 = (version == 3).long()
    sri_c = torch.clamp(sri, max=2)
    table = torch.where(version == 3,
                        tb["select"][sri_c, (nch == 1).long(), bri], 4)
    sblimit = tb["sblimit"][table]
    bound = torch.where(mode == 1,
                        torch.minimum((((w >> 4) & 3) + 1) * 4, sblimit),
                        sblimit)
    size = (144 * tb["bitrate"][v1, bri] * 1000 // tb["rate"][v1, sri]
            + ((w >> 9) & 1))
    valid &= size <= W
    rd = _Reader(frames, torch.where(valid, size * 8, 0))
    cur = torch.where(((w >> 16) & 1) == 0, 48, 32)

    # bit allocation: channel 1 has its own field only below the bound
    aidx = torch.zeros((N, C, 32), dtype=torch.int64, device=dev)
    for sb in range(MAX_SBLIMIT):
        nb = torch.where(sb < sblimit, tb["nbal"][table, sb], 0)
        for ch in range(C):
            own = nb if ch == 0 else torch.where(sb < bound, nb, 0)
            idx, cur = rd.read(cur, own)
            aidx[:, ch, sb] = idx if ch == 0 else torch.where(
                sb < bound, idx, aidx[:, 0, sb])
    sbs = torch.arange(32, device=dev)
    at_alloc = (table[:, None, None], sbs, aidx)
    alloc = tb["classes"][at_alloc]                         # levels
    on = alloc > 0
    # scfsi: 2 bits per allocated (sb, ch)
    scfsi = torch.zeros_like(alloc)
    for sb in range(MAX_SBLIMIT):
        for ch in range(C):
            scfsi[:, ch, sb], cur = rd.read(
                cur, torch.where(on[:, ch, sb], 2, 0))
    # scalefactors: 3, 2, 1 or 2 six-bit fields by scfsi
    sfidx = torch.zeros((N, C, 3, 32), dtype=torch.int64, device=dev)
    for sb in range(MAX_SBLIMIT):
        for ch in range(C):
            s, live = scfsi[:, ch, sb], on[:, ch, sb]
            r0, cur = rd.read(cur, torch.where(live, 6, 0))
            r1, cur = rd.read(cur, torch.where(live & (s != 2), 6, 0))
            r2, cur = rd.read(cur, torch.where(live & (s == 0), 6, 0))
            sfidx[:, ch, 0, sb] = r0
            sfidx[:, ch, 1, sb] = torch.where((s == 0) | (s == 3), r1, r0)
            sfidx[:, ch, 2, sb] = torch.where(
                s == 0, r2, torch.where(s == 2, r0, r1))

    # samples: one field layout per granule, repeated 12 times; a slot is
    # (sb, ch) with ch 1 only below the bound
    slots = [(sb, ch) for sb in range(MAX_SBLIMIT) for ch in range(C)]
    def per_slot(x):                                    # [N, C, 32] -> [N, S]
        return torch.stack([x[:, ch, sb] for sb, ch in slots], 1)
    own = torch.stack([(ch == 0) | (sb < bound) for sb, ch in slots], 1)
    n = per_slot(alloc)
    cg = per_slot(tb["gbits"][at_alloc]) * own
    cu = per_slot(tb["ubits"][at_alloc]) * own
    grouped = cg > 0
    width = cg + 3 * cu                                     # [N, S]
    intra = width.cumsum(1) - width
    g12 = torch.arange(GRANULES, device=dev)
    base = cur[:, None] + g12[None, :] * width.sum(1, keepdim=True)  # [N, 12]
    codes = torch.zeros((N, C, 36, 32), dtype=torch.int64, device=dev)
    nz = torch.clamp(n, min=1)
    for i, (sb, ch) in enumerate(slots):
        at = base + intra[:, i:i + 1]
        ccg, ccu = cg[:, i:i + 1], cu[:, i:i + 1]
        vg, at = rd.read(at, ccg.expand_as(at))
        u0, at = rd.read(at, ccu.expand_as(at))
        u1, at = rd.read(at, ccu.expand_as(at))
        u2, _ = rd.read(at, ccu.expand_as(at))
        q = nz[:, i:i + 1]
        g = grouped[:, i:i + 1]
        vals = (torch.where(g, vg % q, u0), torch.where(g, (vg // q) % q, u1),
                torch.where(g, vg // (q * q), u2))
        # channel 0's field above the bound is shared: it goes to both
        shared = (sb >= bound)[:, None]
        for k in range(3):
            v = torch.where(ccg + ccu > 0, vals[k], 0)      # [N, 12]
            if ch == 0:
                codes[:, 0, k::3, sb] = v
                for dch in range(1, C):
                    codes[:, dch, k::3, sb] = torch.where(
                        shared, v, codes[:, dch, k::3, sb])
            else:
                codes[:, ch, k::3, sb] = torch.where(
                    shared, codes[:, ch, k::3, sb], v)
    err = rd.err | ~valid
    keep = valid.view(N, 1, 1, 1)
    return (torch.where(keep, codes, 0).to(torch.uint16),
            torch.where(keep[..., 0], alloc, 0).to(torch.int32),
            torch.where(keep, sfidx, 0).to(torch.uint8), err)


def mp2_unpack(frames: torch.Tensor, channels: int):
    """Kernel B10 on a CUDA tensor (cuda_kernels.mp2_unpack), its plain
    twin on a CPU tensor; frames u8 [N, fs_max] -> (codes u16
    [N, C, 36, 32], levels i32 [N, C, 32], sfidx u8 [N, C, 3, 32],
    err bool [N])."""
    if frames.device.type == "cpu":
        return mp2_unpack_plain(frames, channels)
    return cuda_kernels.mp2_unpack(frames, channels)
