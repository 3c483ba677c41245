"""Batched HCA, ADX and AHX bank decode and encode on one device, or
sharded over a mesh of devices (`mesh.py`).

HCA: counterpart of the device engine of pycricodecs_tpu/parallel/pipeline.py
(`decode_batch`, `_decode_group`, `_decode_group_inner`):

1. the host parses every header and groups streams by (config, sample rate,
   cipher table);
2. per chunk of up to 64 streams of a group, the host stacks the raw
   enciphered frames, checks frame sync and CRC, and copies them to the
   device;
3. the device deciphers and unpacks the bitstream (kernels B1, B2), builds
   the PNS noise maps of v3 streams with min_resolution 0 (plain PyTorch,
   `DeviceUnpacker.noise_maps`) and runs the transform, noise add included,
   to interleaved PCM16 (kernel B3);
4. the PCM comes back to the host, which trims the encoder delay, zeroes the
   tail of truncated streams and writes the WAVs.

Every config decodes on the device, zero coded_count included (a v2
stereo secondary with base_band_count 0). The unpacker refuses only a
scalefactor count past 128, or 128 with the v3 HFR extension: each stream of
such a config fails with HcaError (returned under on_error="isolate").

Key search (`find_key`, `score_key`, `rank_keys`): counterparts of the JAX
functions. The host parses the header and runs the key-independent frame
checks (silent, sync, CRC); the device builds one cipher table per
candidate, unpacks every (key, frame) row with B1 and B2 under its key's
table and applies the reference's status rules; the keys whose first two
frames pass go through all frames again, their clean frames through the PNS
maps and the float-wave decode (kernel B4), and are scored on the device.

ADX (`adx_decode_batch`, `adx_encode_batch`): counterparts of the JAX
functions of the same names with device=True. The host parses headers (or
WAVs), stacks one lane per stream channel, padded to the longest stream of
the group, and copies raw block bytes (or PCM16) to the device; one launch
of kernel B7 (or B8) runs every lane serially over its blocks; the host
trims, interleaves and writes WAVs (or assembles ADX streams). The spb
limit of the JAX device path is gone: the kernels loop over spb at run time.

HCA encode (`hca_encode_batch`): counterpart of the JAX function of the same
name with device=True. The host parses the WAVs and groups them by
(channels, sample rate); per group it derives each stream's configuration,
stacks the PCM timelines and copies them to the device, which runs the MDCT
(kernel B6), the analysis and rate control, the HCA scale normalisation and
the frame packer (kernel hca_pack); the frames come back and the host
prepends each stream's header.

AHX decode (`ahx_decode_batch`): counterpart of the JAX function of the same
name with device=False (its host lane), byte for byte. The host parses each
AHX or bare Layer II stream and walks its frames; per channel count, the
frames of all streams go to the device as one zero-padded stack, kernel B10
unpacks them (each frame by its own header, so VBR streams mix in) and the
synthesis kernel `mp2_synth` runs the host lane's f64 arithmetic in its
order; the host trims to min(frames * 1152, total samples) and writes WAVs.

AHX encode (`ahx_encode_batch`): counterpart of the JAX function of the
same name with device=False (its f64 host lane), byte for byte. The host
parses the WAVs and groups them by (channels, sample rate); per group it
stacks the PCM, each stream zero-padded at its tail to the longest, and
copies it to the device, which runs the analysis with its part and frame
peaks (kernel K1 `mp2_analysis`) and, after numpy's log10 of the frame
peaks on the host, the allocation and quantisation (kernel K2
`mp2_allocate`) and the frame packer (kernel K3 `mp2_pack`); the streams
come back, each cut to its own frame count, and mono LSF streams get the
AHX container.

Banks (`decode_awb`, `decode_acb`): counterparts of the JAX functions of the
same names. The host reads the AFS2 bank (an ACB's embedded one, or the
sibling `<Name>.awb` of an ACB opened by path) and routes its members by
their first bytes: all HCA members through one decode_batch call, all AHX
members through one ahx_decode_batch call, and all ADX members through one
launch of B7 per geometry in the JAX host decoders' arithmetic; a member
that does not parse comes back raw.

Sharding (`mesh=` on decode_batch, decode_awb, decode_acb, adx_decode_batch,
adx_encode_batch, ahx_decode_batch, hca_encode_batch and ahx_encode_batch,
the JAX functions' counterpart): one process enqueues each shard's work on
its own device of a `parallel.Mesh` and returns the whole batch, as the
JAX package's single controller does. Streams shard over dp; the HCA
decode also splits frames over sp with a one-frame halo; the ADX lanes
shard over every device of the mesh. Each sharded call is byte-equal to
the meshless one.

Observability: `trace(log_dir)` records a torch.profiler Chrome trace of
the calls it wraps, and `measure_d2h_bandwidth` times one device-to-host
copy.

On a CPU `device` every path runs the kernels' plain PyTorch twins.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..models import adx as adx_model
from ..models import ahx as ahx_model
from ..models import hca as hca_model
from ..ops import (adx_kernels, hca_encode_device, hca_frame, hca_kernels,
                   hca_unpack_device, mp2_frame, mp2_kernels,
                   mp2_unpack_device)
from ..utils import hca_crypt, tracing
from ..utils import wav as wavmod
from ..utils.crc import crc16_batch
from ..utils.device import as_device
# make_mesh: the JAX package defines it in this module
from .mesh import Mesh, check_mesh, make_mesh, shard_rows  # noqa: F401

SAMPLES_PER_FRAME = hca_model.SAMPLES_PER_FRAME
CHUNK_STREAMS = 64


@dataclass
class DecodeStats:
    """Per-call pipeline observability: stage timings + counts."""
    streams: int = 0
    groups: int = 0
    frames: int = 0
    failed_streams: int = 0
    bytes_in: int = 0
    samples_out: int = 0
    unpack_seconds: float = 0.0   # host: stack frames, sync + CRC checks
    device_seconds: float = 0.0   # H2D + kernel launches (asynchronous)
    fetch_seconds: float = 0.0    # device->host PCM copy + trim
    total_seconds: float = 0.0
    device_unpack_streams: int = 0  # streams whose bitstream decode ran on-chip

    def as_dict(self) -> dict:
        return dict(self.__dict__)


class trace:
    """Optional profiler tracing of pipeline calls (the JAX package's
    parallel.trace, on torch.profiler):

        with parallel.trace("prof"):
            parallel.decode_batch(blobs)

    Records CPU activity, and CUDA activity where a GPU is present, and
    writes a Chrome trace (`trace_<pid>_<n>.json`, view it in Perfetto or
    chrome://tracing) into log_dir on exit; its path is `self.path`. The
    port's own spans and counts of the traced calls (`utils.tracing`:
    CRILAYLA's stages) are `self.spans` after exit,
    `tracing.summary()`'s dict. A no-op, with `path` and `spans` None,
    only where the profiler cannot start."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self.path: Optional[str] = None
        self.spans: Optional[dict] = None
        self._prof = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        tracing.reset()
        try:
            self._prof = profile(activities=activities)
            self._prof.__enter__()
        except Exception:
            self._prof = None
        return self

    def __exit__(self, *exc):
        if self._prof is None:
            return False
        self._prof.__exit__(*exc)
        self.spans = tracing.summary()
        os.makedirs(self.log_dir, exist_ok=True)
        self.path = os.path.join(
            self.log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        self._prof.export_chrome_trace(self.path)
        return False


_d2h_mbps: dict = {}


def measure_d2h_bandwidth(nbytes: int = 8 << 20, *, device="cuda") -> float:
    """Device-to-host copy bandwidth (MB/s) of `device`: one timed `.cpu()`
    of an nbytes float32 buffer after a small warm-up copy, measured once
    per process and device. A failed probe raises (the JAX package reports
    0 there, which would hide a broken device)."""
    device = as_device(device)
    if str(device) in _d2h_mbps:
        return _d2h_mbps[str(device)]
    x = torch.ones(max(nbytes // 4, 1), dtype=torch.float32, device=device)
    x[:1024].cpu()                      # warm the transfer path
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = x.cpu()
    dt = time.perf_counter() - t0
    _d2h_mbps[str(device)] = out.numel() * 4 / 1e6 / max(dt, 1e-9)
    return _d2h_mbps[str(device)]


def _config_key(info: hca_frame.HcaInfo) -> tuple:
    return (info.channels, info.version, info.frame_size,
            info.min_resolution, info.max_resolution, info.total_band_count,
            info.base_band_count, info.stereo_band_count,
            info.bands_per_hfr_group, info.hfr_group_count,
            info.channel_config, info.track_count, info.ath_type)


def decode_batch(blobs: Sequence[bytes], key: int = 0, subkey: int = 0,
                 subkeys: Optional[Sequence[int]] = None, *,
                 device="cuda", mesh: Optional[Mesh] = None,
                 return_arrays: bool = False, on_error: str = "raise",
                 stats: Optional[DecodeStats] = None) -> List:
    """Decode many HCA streams on `device` in batches.

    mesh (parallel.make_mesh; it replaces `device`): streams shard over
    its dp axis, frames over its sp axis. Shard (d, s) gets its own
    unpacker on its device and the H2D of its own frames; shard s > 0 also
    takes shard s-1's last frame ahead of its own (a device-to-device copy,
    the JAX package's ppermute halo), decodes it for the overlap-add carry
    and drops its PCM. v3 PNS streams keep their kernels under sp: each
    shard continues each stream's noise LCG from the draws of the shards
    before it (an exclusive scan of the shards' draw totals, on the host).
    Every shard's kernels are enqueued before the first PCM fetch.

    on_error: "raise" aborts the batch on any corrupt stream; "isolate"
    keeps going, and a failed stream comes back as its exception object.

    Returns WAV bytes per stream, or (pcm16 [samples, C], HcaInfo) pairs
    when return_arrays. Byte-equal to pycricodecs_tpu.parallel.decode_batch,
    with or without a mesh.
    """
    if on_error not in ("raise", "isolate"):
        raise ValueError("on_error must be 'raise' or 'isolate'")
    devices = ([as_device(device)] if mesh is None
               else list(dict.fromkeys(check_mesh(mesh).flat_devices())))
    t_start = time.perf_counter()
    infos: List = []
    failures: dict = {}
    for i, blob in enumerate(blobs):
        blob = bytes(blob)
        try:
            hs = int.from_bytes(blob[6:8], "big")
            info = hca_frame.parse_header(blob[:hs])
        except ValueError as exc:  # HcaError: isolated per stream
            if on_error == "raise":
                raise
            failures[i] = exc
            infos.append(None)
            continue
        sk = subkeys[i] if subkeys is not None else subkey
        info.set_key(hca_crypt.scramble_subkey(key, sk))
        infos.append((info, blob, hs))

    groups: dict = {}
    for idx, entry in enumerate(infos):
        if entry is None:
            continue
        info = entry[0]
        groups.setdefault(
            _config_key(info) + (int(info.sample_rate),
                                 bytes(np.asarray(info.cipher, np.uint8))),
            []).append(idx)
    # a config the unpacker refuses (the scalefactor count past 128, or
    # at 128 with the v3 HFR extension) fails each of its streams, before
    # any decode starts
    unpackers = {}
    for gk, group in groups.items():
        try:
            # one unpacker a device of the mesh (or the one device)
            unpackers[gk] = {d: hca_unpack_device.DeviceUnpacker(
                infos[group[0]][0], device=d) for d in devices}
        except hca_frame.HcaError as exc:
            if on_error == "raise":
                raise
            failures.update(dict.fromkeys(group, exc))

    results: List = [None] * len(blobs)
    for gk, group in groups.items():
        ups = unpackers.get(gk)
        if ups is None:
            continue
        if on_error == "raise":
            _decode_group(ups, group, infos, results, stats, mesh)
            continue
        try:
            _decode_group(ups, group, infos, results, stats, mesh)
        except hca_frame.HcaError:
            # a stream in this group is corrupt: decode one by one so one
            # bad member doesn't take down its group
            for idx in group:
                try:
                    _decode_group(ups, [idx], infos, results, stats, mesh)
                except hca_frame.HcaError as exc:
                    failures[idx] = exc

    out = []
    for i, entry in enumerate(infos):
        if entry is None or i in failures:
            out.append(failures[i])
            continue
        info, item = entry[0], results[i]
        if return_arrays:
            out.append((item, info))
        else:
            looping, loop_start, loop_end = hca_model.loop_points(info)
            out.append(wavmod.write_wav(
                item.reshape(-1), info.channels, info.sample_rate,
                looping=looping, loop_start=loop_start, loop_end=loop_end))
    if stats is not None:
        stats.streams += len(blobs)
        stats.groups += len(groups)
        stats.failed_streams += len(failures)
        stats.bytes_in += sum(len(b) for b in blobs)
        stats.frames += sum(e[0].frame_count for e in infos if e is not None)
        stats.samples_out += sum(
            int(np.size(r)) for r in results if r is not None)
        stats.total_seconds += time.perf_counter() - t_start
    return out


def decode_rows(up: hca_unpack_device.DeviceUnpacker, frames: torch.Tensor,
                info, seed: int = 1):
    """The device half of a stream decode: enciphered frames u8 [B, F, fs]
    (sync and CRC checked) of B streams of `info`'s config -> (interleaved
    PCM16 [B, F * 1024, C], unpack error bool [B, F]) on the unpacker's
    device, untrimmed. Kernels B1 and B2 unpack every frame, the PNS noise
    maps follow when min_resolution is 0 (each stream's LCG from `seed`),
    then kernel B3; each stream's first frame has a zero overlap carry
    (the JAX fused decode's `core`, pipeline.py:461-485)."""
    B, F, fs = frames.shape
    qc, sf, res, inten, err = up(frames.reshape(B * F, fs))
    pcm = transform_rows(up, info, (qc, sf, res, inten), B, seed=seed)
    return pcm, err.view(B, F)


def transform_rows(up: hca_unpack_device.DeviceUnpacker, info, rows, B: int,
                   seed: int = 1, draws_before=None) -> torch.Tensor:
    """The second half of decode_rows: the unpacked rows (qc, sf, res,
    inten) of B streams' F frames each, frame-major per stream, through
    the PNS noise maps (min_resolution 0; each stream's LCG from `seed`,
    past draws_before i64 [B] draws where given) and kernel B3 ->
    interleaved PCM16 [B, F * 1024, C]."""
    qc, sf, res, inten = rows
    C = up.C
    F = qc.shape[0] // B
    noise = None
    if info.min_resolution == 0:
        # v3 PNS: the fill applies whenever min_resolution is 0, as in the
        # JAX fused device path (apply_noise=up.need_noise)
        noise = tuple(m.view(B, F, C, 8, 128) for m in up.noise_maps(
            sf, res, B, seed=seed, draws_before=draws_before))
    hfr, cfg = hca_kernels.transform_config(info)
    pcm = hca_kernels.hca_decode_transform_batched(
        qc.view(B, F, C, 8, 128), sf.view(B, F, C, 128),
        res.view(B, F, C, 128), inten.view(B, F, C, 8), hfr, noise=noise,
        **cfg)
    return pcm.view(B, F * SAMPLES_PER_FRAME, C)


def _decode_sharded(ups: dict, frames_np: np.ndarray, info, mesh: Mesh):
    """decode_rows over the (dp, sp) grid of `mesh`: enciphered frames u8
    [Bp, Fp, fs] on the host (Bp a multiple of dp, Fp of sp) -> (PCM16
    [Bp, Fp * 1024, C], error flags bool [Bp, Fp]) on the host."""
    dp, sp = mesh.dp, mesh.sp
    grid = mesh.devices.reshape(dp, sp)
    Bp, Fp, fs = frames_np.shape
    Bs, Fs = Bp // dp, Fp // sp
    # each shard's own frames, copied to its device
    own = [[torch.from_numpy(np.ascontiguousarray(
        frames_np[d * Bs:(d + 1) * Bs, s * Fs:(s + 1) * Fs])).to(grid[d, s])
        for s in range(sp)] for d in range(dp)]
    # the halo: shard s > 0 decodes shard s-1's last frame ahead of its own
    # for the overlap-add carry into its first frame; shard 0 keeps the
    # zero carry of a stream's head
    frames = [[own[d][0]] + [torch.cat(
        [own[d][s - 1][:, -1:].to(grid[d, s]), own[d][s]], dim=1)
        for s in range(1, sp)] for d in range(dp)]
    unpacked = [[ups[grid[d, s]](frames[d][s].reshape(-1, fs))
                 for s in range(sp)] for d in range(dp)]
    halo = [0] + [1] * (sp - 1)
    draws_before = [[None] * sp for _ in range(dp)]
    if info.min_resolution == 0 and sp > 1:
        # v3 PNS: a stream's noise LCG runs on across its frames, so shard
        # s starts after the draws of shards 0..s-1 (an exclusive scan of
        # the shards' totals); its halo frame's draws are its left
        # neighbour's, and it draws them again from there
        for d in range(dp):
            per_frame = [ups[grid[d, s]].frame_draws(*unpacked[d][s][1:3])
                         .view(Bs, -1).cpu().numpy() for s in range(sp)]
            done = np.zeros(Bs, np.int64)
            for s in range(sp):
                draws_before[d][s] = torch.from_numpy(
                    done - per_frame[s][:, :halo[s]].sum(1))
                done = done + per_frame[s][:, halo[s]:].sum(1)
    pcm, err = [], []
    for d in range(dp):
        for s in range(sp):
            qc, sf, res, inten, e = unpacked[d][s]
            p = transform_rows(ups[grid[d, s]], info, (qc, sf, res, inten),
                               Bs, draws_before=draws_before[d][s])
            pcm.append(p[:, halo[s] * SAMPLES_PER_FRAME:])
            err.append(e.view(Bs, -1)[:, halo[s]:])
    # every shard is enqueued: now the fetches
    pcm = [p.cpu().numpy() for p in pcm]
    err = [e.cpu().numpy() for e in err]
    return (np.concatenate([np.concatenate(pcm[d * sp:(d + 1) * sp], 1)
                            for d in range(dp)]),
            np.concatenate([np.concatenate(err[d * sp:(d + 1) * sp], 1)
                            for d in range(dp)]))


def _decode_group(ups: dict, group, infos, results,
                  stats: Optional[DecodeStats] = None,
                  mesh: Optional[Mesh] = None) -> None:
    """Decode one (config, sample rate, cipher) group, CHUNK_STREAMS streams
    per device batch, into results[idx] (pcm16 [samples, C]); ups holds
    the group's unpacker on each device. With a mesh, the chunk is a
    multiple of dp and the frame count one of sp, so that the shards are
    equal; the padded rows and frames are zero frames, dropped. (The JAX
    package rounds the frame count to 32 x sp to bound its compiled
    shapes; the port compiles nothing per shape, and a padded frame is
    work: 5 times the frames of a 1 s stream under sp = 8.)"""
    info0 = infos[group[0]][0]
    fs = info0.frame_size
    fmax = max(infos[i][0].frame_count for i in group)
    chunk = CHUNK_STREAMS
    if mesh is not None:
        fmax = -(-fmax // mesh.sp) * mesh.sp
        chunk = -(-chunk // mesh.dp) * mesh.dp
    t_unpack = t_device = t_fetch = 0.0
    for start in range(0, len(group), chunk):
        members = group[start:start + chunk]
        Bc = len(members)
        Bp = Bc if mesh is None else -(-Bc // mesh.dp) * mesh.dp
        t0 = time.perf_counter()
        frames_np = np.zeros((Bp, fmax, fs), dtype=np.uint8)
        real_frames = []
        for b, idx in enumerate(members):
            info, blob, hs = infos[idx]
            data = blob[hs:hs + info.frame_count * fs]
            n = len(data) // fs
            real_frames.append(n)
            arr = np.frombuffer(data, np.uint8, count=n * fs).reshape(n, fs)
            if not (arr[:, :2] == 0xFF).all():
                raise hca_frame.HcaError("Frame sync lost")
            frames_np[b, :n] = arr
        # one batched CRC sweep; zero padding rows have CRC 0
        if crc16_batch(frames_np.reshape(-1, fs)).any():
            raise hca_frame.HcaError("Frame checksum mismatch")
        t1 = time.perf_counter()
        if mesh is None:
            up, = ups.values()
            pcm, err = decode_rows(up, torch.from_numpy(frames_np), info0)
            t2 = time.perf_counter()
            if bool(err.any()):
                raise hca_frame.HcaError("Unpack error (device)")
            out = pcm.cpu().numpy()
        else:
            # enqueue and fetch are one step here (t2 = t1)
            t2 = t1
            out, err = _decode_sharded(ups, frames_np, info0, mesh)
            if err.any():
                raise hca_frame.HcaError("Unpack error (device)")
        for b, idx in enumerate(members):
            info = infos[idx][0]
            samples = (info.frame_count * SAMPLES_PER_FRAME
                       - info.encoder_delay - info.encoder_padding)
            pcm_b = out[b, info.encoder_delay:info.encoder_delay + samples]
            # owned copy: a view would pin the whole fetched chunk buffer
            pcm_b = pcm_b.copy()
            # truncated stream: the reference zeroes everything past the
            # last real frame (hca.cpp:3428-3430); the zero frames past it
            # decode to silence except the first, where the last real
            # frame's overlap-add carry bleeds through
            usable = (real_frames[b] * SAMPLES_PER_FRAME
                      - info.encoder_delay)
            if usable < pcm_b.shape[0]:
                pcm_b[max(usable, 0):] = 0
            results[idx] = pcm_b
        t3 = time.perf_counter()
        t_unpack += t1 - t0
        t_device += t2 - t1
        t_fetch += t3 - t2
        if stats is not None:
            stats.device_unpack_streams += Bc
    if stats is not None:
        stats.unpack_seconds += t_unpack
        stats.device_seconds += t_device
        stats.fetch_seconds += t_fetch


# ---------------------------------------------------------------------------
# HCA key search
# ---------------------------------------------------------------------------

#: (key, frame) rows per device batch of the key search: bounds its memory
KEY_ROWS = 131072


def _lap(stats: Optional[dict], name: str, t0: float, device) -> float:
    """Add the seconds since t0 to stats[name] (after a synchronise, so the
    device work is in them) and return the new start; no-op without stats."""
    if stats is None:
        return t0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t = time.perf_counter()
    stats[name] = stats.get(name, 0.0) + t - t0
    return t


def _key_tables(info, candidates, subkey: int, device, zero_is_plain=False):
    """(cipher tables u8 [T, 256], each candidate's table i64 [K]) on
    `device`. Type 56: one table per candidate, the key times the subkey
    factor mod 2^64 (as JAX pipeline.py:1103-1109); types 0 and 1 ignore
    the key: one table for all. zero_is_plain: a type-56 key that is 0
    after the subkey takes the identity table, as a stream keyed with 0
    does (score_key), where the batch tables give _cipher56(0)'s."""
    K = len(candidates)
    if info.ciph_type != 56:
        table = hca_crypt.cipher_table(info.ciph_type, 0)
        return (torch.from_numpy(table[None].copy()).to(device),
                torch.zeros(K, dtype=torch.int64, device=device))
    keys = np.asarray(candidates, dtype=np.uint64)
    if subkey:
        factor = np.uint64(hca_crypt.scramble_subkey(1, subkey))
        with np.errstate(over="ignore"):
            keys = keys * factor
    tables = hca_crypt.cipher_tables_56_batch(keys, device=device)
    if zero_is_plain:
        plain = torch.from_numpy(keys == 0).to(device)
        tables[plain] = torch.arange(256, device=device).to(torch.uint8)
    return tables, torch.arange(K, device=device)


def _frame_status(up, frames, pre, tables, tix, nf: int, want_soa: bool):
    """The bitstream half of the key test (clHCA_TestBlock up to the wave,
    JAX hca_frame.test_frames_native) for each (key, frame) row of the keys
    with tables[tix] and the first nf frames: status i64 [Kc, nf] (0 silent,
    -1 bad sync or CRC, unpack error or nonzero tail, -6 cursor past
    fs * 8 - 14, 1 clean), and with want_soa the unpacked rows (qc, sf,
    res, inten), [Kc * nf, C, ...] key-major, else None."""
    Kc, fs = tix.shape[0], up.fs
    rows = frames[:nf].unsqueeze(0).expand(Kc, nf, fs).reshape(Kc * nf, fs)
    dec = up.decipher(rows, tables, tix.repeat_interleave(nf))
    sf, res, inten, cur, err = up.side_info(dec)
    qc, end = up.spectra(dec, res, cur, want_qc=want_soa)
    end = end.long()
    # any nonzero deciphered byte from ceil(end / 8) to fs - 2 (exclusive)
    j = torch.arange(fs, device=dec.device)
    tail = ((dec != 0) & (j >= ((end + 7) >> 3)[:, None])
            & (j < fs - 2)).any(dim=1)
    status = torch.where(tail, -1, 1)
    status = torch.where(end + 14 > fs * 8, -6, status)
    status = torch.where(err, -1, status)
    pre_r = pre[:nf].repeat(Kc)
    status = torch.where(pre_r == 1, 0, torch.where(pre_r == -1, -1, status))
    soa = (qc, sf, res, inten) if want_soa else None
    return status.view(Kc, nf), soa


def _wave_scores(wave: torch.Tensor) -> torch.Tensor:
    """Per-frame score of f32 waves [n, C, 8, 128] (JAX pipeline.py:
    1200-1215): 2 or more clipped samples (|x| > 1) score their count,
    one scores 2; else all blank (trunc(x * 32768) in {0, -1}, in f64)
    scores 0, channel 0 blank beside a non-blank channel 1 scores 3, the
    rest 1."""
    n, C = wave.shape[0], wave.shape[1]
    n_samp = 8 * 128
    mag = wave.abs()
    clips = (mag > 1.0).reshape(n, -1).sum(dim=1)
    scaled = torch.trunc(wave.double() * 32768.0)
    blank = (mag <= 1.0) & ((scaled == 0) | (scaled == -1))
    blanks = blank.reshape(n, -1).sum(dim=1)
    chblank = blank.reshape(n, C, -1).sum(dim=2)
    cl = torch.where(clips == 1, 2, clips)
    sc = torch.where(cl > 1, cl, 1)
    all_blank = blanks == C * n_samp
    sc = torch.where((cl <= 1) & all_blank, 0, sc)
    if C >= 2:
        half = ((cl <= 1) & ~all_blank & (chblank[:, 0] == n_samp)
                & (chblank[:, 1] != n_samp))
        sc = torch.where(half, 3, sc)
    return sc


def _score_keys(up, info, frames, pre, tables, tix, F: int,
                stats: Optional[dict]) -> torch.Tensor:
    """Summed frame scores i64 [Kc] of keys that passed the first frames:
    every frame's status again, then the clean frames' waves."""
    dev = frames.device
    t0 = time.perf_counter()
    Kc, C = tix.shape[0], info.channels
    status, (qc, sf, res, inten) = _frame_status(up, frames, pre, tables,
                                                 tix, F, True)
    t0 = _lap(stats, "phase2", t0, dev)
    frame_scores = torch.where(status < 0, -1, 0).view(-1)
    live = (status == 1).view(-1)
    sel = live.nonzero().squeeze(1)
    n = int(sel.numel())
    if n:
        noise = None
        if info.min_resolution == 0:
            # v3 PNS: each key's LCG from 1 across its clean frames only
            noise = tuple(m[sel].view(n, 1, C, 8, 128)
                          for m in up.noise_maps(sf, res, Kc, live=live))
        hfr, cfg = hca_kernels.transform_config(info)
        # each clean frame alone: T = 8 rows and a zero carry
        wave = hca_kernels.hca_decode_wave(
            qc[sel].view(n, 1, C, 8, 128), sf[sel].view(n, 1, C, 128),
            res[sel].view(n, 1, C, 128), inten[sel].view(n, 1, C, 8), hfr,
            noise=noise, **cfg)
        t0 = _lap(stats, "wave", t0, dev)
        frame_scores[sel] = _wave_scores(wave)
    frame_scores = frame_scores.view(Kc, F)
    total = frame_scores.sum(dim=1)
    total = torch.where((frame_scores < 0).any(dim=1), -1, total)
    _lap(stats, "scoring", t0, dev)
    return total


def _find_key(data, candidates, subkey: int, max_frames: int, device,
              stats: Optional[dict], zero_is_plain: bool) -> np.ndarray:
    device = as_device(device)
    t0 = time.perf_counter()
    data = bytes(data)
    hs = int.from_bytes(data[6:8], "big")
    info = hca_frame.parse_header(data[:hs])
    fs = info.frame_size
    F = min(max_frames, info.frame_count)
    raw = data[hs:hs + F * fs]      # as the JAX slice, negative F included
    F = len(raw) // fs
    candidates = list(candidates)
    K = len(candidates)
    scores = np.full(K, -1, dtype=np.int64)
    if K == 0 or F == 0:
        return scores
    up = hca_unpack_device.DeviceUnpacker(info, device=device)
    # key-independent prechecks (hca_frame.test_frames_native): silent
    # first (score 0), then sync and CRC (-1)
    fb = np.frombuffer(raw, np.uint8, count=F * fs).reshape(F, fs)
    silent = ~fb[:, 2:fs - 2].any(axis=1)
    bad = (fb[:, 0] != 0xFF) | (fb[:, 1] != 0xFF) | (crc16_batch(fb) != 0)
    pre = torch.from_numpy(np.where(silent, 1, np.where(bad, -1, 0))
                           .astype(np.int64)).to(device)
    frames = torch.from_numpy(fb.copy()).to(device)
    tables, tix = _key_tables(info, candidates, subkey, device,
                              zero_is_plain)
    t0 = _lap(stats, "tables", t0, device)

    # phase 1: the cursor-only pass over the first frames of every key;
    # most wrong keys fail the bitstream rules there
    nf = min(2, F)
    step = max(1, KEY_ROWS // nf)
    alive = []
    for k0 in range(0, K, step):
        status, _ = _frame_status(up, frames, pre, tables,
                                  tix[k0:k0 + step], nf, False)
        alive.append((status >= 0).all(dim=1))
    alive_idx = torch.cat(alive).nonzero().squeeze(1)
    t0 = _lap(stats, "phase1", t0, device)

    # phase 2: every frame of the surviving keys, and their waves
    step = max(1, KEY_ROWS // F)
    for k0 in range(0, int(alive_idx.numel()), step):
        idx = alive_idx[k0:k0 + step]
        total = _score_keys(up, info, frames, pre, tables, tix[idx], F,
                            stats)
        scores[idx.cpu().numpy()] = total.cpu().numpy()
    return scores


def find_key(data: bytes, candidates, subkey: int = 0, max_frames: int = 16,
             *, device="cuda", stats: Optional[dict] = None) -> np.ndarray:
    """Score many candidate keycodes against one enciphered HCA stream on
    `device`; int64 scores aligned with `candidates`, equal to
    pycricodecs_tpu.parallel.find_key's: -1 = rejected; among the rest the
    LOWEST positive total is the most plausible (1 per clean frame, clips
    inflate it), 0 = all silent. Rank with `rank_keys`.

    stats: a dict that collects the seconds of each stage ("tables",
    "phase1", "phase2", "wave", "scoring"), each ended by a synchronise;
    None (the default) adds no synchronise. Raises HcaError for a header
    that does not parse or a config the unpacker refuses."""
    return _find_key(data, candidates, subkey, max_frames, device, stats,
                     zero_is_plain=False)


def score_key(data: bytes, keycode: int, subkey: int = 0,
              max_frames: int = 16, *, device="cuda") -> int:
    """Summed key-test score of one keycode over the first frames of an HCA
    stream, equal to pycricodecs_tpu.ops.hca_frame.score_key: find_key of
    one candidate, except that a key of 0 (after the subkey) deciphers with
    the identity table, as a stream keyed with 0 does."""
    return int(_find_key(data, [keycode], subkey, max(max_frames, 0), device,
                         None, zero_is_plain=True)[0])


def rank_keys(scores) -> np.ndarray:
    """Candidate indices best-first from find_key/score_key totals:
    accepted keys (> 0) by ascending total, then all-silent keys (0), then
    rejected keys (< 0) (JAX pipeline.py:1224-1233)."""
    s = np.asarray(scores, dtype=np.int64)
    grp = np.where(s > 0, 0, np.where(s == 0, 1, 2))
    return np.lexsort((s, grp))


# ---------------------------------------------------------------------------
# ADX
# ---------------------------------------------------------------------------

def _lane_tensors(device, *arrays) -> List[torch.Tensor]:
    """int32 numpy lane vectors -> device tensors."""
    return [torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)
            for a in arrays]


def _parse_adx(blob: bytes, strict_cri_check: bool = True):
    """(header, payload blocks u8 [nb, C, block_size], (c0, c1)) of one ADX
    stream; raises where the JAX package's decode of it raises (header,
    payload slicing, the mode 3/4 coefficients)."""
    h = adx_model.parse_adx_header(blob, strict_cri_check=strict_cri_check)
    payload = adx_model._payload_blocks(blob, h)
    coef = (0, 0) if h.encoding_mode == 2 else \
        adx_model.calculate_coefficients(h.highpass_frequency, h.sample_rate)
    return h, payload, coef


def _stack_adx_group(parsed, members):
    """Raw blocks of a decode group (entries of _parse_adx) as lanes u8
    [L, nb, block_size] (zero padded to the group's longest payload), their
    history and mode 3/4 coefficients i32 [L], and (idx, first lane,
    channels, blocks) per stream."""
    h0 = parsed[members[0]][0]
    payloads = [parsed[i][1] for i in members]
    nlanes = sum(parsed[i][0].channels for i in members)
    nb = max(pl.shape[0] for pl in payloads)
    lanes = np.zeros((nlanes, nb, h0.block_size), dtype=np.uint8)
    h1 = np.zeros(nlanes, dtype=np.int32)
    h2 = np.zeros(nlanes, dtype=np.int32)
    c0 = np.zeros(nlanes, dtype=np.int32)
    c1 = np.zeros(nlanes, dtype=np.int32)
    spans = []
    lane = 0
    for idx, pl in zip(members, payloads):
        h = parsed[idx][0]
        ch = h.channels
        lanes[lane:lane + ch, :pl.shape[0]] = np.moveaxis(pl, 1, 0)
        h1[lane:lane + ch], h2[lane:lane + ch] = adx_model._history_init(h)
        c0[lane:lane + ch], c1[lane:lane + ch] = parsed[idx][2]
        spans.append((idx, lane, ch, pl.shape[0]))
        lane += ch
    return lanes, h1, h2, c0, c1, spans


def _interleave(pcm: np.ndarray, lane0: int, h, n: int) -> np.ndarray:
    """One stream's interleaved PCM16 [sample_count * channels] from the
    lanes [L, N]: the first n decoded samples, zero past them."""
    ch, count = h.channels, h.sample_count
    out = np.zeros(count * ch, dtype=np.int16)
    have = min(count, n)
    out.reshape(count, ch)[:have] = pcm[lane0:lane0 + ch, :have].T
    return out


def adx_decode_batch(blobs: Sequence[bytes], *, device="cuda",
                     mesh: Optional[Mesh] = None,
                     strict_cri_check: bool = True,
                     wrap: bool = False) -> List[bytes]:
    """Decode many ADX streams on `device`; returns WAV bytes per stream.

    Two arithmetics, which differ only on mode 4 blocks whose scale times
    code leaves int32 (a scale word of 13 mod 32 is 2^31):
    - wrap=False (default): the JAX host decoders' int64 arithmetic, byte-
      equal to pycricodecs_tpu.parallel.adx_decode_batch(blobs) (its
      default native engine) and to models.adx.decode;
    - wrap=True: XLA's int32 wrap, byte-equal to pycricodecs_tpu.parallel.
      adx_decode_batch(blobs, device=True).
    strict_cri_check=False skips the reference's 7th-signature-byte check.

    Streams are grouped by (encoding_mode, bit_depth, block_size); each
    group is one launch of kernel B7 with per-lane history and
    coefficients, so sample rates, highpass values and versions mix freely.
    A bad header raises before anything is decoded.

    mesh (parallel.make_mesh; it replaces `device`): the lanes (streams x
    channels) shard over every device of the mesh, dp x sp flattened,
    padded with silent lanes to a multiple of that count; each shard is one
    launch of B7 on its device, and the blocks are not split. B7 runs each
    lane's AR(2) chain serially, so a device holding a chain's later blocks
    would only wait for its left neighbour's final history; the JAX
    package splits blocks over sp because its meshed engine is a block-
    parallel fixpoint, which the port does not carry. The bytes are the
    same either way, and a mesh does not change the arithmetic: the JAX
    meshed call is its device engine, whose answer is wrap=True's."""
    parsed = [_parse_adx(bytes(b), strict_cri_check) for b in blobs]
    return _adx_decode_parsed(parsed, as_device(device), wrap, mesh)


def _fetch_rows(parts) -> np.ndarray:
    """The shards' device outputs on the host, joined along their rows
    (one shard: its own array, not a copy)."""
    host = [p.cpu().numpy() for p in parts]
    return host[0] if len(host) == 1 else np.concatenate(host)


def _lane_shards(devices, *arrays) -> list:
    """Per device, its equal share of each array's rows (lanes), zero
    lanes added to the last shards: [(device, [shard arrays...]), ...]."""
    shards = [shard_rows(a, len(devices)) for a in arrays]
    return [(dev, [sh[i] for sh in shards]) for i, dev in enumerate(devices)]


def _adx_decode_parsed(parsed, device, wrap: bool,
                       mesh: Optional[Mesh] = None) -> List[bytes]:
    """WAV bytes of the streams parsed by _parse_adx (adx_decode_batch)."""
    devices = [device] if mesh is None else check_mesh(mesh).flat_devices()
    groups: dict = {}
    for idx, (h, *_) in enumerate(parsed):
        groups.setdefault((h.encoding_mode, h.bit_depth, h.block_size),
                          []).append(idx)

    results: List = [None] * len(parsed)
    for (mode, bit_depth, _), members in groups.items():
        lanes, h1, h2, c0, c1, spans = _stack_adx_group(parsed, members)
        L, nb, bs = lanes.shape
        spb = adx_model.samples_per_block(bs, bit_depth)
        if nb:
            pcm_dev = []
            for dev, (pl, *lane_args) in _lane_shards(
                    devices, lanes, h1, h2, c0, c1):
                pcm_dev.append(adx_kernels.adx_decode_device(
                    torch.from_numpy(pl).to(dev),
                    *_lane_tensors(dev, *lane_args), bit_depth=bit_depth,
                    encoding_mode=mode, wrap=wrap))
            pcm = _fetch_rows(pcm_dev)[:L].reshape(L, nb * spb)
        else:
            pcm = np.zeros((L, 0), dtype=np.int16)
        for idx, lane0, _, nblk in spans:
            h = parsed[idx][0]
            results[idx] = wavmod.write_wav(
                _interleave(pcm, lane0, h, nblk * spb), h.channels,
                h.sample_rate, looping=h.looping,
                loop_start=h.loop_start_sample, loop_end=h.loop_end_sample)
    return results


def _stack_adx_pcm(preps, members, spb: int):
    """PCM16 of the streams to encode as lanes i16 [L, nb, spb] (zero padded
    to the longest stream), their coefficients and history i32 [L], and
    (idx, first lane, channels) per stream."""
    nlanes = sum(preps[i].channels for i in members)
    nb = max(preps[i].frames for i in members)
    pcm = np.zeros((nlanes, nb, spb), dtype=np.int16)
    c0 = np.zeros(nlanes, dtype=np.int32)
    c1 = np.zeros(nlanes, dtype=np.int32)
    h1 = np.zeros(nlanes, dtype=np.int32)
    h2 = np.zeros(nlanes, dtype=np.int32)
    spans = []
    lane = 0
    for idx in members:
        prep = preps[idx]
        ch = prep.channels
        pcm[lane:lane + ch, :prep.frames] = prep.blocks
        c0[lane:lane + ch] = prep.c0
        c1[lane:lane + ch] = prep.c1
        h1[lane:lane + ch] = prep.h1
        h2[lane:lane + ch] = prep.h2
        spans.append((idx, lane, ch))
        lane += ch
    return pcm, c0, c1, h1, h2, spans


def adx_encode_batch(wav_blobs: Sequence[bytes], *, bit_depth: int = 4,
                     block_size: int = 0x12, encoding_mode: int = 3,
                     highpass_frequency: int = 0x1F4, filter_: int = 0,
                     version: int = 4, force_not_looping: bool = False,
                     scale_fix: bool = False, device="cuda",
                     mesh: Optional[Mesh] = None) -> List[bytes]:
    """Encode many WAVs to ADX on `device`; returns ADX bytes per WAV,
    byte-equal to pycricodecs_tpu.parallel.adx_encode_batch and
    pycricodecs_tpu.models.adx.encode with the same keywords.

    Every stream with at least one block goes into one launch of kernel B8
    (per-lane coefficients, so sample rates mix); a WAV shorter than one
    block gets a header and EOF block only. A WAV the encoder refuses
    raises before anything is encoded.

    mesh (parallel.make_mesh; it replaces `device`): as adx_decode_batch's,
    the lanes shard over every device of the mesh (one B8 launch each,
    silent lanes padding the last shards) and the blocks are not split:
    B8's chains are serial per lane. The bytes are the meshless call's."""
    devices = ([as_device(device)] if mesh is None
               else check_mesh(mesh).flat_devices())
    preps = [adx_model._encode_prep(
        bytes(b), bit_depth=bit_depth, block_size=block_size,
        encoding_mode=encoding_mode, highpass_frequency=highpass_frequency,
        filter_=filter_, version=version,
        force_not_looping=force_not_looping) for b in wav_blobs]
    stream_kw = dict(bit_depth=bit_depth, block_size=block_size,
                     encoding_mode=encoding_mode,
                     highpass_frequency=highpass_frequency, version=version)
    results: List = [None] * len(wav_blobs)
    members = []
    for idx, prep in enumerate(preps):
        if prep.frames == 0:
            empty = np.zeros((0, prep.channels, block_size), dtype=np.uint8)
            results[idx] = adx_model._assemble_stream(prep, empty,
                                                      **stream_kw)
        else:
            members.append(idx)
    if not members:
        return results
    spb = adx_model.samples_per_block(block_size, bit_depth)
    pcm, c0, c1, h1, h2, spans = _stack_adx_pcm(preps, members, spb)
    blocks_dev = [adx_kernels.adx_encode_device(
        torch.from_numpy(lanes).to(dev), *_lane_tensors(dev, *lane_args),
        block_size=block_size, bit_depth=bit_depth,
        encoding_mode=encoding_mode, filter_=filter_, scale_fix=scale_fix)
        for dev, (lanes, *lane_args) in _lane_shards(
            devices, pcm, c0, c1, h1, h2)]
    blocks = _fetch_rows(blocks_dev)
    for idx, lane0, ch in spans:
        prep = preps[idx]
        payload = np.ascontiguousarray(
            np.moveaxis(blocks[lane0:lane0 + ch, :prep.frames], 0, 1))
        results[idx] = adx_model._assemble_stream(prep, payload, **stream_kw)
    return results


# ---------------------------------------------------------------------------
# HCA encode
# ---------------------------------------------------------------------------

def hca_encode_batch(wavs: Sequence[bytes], quality: int = 1,
                     force_not_looping: bool = False, *,
                     device="cuda", mesh: Optional[Mesh] = None) -> List[bytes]:
    """Encode many WAVs to HCA v2.0 on `device`; returns HCA bytes per WAV,
    byte-equal to pycricodecs_tpu.parallel.hca_encode_batch(wavs, quality,
    force_not_looping, device=True) and to the JAX package's
    hca_encode_host.encode.

    Streams are grouped by (channels, sample rate); each group is one
    device encode. A WAV that does not parse raises before anything is
    encoded. mesh (parallel.make_mesh; it replaces `device`): each group's
    streams shard over its dp axis, padded with silent streams that are
    dropped; each shard runs B6 and the packer on its device."""
    device = as_device(device)
    devices = None if mesh is None else check_mesh(mesh).stream_devices()
    parsed = [wavmod.parse_wav(bytes(b)) for b in wavs]
    groups: dict = {}
    for i, w in enumerate(parsed):
        groups.setdefault((w.channels, w.sample_rate), []).append(i)
    results: List = [None] * len(wavs)
    for members in groups.values():
        encoded = hca_encode_device.encode_wavs(
            [parsed[i] for i in members], quality, force_not_looping,
            device=device, devices=devices)
        for i, blob in zip(members, encoded):
            results[i] = blob
    return results


# ---------------------------------------------------------------------------
# AHX / MPEG Layer II decode
# ---------------------------------------------------------------------------

def _parse_mp2(blob: bytes):
    """(first header, frame walk, total samples or 0, sample rate) of an
    AHX or bare Layer II stream; ValueError if it does not parse."""
    offset, total, rate = 0, 0, 0
    if ahx_model.is_ahx(blob):
        info = ahx_model.parse_header(blob)
        offset = info["data_offset"]
        total = info["total_samples"]
        rate = info["sample_rate"]        # the container rate wins
    hdr0, walk = mp2_frame.scan_frames(blob, offset)
    return hdr0, walk, total, rate or hdr0.sample_rate


def _stack_mp2_frames(walks) -> np.ndarray:
    """Frame bytes of a group as u8 [B, Fmax, fs_max], each frame and each
    stream's frame list zero-padded."""
    fmax = max(len(w) for w in walks)
    fs_max = max(len(fr) for w in walks for _, fr in w)
    out = np.zeros((len(walks), fmax, fs_max), dtype=np.uint8)
    for b, walk in enumerate(walks):
        # the walk is contiguous: one buffer, and a window of fs_max bytes
        # at each frame's start, cleared past the frame's own size
        buf = np.frombuffer(b"".join(fr for _, fr in walk) + bytes(fs_max),
                            np.uint8)
        pos = np.array([p for p, _ in walk], np.int64) - walk[0][0]
        size = np.array([len(fr) for _, fr in walk], np.int64)
        rows = out[b, :len(walk)]
        rows[:] = np.lib.stride_tricks.sliding_window_view(buf, fs_max)[pos]
        for s in np.unique(size[size < fs_max]):
            rows[size == s, s:] = 0
    return out


def ahx_decode_batch(blobs: Sequence[bytes], *, device="cuda",
                     mesh: Optional[Mesh] = None,
                     on_error: str = "raise") -> List:
    """Decode many AHX (or bare MPEG Layer II) streams on `device`; returns
    WAV bytes per stream, byte-equal to pycricodecs_tpu.parallel.
    ahx_decode_batch(blobs, device=False).

    The host parses each stream (AHX header: data offset, total samples,
    rate; then the frame walk) and stacks the frames of every stream with
    the same channel count; per group one launch of kernel B10 unpacks
    every frame (each with its own header, so VBR streams mix in) and one
    launch of the synthesis kernel makes the PCM, which the host trims to
    min(frames * 1152, total samples) and writes as WAV.

    on_error: "raise" aborts on the first stream that does not parse (before
    anything is decoded) or has a truncated frame; "isolate" returns None for
    such streams and decodes the rest.

    mesh (parallel.make_mesh; it replaces `device`): each group's streams
    shard over its dp axis, padded with zero-frame rows that are dropped;
    each shard runs B10 and the synthesis on its device."""
    return _ahx_decode(blobs, as_device(device), on_error,
                       zero_fill=False, mesh=mesh)


def _ahx_decode(blobs: Sequence[bytes], device, on_error: str,
                zero_fill: bool, mesh: Optional[Mesh] = None) -> List:
    """ahx_decode_batch; zero_fill=True pads a stream whose frames hold
    fewer samples than its declared total with zeros up to that total (the
    single-file AHX.decode's rule) where the batch trims."""
    if on_error not in ("raise", "isolate"):
        raise ValueError("on_error must be 'raise' or 'isolate'")
    devices = [device] if mesh is None else check_mesh(mesh).stream_devices()
    parsed: List = [None] * len(blobs)
    for i, blob in enumerate(blobs):
        try:
            parsed[i] = _parse_mp2(bytes(blob))
        except ValueError:
            if on_error == "raise":
                raise
    groups: dict = {}
    for idx, p in enumerate(parsed):
        if p is not None:
            groups.setdefault(p[0].nch, []).append(idx)

    results: List = [None] * len(blobs)
    for nch, members in groups.items():
        frames_np = _stack_mp2_frames([parsed[i][1] for i in members])
        _, fmax, fs_max = frames_np.shape
        pcm_dev, err_dev = [], []
        for dev, rows in zip(devices, shard_rows(frames_np, len(devices))):
            B = rows.shape[0]
            frames = torch.from_numpy(rows).to(dev)
            codes, levels, sfidx, err = mp2_unpack_device.mp2_unpack(
                frames.view(B * fmax, fs_max), nch)
            pcm_dev.append(mp2_kernels.mp2_decode_pcm(
                codes.view(B, fmax, nch, 36, 32),
                levels.view(B, fmax, nch, 32),
                sfidx.view(B, fmax, nch, 3, 32)))
            err_dev.append(err.view(B, fmax))
        err = _fetch_rows(err_dev)
        pcm = _fetch_rows(pcm_dev)
        for row, idx in enumerate(members):
            _hdr, walk, total, rate = parsed[idx]
            if err[row, :len(walk)].any():
                # the host unpacker raises on these frames
                if on_error == "raise":
                    raise ValueError("Layer II frame truncated mid-field.")
                continue
            n = len(walk) * mp2_frame.SAMPLES_PER_FRAME
            if total:
                n = min(n, total)
            out = np.zeros((max(n, total) if zero_fill else n, nch),
                           dtype=np.int16)
            out[:n] = pcm[row, :, :n].T
            results[idx] = wavmod.write_wav(out.reshape(-1), nch, rate)
    return results


# ---------------------------------------------------------------------------
# AHX / MPEG Layer II encode
# ---------------------------------------------------------------------------

def ahx_encode_batch(wavs: Sequence[bytes],
                     bitrate_kbps: Optional[int] = None, *, device="cuda",
                     mesh: Optional[Mesh] = None, container: str = "auto",
                     joint_bound: Optional[int] = None) -> List[bytes]:
    """Encode many WAVs to AHX / raw MPEG Layer II on `device`; returns the
    bytes of pycricodecs_tpu.parallel.ahx_encode_batch(wavs, bitrate_kbps,
    container=container, joint_bound=joint_bound) (device=False, its f64
    host lane) per WAV.

    container: "ahx" wraps each stream in the AHX container (mono MPEG-2
    LSF only, AHX.encode semantics), "mp2" returns raw Layer II streams,
    "auto" picks AHX when the input is mono at an LSF rate.

    Streams are grouped by (channels, sample rate); each group is one
    device encode (ops/mp2_encode_device.encode_streams). Every WAV is
    parsed and every stream's configuration and container checked, in
    order, before anything is encoded, so a batch raises the JAX function's
    first error. The JAX function's `max_workers` (the host lane's thread
    pool) has no counterpart: each group is one launch of each kernel.

    mesh (parallel.make_mesh; it replaces `device`): each group's streams
    shard over its dp axis, padded with silent streams that are dropped;
    each shard runs K1, K2 and K3 on its device (need_db stays numpy's on
    the host, a shard at a time, after every shard's K1 is enqueued)."""
    from ..ops import mp2_encode_device, mp2_encode_host, mp2_tables

    if container not in ("auto", "ahx", "mp2"):
        raise ValueError("container must be 'auto', 'ahx' or 'mp2'")
    devices = ([as_device(device)] if mesh is None
               else check_mesh(mesh).stream_devices())
    parsed = [wavmod.parse_wav(bytes(b)) for b in wavs]

    def use_ahx(w) -> bool:
        return container == "ahx" or (
            container == "auto" and w.channels == 1
            and w.sample_rate in mp2_tables.SAMPLE_RATES_V2)

    configs: dict = {}
    for w in parsed:
        key = (w.channels, w.sample_rate)
        if key not in configs:
            configs[key] = mp2_encode_host.configure(
                w.channels, w.sample_rate, bitrate_kbps, joint_bound)
        if w.pcm16.size == 0:
            raise ValueError(mp2_encode_host.EMPTY_STREAM)
        if use_ahx(w) and (w.channels != 1 or w.sample_rate not in
                           mp2_tables.SAMPLE_RATES_V2):
            raise ValueError("AHX container requires mono PCM at an "
                             "MPEG-2 LSF rate (16000/22050/24000).")
    groups: dict = {}
    for i, w in enumerate(parsed):
        groups.setdefault((w.channels, w.sample_rate), []).append(i)
    results: List = [None] * len(wavs)
    spf = mp2_frame.SAMPLES_PER_FRAME
    for key, members in groups.items():
        C = key[0]
        lengths = [parsed[i].pcm16.size // C for i in members]
        frames = [-(-n // spf) for n in lengths]
        pcm = np.zeros((len(members), C, max(frames) * spf), np.int16)
        for row, (i, n) in enumerate(zip(members, lengths)):
            pcm[row, :, :n] = parsed[i].pcm16.reshape(n, C).T
        streams = mp2_encode_device.encode_streams_sharded(
            [torch.from_numpy(p).to(d)
             for d, p in zip(devices, shard_rows(pcm, len(devices)))],
            configs[key], frames)
        for i, stream in zip(members, streams):
            w = parsed[i]
            results[i] = (ahx_model.ahx_container(stream, w.sample_rate,
                                                  w.pcm16.size)
                          if use_ahx(w) else stream)
    return results


# ---------------------------------------------------------------------------
# AWB / ACB banks
# ---------------------------------------------------------------------------

def decode_awb(awb_obj_or_bytes, key: int = 0, mesh: Optional[Mesh] = None, *,
               decode_non_hca: bool = True, device="cuda") -> List[bytes]:
    """Decode every member of an AWB (AFS2) bank on `device`; returns one
    bytes object per member, byte-equal to pycricodecs_tpu.parallel.
    decode_awb. mesh (parallel.make_mesh; it replaces `device`) is the
    third positional parameter, as in the JAX function, and goes to the
    HCA, AHX and ADX sub-batches alike; a third argument that is not None
    or a Mesh raises TypeError (it is not `decode_non_hca`, which is
    keyword-only).

    Members route by their first bytes, as in the JAX package:
    - HCA (`HCA\\0`, or the masked `\\xC8\\xC3\\xC1\\0`): one decode_batch
      call under (key, the bank's subkey), a WAV each;
    - with decode_non_hca, `0x80 0x00` and type 0x10/0x11: one
      ahx_decode_batch call (on_error="isolate"), a WAV each, the raw bytes
      where it fails;
    - with decode_non_hca, any other `0x80 0x00` member longer than 4
      bytes: ADX, checked non-strictly, all of them through one
      adx_decode_batch launch per geometry in the JAX host decoders'
      arithmetic; a member whose header, payload or coefficients do not
      parse comes back raw;
    - anything else comes back raw."""
    from ..containers.awb import AWB

    if mesh is not None:
        check_mesh(mesh)
    device = as_device(device)
    awb = awb_obj_or_bytes if isinstance(awb_obj_or_bytes, AWB) \
        else AWB(awb_obj_or_bytes)
    members = [bytes(m) for m in awb.getfiles()]
    out: List = list(members)
    hca_idx, ahx_idx, adx_idx, adx_parsed = [], [], [], []
    for i, m in enumerate(members):
        if m[:4] in (b"HCA\x00", b"\xC8\xC3\xC1\x00"):
            hca_idx.append(i)
        elif decode_non_hca and m[:2] == b"\x80\x00" and len(m) > 4:
            if m[4] in ahx_model.AHX_TYPES:
                ahx_idx.append(i)
                continue
            try:
                adx_parsed.append(_parse_adx(m, strict_cri_check=False))
            except Exception:     # malformed: the member stays raw
                continue
            adx_idx.append(i)
    for i, wav in zip(hca_idx, decode_batch(
            [members[i] for i in hca_idx], key=key, subkey=awb.subkey,
            device=device, mesh=mesh)):
        out[i] = wav
    for i, wav in zip(ahx_idx, ahx_decode_batch(
            [members[i] for i in ahx_idx], device=device, mesh=mesh,
            on_error="isolate")):
        if wav is not None:
            out[i] = wav
    for i, wav in zip(adx_idx, _adx_decode_parsed(adx_parsed, device,
                                                  False, mesh)):
        out[i] = wav
    return out


def decode_acb(acb_obj_or_bytes, key: int = 0,
               mesh: Optional[Mesh] = None, *, device="cuda") -> List[bytes]:
    """Decode an ACB's waveform bank (embedded, or the sibling
    `<Name>.awb` of an ACB opened by path) on `device`, or over `mesh`
    (the third positional parameter, as in the JAX function): decode_awb
    of it, byte-equal to pycricodecs_tpu.parallel.decode_acb (BASELINE
    config 5)."""
    from ..containers.acb import ACB

    if mesh is not None:
        check_mesh(mesh)
    acb = acb_obj_or_bytes if isinstance(acb_obj_or_bytes, ACB) \
        else ACB(acb_obj_or_bytes)
    return decode_awb(acb.awb, key, mesh, device=device)


def encode_batch(wavs: Sequence[bytes], **adx_kwargs) -> List[bytes]:
    """Encode WAVs to ADX: adx_encode_batch (one launch of kernel B8 for
    all), the list form of pycricodecs_tpu.parallel.encode_batch; the
    keywords are adx_encode_batch's, `device` among them."""
    return adx_encode_batch(wavs, **adx_kwargs)
