#!/usr/bin/env python3
"""Where the time of the port's bank decode or encode goes, on one CUDA GPU.

Runs one 256-stream x 10 s bank (tests/data/torch_port, the banks that
chip_smoke.py drives): by default the HCA bank decode with
pycricodecs_tpu_torch.decode_batch; with --adx the ADX bank decode with
adx_decode_batch; with --hca-encode the HCA bank encode with
hca_encode_batch (256 copies of the bank's input WAV, rebuilt by
pycricodecs_tpu_torch/utils/signals.py, quality 2); with --ahx the AHX bank
decode with ahx_decode_batch (256 copies of
tests/data/torch_port/ahx/ahx_bank_lsf_mono_22k_96k_10s.ahx).

1. one warm-up run, then one plain run timed on the host clock;
2. one run under torch.profiler (CPU + CUDA activities): device time summed
   by kernel and copy name, and the device busy time (the union of all
   device intervals) against the run's wall time;
3. one run under cProfile: host seconds in the pipeline's pieces. HCA:
   header parse, frame stacking + sync check, CRC16, H2D, launches, D2H,
   trim, WAV write, next to that run's DecodeStats. ADX: header parse,
   payload slicing + lane stacking, H2D, launch, D2H, interleave, WAV write.
   HCA encode: WAV parse, init_encode, build_timeline, stacking, H2D, the
   device work's enqueue, D2H (`.cpu()`, which waits for the device), header
   assembly. AHX: header parse and frame walk (scan_frames, parse_header),
   frame stacking, H2D, the two launches, D2H, interleave + WAV write.

Prints each part with the card's name and power limit, and last one JSON
line of the numbers. There is no CPU path.

Run from the repository root:
    python3 tools/profile_torch_slice.py [--adx | --hca-encode | --ahx]
        [--trace trace.json]
"""
import argparse
import cProfile
import json
import os
import pstats
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANK = os.path.join(ROOT, "tests", "data", "torch_port",
                    "bank_q2_stereo_48k_10s.hca")
ADX_BANK = os.path.join(ROOT, "tests", "data", "torch_port", "adx",
                        "adx_m3_bd4_stereo_48k_10s.adx")
AHX_BANK = os.path.join(ROOT, "tests", "data", "torch_port", "ahx",
                        "ahx_bank_lsf_mono_22k_96k_10s.ahx")
ENCODE_QUALITY = 2
STREAMS = 256
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

# (label, file suffix or "~" for a builtin, function name substring)
HOST_PIECES = [
    ("decode_batch (whole call)", "pipeline.py", "decode_batch"),
    ("parse_header", "hca_frame.py", "parse_header"),
    ("_decode_group", "pipeline.py", "_decode_group"),
    ("crc16_batch", "crc.py", "crc16_batch"),
    ("Tensor.to (H2D, pageable)", "~", "'to' of 'torch._C."),
    ("DeviceUnpacker.__call__ (enqueue)", "hca_unpack_device.py",
     "__call__"),
    ("hca_decode_transform_batched (enqueue)", "hca_kernels.py",
     "hca_decode_transform_batched"),
    ("Tensor.cpu (wait + D2H)", "~", "'cpu' of 'torch._C."),
    ("ndarray.copy (trim)", "~", "'copy' of 'numpy.ndarray'"),
    ("write_wav", "wav.py", "write_wav"),
]
ADX_HOST_PIECES = [
    ("adx_decode_batch (whole call)", "pipeline.py", "adx_decode_batch"),
    ("_parse_adx (header, payload slicing, coefficients)", "pipeline.py",
     "_parse_adx"),
    ("_stack_adx_group (lane stacking)", "pipeline.py", "_stack_adx_group"),
    ("Tensor.to (H2D, pageable)", "~", "'to' of 'torch._C."),
    ("adx_decode_device (enqueue)", "adx_kernels.py", "adx_decode_device"),
    ("Tensor.cpu (wait + D2H)", "~", "'cpu' of 'torch._C."),
    ("_interleave", "pipeline.py", "_interleave"),
    ("write_wav", "wav.py", "write_wav"),
]
ENCODE_HOST_PIECES = [
    ("hca_encode_batch (whole call)", "pipeline.py", "hca_encode_batch"),
    ("parse_wav", "wav.py", "parse_wav"),
    ("init_encode", "hca_encode_host.py", "init_encode"),
    ("build_timeline", "hca_encode_host.py", "build_timeline"),
    ("stack_timelines (stacking, build_timeline included)",
     "hca_encode_device.py", "stack_timelines"),
    ("Tensor.to (H2D, pageable)", "~", "'to' of 'torch._C."),
    ("hca_encode_frames (enqueue; syncs in rate control)",
     "hca_encode_device.py", "hca_encode_frames"),
    ("Tensor.cpu (wait + D2H)", "~", "'cpu' of 'torch._C."),
    ("assemble (header + frames)", "hca_encode_device.py", "assemble"),
]
AHX_HOST_PIECES = [
    ("ahx_decode_batch (whole call)", "pipeline.py", "ahx_decode_batch"),
    ("_parse_mp2 (AHX header + frame walk)", "pipeline.py", "_parse_mp2"),
    ("scan_frames", "mp2_frame.py", "scan_frames"),
    ("parse_header (Layer II, per frame)", "mp2_frame.py", "parse_header"),
    ("_stack_mp2_frames", "pipeline.py", "_stack_mp2_frames"),
    ("Tensor.to (H2D, pageable)", "~", "'to' of 'torch._C."),
    ("mp2_unpack (B10 enqueue)", "mp2_unpack_device.py", "mp2_unpack"),
    ("mp2_decode_pcm (synthesis enqueue)", "mp2_kernels.py",
     "mp2_decode_pcm"),
    ("Tensor.cpu (wait + D2H)", "~", "'cpu' of 'torch._C."),
    ("write_wav", "wav.py", "write_wav"),
]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


def device_intervals(trace_path: str):
    """(name, cat, start us, duration us) of every device event."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], e["cat"], float(e["ts"]), float(e["dur"]))
            for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]


def union_us(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for _, _, ts, dur in sorted(intervals, key=lambda x: x[2]):
        lo, hi = max(ts, end), ts + dur
        if hi > lo:
            busy += hi - lo
        end = max(end, hi)
    return busy


def host_pieces(prof: cProfile.Profile, pieces=HOST_PIECES) -> dict:
    """Cumulative seconds of each `pieces` entry (summed over matches)."""
    stats = pstats.Stats(prof).stats
    out = {}
    for label, fsuffix, fname in pieces:
        total = 0.0
        for (filename, _, funcname), (_, _, _, ct, _) in stats.items():
            if fsuffix == "~":
                hit = filename == "~" and fname in funcname
            else:
                hit = filename.endswith(fsuffix) and funcname == fname
            if hit:
                total += ct
        out[label] = total
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--adx", action="store_true",
                      help="profile the ADX bank decode instead of the HCA "
                           "one")
    mode.add_argument("--hca-encode", action="store_true",
                      help="profile the HCA bank encode")
    mode.add_argument("--ahx", action="store_true",
                      help="profile the AHX bank decode")
    ap.add_argument("--trace", help="write the profiler's chrome trace here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_slice: no CUDA GPU "
                         "(torch.cuda.is_available() is False)")
    sys.path.insert(0, ROOT)
    import pycricodecs_tpu_torch as port

    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}", flush=True)
    if args.hca_encode:
        from pycricodecs_tpu_torch.utils import signals
        from pycricodecs_tpu_torch.utils.wav import write_wav
        bank = [signals.hca_wav(signals.HCA_BANK, write_wav)] * STREAMS
    else:
        path = AHX_BANK if args.ahx else ADX_BANK if args.adx else BANK
        with open(path, "rb") as f:
            bank = [f.read()] * STREAMS

    def run(stats=None) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if args.hca_encode:
            port.hca_encode_batch(bank, quality=ENCODE_QUALITY, device=dev)
        elif args.adx:
            port.adx_decode_batch(bank, device=dev)
        elif args.ahx:
            port.ahx_decode_batch(bank, device=dev)
        else:
            port.decode_batch(bank, device=dev, stats=stats)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    run()                                                   # build, warm-up
    plain_wall = run()
    print(f"[{card}] plain run: {plain_wall:.4f} s", flush=True)

    # -- device view: torch.profiler ---------------------------------------
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_wall = run()
    with tempfile.TemporaryDirectory() as tmp:
        path = args.trace or os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        dev_events = device_intervals(path)
    if not dev_events:
        raise SystemExit("profile_torch_slice: the trace holds no device "
                         "events")
    by_name: dict = {}
    for name, cat, _, dur in dev_events:
        n, t = by_name.get((cat, name), (0, 0.0))
        by_name[(cat, name)] = (n + 1, t + dur)
    busy_s = union_us(dev_events) / 1e6
    print(f"[{card}] profiled run: wall {prof_wall:.4f} s, device busy "
          f"{busy_s:.6f} s (union of {len(dev_events)} device events), "
          f"idle share {1 - busy_s / prof_wall:.4%}", flush=True)
    print(f"  {'cat':<11} {'count':>5} {'sum ms':>10}  name")
    for (cat, name), (n, t) in sorted(by_name.items(),
                                      key=lambda kv: -kv[1][1]):
        print(f"  {cat:<11} {n:>5} {t / 1e3:>10.4f}  {name}")

    # -- host view: cProfile ------------------------------------------------
    st = port.DecodeStats()
    cp = cProfile.Profile()
    cp.enable()
    cprof_wall = run(st)
    cp.disable()
    cprof = {"wall_s": cprof_wall}
    if args.adx or args.hca_encode or args.ahx:
        pieces = host_pieces(cp, ENCODE_HOST_PIECES if args.hca_encode
                             else AHX_HOST_PIECES if args.ahx
                             else ADX_HOST_PIECES)
        print(f"[{card}] cProfile run: wall {cprof_wall:.4f} s", flush=True)
    else:
        pieces = host_pieces(cp)
        stack_s = st.unpack_seconds - pieces["crc16_batch"]
        cprof.update(stats=st.as_dict(), stacking_sync_s=stack_s)
        print(f"[{card}] cProfile run: wall {cprof_wall:.4f} s; DecodeStats "
              f"unpack {st.unpack_seconds:.4f} s, device "
              f"{st.device_seconds:.4f} s, fetch {st.fetch_seconds:.4f} s, "
              f"total {st.total_seconds:.4f} s", flush=True)
    for label, secs in pieces.items():
        print(f"  {secs:>9.4f} s  {label}")
    if not (args.adx or args.hca_encode or args.ahx):
        print(f"  {stack_s:>9.4f} s  frame stacking + sync check "
              f"(DecodeStats.unpack - crc16_batch)")
    cprof["host_s"] = pieces

    print(json.dumps({
        "card": card,
        "bank": ("hca_encode" if args.hca_encode else "ahx" if args.ahx
                 else "adx" if args.adx else "hca"),
        "streams": STREAMS, "plain_wall_s": plain_wall,
        "profiled": {"wall_s": prof_wall, "device_busy_s": busy_s,
                     "idle_share": 1 - busy_s / prof_wall,
                     "device_ms": {f"{cat}:{name}": t / 1e3 for
                                   (cat, name), (_, t) in by_name.items()}},
        "cprofile": cprof}))


if __name__ == "__main__":
    main()
