#!/usr/bin/env python3
"""CRILAYLA's C2 and C1 at their size limits, on one CUDA GPU.

Two checks, both by default (--only picks one):
- round_trip: one member of --mib MiB (default 2,049: above 2^31 bytes)
  goes through `crilayla.compress_members` (kernel C2, a wrapper call
  alone: it is larger than `crilayla.C2_BUDGET`) and back through
  `crilayla.decompress_members` (kernel C1), and must come back byte for
  byte. The member: 1 MiB of random bytes (seed 20), then a run of one
  byte to the middle, then a period-3 pattern to the end, so that the
  search runs both its 32-bit and its 64-bit keys and the matches pass
  2^19 bytes and 255-byte escapes by the million.
- c1_edge: a hand-made member whose decompress size is 2^32 - 1 (the
  largest a u32 holds), three literals and one
  copy whose length is a 255-run of about 16.8 MB
  (`signals.crilayla_fill_blob`), through `crilayla.decompress_members`
  (C1); it must come back as its known bytes: 256 zeros, then the
  literal's byte throughout. Then the wrapper call alone, timed by CUDA
  events with its output left on the card.
Prints each call's time (host clock, with its copies), its peak card
memory above what was allocated before it (torch.cuda.max_memory_allocated)
per member or output byte, the card's name and power limit, and last one
JSON line. No CPU path.

Run from the repository root:
    python3 tools/check_crilayla_limits.py [--only round_trip|c1_edge]
        [--mib N]
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


def member(size: int) -> bytes:
    """1 MiB of random bytes, a run of 0x5A to size / 2, a period-3
    pattern to the end."""
    head = np.random.default_rng(20).integers(0, 256, 1 << 20,
                                              dtype=np.uint8)
    out = np.empty(size, np.uint8)
    out[:head.size] = head
    out[head.size:size // 2] = 0x5A
    tail = size - size // 2
    out[size // 2:] = np.resize(np.array([1, 0x80, 0xFE], np.uint8), tail)
    return out.tobytes()


def measured(fn):
    """(fn()'s result, seconds, peak card bytes above the start)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() - base)


def round_trip(crilayla, dev, mib: int) -> dict:
    data = member(mib << 20)
    if len(data) <= crilayla.C2_BUDGET:
        raise SystemExit("check_crilayla_limits: the member must be larger "
                         "than C2_BUDGET")
    (blob,), c2_s, c2_peak = measured(
        lambda: crilayla.compress_members([data], device=dev))
    torch.cuda.empty_cache()
    if blob is None:
        raise SystemExit("C2 refused the member")
    parsed = crilayla.parse(blob)
    (back,), c1_s, c1_peak = measured(
        lambda: crilayla.decompress_members([parsed], device=dev))
    torch.cuda.empty_cache()
    ok = back == data
    print(f"member {len(data)} bytes -> blob {len(blob)} bytes: C2 "
          f"{c2_s:.3f} s, peak {c2_peak / len(data):.3f} bytes a member "
          f"byte; C1 {c1_s:.3f} s, peak {c1_peak / len(data):.3f} bytes an "
          f"output byte; round trip {'equal' if ok else 'DIFFERS'}",
          flush=True)
    return {"member_bytes": len(data), "blob_bytes": len(blob),
            "c2_s": c2_s, "c2_peak_bytes_per_byte": c2_peak / len(data),
            "c1_s": c1_s, "c1_peak_bytes_per_byte": c1_peak / len(data),
            "round_trip_equal": ok}


def c1_edge(crilayla, CK, signals, dev) -> dict:
    size, fill = (1 << 32) - 1, 0xAB
    blob = signals.crilayla_fill_blob(size, fill)
    parsed = crilayla.parse(blob)
    (back,), c1_s, c1_peak = measured(
        lambda: crilayla.decompress_members([parsed], device=dev))
    torch.cuda.empty_cache()
    ok = (back is not None and len(back) == size + 256
          and back[:256] == bytes(256)
          and back.count(bytes([fill]), 256) == size)
    del back
    out = size + 256
    # the wrapper call alone, its output left on the card (CUDA events)
    src, meta, out_size = crilayla.pack_decompress([parsed])
    src_t = torch.from_numpy(src).to(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    CK.crilayla_decompress(src_t, meta, out_size)
    end.record()
    torch.cuda.synchronize()
    kernel_s = start.elapsed_time(end) / 1e3
    torch.cuda.empty_cache()
    print(f"C1 edge: decompress size {size} (2^32 - {(1 << 32) - size}), "
          f"{len(blob)} blob bytes: C1 {c1_s:.3f} s with its copies, "
          f"{kernel_s:.3f} s the wrapper call alone; peak "
          f"{c1_peak / out:.3f} bytes an output byte ({c1_peak} bytes); "
          f"output {'equal to' if ok else 'DIFFERS from'} its known bytes",
          flush=True)
    return {"edge_decompress_size": size, "edge_blob_bytes": len(blob),
            "edge_c1_s": c1_s, "edge_c1_kernel_s": kernel_s,
            "edge_c1_peak_bytes": c1_peak,
            "edge_c1_peak_bytes_per_byte": c1_peak / out,
            "edge_equal": ok}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=("round_trip", "c1_edge"))
    ap.add_argument("--mib", type=int, default=2049)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("check_crilayla_limits: no CUDA GPU")
    sys.path.insert(0, REPO)
    from pycricodecs_tpu_torch.models import crilayla
    from pycricodecs_tpu_torch.ops import cuda_kernels as CK
    from pycricodecs_tpu_torch.utils import signals
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    res = {"card": card}
    if args.only in (None, "round_trip"):
        res.update(round_trip(crilayla, dev, args.mib))
    if args.only in (None, "c1_edge"):
        res.update(c1_edge(crilayla, CK, signals, dev))
    print(json.dumps(res), flush=True)
    if not all(res.get(k, True) for k in ("round_trip_equal", "edge_equal")):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
