#!/usr/bin/env python3
"""CRILAYLA's C2 and C1 on one member past 2^31 bytes, on one CUDA GPU.

One member of --mib MiB (default 2,049: above 2^31 bytes) goes through
`crilayla.compress_members` (kernel C2, a wrapper call alone: it is larger
than `crilayla.C2_BUDGET`) and back through `crilayla.decompress_members`
(kernel C1), and must come back byte for byte. The member: 1 MiB of random
bytes (seed 20), then a run of one byte to the middle, then a period-3
pattern to the end, so that the search runs both its 32-bit and its
64-bit keys and the matches pass 2^19 bytes and 255-byte escapes by the
million. Prints each call's time (host clock, with its copies), its peak
card memory above what was allocated before it
(torch.cuda.max_memory_allocated) per member byte, the blob's size, the
card's name and power limit, and last one JSON line. No CPU path.

Run from the repository root:
    python3 tools/check_crilayla_limits.py [--mib N]
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mib", type=int, default=2049)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("check_crilayla_limits: no CUDA GPU")
    sys.path.insert(0, REPO)
    from pycricodecs_tpu_torch.models import crilayla
    dev = torch.device("cuda", 0)
    card = card_line()
    data = member(args.mib << 20)
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
    ok = back == data
    res = {"card": card, "member_bytes": len(data), "blob_bytes": len(blob),
           "c2_s": c2_s, "c2_peak_bytes_per_byte": c2_peak / len(data),
           "c1_s": c1_s, "c1_peak_bytes_per_byte": c1_peak / len(data),
           "round_trip_equal": ok}
    print(f"[{card}] member {len(data)} bytes -> blob {len(blob)} bytes: C2 "
          f"{c2_s:.3f} s, peak {c2_peak / len(data):.3f} bytes a member "
          f"byte; C1 {c1_s:.3f} s, peak {c1_peak / len(data):.3f} bytes an "
          f"output byte; round trip "
          f"{'equal' if ok else 'DIFFERS'}", flush=True)
    print(json.dumps(res), flush=True)
    if not ok:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
