#!/usr/bin/env python3
"""Time the AHX encode's kernels K1 (`mp2_analysis`) and K2 (`mp2_allocate`)
alone at the AHX encode bank shape, on one CUDA GPU.

The shape is `chip_smoke.py`'s phase 16 bank: 256 copies of the 10 s bank
PCM (utils/signals.ahx_bank_pcm), mono, 22,050 Hz, 96 kbps, 192 frames a
stream. Each kernel is timed through its wrapper by CUDA events (median
of --reps after a warm-up), with `chip_smoke.py`'s helpers. K2's ablation
is `chip_smoke.k2_ablation`, by its inputs alone: the class levels zeroed
(the greedy loop runs step for step, as it reads no levels, and nothing
is quantised), then the budgets zeroed too (the first step allocates
nothing); the differences are the quantisation and the loop. Also
printed: ptxas's register, shared-memory and spill lines of the two
kernels, and the SM clock and power draw nvidia-smi reads every 100 ms
while each kernel runs back to back for about two seconds (median of the
samples). With --sass, also the two kernels' static SASS instruction
counts by opcode class (`cuobjdump -sass`, as tools/time_transform_synth.py
counts them). Prints one line per measurement with the card's name and
power limit, and last one JSON line of the numbers. There is no CPU path.

Run from the repository root:
    python3 tools/time_mp2_encode.py [--reps N] [--sass]
"""
import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def clocks_while(fn, seconds: float = 2.0) -> dict:
    """Median SM clock (MHz) and power draw (W) that nvidia-smi samples
    every 100 ms while fn() runs back to back for `seconds`."""
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, text=True)
    try:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        n = 0
        while True:
            for _ in range(20):
                fn()
            n += 20
            end.record()
            torch.cuda.synchronize()
            if start.elapsed_time(end) > seconds * 1e3:
                break
    finally:
        smi.terminate()
        out, _ = smi.communicate(timeout=60)
    rows = []
    for line in out.strip().splitlines()[2:]:     # the load is on by then
        try:
            rows.append([float(v) for v in line.split(",")])
        except ValueError:                        # "[N/A]" and the like
            continue
    if not rows:
        return {"sm_mhz": None, "power_w": None, "samples": 0, "calls": n}
    return {"sm_mhz": float(np.median([r[0] for r in rows])),
            "power_w": float(np.median([r[1] for r in rows])),
            "samples": len(rows), "calls": n}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--sass", action="store_true",
                    help="SASS instruction counts of K1 and K2")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_mp2_encode: no CUDA GPU")
    sys.path.insert(0, REPO)
    import chip_smoke as S
    from pycricodecs_tpu_torch import _build
    from pycricodecs_tpu_torch.ops import cuda_kernels as K
    from pycricodecs_tpu_torch.ops import mp2_encode_device as E
    from pycricodecs_tpu_torch.ops import mp2_encode_host
    from pycricodecs_tpu_torch.utils import signals

    dev = torch.device("cuda", 0)
    card = S.card_line()
    _build.load()
    track = False          # inside ptxas's lines of K1 or K2
    for line in _build.BUILD_LOG.splitlines():
        if "Compiling entry function" in line:
            track = "mp2_analysis" in line or "mp2_allocate" in line
        if track:
            print("ptxas:", line.strip())
    if args.sass:
        spec = importlib.util.spec_from_file_location(
            "time_transform_synth",
            os.path.join(REPO, "tools", "time_transform_synth.py"))
        tts = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(tts)
        for k, v in tts.sass_counts(str(_build.build()), names=(
                "mp2_analysis_kernel", "mp2_allocate_kernelILi1")).items():
            print(f"sass {k}: {v}")
    bank = signals.ahx_bank_pcm()
    F = -(-bank.size // 1152)
    x = np.zeros((S.BANK_STREAMS, 1, F * 1152), np.int16)
    x[:, 0, :bank.size] = bank
    pcm = torch.from_numpy(x).to(dev)
    cfg = mp2_encode_host.configure(1, 22050, 96)
    _, _, budgets = cfg.frame_plan(F)
    bud = torch.from_numpy(budgets).to(dev)
    itab, snr = E.device_tables(cfg, dev)
    S_k, part, peaks = K.mp2_analysis(pcm)
    need = E.need_db_host(peaks)

    def k2(budgets=bud, classes=itab):
        return K.mp2_allocate(S_k, part, need, budgets, classes, snr,
                              sblimit=cfg.sblimit, bound=cfg.bound,
                              joint=cfg.joint)

    res = {"card": card,
           "k1_ms": S.cuda_ms(lambda: K.mp2_analysis(pcm), args.reps)}
    abl = S.k2_ablation(k2, itab, bud, args.reps)
    res["k2_ms"] = abl.pop("whole")
    res.update({f"k2_{k.split(',')[0].replace(' ', '_')}_ms": v
                for k, v in abl.items()})
    res["k1_clocks"] = clocks_while(lambda: K.mp2_analysis(pcm))
    res["k2_clocks"] = clocks_while(k2)
    for k, v in res.items():
        if k.endswith("_ms") or k.endswith("_clocks"):
            print(f"{k} [{card}]: {v}")
    print(json.dumps(res))


if __name__ == "__main__":
    main()
