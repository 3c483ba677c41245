#!/usr/bin/env python3
"""Time the AHX encode's kernels K1 (`mp2_analysis`), K2 (`mp2_allocate`)
and K3 (`mp2_pack`) alone at the AHX encode bank shape, on one CUDA GPU,
for the copy of the port under --root (default: this checkout), so that
two versions can be compared in one call on one card.

The shape is `chip_smoke.py`'s phase 16 bank: 256 copies of the 10 s bank
PCM (utils/signals.ahx_bank_pcm), mono, 22,050 Hz, 96 kbps, 192 frames a
stream (K3 packs 49,152 frames of 626-627 bytes). Each kernel is timed
through its wrapper by CUDA events (median of --reps after a warm-up),
with `chip_smoke.py`'s helpers, as `chip_smoke.py` times it; K3 also per
launch of 10 enqueued back to back, by its device time alone (the median
of torch.profiler's kernel records over --reps launches), and by the
host's time to enqueue one call (where that exceeds the kernel's, the
back-to-back time is the host's). K2's
ablation is `chip_smoke.k2_ablation`, by its inputs alone: the class
levels zeroed (the greedy loop runs step for step, as it reads no levels,
and nothing is quantised), then the budgets zeroed too (the first step
allocates nothing); the differences are the quantisation and the loop.
Also printed: ptxas's register, shared-memory and spill lines of the
three kernels, each prefixed with its instance (`mp2_pack_kernel<1>`), and the SM clock and power draw nvidia-smi reads every
100 ms while each kernel runs back to back for about two seconds (median
of the samples). With --sass, also the three kernels' static SASS
instruction counts by opcode class (`cuobjdump -sass`, as
tools/time_transform_synth.py counts them). Prints one line per
measurement with the card's name and power limit, and last one JSON line
of the numbers. There is no CPU path.

Run from the repository root:
    python3 tools/time_mp2_encode.py [--root DIR] [--reps N] [--sass]
Compare two versions in one call: unpack the other version (git archive)
into a directory that .gitignore lists and run both, in turns.
"""
import argparse
import importlib.util
import json
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL_NAMES = ("mp2_analysis_kernel", "mp2_allocate_kernelILi1",
                "mp2_pack_kernel")


def load_tool(name: str):
    """A module of this checkout by path (chip_smoke.py, a tool)."""
    path = os.path.join(REPO, *name.split("/")) + ".py"
    spec = importlib.util.spec_from_file_location(
        os.path.basename(name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def import_port(root: str):
    """Put the port under `root` first on the path and check that it is
    the one imported."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import pycricodecs_tpu_torch as port
    if not os.path.abspath(port.__file__).startswith(root + os.sep):
        raise SystemExit(f"imported {port.__file__}, not the copy in {root}")
    return port


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


def back_to_back_ms(S, fn, reps: int, n: int = 10) -> float:
    """Milliseconds a call of n calls enqueued back to back (the host's
    time to enqueue one hides behind the card's run of the one before)."""
    def calls():
        for _ in range(n):
            fn()
    return S.cuda_ms(calls, reps) / n


def device_ms(fn, kernel: str, n: int = 20) -> float:
    """Median device time (ms) of the kernel whose name holds `kernel` over
    n calls of fn under torch.profiler: CUPTI's record of each launch, the
    kernel's own run without the host's enqueue or the gaps between
    launches. Raises unless the trace holds n such kernels."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        durs = [d for name, _, _, d in load_tool(
            "tools/profile_torch_slice").device_intervals(path)
            if kernel in name]
    if len(durs) != n:
        raise SystemExit(f"device_ms: {len(durs)} {kernel} kernels in the "
                         f"trace, not {n}")
    return float(np.median(durs)) / 1e3


def enqueue_us(fn, n: int = 50) -> float:
    """Host microseconds a call of fn takes to enqueue its work (n calls
    back to back, the clock stopped before the synchronise)."""
    import time
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def ptxas_log(build, sources=("mp2_analysis.cu", "mp2_encode.cu")) -> str:
    """The build's compiler output; where this process loaded a library
    built earlier (no output kept), that of the sources compiled again
    alone with the build's flags."""
    if build.BUILD_LOG:
        return build.BUILD_LOG
    gen = os.path.dirname(str(build.build()))
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, f"-I{gen}", "-c", "-o",
             os.path.join(tmp, src + ".o"),
             os.path.join(str(build.CSRC_DIR), src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src in sources]
        return "".join(proc.communicate(timeout=600)[0] for proc in procs)


def entry_label(line: str):
    """`name<args>` of the K1, K2 or K3 instance that ptxas's "Compiling
    entry function" line names (its template arguments from the mangled
    name), or None for another function."""
    m = re.search(r"(mp2_(?:analysis|allocate|pack)_kernel)(\w*)", line)
    if m is None:
        return None
    rest = m.group(2)
    if not rest.startswith("I"):
        return m.group(1)
    args = re.findall(r"L[ib](\d+)E", rest[:rest.find("EEv") + 1])
    return f"{m.group(1)}<{','.join(args)}>"


def bank_inputs(dev) -> dict:
    """The bank's kernel inputs, on `dev`, for the imported port: the PCM
    i16 [256, 1, 192 * 1152], K1's outputs, need_db, the frame plan, K2's
    tables and outputs, and K3's other inputs; `k3` is a call of K3."""
    from pycricodecs_tpu_torch.ops import cuda_kernels as K
    from pycricodecs_tpu_torch.ops import mp2_encode_device as E
    from pycricodecs_tpu_torch.ops import mp2_encode_host
    from pycricodecs_tpu_torch.utils import signals
    S = load_tool("chip_smoke")
    bank = signals.ahx_bank_pcm()
    F = -(-bank.size // 1152)
    x = np.zeros((S.BANK_STREAMS, 1, F * 1152), np.int16)
    x[:, 0, :bank.size] = bank
    pcm = torch.from_numpy(x).to(dev)
    cfg = mp2_encode_host.configure(1, 22050, 96)
    pads, sizes, budgets = cfg.frame_plan(F)
    bud = torch.from_numpy(budgets).to(dev)
    itab, snr = E.device_tables(cfg, dev)
    S_k, part, peaks = K.mp2_analysis(pcm)
    need = E.need_db_host(peaks)
    out = K.mp2_allocate(S_k, part, need, bud, itab, snr,
                         sblimit=cfg.sblimit, bound=cfg.bound,
                         joint=cfg.joint)
    offs = E.frame_offsets(sizes)
    pads_d = torch.from_numpy(pads).to(dev)
    offs_d = torch.from_numpy(offs).to(dev)
    ctab = E.pack_tables(cfg, dev)

    def k3():
        return K.mp2_pack(*out, pads_d, offs_d, ctab, sblimit=cfg.sblimit,
                          bound=cfg.bound, header_base=cfg.header_base,
                          total=int(offs[-1]), max_frame=int(sizes.max()))

    return dict(pcm=pcm, cfg=cfg, bud=bud, itab=itab, snr=snr, S=S_k,
                part=part, need=need, out=out, k3=k3)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=REPO,
                    help="directory holding the pycricodecs_tpu_torch to time")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--sass", action="store_true",
                    help="SASS instruction counts of K1, K2 and K3")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_mp2_encode: no CUDA GPU")
    root = os.path.abspath(args.root)
    import_port(root)
    from pycricodecs_tpu_torch import _build
    from pycricodecs_tpu_torch.ops import cuda_kernels as K
    S = load_tool("chip_smoke")

    dev = torch.device("cuda", 0)
    card = S.card_line()
    lib = str(_build.build())
    _build.load()
    entry = None           # the K1, K2 or K3 instance ptxas's lines are of
    for line in ptxas_log(_build).splitlines():
        if "Compiling entry function" in line:
            entry = entry_label(line)
        if entry:
            print(f"ptxas {entry}:", line.strip())
    res = {"root": os.path.relpath(root, REPO), "card": card}
    if args.sass:
        res["sass"] = load_tool("tools/time_transform_synth").sass_counts(
            lib, names=KERNEL_NAMES)
        for k, v in res["sass"].items():
            print(f"sass {k}: {json.dumps(v)}")
    x = bank_inputs(dev)
    pcm, cfg, bud, itab = x["pcm"], x["cfg"], x["bud"], x["itab"]

    def k2(budgets=bud, classes=itab):
        return K.mp2_allocate(x["S"], x["part"], x["need"], budgets, classes,
                              x["snr"], sblimit=cfg.sblimit, bound=cfg.bound,
                              joint=cfg.joint)

    res["k1_ms"] = S.cuda_ms(lambda: K.mp2_analysis(pcm), args.reps)
    abl = S.k2_ablation(k2, itab, bud, args.reps)
    res["k2_ms"] = abl.pop("whole")
    res.update({f"k2_{k.split(',')[0].replace(' ', '_')}_ms": v
                for k, v in abl.items()})
    res["k3_ms"] = S.cuda_ms(x["k3"], args.reps)
    res["k3_b2b_ms"] = back_to_back_ms(S, x["k3"], args.reps)
    res["k3_device_ms"] = device_ms(x["k3"], "mp2_pack_kernel", args.reps)
    res["k3_enqueue_us"] = enqueue_us(x["k3"])
    res["k1_clocks"] = clocks_while(lambda: K.mp2_analysis(pcm))
    res["k2_clocks"] = clocks_while(k2)
    res["k3_clocks"] = clocks_while(x["k3"])
    for k, v in res.items():
        if k.endswith(("_ms", "_us", "_clocks")):
            print(f"{k} [{card}] ({res['root']}): {v}")
    print(json.dumps(res))


if __name__ == "__main__":
    main()
