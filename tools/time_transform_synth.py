#!/usr/bin/env python3
"""Time kernels B3 (`hca_transform`) and the Layer II synthesis `mp2_synth`
alone, on one CUDA GPU, for the copy of the port under --root (default:
this checkout), so that two versions can be compared in one call on one
card.

Shapes, each timed by CUDA events (median of --reps after a warm-up
launch):
- B3 at the HCA bank chunk: 64 copies of the bank stream's 469 frames
  (stereo, one intensity pair), its real spectra from B1/B2, without noise
  maps and with random legal PNS maps;
- `mp2_synth` at the AHX bank: 256 copies of the 10 s bank stream's 192
  frames (6,912 rows a stream), its codes from B10;
- with --sweep, `mp2_synth` on random codes of 3 frames (108 rows, one
  block a stream in either version) for 132 x k streams, k = 1, 2, 4, 8,
  16: one block-wave of k blocks an SM, as far as the kernel's occupancy
  allows.

With --sass it also prints, per kernel, the static SASS instruction counts
of the build (`cuobjdump -sass`, by opcode class) and ptxas's register and
spill lines. Prints one line per measurement with the card's name and power
limit, and last one JSON line of the numbers. There is no CPU path.

Run from the repository root:
    python3 tools/time_transform_synth.py [--root DIR] [--reps N] [--sweep]
        [--sass]
Compare two versions in one call: unpack the other version (git archive)
into a directory that .gitignore lists and run both, in turns.
"""
import argparse
import collections
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL_NAMES = ("hca_transform_kernel", "mp2_synth_kernel")
# opcode classes counted (the first token of a SASS instruction, before
# its first '.')
CLASSES = ("FMUL", "FADD", "DMUL", "DADD", "DFMA", "LDS", "STS", "LDG",
           "STG", "LDL", "STL", "LDC", "LDGSTS", "BAR", "WARPSYNC", "SHFL",
           "BRA", "MUFU", "F2I", "I2F", "PRMT")


def load_smoke():
    """chip_smoke.py of this checkout (helpers and fixture paths)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sass_counts(lib: str, names=KERNEL_NAMES) -> dict:
    """kernel -> {"total": n, opcode class: n} from cuobjdump -sass, for
    the kernels whose (mangled) name holds one of `names`."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, cur = {}, None
    ins = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_]*)")
    for line in text.splitlines():
        if "Function :" in line:
            cur = next((k for k in names if k in line), None)
            if cur:
                counts[cur] = collections.Counter()
            continue
        m = ins.search(line) if cur else None
        if m:
            counts[cur]["total"] += 1
            counts[cur][m.group(1)] += 1
    return {k: {c: v[c] for c in ("total",) + CLASSES if v[c]}
            for k, v in counts.items()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=REPO,
                    help="directory holding the pycricodecs_tpu_torch to time")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--sweep", action="store_true",
                    help="mp2_synth at 1-16 block-waves an SM")
    ap.add_argument("--sass", action="store_true",
                    help="SASS instruction counts and ptxas lines")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_transform_synth: no CUDA GPU")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import pycricodecs_tpu_torch as port
    if not os.path.abspath(port.__file__).startswith(root + os.sep):
        raise SystemExit(f"imported {port.__file__}, not the copy in {root}")
    from pycricodecs_tpu_torch import _build
    from pycricodecs_tpu_torch.ops import cuda_kernels
    from pycricodecs_tpu_torch.ops import hca_frame
    from pycricodecs_tpu_torch.ops import hca_kernels as K
    from pycricodecs_tpu_torch.ops import hca_unpack_device as U
    from pycricodecs_tpu_torch.parallel import pipeline as P
    from pycricodecs_tpu_torch.utils import signals
    S = load_smoke()
    dev = torch.device("cuda", 0)
    card = S.card_line()
    out = {"root": os.path.relpath(root, REPO), "card": card}
    lib = str(_build.build())
    _build.load()
    if args.sass:
        for line in _build.BUILD_LOG.splitlines():
            if any(k in line for k in ("registers", "spill", "Compiling")):
                print("  ptxas:", line.strip(), flush=True)
        out["sass"] = sass_counts(lib)
        for k, v in out["sass"].items():
            print(f"SASS {k}: {json.dumps(v)}", flush=True)

    # B3 at the bank chunk, the real spectra
    with open(os.path.join(S.FIXTURES, S.BANK + ".hca"), "rb") as f:
        blob = f.read()
    hs = int.from_bytes(blob[6:8], "big")
    info = hca_frame.parse_header(blob[:hs])
    F, C, B = info.frame_count, info.channels, P.CHUNK_STREAMS
    frames = np.frombuffer(blob, np.uint8, count=F * info.frame_size,
                           offset=hs).reshape(F, -1)
    up = U.DeviceUnpacker(info, device=dev)
    qc, sf, res, inten, _ = up(torch.from_numpy(np.tile(frames, (B, 1)))
                               .to(dev))
    spec = (qc.view(B, F, C, 8, 128), sf.view(B, F, C, 128),
            res.view(B, F, C, 128), inten.view(B, F, C, 8))
    hfr, cfg = K.transform_config(info)
    out["b3_ms"] = S.cuda_ms(lambda: K.hca_decode_transform_batched(
        *spec, hfr, **cfg), args.reps)
    print(f"B3 [{card}] at the bank chunk {B}x{F} frames, {C} ch: "
          f"{out['b3_ms']:.4f} ms", flush=True)
    g = torch.Generator().manual_seed(12)
    rnd, noise = S.random_transform_inputs(g, B, F, C, dev)
    out["b3_pns_ms"] = S.cuda_ms(lambda: K.hca_decode_transform_batched(
        *rnd, hfr, noise=noise, **cfg), args.reps)
    print(f"B3 with random PNS maps [{card}] at {B}x{F} frames: "
          f"{out['b3_pns_ms']:.4f} ms", flush=True)
    del qc, sf, res, inten, spec, rnd, noise

    # mp2_synth at the AHX bank, the real codes
    _, blobs = S.load_ahx_fixtures()
    walks = [P._parse_mp2(blobs[signals.AHX_BANK])[1]] * S.BANK_STREAMS
    stack = P._stack_mp2_frames(walks)
    Bs, Fs, fs_max = stack.shape
    codes, levels, sfidx, err = cuda_kernels.mp2_unpack(
        torch.from_numpy(stack.reshape(Bs * Fs, fs_max)).to(dev), 1)
    if bool(err.any()):
        raise SystemExit("B10 flagged an error in the AHX bank")
    bank = (codes.view(Bs, Fs, 1, 36, 32), levels.view(Bs, Fs, 1, 32),
            sfidx.view(Bs, Fs, 1, 3, 32))
    out["synth_ms"] = S.cuda_ms(lambda: cuda_kernels.mp2_synth(*bank),
                                args.reps)
    print(f"mp2_synth [{card}] at the AHX bank {Bs}x{Fs} frames: "
          f"{out['synth_ms']:.4f} ms", flush=True)

    if args.sweep:
        rng = np.random.default_rng(7)
        out["synth_sweep_ms"] = {}
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        for k in (1, 2, 4, 8, 16):
            n = sms * k
            lv = rng.choice([0, 3, 5, 7, 9, 15, 31, 63, 127],
                            (n, 3, 1, 32)).astype(np.int32)
            cd = (rng.random((n, 3, 1, 36, 32))
                  * np.maximum(lv, 1)[..., None, :]).astype(np.uint16)
            si = rng.integers(0, 63, (n, 3, 1, 3, 32), dtype=np.uint8)
            t = [torch.from_numpy(a).to(dev) for a in (cd, lv, si)]
            ms = S.cuda_ms(lambda: cuda_kernels.mp2_synth(*t), args.reps)
            out["synth_sweep_ms"][k] = ms
            print(f"mp2_synth sweep [{card}]: {n} streams x 3 frames "
                  f"({k} a SM): {ms:.4f} ms", flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
