#!/usr/bin/env python3
"""Time kernels B6 (`hca_mdct`) and B10 (`mp2_unpack`) alone, on one CUDA
GPU, for the copy of the port under --root (default: this checkout), so
that two versions can be compared in one call on one card.

Shapes, each timed through its wrapper by CUDA events (median of --reps
after a warm-up launch), as `chip_smoke.py` times them, and per launch of
10 enqueued back to back (the host's enqueue time hidden):
- B6 at the HCA encode bank: 256 copies of the bank's 10 s stereo input
  WAV as `hca_encode_batch` stacks it (1,920,000 rows of 128 int16);
- B10 at the AHX bank: 256 copies of the 10 s bank stream's 192 frames
  (49,152 frames, mono LSF, sblimit 30).

With --check it times nothing: it holds both kernels to their twins at
those shapes and runs `chip_smoke.py`'s B6 and B10 checks (its phase 9
random cases, its phase 13 random, ragged, odd-size and cut frames), for
a new kernel's first call on the card. With --sass it prints, per kernel,
the static SASS instruction counts of the build (`cuobjdump -sass`, by
opcode class) and ptxas's register and spill lines. Prints one line per
measurement with the card's name and power limit, and last one JSON line
of the numbers. There is no CPU path.

Run from the repository root:
    python3 tools/time_mdct_mp2unpack.py [--root DIR] [--reps N] [--check]
        [--sass]
Compare two versions in one call: unpack the other version (git archive)
into a directory that .gitignore lists and run both, in turns.
"""
import argparse
import importlib.util
import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL_NAMES = ("hca_mdct_kernel", "mp2_unpack_kernel")


def load_tool(name: str):
    """A module of this checkout by path (chip_smoke.py, a tool)."""
    path = os.path.join(REPO, *name.split("/")) + ".py"
    spec = importlib.util.spec_from_file_location(
        os.path.basename(name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def back_to_back_ms(S, fn, reps: int, n: int = 10) -> float:
    """Milliseconds a call of n calls enqueued back to back (the host's
    time to enqueue one hides behind the card's run of the one before)."""
    def calls():
        for _ in range(n):
            fn()
    return S.cuda_ms(calls, reps) / n


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=REPO,
                    help="directory holding the pycricodecs_tpu_torch to time")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--check", action="store_true",
                    help="check against the twins instead of timing")
    ap.add_argument("--sass", action="store_true",
                    help="SASS instruction counts and ptxas lines")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_mdct_mp2unpack: no CUDA GPU")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import pycricodecs_tpu_torch as port
    if not os.path.abspath(port.__file__).startswith(root + os.sep):
        raise SystemExit(f"imported {port.__file__}, not the copy in {root}")
    from pycricodecs_tpu_torch import _build
    from pycricodecs_tpu_torch.ops import cuda_kernels
    from pycricodecs_tpu_torch.ops import hca_encode_device as D
    from pycricodecs_tpu_torch.ops import hca_encode_host as EH
    from pycricodecs_tpu_torch.parallel import pipeline as P
    from pycricodecs_tpu_torch.utils import signals
    from pycricodecs_tpu_torch.utils.wav import parse_wav, write_wav
    S = load_tool("chip_smoke")
    dev = torch.device("cuda", 0)
    card = S.card_line()
    out = {"root": os.path.relpath(root, REPO), "card": card}
    lib = str(_build.build())
    _build.load()
    if args.sass:
        lines = _build.BUILD_LOG.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and any(
                    k in line for k in KERNEL_NAMES):
                for ln in lines[i:i + 4]:
                    if "Compiling" in ln or "registers" in ln \
                            or "spill" in ln:
                        print("  ptxas:", ln.strip(), flush=True)
        tts = load_tool("tools/time_transform_synth")
        out["sass"] = tts.sass_counts(lib, KERNEL_NAMES)
        for k, v in out["sass"].items():
            print(f"SASS {k}: {json.dumps(v)}", flush=True)

    # B6 at the HCA encode bank
    w = parse_wav(signals.hca_wav(S.BANK, write_wav))
    cfg = EH.init_encode(w, 2, w.looping)
    pcm = torch.from_numpy(D.stack_timelines(
        [cfg] * S.BANK_STREAMS, [w] * S.BANK_STREAMS)).to(dev)
    if args.check:
        S.mdct_checks(dev, np.random.default_rng(9))
        S.f32_equal("B6 bank", cuda_kernels.hca_mdct(pcm), D.mdct_plain(pcm))
        print(f"B6 bank {tuple(pcm.shape)}: bit-equal to the twin",
              flush=True)
    else:
        fn = lambda: cuda_kernels.hca_mdct(pcm)  # noqa: E731
        out["mdct_ms"] = S.cuda_ms(fn, args.reps)
        out["mdct_b2b_ms"] = back_to_back_ms(S, fn, args.reps)
        print(f"B6 [{card}] at the HCA encode bank {tuple(pcm.shape)}: "
              f"{out['mdct_ms']:.4f} ms ({out['mdct_b2b_ms']:.4f} ms a "
              f"launch back to back)", flush=True)
    del pcm

    # B10 at the AHX bank
    _, blobs = S.load_ahx_fixtures()
    walks = [P._parse_mp2(blobs[signals.AHX_BANK])[1]] * S.BANK_STREAMS
    stack = P._stack_mp2_frames(walks)
    B, F, fs_max = stack.shape
    frames = torch.from_numpy(stack.reshape(B * F, fs_max)).to(dev)
    if args.check:
        worst = dict.fromkeys(S.KERNELS, 0)
        S.mp2_unpack_pair(worst, "bank", frames, 1)
        print(f"B10 bank {B} x {F} frames of <= {fs_max} bytes: byte-equal "
              f"to the twin", flush=True)
        S.mp2_unpack_checks(dev, worst, blobs, np.random.default_rng(13))
    else:
        fn = lambda: cuda_kernels.mp2_unpack(frames, 1)  # noqa: E731
        out["unpack_ms"] = S.cuda_ms(fn, args.reps)
        out["unpack_b2b_ms"] = back_to_back_ms(S, fn, args.reps)
        print(f"B10 [{card}] at the AHX bank {B} x {F} frames of <= "
              f"{fs_max} bytes: {out['unpack_ms']:.4f} ms "
              f"({out['unpack_b2b_ms']:.4f} ms a launch back to back)",
              flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
