#!/usr/bin/env python3
"""Time kernels B1 (`hca_side_info`), B2 (`hca_coefficients`) and the
packer `hca_pack` alone, on one CUDA GPU, for the copy of the port under
--root (default: this checkout), so that two versions can be compared in
one call on one card.

Shapes, each timed by CUDA events (median of --reps after a warm-up
launch), B1 as a single call through its wrapper (as `chip_smoke.py`
times it, the host's enqueue included), per launch of 10 enqueued back to
back, as the kernel's device time in a torch.profiler trace of 10 calls
and as the host's time to enqueue one call:
- B1 and B2 at the HCA bank chunk: 64 copies of the bank stream's 469
  frames (`DeviceUnpacker.side_info`; B2 with the spectra,
  `DeviceUnpacker.spectra`);
- B1 and B2's cursor-only launch at the key search's shape: 400,000
  (key, frame) rows, the first 200,000 seeded candidates of the
  key-search fixture on the enciphered bank stream's first two frames
  (phase 1 of `find_key`);
- `hca_pack` at the HCA encode bank: 256 copies of the bank's 10 s input
  WAV, quality 2 (120,064 frames).

With --sass it also prints B1's and B2's static SASS instruction counts
(`cuobjdump -sass`, by opcode class, one instantiation of each template)
and ptxas's register and spill lines. Prints one line per measurement
with the card's name and power limit, and last one JSON line of the
numbers. There is no CPU path; `chip_smoke.py` checks the kernels against
their twins.

Run from the repository root:
    python3 tools/time_unpack_pack.py [--root DIR] [--reps N] [--sass]
Compare two versions in one call: unpack the other version (git archive)
into a directory that .gitignore lists and run both, in turns.
"""
import argparse
import importlib.util
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL_NAMES = ("hca_side_info_kernel", "hca_coefficients_kernel")


def load_tool(name: str):
    """A module of this checkout by path (chip_smoke.py, a tool)."""
    path = os.path.join(REPO, *name.split("/")) + ".py"
    spec = importlib.util.spec_from_file_location(
        os.path.basename(name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def back_to_back_ms(S, fn, reps: int, n: int = 10) -> float:
    """Milliseconds a call of n calls enqueued back to back."""
    def calls():
        for _ in range(n):
            fn()
    return S.cuda_ms(calls, reps) / n


def kernel_ms(fn, name: str, n: int = 10) -> float:
    """Device milliseconds a launch of the kernel whose name holds `name`,
    from a torch.profiler trace of n calls (no host time in it)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "device_time_total", None)
                or getattr(e, "cuda_time_total", 0)
                for e in prof.key_averages() if name in e.key)
    return total / n / 1e3


def host_ms(fn, n: int = 100) -> float:
    """Host milliseconds a call takes to enqueue (the card keeps up or
    queues; the wait for it is outside the clock)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e3


def b1_times(S, out: dict, key: str, fn, reps: int) -> str:
    """B1's single call, back-to-back launch, device and enqueue times into
    out[key + ...]; returns them as text."""
    out[key + "_ms"] = S.cuda_ms(fn, reps)
    out[key + "_b2b_ms"] = back_to_back_ms(S, fn, reps)
    out[key + "_kernel_ms"] = kernel_ms(fn, "hca_side_info")
    out[key + "_host_ms"] = host_ms(fn)
    return (f"{out[key + '_ms']:.4f} ms a call ({out[key + '_b2b_ms']:.4f} "
            f"ms a launch back to back; the kernel "
            f"{out[key + '_kernel_ms']:.4f} ms in a profiler trace, the "
            f"host's enqueue {out[key + '_host_ms']:.4f} ms)")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=REPO,
                    help="directory holding the pycricodecs_tpu_torch to time")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--sass", action="store_true",
                    help="SASS instruction counts and ptxas lines")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_unpack_pack: no CUDA GPU")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import pycricodecs_tpu_torch as port
    if not os.path.abspath(port.__file__).startswith(root + os.sep):
        raise SystemExit(f"imported {port.__file__}, not the copy in {root}")
    from pycricodecs_tpu_torch.ops import hca_encode_device as D
    from pycricodecs_tpu_torch.ops import hca_encode_host as EH
    from pycricodecs_tpu_torch.ops import hca_frame
    from pycricodecs_tpu_torch.ops import cuda_kernels
    from pycricodecs_tpu_torch.ops import hca_unpack_device as U
    from pycricodecs_tpu_torch.parallel import pipeline as P
    from pycricodecs_tpu_torch.utils import signals
    from pycricodecs_tpu_torch.utils.wav import parse_wav, write_wav
    from pycricodecs_tpu_torch import _build
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
                            or "spill" in ln or "stack" in ln:
                        print("  ptxas:", ln.strip(), flush=True)
        tts = load_tool("tools/time_transform_synth")
        out["sass"] = tts.sass_counts(lib, KERNEL_NAMES)
        for k, v in out["sass"].items():
            print(f"SASS {k}: {json.dumps(v)}", flush=True)

    # B1 and B2 at the bank chunk
    with open(os.path.join(S.FIXTURES, S.BANK + ".hca"), "rb") as f:
        plain = f.read()
    hs = int.from_bytes(plain[6:8], "big")
    info = hca_frame.parse_header(plain[:hs])
    fs = info.frame_size
    frames = np.frombuffer(plain, np.uint8, count=info.frame_count * fs,
                           offset=hs).reshape(-1, fs)
    up = U.DeviceUnpacker(info, device=dev)
    dec = up.decipher(torch.from_numpy(
        np.tile(frames, (P.CHUNK_STREAMS, 1))).to(dev))
    _, res, _, cur, _ = up.side_info(dec)
    text = b1_times(S, out, "b1_chunk", lambda: up.side_info(dec), args.reps)
    print(f"B1 [{card}] at the bank chunk {tuple(dec.shape)}: {text}",
          flush=True)
    out["b2_chunk_ms"] = S.cuda_ms(lambda: up.spectra(dec, res, cur),
                                   args.reps)
    print(f"B2 [{card}] at the bank chunk {tuple(dec.shape)}: "
          f"{out['b2_chunk_ms']:.4f} ms", flush=True)
    del dec, res, cur

    # B2 cursor-only at the key search's rows
    with open(os.path.join(S.KEYSEARCH_FIXTURES, "expected.json")) as f:
        spec = json.load(f)["find_key"]
    enc = port.crypt(plain, True, hs, spec["cipher"], spec["key"])
    keys = np.random.default_rng(spec["seed"]).integers(
        1, 1 << 63, spec["candidates"]).astype(np.uint64)
    keys[spec["true_index"]] = spec["key"]
    dec, res, cur = S.key_search_rows(up, enc, keys[:S.KEY_ROWS // 2], dev)
    text = b1_times(S, out, "b1_key_rows", lambda: up.side_info(dec),
                    args.reps)
    print(f"B1 [{card}] at {dec.shape[0]} key-search rows: {text}",
          flush=True)
    out["b2_key_rows_cursor_ms"] = S.cuda_ms(
        lambda: up.spectra(dec, res, cur, False), args.reps)
    print(f"B2 cursor-only [{card}] at {dec.shape[0]} key-search rows: "
          f"{out['b2_key_rows_cursor_ms']:.4f} ms", flush=True)
    del dec, res, cur

    # hca_pack at the encode bank
    wav = signals.hca_wav(S.BANK, write_wav)
    w = parse_wav(wav)
    cfg = EH.init_encode(w, 2, w.looping)
    pcm = torch.from_numpy(D.stack_timelines(
        [cfg] * S.BANK_STREAMS, [w] * S.BANK_STREAMS)).to(dev)
    t, kw = S.encode_tensors(pcm, cfg.info, cfg)
    del pcm
    out["pack_ms"] = S.cuda_ms(lambda: cuda_kernels.hca_pack(*t, **kw),
                               args.reps)
    print(f"hca_pack [{card}] at the encode bank "
          f"{tuple(t[0].shape)} frames: {out['pack_ms']:.4f} ms", flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
