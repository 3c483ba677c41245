#!/usr/bin/env python3
"""Time kernels B2 (`hca_coefficients`) and the packer `hca_pack` alone, on
one CUDA GPU, for the copy of the port under --root (default: this
checkout), so that two versions can be compared in one call on one card.

Three shapes, each timed by CUDA events (median of --reps after a
warm-up launch):
- B2 at the HCA bank chunk: 64 copies of the bank stream's 469 frames,
  with the spectra (`DeviceUnpacker.spectra`);
- B2's cursor-only launch at the key search's shape: 400,000 (key, frame)
  rows, the first 200,000 seeded candidates of the key-search fixture on
  the enciphered bank stream's first two frames (phase 1 of `find_key`);
- `hca_pack` at the HCA encode bank: 256 copies of the bank's 10 s input
  WAV, quality 2 (120,064 frames).

Prints one line per shape with the card's name and power limit, and last
one JSON line of the numbers. There is no CPU path.

Run from the repository root:
    python3 tools/time_unpack_pack.py [--root DIR] [--reps N]
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


def load_smoke():
    """chip_smoke.py of this checkout (helpers and fixture paths)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=REPO,
                    help="directory holding the pycricodecs_tpu_torch to time")
    ap.add_argument("--reps", type=int, default=20)
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
    S = load_smoke()
    dev = torch.device("cuda", 0)
    card = S.card_line()
    out = {"root": os.path.relpath(root, REPO), "card": card}

    # B2 at the bank chunk
    with open(os.path.join(S.FIXTURES, S.BANK + ".hca"), "rb") as f:
        plain = f.read()
    hs = int.from_bytes(plain[6:8], "big")
    info = hca_frame.parse_header(plain[:hs])
    fs = info.frame_size
    frames = np.frombuffer(plain, np.uint8, count=info.frame_count * fs,
                           offset=hs).reshape(-1, fs)
    up = U.DeviceUnpacker(info, dev)
    dec = up.decipher(torch.from_numpy(
        np.tile(frames, (P.CHUNK_STREAMS, 1))).to(dev))
    _, res, _, cur, _ = up.side_info(dec)
    out["b2_chunk_ms"] = S.cuda_ms(lambda: up.spectra(dec, res, cur), args.reps)
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
