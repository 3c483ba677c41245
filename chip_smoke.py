#!/usr/bin/env python3
"""GPU smoke test of the PyTorch + CUDA port (pycricodecs_tpu_torch).

Drives the port's main path, the batched HCA bank decode, on one CUDA GPU:

1. prints the card (nvidia-smi name and power limit);
2. builds the three hand-written kernels from csrc/ with nvcc;
3. checks each kernel against its plain PyTorch twin on the card, byte for
   byte: B1 side info and B2 spectra on a 64-stream chunk of the bank stream
   plus 4096 random-byte frames per fixture config and per a v3.0 relabel of
   the q4 stereo config (which reaches B1's v3 branches: the scalefactor
   extension copy and the delta-coded intensity with its error rule), B3
   transform on random legal inputs for all five fixture configs at
   64 streams x 469 frames;
4. decodes the 256-stream x 10 s stereo bank (BASELINE config 5) with
   `decode_batch(..., device="cuda")`, holds every WAV to the sha256 the
   JAX package's decode gives (tests/data/torch_port/expected.json), does
   the same for the four 1 s fixtures, and checks that every kernel ran;
5. times the slice (median of 3 runs after a warm-up) and each kernel and
   twin at the chunk shape (CUDA events).

Prints a JSON line of per-kernel results, the card line, and last a JSON
line {"ok": true, "device": {...}}. Any failure raises and exits non-zero;
there is no CPU path.

Run from the repository root: python3 chip_smoke.py
"""
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(ROOT, "tests", "data", "torch_port")
BANK = "bank_q2_stereo_48k_10s"
BANK_STREAMS = 256
RANDOM_FRAMES = 4096

KERNELS = {
    "hca_side_info": dict(
        source="pycricodecs_tpu_torch/csrc/hca_unpack.cu",
        replaces="pycricodecs_tpu/ops/hca_unpack_device.py:656"),
    "hca_coefficients": dict(
        source="pycricodecs_tpu_torch/csrc/hca_unpack.cu",
        replaces="pycricodecs_tpu/ops/hca_unpack_device.py:921"),
    "hca_transform": dict(
        source="pycricodecs_tpu_torch/csrc/hca_transform.cu",
        replaces="pycricodecs_tpu/ops/pallas_kernels.py:448"),
}


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


def max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"shape/dtype differ: {a.shape} {a.dtype} vs "
                             f"{b.shape} {b.dtype}")
    if a.numel() == 0:
        return 0
    return int((a.long() - b.long()).abs().max())


def require_equal(what: str, pairs) -> int:
    """Every (kernel, twin) tensor pair byte-equal; returns max |diff|."""
    worst = 0
    for name, a, b in pairs:
        d = max_abs_diff(a, b)
        worst = max(worst, d)
        if d != 0 or not torch.equal(a, b):
            raise AssertionError(f"{what}: {name} differs from its twin "
                                 f"(max |diff| {d})")
    return worst


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of fn() on the card (CUDA events), after a
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this check runs only on a CUDA GPU")
    sys.path.insert(0, ROOT)
    import pycricodecs_tpu_torch as port
    from pycricodecs_tpu_torch import _build
    from pycricodecs_tpu_torch.ops import cuda_kernels, hca_frame
    from pycricodecs_tpu_torch.ops import hca_kernels as K
    from pycricodecs_tpu_torch.ops import hca_unpack_device as U
    from pycricodecs_tpu_torch.parallel.pipeline import \
        CHUNK_STREAMS as CHUNK
    for mod in ("jax", "pycricodecs_tpu"):
        if mod in sys.modules:
            raise AssertionError(f"the port imported {mod}")

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}")
    log(f"torch.cuda.get_device_name(0): {torch.cuda.get_device_name(0)}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # -- phase 2: build -----------------------------------------------------
    t0 = time.perf_counter()
    _build.load()
    log(f"build: {time.perf_counter() - t0:.3f} s (nvcc "
        f"{_build.BUILD_SECONDS} s)")
    for line in _build.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas:", line.strip())

    # -- fixtures -----------------------------------------------------------
    with open(os.path.join(FIXTURES, "expected.json")) as f:
        expected = json.load(f)
    blobs = {}
    infos = {}
    for name in expected:
        with open(os.path.join(FIXTURES, name + ".hca"), "rb") as f:
            blobs[name] = f.read()
        hs = int.from_bytes(blobs[name][6:8], "big")
        infos[name] = hca_frame.parse_header(blobs[name][:hs])

    def frames_of(name):
        info, blob = infos[name], blobs[name]
        hs = info.header_size
        n = info.frame_count
        return np.frombuffer(blob, np.uint8, count=n * info.frame_size,
                             offset=hs).reshape(n, info.frame_size)

    # -- phase 3: every kernel against its twin on the card -----------------
    log("tolerance: exact - every kernel output must equal its twin's byte "
        "for byte (max |diff| 0)")
    worst = dict.fromkeys(KERNELS, 0)
    bank_info = infos[BANK]
    up = U.DeviceUnpacker(bank_info, dev)
    F = bank_info.frame_count
    chunk_frames = np.tile(frames_of(BANK), (CHUNK, 1))
    dec = up.decipher(torch.from_numpy(chunk_frames).to(dev))
    side_k = up.side_info(dec)
    side_t = up.side_info_plain(dec)
    if bool(side_k[4].any()):
        raise AssertionError("B1 flagged an error on a valid stream")
    worst["hca_side_info"] = require_equal(
        "B1 bank chunk", zip(("sf", "res", "inten", "cur", "err"),
                             side_k, side_t))
    qc_k = up.coefficients(dec, side_k[1], side_k[3])
    qc_t = up.coefficients_plain(dec, side_k[1], side_k[3])
    worst["hca_coefficients"] = require_equal(
        "B2 bank chunk", [("qc", qc_k, qc_t)])
    torch.cuda.synchronize()
    log(f"B1+B2 bank chunk {CHUNK}x{F} frames: byte-equal to the twins")

    # no encoder makes a v3.0 stream without PNS noise; relabelling the q4
    # stereo config (intensity pair + HFR) reaches B1's v3 branches
    v3 = hca_frame.parse_header(
        blobs["q4_stereo_48k_1s"][:infos["q4_stereo_48k_1s"].header_size])
    v3.version = 0x0300
    v3.init_derived()
    rng = np.random.default_rng(0)
    for name, info in [*infos.items(), ("v3_relabel_q4_stereo", v3)]:
        fr = rng.integers(0, 256, (RANDOM_FRAMES, info.frame_size),
                          dtype=np.uint8)
        fr[:, :2] = 0xFF
        fr[:16] = 0                      # zero padding frames decode cleanly
        u = U.DeviceUnpacker(info, dev)
        d = torch.from_numpy(fr).to(dev)
        sk = u.side_info(d)
        st = u.side_info_plain(d)
        w = require_equal(f"B1 random {name}", [("err", sk[4], st[4])])
        ok = ~sk[4]
        if bool(sk[4][:16].any()):
            raise AssertionError(f"B1 random {name}: zero frames flagged")
        if bool(ok.all()):
            raise AssertionError(f"B1 random {name}: no error rule hit")
        w = max(w, require_equal(f"B1 random {name}", [
            (n, a[ok], b[ok]) for n, a, b in zip(("sf", "res", "inten", "cur"),
                                                 sk[:4], st[:4])]))
        worst["hca_side_info"] = max(worst["hca_side_info"], w)
        qk = u.coefficients(d, sk[1], sk[3])
        qt = u.coefficients_plain(d, sk[1], sk[3])
        worst["hca_coefficients"] = max(
            worst["hca_coefficients"],
            require_equal(f"B2 random {name}", [("qc", qk[ok], qt[ok])]))
        log(f"B1+B2 random {name}: {RANDOM_FRAMES} frames, "
            f"{int(ok.sum())} without error: byte-equal to the twins")

    for name, info in infos.items():
        C = info.channels
        g = torch.Generator().manual_seed(1)
        qc = torch.randint(-127, 128, (CHUNK, F, C, 8, 128), generator=g,
                           dtype=torch.int16).to(dev)
        sf = torch.randint(0, 64, (CHUNK, F, C, 128), generator=g,
                           dtype=torch.uint8).to(dev)
        res = torch.randint(0, 16, (CHUNK, F, C, 128), generator=g,
                            dtype=torch.uint8).to(dev)
        inten = torch.randint(0, 16, (CHUNK, F, C, 8), generator=g,
                              dtype=torch.uint8).to(dev)
        hfr, cfg = K.transform_config(info)
        pk = K.hca_decode_transform_batched(qc, sf, res, inten, hfr, **cfg)
        pt = K.decode_transform_plain(qc, sf, res, inten, hfr, **cfg)
        worst["hca_transform"] = max(
            worst["hca_transform"],
            require_equal(f"B3 random {name}", [("pcm", pk, pt)]))
        del qc, sf, res, inten, pk, pt
        log(f"B3 random {name} ({CHUNK}x{F} frames, {C} ch): byte-equal "
            f"to the twin")
    torch.cuda.synchronize()

    # -- phase 4: the slice, through the public entry point -----------------
    bank = [blobs[BANK]] * BANK_STREAMS
    U.SIDE_INFO_LAUNCHES = 0
    U.COEFF_LAUNCHES = 0
    cuda_kernels.TRANSFORM_LAUNCHES = 0
    wavs = port.decode_batch(bank, device=dev)
    launches = {"hca_side_info": U.SIDE_INFO_LAUNCHES,
                "hca_coefficients": U.COEFF_LAUNCHES,
                "hca_transform": cuda_kernels.TRANSFORM_LAUNCHES}
    log(f"slice launches: {launches}")
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{k} was not launched by the main path")
    want = expected[BANK]["wav_sha256"]
    bad = [i for i, w in enumerate(wavs)
           if hashlib.sha256(w).hexdigest() != want]
    if bad:
        raise AssertionError(f"bank WAVs differ from the JAX package's "
                             f"decode: streams {bad[:8]}")
    audio_s = BANK_STREAMS * expected[BANK]["seconds"]
    pcm_bytes = sum(len(w) for w in wavs)
    log(f"bank: {BANK_STREAMS} x {expected[BANK]['seconds']} s decoded on "
        f"the card, all {BANK_STREAMS} WAV sha256 equal to the JAX "
        f"package's ({pcm_bytes} WAV bytes)")
    del wavs
    small = [n for n in expected if n != BANK]
    for name, w in zip(small, port.decode_batch([blobs[n] for n in small],
                                                device=dev)):
        if hashlib.sha256(w).hexdigest() != expected[name]["wav_sha256"]:
            raise AssertionError(f"{name}: WAV differs from the JAX "
                                 f"package's decode")
        log(f"fixture {name}: WAV sha256 equal to the JAX package's")

    # -- phase 5: timing ----------------------------------------------------
    port.decode_batch(bank, device=dev)                      # warm-up
    runs = []
    for _ in range(3):
        st = port.DecodeStats()
        t0 = time.perf_counter()
        port.decode_batch(bank, device=dev, stats=st)
        runs.append((time.perf_counter() - t0, st))
    runs.sort(key=lambda r: r[0])
    wall, st = runs[1]
    log(f"slice [{card}]: median of 3 = {wall:.4f} s for {audio_s:.0f} "
        f"audio-s -> {audio_s / wall:.1f} audio-s/s; runs "
        f"{[round(r[0], 4) for r in runs]}; stats of the median run: "
        f"unpack {st.unpack_seconds:.4f} s, device {st.device_seconds:.4f} "
        f"s, fetch {st.fetch_seconds:.4f} s, total {st.total_seconds:.4f} s")

    bank_hfr, bank_cfg = K.transform_config(bank_info)
    qc4 = qc_k.view(CHUNK, F, bank_info.channels, 8, 128)
    sf4 = side_k[0].view(CHUNK, F, bank_info.channels, 128)
    res4 = side_k[1].view(CHUNK, F, bank_info.channels, 128)
    in4 = side_k[2].view(CHUNK, F, bank_info.channels, 8)
    timed = {
        "hca_side_info": (lambda: up.side_info(dec),
                          lambda: up.side_info_plain(dec)),
        "hca_coefficients": (
            lambda: up.coefficients(dec, side_k[1], side_k[3]),
            lambda: up.coefficients_plain(dec, side_k[1], side_k[3])),
        "hca_transform": (
            lambda: K.hca_decode_transform_batched(
                qc4, sf4, res4, in4, bank_hfr, **bank_cfg),
            lambda: K.decode_transform_plain(
                qc4, sf4, res4, in4, bank_hfr, **bank_cfg)),
    }
    report = []
    for name, (kernel, twin) in timed.items():
        ms = cuda_ms(kernel, 20)
        plain_ms = cuda_ms(twin, 3)
        log(f"{name} [{card}] at {CHUNK}x{F} frames: kernel {ms:.4f} ms, "
            f"twin {plain_ms:.4f} ms")
        report.append(dict(name=name, route="cuda", **KERNELS[name],
                           launches=launches[name],
                           max_abs_err=worst[name], ms=ms,
                           plain_ms=plain_ms))
    log(json.dumps({"kernels": report}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
