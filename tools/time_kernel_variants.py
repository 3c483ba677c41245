#!/usr/bin/env python3
"""Ablations of kernels B3 (`hca_transform`), `mp2_synth` and K1
(`mp2_analysis`), on one CUDA GPU: where a kernel's time goes, phase by
phase.

Each variant is the kernel's source with one phase switched off by a text
substitution (the phase runs only when a runtime condition that never
holds is true, so the compiler keeps the rest as it is), built alone with
the port's nvcc flags into its own library and swapped in for the port's
library; the baseline is the port's own build. Variants:
- B3: `no_dct` (the DCT-IV replaced by a copy of the row), `no_stage` (no
  spectra staged), `no_copy` (no cp.async of qc, maps and frame rows),
  `no_store` (no PCM store);
- mp2_synth: `no_dequant`, `no_quotient` (the quotient's reciprocal path
  replaced by one multiply), `no_matrix`, `no_window`;
- K1: `k1_no_stage` (no PCM widened to doubles; its copies still
  arrive), `k1_no_fold` (neither half's window fold), `k1_no_matrix`
  (neither half's matrixing), `k1_no_out` (no S or peaks stored),
  `k1_matrix_only` (the last three off at once: the matrixing alone),
  `k1_matrix_y_regs` and `k1_matrix_m_regs` (that, with a q step's Y
  values, or its matrix values, from registers instead of shared memory:
  what those loads cost the matrixing);
- K3 (`mp2_pack`): `k3_no_table` (the class table read by each lane from
  global memory, no copy into shared memory and no CTA barrier for it),
  `k3_no_stage` (no codes staged: the sample fields pack whatever the
  staging buffer holds), `k3_no_samples` (no sample section),
  `k3_no_store` (no frame bytes stored), `k3_skeleton` (the last three
  off at once), `k3_bare` (the walk alone, no frame packed),
  `k3_no_atomics` (each shared atomicOr a plain store), `k3_half_grid`
  (half as many CTAs an SM);
- C2 (`crilayla_compress`): `c2_wide_keys` (every search tile on the
  64-bit path, never the 32-bit keys; the output stays exact).
A variant's output is wrong by design; only its time is read. Shapes: B3 at
the HCA bank chunk (the bank's real spectra, and random PNS maps), the
synthesis at the AHX bank, as tools/time_transform_synth.py, K1 and K3 at
the AHX encode bank (256 x 192 frames of the bank PCM; K3 packs K2's
outputs), C2 at chip_smoke.py phase 19's compressed archive (22 members,
9.09 MB). --source limits the run to the variants of one source file (and
its kernel's baseline); --root takes the sources and the baseline library
from the port under DIR (default: this checkout). Each variant
is timed in --rounds rounds (median of --reps CUDA-event runs each; K3
by the median of --reps kernel records of torch.profiler, its device time
alone, since a K3 launch is shorter than the host's enqueue of one), the
baseline first in every round. Prints one line per variant and round with
the card's name and power limit, and last one JSON line. With --sass,
also the static SASS instruction counts by opcode class (`cuobjdump
-sass`, as tools/time_transform_synth.py counts them) of the kernel in
the baseline and in each variant, which show whether ptxas shared or
dropped instructions of a variant (a phase switched off by a runtime test
still counts) and whether it spilled. No CPU path.

Run from the repository root:
    python3 tools/time_kernel_variants.py [--rounds N] [--reps N] [--sass]
        [--root DIR] [--variants NAME,...]
        [--source hca_transform.cu|mp2_synth.cu|mp2_analysis.cu|mp2_encode.cu
                  |crilayla.cu]
"""
import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import tempfile

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEVER = "cfg.F < 0"          # B3: a condition that never holds
NEVER_SYNTH = "F < 0"        # mp2_synth and K1: the same
VARIANTS = {
    "no_dct": ("hca_transform.cu", [(
        "    dct4_row(myrow, y);",
        "#pragma unroll\n"
        "    for (int q = 0; q < 128; ++q) y[q] = myrow[q];")]),
    "no_stage": ("hca_transform.cu", [(
        "  for (int r = w * 32 / nw; r < (w + 1) * 32 / nw; ++r) {",
        f"  for (int r = w * 32 / nw; r < ({NEVER} ? 32 : 0); ++r) {{")]),
    "no_copy": ("hca_transform.cu", [(
        "  for (int ch = 0; ch < nch; ++ch) {\n"
        "    const int c = ch ? c1 : c0;",
        f"  for (int ch = 0; ch < ({NEVER} ? nch : 0); ++ch) {{\n"
        "    const int c = ch ? c1 : c0;")]),
    "no_store": ("hca_transform.cu", [(
        "  for (int r = 1 + w; r < 32; r += nw) {",
        f"  for (int r = 1 + w; r < ({NEVER} ? 32 : 0); r += nw) {{")]),
    "no_dequant": ("mp2_synth.cu", [(
        "    dequantise(levels, sfidx, b, c, F, C, T, t0, 0, cq, S);",
        f"    if ({NEVER_SYNTH})\n"
        "      dequantise(levels, sfidx, b, c, F, C, T, t0, 0, cq, S);")]),
    "no_quotient": ("mp2_synth.cu", [(
        "  if (idx < 0) return __ddiv_rn(a, (double)n);",
        "  if (idx < 0 || n > 0) return __dmul_rn(a, (double)n);")]),
    "no_matrix": ("mp2_synth.cu", [(
        "    matrixing(S, V, 0);",
        f"    if ({NEVER_SYNTH}) matrixing(S, V, 0);")]),
    "no_window": ("mp2_synth.cu", [(
        "    window(V, t0, T, o_bc);",
        f"    if ({NEVER_SYNTH}) window(V, t0, T, o_bc);")]),
    "k1_no_stage": ("mp2_analysis.cu", [(
        "    // at store e, lane l writes its piece (e + l / 2) % 4\n"
        "    for (int i = tid; i < kChunks; i += kThreads) {",
        f"    for (int i = tid; i < ({NEVER_SYNTH} ? kChunks : 0); "
        "i += kThreads) {")]),
    "k1_no_fold": ("mp2_analysis.cu", [
        (f"    fold<{h}>(xs, Yq, warp, lane);",
         f"    if ({NEVER_SYNTH}) fold<{h}>(xs, Yq, warp, lane);")
        for h in (0, 1)]),
    "k1_no_matrix": ("mp2_analysis.cu", [
        (f"    matrix<{h}>(Yq, Mt, rg, kg, acc);",
         f"    if ({NEVER_SYNTH}) matrix<{h}>(Yq, Mt, rg, kg, acc);")
        for h in (0, 1)]),
    "k1_no_out": ("mp2_analysis.cu", [(
        "    if (f < F) {\n      double2* dst",
        f"    if ({NEVER_SYNTH}) {{\n      double2* dst"), (
        "  if (f < F)\n    frame_peaks[",
        f"  if ({NEVER_SYNTH})\n    frame_peaks[")]),
}
VARIANTS["k1_matrix_only"] = ("mp2_analysis.cu", [
    sub for name in ("k1_no_stage", "k1_no_fold", "k1_no_out")
    for sub in VARIANTS[name][1]])
# the matrixing alone with one operand from registers: each q step's
# loads of Y (k1_matrix_y_regs) or of Mt (k1_matrix_m_regs) replaced by the
# first step's values; the other operand is still loaded every step, so
# every step's products differ and none can be shared (--sass shows the
# DMUL/DADD counts equal k1_matrix_only's)
VARIANTS["k1_matrix_y_regs"] = ("mp2_analysis.cu",
                                VARIANTS["k1_matrix_only"][1] + [(
    "      const double2 t = yr[qq * kYStride / 2 + v];",
    "      const double2 t = yr[v];")])
VARIANTS["k1_matrix_m_regs"] = ("mp2_analysis.cu",
                                VARIANTS["k1_matrix_only"][1] + [(
    "    const double2 mv = mc[qq * 16];",
    "    const double2 mv = mc[0];")])
# K3: the persistent kernel (a CTA of 8 warps walking the frames, the class
# table copied into shared memory once a CTA)
K3 = {
    "k3_no_table": [
        ("  for (int i = threadIdx.x; i < 32 * kClasses; i += kPackWarps * 32)"
         "\n    tab[i] = ctab[i] | ctab[kGbitsOff + i] << 17 | "
         "ctab[kUbitsOff + i] << 21;\n  if (threadIdx.x < 32)\n"
         "    tab[32 * kClasses + threadIdx.x] = ctab[kNbalOff + threadIdx.x];"
         "\n  __syncthreads();", ""),
        ("  const int nb = tab[32 * kClasses + sb];",
         "  const int nb = __ldg(ctab + kNbalOff + sb);"),
        ("  const int* trow = tab + sb * kClasses;",
         "  const int* trow = ctab;"),
        ("    const int e = c < nch ? trow[a[c] & (kClasses - 1)] : 0;",
         "    const int i_ = sb * kClasses + (a[c] & (kClasses - 1));\n"
         "    const int e = c < nch ? (__ldg(trow + i_) | __ldg(trow + "
         "kGbitsOff + i_) << 17 | __ldg(trow + kUbitsOff + i_) << 21) : 0;")],
    "k3_no_stage": [(
        "    if (lane + 32 * k < C * kCodeChunks)\n      copy16(",
        "    if (lane + 32 * k < C * kCodeChunks && gid < 0)\n"
        "      copy16(")],
    "k3_no_samples": [(        # both granule loops: the fast one and
        "for (int gr = 0; gr < 12; ++gr) {",     # the field-by-field one
        "for (int gr = 0; gr < (nb < 0 ? 12 : 0); ++gr) {")],
    "k3_no_store": [(
        "    store_frame(words, out + b * total + cur.off0, fs, lane);",
        f"    if ({NEVER_SYNTH})\n"
        "      store_frame(words, out + b * total + cur.off0, fs, lane);")],
}
# K3 with the staging, the samples and the store all off: what is left is
# the walk, the side info's loads, the zeroing, the scans and the side
# sections
K3["k3_skeleton"] = [sub for name in ("k3_no_stage", "k3_no_samples",
                                      "k3_no_store")
                     for sub in K3[name]]
for _name, _subs in K3.items():
    VARIANTS[_name] = ("mp2_encode.cu", _subs)
# the walk alone, no frame packed (`k3_bare`); each atomicOr a plain store
# (`k3_no_atomics`, the words wrong: what the shared atomics cost); half as
# many CTAs an SM, the same code (`k3_half_grid`: does the time follow the
# warps, or a resource the SM shares?)
VARIANTS["k3_bare"] = ("mp2_encode.cu", K3["k3_skeleton"] + [(
    "    pack_words<C>(words,", f"    if ({NEVER_SYNTH})\n"
    "    pack_words<C>(words,")])
VARIANTS["k3_no_atomics"] = ("mp2_encode.cu", [
    ("  atomicOr(w, xh >> b0);", "  w[0] = xh >> b0;"),
    ("    atomicOr(w + 1, w1);", "    w[1] = w1;"),
    ("    atomicOr(w + 2, xl << (32 - b0));", "    w[2] = xl << (32 - b0);"),
    ("  atomicOr(w, wv[0]);", "  w[0] = wv[0];"),
    ("      atomicOr(w + j, wv[j]);", "      w[j] = wv[j];")])
VARIANTS["k3_half_grid"] = ("mp2_encode.cu", [(
    "    held = per_sm * sms;", "    held = (per_sm / 2) * sms;")])
VARIANTS["c2_wide_keys"] = ("crilayla.cu", [(
    "__syncthreads_or(cmax + (uint32_t)t.cnt > kNarrowMax);",
    "__syncthreads_or(cmax + (uint32_t)t.cnt >= 0u);")])
#: the entry point and the timed calls of each source's kernel
ENTRY = {"hca_transform.cu": ("hca_transform", ("b3_ms", "b3_pns_ms")),
         "mp2_synth.cu": ("mp2_synth", ("synth_ms",)),
         "mp2_analysis.cu": ("mp2_analysis", ("k1_ms",)),
         "mp2_encode.cu": ("mp2_pack", ("k3_ms",)),
         "crilayla.cu": ("crilayla_compress", ("c2_ms",))}
#: the kernel (its name in the SASS) of each source
KERNEL = {"hca_transform.cu": "hca_transform_kernel",
          "mp2_synth.cu": "mp2_synth_kernel",
          "mp2_analysis.cu": "mp2_analysis_kernel",
          "mp2_encode.cu": "mp2_pack_kernel",
          "crilayla.cu": "c2_search_kernel"}


def substitute(name: str, text: str) -> str:
    """The variant's source: its substitutions applied to `text`."""
    for old, new in VARIANTS[name][1]:
        if old not in text:
            raise SystemExit(f"{name}: anchor not in {VARIANTS[name][0]}: "
                             f"{old!r}")
        text = text.replace(old, new)
    return text


def print_sass(base_so: str, libs: dict, sources) -> dict:
    """Print and return the SASS counts of each source's kernel in the
    baseline library and in each variant's."""
    spec = importlib.util.spec_from_file_location(
        "time_transform_synth",
        os.path.join(REPO, "tools", "time_transform_synth.py"))
    tts = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tts)
    out = {}
    for src in sources:
        out[f"baseline {src}"] = tts.sass_counts(
            base_so, names=(KERNEL[src],)).get(KERNEL[src])
    for name, lib in libs.items():
        src = VARIANTS[name][0]
        out[name] = tts.sass_counts(lib._name, names=(KERNEL[src],)).get(
            KERNEL[src])
    for k, v in out.items():
        print(f"sass {k}: {v}", flush=True)
    return out


def build_variants(build, gen_dir: str, out_dir: str, names) -> dict:
    """name -> ctypes library of each named variant (all nvcc runs at
    once)."""
    jobs = {}
    for name in names:
        src = VARIANTS[name][0]
        with open(os.path.join(build.CSRC_DIR, src)) as f:
            text = substitute(name, f.read())
        cu = os.path.join(out_dir, name + ".cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(out_dir, name + ".so")
        cmd = [build._nvcc(), *build.NVCC_FLAGS, f"-I{gen_dir}", "-shared",
               "-o", so, cu]
        jobs[name] = (so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate(timeout=900)
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(so)
        fn = ENTRY[VARIANTS[name][0]][0]
        getattr(lib, fn).argtypes = build.SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def load_tool(name: str):
    """A module of this checkout by path (chip_smoke.py, a tool)."""
    path = os.path.join(REPO, *name.split("/")) + ".py"
    spec = importlib.util.spec_from_file_location(
        os.path.basename(name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def hca_bank_calls(S, dev) -> dict:
    """B3's timed calls at the HCA bank chunk (real spectra; random PNS
    maps)."""
    from pycricodecs_tpu_torch.ops import hca_frame
    from pycricodecs_tpu_torch.ops import hca_kernels as K
    from pycricodecs_tpu_torch.ops import hca_unpack_device as U
    from pycricodecs_tpu_torch.parallel import pipeline as P
    with open(os.path.join(S.FIXTURES, S.BANK + ".hca"), "rb") as f:
        blob = f.read()
    hs = int.from_bytes(blob[6:8], "big")
    info = hca_frame.parse_header(blob[:hs])
    F, C, B = info.frame_count, info.channels, P.CHUNK_STREAMS
    frames = np.frombuffer(blob, np.uint8, count=F * info.frame_size,
                           offset=hs).reshape(F, -1)
    qc, sf, res, inten, _ = U.DeviceUnpacker(info, device=dev)(
        torch.from_numpy(np.tile(frames, (B, 1))).to(dev))
    spec = (qc.view(B, F, C, 8, 128), sf.view(B, F, C, 128),
            res.view(B, F, C, 128), inten.view(B, F, C, 8))
    hfr, cfg = K.transform_config(info)
    rnd, noise = S.random_transform_inputs(
        torch.Generator().manual_seed(12), B, F, C, dev)
    return {
        "b3_ms": lambda: K.hca_decode_transform_batched(*spec, hfr, **cfg),
        "b3_pns_ms": lambda: K.hca_decode_transform_batched(
            *rnd, hfr, noise=noise, **cfg)}


def synth_calls(S, dev) -> dict:
    """`mp2_synth`'s timed call at the AHX bank."""
    from pycricodecs_tpu_torch.ops import cuda_kernels
    from pycricodecs_tpu_torch.parallel import pipeline as P
    from pycricodecs_tpu_torch.utils import signals
    _, blobs = S.load_ahx_fixtures()
    stack = P._stack_mp2_frames(
        [P._parse_mp2(blobs[signals.AHX_BANK])[1]] * S.BANK_STREAMS)
    Bs, Fs, fs_max = stack.shape
    codes, levels, sfidx, _ = cuda_kernels.mp2_unpack(
        torch.from_numpy(stack.reshape(Bs * Fs, fs_max)).to(dev), 1)
    bank = (codes.view(Bs, Fs, 1, 36, 32), levels.view(Bs, Fs, 1, 32),
            sfidx.view(Bs, Fs, 1, 3, 32))
    return {"synth_ms": lambda: cuda_kernels.mp2_synth(*bank)}


def encode_calls(S, dev) -> dict:
    """K1's timed call at the AHX encode bank; K3's at K2's outputs of the
    bank."""
    from pycricodecs_tpu_torch.ops import cuda_kernels
    x = load_tool("tools/time_mp2_encode").bank_inputs(dev)
    return {"k1_ms": lambda: cuda_kernels.mp2_analysis(x["pcm"]),
            "k3_ms": x["k3"]}


def k3_device_ms(S, fn, reps: int) -> float:
    """K3's device time (torch.profiler's kernel records): a K3 launch is
    shorter than the host's enqueue of one, so CUDA events around calls
    would time the host."""
    return load_tool("tools/time_mp2_encode").device_ms(
        fn, "mp2_pack_kernel", reps)


def crilayla_calls(S, dev) -> dict:
    """C2's timed call at phase 19's compressed archive."""
    from pycricodecs_tpu_torch.models import crilayla
    from pycricodecs_tpu_torch.ops import cuda_kernels
    from pycricodecs_tpu_torch.utils import signals
    from pycricodecs_tpu_torch.utils.wav import write_wav
    members = signals.compressed_archive_members(S.FIXTURES, write_wav)
    src, meta, work_size = crilayla.pack_compress(list(members.values()))
    src_t = torch.from_numpy(src).to(dev)
    return {"c2_ms": lambda: cuda_kernels.crilayla_compress(src_t, meta,
                                                            work_size)}


#: how a timed call is timed, where not by CUDA events (`chip_smoke.cuda_ms`)
TIMER = {"k3_ms": k3_device_ms}


#: the builder of each source's timed calls
CALLS = {"hca_transform.cu": hca_bank_calls, "mp2_synth.cu": synth_calls,
         "mp2_analysis.cu": encode_calls, "mp2_encode.cu": encode_calls,
         "crilayla.cu": crilayla_calls}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--root", default=REPO,
                    help="directory holding the pycricodecs_tpu_torch whose "
                         "sources and build to ablate")
    ap.add_argument("--source", choices=sorted(ENTRY),
                    help="only this source's variants")
    ap.add_argument("--variants",
                    help="only these variants (comma-separated names)")
    ap.add_argument("--sass", action="store_true",
                    help="SASS instruction counts of the baseline's and "
                         "each variant's kernel")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_kernel_variants: no CUDA GPU")
    root = os.path.abspath(args.root)
    load_tool("tools/time_mp2_encode").import_port(root)
    from pycricodecs_tpu_torch import _build
    S = load_tool("chip_smoke")
    dev = torch.device("cuda", 0)
    card = S.card_line()
    base = _build.load()
    tmp = tempfile.mkdtemp(prefix="variants", dir=str(_build.BUILD_DIR))
    sources = [s for s in ENTRY if args.source in (None, s)]
    names = [n for n, (src, _) in VARIANTS.items() if src in sources]
    if args.variants:
        names = [n for n in args.variants.split(",") if n in names]
    libs = build_variants(_build, os.path.dirname(str(_build.build())), tmp,
                          names)
    sass = print_sass(str(_build.build()), libs, sources) if args.sass \
        else None
    timed = {}
    for builder in dict.fromkeys(CALLS[s] for s in sources):
        timed.update(builder(S, dev))
    timed = {k: timed[k] for s in sources for k in ENTRY[s][1]}
    out = {"root": os.path.relpath(root, REPO), "card": card, "runs": [],
           "sass": sass}
    try:
        for rnd_i in range(args.rounds):
            for name, lib in [("baseline", base), *libs.items()]:
                _build._lib = lib
                keys = list(timed) if name == "baseline" else \
                    list(ENTRY[VARIANTS[name][0]][1])
                r = {k: TIMER.get(k, lambda S, fn, n: S.cuda_ms(fn, n))(
                    S, timed[k], args.reps) for k in keys}
                out["runs"].append({"round": rnd_i, "variant": name, **r})
                print(f"[{card}] ({out['root']}) round {rnd_i} {name}: "
                      + ", ".join(f"{k} {v:.4f}" for k, v in r.items()),
                      flush=True)
    finally:
        _build._lib = base
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
