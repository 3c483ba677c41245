"""Build and load the port's CUDA kernels.

`load()` compiles every `csrc/*.cu` with nvcc for Hopper (sm_90a), one nvcc
per source, all started together, links the objects into one shared library
with a plain C interface, at first use, and opens it with ctypes. The build
lands in `build/<hash>/` inside this package (ignored by git), keyed by a
hash of the sources, the generated headers and the flags, so a
checkout builds its own kernels and a rebuild happens only when one of them
changes. The constant tables the kernels read are generated from
`ops/hca_tables.py` and `ops/mp2_tables.py` into that directory
(`hca_tables.inc`), so the kernels and the plain PyTorch twins read the
same fp32 and fp64 bit patterns. The DCT-IV of B3, B4 and B5 is generated
there too (`hca_dct4.inc`), as straight-line code from `dct4_schedule()`,
the slot schedule the CPU tests run, and so are B6's window fold and
encoder DCT-IV (`hca_mdct.inc`, from `mdct_schedule()`).

Floating-point contract: `-fmad=false` and no fast-math flag, so every
multiply and add rounds once, as in the JAX reference; `-ftz`, `-prec-div`
and `-prec-sqrt` stay at their IEEE defaults. The one explicit fused
multiply-add is mp2_synth's division: an exact remainder and its correction
give the correctly rounded quotient, the value a division gives.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas=-v")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")
LIB_NAME = "libport_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_U = ctypes.c_uint
# C entry points: each launches its kernel (CRILAYLA's: its stages' kernels,
# in order) on the given stream and returns cudaGetLastError()
SIGNATURES = {
    "hca_side_info": [_P, _I, _P, _P, _P, _P, _P, _P, _P],
    "hca_coefficients": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P],
    "hca_transform": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                      _I, _I, _P, _P, _P, _P, _P, _P],
    "adx_decode": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P,
                   _P],
    "adx_encode": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P,
                   _P],
    "adx_decode_plan": [_I, _I, _I, _I, _P],
    "adx_encode_plan": [_I, _I, _I, _I, _P],
    "hca_mdct": [_P, _L, _I, _P, _P],
    "hca_pack": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _P,
                 _P, _P, _P],
    "mp2_unpack": [_P, _I, _I, _I, _P, _P, _P, _P, _P],
    "mp2_synth": [_P, _P, _P, _I, _I, _I, _P, _P],
    "hca_imdct_ola": [_P, _I, _I, _P, _P],
    "hca_imdct": [_P, _L, _P, _P],
    "mp2_analysis": [_P, _I, _I, _I, _P, _P, _P, _P],
    "mp2_allocate": [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                     _P, _P, _P],
    "mp2_pack": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _U, _P, _L, _I,
                 _P, _P],
    "crilayla_decompress": [_P, _P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P,
                            _P, _P, _P, _P, _P, _P, _P, _P, _L, _I, _P],
    "crilayla_compress": [_P, _P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                          _P],
}

#: the Layer II quantisation classes n whose correctly rounded 1 / n the
#: synthesis kernel keeps (kMp2Recip), at index 0 (5), 1 (9) or k (2^k - 1)
MP2_RECIP_N = (5, 9) + tuple(2 ** k - 1 for k in range(2, 17))

_lib = None
#: wall seconds the last nvcc build took (None: loaded from an earlier build)
BUILD_SECONDS = None
#: nvcc's output of the last build (ptxas register/shared-memory report)
BUILD_LOG = ""


def _c_array(name: str, ctype: str, values) -> str:
    body = ", ".join(values)
    return (f"static __device__ const {ctype} {name}[{len(values)}] = "
            f"{{{body}}};\n")


def _f32_literals(arr) -> list:
    return [float(x).hex() + "f" for x in
            np.asarray(arr, np.float32).reshape(-1)]


def _f64_literals(arr) -> list:
    return [float(x).hex() for x in np.asarray(arr, np.float64).reshape(-1)]


def _int_literals(arr) -> list:
    return [str(int(x)) for x in np.reshape(arr, -1)]


def tables_header() -> str:
    """C++ source of the kernels' constant tables, from the Python tables."""
    from .ops import hca_tables as T
    from .ops import hca_unpack_device as U
    from .ops import mp2_tables
    from .ops import mp2_unpack_device as M
    from .utils.crc import CRC16_TABLE

    out = ["// generated by pycricodecs_tpu_torch/_build.py; do not edit\n",
           "#pragma once\n", "#include <cstdint>\n"]
    out.append(_c_array("kInvertTable", "uint8_t",
                        [str(int(x)) for x in T.INVERT_TABLE]))
    out.append(_c_array("kVlcPacked", "uint32_t",
                        [f"{int(x)}u" for x in U.vlc_packed().reshape(-1)]))
    for name, arr in (("kQsBits", T.QUANTIZE_SPECTRUM_BITS),
                      ("kQsValue", T.QUANTIZE_SPECTRUM_VALUE),
                      ("kQsMaxBits", T.QUANTIZED_SPECTRUM_MAX_BITS)):
        out.append(_c_array(name, "uint8_t",
                            [str(int(x)) for x in np.reshape(arr, -1)]))
    out.append(_c_array("kCrc16", "uint16_t",
                        [str(int(x)) for x in CRC16_TABLE]))
    for name, arr in (("kScalingTable", T.SCALING_TABLE),
                      ("kRangeTable", T.RANGE_TABLE),
                      ("kScaleConversionTable", T.SCALE_CONVERSION_TABLE),
                      ("kIntensityRatioTable", T.INTENSITY_RATIO_TABLE),
                      ("kImdctWindow", T.IMDCT_WINDOW)):
        out.append(_c_array(name, "float", _f32_literals(arr)))
    # MPEG Layer II: B10's header and allocation tables, the synthesis's
    # scalefactors (K2's too), transposed matrixing nt[k][q] = N[q][k] and
    # window
    mt = M.tables()
    for name, ctype, arr in (("kMp2Nbal", "uint8_t", mt["nbal"]),
                             ("kMp2Classes", "uint16_t", mt["classes"]),
                             ("kMp2Gbits", "uint8_t", mt["gbits"]),
                             ("kMp2Ubits", "uint8_t", mt["ubits"]),
                             ("kMp2Sblimit", "int", mt["sblimit"]),
                             ("kMp2TableSelect", "uint8_t", mt["select"]),
                             ("kMp2Bitrate", "int", mt["bitrate"]),
                             ("kMp2Rate", "int", mt["rate"])):
        out.append(_c_array(name, ctype, _int_literals(arr)))
    # and the encoder's analysis matrix, transposed (Mt[q][k] = M[k][q]),
    # and window C (K1)
    for name, arr in (("kMp2Sf", mp2_tables.scalefactors()),
                      ("kMp2Nt", mp2_tables.synthesis_matrixing().T),
                      ("kMp2Dwin", mp2_tables.synth_window()),
                      ("kMp2AmT", mp2_tables.analysis_matrix().T),
                      ("kMp2Cwin", mp2_tables.analysis_window()),
                      ("kMp2Recip", 1.0 / np.asarray(MP2_RECIP_N,
                                                     np.float64))):
        out.append(_c_array(name, "double", _f64_literals(arr)))
    return "".join(out)


def dct4_schedule():
    """The slot schedule of the reference's 7 add/sub + 7 twiddle stage
    DCT-IV (hca.cpp:1898-1979), in place: one thread holds a row's 128
    values in 128 slots (registers), and every stage is a butterfly that
    writes its two results back into its operands' slots. Returns
    (stages, slot_of): stages[i] lists (a, b, tw) per butterfly, the slots
    of its first and second operand and, for a twiddle stage, the flat
    index into IMDCT_SIN / IMDCT_COS (-1 for an add/sub stage); slot_of[l]
    is the slot that holds logical output l at the end.

    Add/sub stage: (a, b) <- (a + b, a - b). Twiddle stage, with s1 in slot
    a, s2 in slot b: (a, b) <- (s1 * sin - s2 * cos, s1 * cos + s2 * sin).
    Where each result lands logically (the add/sub tree's index rotation,
    the twiddle stages' flip of the second half) is only a relabelling of
    the slots, tracked here; the arithmetic per value is the reference's."""
    slot_of = list(range(128))          # logical index -> slot
    stages = []
    for i in range(7):                  # part 1: add/sub tree
        c2 = 64 >> i
        ops, new = [], [0] * 128
        for base in range(0, 128, 2 * c2):
            for j in range(c2):
                a, b = slot_of[base + 2 * j], slot_of[base + 2 * j + 1]
                ops.append((a, b, -1))
                new[base + j], new[base + c2 + j] = a, b
        stages.append(ops)
        slot_of = new
    for i in range(7):                  # part 2: twiddle stages
        c2 = 1 << i
        ops, new = [], [0] * 128
        for g, base in enumerate(range(0, 128, 2 * c2)):
            for j in range(c2):
                a, b = slot_of[base + j], slot_of[base + c2 + j]
                ops.append((a, b, i * 64 + g * c2 + j))
                new[base + j], new[base + 2 * c2 - 1 - j] = a, b
        stages.append(ops)
        slot_of = new
    return stages, slot_of


def dct4_source() -> str:
    """C++ of `dct4_schedule()`: `dct4_slots(v)` runs the 14 stages on the
    128 slots in place (twiddles as f32 literals), `dct4_order(v, y)` names
    the results in logical order (register renaming, no instructions once
    inlined), `dct4_row(row, y)` loads a thread's row and runs both."""
    from .ops import hca_tables as T

    sin = _f32_literals(T.IMDCT_SIN)
    cos = _f32_literals(T.IMDCT_COS)
    stages, slot_of = dct4_schedule()
    out = ["// generated by pycricodecs_tpu_torch/_build.py (dct4_source); "
           "do not edit\n", "#pragma once\n",
           "__device__ __forceinline__ void dct4_slots(float (&v)[128]) {\n",
           "  float a, b;\n"]
    for i, ops in enumerate(stages):
        out.append(f"  // stage {i}\n")
        for a, b, tw in ops:
            if tw < 0:
                out.append(f"  a = v[{a}]; b = v[{b}]; "
                           f"v[{a}] = __fadd_rn(a, b); "
                           f"v[{b}] = __fsub_rn(a, b);\n")
            else:
                sn, cs = sin[tw], cos[tw]
                out.append(f"  a = v[{a}]; b = v[{b}]; "
                           f"v[{a}] = __fsub_rn(__fmul_rn(a, {sn}), "
                           f"__fmul_rn(b, {cs})); "
                           f"v[{b}] = __fadd_rn(__fmul_rn(a, {cs}), "
                           f"__fmul_rn(b, {sn}));\n")
    out.append("}\n")
    out.append("__device__ __forceinline__ void dct4_order("
               "const float (&v)[128], float (&y)[128]) {\n")
    out += [f"  y[{l}] = v[{s}];\n" for l, s in enumerate(slot_of)]
    out.append("}\n")
    # a thread's 16-byte aligned row of 128 floats -> slots, DCT-IV, results
    # in logical order
    out.append(
        "__device__ __forceinline__ void dct4_row(const float* row, "
        "float (&y)[128]) {\n"
        "  float v[128];\n"
        "#pragma unroll\n"
        "  for (int q = 0; q < 32; ++q) {\n"
        "    const float4 t = reinterpret_cast<const float4*>(row)[q];\n"
        "    v[4 * q] = t.x;\n"
        "    v[4 * q + 1] = t.y;\n"
        "    v[4 * q + 2] = t.z;\n"
        "    v[4 * q + 3] = t.w;\n"
        "  }\n"
        "  dct4_slots(v);\n"
        "  dct4_order(v, y);\n"
        "}\n")
    return "".join(out)


def mdct_schedule():
    """The slot schedule of kernel B6's DCT-IV, the encoder's network
    (hca.cpp:2481-2527; `mdct_plain`'s `dct4`), in place on a row's 128
    slots, slot j holding fold output j at the start. Returns
    (pre, stages, out_slot):
    - pre lists (a, b, tw) per pre-rotation butterfly k: the slots of
      x[2k] and x[127-2k] and the flat index 127 + k into DCT4_SIN_FLAT /
      DCT4_COS_FLAT; (a, b) <- (a * cos + b * sin, a * sin - b * cos), which
      are logical values 2k and 2k+1;
    - stages[s] lists (fe, fo, be, bo, tw) per 4-value butterfly of stage s
      (half block size bhs = 32 >> s): the slots of the front pair and the
      back pair, and the flat twiddle index bhs - 1 + i; with
      a2 = fe - be, b2 = fo - bo: fe <- fe + be, fo <- fo + bo,
      be <- a2 * cos + b2 * sin, bo <- a2 * sin - b2 * cos;
    - out_slot[j] is the slot of temp[SHUFFLE_TABLE[j]], output j before
      its final * 0.125.
    The pre-rotation's landing (logical 2k+1 in the slot of x[127-2k]) and
    the SHUFFLE_TABLE gather are relabellings of the slots, fixed here."""
    from .ops import hca_tables as T

    pre = [(2 * k, 127 - 2 * k, 127 + k) for k in range(64)]
    slot_of = [0] * 128                 # logical index -> slot
    for k in range(64):
        slot_of[2 * k], slot_of[2 * k + 1] = 2 * k, 127 - 2 * k
    stages = []
    for s in range(6):
        bhs = 32 >> s
        ops = []
        for blk in range(1 << s):
            for i in range(bhs):
                f = blk * 4 * bhs + 2 * i
                b = f + 2 * bhs
                ops.append((slot_of[f], slot_of[f + 1], slot_of[b],
                            slot_of[b + 1], bhs - 1 + i))
        stages.append(ops)
    out_slot = [slot_of[int(j)] for j in T.SHUFFLE_TABLE]
    return pre, stages, out_slot


def mdct_source() -> str:
    """C++ of kernel B6's window fold and `mdct_schedule()`:
    `mdct_fold(v, cur, prev)` writes the 128 fold outputs into v, reading
    the block (cur) and the one before it (prev) 8 values at a time as
    `cur(chunk, f)` (values 8 * chunk .. 8 * chunk + 7 into f[8]), window
    values as f32 literals with their sign folded in (w * -x and -w * x
    round alike);
    `mdct_slots(v)` runs the pre-rotation and the six stages in place
    (twiddles as f32 literals); `mdct_order(v, y)` names the results in
    output order (register renaming, no instructions once inlined)."""
    from .ops import hca_tables as T

    w = np.asarray(T.IMDCT_WINDOW, np.float32)
    lit = _f32_literals
    wl, nwl = lit(w), lit(-w)
    sin = lit(T.DCT4_SIN_FLAT)
    cos = lit(T.DCT4_COS_FLAT)
    pre, stages, out_slot = mdct_schedule()
    out = ["// generated by pycricodecs_tpu_torch/_build.py (mdct_source); "
           "do not edit\n", "#pragma once\n",
           "template <class Cur, class Prev>\n",
           "__device__ __forceinline__ void mdct_fold(float (&v)[128], "
           "Cur cur, Prev prev) {\n", "  float h[8], l[8];\n"]
    # first[j] = w[63-j] * -x[64+j] - (-w[64+j]) * x[63-j]     (j < 64)
    # second[j] = w[j] * p[j] - (-w[127-j]) * p[127-j]
    for half, load, (ha, la) in ((0, "cur", (8, 7)), (1, "prev", (0, 15))):
        for m in range(8):
            out.append(f"  {load}({ha + m}, h); {load}({la - m}, l);\n")
            for e in range(8):
                j = 8 * m + e
                if half == 0:
                    a, b = nwl[63 - j], nwl[64 + j]
                else:
                    a, b = wl[j], nwl[127 - j]
                out.append(f"  v[{64 * half + j}] = __fsub_rn(__fmul_rn("
                           f"h[{e}], {a}), __fmul_rn(l[{7 - e}], {b}));\n")
    out.append("}\n")
    out += ["__device__ __forceinline__ void mdct_slots(float (&v)[128]) {\n",
            "  float a, b, c, d, e, f;\n", "  // pre-rotation\n"]
    for a, b, tw in pre:
        sn, cs = sin[tw], cos[tw]
        out.append(f"  a = v[{a}]; b = v[{b}]; "
                   f"v[{a}] = __fadd_rn(__fmul_rn(a, {cs}), "
                   f"__fmul_rn(b, {sn})); "
                   f"v[{b}] = __fsub_rn(__fmul_rn(a, {sn}), "
                   f"__fmul_rn(b, {cs}));\n")
    for s, ops in enumerate(stages):
        out.append(f"  // stage {s}\n")
        for fe, fo, be, bo, tw in ops:
            sn, cs = sin[tw], cos[tw]
            out.append(f"  a = v[{fe}]; b = v[{fo}]; c = v[{be}]; "
                       f"d = v[{bo}]; e = __fsub_rn(a, c); "
                       f"f = __fsub_rn(b, d); v[{fe}] = __fadd_rn(a, c); "
                       f"v[{fo}] = __fadd_rn(b, d); "
                       f"v[{be}] = __fadd_rn(__fmul_rn(e, {cs}), "
                       f"__fmul_rn(f, {sn})); "
                       f"v[{bo}] = __fsub_rn(__fmul_rn(e, {sn}), "
                       f"__fmul_rn(f, {cs}));\n")
    out.append("}\n")
    out.append("__device__ __forceinline__ void mdct_order("
               "const float (&v)[128], float (&y)[128]) {\n")
    out += [f"  y[{j}] = v[{s}];\n" for j, s in enumerate(out_slot)]
    out.append("}\n")
    return "".join(out)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): "
                           "the CUDA kernels cannot be built")
    return path


def build() -> Path:
    """Compile the kernels unless this exact build exists; return the .so."""
    global BUILD_SECONDS, BUILD_LOG
    sources = sorted(CSRC_DIR.glob("*.cu"))
    header = tables_header()
    generated = {"hca_tables.inc": header, "hca_dct4.inc": dct4_source(),
                 "hca_mdct.inc": mdct_source()}
    h = hashlib.sha256()
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    for name, text in generated.items():
        h.update(name.encode())
        h.update(text.encode())
    h.update(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    out_dir = BUILD_DIR / h.hexdigest()[:16]
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    # write-then-rename: a concurrent build never sees a partial file
    for name, text in generated.items():
        inc_tmp = out_dir / f"{name}.{os.getpid()}.tmp"
        inc_tmp.write_text(text)
        os.replace(inc_tmp, out_dir / name)
    pid = os.getpid()
    tmp = out_dir / f"{LIB_NAME}.{pid}.tmp"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    # one nvcc per source, all at once; then one link
    jobs = []
    for src in sources:
        obj = out_dir / f"{src.stem}.{pid}.o"
        cmd = [nvcc, *NVCC_FLAGS, f"-I{out_dir}", "-c", "-o", str(obj),
               str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for cmd, _, proc in jobs:
        try:
            log, _ = proc.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
        logs.append(log)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{log}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    cmd = [nvcc, *LINK_FLAGS, "-o", str(tmp), *(str(j[1]) for j in jobs)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed with exit code "
                           f"{proc.returncode}:\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    for _, obj, _ in jobs:
        obj.unlink()
    BUILD_SECONDS = time.perf_counter() - t0
    BUILD_LOG = "".join(logs) + proc.stdout + proc.stderr
    os.replace(tmp, lib)
    return lib


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
