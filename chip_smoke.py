#!/usr/bin/env python3
"""GPU smoke test of the PyTorch + CUDA port (pycricodecs_tpu_torch).

Drives the port's main paths on one CUDA GPU: the batched HCA bank decode,
the batched ADX bank decode and encode, the batched HCA bank encode, the v3
PNS decode, the AHX decode, the HCA key search, the AWB/ACB bank decode,
the single-file surfaces and the CLI, the AHX encode, and the frame-range
decode, the single-frame key test, the Layer II decode, the container
builders and the graft entry, the sharded paths, and the CPK / USM / IVF
containers with CRILAYLA's kernels.

HCA:

1. prints the card (nvidia-smi name and power limit);
2. builds the three hand-written kernels from csrc/ with nvcc;
3. checks each kernel against its plain PyTorch twin on the card, byte for
   byte: B1 side info and B2 spectra on a 64-stream chunk of the bank stream
   plus 4096 random-byte frames per fixture config and per a v3.0 relabel of
   the q4 stereo config (which reaches B1's v3 branches: the scalefactor
   extension copy and the delta-coded intensity with its error rule) and per
   a relabel of it to frame size 515 (B2's byte staging), each 4096 + 13
   frames (a ragged last CTA), B3
   transform on random legal inputs for all five fixture configs at
   64 streams x 469 frames, and at its tile edges (F = 1, B = 1, F * 8
   below, at and off multiples of its 31-subframe tile, the 6-channel
   config) without and with random PNS maps;
4. decodes the 256-stream x 10 s stereo bank (BASELINE config 5) with
   `decode_batch(..., device="cuda")`, holds every WAV to the sha256 the
   JAX package's decode gives (tests/data/torch_port/expected.json), does
   the same for the four 1 s fixtures, and checks that every kernel ran;
5. times the slice (median of 3 runs after a warm-up) and each kernel and
   twin at the chunk shape (CUDA events).

ADX (tests/data/torch_port/adx/, hashes from the JAX package):
6. B7 decode and B8 encode against their twins on the card, byte for byte:
   random block bytes for bit depths 2/4/5/8/11/12/15 in modes 2/3/4 (odd
   spb 25, spb 1 and 1,012, lane strides off a 16-byte boundary; random
   scale words reach mode 2 predictors 4-7 and mode 4's 1 << 31 scale),
   lane counts that leave B7's last CTA ragged, one block, one chunk plus
   3 and 25 blocks of the bank's geometry; random PCM with zero blocks for
   modes 2/3/4, bit depths 2/4/5/8/11/12 (odd spb 25, spb 1 and 1,012
   among them), scale_fix off and on; loud rails at bit depth 2 (the u16 wrap, the 0x1000 cap); lane
   counts that leave B8's last CTA ragged; one block, and one chunk plus 3;
   B7's host instance (the JAX host decoders' int64 arithmetic, wrap=False)
   against its twin: random mode 4 blocks at bit depths 2/4/8/11/15 with a
   quarter of the scale words 13 mod 32 (scale 2^31), modes 2/3 at bit
   depth 15, the ragged lane counts, one block and one chunk plus 3, and a
   block on which the two instances give the two answers;
7. `adx_decode_batch` of 256 copies of the 10 s stereo bank stream (4-bit,
   block 0x12, mode 3, version 4; B7's host instance, the default) and of
   the 1 s fixtures (also with wrap=True, the wrap instance), and
   `adx_encode_batch` of 256 copies of the bank's 10 s WAV (rebuilt by
   pycricodecs_tpu_torch/utils/signals.py, the fixtures' recipe, and held
   to its recorded hash) and of each 1 s case: every output's sha256 equal to the JAX
   package's; each path launched its kernel;
8. at the bank shape (512 lanes x 15,000 blocks), B7 (both instances) and
   B8 against their twins on the first 300 blocks of every lane (the twins
   timed once there, CUDA events), the kernels timed at the full shape by
   CUDA events, and each bank call timed (median of 3).

HCA encode (tests/data/torch_port/, input WAVs rebuilt by signals.hca_wav
and held to their recorded hashes):
9. B6 `hca_mdct` against `mdct_plain`, bit for bit (f32 as i32): random
   PCM16 with both rails and silent blocks (T = 1, a ragged last warp,
   T = 33 tiles that cross a stream channel among them), and the bank's
   PCM (256 x 2 x 3,752 blocks);
   B6's library yardstick timed (the cast, a pad and one `torch.matmul` by
   the folded 256 x 128 matrix over an unfold view, TF32 off);
10. the packer `hca_pack` (B9's work) against `pack_frames_plain`, byte for
   byte: the bank's encode tensors; per 1 s fixture config rate-controlled
   tensors of noise and random tensors in the legal ranges (most overflow
   the writer); 525 random frames (a ragged last CTA) at frame sizes 515 and
   256; a frame whose last symbol ends inside the CRC slot;
11. `hca_encode_batch` of 256 copies of the 10 s stereo WAV, quality 2:
   every stream equal to bank_q2_stereo_48k_10s.hca, the bank decoded back
   to the JAX package's WAV hash; each 1 s fixture equal to its .hca;
   BASELINE config 4's round trip (`crypt` with cipher 56, decode on the
   card with the key, decrypt back); both kernels launched; the bank call
   timed (median of 3 after a warm-up).

v3 PNS noise fill (tests/data/torch_port/pns_v3_mono_48k_1s.hca, a v3.0
relabel with min_resolution 0):
12. B3 with noise maps against its twin: random legal maps for the PNS
   fixture's config and the q4 stereo config (HFR takes the noise-filled
   band as its source) at 64 streams x 469 frames, and the fixture's real
   maps (`noise_maps` on the card equal to the same code on the CPU);
   `decode_batch` of 64 copies of the fixture, every WAV equal to its
   recorded sha256; B1-B3 launched; B3 timed with noise.

AHX (tests/data/torch_port/ahx/, hashes from the JAX package's host lane):
13. B10 `mp2_unpack` against `mp2_unpack_plain`, byte for byte with the error
   flags: the bank's frames (256 x 192), 4,096 random-byte frames behind
   valid headers for each unpacker configuration (LSF mono 16/22.05/24 kHz,
   MPEG-1 stereo and joint stereo with random bounds, CRC on), 4,096 +
   13 frames (a ragged last CTA) in rows of 515 bytes, frames whose size
   ends inside their scalefactors or their samples, rows shorter than
   their frame, the varying-bound stream; `mp2_synth` against
   `synthesize_plain`, bit for
   bit, at the bank shape and on random codes in their legal ranges (C = 1
   and 2, row counts off its 64-row tile and 9-tile segment); its library
   yardstick (one f64 `torch.matmul`, one depthwise f64 `conv1d`, one add,
   within 1 LSB of the kernel) timed;
   `ahx_decode_batch` of 256 copies of the 10 s bank stream and of the 1 s
   fixtures, every WAV equal to its recorded sha256; both kernels launched;
   the bank call timed (median of 3 after a warm-up); kernels and twins
   timed by CUDA events.

Key search and zero coded_count (tests/data/torch_port/keysearch/, hashes
from the JAX package):
14. B4 `hca_imdct_ola` and B5 `hca_imdct` against their twins
   (`imdct_ola_plain`, `imdct_butterflies`; equal f32 values, +0.0 == -0.0)
   on the bank chunk's real spectra (128 rows x 3,752 subframes) and on
   random spectra with extremes; B2's end cursor (and its cursor-only mode)
   against the twin's on the bank chunk and on the key search's rows under
   4,096 wrong keys; B2's cursor-only launch at phase 1's shape (400,000
   key rows, its end cursor equal to the spectra launch's) timed by CUDA
   events; `find_key` at full width (bench_all config 6's
   traffic: the bank stream enciphered by `crypt`, cipher 56, 200,000
   seeded candidates with the true key at index 100,000, 8 frames), the
   scores' sha256 equal to the JAX package's and the true key first, B1, B2
   and B4 launched, timed (median of 3 after a warm-up, keys/s) with the
   stage split; 16 copies of the zero-coded_count stream through
   `decode_batch`, every WAV equal to its recorded sha256; B4 and B5 timed
   at the chunk shape, with B5's yardstick, one `torch.matmul` by the
   128 x 128 DCT-IV matrix, and B4's, a pad and one `torch.matmul` by the
   folded 256 x 128 matrix over an unfold view, TF32 off. B5 has no main
   path (the JAX
   package runs it only in its tests), so its launch count is 0.

Banks, single-file surfaces, CLI (tests/data/torch_port/bank/, hashes from
the JAX package):
15. `decode_acb` of bank.acb with its sibling bank.awb, written to a
   temporary directory by the port's `build_afs2` from 256 copies of the
   10 s bank stream (BASELINE config 5 at its defined size; the AWB held to
   the JAX `build_afs2`'s hash): every WAV equal to the bank hash, B1-B3
   launched, timed (median of 3 after a warm-up) with the ACB + AWB parse
   and member read timed alone as the host layer; `decode_acb` of
   mixed.acb (HCA, ADX that only the non-strict check accepts, a mode 4
   ADX with scale words 13 mod 32, a truncated ADX, AHX, a corrupt AHX, a
   bad ADX header, a non-audio member; with and without the non-HCA
   decode) and `decode_awb` of subkey.awb (cipher 56 under a bank subkey),
   every output equal to its recorded hash, B1-B3, B7's host instance, B10
   and `mp2_synth` launched; `models.adx.decode` / `encode`, `HCA.decode`
   / `encode` and `AHX.decode` on the 1 s fixtures; the CLI in-process
   (`bank-decode` of mixed.acb, `decode` of an HCA fixture), the files'
   sha256 held to the JAX package's.

AHX / MPEG Layer II encode (tests/data/torch_port/ahx/, hashes from the JAX
package's f64 host lane, the input PCM rebuilt by utils/signals.py):
16. K1 `mp2_analysis` (S, part peaks, frame peaks) against
   `analyze_plain`, `part_peaks_plain` and `frame_peaks_plain` (f64 bit for
   bit), K2 `mp2_allocate` (one pass, from the part peaks) against
   `allocate_plain`, K3 `mp2_pack` against `pack_plain`, byte for byte:
   random tones, noise and level jumps (a silent tail, a full-scale square
   wave) for 12 configurations (every allocation table, mono, stereo,
   joint bounds 4-16, odd frame counts that end in half of K1's 72-row
   tile, one frame) and the bank's PCM (256 x 192 frames); K3 alone
   against `pack_plain` on random legal K2 outputs K2 never produces (a
   copy of the CPU tests' generator): stereo 32 kHz 384 kbps (1,728-byte
   frames), joint bound 4, more frames than the persistent grid has warps
   and a multiple of no grid of 1-6 CTAs an SM, one frame, and fields
   past the frame end; each call into memory filled with 0xA5 (a freed
   poisoned tensor for the wrapper's torch.empty, and the C entry into a
   0xA5-filled output), so that every byte must be written; K3 from two
   host threads that take turns, one with the larger frames and one with
   the smaller of a channel count (1,728 and 627 bytes, 864 and 288), so
   that no thread's launch lowers the kernel's shared-memory limit under
   the other's; how many of
   the bank's peaks and of
   1,000,000 log-uniform values torch.log10 on the card gives otherwise
   than np.log10 on the host (need_db is numpy's on the host);
   `ahx_encode_batch` of 256 copies of the bank's 10 s WAV at 96 kbps
   (bench_all config 15), every AHX equal to the bank fixture's hash, K1-K3
   launched; each 1 s fixture through `encode_mp2` / `AHX.encode`, and the
   CLI's `encode --format ahx` in a subprocess, held to their hashes; the
   bank call timed (median of 3 after a warm-up) with its stage split; the
   kernels timed at the bank shape (CUDA events), the twins once, K1's
   library yardstick (the fold in torch and one f64 `torch.matmul`, within
   1e-12 of the kernel), and K2's ablation by its inputs: class levels
   zeroed (the loop runs as it does, nothing to quantise) and budgets
   zeroed (no step allocates).

The remaining single-device surfaces (tests/data/torch_port/surfaces/,
values from the JAX package):
17. (a) `models.hca.decode_range` of the 10 s bank stream over (0, -1),
   (100, 300), (468, -1) and (5, 5), and of the key search's enciphered
   stream under its key, and `decode_frames_to_pcm` of the v3 PNS fixture
   at random_state 1 and 0x1234: sha256 equal to the JAX package's and to
   the same call with device="cpu", B1-B3 launched, the full stream timed
   (median of 3 after a warm-up); (b) `ops.hca_frame.test_block_state`
   threaded over all 469 frames of the enciphered stream under its key and
   three wrong keys, one call a frame, and `score_frames` of them: the
   (score, state) pairs equal to the JAX package's, B1, B2 (and B4 under
   the key) launched, ms a frame (median of 3); (c) `models.ahx.
   decode_mp2` of the AHX bank stream and the joint-stereo fixture, B10
   and `mp2_synth` launched; (d) `ACBBuilder` of 256 copies of the bank
   stream (bank.acb and its awb_blob, timed), mixed.acb rebuilt from its
   members, `AWBBuilder` in list mode over the HCA fixtures: bytes equal
   to the JAX package's; (e) the port's graft entry
   (`__graft_entry_torch__.entry`): its fn's pcm equal to the JAX entry's,
   err all false, B1-B3 launched.

The sharded paths and the CriCodecs module:
18. every sharded entry point (`decode_batch` of 191 copies of the 10 s
   bank stream, one enciphered copy under the test key and 63 copies of
   the v3 PNS fixture; `decode_awb` of subkey.awb; `decode_acb` of
   mixed.acb; `adx_decode_batch` of the ADX bank stream and, with
   wrap=True, of three 1 s fixtures; `adx_encode_batch`,
   `ahx_decode_batch`, `hca_encode_batch` and `ahx_encode_batch` of the
   banks' inputs; 255 streams a bank, an odd count) over `make_mesh()`
   (every visible card) and over cuda:0 four times as (2, 2) and (1, 4):
   every output equal to the unsharded call's, each path's kernels
   launched, the medians of 3 beside the unsharded one's;
   `dryrun_multichip(4, devices=[cuda:0] * 4)`; the seven `cricodecs`
   functions against the port calls they map to; K3 through its wrapper
   with and without the launch device guard (turns: guarded, bare, bare,
   guarded) and the guard's host time.

CPK, USM and IVF, and CRILAYLA's kernels (tests/data/torch_port/containers/,
hashes from the JAX package):
19. (a) a 60 s, 30 fps cutscene (signals.movie_frames: 1,800 frames, a
   48 KB keyframe every 30 frames, ~24 MB) built into an IVF, and
   `USMBuilder` of it with two 60 s stereo 48 kHz tracks as enciphered HCA
   (B6, hca_pack) with two subtitle languages, and with one track as masked
   ADX (B8), under a key below 2^56; `USM.extract(decode=True)` of each
   (B1-B3; B7's host instance): the IVF, the tracks, both USMs and every
   extracted file (.ivf, .wav, .srt) held to the JAX package's sha256,
   builds and extracts timed (median of 3); `USM._decode_audio` of the 10 s
   AHX bank stream (B10, mp2_synth); (b) `CPKBuilder` in modes 0-3 over
   bank.acb with its 256-track bank.awb, mixed.acb, subkey.awb and both
   USMs (118 MB), each archive and each extracted tree held to the JAX
   package's (modes 0 and 1 also to the sources), timed; `decode_acb` of
   the extracted bank.acb to the bank's WAV hash (archive -> bank -> WAV,
   timed); (c) `CPKBuilder(compress=True, encrypt=True)` over bank.acb,
   mixed.acb, the 1 s ADX and HCA fixtures, the 10 s ADX stream and four
   10 s WAVs: C2 `crilayla_compress` once for all 22 members, the archive
   equal to the JAX package's (its native compress); `CPK.extract`: C1
   `crilayla_decompress` once, every member equal to its source; C1 and C2
   against `_decompress_py` / `_compress_py` (the compressed 1 s fixtures
   and a malformed stream; payloads of 257 B - 8.7 KB at the matcher's
   edges, and two it refuses); a 1 MiB run of one byte and a 1 MiB
   period-3 pattern (matches past 2^19 bytes: C2's 64-bit keys) through C2
   to the JAX native's blob hashes and back through C1; C1 and C2 timed at
   the archive's shape (CUDA events) with their stage splits (C2: search,
   walk, emit; C1: parse, materialise), their plain versions once.

Prints one compact JSON line of every bank call's and phases 17-19's timings
(`banks`), then a JSON line of per-kernel results (launches on the main paths, max
|kernel - twin|, kernel/twin ms, the bound from the bytes and operations of
the timed call, and for B7 (each instance), B8, C1 and C2 from their
dependent chain at the card's maximum SM clock; the library calls of B4, B5, B6,
`mp2_synth` and K1), the card line, and last a JSON line
{"ok": true, "device": {...}}. Any failure raises and exits non-zero; there
is no CPU path.

Run from the repository root: python3 chip_smoke.py
"""
import hashlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(ROOT, "tests", "data", "torch_port")
ADX_FIXTURES = os.path.join(FIXTURES, "adx")
AHX_FIXTURES = os.path.join(FIXTURES, "ahx")
BANK = "bank_q2_stereo_48k_10s"
BANK_STREAMS = 256
RANDOM_FRAMES = 4096
# B2's and hca_pack's extra checks: a frame size that is not a multiple of
# 16 (nor of 4), and a frame count past whole CTAs
ODD_FRAME_SIZE = 515
RAGGED = 13
# B1's frames shorter than the bits their side info can take, (frame size,
# version) of a q4 stereo relabel
SMALL_FRAME_SIZES = ((128, 0x0200), (131, 0x0300))
# B1 and B2's cursor-only launch are timed at the key search's phase-1 shape
KEY_ROWS = 400_000
ADX_RANDOM_LANES = 64
ADX_RANDOM_BLOCKS = 24
ADX_PREFIX_BLOCKS = 300

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
    "adx_decode": dict(
        source="pycricodecs_tpu_torch/csrc/adx_codec.cu",
        replaces="pycricodecs_tpu/ops/adx_kernels.py:194"),
    # B7's second instance: the JAX host decoders' arithmetic (the default
    # of adx_decode_batch, the single-file decode and the bank decode)
    "adx_decode_host": dict(
        source="pycricodecs_tpu_torch/csrc/adx_codec.cu",
        replaces="pycricodecs_tpu/ops/adx_kernels.py:194"),
    "adx_encode": dict(
        source="pycricodecs_tpu_torch/csrc/adx_codec.cu",
        replaces="pycricodecs_tpu/ops/adx_kernels.py:1124"),
    "hca_mdct": dict(
        source="pycricodecs_tpu_torch/csrc/hca_encode.cu",
        replaces="pycricodecs_tpu/ops/pallas_kernels.py:656"),
    "hca_pack": dict(
        source="pycricodecs_tpu_torch/csrc/hca_pack.cu",
        replaces="pycricodecs_tpu/ops/hca_pack_device.py:207"),
    # B3 again, launched with the v3 PNS noise maps (the PNS path)
    "hca_transform_pns": dict(
        source="pycricodecs_tpu_torch/csrc/hca_transform.cu",
        replaces="pycricodecs_tpu/ops/pallas_kernels.py:448"),
    "mp2_unpack": dict(
        source="pycricodecs_tpu_torch/csrc/mp2_unpack.cu",
        replaces="pycricodecs_tpu/ops/mp2_unpack_device.py:79"),
    # no Pallas kernel: the JAX device program's f32 XLA matmuls
    "mp2_synth": dict(
        source="pycricodecs_tpu_torch/csrc/mp2_synth.cu",
        replaces="pycricodecs_tpu/ops/mp2_kernels.py:179"),
    "hca_imdct_ola": dict(
        source="pycricodecs_tpu_torch/csrc/hca_imdct.cu",
        replaces="pycricodecs_tpu/ops/pallas_kernels.py:236"),
    # test-only in the JAX package: no main path launches it
    "hca_imdct": dict(
        source="pycricodecs_tpu_torch/csrc/hca_imdct.cu",
        replaces="pycricodecs_tpu/ops/pallas_kernels.py:130"),
    # the AHX encode: no Pallas kernel; the JAX package's f64 numpy host lane
    "mp2_analysis": dict(
        source="pycricodecs_tpu_torch/csrc/mp2_analysis.cu",
        replaces="pycricodecs_tpu/ops/mp2_kernels.py:102"),
    "mp2_allocate": dict(
        source="pycricodecs_tpu_torch/csrc/mp2_encode.cu",
        replaces="pycricodecs_tpu/models/ahx.py:170"),
    "mp2_pack": dict(
        source="pycricodecs_tpu_torch/csrc/mp2_encode.cu",
        replaces="pycricodecs_tpu/ops/mp2_frame.py:367"),
    # CRILAYLA: no Pallas kernel; the JAX package's native host lane
    "crilayla_decompress": dict(
        source="pycricodecs_tpu_torch/csrc/crilayla.cu",
        replaces="pycricodecs_tpu/native/cricore.cpp:130"),
    "crilayla_compress": dict(
        source="pycricodecs_tpu_torch/csrc/crilayla.cu",
        replaces="pycricodecs_tpu/native/cricore.cpp:174"),
}

# H100 SXM rates (NVIDIA data sheet and Hopper white paper: 132 SMs, 3.35
# TB/s of HBM, 1,980 MHz boost). The port builds with -fmad=false, so every
# f32 multiply or add is its own FMUL or FADD: 128 f32 lanes an SM give
# 132 x 128 x 1.98e9 = 33.45e12 instructions/s (the 67 TFLOP/s of the data
# sheet count an FMA as 2). INT32 issues on 64 lanes an SM: 16.7e12/s, the
# rate of the integer kernels (B1, B2, the packer, B10, B7, B8). Float64
# outside the tensor cores: 64 lanes an SM, each DMUL or DADD one op at
# 17e12/s (the data sheet's 34 TFLOP/s count a DFMA as 2).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 33.45e12
INT32_OPS_PER_S = 16.7e12
FP64_OPS_PER_S = 17e12
# Operations counted per unit of work, as lower bounds (each counts only the
# arithmetic the function cannot skip):
# - B1: one per side-info value written; B2: three per spectral code (peek,
#   table lookup, cursor advance);
# - B3: dequantise 2, DCT-IV 28 (7 add/sub stages of 1 and 7 twiddle stages
#   of 2 mul + 1 add per value: 3,584 a 128-value row), window + overlap-add
#   3, PCM conversion 2, per output value: 35;
# - B7: code extraction 4 (shift, mask, sign test, subtract) + recurrence 9
#   (3 mul, 2 shift, 2 add, 2 clamp) per sample;
# - B8: pass 1 residual 6 + pass 2 14 (3 mul, 2 shift, 3 add, rounding add,
#   divide, 2 clamps, sim product and shift counted once) per sample;
# - B6 (hca_mdct): input scale 1, fold 3 (2 mul + 1 sub), DCT-IV
#   pre-rotation 3 and six butterfly stages of 2.5 (10 ops per 4 values),
#   the final scale 1, per output value;
# - hca_pack: three per spectrum code written, i.e. per coded band and
#   subframe whose resolution is 1-15 (table lookup, shift-or into the bit
#   accumulator, cursor add);
# - B3 with PNS: B3's 35 plus the noise term's multiply and add;
# - B10 (mp2_unpack): three per sample code written (field extract, cursor
#   add, store), i.e. per allocated (frame, channel, subband) x 36;
# - mp2_synth, f64 operations per output sample: dequantise 5 (mul, add,
#   sub, div, mul), matrixing 126 (64 outputs x 32 mul + 31 add per 32
#   samples), window 31 (16 mul + 15 add), PCM 2 (mul, add);
# - B4 (hca_imdct_ola): the DCT-IV's 28 and window + overlap-add 3 per
#   output value; B5 (hca_imdct): the DCT-IV's 28;
# - K1 (mp2_analysis), f64 operations per input sample: window fold 32
#   (64 outputs x 8 mul + 8 add per 32 samples) and matrixing 127 (32
#   outputs x 64 mul + 63 add per 32 samples): 159 (the peaks' compares
#   uncounted); its bytes: the PCM in, S and both peak tensors out;
# - K2 (mp2_allocate), f64 operations per quantised code (a code of an
#   allocated (frame, channel, subband), x 36): divide, multiply, add,
#   subtract, divide, add, floor = 7 (the greedy steps' compares uncounted);
#   its bytes: S and the part peaks, need_db and budgets in once, the four
#   outputs;
# - K3 (mp2_pack): three per quantised code written (field value, shift,
#   shared-memory OR);
# - C1 (crilayla_decompress): one per output byte (its store); C2
#   (crilayla_compress): one per input byte (each is read and compared at
#   least once). Neither has a chain term: C1's token parse and C2's
#   greedy walk run speculatively in parallel pieces (chunks, tiles) that
#   the true parse joins, so no serial chain of the function's length is
#   one that every design must run.
OPS = {"hca_side_info": 1, "hca_coefficients": 3, "hca_transform": 35,
       "adx_decode": 13, "adx_decode_host": 13, "adx_encode": 20, "hca_mdct": 23, "hca_pack": 3,
       "hca_transform_pns": 37, "mp2_unpack": 3, "mp2_synth": 164,
       "hca_imdct_ola": 31, "hca_imdct": 28, "mp2_analysis": 159,
       "mp2_allocate": 7, "mp2_pack": 3, "crilayla_decompress": 1,
       "crilayla_compress": 1}
OPS_PER_S = {"mp2_synth": FP64_OPS_PER_S, "mp2_analysis": FP64_OPS_PER_S,
             "mp2_allocate": FP64_OPS_PER_S, "mp2_pack": INT32_OPS_PER_S,
             **dict.fromkeys(("hca_side_info", "hca_coefficients",
                              "hca_pack", "mp2_unpack", "adx_decode",
                              "adx_decode_host", "adx_encode",
                              "crilayla_decompress", "crilayla_compress"),
                            INT32_OPS_PER_S)}
# Dependent operations on the critical path of one step of a serial
# recurrence (the third bound term, `chain`: steps per lane x these ops x
# CHAIN_CYCLES_PER_OP / the card's maximum SM clock). Assumption: every
# integer op on the path (IMAD, IMAD.HI, IADD3, SHF, IMNMX, SEL) has a
# latency of 4 cycles to a dependent instruction on Hopper.
# - B7: multiply a0 * p1, shift, the three-way add, two clamps = 5;
# - B8 as the kernel orders it: the prediction's multiply-add (x - c1 * q2
#   formed a step early), shift, the dividend's clamp (min and max side by
#   side), the rounding add, the select, the division's mask (r & add),
#   multiply-high, shift and sign fix, the simulated decoder's multiply-add,
#   shift and two clamps = 13 (14 in adx_encode_plain's order).
CHAIN_OPS = {"adx_decode": 5, "adx_decode_host": 5, "adx_encode": 13}
CHAIN_CYCLES_PER_OP = 4


#: the median seconds of every bank call and of phase 17's timed calls,
#: printed as one compact line before the kernels line, so that a reader of
#: only the tail of the output still sees them
BANKS: dict = {}


def log(*args) -> None:
    print(*args, flush=True)


_SM_CLOCK_MHZ = []


def max_sm_clock_mhz() -> float:
    """The card's maximum SM clock (nvidia-smi clocks.max.sm), read once."""
    if not _SM_CLOCK_MHZ:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, check=True, timeout=60).stdout
        _SM_CLOCK_MHZ.append(float(out.strip().splitlines()[0]))
    return _SM_CLOCK_MHZ[0]


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


def side_info_equal(what: str, up, dec) -> int:
    """B1 against its twin: err on every row, sf, res, inten and cur on the
    rows without err; returns max |diff|."""
    k, t = up.side_info(dec), up.side_info_plain(dec)
    worst = require_equal(what, [("err", k[4], t[4])])
    ok = ~t[4]
    return max(worst, require_equal(what, [
        (n, a[ok], b[ok]) for n, a, b in zip(("sf", "res", "inten", "cur"),
                                             k[:4], t[:4])]))


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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def side_info_bytes(up, side) -> int:
    """The bytes B1 must move: the part of each row of dec its side info
    can reach (`side_info_reach`), and its five outputs."""
    return side[3].shape[0] * up.side_info_reach + nbytes(*side)


def bound(name: str, moved_bytes: int, units: int,
          chain_steps: int = 0) -> dict:
    """The least time of a kernel's work: moved bytes over HBM bandwidth,
    its counted operations over their type's issue rate, or, for a serial
    recurrence (CHAIN_OPS), its steps per lane times the critical path's
    latency, whichever is largest."""
    terms = {"bytes": moved_bytes / HBM_BYTES_PER_S * 1e3,
             "operations": (OPS[name] * units
                            / OPS_PER_S.get(name, F32_OPS_PER_S) * 1e3)}
    if name in CHAIN_OPS:
        terms["chain"] = (chain_steps * CHAIN_OPS[name] * CHAIN_CYCLES_PER_OP
                          / (max_sm_clock_mhz() * 1e6) * 1e3)
    by = max(terms, key=terms.get)
    return dict(bound_ms=terms[by], bound_by=by)


def cuda_ms_once(fn):
    """(result, milliseconds) of one fn() on the card (CUDA events)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def random_lanes(rng, L, dev):
    """History in int16 range and highpass-derived coefficients, i32 [L]."""
    from pycricodecs_tpu_torch.models import adx as adx_model
    coef = np.array([adx_model.calculate_coefficients(int(hp), int(sr))
                     for hp, sr in zip(rng.integers(0, 0x10000, L),
                                       rng.integers(8000, 96001, L))],
                    dtype=np.int32).reshape(L, 2)
    hist = rng.integers(-32768, 32768, (2, L)).astype(np.int32)
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (hist[0], hist[1], coef[:, 0], coef[:, 1])]


# (bit depth, block size) of the random decode checks, each in modes 2/3/4:
# bit depths 2/4/5/8/11/12/15, spb 64, 32, 25 (odd), 16, 1, 8, 10, 8, 1,012
# and 16 (block 12); 24 blocks of block 13, 3 or 255 leave every lane's
# bytes off a 16-byte boundary
DECODE_GEOMETRIES = [(2, 0x12), (4, 0x12), (5, 0x12), (8, 0x12), (8, 3),
                     (11, 13), (12, 0x12), (15, 0x12), (2, 255), (5, 12)]


def decode_pair(dev, rng, what, L, nb, bd, bs, mode, wrap=True,
                words13=False) -> int:
    """B7 (its wrap or its host instance) against its twin on random block
    bytes; mode 2 draws predictors 4-7 and mode 4 scale words 13 mod 32
    (1 << 31, which wraps); words13: about a quarter of the scale words are
    13 mod 32 and the rest are drawn from 0..63 (scales 2^12 down to 2^13
    and 2^31 ... 2^13 again, the products that leave int32)."""
    from pycricodecs_tpu_torch.ops import adx_kernels as A
    from pycricodecs_tpu_torch.ops import cuda_kernels
    raw = rng.integers(0, 256, (L, nb, bs), dtype=np.uint8)
    if words13:
        w = np.where(rng.random((L, nb)) < 0.25,
                     13 + 32 * rng.integers(0, 2048, (L, nb)),
                     rng.integers(0, 64, (L, nb)))
        raw[..., 0], raw[..., 1] = w >> 8, w & 0xFF
    raw[0, 0, :2] = (0x00, 0x0D)    # mode 4: 1 << 31 (wraps)
    raw[-1, -1, :2] = (0xE0, 0x10)  # mode 2: predictor 7
    words = (raw[..., 0].astype(np.int32) << 8) | raw[..., 1]
    if mode == 2 and not (words >> 13 >= 4).any():
        raise AssertionError("no mode 2 predictor 4-7 drawn")
    if mode == 4 and not ((words & 31) == 13).any():
        raise AssertionError("no mode 4 1 << 31 scale drawn")
    h1, h2, c0, c1 = random_lanes(rng, L, dev)
    payload = torch.from_numpy(raw).to(dev)
    kw = dict(bit_depth=bd, encoding_mode=mode, wrap=wrap)
    got = cuda_kernels.adx_decode(payload, h1, h2, c0, c1, **kw)
    want = A.adx_decode_plain(payload, h1, h2, c0, c1, **kw)
    return require_equal(what, [("pcm", got, want)])


def adx_random_decode_checks(dev) -> int:
    """B7 against its twin on random block bytes: every geometry x mode,
    lane counts that leave the last CTA ragged, one block and one chunk
    plus 3 blocks, and a lane stride off a 16-byte boundary at the bank's
    geometry."""
    from pycricodecs_tpu_torch.models.adx import samples_per_block
    from pycricodecs_tpu_torch.ops import cuda_kernels
    rng = np.random.default_rng(7)
    worst = 0
    L = ADX_RANDOM_LANES
    for bd, bs in DECODE_GEOMETRIES:
        spb = samples_per_block(bs, bd)
        nb = max(4, min(ADX_RANDOM_BLOCKS, 4096 // spb))
        G, K, smem = cuda_kernels.adx_decode_plan(L, nb, block_size=bs,
                                                  bit_depth=bd)
        for mode in (2, 3, 4):
            worst = max(worst, decode_pair(
                dev, rng, f"B7 random bd {bd} bs {bs} mode {mode}", L, nb,
                bd, bs, mode))
        log(f"B7 random bd {bd} block {bs} (spb {spb}; G {G}, K {K}, {smem} "
            f"shared bytes): {L} lanes x {nb} blocks ({nb * bs % 16} bytes "
            f"past a 16-byte lane stride), modes 2/3/4 byte-equal to the "
            f"twin")
    # lane counts against the CTA width G (ragged last CTAs)
    nb = ADX_RANDOM_BLOCKS
    ragged = []
    for lanes in ENCODE_LANE_COUNTS:
        G, K, smem = cuda_kernels.adx_decode_plan(lanes, nb, block_size=0x12,
                                                  bit_depth=4)
        ragged.append(lanes % G != 0)
        worst = max(worst, decode_pair(dev, rng, f"B7 {lanes} lanes", lanes,
                                       nb, 4, 0x12, 3))
        log(f"B7 {lanes} lanes (G {G}, K {K}, {smem} shared bytes) x {nb} "
            f"blocks: byte-equal to the twin")
    if not any(ragged):
        raise AssertionError("no lane count left the last CTA ragged")
    # one block, one chunk plus 3 (the last chunk short), and 25 blocks of
    # the bank's geometry (a 450-byte lane stride)
    for bd, bs in ((4, 0x12), (5, 0x12)):
        K = cuda_kernels.adx_decode_plan(L, 4096, block_size=bs,
                                         bit_depth=bd)[1]
        if cuda_kernels.adx_decode_plan(L, K + 3, block_size=bs,
                                        bit_depth=bd)[1] != K:
            raise AssertionError(f"bd {bd}: K + 3 blocks change K")
        for nb in (1, K + 3, 25):
            for mode in (2, 3, 4):
                worst = max(worst, decode_pair(
                    dev, rng, f"B7 bd {bd} {nb} blocks mode {mode}", L, nb,
                    bd, bs, mode))
            log(f"B7 bd {bd} block {bs} (K {K}): {L} lanes x {nb} blocks, "
                f"modes 2/3/4 byte-equal to the twin")
    return worst


# (bit depth, block size) of B7's host-instance checks in mode 4: bit depths
# 2, 4, 8, 11 and 15 (spb 64, 32, 16, 8 and 8)
HOST_GEOMETRIES = [(2, 0x12), (4, 0x12), (8, 0x12), (11, 13), (15, 0x12)]


def adx_host_decode_checks(dev) -> int:
    """B7's host instance against its twin (wrap=False) on random blocks
    in mode 4, a quarter of the scale words 13 mod 32 (scale 2^31), at bit
    depths 2/4/8/11/15; modes 2 and 3 at bit depth 15; the lane counts of
    the wrap instance's checks (ragged last CTAs), one block and one chunk
    plus 3. Fails unless the host and wrap instances differ somewhere."""
    from pycricodecs_tpu_torch.models.adx import samples_per_block
    from pycricodecs_tpu_torch.ops import adx_kernels as A
    from pycricodecs_tpu_torch.ops import cuda_kernels
    rng = np.random.default_rng(13)
    worst = 0
    L = ADX_RANDOM_LANES
    for bd, bs in HOST_GEOMETRIES:
        spb = samples_per_block(bs, bd)
        nb = max(4, min(ADX_RANDOM_BLOCKS, 4096 // spb))
        worst = max(worst, decode_pair(
            dev, rng, f"B7 host bd {bd} bs {bs}", L, nb, bd, bs, 4,
            wrap=False, words13=True))
        log(f"B7 host instance, mode 4 bd {bd} block {bs} (spb {spb}): {L} "
            f"lanes x {nb} blocks, a quarter of the scale words 13 mod 32: "
            f"byte-equal to the twin")
    for mode in (2, 3):
        worst = max(worst, decode_pair(
            dev, rng, f"B7 host mode {mode} bd 15", L, ADX_RANDOM_BLOCKS, 15,
            0x12, mode, wrap=False))
    log(f"B7 host instance, modes 2/3 bd 15: byte-equal to the twin")
    nb = ADX_RANDOM_BLOCKS
    for lanes in ENCODE_LANE_COUNTS:
        worst = max(worst, decode_pair(
            dev, rng, f"B7 host {lanes} lanes", lanes, nb, 15, 0x12, 4,
            wrap=False, words13=True))
    log(f"B7 host instance at {ENCODE_LANE_COUNTS} lanes x {nb} blocks "
        f"(bd 15, mode 4): byte-equal to the twin")
    K = cuda_kernels.adx_decode_plan(L, 4096, block_size=0x12,
                                     bit_depth=4)[1]
    for nb in (1, K + 3):
        worst = max(worst, decode_pair(
            dev, rng, f"B7 host {nb} blocks", L, nb, 4, 0x12, 4, wrap=False,
            words13=True))
    log(f"B7 host instance at 1 and K + 3 = {K + 3} blocks: byte-equal to "
        f"the twin")
    # the two instances differ on such blocks (the checks reach the case)
    raw = np.zeros((1, 2, 0x12), np.uint8)
    raw[0, :, 1] = 13
    raw[0, :, 2:] = 0x17
    lane = torch.zeros(1, dtype=torch.int32, device=dev)
    payload = torch.from_numpy(raw).to(dev)
    outs = [cuda_kernels.adx_decode(payload, lane, lane, lane, lane,
                                    bit_depth=4, encoding_mode=4, wrap=w)
            for w in (True, False)]
    want = A.adx_decode_plain(payload, lane, lane, lane, lane, bit_depth=4,
                              encoding_mode=4, wrap=False)
    if not torch.equal(outs[1], want) or int(outs[1].max()) != 32767 \
            or int(outs[0].min()) != -32768:
        raise AssertionError("B7's host and wrap instances do not give the "
                             "host and wrap answers on scale word 13")
    return worst


# (bit depth, block size) of the random encode checks, each in modes 2/3/4
# with scale_fix off and on: bd 12 at 0x12 leaves the last block byte
# unfilled (10 codes in 15 of 16 bytes); bd 5 at 0x12 has an odd spb (25),
# so no lane starts 16-byte aligned; bd 8 at 3 is spb 1; bd 2 at 255 the
# largest spb (1,012); bd 4 at 13 (spb 22) ends each block's groups of 8
# in a tail of 6
ENCODE_GEOMETRIES = [(2, 0x12), (4, 0x12), (4, 13), (5, 12), (5, 0x12),
                     (8, 0x12), (8, 3), (11, 13), (12, 0x12), (2, 255)]
# lane counts of the edge checks: one lane, lanes that fill no CTA and
# lane counts whose last CTA is ragged on a 132-SM card (133 -> 2 lanes per
# CTA, 601 -> 5)
ENCODE_LANE_COUNTS = (1, 3, 133, 600, 601)


def random_pcm(rng, L, nb, spb, loud=False) -> np.ndarray:
    """PCM16 lanes [L, nb, spb]: full-range noise, tones, and runs of zero
    blocks (zero-residual blocks once the history has settled at 0); loud:
    random rails (-32768 or 32767), residuals past 0xFFFF."""
    t = np.arange(nb * spb)
    pcm = np.empty((L, nb * spb), dtype=np.int64)
    for lane in range(L):
        kind = 0 if loud else lane % 4
        if loud:
            pcm[lane] = rng.choice(np.array([-32768, 32767]), nb * spb)
        elif kind == 0:
            pcm[lane] = rng.integers(-32768, 32768, nb * spb)
        else:
            f = rng.uniform(50, 8000) / 48000
            amp = (0.9, 0.3, 0.02)[kind - 1] * 32767
            pcm[lane] = (amp * np.sin(2 * np.pi * f * t)
                         + rng.normal(0, 30, nb * spb)).astype(np.int64)
    pcm = np.clip(pcm, -32768, 32767).reshape(L, nb, spb)
    pcm[:, :min(3, nb // 4)] = 0           # leading zero blocks (history 0)
    pcm[1::3, nb // 2:nb // 2 + 6] = 0     # zero runs mid-stream
    return pcm.astype(np.int16)


def encode_pair(dev, rng, what, pcm_np, bd, bs, mode, scale_fix,
                loud=False):
    """B8 and its twin on the same PCM and random lanes (zero history):
    (max |diff| (0), the twin's blocks). loud: the default coefficients
    (highpass 0x1F4 at 48 kHz) on every lane, and fail unless some residual
    against the original samples passes 0xFFFF."""
    from pycricodecs_tpu_torch.models import adx as adx_model
    from pycricodecs_tpu_torch.ops import adx_kernels as A
    from pycricodecs_tpu_torch.ops import cuda_kernels
    L = pcm_np.shape[0]
    pcm = torch.from_numpy(pcm_np).to(dev)
    _, _, c0, c1 = random_lanes(rng, L, dev)
    if loud:
        a, b = adx_model.calculate_coefficients(0x1F4, 48000)
        c0, c1 = torch.full_like(c0, a), torch.full_like(c1, b)
    h1 = torch.zeros(L, dtype=torch.int32, device=dev)
    h2 = h1.clone()
    if loud:
        x = pcm.to(torch.int32)
        r = ((x[:, :, 2:] << 12) - c0[:, None, None] * x[:, :, 1:-1]
             - c1[:, None, None] * x[:, :, :-2]) >> 12
        if int(r.abs().max()) <= 0xFFFF:
            raise AssertionError(f"{what}: no residual passes 0xFFFF")
    kw = dict(block_size=bs, bit_depth=bd, encoding_mode=mode,
              filter_=3 if mode == 2 else 0, scale_fix=scale_fix)
    got = cuda_kernels.adx_encode(pcm, c0, c1, h1, h2, **kw)
    want = A.adx_encode_blocks_plain(pcm, c0, c1, h1, h2, **kw)
    return require_equal(what, [("blocks", got, want)]), want


def adx_random_encode_checks(dev) -> int:
    """B8 against its twin + packer on random PCM: every geometry x mode x
    scale_fix, loud PCM at bit depth 2, lane counts that leave the last CTA
    ragged, one block and one chunk plus 3 blocks."""
    from pycricodecs_tpu_torch.models.adx import samples_per_block
    from pycricodecs_tpu_torch.ops import cuda_kernels
    rng = np.random.default_rng(8)
    worst = 0
    L = ADX_RANDOM_LANES
    for bd, bs in ENCODE_GEOMETRIES:
        spb = samples_per_block(bs, bd)
        nb = max(4, min(ADX_RANDOM_BLOCKS, 4096 // spb))
        for mode in (2, 3, 4):
            for scale_fix in (False, True):
                w, want = encode_pair(
                    dev, rng, f"B8 random bd {bd} bs {bs} mode {mode} fix "
                    f"{scale_fix}", random_pcm(rng, L, nb, spb), bd, bs, mode,
                    scale_fix)
                worst = max(worst, w)
                zero = (want == 0).all(-1)            # all-zero blocks
                if not bool(zero.any()) or bool(zero.all()):
                    raise AssertionError("random PCM without zero blocks")
            log(f"B8 random bd {bd} block {bs} (spb {spb}) mode {mode}: {L} "
                f"lanes x {nb} blocks, scale_fix off/on, {int(zero.sum())} "
                f"all-zero blocks: byte-equal to the twin")
    # loud rails at bit depth 2: the residual range passes 0xFFFF, so the
    # scale wraps (scale_fix off) and meets the 0x1000 cap
    nb = ADX_RANDOM_BLOCKS
    for mode in (2, 3, 4):
        worst = max(worst, encode_pair(
            dev, rng, f"B8 loud bd 2 mode {mode}",
            random_pcm(rng, L, nb, 64, loud=True), 2, 0x12, mode, False,
            loud=True)[0])
    log(f"B8 loud rails, bd 2 block 0x12 modes 2/3/4, scale_fix off: {L} "
        f"lanes x {nb} blocks byte-equal to the twin")
    # lane counts against the CTA width G (ragged last CTAs)
    ragged = []
    for lanes in ENCODE_LANE_COUNTS:
        G, K, smem = cuda_kernels.adx_encode_plan(lanes, nb, block_size=0x12,
                                                  bit_depth=4)
        ragged.append(lanes % G != 0)
        worst = max(worst, encode_pair(
            dev, rng, f"B8 {lanes} lanes", random_pcm(rng, lanes, nb, 32), 4,
            0x12, 3, False)[0])
        log(f"B8 {lanes} lanes (G {G}, K {K}, {smem} shared bytes) x {nb} "
            f"blocks: byte-equal to the twin")
    if not any(ragged):
        raise AssertionError("no lane count left the last CTA ragged")
    # one block, and one chunk plus 3 (the last chunk short), aligned and not
    for bd, bs in ((4, 0x12), (5, 0x12)):
        spb = samples_per_block(bs, bd)
        K = cuda_kernels.adx_encode_plan(L, 4096, block_size=bs,
                                         bit_depth=bd)[1]
        if cuda_kernels.adx_encode_plan(L, K + 3, block_size=bs,
                                        bit_depth=bd)[1] != K:
            raise AssertionError(f"bd {bd}: K + 3 blocks change K")
        for nb in (1, K + 3):
            for scale_fix in (False, True):
                worst = max(worst, encode_pair(
                    dev, rng, f"B8 bd {bd} {nb} blocks fix {scale_fix}",
                    random_pcm(rng, L, nb, spb), bd, bs, 3, scale_fix)[0])
            log(f"B8 bd {bd} block {bs} (K {K}): {L} lanes x {nb} blocks, "
                f"scale_fix off/on: byte-equal to the twin")
    return worst


def reset_launches() -> None:
    from pycricodecs_tpu_torch.ops import cuda_kernels
    from pycricodecs_tpu_torch.ops import hca_unpack_device as U
    U.SIDE_INFO_LAUNCHES = 0
    U.COEFF_LAUNCHES = 0
    cuda_kernels.TRANSFORM_LAUNCHES = 0
    cuda_kernels.ADX_DECODE_LAUNCHES = 0
    cuda_kernels.ADX_DECODE_HOST_LAUNCHES = 0
    cuda_kernels.ADX_ENCODE_LAUNCHES = 0
    cuda_kernels.MDCT_LAUNCHES = 0
    cuda_kernels.PACK_LAUNCHES = 0
    cuda_kernels.MP2_UNPACK_LAUNCHES = 0
    cuda_kernels.MP2_SYNTH_LAUNCHES = 0
    cuda_kernels.IMDCT_OLA_LAUNCHES = 0
    cuda_kernels.IMDCT_LAUNCHES = 0
    cuda_kernels.MP2_ANALYSIS_LAUNCHES = 0
    cuda_kernels.MP2_ALLOCATE_LAUNCHES = 0
    cuda_kernels.MP2_PACK_LAUNCHES = 0
    cuda_kernels.CRILAYLA_DECOMPRESS_LAUNCHES = 0
    cuda_kernels.CRILAYLA_COMPRESS_LAUNCHES = 0


def read_launches() -> dict:
    from pycricodecs_tpu_torch.ops import cuda_kernels
    from pycricodecs_tpu_torch.ops import hca_unpack_device as U
    return {"hca_side_info": U.SIDE_INFO_LAUNCHES,
            "hca_coefficients": U.COEFF_LAUNCHES,
            "hca_transform": cuda_kernels.TRANSFORM_LAUNCHES,
            "adx_decode": cuda_kernels.ADX_DECODE_LAUNCHES,
            "adx_decode_host": cuda_kernels.ADX_DECODE_HOST_LAUNCHES,
            "adx_encode": cuda_kernels.ADX_ENCODE_LAUNCHES,
            "hca_mdct": cuda_kernels.MDCT_LAUNCHES,
            "hca_pack": cuda_kernels.PACK_LAUNCHES,
            "mp2_unpack": cuda_kernels.MP2_UNPACK_LAUNCHES,
            "mp2_synth": cuda_kernels.MP2_SYNTH_LAUNCHES,
            "hca_imdct_ola": cuda_kernels.IMDCT_OLA_LAUNCHES,
            "hca_imdct": cuda_kernels.IMDCT_LAUNCHES,
            "mp2_analysis": cuda_kernels.MP2_ANALYSIS_LAUNCHES,
            "mp2_allocate": cuda_kernels.MP2_ALLOCATE_LAUNCHES,
            "mp2_pack": cuda_kernels.MP2_PACK_LAUNCHES,
            "crilayla_decompress": cuda_kernels.CRILAYLA_DECOMPRESS_LAUNCHES,
            "crilayla_compress": cuda_kernels.CRILAYLA_COMPRESS_LAUNCHES}


def drive(path: str, own, fn):
    """Run one main path with every launch count at 0 just before it; fail
    unless each of its own kernels was launched; return (result, counts)."""
    reset_launches()
    out = fn()
    counts = read_launches()
    log(f"{path} launches: { {k: v for k, v in counts.items() if v} }")
    for k in own:
        if counts[k] <= 0:
            raise AssertionError(f"{k} was not launched by {path}")
    return out, counts


def median_wall(fn, runs: int = 3):
    """(median seconds, all seconds) of fn() on the host clock, each run
    ending in a synchronise."""
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), times


def adx_phases(dev, card: str, worst: dict, launches: dict) -> dict:
    """Phases 6-8; returns name -> (ms, plain_ms, bound dict)."""
    import pycricodecs_tpu_torch as port
    from pycricodecs_tpu_torch.ops import adx_kernels as A
    from pycricodecs_tpu_torch.ops import cuda_kernels
    from pycricodecs_tpu_torch.parallel import pipeline as P
    from pycricodecs_tpu_torch.models import adx as adx_model
    from pycricodecs_tpu_torch.utils import signals
    from pycricodecs_tpu_torch.utils.wav import write_wav

    with open(os.path.join(ADX_FIXTURES, "expected.json")) as f:
        expected = json.load(f)
    blobs = {}
    for name in expected:
        with open(os.path.join(ADX_FIXTURES, name + ".adx"), "rb") as f:
            blobs[name] = f.read()
        if sha(blobs[name]) != expected[name]["adx_sha256"]:
            raise AssertionError(f"{name}.adx differs from its hash")
    bank_name = signals.ADX_BANK
    bank_h = adx_model.parse_adx_header(blobs[bank_name])

    # -- phase 6: B7 / B8 against their twins on random inputs --------------
    fixture_geometries = {(adx_model.parse_adx_header(b).bit_depth,
                           adx_model.parse_adx_header(b).block_size)
                          for b in blobs.values()}
    if not fixture_geometries <= set(DECODE_GEOMETRIES):
        raise AssertionError("a fixture's geometry is not a phase-6 case")
    worst["adx_decode"] = adx_random_decode_checks(dev)
    worst["adx_decode_host"] = adx_host_decode_checks(dev)
    worst["adx_encode"] = adx_random_encode_checks(dev)

    # -- phase 7: the ADX bank decode and encode, held to the JAX hashes ----
    # (adx_decode_batch's default is B7's host instance; its wrap=True, the
    # JAX device path's arithmetic, runs the wrap instance on the 1 s
    # fixtures below)
    bank = [blobs[bank_name]] * BANK_STREAMS
    wavs, counts = drive("adx_decode_batch", ["adx_decode_host"],
                         lambda: port.adx_decode_batch(bank, device=dev))
    launches["adx_decode_host"] = counts["adx_decode_host"]
    want = expected[bank_name]["wav_sha256"]
    bad = [i for i, w in enumerate(wavs) if sha(w) != want]
    if bad:
        raise AssertionError(f"ADX bank WAVs differ from the JAX package's "
                             f"decode: streams {bad[:8]}")
    dec_bytes = sum(len(w) for w in wavs)
    log(f"ADX bank: {BANK_STREAMS} x {expected[bank_name]['seconds']} s "
        f"decoded on the card, all WAV sha256 equal to the JAX package's "
        f"({dec_bytes} WAV bytes)")
    del wavs
    small = [n for n in expected if n != bank_name]
    wrapped, counts = drive(
        "adx_decode_batch(wrap=True)", ["adx_decode"],
        lambda: port.adx_decode_batch([blobs[n] for n in small], device=dev,
                                      wrap=True))
    launches["adx_decode"] = counts["adx_decode"]
    for name, w, ww in zip(small, port.adx_decode_batch(
            [blobs[n] for n in small], device=dev), wrapped):
        if sha(w) != expected[name]["wav_sha256"] or ww != w:
            raise AssertionError(f"{name}: WAV differs from the JAX "
                                 f"package's decode")
        log(f"ADX fixture {name}: decoded WAV sha256 (host and wrap "
            f"instances) equal to the JAX package's")

    wav_in = {}
    for name in expected:
        wav_in[name] = signals.adx_wav(name, write_wav)
        if sha(wav_in[name]) != expected[name]["wav_in_sha256"]:
            raise AssertionError(f"{name}: rebuilt input WAV differs from "
                                 f"its recorded hash")
    wav_bank = [wav_in[bank_name]] * BANK_STREAMS
    adxs, counts = drive("adx_encode_batch", ["adx_encode"],
                         lambda: port.adx_encode_batch(wav_bank, device=dev))
    launches["adx_encode"] = counts["adx_encode"]
    want = expected[bank_name]["adx_sha256"]
    bad = [i for i, a in enumerate(adxs) if sha(a) != want]
    if bad:
        raise AssertionError(f"ADX bank encodes differ from the JAX "
                             f"package's: streams {bad[:8]}")
    log(f"ADX bank: {BANK_STREAMS} x {expected[bank_name]['seconds']} s "
        f"encoded on the card, all ADX sha256 equal to the JAX package's")
    del adxs
    for name in small:
        kw = expected[name]["encode"]
        a = port.adx_encode_batch([wav_in[name]], device=dev, **kw)[0]
        if sha(a) != expected[name]["adx_sha256"]:
            raise AssertionError(f"{name}: ADX differs from the JAX "
                                 f"package's encode ({kw})")
        log(f"ADX fixture {name} ({kw}): encoded ADX sha256 equal to the "
            f"JAX package's")

    # -- phase 8: the kernels and twins at the bank shape; bank timings -----
    parsed = [P._parse_adx(b) for b in bank]
    lanes, h1, h2, c0, c1, _ = P._stack_adx_group(parsed,
                                                  list(range(len(bank))))
    dargs = [torch.from_numpy(lanes).to(dev),
             *P._lane_tensors(dev, h1, h2, c0, c1)]
    dkw = dict(bit_depth=bank_h.bit_depth,
               encoding_mode=bank_h.encoding_mode)
    L, nb, bs = lanes.shape
    spb = bank_h.samples_per_block
    # the twins on the first ADX_PREFIX_BLOCKS blocks of every lane (phase 7
    # held the whole bank's outputs to the JAX package's hashes); the
    # kernels run and are timed at the full bank shape
    pre = ADX_PREFIX_BLOCKS
    pcm_k = cuda_kernels.adx_decode(*dargs, **dkw)
    pre_d = [dargs[0][:, :pre].contiguous(), *dargs[1:]]
    pcm_t, d_plain = cuda_ms_once(lambda: A.adx_decode_plain(*pre_d, **dkw))
    worst["adx_decode"] = max(worst["adx_decode"], require_equal(
        "B7 bank prefix", [("pcm", pcm_k[:, :pre], pcm_t)]))
    G, K, smem = cuda_kernels.adx_decode_plan(L, nb, block_size=bs,
                                              bit_depth=bank_h.bit_depth)
    log(f"B7 at the bank shape {L} lanes x {nb} blocks (G {G} lanes per CTA, "
        f"K {K} blocks per chunk, {smem} shared bytes): its first {pre} "
        f"blocks byte-equal to the twin on them")
    d_ms = cuda_ms(lambda: cuda_kernels.adx_decode(*dargs, **dkw), 5)
    d_bound = bound("adx_decode", nbytes(*dargs, pcm_k), L * nb * spb,
                    chain_steps=nb * spb)
    # B7's host instance at the same shape: the same bytes and chain
    hkw = dict(dkw, wrap=False)
    pcm_h = cuda_kernels.adx_decode(*dargs, **hkw)
    pcm_t, h_plain = cuda_ms_once(lambda: A.adx_decode_plain(*pre_d, **hkw))
    worst["adx_decode_host"] = max(worst["adx_decode_host"], require_equal(
        "B7 host bank prefix", [("pcm", pcm_h[:, :pre], pcm_t)]))
    if not torch.equal(pcm_h, pcm_k):
        raise AssertionError("B7's instances differ on the bank, which has "
                             "no scale word past int32")
    h_ms = cuda_ms(lambda: cuda_kernels.adx_decode(*dargs, **hkw), 5)
    h_bound = bound("adx_decode_host", nbytes(*dargs, pcm_h), L * nb * spb,
                    chain_steps=nb * spb)
    log(f"B7 host instance at the bank shape: its first {pre} blocks "
        f"byte-equal to the twin on them, the whole bank equal to the wrap "
        f"instance's")
    del pcm_t, pre_d, pcm_h

    preps = [adx_model._encode_prep(
        wav_in[bank_name], bit_depth=4, block_size=0x12, encoding_mode=3,
        highpass_frequency=0x1F4, filter_=0, version=4,
        force_not_looping=False)] * BANK_STREAMS
    pcm_np, e0, e1, g1, g2, _ = P._stack_adx_pcm(
        preps, list(range(BANK_STREAMS)), spb)
    eargs = [torch.from_numpy(pcm_np).to(dev),
             *P._lane_tensors(dev, e0, e1, g1, g2)]
    ekw = dict(block_size=0x12, bit_depth=4, encoding_mode=3, filter_=0,
               scale_fix=False)
    blk_k = cuda_kernels.adx_encode(*eargs, **ekw)
    pre_e = [eargs[0][:, :pre].contiguous(), *eargs[1:]]
    blk_t, e_plain = cuda_ms_once(
        lambda: A.adx_encode_blocks_plain(*pre_e, **ekw))
    worst["adx_encode"] = max(worst["adx_encode"], require_equal(
        "B8 bank prefix", [("blocks", blk_k[:, :pre], blk_t)]))
    G, K, smem = cuda_kernels.adx_encode_plan(
        pcm_np.shape[0], pcm_np.shape[1], block_size=0x12, bit_depth=4)
    log(f"B8 at the bank shape {pcm_np.shape[0]} lanes x {pcm_np.shape[1]} "
        f"blocks (G {G} lanes per CTA, K {K} blocks per chunk, {smem} shared "
        f"bytes): its first {pre} blocks byte-equal to the twin on them")
    e_ms = cuda_ms(lambda: cuda_kernels.adx_encode(*eargs, **ekw), 5)
    e_bound = bound("adx_encode", nbytes(*eargs, blk_k), pcm_np.size,
                    chain_steps=pcm_np.shape[1] * spb)
    del blk_t, pcm_k, blk_k, dargs, eargs, pre_e

    audio_s = BANK_STREAMS * expected[bank_name]["seconds"]
    for label, fn in (("decode", lambda: port.adx_decode_batch(
                          bank, device=dev)),
                      ("encode", lambda: port.adx_encode_batch(
                          wav_bank, device=dev))):
        wall, runs = median_wall(fn)
        BANKS[f"adx_{label}_batch_s"] = wall
        log(f"ADX bank {label} [{card}]: median of 3 = {wall:.4f} s for "
            f"{audio_s:.0f} audio-s -> {audio_s / wall:.1f} audio-s/s; runs "
            f"{[round(r, 4) for r in runs]}")
    for name, ms, plain, bd in (("adx_decode", d_ms, d_plain, d_bound),
                                ("adx_decode_host", h_ms, h_plain, h_bound),
                                ("adx_encode", e_ms, e_plain, e_bound)):
        log(f"{name} chain bound inputs: {nb * spb} steps per lane x "
            f"{CHAIN_OPS[name]} critical-path ops x {CHAIN_CYCLES_PER_OP} "
            f"cycles / {max_sm_clock_mhz():.0f} MHz max SM clock")
        log(f"{name} [{card}] at {L} lanes x {nb} blocks: kernel "
            f"{ms:.4f} ms, twin {plain:.4f} ms at {L} lanes x {pre} blocks "
            f"(one run), bound {bd['bound_ms']:.4f} ms by {bd['bound_by']}")
    return {"adx_decode": (d_ms, d_plain, d_bound),
            "adx_decode_host": (h_ms, h_plain, h_bound),
            "adx_encode": (e_ms, e_plain, e_bound)}


# ---------------------------------------------------------------------------
# HCA encode (phases 9-11)
# ---------------------------------------------------------------------------

KEY = 0xCF222F1FE0748978  # the test suite's cipher-56 key


def f32_equal(what: str, a: torch.Tensor, b: torch.Tensor) -> float:
    """f32 tensors equal bit for bit (as i32 views); returns max |a - b|."""
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"{what}: shape/dtype differ")
    if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
        d = float((a.double() - b.double()).abs().max())
        raise AssertionError(f"{what}: B6 differs from its twin "
                             f"(max |diff| {d})")
    return 0.0


def encode_tensors(pcm, info, cfg):
    """The port's encode tensors (the packer's inputs) of PCM16
    [B, C, F*1024] on the card, and the packer keywords."""
    from pycricodecs_tpu_torch.ops import hca_encode_device as D
    kw = D.encode_config(info, cfg)
    tkw = {k: v for k, v in kw.items()
           if k not in ("hfr_counts", "hfr_counts2")}
    sf, res, inten, quant, level, boundary, db, ga, gs = \
        D.hca_encode_transform(pcm, **tkw)
    scales = D.hfr_scales(ga, gs, counts=kw["hfr_counts"],
                          counts2=kw["hfr_counts2"],
                          channel_types=kw["channel_types"])
    pkw = dict(channels=info.channels, coded_counts=kw["coded_counts"],
               channel_types=kw["channel_types"],
               hfr_group_count=kw["hfr_group_count"],
               frame_size=kw["frame_size"])
    return [level, boundary, sf, res, inten, scales, db, quant], pkw


def pack_needs(t, kw, frames_out):
    """(bytes, spectrum codes) the packer needs for these encode tensors:
    level, boundary and delta_bits; sf and res of the coded bands; the
    quantised value of each coded band whose resolution writes a code (1-15),
    in all 8 subframes; intensity of the stereo secondaries, HFR scales of
    the other channels; the frames written."""
    level, boundary, sf, res, inten, scales, db, quant = t
    frames = level.numel()
    coded = [int(x) for x in kw["coded_counts"]]
    codes = 8 * sum(int((res[..., c, :cc] > 0).sum().item())
                    for c, cc in enumerate(coded))
    secondary = sum(1 for x in kw["channel_types"] if x == 2)
    primary = kw["channels"] - secondary
    moved = (nbytes(level, boundary, db, frames_out)
             + frames * sum(coded) * (sf.element_size() + res.element_size())
             + codes * quant.element_size()
             + frames * secondary * 8 * inten.element_size()
             + frames * primary * kw["hfr_group_count"]
             * scales.element_size())
    return moved, codes


def random_pack_tensors(rng, info, n, dev):
    """Random encode tensors of n frames in the legal value ranges; at these
    widths most frames overflow the writer (the end-of-frame rule)."""
    C = info.channels
    G = max(int(info.hfr_group_count), 1)
    res = rng.integers(0, 16, (1, n, C, 128)).astype(np.uint8)
    r = res.astype(np.int64)
    qmax = np.where(r < 8, r, (1 << np.maximum(r - 4, 0)) - 1)
    q = np.round((rng.random((1, n, C, 8, 128)) * 2 - 1)
                 * qmax[..., None, :]).astype(np.int16)
    arrays = [rng.integers(0, 256, (1, n)).astype(np.int32),
              rng.integers(0, 128, (1, n)).astype(np.int32),
              rng.integers(0, 64, (1, n, C, 128)).astype(np.uint8), res,
              rng.integers(0, 16, (1, n, C, 8)).astype(np.uint8),
              rng.integers(0, 64, (1, n, C, G)).astype(np.int32),
              rng.integers(0, 7, (1, n, C)).astype(np.int32), q]
    return [torch.from_numpy(a).to(dev) for a in arrays]


def crc_slot_tensors(info, dev):
    """One frame (of 4) whose last spectrum symbol starts in the last data
    byte and ends inside the CRC slot, with all-ones leading bits (the JAX
    suite's case at 48 kHz q0 stereo, frame_size 1024)."""
    C, fs, G = info.channels, int(info.frame_size), int(info.hfr_group_count)
    head = 32 + sum(3 + (32 if int(t) == 2 else 6 * G)
                    for t in info.channel_type)
    limit = fs * 8 - 16
    total = limit + 1 + (-(limit + 1 - head - 89)) % 8
    fill = (total - head - 89) // 8
    n11, r = fill // 11, fill % 11
    if r == 1:
        n11, r = n11 - 1, 12
    n3 = r % 2
    n2 = (r - 3 * n3) // 2
    t = [np.zeros((1, 4), np.int32), np.zeros((1, 4), np.int32),
         np.zeros((1, 4, C, 128), np.uint8),
         np.zeros((1, 4, C, 128), np.uint8), np.zeros((1, 4, C, 8), np.uint8),
         np.zeros((1, 4, C, max(G, 1)), np.int32),
         np.zeros((1, 4, C), np.int32), np.zeros((1, 4, C, 8, 128), np.int16)]
    t[3][0, 0, 0, :n11] = 15
    t[3][0, 0, 0, n11:n11 + n2] = 2
    if n3:
        t[3][0, 0, 0, n11 + n2] = 4
    cc_last = int(info.coded_count[C - 1])
    t[3][0, 0, C - 1, cc_last - 1] = 15
    t[7][0, 0, C - 1, 7, cc_last - 1] = 2047
    return [torch.from_numpy(a).to(dev) for a in t], limit - (total - 12)


# (B, C, T) of B6's random checks; rows = B * C * T, one-warp tiles of 32
MDCT_CASES = (
    (3, 2, 37), (1, 1, 8), (4, 6, 24),
    (5, 2, 1),      # T = 1: every row folds with zeros (10 rows: ragged)
    (1, 1, 45),     # a ragged last warp of 13 rows
    (2, 3, 33),     # T = 33: tiles that cross into a new stream channel
)


def mdct_checks(dev, rng) -> None:
    """Phase 9's random checks: B6 against mdct_plain, f32 as i32 bits, on
    random PCM16 with both rails and all-zero blocks (MDCT_CASES; the first
    three drawn from rng, the edge cases from their own generator)."""
    from pycricodecs_tpu_torch.ops import cuda_kernels
    from pycricodecs_tpu_torch.ops import hca_encode_device as D
    edge = np.random.default_rng(109)
    for i, (B, C, Tn) in enumerate(MDCT_CASES):
        g = rng if i < 3 else edge
        pcm = g.integers(-32768, 32768, (B, C, Tn * 128), dtype=np.int16)
        pcm[0, 0, :4] = (-32768, 32767, -32768, 32767)
        pcm[-1, -1, 128:384] = 0
        p = torch.from_numpy(pcm).to(dev)
        f32_equal(f"B6 random {B}x{C}x{Tn}", cuda_kernels.hca_mdct(p),
                  D.mdct_plain(p))
        log(f"B6 random {B} x {C} x {Tn} blocks: bit-equal to the twin")


def hca_encode_phases(dev, card: str, worst: dict, launches: dict) -> dict:
    """Phases 9-11; returns name -> (ms, plain_ms, bound dict)."""
    import pycricodecs_tpu_torch as port
    from pycricodecs_tpu_torch.ops import cuda_kernels
    from pycricodecs_tpu_torch.ops import hca_encode_device as D
    from pycricodecs_tpu_torch.ops import hca_encode_host as EH
    from pycricodecs_tpu_torch.ops import hca_frame
    from pycricodecs_tpu_torch.ops import hca_pack_device as PP
    from pycricodecs_tpu_torch.utils import signals
    from pycricodecs_tpu_torch.utils.wav import parse_wav, write_wav

    with open(os.path.join(FIXTURES, "expected.json")) as f:
        # the v3 PNS fixture is a relabelled stream with no encode of its own
        expected = {n: e for n, e in json.load(f).items()
                    if not e.get("v3_pns")}
    blobs, wav_in = {}, {}
    for name in expected:
        with open(os.path.join(FIXTURES, name + ".hca"), "rb") as f:
            blobs[name] = f.read()
        if sha(blobs[name]) != expected[name]["hca_sha256"]:
            raise AssertionError(f"{name}.hca differs from its hash")
        wav_in[name] = signals.hca_wav(name, write_wav)
        if sha(wav_in[name]) != expected[name]["wav_in_sha256"]:
            raise AssertionError(f"{name}: rebuilt input WAV differs from "
                                 f"its recorded hash")
    cfgs = {}
    for name in expected:
        w = parse_wav(wav_in[name])
        cfgs[name] = (EH.init_encode(w, expected[name]["quality"],
                                     w.looping), w)

    # -- phase 9: B6 against mdct_plain -------------------------------------
    rng = np.random.default_rng(9)
    mdct_checks(dev, rng)
    bank_cfg, bank_w = cfgs[BANK]
    bank_pcm = torch.from_numpy(D.stack_timelines(
        [bank_cfg] * BANK_STREAMS, [bank_w] * BANK_STREAMS)).to(dev)
    spec_k = cuda_kernels.hca_mdct(bank_pcm)
    spec_t, mdct_plain_ms = cuda_ms_once(lambda: D.mdct_plain(bank_pcm))
    worst["hca_mdct"] = f32_equal("B6 bank", spec_k, spec_t)
    log(f"B6 bank shape {tuple(bank_pcm.shape)} -> {tuple(spec_k.shape)}: "
        f"bit-equal to the twin")
    mdct_ms = cuda_ms(lambda: cuda_kernels.hca_mdct(bank_pcm), 20)
    mdct_bound = bound("hca_mdct", nbytes(bank_pcm, spec_k), spec_k.numel())
    # the library yardstick: the int16 -> f32 cast and a zero block padded
    # in front (two calls), each block with the one before as a 256-value
    # unfold view (no call), one matmul by the folded 256 x 128 matrix of
    # the window fold, the DCT-IV and the 1 / 32768 (TF32 off)
    mdct_matrix = D.mdct_plain(torch.eye(256).view(1, 256, 256))[0, :, 1] \
        .contiguous().to(dev)

    def mdct_library():
        x = torch.nn.functional.pad(bank_pcm.float(), (128, 0))
        return torch.matmul(x.unfold(-1, 256, 128), mdct_matrix)
    mdct_lib_ms = cuda_ms(mdct_library, 20)
    mdct_lib_err = float((mdct_library() - spec_k).abs().max())
    log(f"hca_mdct library yardstick [{card}]: 3 calls, the cast, F.pad and "
        f"torch.matmul of the unfold view by the folded 256 x 128 matrix "
        f"(TF32 off) {mdct_lib_ms:.4f} ms, max |diff| from B6 "
        f"{mdct_lib_err:.6g} (another summation order)")
    del spec_k, spec_t

    # -- phase 10: hca_pack against pack_frames_plain -----------------------
    bank_t, bank_kw = encode_tensors(bank_pcm, bank_cfg.info, bank_cfg)
    got = cuda_kernels.hca_pack(*bank_t, **bank_kw)
    want, pack_plain_ms = cuda_ms_once(
        lambda: PP.pack_frames_plain(*bank_t, **bank_kw))
    worst["hca_pack"] = require_equal("hca_pack bank",
                                      [("frames", got, want)])
    log(f"hca_pack bank tensors {tuple(got.shape)}: byte-equal to the twin")
    pack_ms = cuda_ms(lambda: cuda_kernels.hca_pack(*bank_t, **bank_kw), 5)
    pack_bytes, pack_codes = pack_needs(bank_t, bank_kw, got)
    pack_bound = bound("hca_pack", pack_bytes, pack_codes)
    log(f"hca_pack bank needs {pack_bytes} bytes, {pack_codes} spectrum "
        f"codes")
    del got, want, bank_t
    for name in expected:
        if name == BANK:
            continue
        cfg, _ = cfgs[name]
        info = cfg.info
        # rate-controlled tensors of noise at a random level per stream
        C = info.channels
        amp = rng.uniform(0.001, 1.0, (16, 1, 1))
        noise = np.clip(rng.standard_normal((16, C, 48 * 1024)) * amp
                        * 32767, -32768, 32767).astype(np.int16)
        t, kw = encode_tensors(torch.from_numpy(noise).to(dev), info, cfg)
        pairs = [("noise frames", cuda_kernels.hca_pack(*t, **kw),
                  PP.pack_frames_plain(*t, **kw))]
        t = random_pack_tensors(rng, info, 512, dev)
        pairs.append(("random frames", cuda_kernels.hca_pack(*t, **kw),
                      PP.pack_frames_plain(*t, **kw)))
        worst["hca_pack"] = max(worst["hca_pack"], require_equal(
            f"hca_pack {name}", pairs))
        log(f"hca_pack {name} config: 16 x 48 noise frames and 512 random "
            f"frames byte-equal to the twin")
    # a frame size off 16 bytes (byte stores, a partial last word) and a
    # frame count that leaves the last CTA ragged
    info = cfgs["q4_stereo_48k_1s"][0].info
    kw = dict(channels=info.channels,
              coded_counts=tuple(int(x) for x in info.coded_count),
              channel_types=tuple(int(x) for x in info.channel_type),
              hfr_group_count=int(info.hfr_group_count))
    for fs_odd in (ODD_FRAME_SIZE, int(info.frame_size)):
        t = random_pack_tensors(rng, info, 512 + RAGGED, dev)
        worst["hca_pack"] = max(worst["hca_pack"], require_equal(
            f"hca_pack frame size {fs_odd}",
            [("random frames", cuda_kernels.hca_pack(*t, **kw,
                                                     frame_size=fs_odd),
              PP.pack_frames_plain(*t, **kw, frame_size=fs_odd))]))
        log(f"hca_pack q4 stereo config at frame size {fs_odd}: "
            f"{512 + RAGGED} random frames byte-equal to the twin")
    q0 = cfgs["q0_stereo_48k_1s"][0].info
    t, lead = crc_slot_tensors(q0, dev)
    kw = dict(channels=q0.channels,
              coded_counts=tuple(int(x) for x in q0.coded_count),
              channel_types=tuple(int(x) for x in q0.channel_type),
              hfr_group_count=int(q0.hfr_group_count),
              frame_size=int(q0.frame_size))
    got = cuda_kernels.hca_pack(*t, **kw)
    require_equal("hca_pack CRC slot", [("frames", got,
                                         PP.pack_frames_plain(*t, **kw))])
    k = min(lead, 8)
    if int(got[0, 0, q0.frame_size - 3]) & ((1 << k) - 1) != (1 << k) - 1:
        raise AssertionError("hca_pack dropped the CRC-slot-crossing symbol")
    log(f"hca_pack CRC-slot-crossing frame (q0 stereo, frame_size "
        f"{q0.frame_size}): byte-equal to the twin, leading bits kept")
    del t, got, bank_pcm
    torch.cuda.synchronize()

    # -- phase 11: the encode bank and config 4's round trip ----------------
    wav_bank = [wav_in[BANK]] * BANK_STREAMS
    hcas, counts = drive("hca_encode_batch", ["hca_mdct", "hca_pack"],
                         lambda: port.hca_encode_batch(wav_bank, quality=2,
                                                       device=dev))
    launches["hca_mdct"] = counts["hca_mdct"]
    launches["hca_pack"] = counts["hca_pack"]
    bad = [i for i, h in enumerate(hcas) if h != blobs[BANK]]
    if bad:
        raise AssertionError(f"encoded bank streams differ from "
                             f"{BANK}.hca: streams {bad[:8]}")
    log(f"HCA encode bank: {BANK_STREAMS} x {expected[BANK]['seconds']} s "
        f"encoded on the card, all equal to {BANK}.hca byte for byte")
    want = expected[BANK]["wav_sha256"]
    wavs = port.decode_batch(hcas, device=dev)
    if any(sha(w) != want for w in wavs):
        raise AssertionError("the encoded bank does not decode to the JAX "
                             "package's WAV")
    log("HCA encode bank: decoded on the card, every WAV sha256 equal to "
        "the JAX package's")
    del wavs, hcas
    for name in expected:
        if name == BANK:
            continue
        h = port.hca_encode_batch([wav_in[name]],
                                  quality=expected[name]["quality"],
                                  device=dev)[0]
        if h != blobs[name]:
            raise AssertionError(f"{name}: the card's encode differs from "
                                 f"the committed stream")
        log(f"HCA encode fixture {name}: equal to {name}.hca")
    name = "q4_stereo_48k_1s"
    plain = blobs[name]
    hs = int.from_bytes(plain[6:8], "big")
    enc = port.crypt(plain, True, hs, 56, KEY)
    if hca_frame.parse_header(enc[:hs]).ciph_type != 56 or enc == plain:
        raise AssertionError("crypt did not encipher the stream")
    wav = port.decode_batch([enc], key=KEY, device=dev)[0]
    if sha(wav) != expected[name]["wav_sha256"]:
        raise AssertionError("config 4: the enciphered stream does not "
                             "decode to the plain stream's WAV")
    if port.crypt(enc, False, hs, 56, KEY) != plain:
        raise AssertionError("config 4: decrypt does not restore the stream")
    log(f"config 4 round trip ({name}): encrypted (cipher 56), decoded on "
        f"the card with the key to the plain WAV's sha256, decrypted back")

    audio_s = BANK_STREAMS * expected[BANK]["seconds"]
    port.hca_encode_batch(wav_bank, quality=2, device=dev)   # warm-up
    wall, runs = median_wall(lambda: port.hca_encode_batch(
        wav_bank, quality=2, device=dev))
    BANKS["hca_encode_batch_s"] = wall
    log(f"HCA encode bank [{card}]: median of 3 = {wall:.4f} s for "
        f"{audio_s:.0f} audio-s -> {audio_s / wall:.1f} audio-s/s; runs "
        f"{[round(r, 4) for r in runs]}")
    for name, ms, plain_ms, bd in (
            ("hca_mdct", mdct_ms, mdct_plain_ms, mdct_bound),
            ("hca_pack", pack_ms, pack_plain_ms, pack_bound)):
        log(f"{name} [{card}] at the encode bank shape: kernel {ms:.4f} ms, "
            f"twin {plain_ms:.4f} ms (one run), bound {bd['bound_ms']:.4f} "
            f"ms by {bd['bound_by']}")
    return {"hca_mdct": (mdct_ms, mdct_plain_ms, mdct_bound, mdct_lib_ms),
            "hca_pack": (pack_ms, pack_plain_ms, pack_bound)}


# ---------------------------------------------------------------------------
# v3 PNS noise fill (phase 12)
# ---------------------------------------------------------------------------

PNS_STREAMS = 64


def random_transform_inputs(g, n_streams, F, C, dev):
    """Random legal B3 inputs and PNS maps [n_streams, F, C, ...] on dev."""
    def ri(hi, shape, dtype):
        return torch.randint(0, hi, shape, generator=g, dtype=dtype).to(dev)
    shape = (n_streams, F, C)
    qc = (torch.randint(-127, 128, shape + (8, 128), generator=g,
                        dtype=torch.int16)).to(dev)
    args = [qc, ri(64, shape + (128,), torch.uint8),
            ri(16, shape + (128,), torch.uint8),
            ri(16, shape + (8,), torch.uint8)]
    mask = (torch.rand(shape + (8, 128), generator=g) < 0.3).to(dev)
    noise = (ri(128, shape + (8, 128), torch.uint8),
             ri(128, shape + (8, 128), torch.uint8), mask)
    return args, noise


def pns_phase(dev, card: str, worst: dict, launches: dict) -> dict:
    """Phase 12; returns name -> (ms, plain_ms, bound dict)."""
    import pycricodecs_tpu_torch as port
    from pycricodecs_tpu_torch.ops import hca_frame
    from pycricodecs_tpu_torch.ops import hca_kernels as K
    from pycricodecs_tpu_torch.ops import hca_unpack_device as U
    from pycricodecs_tpu_torch.parallel.pipeline import \
        CHUNK_STREAMS as CHUNK

    with open(os.path.join(FIXTURES, "expected.json")) as f:
        expected = json.load(f)
    name = next(n for n, e in expected.items() if e.get("v3_pns"))
    with open(os.path.join(FIXTURES, name + ".hca"), "rb") as f:
        blob = f.read()
    if sha(blob) != expected[name]["hca_sha256"]:
        raise AssertionError(f"{name}.hca differs from its hash")
    hs = int.from_bytes(blob[6:8], "big")
    info = hca_frame.parse_header(blob[:hs])
    def fixture_info(fixture):
        with open(os.path.join(FIXTURES, fixture + ".hca"), "rb") as f:
            data = f.read()
        return hca_frame.parse_header(data[:int.from_bytes(data[6:8],
                                                           "big")])
    q4 = "q4_stereo_48k_1s"
    q4_info = fixture_info(q4)
    bank_info = fixture_info(BANK)
    F = bank_info.frame_count               # the bank chunk's 469 frames

    # B3 with random legal maps against its twin
    g = torch.Generator().manual_seed(12)
    w = 0
    for label, cinfo in ((name, info), (q4, q4_info)):
        hfr, cfg = K.transform_config(cinfo)
        args, noise = random_transform_inputs(g, CHUNK, F, cinfo.channels,
                                              dev)
        pk = K.hca_decode_transform_batched(*args, hfr, noise=noise, **cfg)
        pt = K.decode_transform_plain(*args, hfr, noise=noise, **cfg)
        w = max(w, require_equal(f"B3 PNS random {label}", [("pcm", pk, pt)]))
        log(f"B3 with random PNS maps, {label} config ({CHUNK}x{F} frames, "
            f"{cinfo.channels} ch): byte-equal to the twin")
        del pk, pt
    # the fixture's real maps: noise_maps on the card equals the CPU run
    up = U.DeviceUnpacker(info, device=dev)
    n = info.frame_count
    frames = np.frombuffer(blob, np.uint8, count=n * info.frame_size,
                           offset=hs).reshape(n, info.frame_size)
    qc, sf, res, inten, err = up(torch.from_numpy(frames.copy()).to(dev))
    if bool(err.any()):
        raise AssertionError("B1/B2 flagged an error on the PNS fixture")
    maps = up.noise_maps(sf, res, 1)
    cpu_maps = U.DeviceUnpacker(info, device="cpu").noise_maps(sf.cpu(), res.cpu(),
                                                        1)
    for label, a, b in zip(("src", "sci", "mask"), maps, cpu_maps):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"noise_maps {label}: card and CPU differ")
    masked = int(maps[2].sum())
    if masked == 0:
        raise AssertionError("the PNS fixture has no noise band")
    hfr, cfg = K.transform_config(info)
    real = [t.view(1, n, *t.shape[1:]) for t in (qc, sf, res, inten)]
    noise = tuple(m.view(1, n, 1, 8, 128) for m in maps)
    w = max(w, require_equal("B3 PNS real maps", [(
        "pcm", K.hca_decode_transform_batched(*real, hfr, noise=noise, **cfg),
        K.decode_transform_plain(*real, hfr, noise=noise, **cfg))]))
    worst["hca_transform_pns"] = max(worst["hca_transform_pns"], w)
    log(f"B3 with the fixture's real maps ({n} frames, {masked} noise "
        f"values): byte-equal to the twin; noise_maps equal on card and CPU")

    # the PNS path through decode_batch
    bank = [blob] * PNS_STREAMS
    own = ("hca_side_info", "hca_coefficients", "hca_transform")
    wavs, counts = drive("decode_batch (v3 PNS)", own,
                         lambda: port.decode_batch(bank, device=dev))
    launches["hca_transform_pns"] = counts["hca_transform"]
    bad = [i for i, wv in enumerate(wavs)
           if sha(wv) != expected[name]["wav_sha256"]]
    if bad:
        raise AssertionError(f"PNS WAVs differ from the JAX package's "
                             f"decode: streams {bad[:8]}")
    log(f"PNS: {PNS_STREAMS} x {name} decoded on the card, every WAV sha256 "
        f"equal to the JAX package's")

    # B3 with noise, timed at the bank chunk's shape (stereo q2 config)
    hfr, cfg = K.transform_config(bank_info)
    C = bank_info.channels
    args, noise = random_transform_inputs(g, CHUNK, F, C, dev)
    ms = cuda_ms(lambda: K.hca_decode_transform_batched(
        *args, hfr, noise=noise, **cfg), 20)
    plain_ms = cuda_ms(lambda: K.decode_transform_plain(
        *args, hfr, noise=noise, **cfg), 3)
    values = CHUNK * F * 8 * 128 * C
    bd = bound("hca_transform_pns", nbytes(*args, *noise) + values * 2,
               values)
    log(f"hca_transform_pns [{card}] at {CHUNK}x{F} frames, {C} ch, random "
        f"maps: kernel {ms:.4f} ms, twin {plain_ms:.4f} ms, bound "
        f"{bd['bound_ms']:.4f} ms by {bd['bound_by']}")
    return {"hca_transform_pns": (ms, plain_ms, bd)}


# ---------------------------------------------------------------------------
# AHX / MPEG Layer II decode (phase 13)
# ---------------------------------------------------------------------------

# (label, header word fields) of the random-frame checks: every unpacker
# configuration; joint stereo draws its mode_ext per frame
MP2_RANDOM_CONFIGS = (
    ("LSF mono 16 kHz 64 kbps", dict(version=2, bri=8, sri=2, mode=3)),
    ("LSF mono 22.05 kHz 96 kbps", dict(version=2, bri=10, sri=0, mode=3)),
    ("LSF mono 24 kHz 160 kbps", dict(version=2, bri=14, sri=1, mode=3)),
    ("MPEG-1 stereo 44.1 kHz 192 kbps", dict(version=3, bri=10, sri=0,
                                              mode=0)),
    ("MPEG-1 joint 44.1 kHz 192 kbps", dict(version=3, bri=10, sri=0,
                                             mode=1)),
    ("MPEG-1 mono 48 kHz 56 kbps (table c)", dict(version=3, bri=3, sri=1,
                                                   mode=3)),
    ("MPEG-1 stereo 32 kHz 48 kbps (table d)", dict(version=3, bri=2, sri=2,
                                                     mode=0)),
    ("LSF mono 22.05 kHz 96 kbps, CRC", dict(version=2, bri=10, sri=0,
                                             mode=3, crc=True)),
    ("MPEG-1 joint 44.1 kHz 192 kbps, CRC", dict(version=3, bri=10, sri=0,
                                                  mode=1, crc=True)),
)


def random_mp2_frames(rng, version, bri, sri, mode, crc=False,
                      n=RANDOM_FRAMES, fs_max=None):
    """n random-byte frames behind valid headers (random padding bit, and
    mode_ext for joint stereo), u8 [n, fs_max] (default: the largest frame
    size); the first 8 rows are all zero (no header: all zero out, err set).
    Returns (frames, channels)."""
    from pycricodecs_tpu_torch.ops import mp2_frame
    w0 = ((0x7FF << 21) | (version << 19) | (2 << 17)
          | ((0 if crc else 1) << 16) | (bri << 12) | (sri << 10)
          | (mode << 6))
    hdr = mp2_frame.parse_header(w0.to_bytes(4, "big"))
    fs_max = fs_max or hdr.frame_size + 1
    fr = rng.integers(0, 256, (n, fs_max), dtype=np.uint8)
    words = (w0 | (rng.integers(0, 2, n) << 9)
             | (rng.integers(0, 4, n) << 4)).astype(">u4")
    fr[:, :4] = words.view(np.uint8).reshape(-1, 4)
    fr[:8] = 0
    return fr, hdr.nch


# headers whose frame size ends inside the scalefactors (the smallest LSF
# stereo frames) or inside the samples, on random bytes; a legal frame
# cannot end inside its allocation or scfsi (the smallest frame, 48 bytes,
# is longer than both together: tests/test_torch_mp2_unpack_warp.py)
MP2_CUT_CONFIGS = (
    ("LSF stereo 22.05 kHz 8 kbps, cut in the scalefactors",
     dict(version=2, bri=1, sri=0, mode=0)),
    ("LSF joint 24 kHz 16 kbps, cut in the scalefactors",
     dict(version=2, bri=2, sri=1, mode=1)),
    ("LSF mono 24 kHz 32 kbps, cut in the samples",
     dict(version=2, bri=4, sri=1, mode=3)),
    ("MPEG-1 stereo 48 kHz 32 kbps, cut in the samples",
     dict(version=3, bri=1, sri=1, mode=0)),
)


def mp2_unpack_pair(worst: dict, label: str, frames, C):
    """B10 against mp2_unpack_plain on the same frames, byte for byte with
    the error flags; returns the kernel's outputs."""
    from pycricodecs_tpu_torch.ops import cuda_kernels
    from pycricodecs_tpu_torch.ops import mp2_unpack_device as MU
    got = cuda_kernels.mp2_unpack(frames, C)
    want = MU.mp2_unpack_plain(frames, C)
    worst["mp2_unpack"] = max(worst["mp2_unpack"], require_equal(
        f"B10 {label}", [(n, a.view(torch.int16) if a.dtype ==
                          torch.uint16 else a,
                          b.view(torch.int16) if b.dtype == torch.uint16
                          else b)
                         for n, a, b in zip(("codes", "levels", "sfidx",
                                             "err"), got, want)]))
    return got


def mp2_unpack_checks(dev, worst: dict, blobs: dict, rng) -> None:
    """Phase 13's B10 checks besides the bank: random frames behind valid
    headers per configuration (drawn from rng), then, from their own
    generator, RANDOM_FRAMES + RAGGED of them (a ragged last CTA) at rows
    of ODD_FRAME_SIZE bytes, frames cut inside their scalefactors and their
    samples, rows shorter than their frame (all zero, err set); the
    varying-bound stream."""
    from pycricodecs_tpu_torch.parallel import pipeline as P
    for label, kw in MP2_RANDOM_CONFIGS:
        fr, C = random_mp2_frames(rng, **kw)
        got = mp2_unpack_pair(worst, f"random {label}",
                              torch.from_numpy(fr).to(dev), C)
        bad = int(got[3].sum())
        if not bool(got[3][:8].all()):
            raise AssertionError(f"B10 random {label}: a frame without "
                                 f"header was not flagged")
        log(f"B10 random {label}: {RANDOM_FRAMES} frames, {bad} flagged "
            f"(8 without header): byte-equal to the twin, err included")
    rng = np.random.default_rng(113)
    # 480- and 481-byte frames in rows of 515 bytes (no row start on a
    # 16-byte boundary but every 16th), a count 13 past whole CTAs
    for label, kw in (("LSF mono 24 kHz 80 kbps", dict(version=2, bri=10,
                                                       sri=1, mode=3)),
                      ("MPEG-1 joint 48 kHz 160 kbps",
                       dict(version=3, bri=10, sri=1, mode=1))):
        fr, C = random_mp2_frames(rng, **kw, n=RANDOM_FRAMES + RAGGED,
                                  fs_max=ODD_FRAME_SIZE)
        mp2_unpack_pair(worst, f"rows of {ODD_FRAME_SIZE} {label}",
                        torch.from_numpy(fr).to(dev), C)
        log(f"B10 {label}: {RANDOM_FRAMES + RAGGED} frames in rows of "
            f"{ODD_FRAME_SIZE} bytes: byte-equal to the twin")
    for label, kw in MP2_CUT_CONFIGS:
        fr, C = random_mp2_frames(rng, **kw, n=RANDOM_FRAMES + RAGGED)
        got = mp2_unpack_pair(worst, label, torch.from_numpy(fr).to(dev), C)
        bad = int(got[3].sum())
        if bad < RANDOM_FRAMES // 2:
            raise AssertionError(f"B10 {label}: only {bad} frames cut")
        log(f"B10 {label}: {RANDOM_FRAMES + RAGGED} frames, {bad} flagged: "
            f"byte-equal to the twin, err included")
    # rows of 626-627-byte joint frames cut from inside the header (1, 3
    # bytes) and the allocation (5, 12) to the scalefactors (40) and the
    # samples (200, 625)
    fr, C = random_mp2_frames(rng, **MP2_RANDOM_CONFIGS[4][1], n=64)
    cuts = (1, 3, 5, 12, 40, 200, fr.shape[1] - 2)
    for W in cuts:
        got = mp2_unpack_pair(worst, f"rows cut to {W} bytes",
                              torch.from_numpy(
                                  np.ascontiguousarray(fr[:, :W])).to(dev), C)
        if not bool(got[3].all()) or bool(got[1].any()):
            raise AssertionError(f"B10 rows cut to {W} bytes: a frame "
                                 f"longer than its row was decoded")
    log(f"B10 rows cut to {cuts} bytes: all zero with err set, byte-equal "
        f"to the twin")
    hdr, walk, _, _ = P._parse_mp2(blobs["mp2_joint_varying_bound"])
    jf = P._stack_mp2_frames([walk])
    mp2_unpack_pair(worst, "varying-bound stream", torch.from_numpy(
        jf.reshape(-1, jf.shape[-1])).to(dev), 2)
    log(f"B10 varying-bound joint stream ({len(walk)} frames): byte-equal "
        f"to the twin")


def load_ahx_fixtures():
    """(expected.json of the AHX fixtures, name -> stream bytes)."""
    with open(os.path.join(AHX_FIXTURES, "expected.json")) as f:
        expected = json.load(f)
    blobs = {}
    for name, e in expected.items():
        with open(os.path.join(AHX_FIXTURES, e["file"]), "rb") as f:
            blobs[name] = f.read()
        if sha(blobs[name]) != e["stream_sha256"]:
            raise AssertionError(f"{e['file']} differs from its hash")
    return expected, blobs


def ahx_phase(dev, card: str, worst: dict, launches: dict) -> dict:
    """Phase 13; returns name -> (ms, plain_ms, bound dict)."""
    import pycricodecs_tpu_torch as port
    from pycricodecs_tpu_torch.ops import cuda_kernels
    from pycricodecs_tpu_torch.ops import mp2_kernels as MK
    from pycricodecs_tpu_torch.ops import mp2_tables
    from pycricodecs_tpu_torch.ops import mp2_unpack_device as MU
    from pycricodecs_tpu_torch.parallel import pipeline as P
    from pycricodecs_tpu_torch.utils import signals

    expected, blobs = load_ahx_fixtures()
    bank_name = signals.AHX_BANK
    bank = [blobs[bank_name]] * BANK_STREAMS

    # -- B10 against its twin ---------------------------------------------
    walks = [P._parse_mp2(b)[1] for b in bank]
    stack = P._stack_mp2_frames(walks)
    B, Fb, fs_max = stack.shape
    bank_frames = torch.from_numpy(stack.reshape(B * Fb, fs_max)).to(dev)
    codes, levels, sfidx, err = mp2_unpack_pair(worst, "bank", bank_frames,
                                                1)
    if bool(err.any()):
        raise AssertionError("B10 flagged an error in the bank stream")
    log(f"B10 bank {B} x {Fb} frames of <= {fs_max} bytes: byte-equal to "
        f"the twin")
    rng = np.random.default_rng(13)
    mp2_unpack_checks(dev, worst, blobs, rng)

    # -- mp2_synth against its twin ---------------------------------------
    bank_in = (codes.view(B, Fb, 1, 36, 32), levels.view(B, Fb, 1, 32),
               sfidx.view(B, Fb, 1, 3, 32))
    pcm_k = cuda_kernels.mp2_synth(*bank_in)
    pcm_t, synth_plain_ms = cuda_ms_once(lambda: MK.synthesize_plain(
        *bank_in))
    worst["mp2_synth"] = require_equal("mp2_synth bank", [("pcm", pcm_k,
                                                           pcm_t)])
    log(f"mp2_synth bank {B} x {Fb} frames: bit-equal to the twin")
    del pcm_t
    classes = np.unique(np.concatenate(
        [np.concatenate(t) for t in mp2_tables.ALLOC_TABLES.values()]))
    # T = F * 36 off the kernel's 64-row tile and 9-tile segment, C = 2
    for Bs, Fs, C in ((4, 40, 2), (3, 17, 1), (2, 19, 2), (1, 1, 2)):
        lv = rng.choice(classes, (Bs, Fs, C, 32)).astype(np.int32)
        cd = (rng.random((Bs, Fs, C, 36, 32))
              * np.maximum(lv, 1)[..., None, :]).astype(np.uint16)
        cd[lv[..., None, :].repeat(36, -2) == 0] = 0
        sfi = rng.integers(0, 63, (Bs, Fs, C, 3, 32), dtype=np.uint8)
        t = [torch.from_numpy(a).to(dev) for a in (cd, lv, sfi)]
        worst["mp2_synth"] = max(worst["mp2_synth"], require_equal(
            f"mp2_synth random {Bs}x{Fs}x{C}",
            [("pcm", cuda_kernels.mp2_synth(*t), MK.synthesize_plain(*t))]))
        log(f"mp2_synth random codes {Bs} x {Fs} frames x {C} ch: bit-equal "
            f"to the twin")

    # -- the AHX bank through ahx_decode_batch ----------------------------
    wavs, counts = drive("ahx_decode_batch", ["mp2_unpack", "mp2_synth"],
                         lambda: port.ahx_decode_batch(bank, device=dev))
    launches["mp2_unpack"] = counts["mp2_unpack"]
    launches["mp2_synth"] = counts["mp2_synth"]
    want = expected[bank_name]["wav_sha256"]
    bad = [i for i, wv in enumerate(wavs) if sha(wv) != want]
    if bad:
        raise AssertionError(f"AHX bank WAVs differ from the JAX package's "
                             f"host lane: streams {bad[:8]}")
    log(f"AHX bank: {BANK_STREAMS} x 10 s decoded on the card, every WAV "
        f"sha256 equal to the JAX package's host lane "
        f"({sum(len(wv) for wv in wavs)} WAV bytes)")
    del wavs
    small = [n for n in expected if n != bank_name]
    for name, wv in zip(small, port.ahx_decode_batch(
            [blobs[n] for n in small], device=dev)):
        if sha(wv) != expected[name]["wav_sha256"]:
            raise AssertionError(f"{name}: WAV differs from the JAX "
                                 f"package's host lane")
        log(f"AHX fixture {name}: WAV sha256 equal to the JAX package's "
            f"host lane")

    # -- timings ------------------------------------------------------------
    port.ahx_decode_batch(bank, device=dev)                  # warm-up
    wall, runs = median_wall(lambda: port.ahx_decode_batch(bank, device=dev))
    BANKS["ahx_decode_batch_s"] = wall
    audio_s = BANK_STREAMS * 10.0
    log(f"AHX bank [{card}]: median of 3 = {wall:.4f} s for {audio_s:.0f} "
        f"audio-s -> {audio_s / wall:.1f} audio-s/s; runs "
        f"{[round(r, 4) for r in runs]}")
    unpack_ms = cuda_ms(lambda: cuda_kernels.mp2_unpack(bank_frames, 1), 20)
    _, unpack_plain_ms = cuda_ms_once(
        lambda: MU.mp2_unpack_plain(bank_frames, 1))
    synth_ms = cuda_ms(lambda: cuda_kernels.mp2_synth(*bank_in), 20)
    synth_library_ms = synth_library(bank_in, pcm_k, MK, card)
    SB = P._parse_mp2(bank[0])[0].sblimit
    unpack_bd = bound("mp2_unpack", nbytes(bank_frames, codes, levels,
                                           sfidx, err),
                      int((levels > 0).sum()) * 36)
    synth_bd = bound("mp2_synth", nbytes(*bank_in, pcm_k), pcm_k.numel())
    for name, ms, plain_ms, bd in (
            ("mp2_unpack", unpack_ms, unpack_plain_ms, unpack_bd),
            ("mp2_synth", synth_ms, synth_plain_ms, synth_bd)):
        log(f"{name} [{card}] at the AHX bank shape ({B} x {Fb} frames, "
            f"sblimit {SB}): kernel {ms:.4f} ms, twin {plain_ms:.4f} ms "
            f"(one run), bound {bd['bound_ms']:.4f} ms by {bd['bound_by']}")
    return {"mp2_unpack": (unpack_ms, unpack_plain_ms, unpack_bd),
            "mp2_synth": (synth_ms, synth_plain_ms, synth_bd,
                          synth_library_ms)}


def synth_library(bank_in, pcm_k, MK, card: str) -> float:
    """mp2_synth's yardstick, timed from the dequantised samples s: one
    f64 torch.matmul of s by nt, then the window as one depthwise f64
    conv1d (64 channels, 16 taps, zero at the other parity's lags) and one
    add. Another summation order than the kernel's, so its PCM is checked
    to lie within 1 LSB of the kernel's. Never called by the port."""
    codes, levels, sfidx = bank_in
    B, F, C = codes.shape[:3]
    sf_t, nt, dwin = MK._tables(codes.device)
    n = levels.double()[:, :, :, None, :]
    part = torch.arange(36, device=codes.device) // 12
    sf = sf_t[sfidx.long()][:, :, :, part, :]
    c = codes.to(torch.int32).double()
    s = torch.where(n > 0, ((2.0 * c + 1.0 - n) / n) * sf, 0.0)
    s = s.permute(0, 2, 1, 3, 4).reshape(B * C, F * 36, 32).contiguous()
    # conv1d correlates: out[t] = sum_i w[i] * V[t + i - 15], lag 15 - i
    w = torch.zeros((64, 1, 16), dtype=torch.float64, device=codes.device)
    for m in range(8):
        w[:32, 0, 15 - 2 * m] = dwin[64 * m:64 * m + 32]
        w[32:, 0, 14 - 2 * m] = dwin[64 * m + 32:64 * m + 64]

    def library():
        v = torch.matmul(s, nt).transpose(1, 2)             # [BC, 64, T]
        y = torch.nn.functional.conv1d(
            torch.nn.functional.pad(v, (15, 0)), w, groups=64)
        return y[:, :32] + y[:, 32:]

    o = library()
    pcm = torch.floor(o * 32768.0 + 0.5).clamp(-32768.0, 32767.0)
    pcm = pcm.transpose(1, 2).reshape(B, C, -1).to(torch.int16)
    d = max_abs_diff(pcm, pcm_k)
    if d > 1:
        raise AssertionError(f"mp2_synth's library yardstick is {d} LSB "
                             f"from the kernel")
    ms = cuda_ms(library, 20)
    log(f"mp2_synth library yardstick [{card}]: torch.matmul, depthwise "
        f"conv1d and an add, f64, {ms:.4f} ms, within {d} LSB of the "
        f"kernel")
    return ms


# ---------------------------------------------------------------------------
# B4/B5, the key search, the zero-coded_count decode (phase 14)
# ---------------------------------------------------------------------------

KEYSEARCH_FIXTURES = os.path.join(FIXTURES, "keysearch")
ZERO_CODED_STREAMS = 16


def extreme_spectra(g, shape, dev):
    """Random f32 spectra with extremes: +-1e30, zeros of both signs, a
    denormal, an all-zero row (no inf or NaN: the kernels' inputs are
    finite, and NaN never compares equal)."""
    x = torch.randn(shape, generator=g) * 3000
    flat = x.view(-1)
    flat[::97] = 0.0
    flat[1::97] = -0.0
    flat[2::211] = 1.0e30
    flat[3::211] = -1.0e30
    flat[4::307] = 1.0e-40
    x.view(-1, 128)[0] = 0.0
    return x.to(dev)


def wave_equal(what: str, a: torch.Tensor, b: torch.Tensor) -> float:
    """f32 tensors with equal values (torch.equal: +0.0 == -0.0, as B4's
    docstring allows); returns max |a - b| (0)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"{what}: shape/dtype differ")
    if not torch.equal(a, b):
        d = float((a.double() - b.double()).abs().max())
        raise AssertionError(f"{what}: kernel differs from its twin "
                             f"(max |diff| {d})")
    return 0.0


def key_search_rows(up, enc: bytes, keys, dev):
    """The key search's (key, frame) rows of the first two frames of `enc`
    under each key, deciphered and through B1: (dec u8 [2K, fs], res, cur),
    as `find_key`'s phase 1 makes them."""
    from pycricodecs_tpu_torch.ops import hca_frame
    from pycricodecs_tpu_torch.parallel import pipeline as P
    hs = int.from_bytes(enc[6:8], "big")
    fs = up.fs
    tables, tix = P._key_tables(hca_frame.parse_header(enc[:hs]), keys, 0,
                                dev)
    first = torch.from_numpy(np.frombuffer(enc, np.uint8, count=2 * fs,
                                           offset=hs).reshape(2, fs).copy())
    rows = first.to(dev).unsqueeze(0).expand(len(keys), 2, fs).reshape(-1, fs)
    dec = up.decipher(rows, tables, tix.repeat_interleave(2))
    _, res, _, cur, _ = up.side_info(dec)
    return dec, res, cur


def keysearch_phase(dev, card: str, worst: dict, launches: dict) -> dict:
    """Phase 14; returns name -> (ms, plain_ms, bound dict[, library_ms])."""
    import pycricodecs_tpu_torch as port
    from pycricodecs_tpu_torch.ops import hca_frame
    from pycricodecs_tpu_torch.ops import hca_kernels as K
    from pycricodecs_tpu_torch.ops import hca_unpack_device as U
    from pycricodecs_tpu_torch.parallel import pipeline as P

    with open(os.path.join(KEYSEARCH_FIXTURES, "expected.json")) as f:
        expected = json.load(f)
    spec = expected["find_key"]
    with open(os.path.join(FIXTURES, spec["stream"] + ".hca"), "rb") as f:
        plain = f.read()
    hs = int.from_bytes(plain[6:8], "big")
    info = hca_frame.parse_header(plain[:hs])
    C, F = info.channels, info.frame_count

    # B4 and B5 at the HCA bank chunk's shape, on its real spectra
    up = U.DeviceUnpacker(info, device=dev)
    n = info.frame_count * info.frame_size
    frames = np.frombuffer(plain, np.uint8, count=n, offset=hs).reshape(
        F, info.frame_size)
    chunk = torch.from_numpy(np.tile(frames, (P.CHUNK_STREAMS, 1))).to(dev)
    qc, sf, res, inten, err = up(chunk)
    if bool(err.any()):
        raise AssertionError("B1 flagged an error on the bank chunk")
    hfr, cfg = K.transform_config(info)
    B = P.CHUNK_STREAMS
    spectra = K.reconstruct_spectra(
        qc.view(B, F, C, 8, 128), sf.view(B, F, C, 128),
        res.view(B, F, C, 128), inten.view(B, F, C, 8), hfr, **cfg)
    spec_t = torch.movedim(spectra, 2, 1).reshape(B * C, F * 8, 128) \
        .contiguous()
    del qc, sf, res, inten, spectra
    wave_k = K.imdct_ola(spec_t)
    wave_t = K.imdct_ola_plain(spec_t)
    worst["hca_imdct_ola"] = wave_equal("B4 bank chunk", wave_k, wave_t)
    dct_k = K.imdct(spec_t)
    dct_t = K.imdct_butterflies(spec_t)
    worst["hca_imdct"] = wave_equal("B5 bank chunk", dct_k, dct_t)
    log(f"B4 and B5 at the bank chunk {tuple(spec_t.shape)}: equal to their "
        f"twins (f32 values)")
    del wave_t, dct_t
    g = torch.Generator().manual_seed(14)
    for shape in ((7, 1000, 128), (300, 8, 128), (1, 33, 128)):
        x = extreme_spectra(g, shape, dev)
        wave_equal(f"B4 random {shape}", K.imdct_ola(x), K.imdct_ola_plain(x))
        wave_equal(f"B5 random {shape}", K.imdct(x), K.imdct_butterflies(x))
        log(f"B4 and B5 on random spectra with extremes {shape}: equal to "
            f"their twins")

    # B2's end cursor against the twin's: the bank chunk, and the key
    # search's rows under 4,096 wrong keys (most run past the frame end)
    dec = up.decipher(chunk)
    _, res, _, cur, _ = up.side_info(dec)
    pairs = [("bank end", up.spectra(dec, res, cur)[1],
              up.spectra_plain(dec, res, cur)[1]),
             ("bank end, cursor-only", up.spectra(dec, res, cur, False)[1],
              up.spectra_plain(dec, res, cur)[1])]
    del chunk, dec
    enc = port.crypt(plain, True, hs, spec["cipher"], spec["key"])
    if sha(enc) != spec["enciphered_sha256"]:
        raise AssertionError("the enciphered bank stream differs from the "
                             "recorded hash")
    keys = np.random.default_rng(spec["seed"]).integers(
        1, 1 << 63, spec["candidates"]).astype(np.uint64)
    keys[spec["true_index"]] = spec["key"]
    if sha(keys.astype("<u8").tobytes()) != spec["candidates_sha256"]:
        raise AssertionError("the candidates differ from the recorded hash")
    probe = keys[:4096]
    tables, tix = P._key_tables(hca_frame.parse_header(enc[:hs]), probe, 0,
                                dev)
    rows = torch.from_numpy(np.ascontiguousarray(np.tile(
        np.frombuffer(enc, np.uint8, count=2 * info.frame_size, offset=hs),
        len(probe)).reshape(-1, info.frame_size))).to(dev)
    dec = up.decipher(rows, tables, tix.repeat_interleave(2))
    worst["hca_side_info"] = max(worst["hca_side_info"], side_info_equal(
        f"B1 key rows of {len(probe)} keys", up, dec))
    side = up.side_info(dec)
    qk, ek = up.spectra(dec, side[1], side[3])
    qt, et = up.spectra_plain(dec, side[1], side[3])
    ok = ~side[4]
    pairs += [("key rows end", ek, et), ("key rows qc", qk[ok], qt[ok])]
    worst["hca_coefficients"] = max(worst["hca_coefficients"],
                                    require_equal("B2 end cursor", pairs))
    past = int((et.long() + 14 > info.frame_size * 8).sum())
    log(f"B2 end cursor: bank chunk and {dec.shape[0]} key-search rows "
        f"({past} past the frame end) equal to the twin's, cursor-only too")
    del rows, dec, side, qk, qt

    # B2's cursor-only launch at phase 1's shape: KEY_ROWS (key, frame)
    # rows, the first KEY_ROWS / 2 candidates on the first two frames
    dec, res, cur = key_search_rows(up, enc, keys[:KEY_ROWS // 2], dev)
    full_end = up.spectra(dec, res, cur)[1]
    pairs = [("key-search rows, cursor-only end",
              up.spectra(dec, res, cur, False)[1], full_end)]
    worst["hca_coefficients"] = max(worst["hca_coefficients"],
                                    require_equal("B2 cursor-only", pairs))
    cursor_ms = cuda_ms(lambda: up.spectra(dec, res, cur, False), 10)
    log(f"hca_coefficients cursor-only [{card}] at {dec.shape[0]} "
        f"key-search rows: kernel {cursor_ms:.4f} ms (its end cursor equal "
        f"to the spectra launch's)")
    # B1 at the same rows: equal to its twin, then timed
    worst["hca_side_info"] = max(worst["hca_side_info"], side_info_equal(
        f"B1 at {dec.shape[0]} key-search rows", up, dec))
    side = up.side_info(dec)
    b1_ms = cuda_ms(lambda: up.side_info(dec), 10)
    b1_bd = bound("hca_side_info", side_info_bytes(up, side),
                  nbytes(*side[:3]))
    log(f"hca_side_info [{card}] at {dec.shape[0]} key-search rows: kernel "
        f"{b1_ms:.4f} ms, bound {b1_bd['bound_ms']:.4f} ms by "
        f"{b1_bd['bound_by']} (equal to the twin)")
    del dec, res, cur, full_end, pairs, side

    # the key search at full width: bench_all config 6's traffic
    cands = keys
    st = {}
    scores, counts = drive(
        "find_key", ("hca_side_info", "hca_coefficients", "hca_imdct_ola"),
        lambda: port.find_key(enc, cands, max_frames=spec["max_frames"],
                              device=dev, stats=st))
    launches["hca_imdct_ola"] = counts["hca_imdct_ola"]
    launches["hca_imdct"] = counts["hca_imdct"]
    if sha(scores.astype("<i8").tobytes()) != spec["scores_sha256"]:
        raise AssertionError("find_key scores differ from the JAX "
                             "package's")
    if port.rank_keys(scores)[0] != spec["true_index"]:
        raise AssertionError("find_key: the true key does not rank first")
    log(f"find_key: {len(cands)} candidates x {spec['max_frames']} frames "
        f"on the card, scores sha256 equal to the JAX package's, the true "
        f"key first (score {int(scores[spec['true_index']])}, "
        f"{int((scores >= 0).sum())} accepted); stages of that run (s): "
        f"{ {k: round(v, 4) for k, v in st.items()} }")
    port.find_key(enc, cands, max_frames=spec["max_frames"], device=dev)
    wall, runs = median_wall(lambda: port.find_key(
        enc, cands, max_frames=spec["max_frames"], device=dev))
    BANKS["find_key_s"] = wall
    log(f"find_key [{card}]: median of 3 = {wall:.4f} s for {len(cands)} "
        f"keys -> {len(cands) / wall:.1f} keys/s; runs "
        f"{[round(r, 4) for r in runs]}")
    st = {}
    port.find_key(enc, cands, max_frames=spec["max_frames"], device=dev,
                  stats=st)
    log(f"find_key [{card}] host/device split (s, each stage ended by a "
        f"synchronise): {st}")

    # the zero-coded_count stream through decode_batch
    zc = expected["zero_coded"]
    with open(os.path.join(KEYSEARCH_FIXTURES, zc["file"]), "rb") as f:
        zblob = f.read()
    if sha(zblob) != zc["hca_sha256"]:
        raise AssertionError(f"{zc['file']} differs from its hash")
    wavs, _ = drive("decode_batch (zero coded_count)",
                    ("hca_side_info", "hca_coefficients", "hca_transform"),
                    lambda: port.decode_batch([zblob] * ZERO_CODED_STREAMS,
                                              device=dev))
    if any(sha(w) != zc["wav_sha256"] for w in wavs):
        raise AssertionError("the zero-coded_count stream's WAV differs from "
                             "the JAX package's")
    log(f"zero coded_count: {ZERO_CODED_STREAMS} x {zc['file']} decoded on "
        f"the card, every WAV sha256 equal to the JAX package's")

    # times at the bank chunk's shape; B5's yardstick: one matmul by the
    # DCT-IV matrix (TF32 off), the same function in another rounding order;
    # B4's: the zero subframe padded in front (one call), each subframe
    # with the one before as a 256-value unfold view (no call), one matmul
    # by the folded 256 x 128 DCT-IV + overlap-add matrix
    values = spec_t.numel()
    ola_ms = cuda_ms(lambda: K.imdct_ola(spec_t), 20)
    ola_plain_ms = cuda_ms(lambda: K.imdct_ola_plain(spec_t), 3)
    dct_ms = cuda_ms(lambda: K.imdct(spec_t), 20)
    dct_plain_ms = cuda_ms(lambda: K.imdct_butterflies(spec_t), 3)
    matrix = K.imdct_butterflies(torch.eye(128)).to(dev)
    rows2d = spec_t.view(-1, 128)
    lib_ms = cuda_ms(lambda: torch.matmul(rows2d, matrix), 20)
    lib_err = float((torch.matmul(rows2d, matrix) - dct_k.view(-1, 128))
                    .abs().max())
    ola_matrix = K.imdct_ola_plain(torch.eye(256).view(256, 2, 128))[:, 1] \
        .contiguous().to(dev)

    def ola_library():
        x = torch.nn.functional.pad(spec_t, (0, 0, 1, 0))
        return torch.matmul(x.view(x.shape[0], -1).unfold(1, 256, 128),
                            ola_matrix)
    ola_lib_ms = cuda_ms(ola_library, 20)
    ola_lib_err = float((ola_library() - wave_k).abs().max())
    ola_bd = bound("hca_imdct_ola", nbytes(spec_t, wave_k), values)
    dct_bd = bound("hca_imdct", nbytes(spec_t, dct_k), values)
    for name, ms, plain_ms, bd in (
            ("hca_imdct_ola", ola_ms, ola_plain_ms, ola_bd),
            ("hca_imdct", dct_ms, dct_plain_ms, dct_bd)):
        log(f"{name} [{card}] at {tuple(spec_t.shape)}: kernel {ms:.4f} ms, "
            f"twin {plain_ms:.4f} ms, bound {bd['bound_ms']:.4f} ms by "
            f"{bd['bound_by']}")
    log(f"hca_imdct library yardstick [{card}]: torch.matmul by the 128 x 128 "
        f"DCT-IV matrix (TF32 off) {lib_ms:.4f} ms, max |diff| from B5 "
        f"{lib_err:.6g} (another summation order)")
    log(f"hca_imdct_ola library yardstick [{card}]: 2 calls, F.pad and "
        f"torch.matmul of the unfold view by the folded 256 x 128 matrix "
        f"(TF32 off) {ola_lib_ms:.4f} ms, max |diff| from B4 "
        f"{ola_lib_err:.6g} (another summation order)")
    return {"hca_imdct_ola": (ola_ms, ola_plain_ms, ola_bd, ola_lib_ms),
            "hca_imdct": (dct_ms, dct_plain_ms, dct_bd, lib_ms)}


# ---------------------------------------------------------------------------
# Banks, the single-file surfaces and the CLI (phase 15)
# ---------------------------------------------------------------------------

BANK_FIXTURES = os.path.join(FIXTURES, "bank")
HCA_KERNELS = ("hca_side_info", "hca_coefficients", "hca_transform")


def write_bank_awb(tmp: str, bank_expected: dict) -> str:
    """bank.acb and its sibling bank.awb (the port's build_afs2 of 256
    copies of the bank stream, held to the JAX build_afs2's hash) in tmp;
    returns the ACB's path."""
    from pycricodecs_tpu_torch.containers.awb import build_afs2
    e = bank_expected
    with open(os.path.join(BANK_FIXTURES, e["file"]), "rb") as f:
        acb = f.read()
    with open(os.path.join(FIXTURES, e["member"]), "rb") as f:
        track = f.read()
    awb = build_afs2([track] * e["tracks"])
    if sha(acb) != e["acb_sha256"] or sha(awb) != e["awb_sha256"]:
        raise AssertionError("bank.acb or the rebuilt bank.awb differs "
                             "from its recorded hash")
    with open(os.path.join(tmp, "bank.acb"), "wb") as f:
        f.write(acb)
    with open(os.path.join(tmp, e["name"] + ".awb"), "wb") as f:
        f.write(awb)
    log(f"bank.awb: {len(awb)} bytes ({e['tracks']} x {e['member']}), "
        f"sha256 equal to the JAX package's build_afs2")
    return os.path.join(tmp, "bank.acb")


def require_hashes(what: str, outs, want) -> None:
    got = [sha(o) for o in outs]
    bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
    if len(got) != len(want) or bad:
        raise AssertionError(f"{what}: outputs {bad[:8]} differ from the JAX "
                             f"package's ({len(got)} of {len(want)})")


def bank_phase(dev, card: str, hca_expected: dict) -> None:
    """Phase 15: decode_acb of the 256 x 10 s bank (BASELINE config 5)
    and of mixed.acb, decode_awb of subkey.awb, the single-file surfaces
    and the CLI in-process, each output held to the JAX package's hash."""
    import tempfile

    import pycricodecs_tpu_torch as port
    from pycricodecs_tpu_torch import __main__ as cli
    from pycricodecs_tpu_torch.containers.acb import ACB
    from pycricodecs_tpu_torch.models import adx as adx_model
    from pycricodecs_tpu_torch.models import hca as hca_model
    from pycricodecs_tpu_torch.utils import signals
    from pycricodecs_tpu_torch.utils.wav import write_wav

    with open(os.path.join(BANK_FIXTURES, "expected.json")) as f:
        expected = json.load(f)
    blobs = {}
    for name, e in expected.items():
        with open(os.path.join(BANK_FIXTURES, e["file"]), "rb") as f:
            blobs[name] = f.read()
    with tempfile.TemporaryDirectory() as tmp:
        # -- the 256 x 10 s bank through decode_acb ---------------------------
        acb_path = write_bank_awb(tmp, expected["bank"])
        want = [hca_expected[BANK]["wav_sha256"]] * expected["bank"]["tracks"]
        wavs, _ = drive("decode_acb (bank)", HCA_KERNELS,
                             lambda: port.decode_acb(acb_path, device=dev))
        require_hashes("decode_acb bank", wavs, want)
        del wavs
        log(f"decode_acb bank: {len(want)} x {hca_expected[BANK]['seconds']}"
            f" s WAVs, all sha256 equal to the JAX package's decode")

        def parse():
            acb = ACB(acb_path)
            return [len(m) for m in acb.awb.getfiles()]

        parse_s, parse_runs = median_wall(parse)
        port.decode_acb(acb_path, device=dev)                  # warm-up
        wall, runs = median_wall(
            lambda: port.decode_acb(acb_path, device=dev))
        BANKS["decode_acb_s"] = wall
        BANKS["decode_acb_parse_s"] = parse_s
        audio_s = len(want) * hca_expected[BANK]["seconds"]
        log(f"decode_acb bank [{card}]: median of 3 = {wall:.4f} s for "
            f"{audio_s:.0f} audio-s -> {audio_s / wall:.1f} audio-s/s; runs "
            f"{[round(r, 4) for r in runs]}; host layer, ACB + AWB parse and "
            f"member read: median {parse_s:.4f} s "
            f"({100 * parse_s / wall:.2f} % of the call), runs "
            f"{[round(r, 4) for r in parse_runs]}")

        # -- mixed.acb and subkey.awb -----------------------------------------
        mixed_path = os.path.join(tmp, "mixed.acb")
        with open(mixed_path, "wb") as f:
            f.write(blobs["mixed"])
        own = (*HCA_KERNELS, "adx_decode_host", "mp2_unpack", "mp2_synth")
        outs, _ = drive("decode_acb (mixed.acb)", own,
                             lambda: port.decode_acb(blobs["mixed"],
                                                     device=dev))
        require_hashes("decode_acb mixed.acb", outs,
                       expected["mixed"]["wav_sha256"])
        raw = port.decode_awb(ACB(blobs["mixed"]).awb, decode_non_hca=False,
                              device=dev)
        require_hashes("decode_awb mixed (decode_non_hca=False)", raw,
                       expected["mixed"]["no_non_hca_sha256"])
        log(f"decode_acb mixed.acb: {len(outs)} members "
            f"{expected['mixed']['members']}, all sha256 equal to the JAX "
            f"package's (and without the non-HCA decode)")
        e = expected["subkey"]
        outs, _ = drive("decode_awb (subkey.awb)", HCA_KERNELS,
                             lambda: port.decode_awb(blobs["subkey"],
                                                     key=e["key"],
                                                     device=dev))
        require_hashes("decode_awb subkey.awb", outs, e["wav_sha256"])
        log(f"decode_awb subkey.awb (subkey 0x{e['subkey']:04X}): all sha256 "
            f"equal to the JAX package's")

        # -- the single-file surfaces -------------------------------------------
        with open(os.path.join(ADX_FIXTURES, "expected.json")) as f:
            adx_expected = json.load(f)
        with open(os.path.join(AHX_FIXTURES, "expected.json")) as f:
            ahx_expected = json.load(f)
        adx_name, hca_name, enc_name = ("adx_m4_stereo_1s",
                                        "q4_stereo_48k_1s", "q2_mono_48k_1s")
        ahx_name = "ahx11_lsf_mono_22k_1s"

        def read(*parts):
            with open(os.path.join(*parts), "rb") as f:
                return f.read()

        adx_blob = read(ADX_FIXTURES, adx_name + ".adx")
        hca_blob = read(FIXTURES, hca_name + ".hca")
        ahx_blob = read(AHX_FIXTURES, ahx_expected[ahx_name]["file"])
        adx_wav = signals.adx_wav(adx_name, write_wav)
        hca_wav = signals.hca_wav(enc_name, write_wav)
        quality = hca_expected[enc_name]["quality"]

        def single():
            return [adx_model.decode(adx_blob, device=dev),
                    adx_model.encode(adx_wav, device=dev,
                                     **adx_expected[adx_name]["encode"]),
                    port.HCA(hca_blob, device=dev).decode(),
                    port.HCA(hca_wav, device=dev).encode(
                        quality_level=hca_model.CriHcaQuality(quality)),
                    port.AHX.decode(ahx_blob, device=dev)]

        outs, _ = drive("single-file surfaces",
                             (*HCA_KERNELS, "adx_decode_host", "adx_encode",
                              "hca_mdct", "hca_pack", "mp2_unpack",
                              "mp2_synth"), single)
        require_hashes("single-file surfaces", outs, [
            adx_expected[adx_name]["wav_sha256"],
            adx_expected[adx_name]["adx_sha256"],
            hca_expected[hca_name]["wav_sha256"],
            hca_expected[enc_name]["hca_sha256"],
            ahx_expected[ahx_name]["wav_sha256"]])
        log(f"single-file surfaces: models.adx.decode/encode ({adx_name}), "
            f"HCA.decode ({hca_name}), HCA.encode ({enc_name}, quality "
            f"{quality}), AHX.decode ({ahx_name}): sha256 equal to the JAX "
            f"package's")

        # -- the CLI, in-process --------------------------------------------
        out_dir = os.path.join(tmp, "cli_bank")
        cli.main(["bank-decode", mixed_path, "-o", out_dir])
        files = [read(out_dir, f"{i}.wav")
                 for i in range(len(expected["mixed"]["members"]))]
        require_hashes("CLI bank-decode mixed.acb", files,
                       expected["mixed"]["wav_sha256"])
        wav_path = os.path.join(tmp, "cli_q4.wav")
        cli.main(["decode", os.path.join(FIXTURES, hca_name + ".hca"), "-o",
                  wav_path])
        require_hashes("CLI decode", [read(wav_path)],
                       [hca_expected[hca_name]["wav_sha256"]])
        log("CLI in-process (bank-decode mixed.acb, decode "
            f"{hca_name}.hca): the files' sha256 equal to the JAX package's")


# ---------------------------------------------------------------------------
# AHX / MPEG Layer II encode (phase 16)
# ---------------------------------------------------------------------------

ENCODE_KERNELS = ("mp2_analysis", "mp2_allocate", "mp2_pack")
LOG10_VALUES = 1_000_000
# (label, channels, sample rate, kbps, joint bound, streams, frames) of the
# random-signal checks: every allocation table (LSF 4, MPEG-1 a/b/c/d),
# mono, stereo and joint bounds 4-16, odd frame counts (the last of K1's
# 72-row tiles half used), one frame, one stream
ENCODE_CASES = (
    ("LSF mono 16 kHz 64 kbps (table 4)", 1, 16000, 64, None, 3, 7),
    ("LSF mono 24 kHz 160 kbps (table 4)", 1, 24000, 160, None, 2, 5),
    ("LSF stereo 22.05 kHz 128 kbps (table 4)", 2, 22050, 128, None, 2, 3),
    ("MPEG-1 mono 48 kHz 32 kbps (table c)", 1, 48000, 32, None, 3, 5),
    ("MPEG-1 stereo 32 kHz 48 kbps (table d)", 2, 32000, 48, None, 2, 9),
    ("MPEG-1 stereo 48 kHz 384 kbps (table a)", 2, 48000, 384, None, 2, 3),
    ("MPEG-1 mono 32 kHz 320 kbps (table b)", 1, 32000, 320, None, 1, 17),
    ("MPEG-1 stereo 44.1 kHz 192 kbps (table b)", 2, 44100, 192, None, 3, 4),
    ("MPEG-1 joint 4 44.1 kHz 192 kbps", 2, 44100, 192, 4, 2, 5),
    ("MPEG-1 joint 8 48 kHz 256 kbps", 2, 48000, 256, 8, 2, 3),
    ("MPEG-1 joint 12 32 kHz 128 kbps", 2, 32000, 128, 12, 3, 2),
    ("MPEG-1 joint 16 44.1 kHz 320 kbps", 2, 44100, 320, 16, 1, 1),
)


# (label, channels, sample rate, kbps, joint bound, streams, frames, fields
# past the frame end) of K3's checks on random K2 outputs. "Past the grid":
# more frames than K3's persistent grid has warps on an H100 (132 SMs of 2
# CTAs of 8 warps for 1,728-byte stereo frames, 4 for mono), and a
# multiple of no grid of 1-6 such CTAs an SM
K3_RANDOM_CASES = (
    ("MPEG-1 stereo 32 kHz 384 kbps (1,728-byte frames), past the grid",
     2, 32000, 384, None, 2, 1601, False),
    ("MPEG-1 stereo 32 kHz 384 kbps, one frame", 2, 32000, 384, None, 1, 1,
     False),
    ("MPEG-1 joint 4 44.1 kHz 192 kbps", 2, 44100, 192, 4, 3, 5, False),
    ("LSF mono 22.05 kHz 96 kbps, past the grid", 1, 22050, 96, None, 3,
     2117, False),
    ("LSF mono 22.05 kHz 96 kbps, one frame", 1, 22050, 96, None, 1, 1,
     False),
    ("LSF mono 16 kHz 32 kbps, fields past the frame end", 1, 16000, 32,
     None, 2, 9, True),
    ("MPEG-1 joint 4 44.1 kHz 192 kbps, fields past the frame end", 2,
     44100, 192, 4, 2, 7, True),
)
#: distinct random frames a K3 case draws (tiled over its B x F)
K3_DRAWN = 257


def k3_frame_bits(alloc, scfsi, cfg) -> int:
    """The bits one frame's fields take ([C, 32] alloc and scfsi); a copy
    of tests/test_torch_mp2_encode_warp.py's frame_bits."""
    from pycricodecs_tpu_torch.ops import mp2_encode_device as E
    gbits, ubits = E.class_bits(cfg)
    bits = 32 + cfg.nbal_bits
    for sb in range(cfg.sblimit):
        for c in range(cfg.channels):
            a = int(alloc[c, sb])
            if a:
                bits += 2 + 6 * (3, 2, 1, 2)[scfsi[c, sb]]
                if c == 0 or sb < cfg.bound:
                    bits += 12 * (gbits[sb, a] or 3 * ubits[sb, a])
    return bits


def k3_random_frames(rng, cfg, F, overflow=False):
    """Random legal K2 outputs [F, ...] for cfg (a copy of
    tests/test_torch_mp2_encode_warp.py's random_frames): allocations drawn
    per subband's classes (the alloc as transmitted), dropped at random
    until the frame's fields fit its smallest size, codes below their
    class; with overflow, every slot allocated (a class from the upper
    half of its subband's) and nothing dropped."""
    C = cfg.channels
    SB = cfg.sblimit
    fs_bits = 8 * int(cfg.frame_plan(1)[1][0])
    alloc = np.zeros((F, C, 32), np.uint8)
    for sb in range(SB):
        low = max(1, cfg.ncls[sb] // 2) if overflow else 0
        alloc[:, :, sb] = rng.integers(low, cfg.ncls[sb], (F, C)) * \
            (overflow | (rng.random((F, C)) < 0.6))
    scfsi = rng.integers(0, 4, (F, C, 32)).astype(np.uint8)
    for f in range(F):
        if cfg.joint:
            alloc[f, 1, cfg.bound:SB] = alloc[f, 0, cfg.bound:SB]
        while not overflow and k3_frame_bits(alloc[f], scfsi[f], cfg) > \
                fs_bits:
            sb = rng.integers(0, SB)
            alloc[f, :, sb] = 0 if sb >= cfg.bound else \
                alloc[f, :, sb] * (rng.random(C) < 0.5)
    sfidx = rng.integers(0, 63, (F, C, 3, 32)).astype(np.uint8)
    lv = cfg.levels_tbl[np.arange(32), alloc.astype(np.int64)]   # [F, C, 32]
    codes = (rng.random((F, C, 36, 32)) * np.maximum(lv, 1)[:, :, None, :]) \
        .astype(np.uint16)
    return alloc, scfsi, sfidx, codes


def poisoned_free(n: int):
    """Empty PyTorch's cache, fill a fresh CUDA tensor of n bytes with
    0xA5 and free it, so that the next allocation of at most n bytes is
    likely handed that memory; returns its (start, end) addresses."""
    torch.cuda.empty_cache()
    t = torch.full((n,), 0xA5, dtype=torch.uint8, device="cuda")
    span = (t.data_ptr(), t.data_ptr() + n)
    torch.cuda.synchronize()
    del t
    return span


def k3_random_checks(dev, worst: dict) -> None:
    """K3 alone against `pack_plain` on K3_RANDOM_CASES, through the
    wrapper into freed poisoned memory and through the C entry into a
    0xA5-filled output."""
    from pycricodecs_tpu_torch import _build
    from pycricodecs_tpu_torch.ops import cuda_kernels
    from pycricodecs_tpu_torch.ops import mp2_encode_device as E
    from pycricodecs_tpu_torch.ops import mp2_encode_host
    rng = np.random.default_rng(17)
    landed = 0
    for label, C, rate, kbps, jb, B, F, overflow in K3_RANDOM_CASES:
        cfg = mp2_encode_host.configure(C, rate, kbps, jb)
        drawn = k3_random_frames(rng, cfg, min(B * F, K3_DRAWN), overflow)
        alloc, scfsi, sfidx, codes = (
            torch.from_numpy(np.resize(x, (B, F) + x.shape[1:])).to(dev)
            for x in drawn)
        pads, sizes, _ = cfg.frame_plan(F)
        offs = E.frame_offsets(sizes)
        need = max(k3_frame_bits(drawn[0][i], drawn[1][i], cfg)
                   for i in range(len(drawn[0])))
        if overflow and need <= 8 * int(sizes.min()):
            raise AssertionError(f"K3 {label}: no field passes a frame end")
        pads_d = torch.from_numpy(pads).to(dev)
        offs_d = torch.from_numpy(offs).to(dev)
        ctab = E.pack_tables(cfg, dev)
        kw = dict(sblimit=cfg.sblimit, bound=cfg.bound,
                  header_base=cfg.header_base, total=int(offs[-1]),
                  max_frame=int(sizes.max()))
        twin = E.pack_plain(alloc, scfsi, sfidx, codes, cfg, pads_d, sizes)
        lo, hi = poisoned_free(twin.numel() + (1 << 16))
        got = cuda_kernels.mp2_pack(alloc, scfsi, sfidx, codes, pads_d,
                                    offs_d, ctab, **kw)
        landed += lo <= got.data_ptr() and got.data_ptr() + got.numel() <= hi
        filled = torch.full_like(twin, 0xA5)
        rc = _build.load().mp2_pack(
            cuda_kernels.ptr(alloc), cuda_kernels.ptr(scfsi),
            cuda_kernels.ptr(sfidx), cuda_kernels.ptr(codes),
            cuda_kernels.ptr(pads_d), cuda_kernels.ptr(offs_d), B, F, C,
            cfg.sblimit, cfg.bound, cfg.header_base, cuda_kernels.ptr(ctab),
            int(offs[-1]), int(sizes.max()), cuda_kernels.ptr(filled),
            cuda_kernels.stream_ptr(filled))
        if rc:
            raise AssertionError(f"K3 {label}: the C entry returned {rc}")
        worst["mp2_pack"] = max(worst["mp2_pack"], require_equal(
            f"K3 {label}", [("frames (wrapper)", got, twin),
                            ("frames (into 0xA5)", filled, twin)]))
        log(f"K3 random {label}, {B} x {F} frames of {int(sizes.min())}-"
            f"{int(sizes.max())} bytes (up to {need} bits of fields): "
            f"byte-equal to the twin, into poisoned memory")
    log(f"K3 random checks: {landed} of {len(K3_RANDOM_CASES)} wrapper "
        f"outputs lay inside the freed 0xA5 tensor; every C-entry output "
        f"was 0xA5-filled")


#: (channels, sample rate, kbps, joint bound) pairs of one channel count
#: and two frame sizes that K3_THREAD_ROUNDS of turns launch from two host
#: threads: 1,728 and 626-627 bytes, stereo; 864 and 288 bytes, mono
K3_THREAD_PAIRS = (((2, 32000, 384, None), (2, 44100, 192, 4)),
                   ((1, 32000, 192, None), (1, 16000, 32, None)))
K3_THREAD_ROUNDS = 4


def k3_thread_checks(dev, worst: dict) -> None:
    """K3 from two host threads that take turns, the first packing the
    larger frames, the second the smaller ones of the same channel count:
    the launch's shared-memory limit is the kernel's on the device for the
    whole process, so one thread's launch must not lower it under the
    other's. Each output is held to `pack_plain`."""
    import threading
    from pycricodecs_tpu_torch.ops import cuda_kernels
    from pycricodecs_tpu_torch.ops import mp2_encode_device as E
    from pycricodecs_tpu_torch.ops import mp2_encode_host
    rng = np.random.default_rng(18)
    for pair in K3_THREAD_PAIRS:
        calls, twins = [], []
        for args in pair:
            cfg = mp2_encode_host.configure(*args)
            side = tuple(torch.from_numpy(x.reshape((2, 3) + x.shape[1:]))
                         .to(dev) for x in k3_random_frames(rng, cfg, 6))
            pads, sizes, _ = cfg.frame_plan(3)
            offs = E.frame_offsets(sizes)
            pads_d = torch.from_numpy(pads).to(dev)
            offs_d = torch.from_numpy(offs).to(dev)
            kw = dict(sblimit=cfg.sblimit, bound=cfg.bound,
                      header_base=cfg.header_base, total=int(offs[-1]),
                      max_frame=int(sizes.max()))
            ctab = E.pack_tables(cfg, dev)
            twins.append(E.pack_plain(*side, cfg, pads_d, sizes))
            calls.append(lambda side=side, pads_d=pads_d, offs_d=offs_d,
                         ctab=ctab, kw=kw: cuda_kernels.mp2_pack(
                             *side, pads_d, offs_d, ctab, **kw))
        outs = ([], [])
        errors = [None, None]
        turns = threading.Barrier(2)

        def run(k):
            try:
                torch.cuda.set_device(dev)
                for _ in range(K3_THREAD_ROUNDS):
                    for turn in range(2):
                        if turn == k:
                            outs[k].append(calls[k]())
                            torch.cuda.synchronize()
                        turns.wait()
            except BaseException as e:         # the other thread stops too
                errors[k] = e
                turns.abort()

        threads = [threading.Thread(target=run, args=(k,)) for k in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        first = next((e for e in errors
                      if not isinstance(e, threading.BrokenBarrierError)),
                     errors[0] or errors[1])
        if first is not None:
            raise AssertionError(f"K3 from two threads {pair}: {first!r}")
        worst["mp2_pack"] = max(worst["mp2_pack"], require_equal(
            f"K3 from two threads {pair}",
            [(f"thread {k} call {i}", got, twins[k])
             for k in (0, 1) for i, got in enumerate(outs[k])]))
        log(f"K3 from two threads taking {K3_THREAD_ROUNDS} turns each, "
            f"{pair}: byte-equal to the twin")


def random_encode_pcm(rng, B, C, F) -> np.ndarray:
    """PCM16 [B, C, F * 1152] of tones, noise and level jumps at random
    loudness per stream and channel; stream 0 ends in silence and, where
    B > 1, stream 1 is a full-scale square wave (both rails)."""
    n = F * 1152
    t = np.arange(n)
    pcm = np.zeros((B, C, n))
    for b in range(B):
        for c in range(C):
            f0 = rng.uniform(0.001, 0.45)
            sig = rng.uniform(0, 0.8) * np.sin(2 * np.pi * f0 * t)
            sig += rng.uniform(0, 0.3) * rng.standard_normal(n)
            sig *= np.repeat(rng.uniform(0, 1.5, -(-n // 384)), 384)[:n]
            pcm[b, c] = sig
    pcm[0, :, n // 2:] = 0.0
    if B > 1:
        pcm[1] = np.where((t // 37) % 2, 1.0, -1.0)
    return np.clip(np.round(pcm * 32767), -32768, 32767).astype(np.int16)


def f64_equal(what: str, a: torch.Tensor, b: torch.Tensor) -> float:
    """Two float64 tensors bit for bit; returns max |a - b| (0.0)."""
    if a.shape != b.shape or not torch.equal(a.view(torch.int64),
                                             b.view(torch.int64)):
        d = float((a - b).abs().max()) if a.shape == b.shape else "shape"
        raise AssertionError(f"{what}: differs from its twin (max |diff| "
                             f"{d})")
    return 0.0


def encode_pairs(worst: dict, label: str, pcm, cfg):
    """K1, K2 and K3 against their twins on `pcm`, each twin fed the
    kernel's input; returns (S, part peaks, frame peaks, need, K2 outputs,
    K3 bytes)."""
    from pycricodecs_tpu_torch.ops import cuda_kernels
    from pycricodecs_tpu_torch.ops import mp2_encode_device as E
    from pycricodecs_tpu_torch.ops import mp2_kernels as MK
    S, part, peaks = cuda_kernels.mp2_analysis(pcm)
    worst["mp2_analysis"] = max(worst["mp2_analysis"], f64_equal(
        f"K1 {label}", S, MK.analyze_plain(pcm)), f64_equal(
        f"K1 part peaks {label}", part, E.part_peaks_plain(S)), f64_equal(
        f"K1 frame peaks {label}", peaks, E.frame_peaks_plain(S)))
    need = E.need_db_host(peaks)
    F = S.shape[2] // 36
    pads, sizes, budgets = cfg.frame_plan(F)
    bud = torch.from_numpy(budgets).to(pcm.device)
    got = E.allocate(S, part, need, bud, cfg)
    want = E.allocate_plain(S, part, need, bud, cfg)
    worst["mp2_allocate"] = max(worst["mp2_allocate"], require_equal(
        f"K2 {label}", [(n, a.view(torch.int16) if a.dtype == torch.uint16
                         else a, b.view(torch.int16) if b.dtype ==
                         torch.uint16 else b)
                        for n, a, b in zip(("alloc", "scfsi", "sfidx",
                                            "codes"), got, want)]))
    frames = E.pack(*got, cfg, pads, sizes)
    worst["mp2_pack"] = max(worst["mp2_pack"], require_equal(
        f"K3 {label}", [("frames", frames, E.pack_plain(
            *got, cfg, torch.from_numpy(pads).to(pcm.device), sizes))]))
    return S, part, peaks, need, got, frames


def log10_check(dev, peaks: torch.Tensor) -> int:
    """How many values torch.log10 on the card and np.log10 on the host
    give differently, over every peak of the bank and LOG10_VALUES
    log-uniform values in [1e-9, 2]."""
    rng = np.random.default_rng(16)
    vals = np.exp(rng.uniform(np.log(1e-9), np.log(2.0), LOG10_VALUES))
    p = np.maximum(peaks.cpu().numpy().reshape(-1), 1e-9)
    counts = []
    for label, v in (("bank peaks", p), ("log-uniform", vals)):
        card = torch.log10(torch.from_numpy(v).to(dev)).cpu().numpy()
        n = int((card != np.log10(v)).sum())
        counts.append(n)
        log(f"log10: torch.log10 on the card differs from np.log10 on the "
            f"host on {n} of {v.size} {label}")
    log("need_db design: numpy's log10 on the host from K1's frame peaks "
        "(the reference's function; taken because CUDA's differs)"
        if sum(counts) else "need_db: CUDA's log10 agreed everywhere")
    return sum(counts)


def analysis_library(pcm, S_k, card: str) -> float:
    """K1's yardstick: the window fold in torch (analyze_plain's), then one
    f64 torch.matmul of Y by M.T (another summation order: checked within
    1e-12 of the kernel). Never called by the port."""
    from pycricodecs_tpu_torch.ops import mp2_tables
    B, C, N = pcm.shape
    Tn = N // 32
    win = torch.from_numpy(mp2_tables.analysis_window()).to(pcm.device)
    MT = torch.from_numpy(np.ascontiguousarray(
        mp2_tables.analysis_matrix().T)).to(pcm.device)

    def library():
        x32r = torch.nn.functional.pad(pcm.double() / 32768.0, (512, 0)) \
            .reshape(B, C, Tn + 16, 32).flip(-1)
        Y = torch.zeros((B, C, Tn, 64), dtype=torch.float64,
                        device=pcm.device)
        for h in range(2):
            for r in range(8):
                w = win[32 * h + 64 * r:32 * h + 64 * r + 32]
                s0 = 16 - h - 2 * r
                Y[..., 32 * h:32 * h + 32] += w * x32r[..., s0:s0 + Tn, :]
        return torch.matmul(Y, MT)

    d = float((library() - S_k).abs().max())
    if d > 1e-12:
        raise AssertionError(f"K1's library yardstick is {d} from the "
                             f"kernel")
    ms = cuda_ms(library, 5)
    log(f"mp2_analysis library yardstick [{card}]: torch fold + one f64 "
        f"torch.matmul, {ms:.4f} ms, within {d:.3g} of the kernel")
    return ms


def encode_stage_split(dev, wav: bytes, cfg, card: str) -> None:
    """One bank encode in the steps of ahx_encode_batch, each ended by a
    synchronise: where the time goes, on the host clock."""
    from pycricodecs_tpu_torch.models import ahx as ahx_model
    from pycricodecs_tpu_torch.ops import mp2_encode_device as E
    from pycricodecs_tpu_torch.utils import wav as wavmod
    split = {}

    def lap(name, t0):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        split[name] = t1 - t0
        return t1

    t = time.perf_counter()
    parsed = [wavmod.parse_wav(wav) for _ in range(BANK_STREAMS)]
    n = parsed[0].pcm16.size
    F = -(-n // 1152)
    pcm = np.zeros((BANK_STREAMS, 1, F * 1152), np.int16)
    for i, w in enumerate(parsed):
        pcm[i, 0, :n] = w.pcm16
    t = lap("host: WAV parse and stacking", t)
    pcm_d = torch.from_numpy(pcm).to(dev)
    t = lap("H2D of the PCM", t)
    S, part, peaks = E.analysis(pcm_d)
    t = lap("K1 mp2_analysis (spectra, part and frame peaks)", t)
    need = E.need_db_host(peaks)
    t = lap("host: peaks D2H, numpy log10, need_db H2D", t)
    pads, sizes, budgets = cfg.frame_plan(F)
    out = E.allocate(S, part, need, torch.from_numpy(budgets).to(dev), cfg)
    t = lap("K2 mp2_allocate (allocation, quantisation)", t)
    frames = E.pack(*out, cfg, pads, sizes)
    t = lap("K3 mp2_pack", t)
    data = frames.cpu().numpy()
    t = lap("D2H of the frames", t)
    offs = E.frame_offsets(sizes)
    [ahx_model.ahx_container(data[b, :offs[F]].tobytes(), 22050, n)
     for b in range(BANK_STREAMS)]
    lap("host: cut and AHX container", t)
    total = sum(split.values())
    log(f"AHX encode bank stage split [{card}] (one run, synchronised after "
        f"each step, {total:.4f} s): " + "; ".join(
            f"{k} {v:.4f} s ({100 * v / total:.1f} %)"
            for k, v in split.items()))


K2_PARTS = ("quantisation", "greedy loop", "prologue, S stream and stores")


def k2_ablation(k2, itab, bud, reps: int = 10) -> dict:
    """K2's ablation by its inputs, in ms (CUDA events, median of reps):
    the whole call, the class levels zeroed (the greedy loop runs step for
    step, as the loop reads no levels; nothing is quantised), then the
    budgets zeroed as well (the loop's first step allocates nothing); the
    differences are K2_PARTS. k2(budgets=..., classes=...) launches K2 with
    the bank's other inputs."""
    no_levels = itab.clone()
    no_levels[:32 * 16] = 0
    whole = cuda_ms(k2, reps)
    loop = cuda_ms(lambda: k2(classes=no_levels), reps)
    bare = cuda_ms(lambda: k2(budgets=torch.zeros_like(bud),
                              classes=no_levels), reps)
    return {"whole": whole, "levels_zeroed": loop,
            "levels_budgets_zeroed": bare, K2_PARTS[0]: whole - loop,
            K2_PARTS[1]: loop - bare, K2_PARTS[2]: bare}


def ahx_encode_phase(dev, card: str, worst: dict, launches: dict) -> dict:
    """Phase 16; returns name -> (ms, plain_ms, bound dict[, library])."""
    import tempfile

    import pycricodecs_tpu_torch as port
    from pycricodecs_tpu_torch.models import ahx as ahx_model
    from pycricodecs_tpu_torch.ops import cuda_kernels
    from pycricodecs_tpu_torch.ops import mp2_encode_device as E
    from pycricodecs_tpu_torch.ops import mp2_encode_host
    from pycricodecs_tpu_torch.ops import mp2_kernels as MK
    from pycricodecs_tpu_torch.utils import signals
    from pycricodecs_tpu_torch.utils.wav import write_wav

    expected, _ = load_ahx_fixtures()
    # -- K1, K2, K3 against their twins on random signals -----------------
    rng = np.random.default_rng(16)
    for label, C, rate, kbps, jb, B, F in ENCODE_CASES:
        cfg = mp2_encode_host.configure(C, rate, kbps, jb)
        pcm = torch.from_numpy(random_encode_pcm(rng, B, C, F)).to(dev)
        encode_pairs(worst, f"random {label}", pcm, cfg)
        log(f"K1/K2/K3 random {label}, {B} x {F} frames (table "
            f"{cfg.hdr.table_id}, sblimit {cfg.sblimit}, bound {cfg.bound}):"
            f" bit- and byte-equal to the twins")
    k3_random_checks(dev, worst)
    k3_thread_checks(dev, worst)

    # -- the bank shape -----------------------------------------------------
    bank_name = signals.AHX_BANK
    bank_pcm = signals.ahx_bank_pcm()
    n = bank_pcm.size
    F = -(-n // 1152)
    cfg = mp2_encode_host.configure(1, 22050, 96)
    x = np.zeros((BANK_STREAMS, 1, F * 1152), np.int16)
    x[:, 0, :n] = bank_pcm
    pcm = torch.from_numpy(x).to(dev)
    S, part, peaks, need, out, frames = encode_pairs(worst, "bank", pcm,
                                                     cfg)
    offs = E.frame_offsets(cfg.frame_plan(F)[1])
    want = expected[bank_name]["stream_sha256"]
    for b in (0, BANK_STREAMS - 1):
        if sha(ahx_model.ahx_container(frames[b].cpu().numpy().tobytes(),
                                       22050, n)) != want:
            raise AssertionError("K3's bank frames differ from the JAX hash")
    log(f"K1/K2/K3 bank {BANK_STREAMS} x {F} frames: bit- and byte-equal "
        f"to the twins")
    n_log10 = log10_check(dev, peaks)

    # -- the main path: ahx_encode_batch of the bank -------------------------
    wav = write_wav(bank_pcm, 1, 22050)
    streams, counts = drive("ahx_encode_batch", ENCODE_KERNELS,
                            lambda: port.ahx_encode_batch(
                                [wav] * BANK_STREAMS, 96, device=dev))
    for k in ENCODE_KERNELS:
        launches[k] = counts[k]
    require_hashes("ahx_encode_batch bank", streams, [want] * BANK_STREAMS)
    log(f"AHX encode bank: {BANK_STREAMS} x 10 s encoded on the card, every "
        f"AHX sha256 equal to the JAX package's AHX.encode "
        f"({sum(len(s) for s in streams)} bytes)")
    del streams

    # -- the 1 s fixtures, AHX.encode and the CLI ------------------------------
    tones = signals.tones
    enc = lambda *a, **k: ahx_model.encode_mp2(*a, device=dev, **k)  # noqa
    ahx = lambda pcm, rate, **k: port.AHX.encode(                    # noqa
        write_wav(pcm.reshape(-1), 1, rate), device=dev, **k)
    fixtures = {
        "ahx10_lsf_mono_16k_1s": lambda: ahx(tones(1.0, 1, 16000, 11),
                                             16000, AhxVersion=0x10),
        "ahx11_lsf_mono_22k_1s": lambda: ahx(tones(1.0, 1, 22050, 12),
                                             22050, bitrate_kbps=64),
        "mp2_lsf_mono_24k_1s": lambda: enc(tones(1.0, 1, 24000, 13)[0],
                                           24000),
        "mp2_stereo_44k_192k_1s": lambda: enc(tones(1.0, 2, 44100, 14),
                                              44100, bitrate_kbps=192),
        "mp2_joint8_44k_192k_1s": lambda: enc(tones(1.0, 2, 44100, 15),
                                              44100, bitrate_kbps=192,
                                              joint_bound=8),
        "mp2_vbr_lsf_mono_22k_1s": lambda: (
            enc(tones(0.5, 1, 22050, 17)[0], 22050, bitrate_kbps=64)
            + enc(tones(0.5, 1, 22050, 18)[0], 22050, bitrate_kbps=96)),
    }
    for name, fn in fixtures.items():
        if sha(fn()) != expected[name]["stream_sha256"]:
            raise AssertionError(f"{name}: the encode differs from the JAX "
                                 f"package's")
        log(f"AHX encode fixture {name}: sha256 equal to the JAX package's")
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "in.wav")
        with open(src, "wb") as f:
            f.write(write_wav(tones(1.0, 1, 22050, 12).reshape(-1), 1, 22050))
        dst = os.path.join(tmp, "out.ahx")
        proc = subprocess.run([sys.executable, "-m", "pycricodecs_tpu_torch",
                               "encode", src, "-o", dst, "--format", "ahx",
                               "--bitrate", "64"], cwd=ROOT, timeout=300,
                              capture_output=True, text=True)
        if proc.returncode:
            raise AssertionError(f"CLI encode --format ahx exited "
                                 f"{proc.returncode}: {proc.stderr[-2000:]}")
        with open(dst, "rb") as f:
            if sha(f.read()) != \
                    expected["ahx11_lsf_mono_22k_1s"]["stream_sha256"]:
                raise AssertionError("CLI encode --format ahx differs from "
                                     "the JAX package's")
    log("CLI `python -m pycricodecs_tpu_torch encode --format ahx` on the "
        "card: sha256 equal to the JAX package's")

    # -- timings --------------------------------------------------------------
    batch = [wav] * BANK_STREAMS
    port.ahx_encode_batch(batch, 96, device=dev)             # warm-up
    wall, runs = median_wall(lambda: port.ahx_encode_batch(batch, 96,
                                                           device=dev))
    BANKS["ahx_encode_batch_s"] = wall
    audio_s = BANK_STREAMS * 10.0
    log(f"AHX encode bank [{card}]: median of 3 = {wall:.4f} s for "
        f"{audio_s:.0f} audio-s -> {audio_s / wall:.1f} audio-s/s; runs "
        f"{[round(r, 4) for r in runs]}")
    encode_stage_split(dev, wav, cfg, card)
    pads, sizes, budgets = cfg.frame_plan(F)
    bud = torch.from_numpy(budgets).to(dev)
    itab, snr = E.device_tables(cfg, dev)
    ctab = E.pack_tables(cfg, dev)
    offs_d = torch.from_numpy(offs).to(dev)
    pads_d = torch.from_numpy(pads).to(dev)
    k1_ms = cuda_ms(lambda: cuda_kernels.mp2_analysis(pcm), 10)

    def k2(budgets=bud, classes=itab):
        return cuda_kernels.mp2_allocate(
            S, part, need, budgets, classes, snr, sblimit=cfg.sblimit,
            bound=cfg.bound, joint=cfg.joint)

    abl = k2_ablation(k2, itab, bud)
    k2_ms = abl["whole"]
    def k3():
        return cuda_kernels.mp2_pack(
            *out, pads_d, offs_d, ctab, sblimit=cfg.sblimit,
            bound=cfg.bound, header_base=cfg.header_base,
            total=int(offs[-1]), max_frame=int(sizes.max()))

    k3_ms = cuda_ms(k3, 10)
    k3_b2b = cuda_ms(lambda: [k3() for _ in range(10)], 5) / 10
    log(f"mp2_pack [{card}]: {k3_ms:.4f} ms a call through the wrapper "
        f"(the host's enqueue included), {k3_b2b:.4f} ms a launch of 10 "
        f"enqueued back to back")

    def k1_twins():
        S_p = MK.analyze_plain(pcm)
        return S_p, E.part_peaks_plain(S_p), E.frame_peaks_plain(S_p)

    _, k1_plain = cuda_ms_once(k1_twins)
    _, k2_plain = cuda_ms_once(lambda: E.allocate_plain(S, part, need, bud,
                                                        cfg))
    _, k3_plain = cuda_ms_once(lambda: E.pack_plain(*out, cfg, pads_d,
                                                    sizes))
    k1_library = analysis_library(pcm, S, card)
    alloc, scfsi, sfidx, codes = out
    levels = torch.from_numpy(cfg.levels_tbl).to(dev)
    coded = int((levels[torch.arange(32, device=dev), alloc.long()] > 0)
                .sum()) * 36
    bd = {
        "mp2_analysis": bound("mp2_analysis", nbytes(pcm, S, part, peaks),
                              pcm.numel()),
        "mp2_allocate": bound("mp2_allocate",
                              nbytes(S, part, need, bud, *out), coded),
        "mp2_pack": bound("mp2_pack", nbytes(*out, pads_d, offs_d, frames),
                          coded),
    }
    parts = {k: abl[k] for k in K2_PARTS}
    log(f"K2 ablation [{card}] at the bank shape: whole {k2_ms:.4f} ms; "
        f"levels zeroed {abl['levels_zeroed']:.4f} ms; levels and budgets "
        f"zeroed {abl['levels_budgets_zeroed']:.4f} ms -> " + "; ".join(
            f"{k} {v:.4f} ms" for k, v in parts.items())
        + f"; most: {max(parts, key=parts.get)}; {coded} codes quantised; "
        f"log10 differences {n_log10}")
    res = {"mp2_analysis": (k1_ms, k1_plain, bd["mp2_analysis"], k1_library),
           "mp2_allocate": (k2_ms, k2_plain, bd["mp2_allocate"]),
           "mp2_pack": (k3_ms, k3_plain, bd["mp2_pack"])}
    kernel_total = k1_ms + k2_ms + k3_ms
    for name, (ms, plain_ms, b_, *_) in res.items():
        log(f"{name} [{card}] at the AHX encode bank shape ({BANK_STREAMS} "
            f"x {F} frames): kernel {ms:.4f} ms, twin {plain_ms:.4f} ms (one"
            f" run), bound {b_['bound_ms']:.4f} ms by {b_['bound_by']}")
    log(f"AHX encode bank [{card}]: K1-K3 {kernel_total:.4f} ms of the "
        f"{wall * 1e3:.1f} ms call ({100 * kernel_total / (wall * 1e3):.2f} "
        f"%)")
    return res


# ---------------------------------------------------------------------------
# The remaining single-device surfaces (phase 17)
# ---------------------------------------------------------------------------

SURFACE_FIXTURES = os.path.join(FIXTURES, "surfaces")
B1_B2 = ("hca_side_info", "hca_coefficients")


def pcm_record(pcm: np.ndarray) -> dict:
    pcm = np.ascontiguousarray(pcm)
    if pcm.dtype != np.int16:
        raise AssertionError(f"expected int16 samples, got {pcm.dtype}")
    return {"sha256": sha(pcm.tobytes()), "shape": list(pcm.shape)}


def require_record(what: str, pcm: np.ndarray, rec: dict) -> None:
    got = pcm_record(pcm)
    want = {"sha256": rec["sha256"], "shape": rec["shape"]}
    if got != want:
        raise AssertionError(f"{what}: {got} differs from the JAX "
                             f"package's {want}")


def afs2_members(awb: bytes) -> list:
    """The members of an AFS2 bank exactly as built: each from its aligned
    start to the next raw offset (AWB.getfiles keeps the padding)."""
    import struct
    (_, _, osize, isize, n, align, _) = struct.unpack_from("<4sBBHIHH", awb)
    code = {2: "H", 4: "I", 8: "Q"}[osize]
    raw = struct.unpack_from("<" + code * (n + 1), awb, 16 + isize * n)
    return [awb[-(-raw[i] // align) * align:raw[i + 1]] for i in range(n)]


def thread_test_block(info, enc: bytes, dev) -> list:
    """(score, state) of ops.hca_frame.test_block_state threaded from 1
    over every frame of enc, one call a frame on `dev`."""
    from pycricodecs_tpu_torch.ops import hca_frame
    hs, fs = info.header_size, info.frame_size
    state, pairs = 1, []
    for f in range(info.frame_count):
        score, state = hca_frame.test_block_state(
            info, enc[hs + f * fs:hs + (f + 1) * fs], state, device=dev)
        pairs.append((score, state))
    return pairs


def surfaces_phase(dev, card: str) -> None:
    """Phase 17: decode_range / decode_frames_to_pcm, test_block_state,
    decode_mp2, the UTF/AWB/ACB builders and the graft entry on the card,
    each held to the JAX package's recorded values (and the decodes to the
    same call on the CPU)."""
    import tempfile

    import __graft_entry_torch__ as graft
    from pycricodecs_tpu_torch.containers.acb import ACB, ACBBuilder
    from pycricodecs_tpu_torch.containers.awb import AWBBuilder
    from pycricodecs_tpu_torch.models import ahx as ahx_model
    from pycricodecs_tpu_torch.models import hca as hca_model
    from pycricodecs_tpu_torch.ops import hca_frame

    with open(os.path.join(SURFACE_FIXTURES, "expected.json")) as f:
        expected = json.load(f)
    cpu = torch.device("cpu")

    def read(*parts):
        with open(os.path.join(*parts), "rb") as f:
            return f.read()

    # -- (a) decode_range / decode_frames_to_pcm -----------------------------
    e = expected["decode_range"]
    plain = read(FIXTURES, e["stream"] + ".hca")
    hs = int.from_bytes(plain[6:8], "big")
    enc = hca_model.crypt(plain, True, hs, 56, e["enciphered_key"])
    if sha(enc) != e["enciphered_sha256"]:
        raise AssertionError("the enciphered bank stream differs from the "
                             "JAX package's")
    key = e["enciphered_key"]
    cases = [(f"decode_range {e['stream']} ({a}, {b})", rec,
              lambda a=a, b=b, d=None: hca_model.decode_range(
                  plain, a, b, device=d)) for a, b, rec in e["ranges"]]
    cases += [(f"decode_range enciphered ({a}, {b})", rec,
               lambda a=a, b=b, d=None: hca_model.decode_range(
                   enc, a, b, key, device=d))
              for a, b, rec in e["enciphered_ranges"]]
    p = expected["decode_frames_to_pcm"]
    pns = read(FIXTURES, p["stream"] + ".hca")
    pinfo = hca_frame.parse_header(pns[:int.from_bytes(pns[6:8], "big")])
    cases += [(f"decode_frames_to_pcm {p['stream']} random_state "
               f"0x{state:X}", rec,
               lambda state=state, d=None: hca_model.decode_frames_to_pcm(
                   pinfo, pns[pinfo.header_size:], state, device=d))
              for state, rec in p["random_states"]]
    counts = {}
    for what, rec, fn in cases:
        own = HCA_KERNELS if rec["shape"][0] else ()
        out, counts[what] = drive(what, own, lambda: fn(d=dev))
        require_record(what, out, rec)
        if not np.array_equal(fn(d=cpu), out):
            raise AssertionError(f"{what}: the card and the CPU differ")
    log(f"(a) {len(cases)} decode_range / decode_frames_to_pcm calls: "
        f"sha256 equal to the JAX package's and to device='cpu'")
    def full():
        return hca_model.decode_range(plain, 0, -1, device=dev)

    full()
    wall, runs = median_wall(full)
    BANKS["decode_range_full_s"] = wall
    log(f"(a) decode_range of the full {e['stream']} [{card}]: median of 3 "
        f"= {wall:.4f} s; runs {[round(r, 4) for r in runs]}")

    # -- (b) test_block_state over every frame, true and wrong keys ----------
    t = expected["test_block_state"]
    per_frame = {}
    for k, rec in t["keys"].items():
        info = hca_frame.parse_header(enc[:hs])
        info.set_key(int(k, 16))
        own = (*B1_B2, "hca_imdct_ola") if k == t["true_key"] else B1_B2
        pairs, counts[f"test_block_state {k}"] = drive(
            f"test_block_state {k}", own,
            lambda: thread_test_block(info, enc, dev))
        got = sha(np.asarray(pairs, "<i8").tobytes())
        if got != rec["pairs_sha256"]:
            raise AssertionError(f"test_block_state {k}: the (score, state) "
                                 f"pairs differ from the JAX package's")
        scores, states = hca_frame.score_frames(
            info, enc[hs:hs + info.frame_count * info.frame_size], 1,
            device=dev)
        pairs2 = np.stack([scores, states], 1).astype("<i8")
        if sha(pairs2.tobytes()) != rec["pairs_sha256"]:
            raise AssertionError(f"score_frames {k}: differs from the "
                                 f"threaded test_block_state")
        wall, _ = median_wall(lambda: thread_test_block(info, enc, dev))
        per_frame[k] = wall / info.frame_count * 1e3
    BANKS["test_block_state_ms_per_frame"] = per_frame
    log(f"(b) test_block_state threaded over {info.frame_count} frames "
        f"under {len(t['keys'])} keys (and score_frames): pairs equal to "
        f"the JAX package's; [{card}] ms a frame, median of 3: "
        f"{ {k: round(v, 4) for k, v in per_frame.items()} }")

    # -- (c) decode_mp2 ---------------------------------------------------------
    with open(os.path.join(AHX_FIXTURES, "expected.json")) as f:
        ahx_expected = json.load(f)
    for name, rec in expected["decode_mp2"].items():
        blob = read(AHX_FIXTURES, ahx_expected[name]["file"])
        (pcm, rate), counts[f"decode_mp2 {name}"] = drive(
            f"decode_mp2 {name}", ("mp2_unpack", "mp2_synth"),
            lambda: ahx_model.decode_mp2(blob, rec["offset"], device=dev))
        require_record(f"decode_mp2 {name}", pcm, rec)
        if rate != rec["sample_rate"]:
            raise AssertionError(f"decode_mp2 {name}: rate {rate}")
    log(f"(c) decode_mp2 of {list(expected['decode_mp2'])}: sha256 equal "
        f"to the JAX package's host lane")

    # -- (d) the builders --------------------------------------------------------
    with open(os.path.join(BANK_FIXTURES, "expected.json")) as f:
        bank_expected = json.load(f)
    b = bank_expected["bank"]
    track = read(FIXTURES, b["member"])

    def build_bank():
        builder = ACBBuilder([track] * b["tracks"], name=b["name"],
                             embed_awb=False)
        return builder.build(), builder.awb_blob

    acb, awb = build_bank()
    if sha(acb) != b["acb_sha256"] or sha(awb) != b["awb_sha256"]:
        raise AssertionError("ACBBuilder's bank.acb or its awb_blob differs "
                             "from the JAX package's")
    del acb, awb
    wall, runs = median_wall(build_bank)
    BANKS["acb_builder_bank_s"] = wall
    mixed = read(BANK_FIXTURES, bank_expected["mixed"]["file"])
    members = afs2_members(ACB(mixed).awb.stream.getvalue())
    if ACBBuilder(members, name="mixed").build() != mixed:
        raise AssertionError("mixed.acb rebuilt from its members differs")
    a = expected["awb_builder"]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "list.awb")
        AWBBuilder([os.path.join(FIXTURES, n)
                    for n in a["members"]]).build(path)
        if sha(read(path)) != a["sha256"]:
            raise AssertionError("AWBBuilder (list mode) differs from the "
                                 "JAX package's")
    log(f"(d) ACBBuilder of {b['tracks']} x {b['member']} (acb and "
        f"awb_blob), mixed.acb rebuilt, AWBBuilder over {len(a['members'])} "
        f"fixtures: sha256 equal to the JAX package's; the bank build "
        f"[{card}]: median of 3 = {wall:.4f} s, runs "
        f"{[round(r, 4) for r in runs]}")

    # -- (e) the graft entry -----------------------------------------------------
    g = expected["graft_entry"]
    fn, args = graft.entry(device=dev)
    (pcm, err), counts["graft entry fn"] = drive(
        "graft entry fn", HCA_KERNELS, lambda: fn(*args))
    if pcm.device.type != dev.type or bool(err.any()) != g["err_any"]:
        raise AssertionError("graft entry: the result is not on the card "
                             "or flags an error")
    if sha(pcm.cpu().numpy().tobytes()) != g["sha256"]:
        raise AssertionError("graft entry: pcm differs from the JAX entry's")
    log(f"(e) graft entry fn{tuple(args[0].shape)}: pcm "
        f"{tuple(pcm.shape)} equal to the JAX entry's, err all false")
    BANKS["phase17_launches"] = {
        k: sum(c[k] for c in counts.values())
        for k in ("hca_side_info", "hca_coefficients", "hca_transform",
                  "hca_imdct_ola", "mp2_unpack", "mp2_synth")}


# ---------------------------------------------------------------------------
# The sharded paths and the CriCodecs module (phase 18)
# ---------------------------------------------------------------------------

#: streams of each bank case: an odd count, so the last shards are padded
MESH_STREAMS = BANK_STREAMS - 1
PNS_MESH_STREAMS = 63
#: the meshes of cuda:0 repeated (the port's stand-in for the JAX tests'
#: virtual devices): streams over dp and frames over sp, then sp alone
REPEATED_SHAPES = ((2, 2), (1, 4))


def mesh_cases(dev) -> list:
    """(name, own kernels, fn(**where) -> outputs) of every sharded entry
    point at the banks' widths; where is device=dev or mesh=m."""
    import pycricodecs_tpu_torch as port
    from pycricodecs_tpu_torch.models import hca as hca_model
    from pycricodecs_tpu_torch.utils import signals
    from pycricodecs_tpu_torch.utils.wav import write_wav

    def read(*parts):
        with open(os.path.join(*parts), "rb") as f:
            return f.read()

    hca = read(FIXTURES, BANK + ".hca")
    hs = int.from_bytes(hca[6:8], "big")
    keyed = hca_model.crypt(hca, True, hs, 56, KEY)
    pns = read(FIXTURES, signals.HCA_PNS + ".hca")
    hca_in = ([hca] * (MESH_STREAMS - PNS_MESH_STREAMS - 1) + [keyed]
              + [pns] * PNS_MESH_STREAMS)
    with open(os.path.join(BANK_FIXTURES, "expected.json")) as f:
        bank_expected = json.load(f)
    mixed = read(BANK_FIXTURES, bank_expected["mixed"]["file"])
    subkey = read(BANK_FIXTURES, bank_expected["subkey"]["file"])
    sub_key = bank_expected["subkey"]["key"]
    adx = read(ADX_FIXTURES, signals.ADX_BANK + ".adx")
    adx_small = [read(ADX_FIXTURES, n + ".adx") for n in
                 ("adx_m2_f2_stereo_1s", "adx_m4_stereo_1s", "adx_6ch_1s")]
    adx_wav = signals.adx_wav(signals.ADX_BANK, write_wav)
    ahx = read(AHX_FIXTURES, signals.AHX_BANK + ".ahx")
    hca_wav = signals.hca_wav(BANK, write_wav)
    ahx_wav = write_wav(signals.ahx_bank_pcm(), 1, 22050)
    adx_kernel = ["adx_decode_host"]
    return [
        ("decode_batch", HCA_KERNELS, lambda **w: port.decode_batch(
            hca_in, KEY, **w)),
        ("decode_awb subkey.awb", HCA_KERNELS, lambda **w: port.decode_awb(
            subkey, sub_key, **w)),
        ("decode_acb mixed.acb", (*HCA_KERNELS, *adx_kernel, "mp2_unpack",
                                  "mp2_synth"),
         lambda **w: port.decode_acb(mixed, 0, **w)),
        ("adx_decode_batch", adx_kernel, lambda **w: port.adx_decode_batch(
            [adx] * MESH_STREAMS, **w)),
        ("adx_decode_batch(wrap=True)", ["adx_decode"],
         lambda **w: port.adx_decode_batch(adx_small, wrap=True, **w)),
        ("adx_encode_batch", ["adx_encode"], lambda **w: port.adx_encode_batch(
            [adx_wav] * MESH_STREAMS, **w)),
        ("ahx_decode_batch", ("mp2_unpack", "mp2_synth"),
         lambda **w: port.ahx_decode_batch([ahx] * MESH_STREAMS, **w)),
        ("hca_encode_batch", ("hca_mdct", "hca_pack"),
         lambda **w: port.hca_encode_batch([hca_wav] * MESH_STREAMS, 2,
                                           **w)),
        ("ahx_encode_batch", ENCODE_KERNELS,
         lambda **w: port.ahx_encode_batch([ahx_wav] * MESH_STREAMS, 96,
                                           **w)),
    ]


def guard_cost(dev, card: str) -> dict:
    """K3 through its wrapper at the AHX encode bank shape with the launch
    device guard and without it (cuda_kernels.launch patched to a bare
    call), in turns: guarded, bare, bare, guarded; and the guard's own
    host time."""
    from pycricodecs_tpu_torch import _build
    from pycricodecs_tpu_torch.ops import cuda_kernels
    from pycricodecs_tpu_torch.ops import mp2_encode_device as E
    from pycricodecs_tpu_torch.ops import mp2_encode_host
    from pycricodecs_tpu_torch.utils import signals

    bank_pcm = signals.ahx_bank_pcm()
    F = -(-bank_pcm.size // 1152)
    cfg = mp2_encode_host.configure(1, 22050, 96)
    x = np.zeros((BANK_STREAMS, 1, F * 1152), np.int16)
    x[:, 0, :bank_pcm.size] = bank_pcm
    S, part, frame = E.analysis(torch.from_numpy(x).to(dev))
    pads, sizes, budgets = cfg.frame_plan(F)
    out = E.allocate(S, part, E.need_db_host(frame),
                     torch.from_numpy(budgets).to(dev), cfg)
    offs = E.frame_offsets(sizes)
    pads_d, offs_d = (torch.from_numpy(a).to(dev) for a in (pads, offs))
    ctab = E.pack_tables(cfg, dev)

    def k3():
        return cuda_kernels.mp2_pack(
            *out, pads_d, offs_d, ctab, sblimit=cfg.sblimit,
            bound=cfg.bound, header_base=cfg.header_base,
            total=int(offs[-1]), max_frame=int(sizes.max()))

    guarded = cuda_kernels.launch
    want = k3().cpu()

    def bare(kernel, t, *args):
        rc = getattr(_build.load(), kernel)(*args,
                                            cuda_kernels.stream_ptr(t))
        if rc:
            raise cuda_kernels.launch_failed(kernel, rc)

    times = {"guarded": [], "bare": []}
    try:
        for which in ("guarded", "bare", "bare", "guarded"):
            cuda_kernels.launch = guarded if which == "guarded" else bare
            if not torch.equal(k3().cpu(), want):
                raise AssertionError("K3 without the guard differs")
            times[which].append((cuda_ms(k3, 10), cuda_ms(
                lambda: [k3() for _ in range(10)], 5) / 10))
    finally:
        cuda_kernels.launch = guarded
    t = torch.empty(1, device=dev)
    n = 10000

    def context_manager():
        with torch.cuda.device(t.device):
            pass

    def exchange():                      # the guard in cuda_kernels.launch
        prev = torch._C._cuda_exchangeDevice(t.get_device())
        torch._C._cuda_maybeExchangeDevice(prev)

    res = {k: {"wrapper_ms": [round(a, 4) for a, _ in v],
               "back_to_back_ms": [round(b, 4) for _, b in v]}
           for k, v in times.items()}
    for name, fn in (("guard_host_us", exchange),
                     ("context_manager_host_us", context_manager)):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        res[name] = (time.perf_counter() - t0) / n * 1e6
    log(f"the launch device guard [{card}]: K3 through its wrapper at the "
        f"AHX encode bank shape, guarded {res['guarded']['wrapper_ms']} ms, "
        f"bare {res['bare']['wrapper_ms']} ms (turns: guarded, bare, bare, "
        f"guarded); back to back guarded {res['guarded']['back_to_back_ms']}"
        f", bare {res['bare']['back_to_back_ms']} ms a launch; the guard "
        f"alone {res['guard_host_us']:.2f} us on the host, "
        f"torch.cuda.device's context manager "
        f"{res['context_manager_host_us']:.2f} us")
    return res


def mesh_phase(dev, card: str) -> None:
    """Phase 18: every sharded entry point over a mesh of every visible
    card and over meshes of cuda:0 repeated, byte-equal to its unsharded
    call, with the kernels launched and the medians beside the unsharded
    ones; dryrun_multichip on four repeats of cuda:0; the CriCodecs module
    against the port calls it maps to; the launch device guard's cost."""
    import __graft_entry_torch__ as graft
    import pycricodecs_tpu_torch as port
    from pycricodecs_tpu_torch import cricodecs as CC
    from pycricodecs_tpu_torch.models import adx as adx_model
    from pycricodecs_tpu_torch.models import crilayla
    from pycricodecs_tpu_torch.models import hca as hca_model
    from pycricodecs_tpu_torch.parallel import make_mesh
    from pycricodecs_tpu_torch.utils import signals
    from pycricodecs_tpu_torch.utils.wav import write_wav

    real = make_mesh()
    log(f"(a) make_mesh(): shape {real.shape} over "
        f"{[str(d) for d in real.devices.flat]}")
    meshes = [("every card " + str(real.shape), real)] + [
        (f"cuda:0 x 4 as {shape}",
         make_mesh(shape, devices=[torch.device("cuda", 0)] * 4))
        for shape in REPEATED_SHAPES]
    timings = {}
    for name, own, fn in mesh_cases(dev):
        want = fn(device=dev)
        for label, m in meshes:
            got, _ = drive(f"{name} over {label}", own,
                           lambda: fn(mesh=m))
            if [sha(g) for g in got] != [sha(w) for w in want]:
                bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
                raise AssertionError(f"{name} over {label} differs from the "
                                     f"unsharded call: outputs {bad[:8]}")
            del got
        log(f"{name}: {len(want)} outputs, byte-equal to the unsharded call "
            f"over {[label for label, _ in meshes]}")
        del want
        walls = {"unsharded": median_wall(lambda: fn(device=dev))}
        for label, m in meshes[1:]:
            walls[label] = median_wall(lambda: fn(mesh=m))
        timings[name] = {k: round(w, 4) for k, (w, _) in walls.items()}
        log(f"{name} [{card}]: median of 3 " + "; ".join(
            f"{k} {w:.4f} s (runs {[round(r, 4) for r in runs]})"
            for k, (w, runs) in walls.items())
            + " - four shards on one card share its SMs: not a gain")
    BANKS["phase18_s"] = timings

    # -- (c) dryrun_multichip on cuda:0 four times -------------------------
    drive("dryrun_multichip(4, cuda:0 x 4)", (
        *HCA_KERNELS, "adx_decode_host", "adx_encode", "mp2_unpack",
        "mp2_synth", "hca_mdct", "hca_pack", *ENCODE_KERNELS),
        lambda: graft.dryrun_multichip(
            4, devices=[torch.device("cuda", 0)] * 4))

    # -- (d) the CriCodecs module --------------------------------------------
    def read(*parts):
        with open(os.path.join(*parts), "rb") as f:
            return f.read()

    plain = read(FIXTURES, "q4_stereo_48k_1s.hca")
    hs = int.from_bytes(plain[6:8], "big")
    keyed = CC.HcaCrypt(plain, 1, hs, 56, KEY, 0x1234)
    adx = read(ADX_FIXTURES, "adx_m4_stereo_1s.adx")
    adx_wav = signals.adx_wav("adx_m4_stereo_1s", write_wav)
    hca_wav = signals.hca_wav("q4_stereo_48k_1s", write_wav)
    text = b"".join(b"bank %d: the quick brown fox. " % (i % 7)
                    for i in range(400))
    checks = [
        ("AdxDecode", CC.AdxDecode(adx, device=dev),
         adx_model.decode(adx, device=dev)),
        ("AdxEncode", CC.AdxEncode(adx_wav, 4, 0x12, 4, 0x1F4, 0, 4, False,
                                   device=dev),
         adx_model.encode(adx_wav, encoding_mode=4, device=dev)),
        ("HcaDecode", CC.HcaDecode(keyed, hs, KEY, 0x1234, device=dev),
         hca_model.decode(keyed, KEY, 0x1234, device=dev)),
        ("HcaEncode", CC.HcaEncode(hca_wav, 0, 4, device=dev),
         port.hca_encode_batch([hca_wav], 4, device=dev)[0]),
        ("HcaCrypt", CC.HcaCrypt(keyed, 0, hs, 56, KEY, 0x1234),
         hca_model.crypt(keyed, False, hs, 56, KEY, 0x1234)),
        ("CriLaylaCompress", CC.CriLaylaCompress(text),
         crilayla.compress(text)),
        ("CriLaylaDecompress", CC.CriLaylaDecompress(crilayla.compress(text)),
         text),
    ]
    for name, got, want in checks:
        if not isinstance(got, bytes) or got != want:
            raise AssertionError(f"CriCodecs.{name} differs from the port "
                                 f"call it maps to")
    if checks[4][1] != plain:
        raise AssertionError("CriCodecs.HcaCrypt did not decipher back")
    log(f"(d) CriCodecs: {[c[0] for c in checks]} equal to the port calls "
        f"they map to")
    BANKS["phase18_guard"] = guard_cost(dev, card)


CONTAINER_FIXTURES = os.path.join(FIXTURES, "containers")
CRILAYLA_KERNELS = ("crilayla_decompress", "crilayla_compress")


def tree_sha256(root: str) -> dict:
    """{relative path with "/": sha256} of every file under root (the
    fixture tool's tree_sha256)."""
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root).replace(os.sep, "/")] = \
                    sha(f.read())
    return dict(sorted(out.items()))


def require_tree(what: str, got: dict, want: dict) -> None:
    if got != want:
        bad = sorted(k for k in set(got) | set(want)
                     if got.get(k) != want.get(k))
        raise AssertionError(f"{what}: files {bad[:8]} differ from the JAX "
                             f"package's")


def require_members(what: str, root: str, members: dict) -> None:
    """Every extracted member under root equal to its source bytes, and
    nothing else written."""
    got = tree_sha256(root)
    want = {n: sha(d) for n, d in members.items()}
    if got != want:
        bad = sorted(k for k in set(got) | set(want)
                     if got.get(k) != want.get(k))
        raise AssertionError(f"{what}: members {bad[:8]} differ from their "
                             f"sources")


def members_equal(what: str, got: list, want: list) -> int:
    """A kernel's member outputs (bytes, or None where it refused or
    flagged the member) held to its plain version's byte for byte, the
    refusals and the sizes included; returns max |diff|."""
    def column(f):
        return torch.tensor([f(x) for x in got]), \
            torch.tensor([f(x) for x in want])

    def flat(xs):
        return torch.from_numpy(np.frombuffer(
            b"".join(x or b"" for x in xs), dtype=np.uint8).copy())

    require_equal(what, [("refused", *column(lambda x: int(x is None))),
                         ("size", *column(lambda x: len(x or b"")))])
    return require_equal(what, [("bytes", flat(got), flat(want))])


def crilayla_checks(dev, worst: dict, fixtures: dict, card: str) -> None:
    """C1 against `_decompress_py` on the compressed 1 s fixtures and C2
    against `_compress_py` on the edge payloads (257 B - 8.7 KB): each
    through decompress_members / compress_members on the card and on the
    CPU (the plain versions), byte for byte with the refusals. Then C1 on
    a 1 MiB stream whose chunk parses never meet the true one (all zero
    bits: `signals.crilayla_zero_blob`), held to its known output, with
    its time, and on a copy whose u32 length wraps past 2^32
    (`signals.crilayla_wrap_blob`), held to its known bytes."""
    from pycricodecs_tpu_torch.models import crilayla
    from pycricodecs_tpu_torch.ops import cuda_kernels as CK
    from pycricodecs_tpu_torch.utils import signals

    payloads = signals.crilayla_edge_payloads()
    payloads += [b"", b"x" * 0x100]                  # refused: too small
    got = crilayla.compress_members(payloads, device=dev)
    want = crilayla.compress_members(payloads, device="cpu")
    worst["crilayla_compress"] = max(worst["crilayla_compress"], members_equal(
        "C2 against _compress_py on the edge payloads", got, want))
    if got[-1] is not None or got[-2] is not None:
        raise AssertionError("C2 did not refuse a member of 0x100 bytes")
    log(f"C2 crilayla_compress: {len(payloads)} edge payloads "
        f"({[len(p) for p in payloads]} bytes) byte-equal to _compress_py, "
        f"the two of 0x100 bytes or fewer refused by both")
    small = [fixtures[n] for n in sorted(fixtures)
             if n.endswith("_1s.adx") or n.endswith("_1s.hca")]
    blobs = [b for b in crilayla.compress_members(small, device=dev)
             if b is not None]
    bad_blob = bytearray(blobs[0])
    bad_blob[20] ^= 0xFF                              # a malformed stream
    # more damage, as tests/test_torch_crilayla.py does it: three bytes
    # flipped near the stream's end (where the parse starts), an all-ones
    # stream (a back-reference past the end), a stream cut short (an
    # underrun)
    rng = np.random.default_rng(9)
    damaged = []
    for _ in range(24):
        x = bytearray(blobs[1])
        for _ in range(3):
            x[16 + int(rng.integers(0, 40))] ^= int(rng.integers(1, 256))
        damaged.append(bytes(x))
    ones = blobs[2][:16] + b"\xff" * (len(blobs[2]) - 16)
    cut = blobs[3][:8] + (700).to_bytes(4, "little") \
        + (2).to_bytes(4, "little") + blobs[3][16:18] + blobs[3][-256:]
    parsed = [crilayla.parse(b) for b in blobs + [bytes(bad_blob)] + damaged
              + [ones, cut]]
    got = crilayla.decompress_members(parsed, device=dev)
    want = crilayla.decompress_members(parsed, device="cpu")
    worst["crilayla_decompress"] = max(
        worst["crilayla_decompress"],
        members_equal("C1 against _decompress_py on the compressed 1 s "
                      "fixtures and damaged streams", got, want))
    flagged = sum(x is None for x in got)
    if got[len(blobs)] is not None or got[-1] is not None or \
            got[-2] is not None:
        raise AssertionError("C1 did not flag a malformed stream")
    log(f"C1 crilayla_decompress: {len(blobs)} compressed 1 s fixtures and "
        f"{len(parsed) - len(blobs)} damaged streams byte-equal to "
        f"_decompress_py, statuses included ({flagged} flagged by both)")
    # matches past 2^19 bytes: C2's 64-bit keys; the plain matcher would take
    # hours here, so the JAX native's blob hashes hold them
    with open(os.path.join(CONTAINER_FIXTURES, "expected.json")) as f:
        want_long = json.load(f)["long_matches"]
    members = signals.crilayla_long_match_members()
    for n, data in members.items():
        if sha(data) != want_long[n]["member_sha256"]:
            raise AssertionError(f"{n}: the member differs from its recorded "
                                 f"hash")
    blobs = crilayla.compress_members(list(members.values()), device=dev)
    for n, blob in zip(members, blobs):
        if blob is None or sha(blob) != want_long[n]["blob_sha256"]:
            raise AssertionError(f"C2 at {n}: the blob differs from the JAX "
                                 f"native's")
    back = crilayla.decompress_members([crilayla.parse(b) for b in blobs],
                                       device=dev)
    if back != list(members.values()):
        raise AssertionError("C1 did not give the long-match members back")
    log(f"C2 / C1 at matches past 2^19 bytes: "
        + ", ".join(f"{n} ({len(d)} bytes -> {len(b)})"
                    for (n, d), b in zip(members.items(), blobs))
        + ": each blob equal to the JAX native's, each decompressed back to "
        f"its member")
    # all 9-bit zero literals: chunk k starts 4k bits mod 9 past a token
    # start, so about 8 chunks in 9 never meet the true parse and the serial
    # repair parses them
    size = 1 << 20
    zsrc, zmeta, zsize = crilayla.pack_decompress(
        [crilayla.parse(signals.crilayla_zero_blob(size))])
    zsrc_t = torch.from_numpy(zsrc).to(dev)
    out, zstatus, zsteps = CK.crilayla_decompress(zsrc_t, zmeta, zsize)
    if int(zstatus[0]) != 0 or out.numel() != size + 256 or bool(out.any()):
        raise AssertionError("C1 on the all-zero stream: not status 0 and "
                             f"{size + 256} zero bytes")
    tokens = int(zsteps[0])
    zero_ms = cuda_ms(lambda: CK.crilayla_decompress(zsrc_t, zmeta, zsize),
                      3)
    BANKS["c1_all_zero_1mib"] = dict(ms=zero_ms, tokens=tokens,
                                     tokens_per_s=tokens / zero_ms * 1e3)
    log(f"C1 crilayla_decompress [{card}] on the all-zero "
        f"stream ({len(zsrc) - 256} stream bytes, {size} bytes out, "
        f"{tokens} tokens, chunk parses off phase): {size + 256} zero "
        f"bytes, status 0; kernel {zero_ms:.4f} ms (CUDA events, median of "
        f"3), {tokens / zero_ms * 1e3:.0f} tokens/s")
    # a 255-run of 16.84 MB that sums past 2^32: the copy's length wraps to
    # 40 bytes, as the JAX native's u32, and the 16 literals after it count
    tail = bytes(range(1, 17))
    wblob = signals.crilayla_wrap_blob(40, tail, 0xAB)
    t0 = time.perf_counter()
    (wout,) = crilayla.decompress_members([crilayla.parse(wblob)],
                                          device=dev)
    wrap_s = time.perf_counter() - t0
    if wout != bytes(256) + tail[::-1] + b"\xab" * 43:
        raise AssertionError("C1 on the wrapping copy length: not its "
                             "known bytes")
    log(f"C1 crilayla_decompress on a copy whose length wraps past 2^32 "
        f"({len(wblob) - 272} stream bytes, {len(wout) - 256} bytes out): "
        f"its known bytes; {wrap_s:.4f} s on the host clock, copies "
        f"included")


def host_ms(fn) -> float:
    """Milliseconds of one fn() on the host clock (a plain version that
    runs on the CPU)."""
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


#: each CRILAYLA wrapper's stages, by the kernels (names) each launches
CRILAYLA_STAGES = {
    "crilayla_compress": {
        "search": ("c2_summary_kernel", "c2_carry_kernel", "c2_search_kernel"),
        "walk": ("c2_spec_kernel", "c2_repair_kernel"),
        "emit": ("c2_count_kernel", "c2_offsets_kernel", "c2_place_kernel")},
    "crilayla_decompress": {
        "parse": ("c1_spec_kernel", "c1_repair_kernel", "c1_count_kernel",
                  "c1_offsets_kernel", "c1_place_kernel", "c1_finish_kernel"),
        "materialise": ("c1_resolve_kernel", "c1_jump_kernel",
                        "c1_gather_kernel")}}


def stage_device_ms(fn, stages: dict, reps: int = 3) -> dict:
    """{stage: device milliseconds a call} of fn()'s kernels, summed by
    the kernel names each stage lists (the call's other device work, its
    table copies and the work buffer's fill, under "other"), from the
    kernel records of a torch.profiler trace of `reps` calls after a
    warm-up call. Raises where a stage's kernels left no record."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys([*stages, "other"], 0.0)
    for e in prof.key_averages():
        us = (getattr(e, "device_time_total", None)
              or getattr(e, "cuda_time_total", 0))
        stage = next((k for k, names in stages.items()
                      if any(n in e.key for n in names)), "other")
        out[stage] += us / reps / 1e3
    empty = [k for k in stages if out[k] <= 0]
    if empty:
        raise AssertionError(f"no kernel record of the stages {empty} in "
                             f"the profiler's trace")
    return out


def fmt_stages(stages: dict) -> str:
    return ", ".join(f"{k} {v:.4f} ms" for k, v in stages.items())


def crilayla_timing(dev, card: str, named: dict, worst: dict) -> dict:
    """C1 and C2 at the compressed archive's shape (CUDA events, median of
    3; their stages by device time, `stage_device_ms`), their plain
    versions once (C2's on the edge payloads: the Python
    matcher would take hours at this shape), and the bounds. C1's output
    at this shape is held to `_decompress_py`'s byte for byte, statuses
    included; C2's is held to the JAX package's archive hash on the main
    path."""
    from pycricodecs_tpu_torch.models import crilayla
    from pycricodecs_tpu_torch.ops import cuda_kernels as CK
    from pycricodecs_tpu_torch.utils import signals

    members = list(named.values())
    src, meta, work_size = crilayla.pack_compress(members)
    src_t = torch.from_numpy(src).to(dev)
    work, start, status, steps = CK.crilayla_compress(src_t, meta, work_size)
    caps = CK.crilayla_work_cap(meta[:, 1])
    start, status = start.cpu().numpy(), status.cpu().numpy()
    streams = [work[int(o + s):int(o + c)].cpu().numpy().tobytes()
               if not st else None
               for o, s, c, st in zip(meta[:, 2], start, caps, status)]
    c2_steps = int(steps.max())
    log("C2 blob bytes (member bytes -> header + stream + prefix, or "
        "refused): " + ", ".join(
            f"{n} {len(m)} -> {'refused' if x is None else len(x) + 0x110}"
            for n, m, x in zip(named, members, streams)))
    c2_ms = cuda_ms(lambda: CK.crilayla_compress(src_t, meta, work_size), 3)
    c2_stages = stage_device_ms(
        lambda: CK.crilayla_compress(src_t, meta, work_size),
        CRILAYLA_STAGES["crilayla_compress"])
    edge = signals.crilayla_edge_payloads()
    c2_plain_ms = host_ms(lambda: crilayla.compress_members(edge,
                                                            device="cpu"))
    esrc, emeta, ework = crilayla.pack_compress(edge)
    esrc_t = torch.from_numpy(esrc).to(dev)
    c2_edge_ms = cuda_ms(lambda: CK.crilayla_compress(esrc_t, emeta, ework),
                         3)
    c2 = bound("crilayla_compress",
               int(meta[:, 1].sum()) + sum(len(x) for x in streams if x),
               int(meta[:, 1].sum()))

    # C1 at the main path's shape: the members the archive stores
    # compressed (CPKBuilder stores a member raw where its blob is not
    # smaller)
    kept = [(m, x) for m, x in zip(members, streams)
            if x is not None and len(x) + 0x110 < len(m)]
    blobs = [crilayla.assemble(m, x) for m, x in kept]
    parsed = [crilayla.parse(b) for b in blobs]
    dsrc, dmeta, out_size = crilayla.pack_decompress(parsed)
    dsrc_t = torch.from_numpy(dsrc).to(dev)
    out, dstatus, dsteps = CK.crilayla_decompress(dsrc_t, dmeta, out_size)
    c1_steps = int(dsteps.max())
    t0 = time.perf_counter()
    plain = crilayla.decompress_members(parsed, device="cpu")
    c1_plain_ms = (time.perf_counter() - t0) * 1e3
    worst["crilayla_decompress"] = max(
        worst["crilayla_decompress"], require_equal(
            "C1 against _decompress_py at the archive's compressed members",
            [("status", dstatus.cpu(),
              torch.tensor([int(p is None) for p in plain],
                           dtype=torch.int32)),
             ("out", out.cpu(), torch.from_numpy(np.frombuffer(
                 b"".join(p or b"" for p in plain), dtype=np.uint8).copy()))]))
    if bool(dstatus.any()):
        raise AssertionError("C1 flagged a stream C2 wrote")
    if plain != [m for m, _ in kept]:
        raise AssertionError("C1 at the archive's members: a member differs "
                             "from its source")
    c1_ms = cuda_ms(lambda: CK.crilayla_decompress(dsrc_t, dmeta, out_size),
                    3)
    c1_stages = stage_device_ms(
        lambda: CK.crilayla_decompress(dsrc_t, dmeta, out_size),
        CRILAYLA_STAGES["crilayla_decompress"])
    c1 = bound("crilayla_decompress", len(dsrc) + out_size, out_size)
    log(f"C2 crilayla_compress [{card}] at the compressed archive "
        f"({len(members)} members, {int(meta[:, 1].sum())} bytes, longest "
        f"member {c2_steps} tokens): kernel {c2_ms:.4f} ms (CUDA events, "
        f"median of 3); at the edge payloads ({int(emeta[:, 1].sum())} bytes) "
        f"kernel {c2_edge_ms:.4f} ms, plain {c2_plain_ms:.4f} ms; bound "
        f"{c2['bound_ms']:.4f} ms by {c2['bound_by']}; stages (device "
        f"time, torch.profiler, mean of 3) {fmt_stages(c2_stages)}")
    log(f"C1 crilayla_decompress [{card}] at the archive's "
        f"{len(blobs)} compressed members ({len(dsrc)} bytes in, {out_size} "
        f"out, longest member {c1_steps} tokens): kernel {c1_ms:.4f} ms (CUDA "
        f"events, median of 3), equal byte for byte to its plain version, "
        f"plain {c1_plain_ms:.4f} ms (once); bound {c1['bound_ms']:.4f} ms "
        f"by {c1['bound_by']}; stages (device time, torch.profiler, mean of "
        f"3) {fmt_stages(c1_stages)}")
    BANKS["crilayla_stages_ms"] = {"crilayla_compress": c2_stages,
                                   "crilayla_decompress": c1_stages}
    return {"crilayla_decompress": (c1_ms, c1_plain_ms, c1),
            "crilayla_compress": (c2_ms, c2_plain_ms, c2)}


def containers_phase(dev, card: str, worst: dict = None,
                     launches: dict = None) -> dict:
    """Phase 19: the 60 s cutscene through USMBuilder (HCA and ADX audio)
    and USM.extract(decode=True), the sound archive through CPKBuilder in
    modes 0-3, CPK.extract and decode_acb, the compressed archive through
    C2 and C1; every output held to the JAX package's recorded sha256.
    Returns the CRILAYLA kernels' results (ms, plain ms, bound)."""
    import tempfile

    import pycricodecs_tpu_torch as port
    from pycricodecs_tpu_torch.containers.cpk import CPK, CPKBuilder
    from pycricodecs_tpu_torch.containers.ivf import build_ivf
    from pycricodecs_tpu_torch.containers.usm import USM, USMBuilder
    from pycricodecs_tpu_torch.utils import signals as S
    from pycricodecs_tpu_torch.utils.wav import write_wav

    worst = dict.fromkeys(KERNELS, 0) if worst is None else worst
    launches = {} if launches is None else launches
    with open(os.path.join(CONTAINER_FIXTURES, "expected.json")) as f:
        exp = json.load(f)
    with open(os.path.join(FIXTURES, "expected.json")) as f:
        hca_expected = json.load(f)
    with open(os.path.join(BANK_FIXTURES, "expected.json")) as f:
        bank_expected = json.load(f)
    timings = {}
    key = S.MOVIE_KEY

    # -- (a) the movie: IVF, USMBuilder, USM.extract(decode=True) ----------
    em = exp["movie"]
    ivf = build_ivf(S.movie_frames(), fps_num=S.MOVIE["fps"], fps_den=1)
    tracks = [S.movie_track(seed, write_wav) for seed in S.MOVIE_TRACK_SEEDS]
    if sha(ivf) != em["ivf_sha256"] or \
            [sha(t) for t in tracks] != em["track_sha256"]:
        raise AssertionError("the rebuilt cutscene IVF or its tracks differ "
                             "from their recorded hashes")
    log(f"(a) movie: IVF of {S.MOVIE['seconds'] * S.MOVIE['fps']} frames, "
        f"{len(ivf)} bytes, and two 60 s stereo 48 kHz tracks: sha256 equal "
        f"to the recorded ones")
    builds = {
        "hca": (("hca_mdct", "hca_pack"), HCA_KERNELS,
                lambda: USMBuilder(ivf, tracks, key=key, audio_codec="hca",
                                   encryptAudio=True,
                                   subtitles=S.MOVIE_SUBTITLES,
                                   device=dev).build()),
        "adx": (("adx_encode",), ("adx_decode_host",),
                lambda: USMBuilder(ivf, [tracks[0]], key=key,
                                   audio_codec="adx", encryptAudio=True,
                                   device=dev).build()),
    }
    usms = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, (own_build, own_extract, build) in builds.items():
            usm, _ = drive(f"USMBuilder ({name} audio)", own_build, build)
            if sha(usm) != em[name]["usm_sha256"]:
                raise AssertionError(f"USMBuilder ({name}): the USM differs "
                                     f"from the JAX package's")
            usms[name] = usm
            out = os.path.join(tmp, name)

            def extract(out=out, usm=usm):
                USM(usm, key=key, device=dev).extract(out, decode=True,
                                                      key=key)

            drive(f"USM.extract(decode=True) ({name})", own_extract, extract)
            require_tree(f"USM.extract ({name})", tree_sha256(out),
                         em[name]["extract"])
            build_s, build_runs = median_wall(build)
            extract_s, extract_runs = median_wall(extract)
            timings[f"usm_{name}_build_s"] = build_s
            timings[f"usm_{name}_extract_s"] = extract_s
            log(f"{name} USM ({len(usm)} bytes): bytes and every extracted "
                f"file ({sorted(em[name]['extract'])}) equal to the JAX "
                f"package's; [{card}] build median of 3 {build_s:.4f} s "
                f"(runs {[round(r, 4) for r in build_runs]}), "
                f"extract(decode=True) {extract_s:.4f} s "
                f"(runs {[round(r, 4) for r in extract_runs]})")
        with open(os.path.join(AHX_FIXTURES, exp["ahx_decode"]["stream"]),
                  "rb") as f:
            ahx = f.read()
        wav, _ = drive("USM._decode_audio (AHX)", ("mp2_unpack", "mp2_synth"),
                       lambda: USM._decode_audio(ahx, device=dev))
        if sha(wav) != exp["ahx_decode"]["wav_sha256"]:
            raise AssertionError("USM._decode_audio of the AHX bank stream "
                                 "differs from the JAX package's")
        log("USM._decode_audio of the 10 s AHX bank stream: equal to the JAX "
            "package's")

    # -- (b) the sound archive: CPKBuilder modes 0-3, extract, decode_acb ----
    ea = exp["archive"]
    with tempfile.TemporaryDirectory() as tmp:
        named, ids = os.path.join(tmp, "named"), os.path.join(tmp, "ids")
        os.makedirs(named)
        os.makedirs(ids)
        write_bank_awb(named, bank_expected["bank"])
        for n in ("mixed.acb", "subkey.awb"):
            with open(os.path.join(BANK_FIXTURES, n), "rb") as f:
                data = f.read()
            with open(os.path.join(named, n), "wb") as f:
                f.write(data)
        for n, data in (("hca.usm", usms["hca"]), ("adx.usm", usms["adx"])):
            with open(os.path.join(named, n), "wb") as f:
                f.write(data)
        members = {}
        for i, n in enumerate(S.ARCHIVE_MEMBERS):
            with open(os.path.join(named, n), "rb") as f:
                members[n] = f.read()
            os.link(os.path.join(named, n), os.path.join(ids, str(i)))
        if {n: sha(d) for n, d in members.items()} != ea["members"]:
            raise AssertionError("the sound archive's members differ from "
                                 "their recorded hashes")
        total = sum(len(d) for d in members.values())
        for mode in (0, 1, 2, 3):
            path = os.path.join(tmp, f"mode{mode}.cpk")
            src = ids if mode == 0 else named

            def build(path=path, src=src, mode=mode):
                CPKBuilder(src, path, CpkMode=mode, device=dev)

            build_s, runs = median_wall(build)
            with open(path, "rb") as f:
                if sha(f.read()) != ea["modes"][str(mode)]["sha256"]:
                    raise AssertionError(f"CPKBuilder mode {mode}: the "
                                         f"archive differs from the JAX "
                                         f"package's")
            out = os.path.join(tmp, f"out{mode}")

            def extract(path=path, out=out):
                CPK(path, device=dev).extract(out)

            extract_s, xruns = median_wall(extract)
            require_tree(f"CPK.extract mode {mode}", tree_sha256(out),
                         ea["modes"][str(mode)]["extract"])
            if mode in (0, 1):
                require_members(f"CPK.extract mode {mode}", out, {
                    (str(i) if mode == 0 else n): members[n]
                    for i, n in enumerate(S.ARCHIVE_MEMBERS)})
            timings[f"cpk_mode{mode}_build_s"] = build_s
            timings[f"cpk_mode{mode}_extract_s"] = extract_s
            log(f"CPK mode {mode} ({ea['modes'][str(mode)]['bytes']} bytes, "
                f"{total} member bytes): equal to the JAX package's; every "
                f"extracted file equal to the JAX extract's"
                + (" and to its source member" if mode in (0, 1) else
                   " (modes 2 and 3 read members at the TOC's FileOffset, "
                   "which leaves out the ITOC or GTOC: the JAX package's "
                   "bytes, not the sources)")
                + f"; [{card}] build "
                f"median of 3 {build_s:.4f} s (runs "
                f"{[round(r, 4) for r in runs]}), extract {extract_s:.4f} s "
                f"(runs {[round(r, 4) for r in xruns]})")
            if mode == 1:
                acb = os.path.join(out, "bank.acb")
                wavs, _ = drive("decode_acb of the extracted bank.acb",
                                HCA_KERNELS,
                                lambda: port.decode_acb(acb, device=dev))
                want = hca_expected[BANK]["wav_sha256"]
                require_hashes("decode_acb of the extracted bank.acb", wavs,
                               [want] * bank_expected["bank"]["tracks"])
                del wavs

                def pipeline(path=path, out=out):
                    CPK(path, device=dev).extract(out)
                    port.decode_acb(os.path.join(out, "bank.acb"),
                                    device=dev)

                pipe_s, pruns = median_wall(pipeline)
                timings["cpk_extract_decode_acb_s"] = pipe_s
                log(f"archive -> bank -> WAV: {bank_expected['bank']['tracks']}"
                    f" WAVs of the extracted bank.acb equal to the JAX "
                    f"package's; [{card}] CPK.extract + decode_acb median of "
                    f"3 {pipe_s:.4f} s (runs {[round(r, 4) for r in pruns]})")
            shutil.rmtree(out)
            os.unlink(path)

    # -- (c) the compressed archive: C2 and C1 on the main path --------------
    ec = exp["compressed"]
    fixtures = S.compressed_archive_members(FIXTURES, write_wav)
    if {n: sha(d) for n, d in fixtures.items()} != ec["members"]:
        raise AssertionError("the compressed archive's members differ from "
                             "their recorded hashes")
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "in")
        os.makedirs(src)
        for n, data in fixtures.items():
            with open(os.path.join(src, n), "wb") as f:
                f.write(data)
        path = os.path.join(tmp, "compressed.cpk")

        def build():
            CPKBuilder(src, path, compress=True, encrypt=True, device=dev)

        _, counts = drive("CPKBuilder(compress=True, encrypt=True)",
                          ("crilayla_compress",), build)
        launches["crilayla_compress"] = counts["crilayla_compress"]
        with open(path, "rb") as f:
            if sha(f.read()) != ec["sha256"]:
                raise AssertionError("CPKBuilder(compress=True): the archive "
                                     "differs from the JAX package's")
        toc = CPK(path, device=dev).tables["TOC"]
        packed = sorted(CPK._cell(toc["FileName"], i)
                        for i in range(len(toc["FileName"]))
                        if CPK._cell(toc["ExtractSize"], i)
                        > CPK._cell(toc["FileSize"], i))
        if packed != ec["stored_compressed"]:
            raise AssertionError("the compressed archive stores other "
                                 "members compressed than the JAX package's")
        out = os.path.join(tmp, "out")

        def extract():
            CPK(path, device=dev).extract(out)

        _, counts = drive("CPK.extract (compressed)",
                          ("crilayla_decompress",), extract)
        launches["crilayla_decompress"] = counts["crilayla_decompress"]
        require_members("CPK.extract (compressed)", out, fixtures)
        build_s, runs = median_wall(build)
        extract_s, xruns = median_wall(extract)
        timings["cpk_compress_build_s"] = build_s
        timings["cpk_compress_extract_s"] = extract_s
        log(f"compressed CPK ({ec['bytes']} bytes, {len(fixtures)} members, "
            f"{len(packed)} stored compressed): equal to the JAX package's "
            f"(its native compress); every member extracted equal to its "
            f"source; [{card}] build median of 3 {build_s:.4f} s (runs "
            f"{[round(r, 4) for r in runs]}), extract {extract_s:.4f} s "
            f"(runs {[round(r, 4) for r in xruns]})")
    crilayla_checks(dev, worst, fixtures, card)
    BANKS["phase19_s"] = timings
    return crilayla_timing(dev, card, fixtures, worst)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this check runs only on a CUDA GPU")
    sys.path.insert(0, ROOT)
    import pycricodecs_tpu_torch as port
    from pycricodecs_tpu_torch import _build
    from pycricodecs_tpu_torch.ops import hca_frame
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
    log(f"max SM clock: {max_sm_clock_mhz():.0f} MHz (nvidia-smi "
        f"clocks.max.sm)")
    log(f"torch.cuda.get_device_name(0): {torch.cuda.get_device_name(0)}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # -- phase 2: build -----------------------------------------------------
    t0 = time.perf_counter()
    _build.load()
    log(f"build: {time.perf_counter() - t0:.3f} s (nvcc "
        f"{_build.BUILD_SECONDS} s)")
    for line in _build.BUILD_LOG.splitlines():
        if ("registers" in line or "spill" in line
                or "Compiling entry function" in line):
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
    up = U.DeviceUnpacker(bank_info, device=dev)
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
    # a frame size off 16 bytes: B2 stages such frames byte by byte
    odd = hca_frame.parse_header(
        blobs["q4_stereo_48k_1s"][:infos["q4_stereo_48k_1s"].header_size])
    odd.frame_size = ODD_FRAME_SIZE
    # frames shorter than their side info can run: B1 tests every read
    # against the frame end only there (SMALL_FRAME_SIZES)
    small = []
    for fs, version in SMALL_FRAME_SIZES:
        info = hca_frame.parse_header(
            blobs["q4_stereo_48k_1s"][:infos["q4_stereo_48k_1s"].header_size])
        info.version = version
        info.init_derived()
        info.frame_size = fs
        small.append((f"fs{fs}_v{version >> 8}_relabel_q4_stereo", info))
    rng = np.random.default_rng(0)
    for name, info in [*infos.items(), ("v3_relabel_q4_stereo", v3),
                       (f"fs{ODD_FRAME_SIZE}_relabel_q4_stereo", odd),
                       *small]:
        # RAGGED frames more than whole CTAs of 32: a ragged last CTA
        fr = rng.integers(0, 256, (RANDOM_FRAMES + RAGGED, info.frame_size),
                          dtype=np.uint8)
        fr[:, :2] = 0xFF
        fr[:16] = 0                      # zero padding frames decode cleanly
        u = U.DeviceUnpacker(info, device=dev)
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
        log(f"B1+B2 random {name}: {RANDOM_FRAMES + RAGGED} frames, "
            f"{int(ok.sum())} without error: byte-equal to the twins")
        # B1 on the same frames as a view 3 bytes past a 16-byte boundary
        buf = torch.zeros(d.numel() + 16, dtype=torch.uint8, device=dev)
        buf[3:3 + d.numel()] = d.reshape(-1)
        worst["hca_side_info"] = max(worst["hca_side_info"], side_info_equal(
            f"B1 random {name}, dec 3 bytes past 16", u,
            buf[3:3 + d.numel()].view(d.shape)))

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
    # B3's tile edges: F = 1 and B = 1, T = F * 8 below, at and off
    # multiples of its 31-subframe tile, the 6-channel config's two pairs
    # and two unpaired channels, without and with PNS maps
    g = torch.Generator().manual_seed(2)
    for name, Bs, Fs in (("q2_6ch_48k_1s", 1, 1), (BANK, 1, 1),
                         ("q4_stereo_48k_1s", 3, 5),
                         ("q2_6ch_48k_1s", 2, 33),
                         ("q0_stereo_48k_1s", 1, 31),
                         ("q2_mono_48k_1s", 5, 4)):
        info = infos[name]
        hfr, cfg = K.transform_config(info)
        args, noise = random_transform_inputs(g, Bs, Fs, info.channels, dev)
        for key, nz in (("hca_transform", None),
                        ("hca_transform_pns", noise)):
            pk = K.hca_decode_transform_batched(*args, hfr, noise=nz, **cfg)
            pt = K.decode_transform_plain(*args, hfr, noise=nz, **cfg)
            worst[key] = max(worst[key], require_equal(
                f"B3 tile edge {name} {Bs}x{Fs}", [("pcm", pk, pt)]))
        log(f"B3 random {name} at {Bs} x {Fs} frames (T = {Fs * 8}), "
            f"without and with PNS maps: byte-equal to the twin")
    torch.cuda.synchronize()

    # -- phase 4: the slice, through the public entry point -----------------
    bank = [blobs[BANK]] * BANK_STREAMS
    hca_kernels = ("hca_side_info", "hca_coefficients", "hca_transform")
    wavs, counts = drive("decode_batch", hca_kernels,
                         lambda: port.decode_batch(bank, device=dev))
    launches = {k: counts[k] for k in hca_kernels}
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
    BANKS["hca_decode_batch_s"] = wall
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
    n_frames = CHUNK * F
    C = bank_info.channels
    bounds = {
        "hca_side_info": bound("hca_side_info",
                               side_info_bytes(up, side_k),
                               nbytes(*side_k[:3])),
        "hca_coefficients": bound("hca_coefficients",
                                  nbytes(dec, side_k[1], side_k[3], qc_k),
                                  qc_k.numel()),
        "hca_transform": bound("hca_transform",
                               nbytes(qc4, sf4, res4, in4)
                               + n_frames * 8 * 128 * C * 2,
                               n_frames * 8 * 128 * C),
    }
    results = {}
    for name, (kernel, twin) in timed.items():
        ms = cuda_ms(kernel, 20)
        plain_ms = cuda_ms(twin, 3)
        log(f"{name} [{card}] at {CHUNK}x{F} frames: kernel {ms:.4f} ms, "
            f"twin {plain_ms:.4f} ms, bound {bounds[name]['bound_ms']:.4f} "
            f"ms by {bounds[name]['bound_by']}")
        results[name] = (ms, plain_ms, bounds[name])

    # -- phases 6-8: the ADX codec ------------------------------------------
    results.update(adx_phases(dev, card, worst, launches))

    # -- phases 9-11: the HCA encode -----------------------------------------
    results.update(hca_encode_phases(dev, card, worst, launches))

    # -- phase 12: the v3 PNS noise fill -------------------------------------
    results.update(pns_phase(dev, card, worst, launches))

    # -- phase 13: the AHX / MPEG Layer II decode ----------------------------
    results.update(ahx_phase(dev, card, worst, launches))

    # -- phase 14: B4/B5, the key search, the zero-coded_count decode --------
    results.update(keysearch_phase(dev, card, worst, launches))

    # -- phase 15: the AWB/ACB banks, the single-file surfaces, the CLI -------
    bank_phase(dev, card, expected)

    # -- phase 16: the AHX / MPEG Layer II encode ----------------------------
    results.update(ahx_encode_phase(dev, card, worst, launches))

    # -- phase 17: the remaining single-device surfaces ------------------------
    surfaces_phase(dev, card)

    # -- phase 18: the sharded paths and the CriCodecs module ------------------
    mesh_phase(dev, card)

    # -- phase 19: CPK, USM and IVF; CRILAYLA's kernels -------------------------
    results.update(containers_phase(dev, card, worst, launches))

    report = []
    for name, (ms, plain_ms, bd, *library) in results.items():
        report.append(dict(name=name, route="cuda", **KERNELS[name],
                           launches=launches[name],
                           max_abs_err=worst[name], ms=ms,
                           plain_ms=plain_ms, **bd,
                           library_ms=library[0] if library else None))
    log(json.dumps({"banks": BANKS, "card": card}))
    log(json.dumps({"kernels": report}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
