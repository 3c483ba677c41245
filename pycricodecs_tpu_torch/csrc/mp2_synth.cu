// MPEG Layer II synthesis kernel for Hopper (sm_90a): mp2_synth.
//
// Not a TPU Pallas kernel: in the JAX package this step is two f32 XLA
// matmuls (pycricodecs_tpu/ops/mp2_kernels.py _decode_jax_impl), which agree
// with its host lane only within 1 LSB. The port holds the AHX decode to the
// host lane byte for byte: mp2_kernels.decode_pcm16_host, i.e. the native
// f64 V-FIFO synthesis cri_mp2_synthesize
// (pycricodecs_tpu/native/cricore.cpp:3026-3139). A matmul (cuBLAS) fixes no
// summation order, so this kernel does that lane's arithmetic itself.
// Plain PyTorch twin: pycricodecs_tpu_torch/ops/mp2_kernels.py
// (synthesize_plain), bit-equal by test.
//
// Computes, per (stream, channel), in float64 with one rounding per op (the
// _rn intrinsics are never contracted; the build passes -fmad=false):
//   s[t][k] = ((2c + 1 - n) / n) * sf[sfidx[row / 12]], 0 where n == 0;
//   V[t][q] = s[t][0] * nt[0][q], then += s[t][k] * nt[k][q], k = 1..31;
//   o[j] = D[j] * V[t][j] + D[32 + j] * V[t-1][32 + j], then for m = 1..7
//          + D[64m + j] * V[t-2m][j] + D[64m + 32 + j] * V[t-2m-1][32 + j],
//          with V = 0 before the stream start;
//   pcm = clamp(floor(o * 32768 + 0.5), -32768, 32767).
// Inputs codes u16 [B, F, C, 36, 32], levels i32 [B, F, C, 32], sfidx u8
// [B, F, C, 3, 32]; output i16 [B, C, F * 1152] (t = f * 36 + row).
//
// What bounds it on this card: operations. Per output sample it does 64
// multiplies and 64 adds of matrixing and 16 + 16 of window in f64, against
// 2-4 bytes moved, and with FMA off each multiply and add is its own DMUL or
// DADD instruction at the f64 rate.
//
// Design: the FIR has no recurrence (V[t] depends on s[t] only), so blocks
// are independent: one block per (stream, channel, tile of 128 rows). It
// dequantises the tile and the 15 rows before it (the window's halo) into
// shared memory, computes their V rows (each thread keeps one column q of
// nt in registers and folds k in order over two rows at a time), then
// windows: each thread keeps the 16 taps of its output column j in
// registers. The halo costs 15/128 of the matrixing again.
#include <cstdint>
#include <cuda_runtime.h>

#include "hca_tables.inc"  // generated by _build.py (kMp2Sf, kMp2Nt, kMp2Dwin)

namespace {

constexpr int kTile = 128;
constexpr int kHalo = 15;
constexpr int kRows = kTile + kHalo;
constexpr int kThreads = 256;
constexpr size_t kSmemBytes = (size_t)kRows * (32 + 64) * sizeof(double);

__global__ void __launch_bounds__(kThreads)
mp2_synth_kernel(const uint16_t* __restrict__ codes,
                 const int32_t* __restrict__ levels,
                 const uint8_t* __restrict__ sfidx, int F, int C, int tiles,
                 int16_t* __restrict__ out) {
  extern __shared__ double smem[];
  double* S = smem;               // [kRows][32] dequantised subband samples
  double* V = smem + kRows * 32;  // [kRows][64] matrixed rows
  const int tile = blockIdx.x % tiles;
  const int bc = blockIdx.x / tiles;  // b * C + c
  const int b = bc / C, c = bc % C;
  const long long T = (long long)F * 36;
  const long long t0 = (long long)tile * kTile - kHalo;  // global t of row 0
  const int tid = threadIdx.x;

  // 1. dequantise rows with 0 <= t < T
  for (int i = tid; i < kRows * 32; i += kThreads) {
    const int r = i >> 5, sb = i & 31;
    const long long t = t0 + r;
    if (t < 0 || t >= T) continue;
    const long long f = t / 36;
    const int row = (int)(t % 36);
    const size_t fc = ((size_t)b * F + f) * C + c;
    const int32_t lv = levels[fc * 32 + sb];
    double s = 0.0;
    if (lv > 0) {
      const double n = (double)lv;
      const double cq = (double)codes[(fc * 36 + row) * 32 + sb];
      const double sf = kMp2Sf[sfidx[(fc * 3 + row / 12) * 32 + sb]];
      s = __dmul_rn(__ddiv_rn(__dsub_rn(__dadd_rn(__dmul_rn(2.0, cq), 1.0),
                                        n),
                              n),
                    sf);
    }
    S[i] = s;
  }
  __syncthreads();

  // 2. matrixing: V[r][q], k folded in order; V = 0 before the stream start
  {
    const int q = tid & 63, g = tid >> 6;
    double ntq[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) ntq[k] = kMp2Nt[k * 64 + q];
    for (int r0 = g; r0 < kRows; r0 += 8) {
      const int r1 = r0 + 4;
      const long long ta = t0 + r0, tb = t0 + r1;
      const bool va = ta >= 0 && ta < T;
      const bool vb = r1 < kRows && tb >= 0 && tb < T;
      const double* sa = S + r0 * 32;
      const double* sbp = S + (vb ? r1 : r0) * 32;
      double acc0 = __dmul_rn(sa[0], ntq[0]);
      double acc1 = __dmul_rn(sbp[0], ntq[0]);
#pragma unroll
      for (int k = 1; k < 32; ++k) {
        acc0 = __dadd_rn(acc0, __dmul_rn(sa[k], ntq[k]));
        acc1 = __dadd_rn(acc1, __dmul_rn(sbp[k], ntq[k]));
      }
      if (ta < T) V[r0 * 64 + q] = va ? acc0 : 0.0;
      if (r1 < kRows && tb < T) V[r1 * 64 + q] = vb ? acc1 : 0.0;
    }
  }
  __syncthreads();

  // 3. window the tile's rows
  {
    const int j = tid & 31, rg = tid >> 5;
    double de[8], dd[8];
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      de[m] = kMp2Dwin[64 * m + j];
      dd[m] = kMp2Dwin[64 * m + 32 + j];
    }
    int16_t* o_bc = out + (size_t)bc * T * 32;
    for (int r = kHalo + rg; r < kRows; r += 8) {
      const long long t = t0 + r;
      if (t >= T) break;
      double o = __dmul_rn(de[0], V[r * 64 + j]);
      o = __dadd_rn(o, __dmul_rn(dd[0], V[(r - 1) * 64 + 32 + j]));
#pragma unroll
      for (int m = 1; m < 8; ++m) {
        o = __dadd_rn(o, __dmul_rn(de[m], V[(r - 2 * m) * 64 + j]));
        o = __dadd_rn(o, __dmul_rn(dd[m], V[(r - 2 * m - 1) * 64 + 32 + j]));
      }
      double y = floor(__dadd_rn(__dmul_rn(o, 32768.0), 0.5));
      y = fmin(fmax(y, -32768.0), 32767.0);
      o_bc[t * 32 + j] = (int16_t)y;
    }
  }
}

}  // namespace

extern "C" int mp2_synth(const void* codes, const void* levels,
                         const void* sfidx, int B, int F, int C, void* out,
                         void* stream) {
  if (B < 1 || F < 1 || C < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      mp2_synth_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  const long long T = (long long)F * 36;
  const int tiles = (int)((T + kTile - 1) / kTile);
  const long long blocks = (long long)tiles * B * C;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  mp2_synth_kernel<<<(unsigned)blocks, kThreads, kSmemBytes,
                     (cudaStream_t)stream>>>(
      (const uint16_t*)codes, (const int32_t*)levels, (const uint8_t*)sfidx,
      F, C, tiles, (int16_t*)out);
  return (int)cudaGetLastError();
}
