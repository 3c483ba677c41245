// MPEG Layer II analysis filterbank kernel for Hopper (sm_90a): K1
// mp2_analysis.
//
// Not a TPU Pallas kernel: in the JAX package the encoder's analysis is
// numpy on the host (pycricodecs_tpu/ops/mp2_kernels.py analyze_fast, the
// f64 lane of models/ahx.py encode_mp2), ending in a BLAS matmul Y @ M.T
// whose summation order is the BLAS build's. The port fixes one order and
// holds the encode to that lane's bytes (no fixture's scalefactor pick,
// quantisation floor or allocation test flips; the spectra differ by at most
// 1.4e-17 on the AHX bank). Plain PyTorch twin:
// pycricodecs_tpu_torch/ops/mp2_kernels.py (analyze_plain), bit-equal by
// test.
//
// Computes, per (stream, channel) row of PCM16 and per 32-sample block t, in
// float64 with one rounding per op (the _rn intrinsics are never
// contracted; the build passes -fmad=false):
//   x = pcm / 32768 (exact), 0 before the row start;
//   Y[t][q] = 0.0 + C[q] * x(t - h, m), then += C[q + 64r] * x(t - h - 2r, m)
//     for r = 1..7, with q = 32h + m, x(j, m) = sample 32j + 31 - m and C
//     the analysis window D / 32 (kMp2Cwin);
//   S[t][k] = Y[t][0] * M[k][0], then += Y[t][q] * M[k][q] for q = 1..63.
// Input PCM i16 [R, T * 32] (R = streams x channels); output S f64
// [R, T, 32].
//
// What bounds it on this card: operations. A block of 32 samples takes
// 1,024 f64 operations of window fold and 4,064 of matrixing against 64
// bytes in and 256 out, and with FMA off each multiply and add is its own
// DMUL or DADD at the f64 rate (17e12/s on 132 SMs).
//
// Design: a CTA of 256 threads takes 64 blocks of one row. It stages the
// PCM of those blocks and the 15 before them (the window's reach) with
// 16-byte loads as doubles in shared memory (zeros outside the row), with
// the transposed matrix Mt[q][k]. Fold: thread (q, row group) keeps its 8
// window taps in registers and folds 16 rows, each tap's sample read
// conflict-free (a warp's lanes read 32 neighbouring samples). Matrixing:
// thread k = lane keeps 8 row sums, each Mt[q][k] load (neighbouring lanes,
// neighbouring words) feeds 8 multiplies and each Y[t][q] read is a warp
// broadcast. Shared memory: 79 x 32 + 64 x 64 + 64 x 32 doubles = 69,376
// bytes, three CTAs an SM.
#include <cstdint>
#include <cuda_runtime.h>

#include "hca_tables.inc"  // generated by _build.py (kMp2Am, kMp2Cwin)

namespace {

constexpr int kTile = 64;          // blocks (rows of S) a CTA
constexpr int kHalo = 15;          // blocks before a row that its window reads
constexpr int kStaged = kTile + kHalo;
constexpr int kThreads = 256;
constexpr size_t kSmemBytes =
    (size_t)(kStaged * 32 + kTile * 64 + 64 * 32) * sizeof(double);

__global__ void __launch_bounds__(kThreads)
    mp2_analysis_kernel(const int16_t* __restrict__ pcm, int T, int tiles,
                        double* __restrict__ out) {
  extern __shared__ double smem[];
  double* xs = smem;                    // [kStaged][32]: blocks t0 - 15 ..
  double* Y = xs + kStaged * 32;        // [kTile][64]
  double* Mt = Y + kTile * 64;          // [64][32]
  const int tid = threadIdx.x;
  const int tile = blockIdx.x % tiles;
  const long long row = blockIdx.x / tiles;
  const int t0 = tile * kTile;
  const int16_t* src = pcm + row * (long long)T * 32;
  for (int i = tid; i < 64 * 32; i += kThreads)
    Mt[i] = kMp2Am[(i & 31) * 64 + (i >> 5)];
  // 8 samples a 16-byte chunk, 4 chunks a block; a chunk lies wholly in or
  // out of the row (rows start on 64-byte boundaries of a 16-byte aligned
  // base)
  for (int i = tid; i < kStaged * 4; i += kThreads) {
    const int j = t0 - kHalo + (i >> 2);
    double* d = xs + i * 8;
    if (j >= 0 && j < T) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(
          src + (long long)j * 32 + (i & 3) * 8));
      const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // x = pcm / 32768: a multiply by 2^-15, exact like the division
        d[2 * e] = __dmul_rn((double)(int16_t)(w[e] & 0xFFFF), 0x1p-15);
        d[2 * e + 1] = __dmul_rn((double)(int16_t)(w[e] >> 16), 0x1p-15);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) d[e] = 0.0;
    }
  }
  __syncthreads();
  {
    // fold: thread q = tid % 64 (h = q / 32, m = q % 32), rows tid / 64 + 4i
    const int q = tid & 63, h = q >> 5, m = q & 31;
    double w[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) w[r] = kMp2Cwin[q + 64 * r];
    for (int rr = tid >> 6; rr < kTile; rr += kThreads / 64) {
      double y = 0.0;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        // block t0 + rr - h - 2r sits at staged row rr + 15 - h - 2r
        const double xv = xs[(rr + kHalo - h - 2 * r) * 32 + 31 - m];
        y = __dadd_rn(y, __dmul_rn(w[r], xv));
      }
      Y[rr * 64 + q] = y;
    }
  }
  __syncthreads();
  // matrixing: thread k = lane, rows warp + 8i
  const int k = tid & 31, r0 = tid >> 5;
  double acc[8];
  {
    const double m0 = Mt[k];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = __dmul_rn(Y[(r0 + 8 * i) * 64], m0);
  }
  for (int q = 1; q < 64; ++q) {
    const double mq = Mt[q * 32 + k];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      acc[i] = __dadd_rn(acc[i], __dmul_rn(Y[(r0 + 8 * i) * 64 + q], mq));
  }
  double* dst = out + row * (long long)T * 32;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = t0 + r0 + 8 * i;
    if (t < T) dst[(long long)t * 32 + k] = acc[i];
  }
}

}  // namespace

extern "C" int mp2_analysis(const void* pcm, long long rows, int T, void* out,
                            void* stream) {
  if (rows < 1 || T < 1) return (int)cudaErrorInvalidValue;
  // PCM is staged in 16-byte chunks
  if ((reinterpret_cast<uintptr_t>(pcm) & 15) != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaError_t e = cudaFuncSetAttribute(
      mp2_analysis_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  const long long tiles = (T + kTile - 1) / kTile;
  const long long blocks = rows * tiles;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  mp2_analysis_kernel<<<(unsigned)blocks, kThreads, kSmemBytes,
                        (cudaStream_t)stream>>>((const int16_t*)pcm, T,
                                                (int)tiles, (double*)out);
  return (int)cudaGetLastError();
}
