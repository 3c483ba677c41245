// HCA inverse MDCT kernels for Hopper (sm_90a): B4 (DCT-IV + windowed
// overlap-add) and B5 (DCT-IV alone).
//
// Replaces (TPU Pallas kernels of the JAX package):
//   B4 pycricodecs_tpu/ops/pallas_kernels.py imdct_ola_pallas
//      (body _imdct_ola_kernel), fed by hca_kernels.hca_decode_wave's
//      IMDCT + overlap-add tail
//   B5 pycricodecs_tpu/ops/pallas_kernels.py imdct_pallas (body _imdct_kernel)
// Plain PyTorch twins: pycricodecs_tpu_torch/ops/hca_kernels.py
// (imdct_ola_plain = window_overlap_add(imdct_butterflies(x)), and
// imdct_butterflies), equal by test on every f32 value (+0.0 and -0.0 count
// as equal, as B4's docstring allows for the JAX kernel).
//
// Computes, per 128-value row: the reference's 7 add/sub + 7 twiddle stage
// DCT-IV (hca.cpp:1898-1979); B4 then, per row of T subframes, the windowed
// overlap-add with the previous subframe's DCT output (hca.cpp:1981-2018),
// a zero carry for each row's first subframe:
//   wave[k]    = w[k]    * dct[64+k]  + w[127-k] * prev[63-k]   (k < 64)
//   wave[64+j] = w[64+j] * dct[127-j] - w[63-j]  * prev[j]
//
// What bounds them on this card: per value one f32 read and one f32 write
// against ~38 (B4) or ~35 (B5) f32 operations, so the bytes bound them
// (491.8 MB at the HCA bank chunk's 128 x 3,752 rows: 0.147 ms at
// 3.35 TB/s); the stage network's barriers and shared-memory shuffles are
// what the kernel actually pays.
//
// Design: one warp per row of values (B5) or per (row, tile of TT
// subframes) (B4); each lane owns 4 of the 128 values (lane + 32 q, so the
// loads and stores are coalesced), the stages ping-pong through the warp's
// shared-memory rows with __syncwarp() between them, and no block-wide
// barrier is needed. The TPU kernels' XOR-roll schedule, final lane
// permutation and 0/1 OLA matmuls worked around Mosaic's missing lane
// gathers; here every stage reads its operands by index. The overlap-add
// couples subframe t only to t-1, so a tile recomputes the DCT of the
// subframe before it as its carry (the halo recompute of B3) instead of the
// TPU kernel's sequential-grid carry, and tiles run in any order. Every
// float op is one rounded IEEE multiply, add or subtract, in the twins'
// order (the _rn intrinsics are never contracted; the build also passes
// -fmad=false).
#include <cstdint>
#include <cuda_runtime.h>

#include "hca_tables.inc"  // generated by _build.py from ops/hca_tables.py

namespace {

constexpr int kWarps = 8;      // warps (rows in flight) per block
constexpr int kTile = 32;      // B4: subframes per warp (one halo each)

// The 14-stage DCT-IV of the 128 values in buf[0]; the result is back in
// buf[0] (an even number of ping-pong stages). Lane owns k = lane + 32 q.
__device__ __forceinline__ void dct4_warp(float (*buf)[128], int lane) {
  int in = 0;
  // part 1: add/sub tree (hca.cpp:1906-1935)
  for (int i = 0; i < 7; ++i) {
    const int c2 = 64 >> i;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = lane + 32 * q;
      const int base = (k >> (7 - i)) << (7 - i);
      const int r = k & ((128 >> i) - 1);
      const int j = r < c2 ? r : r - c2;
      const float a = buf[in][base + 2 * j];
      const float b = buf[in][base + 2 * j + 1];
      buf[in ^ 1][k] = r < c2 ? __fadd_rn(a, b) : __fsub_rn(a, b);
    }
    in ^= 1;
    __syncwarp();
  }
  // part 2: twiddle stages (hca.cpp:1937-1972)
  for (int i = 0; i < 7; ++i) {
    const int c2 = 1 << i;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = lane + 32 * q;
      const int blk = k >> (i + 1);
      const int base = blk << (i + 1);
      const int r = k & ((2 << i) - 1);
      const int j = r < c2 ? r : c2 - 1 - (r - c2);
      const float sn = kImdctSin[i * 64 + blk * c2 + j];
      const float cs = kImdctCos[i * 64 + blk * c2 + j];
      const float s1 = buf[in][base + j];
      const float s2 = buf[in][base + c2 + j];
      buf[in ^ 1][k] =
          r < c2 ? __fsub_rn(__fmul_rn(s1, sn), __fmul_rn(s2, cs))
                 : __fadd_rn(__fmul_rn(s1, cs), __fmul_rn(s2, sn));
    }
    in ^= 1;
    __syncwarp();
  }
}

__global__ void __launch_bounds__(32 * kWarps)
hca_imdct_ola_kernel(const float* __restrict__ x, int R, int T, int tiles,
                     float* __restrict__ out) {
  __shared__ float buf[kWarps][2][128];
  __shared__ float prev[kWarps][128];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long w = (long long)blockIdx.x * kWarps + warp;
  if (w >= (long long)R * tiles) return;  // warp-uniform: no block barrier
  const int r = (int)(w / tiles);
  const int t0 = (int)(w % tiles) * kTile;
  const int t1 = min(t0 + kTile, T);
  float (*b)[128] = buf[warp];
  float* p = prev[warp];
#pragma unroll
  for (int q = 0; q < 4; ++q) p[lane + 32 * q] = 0.0f;
  for (int t = (t0 > 0 ? t0 - 1 : t0); t < t1; ++t) {
    const float* src = x + ((size_t)r * T + t) * 128;
#pragma unroll
    for (int q = 0; q < 4; ++q) b[0][lane + 32 * q] = src[lane + 32 * q];
    __syncwarp();
    dct4_warp(b, lane);
    if (t >= t0) {
      float* dst = out + ((size_t)r * T + t) * 128;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = lane + 32 * q;
        float wave;
        if (k < 64) {
          const float pv = __fmul_rn(kImdctWindow[127 - k], p[63 - k]);
          wave = __fadd_rn(__fmul_rn(kImdctWindow[k], b[0][64 + k]), pv);
        } else {
          const int j = k - 64;
          const float pv = __fmul_rn(kImdctWindow[63 - j], p[j]);
          wave = __fsub_rn(__fmul_rn(kImdctWindow[64 + j], b[0][127 - j]),
                           pv);
        }
        dst[k] = wave;
      }
    }
    __syncwarp();  // every lane is done reading prev and b[0]
#pragma unroll
    for (int q = 0; q < 4; ++q) p[lane + 32 * q] = b[0][lane + 32 * q];
    __syncwarp();
  }
}

__global__ void __launch_bounds__(32 * kWarps)
hca_imdct_kernel(const float* __restrict__ x, long long rows,
                 float* __restrict__ out) {
  __shared__ float buf[kWarps][2][128];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + warp;
  if (row >= rows) return;  // warp-uniform: no block barrier
  float (*b)[128] = buf[warp];
  const float* src = x + (size_t)row * 128;
#pragma unroll
  for (int q = 0; q < 4; ++q) b[0][lane + 32 * q] = src[lane + 32 * q];
  __syncwarp();
  dct4_warp(b, lane);
  float* dst = out + (size_t)row * 128;
#pragma unroll
  for (int q = 0; q < 4; ++q) dst[lane + 32 * q] = b[0][lane + 32 * q];
}

}  // namespace

extern "C" int hca_imdct_ola(const void* x, int R, int T, void* out,
                             void* stream) {
  if (R < 1 || T < 1) return (int)cudaErrorInvalidValue;
  const int tiles = (T + kTile - 1) / kTile;
  const long long warps = (long long)R * tiles;
  const long long blocks = (warps + kWarps - 1) / kWarps;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  hca_imdct_ola_kernel<<<(unsigned)blocks, 32 * kWarps, 0,
                         (cudaStream_t)stream>>>(
      (const float*)x, R, T, tiles, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int hca_imdct(const void* x, long long rows, void* out,
                         void* stream) {
  if (rows < 1) return (int)cudaErrorInvalidValue;
  const long long blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  hca_imdct_kernel<<<(unsigned)blocks, 32 * kWarps, 0,
                     (cudaStream_t)stream>>>((const float*)x, rows,
                                             (float*)out);
  return (int)cudaGetLastError();
}
