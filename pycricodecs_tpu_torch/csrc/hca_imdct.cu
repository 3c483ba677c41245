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
// against 28 f32 operations of the stage network (B4: 31 with the
// overlap-add), so the bytes bound them (491.8 MB at the HCA bank chunk's
// 128 x 3,752 rows: 0.147 ms at 3.35 TB/s); the network's 3,584 f32
// instructions a row come to about 0.05 ms at the card's f32 issue rate.
//
// Design: one thread owns a whole row. The DCT-IV runs in its registers as
// the slot schedule that _build.py generates into hca_dct4.inc
// (dct4_slots): every stage is an in-place butterfly on two of the 128
// slots with compile-time indices, the twiddles are f32 literals in the
// instructions, and where a result lands logically (the add/sub tree's
// index rotation, the twiddle stages' flip) is a relabelling of the slots
// fixed at build time (dct4_order: register renaming). So a row costs its
// float operations and nothing else: no shared-memory ping-pong, no index
// arithmetic, no barrier, no twiddle load. A warp moves 32 rows between
// device memory and a padded shared tile with coalesced float4 copies, one
// row per warp instruction; each thread then reads and writes its own row
// of the tile as float4s (the 132-float stride keeps a quarter-warp's rows
// in distinct banks). B4: lane l of a warp takes subframe t0 - 1 + l of
// one row; lane 0's subframe is the halo whose DCT is only the carry into
// lane 1 (recomputed, 1/31 extra work, so warps run in any order), and
// lanes 1-31 write the 31 subframes t0..t0+30. The carry is handed over in
// a second shared tile: each thread writes the first 64 DCT values, reads
// its left neighbour's and forms the overlap-add in the twins' order, two
// outputs per carried value. Every float op is one rounded IEEE multiply,
// add or subtract, in the twins' order (the _rn intrinsics are never
// contracted; the build also passes -fmad=false). No twiddle or window is
// loaded per row, so the grid is a plain one, a warp per 32 rows (B5) or
// per (row, 31 subframes) (B4), not a persistent loop.
#include <cstdint>
#include <cuda_runtime.h>

#include "hca_tables.inc"  // generated by _build.py from ops/hca_tables.py
#include "hca_dct4.inc"    // generated by _build.py: dct4_slots, dct4_order,
                           // dct4_row

namespace {

constexpr int kStride = 132;      // floats per row of the staged tile
constexpr int kHandStride = 68;   // floats per row of B4's carry tile
constexpr int kB5Warps = 2;       // B5: warps per block
constexpr int kOlaOut = 31;       // B4: subframes a warp writes

// Warp: rows src[row(r)] -> tile row r for r < 32, one row per instruction
// (each lane a float4); rows with !ok(r) are staged as zeros.
template <class Src>
__device__ __forceinline__ void load_rows(Src src, float* tile, int lane) {
#pragma unroll 8
  for (int r = 0; r < 32; ++r) {
    const float* p = src(r);
    const float4 v = p ? __ldg(reinterpret_cast<const float4*>(p) + lane)
                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    reinterpret_cast<float4*>(tile + r * kStride)[lane] = v;
  }
}

// Warp: tile row r -> dst(r) for the rows dst gives (nullptr: skip).
template <class Dst>
__device__ __forceinline__ void store_rows(Dst dst, const float* tile,
                                           int lane) {
#pragma unroll 8
  for (int r = 0; r < 32; ++r) {
    float* p = dst(r);
    if (p)
      reinterpret_cast<float4*>(p)[lane] =
          reinterpret_cast<const float4*>(tile + r * kStride)[lane];
  }
}

__global__ void __launch_bounds__(32)
hca_imdct_ola_kernel(const float* __restrict__ x, int T, int tiles,
                     float* __restrict__ out) {
  __shared__ __align__(16) float tile[32 * kStride];
  __shared__ __align__(16) float hand[32 * kHandStride];
  const int lane = threadIdx.x;
  const int r = blockIdx.x / tiles;
  const int t0 = (blockIdx.x % tiles) * kOlaOut;
  const float* xr = x + (size_t)r * T * 128;
  float* outr = out + (size_t)r * T * 128;
  // tile row l holds subframe t0 - 1 + l (zeros outside 0..T-1)
  load_rows([&](int l) -> const float* {
    const int t = t0 - 1 + l;
    return t >= 0 && t < T ? xr + (size_t)t * 128 : nullptr;
  }, tile, lane);
  __syncwarp();
  float y[128];
  dct4_row(tile + lane * kStride, y);
  // the carry: dct[0..63] of this subframe; a zero carry before the
  // row's first subframe
  const bool none = t0 - 1 + lane < 0;
  float4* h = reinterpret_cast<float4*>(hand + lane * kHandStride);
#pragma unroll
  for (int m = 0; m < 16; ++m)
    h[m] = none ? make_float4(0.0f, 0.0f, 0.0f, 0.0f)
                : make_float4(y[4 * m], y[4 * m + 1], y[4 * m + 2],
                              y[4 * m + 3]);
  __syncwarp();
  // overlap-add with the left neighbour's carry, two outputs per carried
  // value p: wave[63-p] and wave[64+p] both take dct[127-p] and prev[p];
  // written into this thread's own tile row (read only by it so far)
  const float4* pv =
      reinterpret_cast<const float4*>(hand + (lane > 0 ? lane - 1 : 0) *
                                                 kHandStride);
  float4* row = reinterpret_cast<float4*>(tile + lane * kStride);
#pragma unroll
  for (int m = 0; m < 16; ++m) {
    const float4 p4 = pv[m];
    const float pr[4] = {p4.x, p4.y, p4.z, p4.w};
    float lo[4], hi[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = 4 * m + e;
      const float d = y[127 - p];
      lo[e] = __fadd_rn(__fmul_rn(kImdctWindow[63 - p], d),
                        __fmul_rn(kImdctWindow[64 + p], pr[e]));
      hi[e] = __fsub_rn(__fmul_rn(kImdctWindow[64 + p], d),
                        __fmul_rn(kImdctWindow[63 - p], pr[e]));
    }
    row[15 - m] = make_float4(lo[3], lo[2], lo[1], lo[0]);  // 60-4m..63-4m
    row[16 + m] = make_float4(hi[0], hi[1], hi[2], hi[3]);  // 64+4m..
  }
  __syncwarp();
  store_rows([&](int l) -> float* {
    const int t = t0 - 1 + l;
    return l > 0 && t < T ? outr + (size_t)t * 128 : nullptr;
  }, tile, lane);
}

__global__ void __launch_bounds__(32 * kB5Warps)
hca_imdct_kernel(const float* __restrict__ x, long long rows,
                 float* __restrict__ out) {
  __shared__ __align__(16) float tiles[kB5Warps][32 * kStride];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long r0 = ((long long)blockIdx.x * kB5Warps + warp) * 32;
  if (r0 >= rows) return;  // warp-uniform: no block barrier
  const int n = (int)min(32LL, rows - r0);
  float* tile = tiles[warp];
  load_rows([&](int r) -> const float* {
    return r < n ? x + (size_t)(r0 + r) * 128 : nullptr;
  }, tile, lane);
  __syncwarp();
  float y[128];
  dct4_row(tile + lane * kStride, y);
  float4* row = reinterpret_cast<float4*>(tile + lane * kStride);
#pragma unroll
  for (int q = 0; q < 32; ++q)
    row[q] = make_float4(y[4 * q], y[4 * q + 1], y[4 * q + 2], y[4 * q + 3]);
  __syncwarp();
  store_rows([&](int r) -> float* {
    return r < n ? out + (size_t)(r0 + r) * 128 : nullptr;
  }, tile, lane);
}

}  // namespace

extern "C" int hca_imdct_ola(const void* x, int R, int T, void* out,
                             void* stream) {
  if (R < 1 || T < 1) return (int)cudaErrorInvalidValue;
  const int tiles = (T + kOlaOut - 1) / kOlaOut;
  const long long blocks = (long long)R * tiles;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  hca_imdct_ola_kernel<<<(unsigned)blocks, 32, 0, (cudaStream_t)stream>>>(
      (const float*)x, T, tiles, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int hca_imdct(const void* x, long long rows, void* out,
                         void* stream) {
  if (rows < 1) return (int)cudaErrorInvalidValue;
  const long long blocks = (rows + 32 * kB5Warps - 1) / (32 * kB5Warps);
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  hca_imdct_kernel<<<(unsigned)blocks, 32 * kB5Warps, 0,
                     (cudaStream_t)stream>>>((const float*)x, rows,
                                             (float*)out);
  return (int)cudaGetLastError();
}
