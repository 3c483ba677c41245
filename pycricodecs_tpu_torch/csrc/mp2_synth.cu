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
//   s[t][k] = ((2c + 1 - n) / n) * sf[sfidx[row / 12]], 0 where n == 0 (the
//     quotient correctly rounded);
//   V[t][q] = s[t][0] * nt[0][q], then += s[t][k] * nt[k][q], k = 1..31;
//   o[j] = D[j] * V[t][j] + D[32 + j] * V[t-1][32 + j], then for m = 1..7
//          + D[64m + j] * V[t-2m][j] + D[64m + 32 + j] * V[t-2m-1][32 + j],
//          with V = 0 before the stream start;
//   pcm = clamp(floor(o * 32768 + 0.5), -32768, 32767).
// Inputs codes u16 [B, F, C, 36, 32], levels i32 [B, F, C, 32], sfidx u8
// [B, F, C, 3, 32]; output i16 [B, C, F * 1152] (t = f * 36 + row).
//
// What bounds it on this card: operations. Per output sample it does 64
// multiplies and 63 adds of matrixing and 16 + 15 of window in f64, against
// 2-4 bytes moved, and with FMA off each multiply and add is its own DMUL or
// DADD instruction at the f64 rate (64 lanes an SM: a warp's f64
// instruction holds the pipe two cycles, leaving one issue slot for
// anything else).
//
// Design: the FIR has no recurrence (V[t] depends on s[t] only), so a
// block takes a segment of kSegTiles tiles of kTile rows of one (stream,
// channel) and walks them in order, carrying the last 15 V rows (the
// window's reach) from tile to tile in shared memory; only a segment's
// first tile recomputes 16 rows before it (the halo, 16 / 576 = 2.8 % of
// the matrixing). Per tile, four warps: (1) dequantise the tile's samples
// into S, from codes loaded a tile ahead (so no load from device memory
// stalls the phase) and, for a Layer II class n, the quotient from a
// reciprocal table with an exact remainder correction instead of the
// dozen-instruction __ddiv_rn (the same correctly rounded value); (2)
// matrixing, each thread one column q of nt (32 doubles in registers)
// against four rows at a time, S read as 16-byte double2 broadcasts, so
// each shared load feeds 4 f64 ops; (3) window, each warp 16 consecutive
// rows of its 32 columns j with a 16-slot register ring of the rows'
// V[.][j] and V[.][32 + j]: each V value is loaded once per thread, the
// ring's slots are compile-time (the loop is unrolled by the ring length),
// the 16 taps of column j are in registers; (4) the last 15 V rows move to
// the front. S (64 x 32) and V (79 x 64) take 56,832 bytes, so four
// 128-thread blocks fit an SM; the per-tile reloads of nt's column and the
// taps keep the phases' registers apart (at most 128 a thread).
#include <cstdint>
#include <cuda_runtime.h>

#include "hca_tables.inc"  // generated by _build.py (kMp2Sf, kMp2Nt,
                           // kMp2Dwin, kMp2Recip)

namespace {

constexpr int kTile = 64;          // rows a tile
constexpr int kHalo = 15;          // V rows before a row that its window reads
constexpr int kVRows = kTile + kHalo;
constexpr int kSegTiles = 9;       // tiles a block walks
constexpr int kPrologue = 48;      // first S row of a segment's halo pass
constexpr int kThreads = 128;
constexpr size_t kSmemBytes = (size_t)(kTile * 32 + kVRows * 64) *
                              sizeof(double);

// RN(a / n) for a = 2 code + 1 - n. Where code < n (so |a| < n) and n is
// a Layer II class (3, 5, 9 or 2^k - 1): y = RN(1 / n) from kMp2Recip,
// q = RN(a * y), the exact remainder r = a - q * n (one fused
// multiply-add, exact as q is within an ulp of a / n) and RN(q + r * y),
// the correctly rounded quotient that __ddiv_rn gives (held for every
// class and every such a by tests/test_torch_synth_tile.py); otherwise
// __ddiv_rn.
__device__ __forceinline__ double quotient(double a, int n, uint32_t code) {
  int idx = -1;
  if ((int)code >= n) {
    idx = -1;
  } else if (n == 5) {
    idx = 0;
  } else if (n == 9) {
    idx = 1;
  } else if (n > 2 && n <= 65535 && (n & (n + 1)) == 0) {
    idx = __popc(n);  // 2^k - 1 -> k
  }
  if (idx < 0) return __ddiv_rn(a, (double)n);
  const double y = kMp2Recip[idx];
  const double q = __dmul_rn(a, y);
  const double r = __fma_rn(-q, (double)n, a);
  return __fma_rn(r, y, q);
}

// Thread tid stages subbands 2p, 2p + 1 (p = tid % 16) of tile rows
// tid / 16 + 8 i, i = 0..7: its codes as one 32-bit load a row, issued a
// tile ahead (cq), so the dequantisation waits on no load from device
// memory but the cached levels and scalefactor indices.
constexpr int kRowsPer = kTile * 16 / kThreads;   // 8

__device__ __forceinline__ void load_codes(
    const uint16_t* __restrict__ codes, int b, int c, int F, int C, int T,
    int t0, uint32_t (&cq)[kRowsPer]) {
  const int p = threadIdx.x & 15, r0 = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    const int t = t0 + r0 + 8 * i;
    cq[i] = 0;
    if (t >= 0 && t < T) {
      const int f = t / 36, row = t - f * 36;
      const size_t fc = ((size_t)b * F + f) * C + c;
      cq[i] = __ldg(reinterpret_cast<const uint32_t*>(
          codes + (fc * 36 + row) * 32) + p);
    }
  }
}

// S rows r_lo..kTile-1 <- dequantised samples of t = t0 + r (0 outside
// 0 <= t < T), from the codes load_codes staged for t0
__device__ __forceinline__ void dequantise(
    const int32_t* __restrict__ levels, const uint8_t* __restrict__ sfidx,
    int b, int c, int F, int C, int T, int t0, int r_lo,
    const uint32_t (&cq)[kRowsPer], double* S) {
  const int p = threadIdx.x & 15, r0 = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    const int r = r0 + 8 * i, t = t0 + r;
    if (r < r_lo) continue;
    double2 s = make_double2(0.0, 0.0);
    if (t >= 0 && t < T) {
      const int f = t / 36, row = t - f * 36;
      const size_t fc = ((size_t)b * F + f) * C + c;
      const int2 lv = __ldg(reinterpret_cast<const int2*>(levels + fc * 32)
                            + p);
      const uint32_t si = __ldg(reinterpret_cast<const uint16_t*>(
          sfidx + (fc * 3 + row / 12) * 32) + p);
      const int n2[2] = {lv.x, lv.y};
      double v[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        v[h] = 0.0;
        if (n2[h] > 0) {
          // 2c + 1 - n, exact in int as in f64
          const uint32_t code = (cq[i] >> (16 * h)) & 0xFFFF;
          const double a = (double)(2 * (int)code + 1 - n2[h]);
          v[h] = __dmul_rn(quotient(a, n2[h], code),
                           kMp2Sf[(si >> (8 * h)) & 0xFF]);
        }
      }
      s = make_double2(v[0], v[1]);
    }
    reinterpret_cast<double2*>(S + r * 32)[p] = s;
  }
}

// V rows kHalo + r <- matrixing of S rows r, for r = r_lo..kTile-1 (r_lo a
// multiple of 8); k folded in order
__device__ __forceinline__ void matrixing(const double* S, double* V,
                                          int r_lo) {
  const int q = threadIdx.x & 63, g = threadIdx.x >> 6;
  double ntq[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) ntq[k] = kMp2Nt[k * 64 + q];
  for (int r0 = r_lo + 4 * g; r0 < kTile; r0 += 8) {
    const double2* s = reinterpret_cast<const double2*>(S + r0 * 32);
    double acc[4];
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const double2 sv = s[i * 16 + kk];
        acc[i] = kk == 0 ? __dmul_rn(sv.x, ntq[0])
                         : __dadd_rn(acc[i], __dmul_rn(sv.x, ntq[2 * kk]));
        acc[i] = __dadd_rn(acc[i], __dmul_rn(sv.y, ntq[2 * kk + 1]));
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) V[(kHalo + r0 + i) * 64 + q] = acc[i];
  }
}

// output rows t0 + r, r = 16 w .. 16 w + 15 for warp w, column j = lane
__device__ __forceinline__ void window(const double* V, int t0, int T,
                                       int16_t* __restrict__ o_bc) {
  const int w = threadIdx.x >> 5, j = threadIdx.x & 31;
  double de[8], dd[8];
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    de[m] = kMp2Dwin[64 * m + j];
    dd[m] = kMp2Dwin[64 * m + 32 + j];
  }
  // ring slot u % 16 holds V[u][j] (E) and V[u][32 + j] (O) of V row u;
  // output row r is V row kHalo + r
  const int u0 = 16 * w;
  double E[16], O[16];
#pragma unroll
  for (int i = 0; i < 15; ++i) {
    E[i] = V[(u0 + i) * 64 + j];
    O[i] = V[(u0 + i) * 64 + 32 + j];
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int u = u0 + 15 + i, sl = (15 + i) & 15;
    E[sl] = V[u * 64 + j];
    O[sl] = V[u * 64 + 32 + j];
    double o = __dmul_rn(de[0], E[sl]);
    o = __dadd_rn(o, __dmul_rn(dd[0], O[(sl + 15) & 15]));
#pragma unroll
    for (int m = 1; m < 8; ++m) {
      o = __dadd_rn(o, __dmul_rn(de[m], E[(sl + 16 - 2 * m) & 15]));
      o = __dadd_rn(o, __dmul_rn(dd[m], O[(sl + 15 - 2 * m) & 15]));
    }
    const int t = t0 + u0 + i;
    if (t < T) {
      // floor and convert in one instruction, then the clamp in int
      const int y = __double2int_rd(__dadd_rn(__dmul_rn(o, 32768.0), 0.5));
      o_bc[(size_t)t * 32 + j] = (int16_t)min(max(y, -32768), 32767);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 4)
mp2_synth_kernel(const uint16_t* __restrict__ codes,
                 const int32_t* __restrict__ levels,
                 const uint8_t* __restrict__ sfidx, int F, int C, int segs,
                 int16_t* __restrict__ out) {
  extern __shared__ double smem[];
  double* S = smem;                // [kTile][32] dequantised samples
  double* V = smem + kTile * 32;   // [kVRows][64]: 15 carried rows, the tile
  const int seg = blockIdx.x % segs;
  const int bc = blockIdx.x / segs;  // b * C + c
  const int b = bc / C, c = bc % C;
  const int T = F * 36;
  const int tiles = (T + kTile - 1) / kTile;
  const int tile_end = min((seg + 1) * kSegTiles, tiles);
  int16_t* o_bc = out + (size_t)bc * T * 32;
  const int tid = threadIdx.x;

  // the 15 V rows before the segment: zeros before the stream start, else
  // recomputed from the S rows kPrologue.. of the tile before
  int t0 = seg * kSegTiles * kTile;
  uint32_t cq[kRowsPer];
  if (seg == 0) {
    for (int i = tid; i < kHalo * 64; i += kThreads) V[i] = 0.0;
  } else {
    load_codes(codes, b, c, F, C, T, t0 - kTile, cq);
    dequantise(levels, sfidx, b, c, F, C, T, t0 - kTile, kPrologue, cq, S);
    __syncthreads();
    matrixing(S, V, kPrologue);
    __syncthreads();
    for (int i = tid; i < kHalo * 64; i += kThreads) V[i] = V[kTile * 64 + i];
  }
  load_codes(codes, b, c, F, C, T, t0, cq);
  for (int tile = seg * kSegTiles; tile < tile_end; ++tile, t0 += kTile) {
    dequantise(levels, sfidx, b, c, F, C, T, t0, 0, cq, S);
    // the next tile's codes, in flight through this tile's other phases
    if (tile + 1 < tile_end) load_codes(codes, b, c, F, C, T, t0 + kTile, cq);
    __syncthreads();
    matrixing(S, V, 0);
    __syncthreads();
    window(V, t0, T, o_bc);
    __syncthreads();
    for (int i = tid; i < kHalo * 64; i += kThreads) V[i] = V[kTile * 64 + i];
  }
}

}  // namespace

extern "C" int mp2_synth(const void* codes, const void* levels,
                         const void* sfidx, int B, int F, int C, void* out,
                         void* stream) {
  if (B < 1 || F < 1 || C < 1 || F > 0x7FFFFFFF / 36)
    return (int)cudaErrorInvalidValue;
  // codes are read as 32-bit pairs, levels as int2, sfidx as 16-bit pairs
  if ((reinterpret_cast<uintptr_t>(codes) & 3) != 0 ||
      (reinterpret_cast<uintptr_t>(levels) & 7) != 0 ||
      (reinterpret_cast<uintptr_t>(sfidx) & 1) != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaError_t e = cudaFuncSetAttribute(
      mp2_synth_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(mp2_synth_kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  const long long T = (long long)F * 36;
  const long long tiles = (T + kTile - 1) / kTile;
  const int segs = (int)((tiles + kSegTiles - 1) / kSegTiles);
  const long long blocks = (long long)segs * B * C;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  mp2_synth_kernel<<<(unsigned)blocks, kThreads, kSmemBytes,
                     (cudaStream_t)stream>>>(
      (const uint16_t*)codes, (const int32_t*)levels, (const uint8_t*)sfidx,
      F, C, segs, (int16_t*)out);
  return (int)cudaGetLastError();
}
