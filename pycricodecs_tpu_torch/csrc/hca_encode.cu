// HCA encoder MDCT kernel for Hopper (sm_90a): B6.
//
// Replaces (TPU Pallas kernel of the JAX package):
//   B6 pycricodecs_tpu/ops/pallas_kernels.py mdct_enc_pallas
//      (body _enc_mdct_kernel, constants _build_enc_mdct_constants)
// Plain PyTorch twin: pycricodecs_tpu_torch/ops/hca_encode_device.py
// mdct_plain (= the JAX package's hca_encode_device._mdct + _dct4),
// bit-equal by test (f32 compared as its bits, signed zeros included).
//
// Computes, per 128-sample block of a stream channel (a "row"): wave =
// pcm / 32768 for the block and the previous one (zero before a stream
// channel's first block), the window fold (hca.cpp:2529-2553)
//   first[j]  = w[63-j] * -x[64+j] - (-w[64+j]) * x[63-j]      j < 64
//   second[j] = w[j] * p[j] - (-w[127-j]) * p[127-j]
// the DCT-IV (hca.cpp:2481-2527): pre-rotation by the stage-7 twiddles,
// six butterfly stages, the SHUFFLE_TABLE gather, times 0.125. In: i16
// [rows, 128] (rows = B * C * T, a stream channel's T blocks contiguous,
// 16-byte aligned); out: f32 [rows, 128].
//
// What bounds it on this card: the bytes. A row reads 256 bytes of PCM
// and writes 512 bytes of spectra (1.47 GB at the HCA encode bank of
// 1,920,000 rows: 0.4404 ms at 3.35 TB/s), against ~23 f32 operations a
// value (0.17 ms at the f32 issue rate with -fmad=false) and two int16
// conversions a value. On "NVIDIA H100 80GB HBM3, 700.00 W" it ran 0.5530-
// 0.5574 ms a launch back to back (tools/time_mdct_mp2unpack.py), 79 % of
// the bytes bound: ptxas gives 152 registers, no spill, so 12 warps an SM,
// whose staging, ~3,850 SASS instructions a row and stores overlap;
// one-warp CTAs, 128 registers (spills), streaming stores and an
// integer-add conversion of the PCM were no faster (PERF.md).
//
// Design (B4/B5's method, csrc/hca_imdct.cu): one thread owns one row.
// A one-warp tile is 32 consecutive rows plus the row before them (the
// halo): the warp stages its 33 x 256 contiguous bytes of PCM once into
// shared memory as int16 with 16-byte cp.async copies (272-byte rows, so a
// quarter-warp's 16-byte row reads fall in distinct banks), so the PCM is
// read from device memory once, plus 1/32 for the halo. A thread folds its
// row from its own staged row and its left neighbour's, 8 values at a time
// (a row % T == 0 folds with zeros: the previous block is masked to 0, even
// where the tile crosses into a new stream channel), then runs the DCT-IV
// as the slot schedule that _build.py generates into hca_mdct.inc
// (mdct_fold, mdct_slots, mdct_order): window values and twiddles are f32
// literals in the instructions, and the pre-rotation's landing and the
// SHUFFLE_TABLE gather are a relabelling of the slots fixed at build time.
// So a row costs its float operations and its conversions: no
// shared-memory round trip between stages, no barrier, no table load. The
// results, times 0.125, go through a 132-float-stride tile that aliases
// the int16 stage, and leave with coalesced float4 stores, one row a warp
// instruction. Every float op is one rounded IEEE multiply, add or
// subtract, in the twin's order (the _rn intrinsics are never contracted;
// the build also passes -fmad=false); the int16 -> wave conversion is
// exact.
#include <cstdint>
#include <cuda_runtime.h>

#include "hca_mdct.inc"  // generated by _build.py: mdct_fold, mdct_slots,
                         // mdct_order

namespace {

constexpr int kWarps = 2;           // one-warp tiles per CTA
constexpr int kInStride = 272;      // bytes per staged int16 row
constexpr int kOutStride = 132;     // floats per staged f32 row
constexpr float kScale = 1.0f / 32768.0f;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// 8 int16 (a 16-byte word, AND-masked by m) -> wave floats
__device__ __forceinline__ void wave8(uint4 q, uint32_t m, float (&f)[8]) {
  const uint32_t w[4] = {q.x & m, q.y & m, q.z & m, q.w & m};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __fmul_rn(__int2float_rn((int)(int16_t)(w[i] & 0xFFFFu)),
                         kScale);
    f[2 * i + 1] = __fmul_rn(__int2float_rn((int)w[i] >> 16), kScale);
  }
}

__global__ void __launch_bounds__(32 * kWarps)
hca_mdct_kernel(const int16_t* __restrict__ pcm, long long rows, int T,
                float* __restrict__ out) {
  // per warp: the int16 stage (33 x 272 bytes), then the f32 tile over it
  __shared__ __align__(16) float tiles[kWarps][32 * kOutStride];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long r0 = ((long long)blockIdx.x * kWarps + warp) * 32;
  if (r0 >= rows) return;  // warp-uniform: no block barrier
  const int n = (int)min(32LL, rows - r0);
  char* stage = reinterpret_cast<char*>(tiles[warp]);
  // stage row s holds row r0 - 1 + s; 16 chunks of 16 bytes a row
  const char* src = reinterpret_cast<const char*>(pcm) + (r0 - 1) * 256;
  const int chunks = (n + 1) * 16;
#pragma unroll 4
  for (int c = lane + (r0 == 0 ? 16 : 0); c < chunks; c += 32)
    cp_async16(stage + (c >> 4) * kInStride + (c & 15) * 16, src + c * 16);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();

  // lanes >= n fold rows that were never staged; their results are dropped
  const uint32_t keep = (r0 + lane) % T == 0 ? 0u : 0xFFFFFFFFu;
  const uint4* own = reinterpret_cast<const uint4*>(stage +
                                                    (lane + 1) * kInStride);
  const uint4* prv = reinterpret_cast<const uint4*>(stage + lane * kInStride);
  float v[128];
  mdct_fold(
      v, [&](int c, float (&f)[8]) { wave8(own[c], 0xFFFFFFFFu, f); },
      [&](int c, float (&f)[8]) { wave8(prv[c], keep, f); });
  mdct_slots(v);
  float y[128];
  mdct_order(v, y);
  __syncwarp();  // every lane has read the stage: the f32 tile takes it over
  float4* trow = reinterpret_cast<float4*>(tiles[warp] + lane * kOutStride);
#pragma unroll
  for (int q = 0; q < 32; ++q)
    trow[q] = make_float4(__fmul_rn(y[4 * q], 0.125f),
                          __fmul_rn(y[4 * q + 1], 0.125f),
                          __fmul_rn(y[4 * q + 2], 0.125f),
                          __fmul_rn(y[4 * q + 3], 0.125f));
  __syncwarp();
  float4* dst = reinterpret_cast<float4*>(out + r0 * 128);
  const float4* tile = reinterpret_cast<const float4*>(tiles[warp]);
#pragma unroll 8
  for (int r = 0; r < 32; ++r)
    if (r < n) dst[r * 32 + lane] = tile[r * (kOutStride / 4) + lane];
}

}  // namespace

extern "C" int hca_mdct(const void* pcm, long long rows, int T, void* out,
                        void* stream) {
  if (rows < 1 || T < 1 || rows % T) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(pcm) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0)
    return (int)cudaErrorMisalignedAddress;
  const long long blocks = (rows + 32 * kWarps - 1) / (32 * kWarps);
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  hca_mdct_kernel<<<(unsigned)blocks, 32 * kWarps, 0,
                    (cudaStream_t)stream>>>((const int16_t*)pcm, rows, T,
                                            (float*)out);
  return (int)cudaGetLastError();
}
