// HCA encoder MDCT kernel for Hopper (sm_90a): B6.
//
// Replaces (TPU Pallas kernel of the JAX package):
//   B6 pycricodecs_tpu/ops/pallas_kernels.py mdct_enc_pallas
//      (body _enc_mdct_kernel, constants _build_enc_mdct_constants)
// Plain PyTorch twin: pycricodecs_tpu_torch/ops/hca_encode_device.py
// mdct_plain (= the JAX package's hca_encode_device._mdct + _dct4),
// bit-equal by test.
//
// Computes, per 128-sample block of a stream channel (a "row"): wave =
// pcm / 32768 for the block and the previous one (zero before a stream
// channel's first block), the window fold (hca.cpp:2529-2553)
//   first[j]  = w[63-j] * -x[64+j] - (-w[64+j]) * x[63-j]      j < 64
//   second[j] = w[j] * p[j] - (-w[127-j]) * p[127-j]
// the DCT-IV (hca.cpp:2481-2527): pre-rotation by the stage-7 twiddles,
// six butterfly stages, the SHUFFLE_TABLE gather, times 0.125. In: i16
// [rows, 128] (rows = B * C * T, a stream channel's T blocks contiguous);
// out: f32 [rows, 128].
//
// What bounds it on this card: per value it reads 2 bytes and writes 4, and
// does ~20 float ops, so it is bound by HBM bytes (3.35 TB/s), not by the
// fp32 rate. The TPU kernel's lane rolls, XOR lane schedule and 0/1
// permutation matmul were Mosaic workarounds; here one warp owns one row,
// the row lives in shared memory between stages (each butterfly reads its
// partners directly, __syncwarp between stages), and the shuffle is a
// shared-memory gather.
//
// Every float op is one rounded IEEE multiply, add or subtract in the JAX
// reference order (_rn intrinsics, never contracted; -fmad=false).
#include <cstdint>
#include <cuda_runtime.h>

#include "hca_tables.inc"  // generated by _build.py from ops/hca_tables.py

namespace {

constexpr int kRowsPerBlock = 8;  // one warp per row

__global__ void __launch_bounds__(32 * kRowsPerBlock)
hca_mdct_kernel(const int16_t* __restrict__ pcm, long long rows, int T,
                float* __restrict__ out) {
  __shared__ float xs[kRowsPerBlock][128];  // current block, then scratch
  __shared__ float ps[kRowsPerBlock][128];  // previous block, then DCT temp
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kRowsPerBlock + warp;
  if (row >= rows) return;  // whole warp leaves together
  float* x = xs[warp];
  float* p = ps[warp];
  const int t = (int)(row % T);
  const int16_t* cur = pcm + row * 128;
  const float scale = 1.0f / 32768.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int j = lane + 32 * k;
    x[j] = __fmul_rn((float)cur[j], scale);
    p[j] = t > 0 ? __fmul_rn((float)cur[j - 128], scale) : 0.0f;
  }
  __syncwarp();

  // window fold into the scratch row
  float sc[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int j = lane + 32 * k;
    if (j < 64) {
      sc[k] = __fsub_rn(__fmul_rn(kImdctWindow[63 - j], -x[64 + j]),
                        __fmul_rn(-kImdctWindow[64 + j], x[63 - j]));
    } else {
      const int m = j - 64;
      sc[k] = __fsub_rn(__fmul_rn(kImdctWindow[m], p[m]),
                        __fmul_rn(-kImdctWindow[127 - m], p[127 - m]));
    }
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < 4; ++k) x[lane + 32 * k] = sc[k];
  __syncwarp();

  // DCT-IV pre-rotation (stage-7 twiddles, first 64): pairs k = lane, +32
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int k = lane + 32 * h;
    const float a = x[2 * k];
    const float b = x[127 - 2 * k];
    const float s7 = kDct4Sin[127 + k];
    const float c7 = kDct4Cos[127 + k];
    p[2 * k] = __fadd_rn(__fmul_rn(a, c7), __fmul_rn(b, s7));
    p[2 * k + 1] = __fsub_rn(__fmul_rn(a, s7), __fmul_rn(b, c7));
  }
  __syncwarp();

  // six butterfly stages, in place: one butterfly (4 values) per lane
#pragma unroll
  for (int stage = 0; stage < 6; ++stage) {
    const int bhs = 32 >> stage;
    const int blk = lane / bhs;
    const int i = lane % bhs;
    const int front = blk * 4 * bhs + 2 * i;
    const int back = front + 2 * bhs;
    const float fe = p[front], fo = p[front + 1];
    const float be = p[back], bo = p[back + 1];
    const float sn = kDct4Sin[bhs - 1 + i];
    const float cs = kDct4Cos[bhs - 1 + i];
    const float a2 = __fsub_rn(fe, be);
    const float b2 = __fsub_rn(fo, bo);
    p[front] = __fadd_rn(fe, be);
    p[front + 1] = __fadd_rn(fo, bo);
    p[back] = __fadd_rn(__fmul_rn(a2, cs), __fmul_rn(b2, sn));
    p[back + 1] = __fsub_rn(__fmul_rn(a2, sn), __fmul_rn(b2, cs));
    __syncwarp();
  }

  float* o = out + row * 128;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int j = lane + 32 * k;
    o[j] = __fmul_rn(p[kShuffle[j]], 0.125f);
  }
}

}  // namespace

extern "C" int hca_mdct(const void* pcm, long long rows, int T, void* out,
                        void* stream) {
  if (rows < 1 || T < 1 || rows % T) return (int)cudaErrorInvalidValue;
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  hca_mdct_kernel<<<(unsigned)blocks, 32 * kRowsPerBlock, 0,
                    (cudaStream_t)stream>>>((const int16_t*)pcm, rows, T,
                                            (float*)out);
  return (int)cudaGetLastError();
}
