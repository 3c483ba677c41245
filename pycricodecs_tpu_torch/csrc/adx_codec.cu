// ADX block-ADPCM codec kernels for Hopper (sm_90a): B7 decode, B8 encode.
//
// Replaces (TPU Pallas kernels of the JAX package):
//   B7 pycricodecs_tpu/ops/adx_kernels.py adx_decode_serial_pallas
//      (with the XLA unpack adx_unpack_device fused in)
//   B8 pycricodecs_tpu/ops/adx_kernels.py adx_encode_serial_pallas
//      (with the XLA residual pre-pass and adx_pack_device fused in)
// Plain PyTorch twins: pycricodecs_tpu_torch/ops/adx_kernels.py
// (adx_decode_plain; adx_encode_plain + adx_pack), byte-equal by test.
//
// What bounds them on this card: both are one serial recurrence per lane
// (stream x channel): every sample needs the two samples before it, through
// a multiply, an arithmetic shift and a clamp (decode) or a truncating
// division as well (encode). A 10 s 48 kHz lane is 480,000 dependent steps,
// and a bank of 256 stereo streams has only 512 lanes, so the dependent
// chain, not memory (~0.19 ms for the bank's 630 MB at 3.35 TB/s), sets the
// time.
//
// Design: one thread per lane, serial over the lane's blocks; the TPU
// kernels' (8, 128) lane tiles, block-chunk grid, f32 division and
// exponent-field log2 were Mosaic workarounds and are gone: C `/` truncates,
// __clz gives the power. Everything the JAX pipeline did around the serial
// kernels in XLA is fused in, so no int32 [L, blocks, spb] intermediate
// (983 MB at the bank size) is ever written:
// - B7 reads the raw block bytes, takes the big-endian scale word, derives
//   (scale, a0, a1) by mode, reads the codes MSB first at any width 2..15 and
//   writes PCM16, eight samples per 16-byte store where aligned;
// - B8 reads PCM16, computes the block's residual range against the
//   original samples, the scale, and the codes against the simulated
//   decoder, and writes the packed block bytes.
// Integer semantics are XLA's int32: products and sums that can wrap (mode
// 4's 1 << 31 scale) are done in uint32 and cast back, shifts are
// arithmetic, division truncates toward zero.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;

struct StaticCoef {
  int32_t a0[8];  // mode 2 predictor -> coefficients; 4..7 are 0
  int32_t a1[8];
};

__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int32_t wsub(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
}
__device__ __forceinline__ int32_t wmul(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a * (uint32_t)b);
}
__device__ __forceinline__ int32_t wshl(int32_t a, int s) {
  return (int32_t)((uint32_t)a << s);
}
__device__ __forceinline__ int32_t clamp16(int32_t v) {
  return min(max(v, -32768), 32767);
}

__global__ void __launch_bounds__(kThreads)
adx_decode_kernel(const uint8_t* __restrict__ payload,
                  const int32_t* __restrict__ h1v,
                  const int32_t* __restrict__ h2v,
                  const int32_t* __restrict__ c0v,
                  const int32_t* __restrict__ c1v, int L, int nb, int bs,
                  int bd, int mode, StaticCoef sc,
                  int16_t* __restrict__ out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  const int spb = (bs - 2) * 8 / bd;
  const uint32_t mask = (1u << bd) - 1u;
  const int32_t signbit = 1 << (bd - 1);
  const int32_t full = 1 << bd;
  const int32_t c0 = c0v[lane], c1 = c1v[lane];
  int32_t p1 = h1v[lane], p2 = h2v[lane];
  const uint8_t* __restrict__ blk = payload + (size_t)lane * nb * bs;
  int16_t* __restrict__ o = out + (size_t)lane * nb * spb;
  for (int b = 0; b < nb; ++b, blk += bs, o += spb) {
    const int32_t scale_raw = ((int32_t)blk[0] << 8) | (int32_t)blk[1];
    int32_t s, a0, a1;
    if (mode == 4) {
      s = (int32_t)(1u << ((12 - scale_raw) & 31));
      a0 = c0;
      a1 = c1;
    } else if (mode == 2) {
      const int pred = scale_raw >> 13;  // 0..7
      s = (scale_raw & 0x1FFF) + 1;
      a0 = sc.a0[pred];
      a1 = sc.a1[pred];
    } else {
      s = scale_raw + 1;
      a0 = c0;
      a1 = c1;
    }
    const uint8_t* __restrict__ p = blk + 2;
    uint32_t acc = 0;  // live bits: the low `navail` (< bd + 8 <= 23)
    int navail = 0;
    for (int t = 0; t < spb; t += 8) {
      const int n = min(8, spb - t);
      int32_t q[8];
      // the codes first (independent of the recurrence), then the chain
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (k < n) {
          while (navail < bd) {
            acc = (acc << 8) | (uint32_t)*p++;
            navail += 8;
          }
          int32_t v = (int32_t)((acc >> (navail - bd)) & mask);
          navail -= bd;
          q[k] = (v & signbit) ? v - full : v;
        }
      }
      int16_t v16[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (k < n) {
          const int32_t x = clamp16(wadd(wadd(wmul(q[k], s), wmul(a0, p1) >> 12),
                                         wmul(a1, p2) >> 12));
          p2 = p1;
          p1 = x;
          v16[k] = (int16_t)x;
        }
      }
      int16_t* dst = o + t;
      if (n == 8 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
        uint32_t w[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          w[k] = (uint32_t)(uint16_t)v16[2 * k]
                 | ((uint32_t)(uint16_t)v16[2 * k + 1] << 16);
        *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (k < n) dst[k] = v16[k];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
adx_encode_kernel(const int16_t* __restrict__ pcm,
                  const int32_t* __restrict__ c0v,
                  const int32_t* __restrict__ c1v,
                  const int32_t* __restrict__ h1v,
                  const int32_t* __restrict__ h2v, int L, int nb, int bs,
                  int bd, int mode, int filter, int scale_fix,
                  uint8_t* __restrict__ out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  const int spb = (bs - 2) * 8 / bd;
  const int32_t limit = (1 << (bd - 1)) - 1;
  const uint32_t mask = (1u << bd) - 1u;
  const int32_t c0 = c0v[lane], c1 = c1v[lane];
  int32_t h1 = h1v[lane], h2 = h2v[lane];
  const int16_t* __restrict__ x = pcm + (size_t)lane * nb * spb;
  uint8_t* __restrict__ o = out + (size_t)lane * nb * bs;
  for (int b = 0; b < nb; ++b, x += spb, o += bs) {
    // pass 1: residual range against the original-sample prediction, min
    // and max starting at 0 (adx_encode_scan)
    int32_t mn = 0, mx = 0;
    int32_t p1 = h1, p2 = h2;
    for (int t = 0; t < spb; ++t) {
      const int32_t xt = x[t];
      const int32_t r = wsub(wsub(wshl(xt, 12), wmul(c0, p1)), wmul(c1, p2))
                        >> 12;
      mn = min(mn, r);
      mx = max(mx, r);
      p2 = p1;
      p1 = xt;
    }
    if (mn == 0 && mx == 0) {
      // zero block: scale word and codes 0; the history carries the
      // original samples (at spb == 1, h2 takes the new h1, as the public
      // encoder does)
      for (int k = 0; k < bs; ++k) o[k] = 0;
      h2 = spb >= 2 ? (int32_t)x[spb - 2] : (int32_t)x[spb - 1];
      h1 = x[spb - 1];
      continue;
    }
    // _scale_from_minmax: C division, the u16 wrap before the 0x1000 cap
    int32_t scale = max(mx / limit, mn / -(limit + 1));
    if (!scale_fix) scale &= 0xFFFF;
    scale = min(scale, 0x1000);
    int32_t scale_raw, scale_eff;
    if (mode == 4) {
      const int power = scale >= 1 ? 32 - __clz(scale) : 0;
      scale_eff = 1 << power;
      scale_raw = 12 - power;
    } else if (mode == 2) {
      scale_raw = scale & 0x1FFF;
      scale_eff = scale;
    } else {
      scale_raw = scale;
      scale_eff = scale;
    }
    scale_eff = max(scale_eff, 1);
    const int32_t eff = mode == 4 ? scale_eff : scale + 1;
    const int32_t field = mode == 2 ? ((filter << 13) | (scale_raw & 0x1FFF))
                                    : (scale_raw & 0xFFFF);
    o[0] = (uint8_t)(field >> 8);
    o[1] = (uint8_t)field;
    // pass 2: quantise against the simulated decoder, packing MSB first
    int32_t q1 = h1, q2 = h2;
    uint32_t acc = 0;  // live bits: the low `nacc` (< 8 + bd <= 23)
    int nacc = 0;
    int ob = 2;
    for (int t = 0; t < spb; ++t) {
      const int32_t xt = x[t];
      int32_t d, sim;
      if (scale_fix) {
        // decoder-exact arithmetic
        const int32_t pred = wadd(wmul(c0, q1) >> 12, wmul(c1, q2) >> 12);
        d = wsub(xt, pred);
        d = d > 0 ? wadd(d, eff >> 1) : wsub(d, eff >> 1);
        d = min(max(d / eff, -limit - 1), limit);
        sim = clamp16(wadd(wmul(d, eff), pred));
      } else {
        const int32_t pr = wadd(wmul(c0, q1), wmul(c1, q2));
        d = wsub(wshl(xt, 12), pr) >> 12;
        d = d > 0 ? wadd(d, scale_eff >> 1) : wsub(d, scale_eff >> 1);
        d = min(max(d / scale_eff, -limit - 1), limit);
        sim = clamp16(wadd(wmul(wshl(d, 12), scale_eff), pr) >> 12);
      }
      q2 = q1;
      q1 = sim;
      acc = (acc << bd) | ((uint32_t)d & mask);
      nacc += bd;
      while (nacc >= 8) {
        nacc -= 8;
        o[ob++] = (uint8_t)(acc >> nacc);
      }
    }
    if (nacc > 0) o[ob++] = (uint8_t)(acc << (8 - nacc));
    for (; ob < bs; ++ob) o[ob] = 0;  // spb * bd short of the block
    h1 = q1;
    h2 = q2;
  }
}

bool geometry_ok(int L, int nb, int bs, int bd, int mode) {
  return L >= 1 && nb >= 1 && bs >= 3 && bs <= 255 && bd >= 2 && bd <= 15 &&
         (bs - 2) * 8 / bd >= 1 && (mode == 2 || mode == 3 || mode == 4);
}

}  // namespace

// Each entry point launches one kernel on the given stream and returns
// cudaGetLastError(). Pointers are device pointers except static_coef
// (host, 8 int32: the (a0, a1) pairs of mode 2 predictors 0..3).
extern "C" int adx_decode(const void* payload, const void* h1, const void* h2,
                          const void* c0, const void* c1, int L, int nb,
                          int bs, int bd, int mode, const int32_t* static_coef,
                          void* out, void* stream) {
  if (!geometry_ok(L, nb, bs, bd, mode)) return (int)cudaErrorInvalidValue;
  StaticCoef sc;
  for (int k = 0; k < 8; ++k) {
    sc.a0[k] = k < 4 ? static_coef[2 * k] : 0;
    sc.a1[k] = k < 4 ? static_coef[2 * k + 1] : 0;
  }
  adx_decode_kernel<<<(L + kThreads - 1) / kThreads, kThreads, 0,
                      (cudaStream_t)stream>>>(
      (const uint8_t*)payload, (const int32_t*)h1, (const int32_t*)h2,
      (const int32_t*)c0, (const int32_t*)c1, L, nb, bs, bd, mode, sc,
      (int16_t*)out);
  return (int)cudaGetLastError();
}

extern "C" int adx_encode(const void* pcm, const void* c0, const void* c1,
                          const void* h1, const void* h2, int L, int nb,
                          int bs, int bd, int mode, int filter, int scale_fix,
                          void* out, void* stream) {
  if (!geometry_ok(L, nb, bs, bd, mode)) return (int)cudaErrorInvalidValue;
  adx_encode_kernel<<<(L + kThreads - 1) / kThreads, kThreads, 0,
                      (cudaStream_t)stream>>>(
      (const int16_t*)pcm, (const int32_t*)c0, (const int32_t*)c1,
      (const int32_t*)h1, (const int32_t*)h2, L, nb, bs, bd, mode, filter,
      scale_fix, (uint8_t*)out);
  return (int)cudaGetLastError();
}
