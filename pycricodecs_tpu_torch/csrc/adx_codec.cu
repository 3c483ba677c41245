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
// (stream x channel): every sample needs the two samples before it. A 10 s
// 48 kHz lane is 480,000 dependent steps, and a bank of 256 stereo streams
// has only 512 lanes, so the latency of the dependent chain, not memory
// (~0.19 ms for the bank's 630 MB at 3.35 TB/s), sets the time. The
// critical path of one step:
// - B7: multiply a0 * p1, shift, the three-way add, two clamps (5 ops;
//   compiled, the shift and add are one LEA.HI.SX32, so 4 dependent
//   instructions, and a step issues about 6 with a1 * p2 >> 12 and its add
//   to q * s off the chain);
// - B8 in adx_encode_plain's order: the prediction's multiply-add (c1 * q2
//   is known one step early), subtract, shift, the rounding select, the
//   exact division (multiply-high, add, shift, sign fix), two clamps, the
//   simulated decoder's multiply-add, shift and two clamps (14 ops); as the
//   kernel orders it (below): multiply-add, shift, the dividend's clamp,
//   the rounding add and select, the division's four, the simulated
//   decoder's multiply-add, shift and two clamps (13).
//
// B7 and B8 share a launch shape (chunk_plan): a CTA owns G lanes
// (G = ceil(L / SMs), at most 32, so a 512-lane bank spreads over 128 SMs)
// and walks them in chunks of K blocks, G and K from a 100 KB shared-memory
// budget (spb up to 1,012 fits). Warp 0 runs the G chains and nothing else;
// warps 1-3 stage, double-buffered, one barrier per chunk.
//
// B7: the stagers copy chunk c + 1 of every lane's raw block bytes into
// shared memory (16-byte cp.async where the lane's bytes are 16-byte
// aligned, byte copies elsewhere), take each block's big-endian scale word
// to (scale, a0, a1) by mode, extract its codes MSB first at any width
// 2..15 and write q * scale (int32, wrapping) into a q * s tile, and store
// chunk c - 1's PCM from a shared tile, 16 bytes a thread where aligned.
// A chain thread reads its lane's q * s values two 16-byte loads per group
// of 8, carries (p1, p2) across blocks and chunks, forms a1 * p2 >> 12 one
// step early and writes int16 into the PCM tile, the groups of 8 unguarded,
// then a tail.
//
// B8: the stagers copy the next chunk of every lane's PCM into shared
// memory (16-byte cp.async where the lane's bytes are 16-byte aligned,
// int16 copies elsewhere, e.g. an odd spb), compute each block's residual
// min/max over t >= 2 (original samples only, as the JAX kernel does
// outside its loop), and store the previous chunk's packed bytes to device
// memory from a shared tile, 16 bytes a thread where aligned. Both tiles are double-buffered: the staging of chunk c + 1 and
// the store of chunk c - 1 overlap the chains of chunk c, one barrier per
// chunk. A chain thread finishes pass 1 with r0 and r1 (they need the
// carried history), picks the scale, and quantises against the simulated
// decoder, writing its bytes into the shared tile. Per block the divisor is
// fixed, so the division is a multiply-high from a table of
// (mul, add, shift, fix) per divisor 1..16384 (ops/adx_kernels.py
// divisor_table; exact C truncation for every int32 dividend, held by
// tests/test_torch_adx_divide.py), read once per block; the scale choice's
// divisions by limit and limit + 1 use the same table (n / -k == -(n / k)).
// (d << 12) * scale_eff is d * (scale_eff << 12) mod 2^32, so the factor is
// formed once per block. Off the chain as well: x - c1 * q2 (formed before
// q1 is known), the quotient's min and max (applied side by side to the
// dividend, since trunc(. / dv) is monotone) and the packing. The samples
// go through in unguarded groups of 8, then a tail (a per-sample guard
// inside the unrolled loop was most of the time this layout first lost).
//
// Integer semantics are XLA's int32: products and sums that can wrap (mode
// 4's 1 << 31 scale) are done in uint32 and cast back, shifts are
// arithmetic, division truncates toward zero.
//
// B7 has a second instance, the JAX host decoders' arithmetic (int64,
// native/cricore.cpp cri_adx_decode_blocks): mode 4's scale is 2^k exactly,
// 2^31 included, and q * scale does not wrap. The stagers form that
// product in int64 and hold it to +-2^24 (kQsLimit) before it enters the
// q * s tile. A prediction is under 2^17 in magnitude (|a0|, |a1| <= 8192
// from the highpass or the mode 2 table, |p| <= 32768, each term >> 12),
// so a product past the limit clamps to the same int16 rail as the exact
// sum, and the chain's int32 adds cannot wrap. The chain is the same code
// in both instances; only the staging differs (template kWrap).
#include <algorithm>
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

// B7's and B8's launch: one chain warp and three staging warps per CTA
constexpr int kCtaThreads = 128;
constexpr int kStagers = kCtaThreads - 32;
constexpr int kMaxLanesPerCta = 32;
constexpr int kMaxChunk = 64;
constexpr int kSmemBudget = 100 * 1024;
// B7's host instance: the bound on a staged q * s (see the header)
constexpr int64_t kQsLimit = 1 << 24;

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

// The launch geometry of a call, shared by B7 and B8: a CTA owns G lanes
// (G = ceil(L / SMs), at most 32, halved while one block of each lane
// overflows the shared budget) and walks them in chunks of K blocks (at
// most 64, shrunk to the budget, a multiple of 8 from 8 on, so that K * bs
// is a multiple of 16 for an even bs). `geo(G, K)` gives a kernel's plan,
// with its `smem` bytes, for such a G and K.
template <class Geometry>
auto chunk_plan(int L, int nb, int sms, Geometry geo) {
  int G = std::min(kMaxLanesPerCta, (L + sms - 1) / sms);
  while (G > 1 && geo(G, 1).smem > (size_t)kSmemBudget) G = (G + 1) / 2;
  int K = std::min(nb, kMaxChunk);
  while (K > 1 && geo(G, K).smem > (size_t)kSmemBudget) --K;
  if (K >= 8) K &= ~7;
  return geo(G, K);
}

// B8's plan: the per-lane strides of the shared tiles (16-byte multiples,
// padded by 16 so that the chain threads' rows fall in different banks).
struct EncPlan {
  int G, K, in_stride, out_stride;
  size_t smem;
};

EncPlan enc_geometry(int G, int K, int spb, int bs) {
  EncPlan p;
  p.G = G;
  p.K = K;
  p.in_stride = ((K * spb * 2 + 15) & ~15) + 16;
  p.out_stride = ((K * bs + 15) & ~15) + 16;
  // input and output tiles and the (min, max) pairs, each twice
  p.smem = 2 * (size_t)G * (p.in_stride + p.out_stride + K * 8);
  return p;
}

EncPlan enc_plan(int L, int nb, int bs, int spb, int sms) {
  return chunk_plan(L, nb, sms, [=](int G, int K) {
    return enc_geometry(G, K, spb, bs);
  });
}

// B7's plan: per lane, the raw block bytes (one copy: only the stagers use
// it), the codes times their scale as int32 in rows of spb rounded up to 8
// per block (so the chain reads groups of 8 as two 16-byte loads), the PCM
// tile and the (a0, a1) pairs (two copies each); strides padded as B8's.
struct DecPlan {
  int G, K, raw_stride, qs_stride, out_stride;
  size_t smem;
};

DecPlan dec_geometry(int G, int K, int spb, int bs) {
  DecPlan p;
  p.G = G;
  p.K = K;
  p.raw_stride = ((K * bs + 15) & ~15) + 16;
  p.qs_stride = K * ((spb + 7) & ~7) * 4 + 16;
  p.out_stride = ((K * spb * 2 + 15) & ~15) + 16;
  p.smem = (size_t)G * (p.raw_stride + 2 * (p.qs_stride + p.out_stride + K * 8));
  return p;
}

DecPlan dec_plan(int L, int nb, int bs, int spb, int sms) {
  return chunk_plan(L, nb, sms, [=](int G, int K) {
    return dec_geometry(G, K, spb, bs);
  });
}

// ---------------------------------------------------------------------------
// B7
// ---------------------------------------------------------------------------

// Staging warps: chunk c of every lane's raw block bytes into the raw tile
// (16-byte cp.async where the lane's bytes start 16-byte aligned, then byte
// copies for the rest; byte copies only where they do not).
__device__ __forceinline__ void stage_bytes(const uint8_t* __restrict__ src0,
                                            int lane0, int nl, int nb,
                                            int bs, int k0, int kc,
                                            uint8_t* tile, int raw_stride,
                                            int st) {
  const int n = kc * bs;
  for (int g = 0; g < nl; ++g) {
    const uint8_t* src = src0 + ((size_t)(lane0 + g) * nb + k0) * bs;
    uint8_t* dst = tile + (size_t)g * raw_stride;
    const int n16 = (reinterpret_cast<uintptr_t>(src) & 15) == 0 ? n / 16 : 0;
    for (int i = st; i < n16; i += kStagers)
      __pipeline_memcpy_async(dst + 16 * i, src + 16 * i, 16);
    for (int i = 16 * n16 + st; i < n; i += kStagers) dst[i] = __ldg(src + i);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
}

// Staging warps: per block of the raw tile, (a0, a1) by mode into `coef`
// and the codes (MSB first, bd bits, sign-extended, read afresh at every
// block: a block's leftover bits are skipped) times the scale into the
// block's row of the q * s tile: int32 with wrap (kWrap), or the exact
// product held to +-kQsLimit. A code spans at most 3 bytes (7 + 15 bits);
// the bytes past the block's last code are the next block's or the tile's
// padding, and their bits are masked off.
template <bool kWrap>
__device__ __forceinline__ void unpack_blocks(
    const int32_t* __restrict__ c0v, const int32_t* __restrict__ c1v,
    const StaticCoef& sc, int lane0, int nl, int spb, int bs, int bd,
    int mode, int K, int kc, const uint8_t* raw, int raw_stride,
    int32_t* qs, int qs_stride, int2* coef, int st) {
  const int spb8 = (spb + 7) & ~7;
  const uint32_t mask = (1u << bd) - 1u;
  const int32_t signbit = 1 << (bd - 1);
  const int32_t full = 1 << bd;
  for (int it = st; it < nl * kc; it += kStagers) {
    const int g = it / kc, k = it - g * kc;
    const uint8_t* blk = raw + (size_t)g * raw_stride + k * bs;
    const int32_t scale_raw = ((int32_t)blk[0] << 8) | (int32_t)blk[1];
    int32_t s, a0, a1;
    int64_t s64;  // the host instance's scale: mode 4's 2^31 stays positive
    if (mode == 2) {
      const int pred = scale_raw >> 13;  // 0..7
      s = (scale_raw & 0x1FFF) + 1;
      s64 = s;
      a0 = sc.a0[pred];
      a1 = sc.a1[pred];
    } else {
      const int k = (12 - scale_raw) & 31;
      s = mode == 4 ? (int32_t)(1u << k) : scale_raw + 1;
      s64 = mode == 4 ? (int64_t)1 << k : (int64_t)s;
      a0 = __ldg(c0v + lane0 + g);
      a1 = __ldg(c1v + lane0 + g);
    }
    coef[g * K + k] = make_int2(a0, a1);
    int32_t* q = reinterpret_cast<int32_t*>(
        reinterpret_cast<uint8_t*>(qs) + (size_t)g * qs_stride) + k * spb8;
    const uint8_t* codes = blk + 2;
    for (int t = 0; t < spb; ++t) {
      const int o = t * bd;
      const uint8_t* c = codes + (o >> 3);
      const uint32_t w = ((uint32_t)c[0] << 16) | ((uint32_t)c[1] << 8) | c[2];
      const int32_t v = (int32_t)((w >> (24 - (o & 7) - bd)) & mask);
      const int32_t code = (v & signbit) ? v - full : v;
      if (kWrap) {
        q[t] = wmul(code, s);
      } else {
        const int64_t p = (int64_t)code * s64;
        q[t] = (int32_t)(p < -kQsLimit ? -kQsLimit
                                       : p > kQsLimit ? kQsLimit : p);
      }
    }
  }
}

// Staging warps: chunk c's PCM from the output tile to `out`, 16 bytes a
// thread where the lane's samples start 16-byte aligned, int16 copies for
// the rest.
__device__ __forceinline__ void store_pcm(int16_t* __restrict__ out,
                                          int lane0, int nl, int nb, int spb,
                                          int k0, int kc, const uint8_t* tile,
                                          int out_stride, int st) {
  const int n = kc * spb;
  for (int g = 0; g < nl; ++g) {
    int16_t* dst = out + ((size_t)(lane0 + g) * nb + k0) * spb;
    const int16_t* src =
        reinterpret_cast<const int16_t*>(tile + (size_t)g * out_stride);
    const int n8 = (reinterpret_cast<uintptr_t>(dst) & 15) == 0 ? n / 8 : 0;
    for (int i = st; i < n8; i += kStagers)
      reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
    for (int i = 8 * n8 + st; i < n; i += kStagers) dst[i] = src[i];
  }
}

// The chain thread of one lane over kc blocks of its staged q * s rows.
// p1/p2 carry the history from chunk to chunk; a1 * p2 >> 12 is formed one
// step early, so a step's chain is a0 * p1, the shift, the three-way add
// and the two clamps. Groups of 8 run unguarded, then a tail.
__device__ __forceinline__ void decode_chunk(const int32_t* qs0,
                                             const int2* coef, int16_t* o0,
                                             int kc, int spb, int32_t& p1,
                                             int32_t& p2) {
  const int spb8 = (spb + 7) & ~7;
  for (int k = 0; k < kc; ++k) {
    const int2 c = coef[k];
    const int32_t a0 = c.x, a1 = c.y;
    const int32_t* qs = qs0 + k * spb8;
    int16_t* o = o0 + k * spb;
    int32_t a1p2 = wmul(a1, p2) >> 12;
    auto step = [&](int32_t q) {
      const int32_t x = clamp16(wadd(wadd(q, wmul(a0, p1) >> 12), a1p2));
      a1p2 = wmul(a1, p1) >> 12;
      p2 = p1;
      p1 = x;
      return (uint32_t)(uint16_t)x;
    };
    int t = 0;
    for (; t + 8 <= spb; t += 8) {
      const int4 u = *reinterpret_cast<const int4*>(qs + t);
      const int4 v = *reinterpret_cast<const int4*>(qs + t + 4);
      uint32_t w[4];
      w[0] = step(u.x);
      w[0] |= step(u.y) << 16;
      w[1] = step(u.z);
      w[1] |= step(u.w) << 16;
      w[2] = step(v.x);
      w[2] |= step(v.y) << 16;
      w[3] = step(v.z);
      w[3] |= step(v.w) << 16;
      int16_t* dst = o + t;
      if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
        *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          dst[2 * j] = (int16_t)w[j];
          dst[2 * j + 1] = (int16_t)(w[j] >> 16);
        }
      }
    }
    for (; t < spb; ++t) o[t] = (int16_t)step(qs[t]);
  }
}

template <bool kWrap>
__global__ void __launch_bounds__(kCtaThreads)
adx_decode_kernel(const uint8_t* __restrict__ payload,
                  const int32_t* __restrict__ h1v,
                  const int32_t* __restrict__ h2v,
                  const int32_t* __restrict__ c0v,
                  const int32_t* __restrict__ c1v, int L, int nb, int bs,
                  int bd, int mode, StaticCoef sc, int G, int K,
                  int raw_stride, int qs_stride, int out_stride,
                  int16_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int spb = (bs - 2) * 8 / bd;
  const int lane0 = blockIdx.x * G;
  const int nl = min(G, L - lane0);
  const int nch = (nb + K - 1) / K;
  // shared: the raw tile, then two each of the q * s tiles, the PCM tiles
  // and the (a0, a1) pairs; buffer b of chunk c is c & 1
  const size_t qs_size = (size_t)G * qs_stride, out_size = (size_t)G * out_stride;
  uint8_t* qs_base = smem + (size_t)G * raw_stride;
  uint8_t* out_base = qs_base + 2 * qs_size;
  int2* coef_base = reinterpret_cast<int2*>(out_base + 2 * out_size);
  auto qs_tile = [&](int b) {
    return reinterpret_cast<int32_t*>(qs_base + b * qs_size);
  };
  auto out_tile = [&](int b) { return out_base + b * out_size; };
  auto coef_tile = [&](int b) { return coef_base + b * G * K; };
  const bool stager = threadIdx.x >= 32;
  const int st = threadIdx.x - 32;
  const int g = threadIdx.x;  // the chain thread's lane in the CTA
  const bool chain = !stager && g < nl;
  int32_t p1 = 0, p2 = 0;
  if (chain) {
    p1 = h1v[lane0 + g];
    p2 = h2v[lane0 + g];
  }
  // step c: the chains decode chunk c while the stagers fill chunk c + 1
  // and store chunk c - 1
  for (int c = -1; c <= nch; ++c) {
    if (stager) {
      if (c + 1 < nch) {
        const int b = (c + 1) & 1, k0 = (c + 1) * K;
        const int kc = min(K, nb - k0);
        stage_bytes(payload, lane0, nl, nb, bs, k0, kc, smem, raw_stride, st);
        asm volatile("bar.sync 1, %0;" ::"n"(kStagers) : "memory");
        unpack_blocks<kWrap>(c0v, c1v, sc, lane0, nl, spb, bs, bd, mode, K,
                             kc, smem, raw_stride, qs_tile(b), qs_stride,
                             coef_tile(b), st);
      }
      if (c >= 1) {
        const int b = (c - 1) & 1, k0 = (c - 1) * K;
        store_pcm(out, lane0, nl, nb, spb, k0, min(K, nb - k0), out_tile(b),
                  out_stride, st);
      }
    } else if (chain && c >= 0 && c < nch) {
      const int b = c & 1, k0 = c * K;
      decode_chunk(reinterpret_cast<const int32_t*>(
                       reinterpret_cast<const uint8_t*>(qs_tile(b)) +
                       (size_t)g * qs_stride),
                   coef_tile(b) + g * K,
                   reinterpret_cast<int16_t*>(out_tile(b) +
                                              (size_t)g * out_stride),
                   min(K, nb - k0), spb, p1, p2);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// B8
// ---------------------------------------------------------------------------

// One row of the division table: trunc(n / d) for every int32 n is
//   q = mulhi(n, mul) + (n & add); q >>= shift; q += (n >>> 31) & fix
struct DivMagic {
  int32_t mul, add, shift, fix;
};

__device__ __forceinline__ DivMagic load_magic(const int4* __restrict__ tab,
                                               int d) {
  const int4 v = __ldg(tab + d);
  return {v.x, v.y, v.z, v.w};
}

__device__ __forceinline__ int32_t div_exact(int32_t n, const DivMagic& m) {
  int32_t q = wadd(__mulhi(n, m.mul), n & m.add);
  q >>= m.shift;
  return wadd(q, (int32_t)((uint32_t)n >> 31) & m.fix);
}

// Staging warps: chunk c of every lane's PCM into the input tile.
__device__ __forceinline__ void stage_pcm(const int16_t* __restrict__ pcm,
                                          int lane0, int nl, int nb, int spb,
                                          int k0, int kc, uint8_t* tile,
                                          int in_stride, int st) {
  const int n = kc * spb;  // samples of this chunk in one lane
  for (int g = 0; g < nl; ++g) {
    const int16_t* src = pcm + ((size_t)(lane0 + g) * nb + k0) * spb;
    int16_t* dst = reinterpret_cast<int16_t*>(tile + (size_t)g * in_stride);
    if (((reinterpret_cast<uintptr_t>(src) | (uintptr_t)(n * 2)) & 15) == 0) {
      for (int i = st; i < n / 8; i += kStagers)
        __pipeline_memcpy_async(dst + 8 * i, src + 8 * i, 16);
    } else {
      for (int i = st; i < n; i += kStagers) dst[i] = src[i];
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
}

// Staging warps: the residual min/max over t >= 2 of each block of the
// input tile (pass 1 without its first two samples), starting at 0.
__device__ __forceinline__ void block_ranges(
    const int32_t* __restrict__ c0v, const int32_t* __restrict__ c1v,
    int lane0, int nl, int spb, int K, int kc, const uint8_t* tile,
    int in_stride, int2* mm, int st) {
  for (int it = st; it < nl * kc; it += kStagers) {
    const int g = it / kc, k = it - g * kc;
    const int16_t* xs =
        reinterpret_cast<const int16_t*>(tile + (size_t)g * in_stride) +
        k * spb;
    const int32_t c0 = __ldg(c0v + lane0 + g), c1 = __ldg(c1v + lane0 + g);
    int32_t mn = 0, mx = 0;
    if (spb > 2) {
      int32_t p2 = xs[0], p1 = xs[1];
      for (int t = 2; t < spb; ++t) {
        const int32_t x = xs[t];
        const int32_t r =
            wsub(wsub(wshl(x, 12), wmul(c0, p1)), wmul(c1, p2)) >> 12;
        mn = min(mn, r);
        mx = max(mx, r);
        p2 = p1;
        p1 = x;
      }
    }
    mm[g * K + k] = make_int2(mn, mx);
  }
}

// Staging warps: chunk c's packed bytes from the output tile to `out`.
__device__ __forceinline__ void store_blocks(uint8_t* __restrict__ out,
                                             int lane0, int nl, int nb,
                                             int bs, int k0, int kc,
                                             const uint8_t* tile,
                                             int out_stride, int st) {
  const int n = kc * bs;
  for (int g = 0; g < nl; ++g) {
    uint8_t* dst = out + ((size_t)(lane0 + g) * nb + k0) * bs;
    const uint8_t* src = tile + (size_t)g * out_stride;
    if (((reinterpret_cast<uintptr_t>(dst) | (uintptr_t)n) & 15) == 0) {
      for (int i = st; i < n / 16; i += kStagers)
        reinterpret_cast<uint4*>(dst)[i] =
            reinterpret_cast<const uint4*>(src)[i];
    } else {
      for (int i = st; i < n; i += kStagers) dst[i] = src[i];
    }
  }
}

// The chain thread of one lane over kc blocks of its staged tile. h1/h2
// carry the history from chunk to chunk.
template <bool kFix>
__device__ __forceinline__ void encode_chunk(
    const int16_t* xs0, const int2* mm, uint8_t* o0, int kc, int spb, int bs,
    int bd, int mode, int filter, int32_t limit, const DivMagic& m_lim,
    const DivMagic& m_lim1, const int4* __restrict__ divtab, int32_t c0,
    int32_t c1, int32_t& h1, int32_t& h2) {
  const uint32_t mask = (1u << bd) - 1u;
  for (int k = 0; k < kc; ++k) {
    const int16_t* xs = xs0 + k * spb;
    uint8_t* o = o0 + k * bs;
    // pass 1: the first two residuals need the carried history; min and max
    // start at 0 (adx_encode_scan)
    const int32_t x0 = xs[0];
    const int2 part = mm[k];
    const int32_t r0 =
        wsub(wsub(wshl(x0, 12), wmul(c0, h1)), wmul(c1, h2)) >> 12;
    int32_t mn = min(part.x, r0), mx = max(part.y, r0);
    if (spb >= 2) {
      const int32_t r1 =
          wsub(wsub(wshl(xs[1], 12), wmul(c0, x0)), wmul(c1, h1)) >> 12;
      mn = min(mn, r1);
      mx = max(mx, r1);
    }
    if (mn == 0 && mx == 0) {
      // zero block: scale word and codes 0; the history carries the
      // original samples (at spb == 1, h2 takes the new h1, as the public
      // encoder does)
      for (int j = 0; j < bs; ++j) o[j] = 0;
      h2 = spb >= 2 ? (int32_t)xs[spb - 2] : (int32_t)xs[spb - 1];
      h1 = xs[spb - 1];
      continue;
    }
    // _scale_from_minmax: C division, the u16 wrap before the 0x1000 cap
    int32_t scale = max(div_exact(mx, m_lim), wsub(0, div_exact(mn, m_lim1)));
    if (!kFix) scale &= 0xFFFF;
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
    // pass 2: quantise against the simulated decoder, packing MSB first;
    // divisor <= 8192, so its table row exists
    const int32_t dv = kFix ? eff : scale_eff;
    const DivMagic m = load_magic(divtab, dv);
    const int32_t half = dv >> 1;
    const int32_t fac = kFix ? eff : wshl(scale_eff, 12);
    // trunc(. / dv) is monotone, so clamping the rounded dividend to
    // [(-limit - 2) * dv + 1, (limit + 1) * dv - 1] clamps the quotient to
    // [-limit - 1, limit]; before the rounding add that is [lo, hi]
    // (|d| < 2^21 and |bounds| < 2^28: no wrap)
    const int32_t hi = (limit + 1) * dv - 1 - half;
    const int32_t lo = half + 1 - (limit + 2) * dv;
    const int32_t nc0 = wsub(0, c0);
    int32_t q1 = h1, q2 = h2;
    int32_t c1q2 = kFix ? (wmul(c1, q2) >> 12) : wmul(c1, q2);
    uint32_t acc = 0;  // live bits: the low `nacc` (< 8 + bd <= 23)
    int nacc = 0;
    int ob = 2;
    // One step: the chain, then the code into the bit accumulator. The
    // order is adx_encode_plain's, value for value; x - c1 * q2 is formed
    // before q1 is known, and the quotient's clamp is the dividend's.
    auto step = [&](int32_t x) {
      int32_t d, pred;
      if (kFix) {
        // decoder-exact arithmetic
        const int32_t c0q1 = wmul(c0, q1) >> 12;
        pred = wadd(c0q1, c1q2);
        d = wsub(wsub(x, c1q2), c0q1);
        c1q2 = wmul(c1, q1) >> 12;
      } else {
        pred = wadd(wmul(c0, q1), c1q2);
        d = wadd(wmul(nc0, q1), wsub(wshl(x, 12), c1q2)) >> 12;
        c1q2 = wmul(c1, q1);
      }
      // d > 0 ? d + half : d - half, the dividend clamped
      const int32_t r = d > 0 ? wadd(min(d, hi), half) : wsub(max(d, lo), half);
      const int32_t q = div_exact(r, m);
      const int32_t y = wadd(wmul(q, fac), pred);
      q2 = q1;
      q1 = kFix ? clamp16(y) : clamp16(y >> 12);
      acc = (acc << bd) | ((uint32_t)q & mask);
      nacc += bd;
      if (nacc >= 8) {
        nacc -= 8;
        o[ob++] = (uint8_t)(acc >> nacc);
      }
      if (nacc >= 8) {  // bd > 8: a second byte
        nacc -= 8;
        o[ob++] = (uint8_t)(acc >> nacc);
      }
    };
    // groups of 8 samples, loaded ahead, with no guard in the chain; then
    // the tail
    int t = 0;
    for (; t + 8 <= spb; t += 8) {
      int32_t xv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) xv[j] = xs[t + j];
#pragma unroll
      for (int j = 0; j < 8; ++j) step(xv[j]);
    }
    for (; t < spb; ++t) step(xs[t]);
    if (nacc > 0) o[ob++] = (uint8_t)(acc << (8 - nacc));
    for (; ob < bs; ++ob) o[ob] = 0;  // spb * bd short of the block
    h1 = q1;
    h2 = q2;
  }
}

template <bool kFix>
__global__ void __launch_bounds__(kCtaThreads)
adx_encode_kernel(const int16_t* __restrict__ pcm,
                  const int32_t* __restrict__ c0v,
                  const int32_t* __restrict__ c1v,
                  const int32_t* __restrict__ h1v,
                  const int32_t* __restrict__ h2v,
                  const int4* __restrict__ divtab, int L, int nb, int bs,
                  int bd, int mode, int filter, int G, int K, int in_stride,
                  int out_stride, uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int spb = (bs - 2) * 8 / bd;
  const int lane0 = blockIdx.x * G;
  const int nl = min(G, L - lane0);
  const int nch = (nb + K - 1) / K;
  // shared: the input tiles, the output tiles, the (min, max) pairs; two
  // of each, buffer b of chunk c is c & 1
  const size_t in_size = (size_t)G * in_stride, out_size = (size_t)G * out_stride;
  uint8_t* out_base = smem + 2 * in_size;
  int2* mm_base = reinterpret_cast<int2*>(out_base + 2 * out_size);
  auto in_tile = [&](int b) { return smem + b * in_size; };
  auto out_tile = [&](int b) { return out_base + b * out_size; };
  auto mm_tile = [&](int b) { return mm_base + b * G * K; };
  const bool stager = threadIdx.x >= 32;
  const int st = threadIdx.x - 32;
  const int g = threadIdx.x;  // the chain thread's lane in the CTA
  const bool chain = !stager && g < nl;
  const int32_t limit = (1 << (bd - 1)) - 1;
  int32_t c0 = 0, c1 = 0, h1 = 0, h2 = 0;
  DivMagic m_lim{}, m_lim1{};
  if (chain) {
    c0 = c0v[lane0 + g];
    c1 = c1v[lane0 + g];
    h1 = h1v[lane0 + g];
    h2 = h2v[lane0 + g];
    m_lim = load_magic(divtab, limit);
    m_lim1 = load_magic(divtab, limit + 1);
  }
  // step c: the chains encode chunk c while the stagers fill chunk c + 1
  // and store chunk c - 1
  for (int c = -1; c <= nch; ++c) {
    if (stager) {
      if (c + 1 < nch) {
        const int b = (c + 1) & 1, k0 = (c + 1) * K;
        const int kc = min(K, nb - k0);
        stage_pcm(pcm, lane0, nl, nb, spb, k0, kc, in_tile(b), in_stride, st);
        asm volatile("bar.sync 1, %0;" ::"n"(kStagers) : "memory");
        block_ranges(c0v, c1v, lane0, nl, spb, K, kc, in_tile(b), in_stride,
                     mm_tile(b), st);
      }
      if (c >= 1) {
        const int b = (c - 1) & 1, k0 = (c - 1) * K;
        store_blocks(out, lane0, nl, nb, bs, k0, min(K, nb - k0), out_tile(b),
                     out_stride, st);
      }
    } else if (chain && c >= 0 && c < nch) {
      const int b = c & 1, k0 = c * K;
      encode_chunk<kFix>(
          reinterpret_cast<const int16_t*>(in_tile(b) + (size_t)g * in_stride),
          mm_tile(b) + g * K, out_tile(b) + (size_t)g * out_stride,
          min(K, nb - k0), spb, bs, bd, mode, filter, limit, m_lim, m_lim1,
          divtab, c0, c1, h1, h2);
    }
    __syncthreads();
  }
}

bool geometry_ok(int L, int nb, int bs, int bd, int mode) {
  return L >= 1 && nb >= 1 && bs >= 3 && bs <= 255 && bd >= 2 && bd <= 15 &&
         (bs - 2) * 8 / bd >= 1 && (mode == 2 || mode == 3 || mode == 4);
}

int sm_count(int* sms) {
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)rc;
}

// A launch geometry for a call on the current device: plan[0] = G lanes
// per CTA, plan[1] = K blocks per chunk, plan[2] = dynamic shared bytes.
template <class Plan>
int export_plan(int L, int nb, int bs, int bd, Plan plan_of, int* plan) {
  if (!geometry_ok(L, nb, bs, bd, 3)) return (int)cudaErrorInvalidValue;
  int sms = 0;
  const int rc = sm_count(&sms);
  if (rc) return rc;
  const auto p = plan_of(L, nb, bs, (bs - 2) * 8 / bd, sms);
  plan[0] = p.G;
  plan[1] = p.K;
  plan[2] = (int)p.smem;
  return 0;
}

}  // namespace

// Each entry point launches one kernel on the given stream and returns
// cudaGetLastError(). Pointers are device pointers except static_coef
// (host, 8 int32: the (a0, a1) pairs of mode 2 predictors 0..3). wrap != 0
// launches B7's XLA-wrap instance, wrap == 0 its host instance.
extern "C" int adx_decode(const void* payload, const void* h1, const void* h2,
                          const void* c0, const void* c1, int L, int nb,
                          int bs, int bd, int mode, int wrap,
                          const int32_t* static_coef, void* out,
                          void* stream) {
  if (!geometry_ok(L, nb, bs, bd, mode)) return (int)cudaErrorInvalidValue;
  int sms = 0;
  int rc = sm_count(&sms);
  if (rc) return rc;
  StaticCoef sc;
  for (int k = 0; k < 8; ++k) {
    sc.a0[k] = k < 4 ? static_coef[2 * k] : 0;
    sc.a1[k] = k < 4 ? static_coef[2 * k + 1] : 0;
  }
  const DecPlan p = dec_plan(L, nb, bs, (bs - 2) * 8 / bd, sms);
  auto kernel = wrap ? &adx_decode_kernel<true> : &adx_decode_kernel<false>;
  if (p.smem > 48 * 1024) {
    rc = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (rc) return rc;
  }
  kernel<<<(L + p.G - 1) / p.G, kCtaThreads, p.smem, (cudaStream_t)stream>>>(
      (const uint8_t*)payload, (const int32_t*)h1, (const int32_t*)h2,
      (const int32_t*)c0, (const int32_t*)c1, L, nb, bs, bd, mode, sc, p.G,
      p.K, p.raw_stride, p.qs_stride, p.out_stride, (int16_t*)out);
  return (int)cudaGetLastError();
}

// B7's and B8's launch geometry (export_plan) for such a call.
extern "C" int adx_decode_plan(int L, int nb, int bs, int bd, int* plan) {
  return export_plan(L, nb, bs, bd, dec_plan, plan);
}

extern "C" int adx_encode_plan(int L, int nb, int bs, int bd, int* plan) {
  return export_plan(L, nb, bs, bd, enc_plan, plan);
}

// divtab: int32 [16385, 4], the rows of ops/adx_kernels.py divisor_table.
extern "C" int adx_encode(const void* pcm, const void* c0, const void* c1,
                          const void* h1, const void* h2, const void* divtab,
                          int L, int nb, int bs, int bd, int mode, int filter,
                          int scale_fix, void* out, void* stream) {
  if (!geometry_ok(L, nb, bs, bd, mode)) return (int)cudaErrorInvalidValue;
  int sms = 0;
  int rc = sm_count(&sms);
  if (rc) return rc;
  const EncPlan p = enc_plan(L, nb, bs, (bs - 2) * 8 / bd, sms);
  auto kernel = scale_fix ? &adx_encode_kernel<true> : &adx_encode_kernel<false>;
  if (p.smem > 48 * 1024) {
    rc = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (rc) return rc;
  }
  kernel<<<(L + p.G - 1) / p.G, kCtaThreads, p.smem, (cudaStream_t)stream>>>(
      (const int16_t*)pcm, (const int32_t*)c0, (const int32_t*)c1,
      (const int32_t*)h1, (const int32_t*)h2, (const int4*)divtab, L, nb, bs,
      bd, mode, filter, p.G, p.K, p.in_stride, p.out_stride, (uint8_t*)out);
  return (int)cudaGetLastError();
}
