// MPEG Audio Layer II frame unpack kernel for Hopper (sm_90a): B10.
//
// Replaces (TPU Pallas kernel of the JAX package):
//   B10 pycricodecs_tpu/ops/mp2_unpack_device.py Mp2DeviceUnpacker._unpack
// Plain PyTorch twin: pycricodecs_tpu_torch/ops/mp2_unpack_device.py
// (mp2_unpack_plain), byte-equal by test. Semantics: the host unpacker's
// mp2_frame._read_side_info / _frame_field_layout.
//
// Computes, per frame: its own header (CRC flag, padding and so the frame
// size, allocation table and sblimit, joint-stereo bound), the bit
// allocation (one field per channel below the bound, one shared field above
// it), scfsi, the scalefactors, and 12 granules of sample codes (grouped
// 3/5/9-level codes split by integer division; a shared field goes to both
// channels). A read that crosses the frame end returns 0 and sets err (the
// host raises there); a frame whose header is not a Layer II header of this
// channel count, or whose size exceeds the row, is left all zero with err
// set. Outputs: codes u16 [N, C, 36, 32], levels i32 [N, C, 32], sfidx u8
// [N, C, 3, 32] (zeroed by the wrapper: only allocated fields are written),
// err bool [N].
//
// What bounds it on this card: it moves about 0.6 KB of frame in and 2.4 KB
// per channel of codes out per frame, so the HBM bound is tens of
// microseconds for a bank; the work is a serial chain of ~1,500 dependent
// bit reads per frame, so latency bounds it, not bytes or operations.
//
// Design: Layer II side info is serial only within a frame, so one thread
// owns one frame with a plain MSB-first cursor (as B1/B2 do). The TPU
// kernel's layout (frames on the (8, 128) tile axes, select trees for the
// table lookups, a one-hot extract over the word span, a 12-step granule
// grid, one header per launch) is gone: each thread reads its own header and
// looks the tables up directly, so one launch serves every stream of a
// channel count, VBR streams included.
#include <cstdint>
#include <cuda_runtime.h>

#include "hca_tables.inc"  // generated by _build.py (kMp2* tables)

namespace {

constexpr int kMaxCh = 2;

struct Reader {
  const uint8_t* row;
  int row_bytes;
  long long nbits;  // frame_size * 8
  long long pos;
  bool err;

  // MSB-first read of n (0..16) bits; past the frame end: 0 and err
  __device__ __forceinline__ uint32_t get(int n) {
    if (n <= 0) return 0;
    const long long p = pos;
    pos += n;
    if (p + n > nbits) {
      err = true;
      return 0;
    }
    const int b = (int)(p >> 3);
    uint32_t w = 0;
    for (int i = 0; i < 3; ++i)
      w = (w << 8) | (b + i < row_bytes ? (uint32_t)row[b + i] : 0u);
    return (w >> (24 - (int)(p & 7) - n)) & ((1u << n) - 1u);
  }
};

__device__ __forceinline__ int code_bits(int n) {
  int b = 1;
  while ((1 << b) - 1 < n) ++b;
  return b;
}

__global__ void __launch_bounds__(128)
mp2_unpack_kernel(const uint8_t* __restrict__ frames, int N, int W, int C,
                  uint16_t* __restrict__ codes, int32_t* __restrict__ levels,
                  uint8_t* __restrict__ sfidx, bool* __restrict__ err) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= N) return;
  const uint8_t* row = frames + (size_t)f * W;
  uint32_t w = 0;
  for (int i = 0; i < 4; ++i) w = (w << 8) | (i < W ? (uint32_t)row[i] : 0u);
  const int version = (w >> 19) & 3, bri = (w >> 12) & 0xF;
  const int sri = (w >> 10) & 3, mode = (w >> 6) & 3;
  const int nch = mode == 3 ? 1 : 2;
  bool valid = ((w >> 21) & 0x7FF) == 0x7FF && ((w >> 17) & 3) == 2 &&
               (version == 2 || version == 3) && bri != 0 && bri != 15 &&
               sri != 3 && nch == C;
  if (!valid) {
    err[f] = true;
    return;
  }
  const int v1 = version == 3;
  const int table =
      v1 ? kMp2TableSelect[(sri * 2 + (nch == 1)) * 16 + bri] : 4;
  const int sblimit = kMp2Sblimit[table];
  int bound = sblimit;
  if (mode == 1) bound = min((int)(((w >> 4) & 3) + 1) * 4, sblimit);
  const long long size = 144LL * kMp2Bitrate[v1 * 16 + bri] * 1000 /
                             kMp2Rate[v1 * 4 + sri] +
                         ((w >> 9) & 1);
  if (size > W) {
    err[f] = true;
    return;
  }
  Reader rd{row, W, size * 8, ((w >> 16) & 1) ? 32 : 48, false};

  // bit allocation
  int alloc[kMaxCh][32];
  for (int sb = 0; sb < sblimit; ++sb) {
    const int nb = kMp2Nbal[table * 32 + sb];
    const uint16_t* cl = kMp2Classes + (table * 32 + sb) * 16;
    if (sb < bound) {
      for (int ch = 0; ch < C; ++ch) alloc[ch][sb] = cl[rd.get(nb)];
    } else {
      const int n = cl[rd.get(nb)];
      for (int ch = 0; ch < C; ++ch) alloc[ch][sb] = n;
    }
  }
  // scfsi
  int scfsi[kMaxCh][32];
  for (int sb = 0; sb < sblimit; ++sb)
    for (int ch = 0; ch < C; ++ch)
      scfsi[ch][sb] = alloc[ch][sb] ? (int)rd.get(2) : 0;
  // scalefactors
  uint8_t* sf_f = sfidx + (size_t)f * C * 3 * 32;
  for (int sb = 0; sb < sblimit; ++sb) {
    for (int ch = 0; ch < C; ++ch) {
      if (!alloc[ch][sb]) continue;
      uint32_t a, b, c;
      switch (scfsi[ch][sb]) {
        case 0: a = rd.get(6); b = rd.get(6); c = rd.get(6); break;
        case 1: a = b = rd.get(6); c = rd.get(6); break;
        case 2: a = b = c = rd.get(6); break;
        default: a = rd.get(6); b = c = rd.get(6); break;
      }
      uint8_t* sf = sf_f + (size_t)ch * 3 * 32;
      sf[sb] = (uint8_t)a;
      sf[32 + sb] = (uint8_t)b;
      sf[64 + sb] = (uint8_t)c;
    }
  }
  int32_t* lv_f = levels + (size_t)f * C * 32;
  for (int ch = 0; ch < C; ++ch)
    for (int sb = 0; sb < sblimit; ++sb) lv_f[ch * 32 + sb] = alloc[ch][sb];

  // samples: 12 granules of the same field layout
  uint16_t* q_f = codes + (size_t)f * C * 36 * 32;
  for (int gr = 0; gr < 12; ++gr) {
    const int row3 = gr * 3;
    for (int sb = 0; sb < sblimit; ++sb) {
      const bool shared = sb >= bound;
      for (int ch = 0; ch < (shared ? 1 : C); ++ch) {
        const int n = alloc[ch][sb];
        if (!n) continue;
        uint32_t v0, v1s, v2;
        if (n == 3 || n == 5 || n == 9) {
          uint32_t c = rd.get(n == 3 ? 5 : (n == 5 ? 7 : 10));
          v0 = c % n;
          c /= n;
          v1s = c % n;
          v2 = c / n;
        } else {
          const int nb = code_bits(n);
          v0 = rd.get(nb);
          v1s = rd.get(nb);
          v2 = rd.get(nb);
        }
        for (int d = shared ? 0 : ch; d < (shared ? C : ch + 1); ++d) {
          uint16_t* q = q_f + (size_t)d * 36 * 32 + row3 * 32 + sb;
          q[0] = (uint16_t)v0;
          q[32] = (uint16_t)v1s;
          q[64] = (uint16_t)v2;
        }
      }
    }
  }
  err[f] = rd.err;
}

}  // namespace

extern "C" int mp2_unpack(const void* frames, int N, int W, int C,
                          void* codes, void* levels, void* sfidx, void* err,
                          void* stream) {
  if (N < 1 || W < 1 || C < 1 || C > kMaxCh) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  mp2_unpack_kernel<<<(N + threads - 1) / threads, threads, 0,
                      (cudaStream_t)stream>>>(
      (const uint8_t*)frames, N, W, C, (uint16_t*)codes, (int32_t*)levels,
      (uint8_t*)sfidx, (bool*)err);
  return (int)cudaGetLastError();
}
