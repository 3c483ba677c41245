// HCA bitstream unpack kernels for Hopper (sm_90a): B1 side info, B2 spectra
// and the bit cursor after them.
//
// Replaces (TPU Pallas kernels of the JAX package):
//   B1 pycricodecs_tpu/ops/hca_unpack_device.py DeviceUnpacker._side_info_pallas
//   B2 pycricodecs_tpu/ops/hca_unpack_device.py DeviceUnpacker._coefficients_pallas
// Plain PyTorch twins: pycricodecs_tpu_torch/ops/hca_unpack_device.py
// (DeviceUnpacker.side_info_plain / coefficients_plain), byte-equal by test.
//
// What bounds them on this card: an HCA frame is a serial prefix-code
// bitstream (every symbol's length moves the cursor of the next), so the work
// inside a frame is one dependent chain of byte loads, shifts and table
// lookups: latency-bound, not bandwidth- or FLOP-bound. Frames are
// independent, so the parallelism is the frame count (a 64-stream x 469-frame
// chunk is ~30k frames, about one wave of resident threads on 132 SMs).
//
// Design: one thread per frame, reading its (already deciphered) frame bytes
// MSB-first straight from device memory through L1 with a plain bit cursor.
// The TPU kernel's layout (1024-frame (8,128) blocks, one-hot word fetches,
// select trees, 10-symbol supersteps) existed because the TPU has no cheap
// per-lane gather; Hopper has byte loads and table lookups, so none of it is
// kept. The arithmetic is the JAX kernels' symbol for symbol (_sf_symbol,
// _inten3_symbol, _resolutions, _vlc_symbol), including the per-frame error
// rules, so the outputs match byte for byte.
#include <cstdint>
#include <cuda_runtime.h>

#include "hca_tables.inc"  // generated by _build.py from ops/hca_tables.py

#define HCA_MAX_CH 16

namespace {

constexpr int kStereoSecondary = 2;
constexpr int kVersionV200 = 0x0200;

struct SideInfoCfg {
  int C, fs, version, hfr, min_res, max_res;
  int coded[HCA_MAX_CH];
  int cs[HCA_MAX_CH];     // scalefactor symbols, v3 HFR extension included
  int extra[HCA_MAX_CH];  // v3 HFR extension length
  int ctype[HCA_MAX_CH];
  uint8_t ath[128];
};

struct CoefficientsCfg {
  int C, fs;
  int coded[HCA_MAX_CH];
};

// BitReader.peek: `count` bits at bit `cur`, MSB first; a read crossing the
// frame end (or of 0 bits) returns 0. count <= 25.
__device__ __forceinline__ int peek(const uint8_t* __restrict__ p, int nbits,
                                    int cur, int count) {
  if (count <= 0 || cur + count > nbits) return 0;
  const int b = cur >> 3;
  const int off = cur & 7;
  const int nb = (off + count + 7) >> 3;
  uint32_t w = 0;
  for (int i = 0; i < nb; ++i) w = (w << 8) | p[b + i];
  return (int)((w >> (nb * 8 - off - count)) & ((1u << count) - 1u));
}

__global__ void __launch_bounds__(128)
hca_side_info_kernel(const uint8_t* __restrict__ dec, int N, SideInfoCfg cfg,
                     uint8_t* __restrict__ sf_out,
                     uint8_t* __restrict__ res_out,
                     uint8_t* __restrict__ int_out,
                     int32_t* __restrict__ cur_out,
                     uint8_t* __restrict__ err_out) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int C = cfg.C;
  const uint8_t* __restrict__ p = dec + (size_t)n * cfg.fs;
  const int nbits = cfg.fs * 8;
  // 9-bit noise level and 7-bit evaluation boundary (frame bytes 2-3)
  const int anl = ((int)p[2] << 1) | ((int)p[3] >> 7);
  const int evb = (int)p[3] & 0x7F;
  const int packed_noise = (anl << 8) - evb;
  int cur = 32;
  int err = 0;
  for (int c = 0; c < C; ++c) {
    __align__(16) uint8_t sf[128];
    for (int i = 0; i < 128; ++i) sf[i] = 0;
    const int cs = cfg.cs[c];
    // scalefactors (hca.cpp:1290-1355)
    const int db = peek(p, nbits, cur, 3);
    cur += 3;
    if (db >= 6) {
      for (int i = 0; i < cs; ++i) {
        sf[i] = (uint8_t)peek(p, nbits, cur, 6);
        cur += 6;
      }
    } else if (db > 0) {
      const int expected = (1 << db) - 1;
      const int half = expected >> 1;
      int value = peek(p, nbits, cur, 6);
      cur += 6;
      sf[0] = (uint8_t)value;
      for (int i = 1; i < cs; ++i) {
        const int delta = peek(p, nbits, cur, db);
        if (delta == expected) {
          value = peek(p, nbits, cur + db, 6);
          cur += db + 6;
        } else {
          const int test = value + delta - half;
          if (test < 0 || test >= 64) err = 1;
          value = (value - half + delta) & 0x3F;
          cur += db;
        }
        sf[i] = (uint8_t)value;
      }
    }
    // v3 HFR extension: sf[127-i] = sf[cs-i], i ascending (i=0 copies a 0)
    for (int i = 0; i < cfg.extra[c]; ++i) sf[127 - i] = sf[cs - i];

    // intensity (secondary) or v2 HFR scales (hca.cpp:1357-1434)
    uint8_t inten[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (cfg.ctype[c] == kStereoSecondary) {
      const int v4 = peek(p, nbits, cur, 4);
      const bool flag = v4 < 15;
      if (cfg.version <= kVersionV200) {
        inten[0] = (uint8_t)v4;
        if (flag) {
          cur += 4;
          for (int i = 1; i < 8; ++i) {
            inten[i] = (uint8_t)peek(p, nbits, cur, 4);
            cur += 4;
          }
        }
      } else {
        cur += 4;
        if (flag) {
          const int db2 = peek(p, nbits, cur, 2);
          cur += 2;
          inten[0] = (uint8_t)v4;
          if (db2 == 3) {
            for (int i = 1; i < 8; ++i) {
              inten[i] = (uint8_t)peek(p, nbits, cur, 4);
              cur += 4;
            }
          } else {
            const int bmax = (2 << db2) - 1;
            const int bits = db2 + 1;
            int value = v4;
            for (int i = 1; i < 8; ++i) {
              const int delta = peek(p, nbits, cur, bits);
              if (delta == bmax) {
                value = peek(p, nbits, cur + bits, 4);
                cur += bits + 4;
              } else {
                value = value - (bmax >> 1) + delta;
                if (value > 15 || value < 0) err = 1;
                cur += bits;
              }
              inten[i] = (uint8_t)(value & 0xFF);
            }
          }
        } else {
          for (int i = 0; i < 8; ++i) inten[i] = 7;
        }
      }
    } else if (cfg.version <= kVersionV200 && cfg.hfr > 0) {
      for (int i = 0; i < cfg.hfr; ++i) {
        sf[128 - cfg.hfr + i] = (uint8_t)peek(p, nbits, cur, 6);
        cur += 6;
      }
    }

    // resolutions (hca.cpp:1444-1494)
    __align__(16) uint8_t res[128];
    const int coded = cfg.coded[c];
    for (int k = 0; k < 128; ++k) {
      const int s = sf[k];
      const int noise_level = (int)cfg.ath[k] + ((packed_noise + k) >> 8);
      const int curve_pos = noise_level + 1 - ((5 * s) >> 1);
      int r = curve_pos < 0 ? 15 : (curve_pos <= 65 ? (int)kInvertTable[curve_pos] : 0);
      r = min(max(r, cfg.min_res), cfg.max_res);
      if (s <= 0 || k >= coded) r = 0;
      res[k] = (uint8_t)r;
    }

    const size_t row = (size_t)n * C + c;
    uint4* sfo = reinterpret_cast<uint4*>(sf_out + row * 128);
    uint4* reso = reinterpret_cast<uint4*>(res_out + row * 128);
    const uint4* sfv = reinterpret_cast<const uint4*>(sf);
    const uint4* resv = reinterpret_cast<const uint4*>(res);
    for (int i = 0; i < 8; ++i) {
      sfo[i] = sfv[i];
      reso[i] = resv[i];
    }
    for (int i = 0; i < 8; ++i) int_out[row * 8 + i] = inten[i];
  }
  cur_out[n] = cur;
  err_out[n] = (uint8_t)err;
}

// MAX_BIT_TABLE closed form: 0, 2,3,3,4,4,4,4, then r-3
__device__ __forceinline__ int max_bit(int r) {
  if (r == 0) return 0;
  if (r < 8) return 2 + (r >= 2) + (r >= 4);
  return r - 3;
}

__global__ void __launch_bounds__(128)
hca_coefficients_kernel(const uint8_t* __restrict__ dec,
                        const uint8_t* __restrict__ res,
                        const int32_t* __restrict__ cur0, int N,
                        CoefficientsCfg cfg, int16_t* __restrict__ qc,
                        int32_t* __restrict__ cur_end) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int C = cfg.C;
  const uint8_t* __restrict__ p = dec + (size_t)n * cfg.fs;
  const int nbits = cfg.fs * 8;
  const uint8_t* __restrict__ rrow = res + (size_t)n * C * 128;
  // qc == nullptr: the cursor-only pass of the key search (no spectra)
  int16_t* __restrict__ q = qc ? qc + (size_t)n * C * 8 * 128 : nullptr;
  int cur = cur0[n];
  // program order: subframe, channel, band (hca.cpp:1195-1201)
  for (int s = 0; s < 8; ++s) {
    for (int c = 0; c < C; ++c) {
      const int coded = cfg.coded[c];
      int16_t* __restrict__ qs = q ? q + ((size_t)c * 8 + s) * 128 : nullptr;
      for (int k = 0; k < coded; ++k) {
        const int r = rrow[c * 128 + k];
        const int bits = max_bit(r);
        const int code = peek(p, nbits, cur, bits);
        int v, adv;
        if (r > 7) {
          v = (1 - ((code & 1) << 1)) * (code >> 1);
          adv = bits - (v == 0 ? 1 : 0);
        } else {
          v = (int)kVlcValue[r * 16 + code];
          adv = (int)kVlcAdvance[r * 16 + code];
        }
        if (qs) qs[k] = (int16_t)v;
        cur += adv;
      }
      if (qs)
        for (int k = coded; k < 128; ++k) qs[k] = 0;
    }
  }
  // unclamped: the key search's -6 rule reads how far past the end it ran
  cur_end[n] = cur;
}

}  // namespace

extern "C" int hca_side_info(const void* dec, int N, int fs, int C,
                             int version, int hfr, int min_res, int max_res,
                             const int32_t* chan, const uint8_t* ath,
                             void* sf, void* res, void* inten, void* cur,
                             void* err, void* stream) {
  if (C < 1 || C > HCA_MAX_CH || N < 1) return (int)cudaErrorInvalidValue;
  SideInfoCfg cfg;
  cfg.C = C;
  cfg.fs = fs;
  cfg.version = version;
  cfg.hfr = hfr;
  cfg.min_res = min_res;
  cfg.max_res = max_res;
  for (int c = 0; c < HCA_MAX_CH; ++c) {
    const bool on = c < C;
    cfg.coded[c] = on ? chan[c] : 0;
    cfg.cs[c] = on ? chan[C + c] : 0;
    cfg.extra[c] = on ? chan[2 * C + c] : 0;
    cfg.ctype[c] = on ? chan[3 * C + c] : 0;
  }
  for (int k = 0; k < 128; ++k) cfg.ath[k] = ath[k];
  const int threads = 128;
  hca_side_info_kernel<<<(N + threads - 1) / threads, threads, 0,
                         (cudaStream_t)stream>>>(
      (const uint8_t*)dec, N, cfg, (uint8_t*)sf, (uint8_t*)res,
      (uint8_t*)inten, (int32_t*)cur, (uint8_t*)err);
  return (int)cudaGetLastError();
}

extern "C" int hca_coefficients(const void* dec, const void* res,
                                const void* cur, int N, int fs, int C,
                                const int32_t* coded, void* qc,
                                void* cur_end, void* stream) {
  if (C < 1 || C > HCA_MAX_CH || N < 1) return (int)cudaErrorInvalidValue;
  CoefficientsCfg cfg;
  cfg.C = C;
  cfg.fs = fs;
  for (int c = 0; c < HCA_MAX_CH; ++c) cfg.coded[c] = c < C ? coded[c] : 0;
  const int threads = 128;
  hca_coefficients_kernel<<<(N + threads - 1) / threads, threads, 0,
                            (cudaStream_t)stream>>>(
      (const uint8_t*)dec, (const uint8_t*)res, (const int32_t*)cur, N, cfg,
      (int16_t*)qc, (int32_t*)cur_end);
  return (int)cudaGetLastError();
}
