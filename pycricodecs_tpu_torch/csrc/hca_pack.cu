// HCA frame packer kernel for Hopper (sm_90a): carries B9's work.
//
// Replaces (TPU Pallas kernel of the JAX package):
//   B9 pycricodecs_tpu/ops/hca_pack_device.py _scatter_segments_pallas, the
//      symbol -> word placement of pack_frames_device (chunk-local
//      threshold sums over exclusive bit offsets); here that placement is
//      this kernel's serial bit writer. The rest of pack_frames_device
//      (symbol build, prefix sum, CRC16 by GF(2) masks, byte order) is fused
//      in.
// Plain PyTorch twin: pycricodecs_tpu_torch/ops/hca_pack_device.py
// pack_frames_plain, byte-equal by test; both equal the reference's
// PackFrame (hca.cpp:2894-2963) with the IO.cpp writer.
//
// Computes, per frame: the MSB-first bit stream sync 0xFFFF, level (9),
// boundary (7), per channel the 3-bit delta width, the scalefactor codes
// (raw 6-bit, or delta with escape + raw), 8 x 4-bit intensity (stereo
// secondary) or G x 6-bit HFR scales, then the spectrum codes
// subframe-major, channel-minor, band innermost; the writer's range is frame
// bits [16, fs*8) and a write that would cross fs*8 is dropped without
// moving the cursor; then CRC16 (poly 0x8005) over bytes [0, fs-2), stored
// big-endian in the last two bytes. Out: u8 [frames, fs].
//
// What bounds it on this card: it reads ~3 bytes per spectral value
// (quantised i16 + resolution) and writes the frames, a few hundred MB per
// 256-stream bank, so HBM bytes bound it; the serial writer (one dependent
// bit cursor per frame) is what it actually spends. The TPU's threshold
// scatter and popcount CRC masks avoided serial loops Mosaic cannot run;
// here one thread owns one frame and writes words into its own row of
// shared memory (odd row stride: no bank conflicts on equal word indices),
// then the block copies its rows out with coalesced byte stores.
#include <cstdint>
#include <cuda_runtime.h>

#include "hca_tables.inc"  // generated by _build.py from ops/hca_tables.py

#define HCA_MAX_CH 16

namespace {

struct PackCfg {
  int C, G, Gp, fs, W, stride;
  long long frames;
  int coded[HCA_MAX_CH];
  int secondary[HCA_MAX_CH];
};

struct Writer {
  uint32_t* words;  // this frame's row (big-endian byte order per word)
  int pos;          // frame bit cursor
  int limit;        // fs * 8
  int widx;         // next word to store
  int nacc;         // bits pending in acc
  uint64_t acc;
};

__device__ __forceinline__ void put(Writer& w, uint32_t v, int n) {
  if (n <= 0 || n > 32 || n > w.limit - w.pos) return;
  v &= n == 32 ? 0xFFFFFFFFu : ((1u << n) - 1u);
  w.acc = (w.acc << n) | v;
  w.nacc += n;
  w.pos += n;
  if (w.nacc >= 32) {
    w.nacc -= 32;
    w.words[w.widx++] = __byte_perm((uint32_t)(w.acc >> w.nacc), 0, 0x0123);
  }
}

__global__ void hca_pack_kernel(
    const int32_t* __restrict__ level, const int32_t* __restrict__ boundary,
    const uint8_t* __restrict__ sf, const uint8_t* __restrict__ res,
    const uint8_t* __restrict__ inten, const int32_t* __restrict__ hfr,
    const int32_t* __restrict__ delta_bits,
    const int16_t* __restrict__ quant, PackCfg cfg,
    uint8_t* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  uint16_t* crc_table = (uint16_t*)smem;             // 256 entries
  uint32_t* rows = smem + 128;
  for (int i = threadIdx.x; i < 256; i += blockDim.x) crc_table[i] = kCrc16[i];
  __syncthreads();

  const long long f0 = (long long)blockIdx.x * blockDim.x;
  const long long f = f0 + threadIdx.x;
  const int C = cfg.C;
  if (f < cfg.frames) {
    Writer w;
    w.words = rows + (size_t)threadIdx.x * cfg.stride;
    w.pos = 16;
    w.limit = cfg.fs * 8;
    w.widx = 0;
    w.nacc = 16;
    w.acc = 0xFFFF;  // sync word
    put(w, (uint32_t)level[f], 9);
    put(w, (uint32_t)boundary[f], 7);
    for (int c = 0; c < C; ++c) {
      const long long fc = f * C + c;
      const uint8_t* s = sf + fc * 128;
      const int cc = cfg.coded[c];
      const int db = delta_bits[fc];
      put(w, (uint32_t)db, 3);
      if (db == 6) {
        for (int i = 0; i < cc; ++i) put(w, s[i], 6);
      } else if (db != 0) {
        put(w, s[0], 6);
        const int max_delta = (1 << (db - 1)) - 1;
        const uint32_t escape = (1u << db) - 1u;
        for (int i = 1; i < cc; ++i) {
          const int delta = (int)s[i] - (int)s[i - 1];
          if (abs(delta) > max_delta) {
            put(w, escape, db);
            put(w, s[i], 6);
          } else {
            put(w, (uint32_t)(max_delta + delta), db);
          }
        }
      }
      if (cfg.secondary[c]) {
        for (int i = 0; i < 8; ++i) put(w, inten[fc * 8 + i], 4);
      } else {
        for (int g = 0; g < cfg.G; ++g) put(w, (uint32_t)hfr[fc * cfg.Gp + g], 6);
      }
    }
    for (int s8 = 0; s8 < 8; ++s8) {
      for (int c = 0; c < C; ++c) {
        const long long fc = f * C + c;
        const uint8_t* r = res + fc * 128;
        const int16_t* q = quant + (fc * 8 + s8) * 128;
        const int cc = cfg.coded[c];
        for (int i = 0; i < cc; ++i) {
          const int rv = r[i];
          if (rv == 0 || rv >= 16) continue;
          const int qv = q[i];
          if (rv < 8) {
            const int code = min(max(qv + 8, 0), 15);
            put(w, kQsValue[rv * 16 + code], kQsBits[rv * 16 + code]);
          } else {
            put(w, (uint32_t)abs(qv), (int)kQsMaxBits[rv] - 1);
            if (qv != 0) put(w, qv > 0 ? 0u : 1u, 1);
          }
        }
      }
    }
    if (w.nacc > 0) {
      w.words[w.widx++] =
          __byte_perm((uint32_t)(w.acc << (32 - w.nacc)), 0, 0x0123);
    }
    for (int i = w.widx; i < cfg.W; ++i) w.words[i] = 0u;
    // CRC16 over frame bytes [0, fs - 2), big-endian into the last two
    uint8_t* bytes = (uint8_t*)w.words;
    uint32_t crc = 0;
    for (int j = 0; j < cfg.fs - 2; ++j)
      crc = ((crc << 8) ^ crc_table[((crc >> 8) ^ bytes[j]) & 0xFF]) & 0xFFFF;
    bytes[cfg.fs - 2] = (uint8_t)(crc >> 8);
    bytes[cfg.fs - 1] = (uint8_t)(crc & 0xFF);
  }
  __syncthreads();

  // coalesced copy of the block's frames (contiguous in the output)
  const long long n_here = min((long long)blockDim.x, cfg.frames - f0);
  const long long total = n_here * cfg.fs;
  uint8_t* dst = out + f0 * cfg.fs;
  const uint8_t* src = (const uint8_t*)rows;
  const int row_bytes = cfg.stride * 4;
  for (long long k = threadIdx.x; k < total; k += blockDim.x) {
    const long long fr = k / cfg.fs;
    const int j = (int)(k - fr * cfg.fs);
    dst[k] = src[fr * row_bytes + j];
  }
}

}  // namespace

extern "C" int hca_pack(const void* level, const void* boundary,
                        const void* sf, const void* res, const void* inten,
                        const void* hfr, const void* delta_bits,
                        const void* quant, long long frames, int C, int Gp,
                        int G, int fs, const int32_t* coded,
                        const int32_t* channel_types, void* out,
                        void* stream) {
  if (C < 1 || C > HCA_MAX_CH || frames < 1 || fs < 8 || G < 0 || G > Gp)
    return (int)cudaErrorInvalidValue;
  PackCfg cfg;
  cfg.C = C;
  cfg.G = G;
  cfg.Gp = Gp;
  cfg.fs = fs;
  cfg.W = (fs + 3) / 4;
  cfg.stride = cfg.W | 1;  // odd word stride between threads' rows
  cfg.frames = frames;
  for (int c = 0; c < HCA_MAX_CH; ++c) {
    cfg.coded[c] = c < C ? coded[c] : 0;
    cfg.secondary[c] = c < C ? (channel_types[c] == 2) : 0;
  }
  // frames per block: as many rows as fit in 48 KB of shared memory, <= 64
  const int row_bytes = cfg.stride * 4;
  int threads = 64;
  while (threads > 1 && 512 + threads * row_bytes > 48 * 1024) threads >>= 1;
  const size_t smem = 512 + (size_t)threads * row_bytes;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const long long blocks = (frames + threads - 1) / threads;
  hca_pack_kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)level, (const int32_t*)boundary, (const uint8_t*)sf,
      (const uint8_t*)res, (const uint8_t*)inten, (const int32_t*)hfr,
      (const int32_t*)delta_bits, (const int16_t*)quant, cfg, (uint8_t*)out);
  return (int)cudaGetLastError();
}
