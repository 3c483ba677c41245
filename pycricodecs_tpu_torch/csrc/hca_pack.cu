// HCA frame packer kernel for Hopper (sm_90a): carries B9's work.
//
// Replaces (TPU Pallas kernel of the JAX package):
//   B9 pycricodecs_tpu/ops/hca_pack_device.py _scatter_segments_pallas, the
//      symbol -> word placement of pack_frames_device (chunk-local
//      threshold sums over exclusive bit offsets); here that placement is
//      a warp's scan and OR into shared memory. The rest of
//      pack_frames_device (symbol build, prefix sum, CRC16 by GF(2) masks,
//      byte order) is fused in.
// Plain PyTorch twin: pycricodecs_tpu_torch/ops/hca_pack_device.py
// pack_frames_plain, byte-equal by test; both equal the reference's
// PackFrame (hca.cpp:2894-2963) with the IO.cpp writer.
//
// Computes, per frame: the MSB-first bit stream sync 0xFFFF, level (9),
// boundary (7), per channel the 3-bit delta width, the scalefactor codes
// (raw 6-bit, or delta with escape + raw), 8 x 4-bit intensity (stereo
// secondary) or G x 6-bit HFR scales, then the spectrum codes
// subframe-major, channel-minor, band innermost; then CRC16 (poly 0x8005)
// over bytes [0, fs-2), stored big-endian in the last two bytes.
// Out: u8 [frames, fs].
//
// End of frame, as the twin and the JAX device packer: a symbol's offset is
// the exclusive sum of every width before it, and it is kept iff it ends at
// or before fs * 8 (it may end inside the CRC slot, which the CRC then
// overwrites). Ends grow along the sequence, so the kept symbols are a
// prefix. The reference's serial writer, which drops only the crossing
// write, gives the same bytes: after a drop fewer than 13 bits are left, all
// inside the CRC slot.
//
// What bounds it on this card: the bytes it must move (~3 per spectral
// value: quantised i16 + resolution, and the frames out; 479 MB at the
// 256-stream encode bank) are 0.14 ms of HBM time, but the symbol build
// and placement are ~5,000 integer instructions a frame, so the integer
// pipes bound it. Design: one warp per frame (CTAs of up to 8 warps walk
// the frames grid-stride). A segment of the symbol sequence (the sync word
// with level and boundary; a channel's delta width, its scalefactors, its
// intensity or HFR scales; one (subframe, channel) of spectrum codes) gives
// each lane four consecutive symbols, read as one u32 of bytes and one
// 8-byte vector of codes (coalesced across the warp) and built without
// branches (the small-resolution codes from one packed value | width table
// in shared memory); the lane concatenates them (at most 52 bits), a
// shuffle scan of the lanes' widths gives the bit offsets, and each lane
// ORs its bits into the frame's word row in shared memory (at most three
// words, shared-memory atomic ORs: the ranges are disjoint). The CRC is
// linear over GF(2): bit j is the parity of XOR_w (word_w & M[j][w]) over a
// mask table built on the host for fs (hca_pack_device.crc_mask_table), so
// each lane folds its words with one LOP3 per mask and five shuffles
// combine the lanes. The warp stores the frame with 16-byte vectors where
// fs is a multiple of 16, else byte by byte, coalesced either way.
#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "hca_tables.inc"  // generated by _build.py from ops/hca_tables.py

#define HCA_MAX_CH 16

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxWarps = 8;
// dynamic shared bytes without the opt-in: 48 KB less the static tables
constexpr int kSmemBudget = 48 * 1024 - 256;

struct PackCfg {
  int C, G, Gp, fs, W, row_words, warps;
  long long frames;
  int coded[HCA_MAX_CH];
  int secondary[HCA_MAX_CH];
};

// v's low n bits, n in 0..31 (no symbol is wider than 16 bits)
__device__ __forceinline__ uint32_t low_bits(uint32_t v, int n) {
  return v & ((1u << n) - 1u);
}

// OR k (0..52) bits, right-aligned in v, into the row at MSB-first bit o.
__device__ __forceinline__ void place(uint32_t* words, int o, uint64_t v,
                                      int k) {
  const uint64_t t = k ? v << (64 - k) : 0ull;
  const int sh = o & 31;
  uint32_t* w = words + (o >> 5);
  const uint32_t w0 = (uint32_t)(t >> (32 + sh));
  const uint32_t w1 = (uint32_t)(t >> sh);
  const uint32_t w2 = (uint32_t)(t << (32 - sh));
  if (w0) atomicOr(w, w0);
  if (w1) atomicOr(w + 1, w1);
  if (w2) atomicOr(w + 2, w2);
}

// One segment of the symbol sequence: up to four symbols a lane, in lane
// order, the segment starting at bit `base` (uniform). Returns the bit
// offset after it (every width counted, kept or not).
__device__ __forceinline__ int emit(uint32_t* words, int base, int limit,
                                    const uint32_t (&val)[4],
                                    const int (&bits)[4], int lane) {
  uint64_t acc = 0;
  int tw = 0;
  int cum[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    acc = (acc << bits[j]) | low_bits(val[j], bits[j]);
    tw += bits[j];
    cum[j] = tw;
  }
  int incl = tw;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  const int total = __shfl_sync(kFull, incl, 31);
  const int off = base + incl - tw;
  int cut = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (off + cum[j] <= limit) cut = cum[j];
  place(words, off, acc >> (tw - cut), cut);
  return base + total;
}

__global__ void __launch_bounds__(kMaxWarps * 32)
hca_pack_kernel(const int32_t* __restrict__ level,
                const int32_t* __restrict__ boundary,
                const uint8_t* __restrict__ sf,
                const uint8_t* __restrict__ res,
                const uint8_t* __restrict__ inten,
                const int32_t* __restrict__ hfr,
                const int32_t* __restrict__ delta_bits,
                const int16_t* __restrict__ quant,
                const uint32_t* __restrict__ crc_masks, PackCfg cfg,
                uint8_t* __restrict__ out) {
  extern __shared__ uint32_t rows[];
  // QUANTIZE_SPECTRUM_VALUE | QUANTIZE_SPECTRUM_BITS << 8, res 0-7 x code
  __shared__ uint16_t qs_code[128];
  for (int i = threadIdx.x; i < 128; i += blockDim.x)
    qs_code[i] = (uint16_t)(kQsValue[i] | (kQsBits[i] << 8));
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int C = cfg.C, fs = cfg.fs, W = cfg.W;
  const int limit = fs * 8;
  uint32_t* words = rows + warp * cfg.row_words;
  const bool vec_out = (fs & 15) == 0;
  for (long long f = (long long)blockIdx.x * cfg.warps + warp;
       f < cfg.frames; f += (long long)gridDim.x * cfg.warps) {
    for (int i = lane; i < cfg.row_words; i += 32) words[i] = 0u;
    __syncwarp();
    uint32_t val[4] = {0u, 0u, 0u, 0u};
    int bits[4] = {0, 0, 0, 0};
    // sync word, level (9) and boundary (7)
    if (lane == 0) {
      val[0] = 0xFFFFu;
      val[1] = (((uint32_t)level[f] & 0x1FFu) << 7) |
               ((uint32_t)boundary[f] & 0x7Fu);
      bits[0] = 16;
      bits[1] = 16;
    }
    int pos = emit(words, 0, limit, val, bits, lane);
    for (int c = 0; c < C; ++c) {
      const long long fc = f * C + c;
      const int cc = cfg.coded[c];
      const int db = delta_bits[fc];
      // the 3-bit delta width
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        val[j] = (uint32_t)db;
        bits[j] = lane == 0 && j == 0 ? 3 : 0;
      }
      pos = emit(words, pos, limit, val, bits, lane);
      // scalefactors: width 0 nothing; 6 raw codes; else sf[0] raw (even at
      // coded count 0), then deltas in db bits or escape + raw 6 bits
      const uint32_t sw =
          *reinterpret_cast<const uint32_t*>(sf + fc * 128 + 4 * lane);
      const uint32_t pw = __shfl_up_sync(kFull, sw, 1);
      const int ns = db == 0 ? 0 : (db == 6 ? cc : max(cc, 1));
      const int maxd = db >= 1 ? (1 << (db - 1)) - 1 : 0;
      const uint32_t escape = (1u << db) - 1u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = 4 * lane + j;
        const int si = (int)((sw >> (8 * j)) & 0xFF);
        const int sp = j ? (int)((sw >> (8 * j - 8)) & 0xFF)
                         : (lane ? (int)(pw >> 24) : si);
        const int delta = si - sp;
        const bool raw = db == 6 || i == 0;
        const bool esc = abs(delta) > maxd;
        val[j] = raw ? (uint32_t)si
                     : (esc ? (escape << 6) | (uint32_t)si
                            : (uint32_t)(maxd + delta));
        bits[j] = i >= ns ? 0 : (raw ? 6 : (esc ? db + 6 : db));
      }
      pos = emit(words, pos, limit, val, bits, lane);
      // intensity (stereo secondary) or the HFR scales
      if (cfg.secondary[c]) {
        const uint32_t iw = lane < 2 ? *reinterpret_cast<const uint32_t*>(
                                           inten + fc * 8 + 4 * lane)
                                     : 0u;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          val[j] = iw >> (8 * j);
          bits[j] = lane < 2 ? 4 : 0;
        }
        pos = emit(words, pos, limit, val, bits, lane);
      } else if (cfg.G > 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int g = 4 * lane + j;
          val[j] = g < cfg.G ? (uint32_t)hfr[fc * cfg.Gp + g] : 0u;
          bits[j] = g < cfg.G ? 6 : 0;
        }
        pos = emit(words, pos, limit, val, bits, lane);
      }
    }
    // spectrum codes: subframe, channel, band
    for (int s8 = 0; s8 < 8; ++s8) {
      for (int c = 0; c < C; ++c) {
        const long long fc = f * C + c;
        const int cc = cfg.coded[c];
        const uint32_t rw =
            *reinterpret_cast<const uint32_t*>(res + fc * 128 + 4 * lane);
        const uint2 qw = *reinterpret_cast<const uint2*>(
            quant + (fc * 8 + s8) * 128 + 4 * lane);
        const uint32_t qpair[2] = {qw.x, qw.y};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int rv = (int)((rw >> (8 * j)) & 0xFF);
          const int qv =
              (int)(int16_t)(uint16_t)(qpair[j >> 1] >> (16 * (j & 1)));
          // res 1-7: the table code at q + 8; 8-15: |q| in res - 4 bits
          // (QUANTIZED_SPECTRUM_MAX_BITS[res] - 1), then a sign bit if q != 0
          const int code = min(max(qv + 8, 0), 15);
          const uint32_t vb = qs_code[min(rv, 7) * 16 + code];
          const bool small = rv < 8;
          val[j] = small ? (vb & 0xFFu)
                         : ((uint32_t)abs(qv) << 1) | (qv < 0 ? 1u : 0u);
          const int b = small ? (int)(vb >> 8) : rv - 4 + (qv != 0 ? 1 : 0);
          bits[j] = (4 * lane + j < cc && rv != 0 && rv < 16) ? b : 0;
        }
        pos = emit(words, pos, limit, val, bits, lane);
      }
    }
    __syncwarp();
    // CRC16 over bytes [0, fs - 2): bit j = parity of XOR_w (w & M[j][w])
    uint32_t fold[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) fold[j] = 0u;
    for (int w = lane; w < W; w += 32) {
      const uint32_t x = words[w];
#pragma unroll
      for (int j = 0; j < 16; ++j)
        fold[j] ^= x & __ldg(crc_masks + (size_t)j * W + w);
    }
    uint32_t crc = 0;
#pragma unroll
    for (int j = 0; j < 16; ++j) crc |= (uint32_t)(__popc(fold[j]) & 1) << j;
#pragma unroll
    for (int d = 16; d >= 1; d >>= 1) crc ^= __shfl_xor_sync(kFull, crc, d);
    if (lane == 0) {
      // bytes fs - 2 and fs - 1: the CRC, over any spilled symbol bits
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int j = fs - 2 + k;
        const int sh = 24 - 8 * (j & 3);
        const uint32_t b = k ? (crc & 0xFFu) : (crc >> 8);
        words[j >> 2] = (words[j >> 2] & ~(0xFFu << sh)) | (b << sh);
      }
    }
    __syncwarp();
    uint8_t* dst = out + f * fs;
    if (vec_out) {
      for (int q = lane; q < (fs >> 4); q += 32) {
        const uint32_t* src = words + 4 * q;
        reinterpret_cast<uint4*>(dst)[q] = make_uint4(
            __byte_perm(src[0], 0, 0x0123), __byte_perm(src[1], 0, 0x0123),
            __byte_perm(src[2], 0, 0x0123), __byte_perm(src[3], 0, 0x0123));
      }
    } else {
      for (int j = lane; j < fs; j += 32)
        dst[j] = (uint8_t)(words[j >> 2] >> (24 - 8 * (j & 3)));
    }
    __syncwarp();
  }
}

}  // namespace

// Pointers are device pointers except coded and channel_types (host, C
// int32 each). sf, res, inten and quant must start 4-, 4-, 4- and 8-byte
// aligned (the wrapper copies them otherwise); crc_masks is u32 [16, W],
// W = ceil(fs / 4), the transposed hca_pack_device.crc_mask_table(fs).
extern "C" int hca_pack(const void* level, const void* boundary,
                        const void* sf, const void* res, const void* inten,
                        const void* hfr, const void* delta_bits,
                        const void* quant, const void* crc_masks,
                        long long frames, int C, int Gp, int G, int fs,
                        const int32_t* coded, const int32_t* channel_types,
                        void* out, void* stream) {
  if (C < 1 || C > HCA_MAX_CH || frames < 1 || fs < 8 || G < 0 || G > Gp ||
      G > 128)
    return (int)cudaErrorInvalidValue;
  PackCfg cfg;
  cfg.C = C;
  cfg.G = G;
  cfg.Gp = Gp;
  cfg.fs = fs;
  cfg.W = (fs + 3) / 4;
  cfg.row_words = cfg.W + 2;
  cfg.frames = frames;
  for (int c = 0; c < HCA_MAX_CH; ++c) {
    cfg.coded[c] = c < C ? coded[c] : 0;
    cfg.secondary[c] = c < C ? (channel_types[c] == 2) : 0;
  }
  // warps (frames in flight) per CTA: as many rows as fit in 48 KB, <= 8
  const size_t row_bytes = (size_t)cfg.row_words * 4;
  cfg.warps = kMaxWarps;
  while (cfg.warps > 1 && cfg.warps * row_bytes > kSmemBudget) cfg.warps >>= 1;
  const size_t smem = cfg.warps * row_bytes;
  int rc;
  if (smem > kSmemBudget) {
    rc = (int)cudaFuncSetAttribute(
        hca_pack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (rc) return rc;
  }
  int dev = 0, sms = 0, per_sm = 0;
  rc = (int)cudaGetDevice(&dev);
  if (!rc) rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                            dev);
  if (!rc) rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &per_sm, hca_pack_kernel, cfg.warps * 32, smem);
  if (rc) return rc;
  const long long need = (frames + cfg.warps - 1) / cfg.warps;
  const long long blocks = std::min(need, (long long)sms * std::max(per_sm, 1));
  hca_pack_kernel<<<(unsigned)blocks, cfg.warps * 32, smem,
                    (cudaStream_t)stream>>>(
      (const int32_t*)level, (const int32_t*)boundary, (const uint8_t*)sf,
      (const uint8_t*)res, (const uint8_t*)inten, (const int32_t*)hfr,
      (const int32_t*)delta_bits, (const int16_t*)quant,
      (const uint32_t*)crc_masks, cfg, (uint8_t*)out);
  return (int)cudaGetLastError();
}
