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
// inside a frame is one dependent chain of shifts and table lookups:
// latency-bound, not bandwidth- or FLOP-bound. Frames are independent, so the
// parallelism is the frame count (a 64-stream x 469-frame chunk is ~30k
// frames, about one wave of resident threads on 132 SMs).
//
// B1: one thread per frame, reading its (already deciphered) frame bytes
// MSB-first straight from device memory through L1 with a plain bit cursor.
// The TPU kernel's layout (1024-frame (8,128) blocks, one-hot word fetches,
// select trees, 10-symbol supersteps) existed because the TPU has no cheap
// per-lane gather; Hopper has byte loads and table lookups, so none of it is
// kept. The arithmetic is the JAX kernels' symbol for symbol (_sf_symbol,
// _inten3_symbol, _resolutions, _vlc_symbol), including the per-frame error
// rules, so the outputs match byte for byte.
//
// B2: still one chain per frame, one warp per CTA and one frame per lane, but
// nothing on the chain touches device memory. The warp copies its 32 frames
// (contiguous in `dec`) and their resolution rows into shared memory with
// coalesced 16-byte cp.async copies (byte copies where a frame size or a base
// address is not 16-byte aligned), rows padded by 16 bytes so that the
// lanes' 16-byte resolution reads spread over all banks, and turns the
// frame words big-endian in place. A lane then reads its frame through a
// 64-bit bit buffer in registers (hi:lo, MSB first): a code is one funnel
// shift of hi, and the buffer is topped up with one word, prefetched a
// top-up ahead, after every second symbol (two take at most 24 of its 32 or
// more bits). The prefix-code tables are folded into one 16-byte row per
// resolution (kVlcPacked: the code width, the >= 8 flag, and the advance as
// a step base + (code >= thr), which it is at every code a resolution can
// read; the value + 8 in 4 bits per code), read from shared memory with the
// band's resolution before its code is known. A symbol's chain is four
// integer operations, and its instruction count is what bounds the kernel:
// the integer pipes, at the bank chunk's seven warps an SM. The lanes of a
// warp walk
// (subframe, channel, band) in lockstep (coded_count is per channel), so each
// lane keeps 16 int16 values in registers and stores them as two 16-byte
// vectors: a whole 32-byte sector of its qc row, zero fill included.
//
// BitReader semantics kept exactly: a read with count <= 0 or past fs * 8
// returns 0 as a whole; the cursor is never clamped (the key search's -6 rule
// reads how far past the end it ran): only the staged word index is.
#include <cstdint>
#include <cuda_pipeline.h>
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

// B2's geometry: one warp per CTA, up to 32 frames (one a lane), each with a
// padded frame row (at least two pad words past the frame) and a padded resolution row in shared memory.
constexpr int kB2Lanes = 32;
// dynamic shared bytes without the opt-in: 48 KB less the static table
constexpr int kB2SmemBudget = 48 * 1024 - 16 * 16;

struct B2Geometry {
  int frames;        // frames per CTA (lanes that decode)
  int frame_stride;  // bytes per staged frame row: fs rounded up to 16, + 16
  int res_stride;    // bytes per staged resolution row: C * 128 + 16
  size_t smem;
};

B2Geometry b2_geometry(int fs, int C) {
  B2Geometry g;
  g.frame_stride = ((fs + 15) & ~15) + 16;
  g.res_stride = C * 128 + 16;
  const int per_frame = g.frame_stride + g.res_stride;
  g.frames = kB2Lanes;
  while (g.frames > 1 && (size_t)g.frames * per_frame > kB2SmemBudget)
    --g.frames;
  g.smem = (size_t)g.frames * per_frame;
  return g;
}

// Copy `rows` rows of `n` bytes, contiguous at src, into shared rows of
// `stride` bytes: 16-byte cp.async where src and n allow, else bytes.
__device__ __forceinline__ void stage_rows(const uint8_t* __restrict__ src,
                                           int rows, int n, uint8_t* dst,
                                           int stride, int lane) {
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && (n & 15) == 0) {
    const int q = n >> 4;
    for (int i = lane; i < rows * q; i += kB2Lanes) {
      const int r = i / q, j = i - r * q;
      __pipeline_memcpy_async(dst + r * stride + 16 * j,
                              src + (size_t)r * n + 16 * j, 16);
    }
  } else {
    for (int r = 0; r < rows; ++r)
      for (int j = lane; j < n; j += kB2Lanes)
        dst[r * stride + j] = __ldg(src + (size_t)r * n + j);
  }
}

// One lane's bit buffer: nbuf valid bits at the top of hi:lo, zeros below
// them; `next` is the staged word after them (big-endian), loaded one refill
// ahead.
struct BitBuf {
  uint32_t hi, lo, next;
  int nbuf, widx, cur;
};

// One prefix-code symbol at resolution row t (kVlcPacked); returns its value.
// Row 0 (resolution 0) reads nothing and does not move the cursor. Needs
// nbuf >= 12 and consumes at most 12 bits. The chain from one symbol to the
// next: the code's funnel shift, the advance's compare (base + (code >=
// thr), with the range check folded in), the select, the buffer's funnel
// shift.
__device__ __forceinline__ int vlc_symbol(BitBuf& b, const uint4 t,
                                          int nbits) {
  const uint32_t count = t.x & 0x1F;
  const bool big = (t.x >> 8) & 1;
  const int base = (int)((t.x >> 12) & 0xF);
  const int thr = (int)(t.x >> 16);
  // peek: `count` bits at cur, 0 as a whole past the frame end
  const bool ok = b.cur <= nbits - (int)count;
  const int raw = (int)__funnelshift_l(b.hi, 0u, count);  // hi >> (32 - count)
  const int adv = base + ((ok && raw >= thr) ? 1 : 0);
  b.cur += adv;
  b.hi = __funnelshift_l(b.lo, b.hi, adv);
  b.lo <<= adv;
  b.nbuf -= adv;
  // the value (off the chain)
  const int code = ok ? raw : 0;
  const int mag = code >> 1;
  const int v_big = (code & 1) ? -mag : mag;
  const uint32_t vw = (code & 8) ? t.z : t.y;
  const int v_small = (int)((vw >> (4 * (code & 7))) & 15u) - 8;
  return big ? v_big : v_small;
}

// Top the buffer up to nbuf >= 32 with the prefetched word (nbuf >= 8).
__device__ __forceinline__ void refill(BitBuf& b, const uint32_t* row, int W) {
  const bool low = b.nbuf < 32;
  b.hi = low ? (b.hi | (b.next >> (b.nbuf & 31))) : b.hi;
  b.lo = low ? (b.next << ((32 - b.nbuf) & 31)) : b.lo;
  b.nbuf += low ? 32 : 0;
  b.widx = min(b.widx + (low ? 1 : 0), W);
  if (low) b.next = row[b.widx];
}

// Sixteen bands (resolution bytes in r16, the first n of them coded; the
// rest read as resolution 0, which reads nothing): their int16 values packed
// two a word into p[0..7] (zero where not coded). Two symbols take at most
// 24 bits, so the buffer is topped up after every second one.
__device__ __forceinline__ void vlc_sixteen(BitBuf& b, const uint4 r16, int n,
                                            const uint4* vlc,
                                            const uint32_t* row, int W,
                                            int nbits, uint32_t (&p)[8]) {
  const uint32_t rw[4] = {r16.x, r16.y, r16.z, r16.w};
  uint4 t[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const uint32_t r = (rw[j >> 2] >> (8 * (j & 3))) & 0xFFu;
    t[j] = vlc[j < n ? min(r, 15u) : 0u];
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const uint32_t h = (uint32_t)vlc_symbol(b, t[j], nbits) & 0xFFFFu;
    p[j >> 1] = (j & 1) ? (p[j >> 1] | (h << 16)) : h;
    if (j & 1) refill(b, row, W);
  }
}

template <bool kStore>
__global__ void __launch_bounds__(kB2Lanes)
hca_coefficients_kernel(const uint8_t* __restrict__ dec,
                        const uint8_t* __restrict__ res,
                        const int32_t* __restrict__ cur0, int N,
                        CoefficientsCfg cfg, B2Geometry geo,
                        int16_t* __restrict__ qc,
                        int32_t* __restrict__ cur_end) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ uint4 vlc[16];
  const int lane = threadIdx.x;
  const int C = cfg.C;
  const int fs = cfg.fs;
  const long long f0 = (long long)blockIdx.x * geo.frames;
  const int here = (int)min((long long)geo.frames, (long long)N - f0);
  uint8_t* frows = smem;
  uint8_t* rrows = smem + (size_t)geo.frames * geo.frame_stride;
  if (lane < 16)
    vlc[lane] = make_uint4(kVlcPacked[4 * lane], kVlcPacked[4 * lane + 1],
                           kVlcPacked[4 * lane + 2], kVlcPacked[4 * lane + 3]);
  stage_rows(dec + f0 * fs, here, fs, frows, geo.frame_stride, lane);
  stage_rows(res + f0 * C * 128, here, C * 128, rrows, geo.res_stride, lane);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncwarp();
  // frame words to big-endian in place (MSB-first bit order)
  const int W = (fs + 3) >> 2;  // words holding frame bytes; row[W..] is pad
  for (int r = 0; r < here; ++r) {
    uint32_t* wr = reinterpret_cast<uint32_t*>(frows + r * geo.frame_stride);
    for (int i = lane; i < W; i += kB2Lanes)
      wr[i] = __byte_perm(wr[i], 0, 0x0123);
  }
  __syncwarp();
  if (lane >= here) return;

  const long long n = f0 + lane;
  const uint32_t* row =
      reinterpret_cast<const uint32_t*>(frows + lane * geo.frame_stride);
  const uint8_t* rrow = rrows + lane * geo.res_stride;
  const int nbits = fs * 8;
  BitBuf b;
  b.cur = cur0[n];
  const int w0 = (int)min((uint32_t)b.cur >> 5, (uint32_t)W);
  const int off = b.cur & 31;
  b.hi = __funnelshift_l(row[min(w0 + 1, W)], row[w0], off);
  b.lo = row[min(w0 + 1, W)] << off;
  b.nbuf = 64 - off;
  b.widx = min(w0 + 2, W);
  b.next = row[b.widx];
  // qc == nullptr: the cursor-only pass of the key search (no spectra)
  int16_t* __restrict__ q = kStore ? qc + n * C * 8 * 128 : nullptr;
  // program order: subframe, channel, band (hca.cpp:1195-1201)
  for (int s = 0; s < 8; ++s) {
    for (int c = 0; c < C; ++c) {
      const int cc = cfg.coded[c];
      const uint8_t* rc = rrow + c * 128;
      for (int kb = 0; kb < (kStore ? 128 : cc); kb += 16) {
        uint32_t p[8] = {0, 0, 0, 0, 0, 0, 0, 0};
        if (kb < cc)
          vlc_sixteen(b, *reinterpret_cast<const uint4*>(rc + kb), cc - kb,
                      vlc, row, W, nbits, p);
        if (kStore) {
          uint4* d = reinterpret_cast<uint4*>(q + ((size_t)c * 8 + s) * 128 + kb);
          d[0] = make_uint4(p[0], p[1], p[2], p[3]);
          d[1] = make_uint4(p[4], p[5], p[6], p[7]);
        }
      }
    }
  }
  // unclamped: the key search's -6 rule reads how far past the end it ran
  cur_end[n] = b.cur;
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

// res must start 16-byte aligned (the wrapper copies it otherwise); dec may
// start anywhere. qc == nullptr runs the cursor-only kernel.
extern "C" int hca_coefficients(const void* dec, const void* res,
                                const void* cur, int N, int fs, int C,
                                const int32_t* coded, void* qc,
                                void* cur_end, void* stream) {
  if (C < 1 || C > HCA_MAX_CH || N < 1) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(res) & 15) return (int)cudaErrorInvalidValue;
  CoefficientsCfg cfg;
  cfg.C = C;
  cfg.fs = fs;
  for (int c = 0; c < HCA_MAX_CH; ++c) cfg.coded[c] = c < C ? coded[c] : 0;
  const B2Geometry geo = b2_geometry(fs, C);
  auto kernel = qc ? &hca_coefficients_kernel<true>
                   : &hca_coefficients_kernel<false>;
  if (geo.smem > kB2SmemBudget) {
    const int rc = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)geo.smem);
    if (rc) return rc;
  }
  const long long blocks = ((long long)N + geo.frames - 1) / geo.frames;
  kernel<<<(unsigned)blocks, kB2Lanes, geo.smem, (cudaStream_t)stream>>>(
      (const uint8_t*)dec, (const uint8_t*)res, (const int32_t*)cur, N, cfg,
      geo, (int16_t*)qc, (int32_t*)cur_end);
  return (int)cudaGetLastError();
}

