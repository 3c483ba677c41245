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
// inside a frame is one dependent chain of shifts and selects; frames are
// independent, so the parallelism is the frame count (a 64-stream x
// 469-frame chunk is ~30k frames, 938 warps at one frame a lane: about seven
// an SM, one wave).
//
// B1: one warp per CTA and one frame per lane. The warp stages, for each of
// its up to 32 frames (contiguous in `dec`), the 16-byte chunks from the
// boundary below the frame's start that cover the bytes its side info can
// reach (from the host's side_info_max_bits: 272 of the bank's 512 bytes),
// with coalesced 16-byte cp.async copies (bytes, zeros outside dec, for a
// chunk that reaches outside it), so any frame size and any base address
// take the same path. A lane reads its frame through B2's 64-bit bit
// buffer, turning each staged word big-endian as it loads it. The chain is
// branch-free per lane: the scalefactor mode sets one width (6 absolute,
// db delta, 0 none), an all-ones delta code adds the 6-bit escape value
// behind it, and the loop over cs is the warp's; the lane writes its
// scalefactors into a 132-byte shared row. When a frame's side info fits
// the frame (every real config), no read can cross its end and the kernel
// (kChecked false) tests none; otherwise each read returns 0 past it (the
// test would cost 7 % at the bank chunk and 4 % at 400,000 key rows:
// PERF.md). After each channel the warp shares the resolutions out: lane j
// takes bands 4j..4j+3 of every frame, the frame's noise level from its
// lane by a shuffle, a shared 68-entry table of the clamped resolutions,
// and stores the frame's sf and res rows as whole 128-byte lines. The five
// outputs are parts of one allocation.
// On "NVIDIA H100 80GB HBM3, 700.00 W" (tools/time_unpack_pack.py, device
// time in a profiler trace) the parent's thread-per-frame kernel (a
// 288-byte stack frame, byte loads from device memory) took 0.100 ms at the
// bank chunk and 0.84 ms at 400,000 key-search rows; this one takes 0.020
// and 0.19 ms, 2.7x and 2.0x its bytes bounds of 0.0072 and 0.0961 ms (the
// reachable bytes of dec read once, the outputs written once). At the
// chunk each warp's own path bounds it (staging, a ~200-symbol chain of
// ~25 instructions a symbol, the resolution pass); at 400,000 rows the
// SMs' instruction throughput and the 213 MB of stores do (an ablation in
// PERF.md splits it).
// A single call through the wrapper also waits for the host's enqueue.
// The arithmetic is the JAX kernels' symbol for symbol (_sf_symbol,
// _inten3_symbol, _resolutions), per-frame error rules included, so the
// outputs match byte for byte.
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

struct CoefficientsCfg {
  int C, fs;
  int coded[HCA_MAX_CH];
};

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

// ---------------------------------------------------------------------------
// B1: side info. One warp per CTA and up to 32 frames (one a lane). Each
// frame has a row of the 16-byte chunks from the boundary below its start
// that cover the bytes its side info can reach, as they lie in memory, and
// a scalefactor row of kSfStride bytes (33 words: lane l's byte i lies in
// bank (l + i / 4) % 32, so the lanes' byte writes never conflict, and lane
// j's word j of any one row neither).
constexpr int kB1Lanes = 32;
constexpr int kSfStride = 132;
// dynamic shared bytes a CTA may take (227 KB, less the static part)
constexpr int kB1SmemMax = 227 * 1024 - 1024;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct B1Geometry {
  int frames;  // frames per CTA
  int chunks;  // 16-byte chunks a staged frame row holds
  size_t smem;  // frames * (16 * chunks + kSfStride)
};

// `bytes` of each frame to stage: the bytes its side info can reach
B1Geometry b1_geometry(int bytes) {
  B1Geometry g;
  g.chunks = (15 + bytes + 15) >> 4;
  g.frames = kB1Lanes;
  for (;;) {
    g.smem = (size_t)g.frames * (16 * g.chunks + kSfStride);
    if (g.smem <= (size_t)kB1SmemMax || g.frames == 1) return g;
    --g.frames;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// Staged word i, big-endian (MSB-first bit order).
__device__ __forceinline__ uint32_t be_word(const uint32_t* w, int i) {
  return __byte_perm(w[i], 0, 0x0123);
}

// refill() of B2 on words kept in memory order: top the buffer up to
// nbuf >= 32 with the prefetched word (nbuf >= 1).
__device__ __forceinline__ void b1_refill(BitBuf& b, const uint32_t* words,
                                          int wl) {
  const bool low = b.nbuf < 32;
  b.hi = low ? (b.hi | (b.next >> (b.nbuf & 31))) : b.hi;
  b.lo = low ? (b.next << ((32 - b.nbuf) & 31)) : b.lo;
  b.nbuf += low ? 32 : 0;
  b.widx = min(b.widx + (low ? 1 : 0), wl);
  if (low) b.next = be_word(words, b.widx);
}

// BitReader.peek on the bit buffer: `count` (0..25, nbuf >= count) bits at
// the cursor, 0 (with kChecked) when they cross the frame end, or count is
// 0. Without kChecked no read can cross it (the host's check).
template <bool kChecked>
__device__ __forceinline__ uint32_t b1_peek(const BitBuf& b, int count,
                                            int nbits) {
  const uint32_t raw = __funnelshift_l(b.hi, 0u, count);  // hi >> (32 - count)
  return !kChecked || b.cur + count <= nbits ? raw : 0u;
}

// `count` (1..25) bits `skip` bits past the cursor (skip + count <= nbuf):
// an escape's value behind its code.
template <bool kChecked>
__device__ __forceinline__ uint32_t b1_peek_after(const BitBuf& b, int skip,
                                                  int count, int nbits) {
  const uint32_t x = __funnelshift_l(b.lo, b.hi, skip) >> (32 - count);
  return !kChecked || b.cur + skip + count <= nbits ? x : 0u;
}

// Move the cursor by n (0..31) bits; the cursor is never clamped.
__device__ __forceinline__ void b1_consume(BitBuf& b, int n) {
  b.hi = __funnelshift_l(b.lo, b.hi, n);
  b.lo <<= n;
  b.nbuf -= n;
  b.cur += n;
}

// One scalefactor symbol, branch-free over the lane's mode: a code of w
// bits (6 absolute, db delta, 0 none); a delta code equal to `expected`
// (all ones; ~0 in the other modes) escapes to the 6-bit value behind it.
// keep is ~0 in delta mode and 0 otherwise, so the absolute value is the
// code itself and neither other mode can set err.
template <bool kChecked>
__device__ __forceinline__ void sf_symbol(BitBuf& b, int w, uint32_t expected,
                                          int keep, int half, int& value,
                                          bool& err, uint8_t* dst,
                                          int nbits) {
  const uint32_t d = b1_peek<kChecked>(b, w, nbits);
  const bool esc = d == expected;
  const int vesc = (int)b1_peek_after<kChecked>(b, w, 6, nbits);
  const int test = (value & keep) + (int)d - half;
  err |= !esc && (unsigned)test >= 64u;
  value = esc ? vesc : (test & 0x3F);
  *dst = (uint8_t)value;
  b1_consume(b, esc ? w + 6 : w);
}

struct SideInfoCfg {
  int C, fs, version, hfr, min_res, max_res;
  // per channel: coded | cs << 8 | extra << 16 | type << 24 (cs counts the
  // v3 HFR extension; extra is its length)
  uint32_t chan[HCA_MAX_CH];
  uint32_t ath[32];  // the ATH curve, band 4j + b in byte b of word j
};

template <bool kChecked>
__global__ void __launch_bounds__(kB1Lanes)
hca_side_info_kernel(const uint8_t* __restrict__ dec, int N, SideInfoCfg cfg,
                     B1Geometry geo, uint8_t* __restrict__ sf_out,
                     uint8_t* __restrict__ res_out,
                     uint8_t* __restrict__ int_out,
                     int32_t* __restrict__ cur_out,
                     uint8_t* __restrict__ err_out) {
  extern __shared__ __align__(16) uint8_t smem[];
  // the resolution of curve position p in [-1, 66] at tab[p + 1], clamped
  // to [min_res, max_res]; every p below or above reads an end
  __shared__ uint8_t tab[68];
  const int lane = threadIdx.x;
  const int C = cfg.C;
  const int fs = cfg.fs;
  const long long f0 = (long long)blockIdx.x * geo.frames;
  const int here = (int)min((long long)geo.frames, (long long)N - f0);

  // stage each frame's row: geo.chunks 16-byte chunks from the boundary
  // below its start; a chunk reaching outside dec (at either end) by bytes,
  // zeros outside
  const int row_bytes = 16 * geo.chunks;
  const uintptr_t lo_addr = reinterpret_cast<uintptr_t>(dec);
  const uintptr_t hi_addr = lo_addr + (size_t)N * fs;
  const uintptr_t blk = lo_addr + (size_t)f0 * fs;
  for (int r = 0; r < here; ++r) {
    const uintptr_t a = (blk + (size_t)r * fs) & ~(uintptr_t)15;
    for (int i = lane; i < geo.chunks; i += kB1Lanes) {
      const uintptr_t g = a + 16 * (uintptr_t)i;
      uint8_t* dst = smem + r * row_bytes + 16 * i;
      if (g >= lo_addr && g + 16 <= hi_addr) {
        cp_async16(dst, reinterpret_cast<const void*>(g));
        continue;
      }
      uint32_t v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        uint32_t x = 0;
#pragma unroll
        for (int j = 3; j >= 0; --j) {
          const uintptr_t q = g + 4 * k + j;
          x = (x << 8) | (q >= lo_addr && q < hi_addr
                              ? (uint32_t)*reinterpret_cast<const uint8_t*>(q)
                              : 0u);
        }
        v[k] = x;
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
  // meanwhile: the config into registers by literal indices (a lane's four
  // ATH bands, + 1; channel c's word on lane c, read back by shuffles), the
  // resolution table into shared memory
  uint32_t ath4 = 0, chan = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) ath4 = lane == i ? cfg.ath[i] : ath4;
#pragma unroll
  for (int i = 0; i < HCA_MAX_CH; ++i) chan = lane == i ? cfg.chan[i] : chan;
  int ath1[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) ath1[j] = (int)((ath4 >> (8 * j)) & 0xFFu) + 1;
  for (int i = lane; i < 68; i += kB1Lanes) {
    const int v = i == 0 ? 15 : (i <= 66 ? (int)kInvertTable[i - 1] : 0);
    tab[i] = (uint8_t)min(max(v, cfg.min_res), cfg.max_res);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();

  // the lane's frame: its bit buffer at the frame's first byte, the row's
  // last word as the index clamp (a read past the frame end is masked)
  const bool mine = lane < here;
  const uint32_t* words = reinterpret_cast<const uint32_t*>(
      smem + (mine ? lane : 0) * row_bytes);
  const int wl = 4 * geo.chunks - 1;
  const int nbits = fs * 8;
  const int base = 8 * (int)((blk + (size_t)(mine ? lane : 0) * fs) & 15);
  BitBuf b;
  {
    const int w0 = min(base >> 5, wl), sh = base & 31;
    const uint32_t x1 = be_word(words, min(w0 + 1, wl));
    b.hi = __funnelshift_l(x1, be_word(words, w0), sh);
    b.lo = x1 << sh;
    b.nbuf = 64 - sh;
    b.widx = min(w0 + 2, wl);
    b.next = be_word(words, b.widx);
  }
  // frame bytes 2-3: the 9-bit noise level and the 7-bit boundary
  const int packed_noise = (int)(((b.hi >> 7) & 0x1FFu) << 8) -
                           (int)(b.hi & 0x7Fu);
  b.hi = b.lo;  // past the 32-bit header (sh is 0, 8, 16 or 24)
  b.lo = 0;
  b.nbuf -= 32;
  b.cur = 32;
  bool err = false;
  uint8_t* const sf_rows = smem + geo.frames * row_bytes;
  uint8_t* row = sf_rows + lane * kSfStride;
  const long long n = f0 + lane;

  for (int c = 0; c < C; ++c) {
    const uint32_t cw = __shfl_sync(kFull, chan, c);
    const int coded = (int)(cw & 0xFF), cs = (int)((cw >> 8) & 0xFF);
    const int extra = (int)((cw >> 16) & 0xFF), ctype = (int)(cw >> 24);
    if (mine) {
      // scalefactors (hca.cpp:1290-1355); the loop over cs is the warp's
#pragma unroll
      for (int i = 0; i < kSfStride / 4; ++i)
        reinterpret_cast<uint32_t*>(row)[i] = 0;
      b1_refill(b, words, wl);
      const int db = (int)b1_peek<kChecked>(b, 3, nbits);
      b1_consume(b, 3);
      const bool is_abs = db >= 6, is_delta = db >= 1 && db <= 5;
      // the delta branch reads its first value even at cs 0
      const bool first = is_delta || (is_abs && cs > 0);
      int value = first ? (int)b1_peek<kChecked>(b, 6, nbits) : 0;
      b1_consume(b, first ? 6 : 0);
      row[0] = (uint8_t)value;
      b1_refill(b, words, wl);
      const int w = is_abs ? 6 : (is_delta ? db : 0);
      const uint32_t expected = is_delta ? (1u << db) - 1u : ~0u;
      const int keep = is_delta ? ~0 : 0;
      const int half = is_delta ? ((1 << db) - 1) >> 1 : 0;
      int i = 1;
      for (; i + 1 < cs; i += 2) {  // two symbols take <= 22 bits
        sf_symbol<kChecked>(b, w, expected, keep, half, value, err, row + i,
                            nbits);
        sf_symbol<kChecked>(b, w, expected, keep, half, value, err,
                            row + i + 1, nbits);
        b1_refill(b, words, wl);
      }
      if (i < cs)
        sf_symbol<kChecked>(b, w, expected, keep, half, value, err, row + i,
                            nbits);
      // v3 HFR extension: sf[127-i] = sf[cs-i], i ascending (i=0 copies a 0)
      for (int i = 0; i < extra; ++i) row[127 - i] = row[cs - i];

      // intensity (secondary) or v2 HFR scales (hca.cpp:1357-1434)
      b1_refill(b, words, wl);
      uint32_t in0 = 0, in1 = 0;  // intensities 0-3, 4-7, a byte each
      if (ctype == kStereoSecondary) {
        const int v4 = (int)b1_peek<kChecked>(b, 4, nbits);
        const bool flag = v4 < 15;
        if (cfg.version <= kVersionV200) {
          // inten[0] = v4 even at 15; the cursor moves only below 15
          const int step = flag ? 4 : 0;
          b1_consume(b, step);
          in0 = (uint32_t)v4;
#pragma unroll
          for (int k = 1; k < 8; ++k) {
            const uint32_t v = b1_peek<kChecked>(b, step, nbits);
            b1_consume(b, step);
            if (k < 4) in0 |= v << (8 * k);
            else in1 |= v << (8 * (k - 4));
            if (k == 3) b1_refill(b, words, wl);
          }
        } else {
          b1_consume(b, 4);
          const int db2 = (int)b1_peek<kChecked>(b, 2, nbits);
          b1_consume(b, flag ? 2 : 0);
          b1_refill(b, words, wl);
          const bool direct = flag && db2 == 3, delta = flag && db2 < 3;
          const int nb = delta ? db2 + 1 : 0;
          const int bmax = (2 << db2) - 1;
          const int w3 = direct ? 4 : nb;
          const uint32_t expect3 = delta ? (uint32_t)bmax : ~0u;
          int value3 = v4;
          in0 = flag ? (uint32_t)v4 : 7u;
#pragma unroll
          for (int k = 1; k < 8; ++k) {  // a symbol takes <= 7 bits
            const uint32_t d = b1_peek<kChecked>(b, w3, nbits);
            const bool esc = d == expect3;
            const int vesc = (int)b1_peek_after<kChecked>(b, w3, 4, nbits);
            const int vnew = esc ? vesc : value3 - (bmax >> 1) + (int)d;
            err |= delta && (vnew > 15 || vnew < 0);
            value3 = delta ? vnew : value3;
            const uint32_t v =
                (uint32_t)(direct ? (int)d : (delta ? value3 : 7)) & 0xFFu;
            if (k < 4) in0 |= v << (8 * k);
            else in1 |= v << (8 * (k - 4));
            b1_consume(b, esc ? w3 + 4 : w3);
            if (k == 4) b1_refill(b, words, wl);
          }
        }
      } else if (cfg.version <= kVersionV200 && cfg.hfr > 0) {
        for (int i = 0; i < cfg.hfr; ++i) {
          row[128 - cfg.hfr + i] = (uint8_t)b1_peek<kChecked>(b, 6, nbits);
          b1_consume(b, 6);
          if (i & 1) b1_refill(b, words, wl);
        }
      }
      *reinterpret_cast<uint2*>(int_out + ((size_t)n * C + c) * 8) =
          make_uint2(in0, in1);
    }
    __syncwarp();

    // resolutions (hca.cpp:1444-1494), the warp over each frame: lane j
    // takes bands 4j..4j+3, the frame's noise level from its lane, then
    // stores the frame's sf and res rows as two 128-byte lines. A band
    // reads 0 where its sf is 0 or it is not coded: the two byte masks.
    uint32_t coded4 = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      coded4 |= 4 * lane + j < coded ? 0xFFu << (8 * j) : 0u;
    const uint8_t* tab1 = tab + 1;
    const uint8_t* rows = sf_rows + 4 * lane;
    uint8_t* sfo = sf_out + ((size_t)f0 * C + c) * 128 + 4 * lane;
    uint8_t* reso = res_out + ((size_t)f0 * C + c) * 128 + 4 * lane;
#pragma unroll 2
    for (int r = 0; r < here; ++r, sfo += C * 128, reso += C * 128) {
      const int pn = __shfl_sync(kFull, packed_noise, r) + 4 * lane;
      const uint32_t s4 = *reinterpret_cast<const uint32_t*>(
          rows + r * kSfStride);
      // 0xFF in the bytes whose sf is not 0 (every sf is below 64)
      const uint32_t nz = (((s4 + 0x7F7F7F7Fu) & 0x80808080u) >> 7) * 0xFFu;
      uint32_t r4 = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = (int)__byte_perm(s4, 0, 0x4440 + j);  // byte j
        const int pos = ath1[j] + ((pn + j) >> 8) - ((5 * s) >> 1);
        r4 |= (uint32_t)tab1[min(max(pos, -1), 66)] << (8 * j);
      }
      *reinterpret_cast<uint32_t*>(sfo) = s4;
      *reinterpret_cast<uint32_t*>(reso) = r4 & nz & coded4;
    }
    __syncwarp();  // the rows are the next channel's
  }
  if (mine) {
    cur_out[n] = b.cur;  // unclamped: the key search reads how far it ran
    err_out[n] = (uint8_t)err;
  }
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

// cfg (host): fs, C, version, hfr, min_res, max_res, the most bits a
// frame's side info can take (DeviceUnpacker.side_info_max_bits), then per
// channel coded[C], cs[C], extra[C], type[C], then the ATH curve as 32
// words of 4 bands. The outputs, sf and res u8 [N, C, 128], inten u8
// [N, C, 8], cur i32 [N] and err bool [N], each start 16-byte aligned; dec
// may start anywhere.
extern "C" int hca_side_info(const void* dec, int N, const int32_t* cfg_in,
                             void* sf, void* res, void* inten, void* cur,
                             void* err, void* stream) {
  const int fs = cfg_in[0], C = cfg_in[1], max_bits = cfg_in[6];
  if (C < 1 || C > HCA_MAX_CH || N < 1 || fs < 4 || max_bits < 32)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(sf) | reinterpret_cast<uintptr_t>(res) |
       reinterpret_cast<uintptr_t>(inten) | reinterpret_cast<uintptr_t>(cur) |
       reinterpret_cast<uintptr_t>(err)) & 15)
    return (int)cudaErrorMisalignedAddress;
  SideInfoCfg cfg;
  cfg.C = C;
  cfg.fs = fs;
  cfg.version = cfg_in[2];
  cfg.hfr = cfg_in[3];
  cfg.min_res = cfg_in[4];
  cfg.max_res = cfg_in[5];
  const int32_t* chan = cfg_in + 7;
  for (int c = 0; c < HCA_MAX_CH; ++c)
    cfg.chan[c] = c < C ? (uint32_t)chan[c] | (uint32_t)chan[C + c] << 8 |
                              (uint32_t)chan[2 * C + c] << 16 |
                              (uint32_t)chan[3 * C + c] << 24
                        : 0u;
  for (int j = 0; j < 32; ++j) cfg.ath[j] = (uint32_t)chan[4 * C + j];
  // when the side info fits the frame no read can cross its end: stage
  // only the bytes it can reach and test no read
  const bool checked = max_bits > fs * 8;
  const B1Geometry geo = b1_geometry(checked ? fs : (max_bits + 7) >> 3);
  auto kernel = checked ? &hca_side_info_kernel<true>
                        : &hca_side_info_kernel<false>;
  if (geo.smem > 48 * 1024) {
    const int rc = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)geo.smem);
    if (rc) return rc;
  }
  const long long blocks = ((long long)N + geo.frames - 1) / geo.frames;
  kernel<<<(unsigned)blocks, kB1Lanes, geo.smem, (cudaStream_t)stream>>>(
      (const uint8_t*)dec, N, cfg, geo, (uint8_t*)sf, (uint8_t*)res,
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

