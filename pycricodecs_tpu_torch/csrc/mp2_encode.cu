// MPEG Layer II encoder kernels for Hopper (sm_90a): K2 mp2_allocate and K3
// mp2_pack.
//
// Not TPU Pallas kernels: in the JAX package these steps are numpy on the
// host, the f64 lane of pycricodecs_tpu/models/ahx.py encode_mp2
// (:170-283: scalefactors, scfsi, the greedy allocation, quantisation) and
// ops/mp2_frame.py pack_frames (:367-472). (Its jnp device encoder,
// ops/mp2_encode_device.py, ranks by an f32 proxy and gives other bytes.)
// Plain PyTorch twins: pycricodecs_tpu_torch/ops/mp2_encode_device.py
// (allocate_plain, pack_plain), byte-equal by test.
//
// K2, a warp per (stream, frame), lane = subband, a slot per channel, from
// S, K1's part peaks and need_db (numpy's 20 log10(max(frame peak, 1e-9))
// on the host: CUDA's log10 differs from numpy's in the last bit on 5.8 %
// of values, and the reference is numpy's), exactly as encode_mp2 orders
// each float64 operation: sfidx = count(sf >= part peak - 1e-12) - 1
// floored at 0 (a binary search: the 63 scalefactors strictly decrease),
// scfsi and its scalefactor bits; at joint subbands the mid signal
// (S0 + S1) * 0.5 and its part peaks' scalefactors; first_cost, need and
// eligibility (joint subbands allocate once, in channel 0's slot, paying
// both channels' side info, needing the louder channel); the greedy loop:
// each step every eligible slot's cost and gain = need - snr[class], ok =
// class + 1 < ncls, gain > -60, spent + cost <= budget; a warp argmax over
// the flat channel-major index ch * sblimit + sb picks the largest gain,
// the lowest index on a tie (numpy's argmax); it stops when no slot is ok.
// Then the quantisation clip(floor(((s / sf) * n + n - 1) * 0.5 + 0.5), 0,
// n - 1) with an IEEE division by sf (the reference's / 2 is the multiply
// by 0.5, the same correctly rounded value), and the transmitted
// allocation (channel 1 repeats channel 0 at joint subbands).
// K3, a warp per (stream, frame), lane = subband: the frame's bytes in
//   pack_frame's field order: header with the frame's padding bit; nbal
//   allocation bits a (sb, ch < C, or 1 at joint subbands); 2-bit scfsi a
//   (sb, ch) with a nonzero allocation; 1-3 six-bit scalefactors by scfsi;
//   12 granules of one grouped field (5/7/10 bits) or three code_bits fields
//   a (sb, ch slot); every other bit 0, no CRC. A field that would pass the
//   frame end is dropped whole, and every later one with it (pack_plain's
//   rule; pack_frame's BitWriter, which keeps its position on a drop,
//   agrees on every frame that fits, and the budget keeps every encoded
//   frame inside).
//
// What bounds them on this card: bytes. K2 reads S once (9,216 bytes a
// frame and channel) and the part peaks, and writes 2.6 KB of codes and
// side info; a frame's greedy loop is a few tens of warp steps of integer
// and f64 compares. K3 reads the codes (2,304 bytes a frame and channel)
// and side info and writes the frames (~0.6 KB each at the AHX bank).
//
// Design: K2 keeps no S in shared memory for the loop: a CTA of 8 warps
// holds the class tables and scalefactors (9 KB), so many frames are in
// flight an SM to hide the loop's shuffle chain and the divisions. S is
// streamed once, for the quantisation, through a per-warp ring of one
// 12-row part (3 KB; both channels' in a joint configuration, whose
// channel 0 quantises the mid signal at joint subbands) filled with
// 16-byte cp.async copies: the first part is in flight through the
// prologue and the loop, each next one through the current one's
// divisions. Joint configurations also read their joint subbands' S
// columns before the loop for the mid signal's part peaks. The argmax is a
// 5-step xor butterfly of (gain, index) pairs, so every lane ends with the
// same pick; the chosen slot's cost is a shuffle from its lane.
// K3 is persistent: as many CTAs of 8 warps as the SMs hold, each warp
// walking the frames with a grid stride, the CTA's one barrier after it
// packs the class table (levels, group and code bits in one int a
// (subband, class)) into shared memory once. It is templated on C, and
// every buffer is sized to C and to the launch's largest frame. A warp
// double-buffers its frame's codes (C x 2,304 bytes a stage): the next
// frame's go out by 16-byte cp.async, and its side info into registers,
// before the current frame packs. Each section (allocation, scfsi,
// scalefactors, each granule) is laid out by one exclusive warp scan of the
// lanes' widths; a lane builds its fields of the section as one run in
// registers (at most 96 bits, a granule in stereo), stores the words it
// covers alone and ORs its first and last words (at most two shared
// atomics a lane and section, in place of one or two a field) into a
// zeroed big-endian word buffer. The frame goes out at its offset by
// aligned 4-byte stores (a funnel shift and byte swap of two words each),
// with the bytes before the first and after the last 4-byte boundary
// stored one by one.
#include <cstdint>
#include <cuda_runtime.h>

#include "hca_tables.inc"  // generated by _build.py (kMp2Sf)

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kAllocWarps = 8;       // frames (warps) a K2 CTA
constexpr int kRows = 36;            // subband rows a frame
constexpr int kPartRows = 12;        // rows a scalefactor part
constexpr int kPart = kPartRows * 32;  // doubles of one part of one channel
constexpr int kClasses = 16;
constexpr int kMaxFrame = 1729;      // largest Layer II frame: 384 kbps, 32 kHz
// class tables of a configuration (itab): levels [32][16], bits [32][17],
// ncls [32]
constexpr int kBitsOff = 32 * kClasses;
constexpr int kNclsOff = kBitsOff + 32 * (kClasses + 1);
constexpr int kItab = kNclsOff + 32;
// K2's shared memory, in doubles: itab, snr [32][16], the 63 scalefactors
// (and one more), then a ring per warp
constexpr int kSnrOff = kItab / 2;
constexpr int kSfOff = kSnrOff + 32 * kClasses;
constexpr int kRingOff = kSfOff + 64;

// count of sf[i] >= peak - 1e-12 over the strictly decreasing sf[0..62],
// less one, floored at 0: the reference's count, found by bisection
__device__ __forceinline__ int sf_index(const double* sf, double peak) {
  const double thr = __dsub_rn(peak, 1e-12);
  int cnt = 0;
#pragma unroll
  for (int step = 32; step > 0; step >>= 1)
    if (cnt + step <= 63 && sf[cnt + step - 1] >= thr) cnt += step;
  return (cnt > 1 ? cnt : 1) - 1;
}

__device__ __forceinline__ int scfsi_of(int a, int b, int c) {
  const bool e01 = a == b, e12 = b == c;
  return e01 ? (e12 ? 2 : 1) : (e12 ? 3 : 0);
}

__device__ __forceinline__ int sf_bits(int s) {
  return s == 2 ? 6 : (s == 0 ? 18 : 12);
}

__device__ __forceinline__ void cp_async16(double* dst, const double* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// one part (12 rows, 3,072 contiguous bytes) into the ring, the warp's
// lanes in turn, as one group
__device__ __forceinline__ void fetch_part(double* ring, const double* src,
                                           int lane) {
#pragma unroll
  for (int i = lane; i < kPart / 2; i += 32)
    cp_async16(ring + 2 * i, src + 2 * i);
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int C, bool kJoint>
__global__ void __launch_bounds__(kAllocWarps * 32, 4)
    mp2_allocate_kernel(const double* __restrict__ S,
                        const double* __restrict__ part_peaks, int F,
                        long long n_frames, int sblimit, int bound,
                        const double* __restrict__ need_db,
                        const int* __restrict__ budgets,
                        const int* __restrict__ itab,
                        const double* __restrict__ snr_tab,
                        uint8_t* __restrict__ alloc,
                        uint8_t* __restrict__ scfsi,
                        uint8_t* __restrict__ sfidx,
                        uint16_t* __restrict__ codes) {
  constexpr int kRing = kJoint ? 2 * kPart : kPart;  // the warp's ring
  extern __shared__ double smem[];
  int* tab = reinterpret_cast<int*>(smem);
  double* snr = smem + kSnrOff;
  double* sfs = smem + kSfOff;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  double* ring = smem + kRingOff + warp * kRing;
  const long long gid = (long long)blockIdx.x * kAllocWarps + warp;
  const bool live_frame = gid < n_frames;
  const long long b = gid / F;
  const int f = (int)(gid - b * F);
  const long long T = (long long)F * kRows;
  // rows 12p .. 12p + 11 of channel c of this frame
  auto part_of = [&](int c, int p) {
    return S + ((b * C + c) * T + f * kRows + kPartRows * p) * 32;
  };
  // the quantisation's first block (channel 0, part 0; both channels' in a
  // joint configuration) is in flight through the prologue and the loop
  if (live_frame) {
    fetch_part(ring, part_of(0, 0), lane);
    if (kJoint) fetch_part(ring + kPart, part_of(1, 0), lane);
    commit();
  }
  for (int i = threadIdx.x; i < kItab; i += kAllocWarps * 32)
    tab[i] = itab[i];
  for (int i = threadIdx.x; i < 32 * kClasses; i += kAllocWarps * 32)
    snr[i] = snr_tab[i];
  for (int i = threadIdx.x; i < 64; i += kAllocWarps * 32)
    sfs[i] = kMp2Sf[i];
  __syncthreads();
  if (!live_frame) return;

  const int sb = lane;
  const bool live = sb < sblimit;
  const bool shared_sb = kJoint && sb >= bound;    // a joint subband
  const long long fc_base = gid * C;
  int sfi[C][3], sc[C], fc[C];
  double nd[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int p = 0; p < 3; ++p)
      sfi[c][p] =
          sf_index(sfs, part_peaks[((fc_base + c) * 3 + p) * 32 + sb]);
    sc[c] = scfsi_of(sfi[c][0], sfi[c][1], sfi[c][2]);
    fc[c] = 2 + sf_bits(sc[c]);
    nd[c] = need_db[(fc_base + c) * 32 + sb];
  }
  int sfj[3] = {0, 0, 0};
  if (kJoint && shared_sb && live) {
    // the mid signal's scalefactors; channel 0's slot pays both channels'
    // side info and needs the louder channel
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      const double* s0 = part_of(0, p) + sb;
      const double* s1 = part_of(C - 1, p) + sb;
      double m = 0.0;
#pragma unroll 4
      for (int r = 0; r < kPartRows; ++r) {
        const double v = fabs(__dmul_rn(
            __dadd_rn(__ldg(s0 + r * 32), __ldg(s1 + r * 32)), 0.5));
        m = (r == 0 || v > m) ? v : m;
      }
      sfj[p] = sf_index(sfs, m);
    }
    fc[0] = 4 + sf_bits(sc[0]) + sf_bits(sc[C - 1]);
    nd[0] = nd[C - 1] > nd[0] ? nd[C - 1] : nd[0];
  }
  const int ncls = live ? tab[kNclsOff + sb] : 0;
  const int* bits = tab + kBitsOff + sb * (kClasses + 1);
  const double* snr_sb = snr + sb * kClasses;
  int al[C];
#pragma unroll
  for (int c = 0; c < C; ++c) al[c] = 0;
  int spent = 0;
  const int budget = budgets[f];
  for (;;) {
    double g_best = -__longlong_as_double(0x7FF0000000000000LL);  // -inf
    int i_best = 0x7FFFFFFF;
    int cost[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int a = al[c];
      cost[c] = 0;
      if (!live || a + 1 >= ncls || (c == 1 && shared_sb)) continue;
      cost[c] = bits[a + 1] - bits[a] + (a == 0 ? fc[c] : 0);
      const double gain = __dsub_rn(nd[c], snr_sb[a]);   // a < ncls - 1
      if (gain > -60.0 && spent + cost[c] <= budget && gain > g_best) {
        g_best = gain;              // slot 0 comes first: it wins a tie
        i_best = c * sblimit + sb;
      }
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      const double og = __shfl_xor_sync(kFull, g_best, d);
      const int oi = __shfl_xor_sync(kFull, i_best, d);
      if (og > g_best || (og == g_best && oi < i_best)) {
        g_best = og;
        i_best = oi;
      }
    }
    if (i_best == 0x7FFFFFFF) break;   // no slot is ok (every gain -inf)
    const int c_best = i_best >= sblimit ? 1 : 0;
    const int owner = i_best - c_best * sblimit;
    const int pay = __shfl_sync(kFull, C == 2 && c_best ? cost[C - 1]
                                                        : cost[0], owner);
    spent += pay;
    if (sb == owner) {
      if (c_best) al[C - 1] += 1;
      else al[0] += 1;
    }
  }

  // quantisation: each (channel, part) block from the ring, the next one
  // fetched once the lanes hold this one's values
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int n = live ? tab[sb * kClasses + al[c]] : 0;
    const double nf = (double)n;
    const bool mid = c == 0 && shared_sb;
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      wait_all();
      __syncwarp();
      double x[kPartRows];
#pragma unroll
      for (int r = 0; r < kPartRows; ++r) {
        x[r] = ring[r * 32 + sb];
        if (kJoint && c == 0 && mid)
          x[r] = __dmul_rn(__dadd_rn(x[r], ring[kPart + r * 32 + sb]), 0.5);
      }
      __syncwarp();
      const int nc = p == 2 ? c + 1 : c, np = p == 2 ? 0 : p + 1;
      if (nc < C) {
        fetch_part(ring, part_of(nc, np), lane);
        if (kJoint && nc == 0)
          fetch_part(ring + kPart, part_of(1, np), lane);
        commit();
      }
      const double sf = sfs[mid ? sfj[p] : sfi[c][p]];
      uint16_t* out =
          codes + ((fc_base + c) * kRows + kPartRows * p) * 32 + sb;
#pragma unroll
      for (int r = 0; r < kPartRows; ++r) {
        uint16_t code = 0;
        if (n > 0) {
          double t = __dmul_rn(__ddiv_rn(x[r], sf), nf);
          t = __dsub_rn(__dadd_rn(t, nf), 1.0);
          t = __dadd_rn(__dmul_rn(t, 0.5), 0.5);
          double q = floor(t);
          q = q > 0.0 ? q : 0.0;
          q = q < nf - 1.0 ? q : nf - 1.0;
          code = (uint16_t)q;
        }
        out[r * 32] = code;
      }
    }
    const int a_tx = (c == 1 && shared_sb) ? al[0] : al[c];
    alloc[(fc_base + c) * 32 + sb] = (uint8_t)(live ? a_tx : 0);
    scfsi[(fc_base + c) * 32 + sb] = (uint8_t)sc[c];
#pragma unroll
    for (int p = 0; p < 3; ++p)
      sfidx[((fc_base + c) * 3 + p) * 32 + sb] = (uint8_t)sfi[c][p];
  }
}

// Exclusive sum of x over the warp's lanes; *total is the whole sum.
__device__ __forceinline__ int warp_scan(int x, int lane, int* total) {
  int s = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, s, d);
    if (lane >= d) s += y;
  }
  *total = __shfl_sync(kFull, s, 31);
  return s - x;
}

// ctab: levels [32][16], group bits [32][16], code bits [32][16], nbal [32]
constexpr int kGbitsOff = 32 * kClasses;
constexpr int kUbitsOff = 2 * 32 * kClasses;
constexpr int kNbalOff = 3 * 32 * kClasses;
constexpr int kPackWarps = 8;                     // frames in flight a K3 CTA
constexpr int kCodeChunks = kRows * 32 * 2 / 16;  // 16-byte chunks, a channel
// K3's shared table: an int a (subband, class), levels | group bits << 17
// | code bits << 21, then nbal [32]
constexpr int kPackTab = 32 * kClasses + 32;
// int4s of a warp's word buffer for frames of up to max_frame bytes: their
// words and one more (the last 4-byte store's second word); kMaxNw4 for
// the largest Layer II frame
__host__ __device__ constexpr int pack_nw4(int max_frame) {
  return ((max_frame + 3) / 4 + 1 + 3) / 4;
}
constexpr int kMaxNw4 = pack_nw4(kMaxFrame);

// A lane's run of fields in one section: their bits right-aligned in
// hi:lo, how many, and the bit where the next field starts. A field that
// would pass the frame's fs_bits is dropped whole (every later field then
// passes it too).
struct Run {
  unsigned long long hi, lo;
  int n, end;
};

__device__ __forceinline__ Run run_at(int pos) {
  return Run{0ull, 0ull, 0, pos};
}

// append a w-bit field (w <= 16); kWide keeps more than 64 bits
template <bool kWide>
__device__ __forceinline__ void append(Run& r, unsigned v, int w,
                                       int fs_bits) {
  r.end += w;
  if (r.end > fs_bits) return;
  v &= (1u << w) - 1u;
  if (kWide && w) r.hi = (r.hi << w) | (r.lo >> (64 - w));
  r.lo = (r.lo << w) | v;
  r.n += w;
}

// Put a run of n <= 64 bits (v, right-aligned) that starts at bit p into
// the zeroed big-endian word buffer: its first and last words (which
// neighbouring lanes' runs may share) by atomicOr, a word between them (it
// covers that one alone) by a plain store; at most 3 words, in
// straight-line code.
__device__ __forceinline__ void emit(unsigned* words, int p,
                                     unsigned long long v, int n) {
  if (n == 0) return;
  const int b0 = p & 31, span = b0 + n;       // span <= 31 + 64
  const unsigned long long x = v << (64 - n);  // left-aligned
  const unsigned xh = (unsigned)(x >> 32), xl = (unsigned)x;
  const unsigned w1 = __funnelshift_r(xl, xh, b0);
  unsigned* w = words + (p >> 5);
  atomicOr(w, xh >> b0);
  if (span > 64) {
    w[1] = w1;
    atomicOr(w + 2, xl << (32 - b0));           // b0 > 0 here
  } else if (span > 32) {
    atomicOr(w + 1, w1);
  }
}

// The same for a run of up to 96 bits (a stereo lane's granule): at most 4
// words.
__device__ __forceinline__ void emit_wide(unsigned* words, int p,
                                          const Run& r) {
  if (r.n == 0) return;
  const int b0 = p & 31, span = b0 + r.n;     // span <= 31 + 96
  const int sh = 128 - span;                  // left-align in 128 bits
  unsigned long long hi, lo;
  if (sh >= 64) {
    hi = r.lo << (sh - 64);
    lo = 0ull;
  } else {
    hi = (r.hi << sh) | (r.lo >> (64 - sh));
    lo = r.lo << sh;
  }
  const unsigned wv[4] = {(unsigned)(hi >> 32), (unsigned)hi,
                          (unsigned)(lo >> 32), (unsigned)lo};
  unsigned* w = words + (p >> 5);
  atomicOr(w, wv[0]);
#pragma unroll
  for (int j = 1; j < 4; ++j) {
    if (32 * j + 32 <= span)
      w[j] = wv[j];
    else if (32 * j < span)
      atomicOr(w + j, wv[j]);
  }
}

// A slot's three codes of a granule (v[0], v[32], v[64]) as its fields'
// bits: one grouped field of g bits, or three fields of u bits (u <= 16);
// m masks a field.
__device__ __forceinline__ unsigned long long slot_bits(const uint16_t* v,
                                                        unsigned n, int g,
                                                        int u, unsigned m) {
  const unsigned v0 = v[0], v1 = v[32], v2 = v[64];
  const unsigned grouped = (v0 + n * (v1 + n * v2)) & m;
  const unsigned top = ((v0 & m) << u) | (v1 & m);   // 2 u <= 32 bits
  const unsigned long long three =
      ((unsigned long long)top << u) | (v2 & m);
  return g ? grouped : three;
}

// A frame's side info in the lane's registers (lane = subband) and its
// place in its stream.
template <int C>
struct Side {
  int a[C], s[C], sv[C][3];
  int pad;
  long long off0, off1;
};

// A warp's stage of one frame, in int4s: its codes [C][36][32] u16, then
// its side info (alloc [C][32], scfsi [C][32], sfidx [C][3][32] u8), then
// offs[f], offs[f + 1] and pads[f]
template <int C>
struct Stage {
  static constexpr int kSide = C * kCodeChunks;     // side info's offset
  static constexpr int kInfo = kSide + 10 * C;      // frame info's offset
  static constexpr int kSize = kInfo + 2;
};

// K3's dynamic shared memory for word buffers of nw4 int4s: the table,
// then each warp's two stages and its words
template <int C>
constexpr size_t pack_smem(int nw4) {
  return (size_t)kPackTab * sizeof(int) +
         (size_t)kPackWarps * (2 * Stage<C>::kSize + nw4) * sizeof(int4);
}

template <int C>
__device__ __forceinline__ void read_side(Side<C>& d, const int4* stage,
                                          int sb) {
  const uint8_t* sd = reinterpret_cast<const uint8_t*>(stage +
                                                       Stage<C>::kSide);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    d.a[c] = sd[c * 32 + sb];
    d.s[c] = sd[(C + c) * 32 + sb];
#pragma unroll
    for (int p = 0; p < 3; ++p) d.sv[c][p] = sd[(2 * C + 3 * c + p) * 32 + sb];
  }
  const long long* info =
      reinterpret_cast<const long long*>(stage + Stage<C>::kInfo);
  d.off0 = info[0];
  d.off1 = info[1];
  d.pad = reinterpret_cast<const int*>(info + 2)[0];
}

__device__ __forceinline__ void copy16(int4* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void copy8(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void copy4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

// Frame gid (f in its stream) into a stage, as one group: its codes by the
// lanes in turn, its side info's 10 C 16-byte chunks a lane each, its
// offsets and padding bit by the next lane.
template <int C>
__device__ __forceinline__ void fetch_frame(
    int4* stage, const uint16_t* __restrict__ codes,
    const uint8_t* __restrict__ alloc, const uint8_t* __restrict__ scfsi,
    const uint8_t* __restrict__ sfidx, const int* __restrict__ pads,
    const long long* __restrict__ offs, long long gid, int f, int lane) {
  const int4* cs =
      reinterpret_cast<const int4*>(codes) + gid * C * kCodeChunks + lane;
#pragma unroll
  for (int k = 0; k < (C * kCodeChunks + 31) / 32; ++k)
    if (lane + 32 * k < C * kCodeChunks)
      copy16(stage + lane + 32 * k, cs + 32 * k);
  int4* side = stage + Stage<C>::kSide;
  if (lane < 2 * C)
    copy16(side + lane, reinterpret_cast<const int4*>(alloc) +
                            gid * 2 * C + lane);
  else if (lane < 4 * C)
    copy16(side + lane, reinterpret_cast<const int4*>(scfsi) +
                            gid * 2 * C + lane - 2 * C);
  else if (lane < 10 * C)
    copy16(side + lane, reinterpret_cast<const int4*>(sfidx) +
                            gid * 6 * C + lane - 4 * C);
  else if (lane == 10 * C) {
    long long* info = reinterpret_cast<long long*>(stage + Stage<C>::kInfo);
    copy8(info, offs + f);
    copy8(info + 1, offs + f + 1);
    copy4(info + 2, pads + f);
  }
}

__device__ __forceinline__ void wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// One frame into the word buffer, in pack_frame's field order: the header
// (lane 0), then the sections, a lane's fields of a section as one run. The
// allocation's layout is the same for every frame (apos, atot: the
// caller's scan); one exclusive warp scan lays out the other three.
template <int C>
__device__ __forceinline__ void pack_words(unsigned* words,
                                           const uint16_t* cw,
                                           const Side<C>& d, const int* trow,
                                           int sb, int nch, int nb, int apos,
                                           int atot, unsigned hdr_base,
                                           int fs_bits) {
  if (sb == 0 && fs_bits >= 32)
    words[0] = hdr_base | ((unsigned)d.pad << 9);
  // each section's widths: scfsi 2 bits a channel with a nonzero
  // allocation, 1-3 six-bit scalefactors by scfsi, a slot's sample fields
  // (a granule's; every granule repeats them)
  int a[C], nsf[C], g[C], u[C], w[C], ws = 0, wf = 0, wq = 0;
  unsigned n[C], m[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    a[c] = nch > 0 ? d.a[c] : 0;
    nsf[c] = a[c] > 0 ? (d.s[c] == 0 ? 3 : (d.s[c] == 2 ? 1 : 2)) : 0;
    ws += a[c] > 0 ? 2 : 0;
    wf += 6 * nsf[c];
    const int e = c < nch ? trow[a[c] & (kClasses - 1)] : 0;
    n[c] = (unsigned)(e & 0x1FFFF);
    g[c] = (e >> 17) & 15;
    u[c] = e >> 21;
    w[c] = n[c] ? (g[c] ? g[c] : 3 * u[c]) : 0;
    m[c] = (1u << (g[c] ? g[c] : u[c])) - 1u;
    wq += w[c];
  }
  // one scan of the three widths packed as 8, 11 and 12 bits (the warp's
  // sums are at most 128, 1,152 and 3,072: no carry between them)
  int tot;
  const int off = warp_scan(ws | wf << 8 | wq << 19, sb, &tot);
  const int sf0 = 32 + atot + (tot & 0xFF);            // scalefactors
  const int pos = sf0 + ((tot >> 8) & 0x7FF);          // samples
  const int granule = tot >> 19, intra = off >> 19;
  // allocation
  Run r = run_at(32 + apos);
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (c < nch) append<false>(r, a[c], nb, fs_bits);
  emit(words, 32 + apos, r.lo, r.n);
  // scfsi
  int p = 32 + atot + (off & 0xFF);
  r = run_at(p);
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (a[c] > 0) append<false>(r, d.s[c], 2, fs_bits);
  emit(words, p, r.lo, r.n);
  // scalefactors
  p = sf0 + ((off >> 8) & 0x7FF);
  r = run_at(p);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (nsf[c] == 0) continue;
    append<false>(r, d.sv[c][0], 6, fs_bits);
    if (nsf[c] >= 2)
      append<false>(r, d.s[c] == 1 ? d.sv[c][2] : d.sv[c][1], 6, fs_bits);
    if (nsf[c] == 3) append<false>(r, d.sv[c][2], 6, fs_bits);
  }
  emit(words, p, r.lo, r.n);
  // samples: 12 granules
  if (pos + 12 * granule <= fs_bits) {
    // every field fits (every frame the encoder makes): a slot's fields
    // as one value
#pragma unroll
    for (int gr = 0; gr < 12; ++gr) {
      p = pos + gr * granule + intra;
      const uint16_t* v = cw + 3 * gr * 32 + sb;
      const unsigned long long s0 = slot_bits(v, n[0], g[0], u[0], m[0]);
      if (C == 1) {
        emit(words, p, s0, w[0]);
      } else {
        const unsigned long long s1 =
            slot_bits(v + kRows * 32, n[C - 1], g[C - 1], u[C - 1],
                      m[C - 1]);
        const int w1 = w[C - 1];
        r.hi = w1 ? s0 >> (64 - w1) : 0ull;
        r.lo = (w1 ? s0 << w1 : s0) | s1;
        r.n = w[0] + w1;
        emit_wide(words, p, r);
      }
    }
    return;
  }
  // the frame ends inside its samples: field by field
  for (int gr = 0; gr < 12; ++gr) {
    p = pos + gr * granule + intra;
    r = run_at(p);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (n[c] == 0) continue;
      const uint16_t* v = cw + (c * kRows + 3 * gr) * 32 + sb;
      const unsigned v0 = v[0], v1 = v[32], v2 = v[64];
      if (g[c]) {
        append<C == 2>(r, v0 + n[c] * (v1 + n[c] * v2), g[c], fs_bits);
      } else {
        append<C == 2>(r, v0, u[c], fs_bits);
        append<C == 2>(r, v1, u[c], fs_bits);
        append<C == 2>(r, v2, u[c], fs_bits);
      }
    }
    if (C == 1)
      emit(words, p, r.lo, r.n);
    else
      emit_wide(words, p, r);
  }
}

// byte i of the frame in the big-endian word buffer
__device__ __forceinline__ uint8_t frame_byte(const unsigned* words, int i) {
  return (uint8_t)(words[i >> 2] >> (24 - 8 * (i & 3)));
}

// The frame's fs bytes at dst: the bytes up to dst's first 4-byte boundary
// and those after its last one by byte stores, the rest by aligned 4-byte
// stores, each built from two buffer words by a funnel shift and a byte
// swap. Nothing past the frame's ends is written.
__device__ __forceinline__ void store_frame(const unsigned* words,
                                            uint8_t* dst, int fs, int lane) {
  int h = (int)((4 - (reinterpret_cast<uintptr_t>(dst) & 3)) & 3);
  h = h < fs ? h : fs;
  const int nw = (fs - h) >> 2, t0 = h + 4 * nw;
  if (lane < h) dst[lane] = frame_byte(words, lane);
  if (lane < fs - t0) dst[t0 + lane] = frame_byte(words, t0 + lane);
  unsigned* d4 = reinterpret_cast<unsigned*>(dst + h);
  for (int k = lane; k < nw; k += 32)
    d4[k] = __byte_perm(__funnelshift_l(words[k + 1], words[k], 8 * h), 0u,
                        0x0123);
}

template <int C>
__global__ void __launch_bounds__(kPackWarps * 32, C == 1 ? 4 : 2)
    mp2_pack_kernel(const uint8_t* __restrict__ alloc,
                    const uint8_t* __restrict__ scfsi,
                    const uint8_t* __restrict__ sfidx,
                    const uint16_t* __restrict__ codes,
                    const int* __restrict__ pads,
                    const long long* __restrict__ offs, int F,
                    long long n_frames, int sblimit, int bound,
                    unsigned hdr_base, const int* __restrict__ ctab,
                    long long total, int max_frame, int nw4,
                    uint8_t* __restrict__ out) {
  constexpr int kStage = Stage<C>::kSize;          // int4s of a frame's stage
  extern __shared__ int4 smem4[];
  int* tab = reinterpret_cast<int*>(smem4);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int4* stage = smem4 + kPackTab / 4 + warp * (2 * kStage + nw4);
  int4* words4 = stage + 2 * kStage;
  unsigned* words = reinterpret_cast<unsigned*>(words4);
  // the warp's frames: gid, gid + stride, ...
  const long long stride = (long long)gridDim.x * kPackWarps;
  long long gid = (long long)blockIdx.x * kPackWarps + warp;
  // the warp's first frame is in flight while the CTA builds its table
  if (gid < n_frames)
    fetch_frame<C>(stage, codes, alloc, scfsi, sfidx, pads, offs, gid,
                   (int)(gid % F), lane);
  commit();
  for (int i = threadIdx.x; i < 32 * kClasses; i += kPackWarps * 32)
    tab[i] = ctab[i] | ctab[kGbitsOff + i] << 17 | ctab[kUbitsOff + i] << 21;
  if (threadIdx.x < 32)
    tab[32 * kClasses + threadIdx.x] = ctab[kNbalOff + threadIdx.x];
  __syncthreads();                 // the CTA's only barrier
  if (gid >= n_frames) return;
  const int sb = lane;
  const bool live = sb < sblimit;
  const int nch = live ? (sb < bound ? C : 1) : 0;
  const int nb = tab[32 * kClasses + sb];
  int atot;
  const int apos = warp_scan(nb * nch, lane, &atot);
  const int* trow = tab + sb * kClasses;
  const long long db = stride / F;
  const int df = (int)(stride - db * F);
  long long b = gid / F;
  int f = (int)(gid - b * F);
  int st = 0;
  for (;;) {
    const long long nxt = gid + stride;
    long long nxt_b = b + db;
    int nxt_f = f + df;
    if (nxt_f >= F) {
      nxt_f -= F;
      ++nxt_b;
    }
    const bool more = nxt < n_frames;
    // the next frame is in flight while this one packs
    if (more)
      fetch_frame<C>(stage + (st ^ 1) * kStage, codes, alloc, scfsi, sfidx,
                     pads, offs, nxt, nxt_f, lane);
    commit();
#pragma unroll
    for (int k = 0; k < (kMaxNw4 + 31) / 32; ++k)
      if (lane + 32 * k < nw4) words4[lane + 32 * k] = make_int4(0, 0, 0, 0);
    wait_prior();
    __syncwarp();
    Side<C> cur;
    read_side<C>(cur, stage + st * kStage, sb);
    int fs = (int)(cur.off1 - cur.off0);
    fs = fs < max_frame ? fs : max_frame;
    pack_words<C>(words,
                  reinterpret_cast<const uint16_t*>(stage + st * kStage),
                  cur, trow, sb, nch, nb, apos, atot, hdr_base, fs * 8);
    __syncwarp();
    store_frame(words, out + b * total + cur.off0, fs, lane);
    if (!more) break;
    __syncwarp();                  // the stage and the words are reused
    gid = nxt;
    b = nxt_b;
    f = nxt_f;
    st ^= 1;
  }
}

template <int C>
cudaError_t launch_pack(const uint8_t* alloc, const uint8_t* scfsi,
                        const uint8_t* sfidx, const uint16_t* codes,
                        const int* pads, const long long* offs, int F,
                        long long n_frames, int sblimit, int bound,
                        unsigned hdr_base, const int* ctab, long long total,
                        int max_frame, uint8_t* out, cudaStream_t stream) {
  const int nw4 = pack_nw4(max_frame);
  const size_t smem = pack_smem<C>(nw4);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  // the shared-memory limit and the CTAs an SM holds, set and queried once
  // for a (thread, device, buffer size): host time a launch saves. The
  // limit is the kernel's on the device for every thread of the process,
  // so each thread sets it to what the largest frame needs: no thread
  // lowers it under another's launch of larger frames
  static thread_local int last_dev = -1, last_nw4 = -1, held = 0;
  if (dev != last_dev || nw4 != last_nw4) {
    int sms = 0, per_sm = 0;
    e = cudaFuncSetAttribute(mp2_pack_kernel<C>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)pack_smem<C>(kMaxNw4));
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, mp2_pack_kernel<C>, kPackWarps * 32, smem);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    last_dev = dev;
    last_nw4 = nw4;
    held = per_sm * sms;
  }
  // persistent: as many CTAs as the SMs hold, or as the frames need
  const long long need = (n_frames + kPackWarps - 1) / kPackWarps;
  const long long blocks = need < held ? need : held;
  mp2_pack_kernel<C><<<(unsigned)blocks, kPackWarps * 32, smem, stream>>>(
      alloc, scfsi, sfidx, codes, pads, offs, F, n_frames, sblimit, bound,
      hdr_base, ctab, total, max_frame, nw4, out);
  return cudaGetLastError();
}

template <int C, bool kJoint>
cudaError_t launch_allocate(const double* S, const double* part_peaks, int F,
                            long long n_frames, int sblimit, int bound,
                            const double* need_db, const int* budgets,
                            const int* itab, const double* snr,
                            uint8_t* alloc, uint8_t* scfsi, uint8_t* sfidx,
                            uint16_t* codes, cudaStream_t stream) {
  const size_t smem =
      (size_t)(kRingOff + kAllocWarps * (kJoint ? 2 : 1) * kPart) *
      sizeof(double);
  cudaError_t e = cudaFuncSetAttribute(
      mp2_allocate_kernel<C, kJoint>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const long long blocks = (n_frames + kAllocWarps - 1) / kAllocWarps;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  mp2_allocate_kernel<C, kJoint><<<(unsigned)blocks, kAllocWarps * 32, smem,
                                   stream>>>(
      S, part_peaks, F, n_frames, sblimit, bound, need_db, budgets, itab, snr,
      alloc, scfsi, sfidx, codes);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mp2_allocate(const void* S, const void* part_peaks, int B,
                            int F, int C, int sblimit, int bound, int joint,
                            const void* need_db, const void* budgets,
                            const void* itab, const void* snr, void* alloc,
                            void* scfsi, void* sfidx, void* codes,
                            void* stream) {
  if (B < 1 || F < 1 || C < 1 || C > 2 || sblimit < 1 || sblimit > 32 ||
      bound < 0 || bound > sblimit || (joint && C != 2))
    return (int)cudaErrorInvalidValue;
  // S is streamed through the rings with 16-byte copies
  if ((reinterpret_cast<uintptr_t>(S) & 15) != 0)
    return (int)cudaErrorMisalignedAddress;
  const long long n_frames = (long long)B * F;
  const double* s = (const double*)S;
  const double* pp = (const double*)part_peaks;
  const double* nd = (const double*)need_db;
  const int* bud = (const int*)budgets;
  const int* it = (const int*)itab;
  const double* sn = (const double*)snr;
  uint8_t* al = (uint8_t*)alloc;
  uint8_t* sc = (uint8_t*)scfsi;
  uint8_t* sf = (uint8_t*)sfidx;
  uint16_t* cd = (uint16_t*)codes;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e =
      C == 1 ? launch_allocate<1, false>(s, pp, F, n_frames, sblimit, bound,
                                         nd, bud, it, sn, al, sc, sf, cd, st)
      : joint ? launch_allocate<2, true>(s, pp, F, n_frames, sblimit, bound,
                                         nd, bud, it, sn, al, sc, sf, cd, st)
              : launch_allocate<2, false>(s, pp, F, n_frames, sblimit, bound,
                                          nd, bud, it, sn, al, sc, sf, cd,
                                          st);
  return (int)e;
}

extern "C" int mp2_pack(const void* alloc, const void* scfsi,
                        const void* sfidx, const void* codes, const void* pads,
                        const void* offs, int B, int F, int C, int sblimit,
                        int bound, unsigned hdr_base, const void* ctab,
                        long long total, int max_frame, void* out,
                        void* stream) {
  if (B < 1 || F < 1 || C < 1 || C > 2 || sblimit < 1 || sblimit > 32 ||
      bound < 0 || bound > sblimit || max_frame > kMaxFrame)
    return (int)cudaErrorInvalidValue;
  // a frame's codes and side info are staged with 16-byte copies
  if (((reinterpret_cast<uintptr_t>(codes) |
        reinterpret_cast<uintptr_t>(alloc) |
        reinterpret_cast<uintptr_t>(scfsi) |
        reinterpret_cast<uintptr_t>(sfidx)) & 15) != 0)
    return (int)cudaErrorMisalignedAddress;
  const long long n_frames = (long long)B * F;
  const uint8_t* al = (const uint8_t*)alloc;
  const uint8_t* sc = (const uint8_t*)scfsi;
  const uint8_t* sf = (const uint8_t*)sfidx;
  const uint16_t* cd = (const uint16_t*)codes;
  const int* pd = (const int*)pads;
  const long long* of = (const long long*)offs;
  const int* ct = (const int*)ctab;
  uint8_t* o = (uint8_t*)out;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e =
      C == 1 ? launch_pack<1>(al, sc, sf, cd, pd, of, F, n_frames, sblimit,
                              bound, hdr_base, ct, total, max_frame, o, st)
             : launch_pack<2>(al, sc, sf, cd, pd, of, F, n_frames, sblimit,
                              bound, hdr_base, ct, total, max_frame, o, st);
  return (int)e;
}
