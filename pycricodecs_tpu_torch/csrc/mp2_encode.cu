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
//   frame end is dropped (pack_frame's BitWriter drops it; the budget
//   keeps every encoded frame inside).
//
// What bounds them on this card: bytes. K2 reads S once (9,216 bytes a
// frame and channel) and the part peaks, and writes 2.6 KB of codes and
// side info; a frame's greedy loop is a few tens of warp steps of integer
// and f64 compares. K3 reads the codes and side info and writes the frames
// (~0.6 KB each at the AHX bank).
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
// same pick; the chosen slot's cost is a shuffle from its lane. K3 stages
// the frame's codes with 16-byte loads, lays each of the four sections out
// with one exclusive warp scan of the lanes' field widths (a lane's two
// channel slots in order), ORs each field into a zeroed big-endian word
// buffer in shared memory and writes the frame's bytes out, coalesced, at
// its offset.
#include <cstdint>
#include <cuda_runtime.h>

#include "hca_tables.inc"  // generated by _build.py (kMp2Sf)

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarps = 4;            // frames (warps) a K3 CTA
constexpr int kAllocWarps = 8;       // frames (warps) a K2 CTA
constexpr int kRows = 36;            // subband rows a frame
constexpr int kPartRows = 12;        // rows a scalefactor part
constexpr int kPart = kPartRows * 32;  // doubles of one part of one channel
constexpr int kClasses = 16;
constexpr int kMaxFrame = 1729;      // largest Layer II frame: 384 kbps, 32 kHz
constexpr int kWords = (kMaxFrame + 3) / 4 + 1;
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

// OR the w-bit field v (1 <= w <= 32) in at bit pos of the big-endian word
// buffer, unless it would pass the frame's fs_bits
__device__ __forceinline__ void put(unsigned* words, int pos, int w,
                                    unsigned v, int fs_bits) {
  if (w <= 0 || pos + w > fs_bits) return;
  if (w < 32) v &= (1u << w) - 1u;
  const int i = pos >> 5, bit = pos & 31;
  if (bit + w <= 32) {
    atomicOr(words + i, v << (32 - bit - w));
  } else {
    atomicOr(words + i, v >> (bit + w - 32));
    atomicOr(words + i + 1, v << (64 - bit - w));
  }
}

// ctab: levels [32][16], group bits [32][16], code bits [32][16], nbal [32]
constexpr int kGbitsOff = 32 * kClasses;
constexpr int kUbitsOff = 2 * 32 * kClasses;
constexpr int kNbalOff = 3 * 32 * kClasses;
constexpr int kCtab = kNbalOff + 32;
constexpr int kCodeWords = 2 * kRows * 32 / 8;   // int4 chunks, 2 channels

__global__ void __launch_bounds__(kWarps * 32)
    mp2_pack_kernel(const uint8_t* __restrict__ alloc,
                    const uint8_t* __restrict__ scfsi,
                    const uint8_t* __restrict__ sfidx,
                    const uint16_t* __restrict__ codes,
                    const int* __restrict__ pads,
                    const long long* __restrict__ offs, int F, int C,
                    long long n_frames, int sblimit, int bound,
                    unsigned hdr_base, const int* __restrict__ ctab,
                    long long total, uint8_t* __restrict__ out) {
  __shared__ int tab[kCtab];
  __shared__ unsigned words_all[kWarps][kWords];
  __shared__ int4 code_all[kWarps][kCodeWords];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < kCtab; i += kWarps * 32) tab[i] = ctab[i];
  const long long gid = (long long)blockIdx.x * kWarps + warp;
  const bool live_frame = gid < n_frames;
  const long long b = gid / F;
  const int f = (int)(gid - b * F);
  unsigned* words = words_all[warp];
  const uint16_t* cw = reinterpret_cast<const uint16_t*>(code_all[warp]);
  int fs = 0;
  if (live_frame) {
    fs = (int)(offs[f + 1] - offs[f]);
    for (int i = lane; i < kWords; i += 32) words[i] = 0u;
    // the frame's codes, C x 36 x 32 u16, 16 bytes at a time
    const int4* src = reinterpret_cast<const int4*>(
        codes + (b * F + f) * C * kRows * 32);
    for (int i = lane; i < C * kRows * 32 / 8; i += 32)
      code_all[warp][i] = __ldg(src + i);
  }
  __syncthreads();
  if (!live_frame) return;
  const int fs_bits = fs * 8;
  const int sb = lane;
  const bool live = sb < sblimit;
  const int nch = live ? (sb < bound ? C : 1) : 0;
  const long long fc_base = (b * F + f) * C;
  int a[2] = {0, 0}, s[2] = {0, 0}, sv[2][3];
  for (int c = 0; c < C; ++c) {
    a[c] = live ? alloc[(fc_base + c) * 32 + sb] : 0;
    s[c] = scfsi[(fc_base + c) * 32 + sb];
    for (int p = 0; p < 3; ++p)
      sv[c][p] = sfidx[((fc_base + c) * 3 + p) * 32 + sb];
  }
  if (lane == 0) put(words, 0, 32, hdr_base | ((unsigned)pads[f] << 9),
                     fs_bits);
  // allocation
  const int nb = tab[kNbalOff + sb];
  int tot;
  int p = 32 + warp_scan(nb * nch, lane, &tot);
  for (int c = 0; c < nch; ++c, p += nb) put(words, p, nb, a[c], fs_bits);
  int pos = 32 + tot;
  // scfsi
  const bool act0 = a[0] > 0, act1 = C > 1 && a[1] > 0;
  p = pos + warp_scan(2 * (act0 + act1), lane, &tot);
  for (int c = 0; c < C; ++c) {
    if (!(c == 0 ? act0 : act1)) continue;
    put(words, p, 2, s[c], fs_bits);
    p += 2;
  }
  pos += tot;
  // scalefactors
  int nsf[2];
  for (int c = 0; c < 2; ++c) {
    const bool act = c == 0 ? act0 : act1;
    nsf[c] = act ? (s[c] == 0 ? 3 : (s[c] == 2 ? 1 : 2)) : 0;
  }
  p = pos + warp_scan(6 * (nsf[0] + nsf[1]), lane, &tot);
  for (int c = 0; c < C; ++c) {
    if (nsf[c] == 0) continue;
    put(words, p, 6, sv[c][0], fs_bits);
    if (nsf[c] >= 2)
      put(words, p + 6, 6, s[c] == 1 ? sv[c][2] : sv[c][1], fs_bits);
    if (nsf[c] == 3) put(words, p + 12, 6, sv[c][2], fs_bits);
    p += 6 * nsf[c];
  }
  pos += tot;
  // samples: a slot's width repeats every granule
  int n[2] = {0, 0}, g[2] = {0, 0}, u[2] = {0, 0}, wq[2] = {0, 0};
  for (int c = 0; c < nch; ++c) {
    const int i = sb * kClasses + a[c];
    n[c] = tab[i];
    g[c] = tab[kGbitsOff + i];
    u[c] = tab[kUbitsOff + i];
    wq[c] = n[c] ? (g[c] ? g[c] : 3 * u[c]) : 0;
  }
  int granule;
  const int intra = warp_scan(wq[0] + wq[1], lane, &granule);
  for (int gr = 0; gr < 12; ++gr) {
    int off = pos + gr * granule + intra;
    for (int c = 0; c < nch; ++c) {
      if (n[c]) {
        const uint16_t* v = cw + (c * kRows + 3 * gr) * 32 + sb;
        const unsigned v0 = v[0], v1 = v[32], v2 = v[64];
        if (g[c]) {
          put(words, off, g[c], v0 + n[c] * (v1 + n[c] * v2), fs_bits);
        } else {
          put(words, off, u[c], v0, fs_bits);
          put(words, off + u[c], u[c], v1, fs_bits);
          put(words, off + 2 * u[c], u[c], v2, fs_bits);
        }
      }
      off += wq[c];
    }
  }
  __syncwarp();
  uint8_t* dst = out + b * total + offs[f];
  for (int i = lane; i < fs; i += 32)
    dst[i] = (uint8_t)(words[i >> 2] >> (24 - 8 * (i & 3)));
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
  // a frame's codes are staged with 16-byte loads
  if ((reinterpret_cast<uintptr_t>(codes) & 15) != 0)
    return (int)cudaErrorMisalignedAddress;
  const long long n_frames = (long long)B * F;
  const long long blocks = (n_frames + kWarps - 1) / kWarps;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  mp2_pack_kernel<<<(unsigned)blocks, kWarps * 32, 0,
                    (cudaStream_t)stream>>>(
      (const uint8_t*)alloc, (const uint8_t*)scfsi, (const uint8_t*)sfidx,
      (const uint16_t*)codes, (const int*)pads, (const long long*)offs, F, C,
      n_frames, sblimit, bound, hdr_base, (const int*)ctab, total,
      (uint8_t*)out);
  return (int)cudaGetLastError();
}
