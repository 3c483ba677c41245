// MPEG Layer II encoder kernels for Hopper (sm_90a): K2 mp2_allocate (two
// passes) and K3 mp2_pack.
//
// Not TPU Pallas kernels: in the JAX package these steps are numpy on the
// host, the f64 lane of pycricodecs_tpu/models/ahx.py encode_mp2
// (:170-283: scalefactors, scfsi, the greedy allocation, quantisation) and
// ops/mp2_frame.py pack_frames (:367-472). (Its jnp device encoder,
// ops/mp2_encode_device.py, ranks by an f32 proxy and gives other bytes.)
// Plain PyTorch twins: pycricodecs_tpu_torch/ops/mp2_encode_device.py
// (frame_peaks_plain, allocate_plain, pack_plain), byte-equal by test.
//
// K2, a warp per (stream, frame), lane = subband, a slot per channel:
//   pass 1: peak[c][sb] = max |S| over the frame's 36 rows (the host takes
//     numpy's 20 log10(max(peak, 1e-9)) of it: CUDA's log10 differs from
//     numpy's in the last bit on 5.8 % of values, and the reference is
//     numpy's);
//   pass 2: from S and need_db, exactly as encode_mp2 orders each float64
//     operation: the part peaks (12 rows each), sfidx = count(sf >= peak -
//     1e-12) - 1 floored at 0, scfsi and its scalefactor bits, the joint
//     mid signal (S0 + S1) * 0.5 with its own scalefactors; first_cost,
//     need and eligibility (joint subbands allocate once, in channel 0's
//     slot, paying both channels' side info, needing the louder channel);
//     the greedy loop: each step every eligible slot's cost and gain = need
//     - snr[class], ok = class + 1 < ncls, gain > -60, spent + cost <=
//     budget; a warp argmax over the flat channel-major index ch * sblimit
//     + sb picks the largest gain, the lowest index on a tie (numpy's
//     argmax); it stops when no slot is ok. Then the quantisation
//     clip(floor(((s / sf) * n + n - 1) / 2 + 0.5), 0, n - 1) with IEEE
//     divisions, and the transmitted allocation (channel 1 repeats channel
//     0 at joint subbands).
// K3, a warp per (stream, frame), lane = subband: the frame's bytes in
//   pack_frame's field order: header with the frame's padding bit; nbal
//   allocation bits a (sb, ch < C, or 1 at joint subbands); 2-bit scfsi a
//   (sb, ch) with a nonzero allocation; 1-3 six-bit scalefactors by scfsi;
//   12 granules of one grouped field (5/7/10 bits) or three code_bits fields
//   a (sb, ch slot); every other bit 0, no CRC. A field that would pass the
//   frame end is dropped (pack_frame's BitWriter drops it; the budget
//   keeps every encoded frame inside).
//
// What bounds them on this card: bytes. K2 reads S (9,216 bytes a frame and
// channel) and writes 2.6 KB of codes and side info; a frame's greedy loop
// is a few hundred warp steps of integer and f64 compares. K3 reads the
// codes and side info and writes the frames (~0.6 KB each at the AHX bank).
//
// Design: K2 pass 2 stages each frame's S rows once into shared memory
// with 16-byte loads (each (stream, channel, frame) block of S is 9,216
// contiguous bytes) and the class tables once a CTA; the lanes read their
// own column from there for the peaks, the mid signal and the
// quantisation. The argmax is a 5-step xor butterfly of (gain, index)
// pairs, so every lane ends with the same pick; the chosen slot's cost is
// a shuffle from its lane. K3 stages the frame's codes with 16-byte loads,
// lays each of the four sections out with one exclusive warp scan of the
// lanes' field widths (a lane's two channel slots in order), ORs each field
// into a zeroed big-endian word buffer in shared memory and writes the
// frame's bytes out, coalesced, at its offset.
#include <cstdint>
#include <cuda_runtime.h>

#include "hca_tables.inc"  // generated by _build.py (kMp2Sf)

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarps = 4;            // frames (warps) a CTA
constexpr int kRows = 36;            // subband rows a frame
constexpr int kClasses = 16;
constexpr int kMaxFrame = 1729;      // largest Layer II frame: 384 kbps, 32 kHz
constexpr int kWords = (kMaxFrame + 3) / 4 + 1;
// class tables of a configuration (itab): levels [32][16], bits [32][17],
// ncls [32]
constexpr int kBitsOff = 32 * kClasses;
constexpr int kNclsOff = kBitsOff + 32 * (kClasses + 1);
constexpr int kItab = kNclsOff + 32;

__device__ __forceinline__ int sf_index(double peak) {
  const double thr = __dsub_rn(peak, 1e-12);
  int cnt = 0;
#pragma unroll 9
  for (int i = 0; i < 63; ++i) cnt += kMp2Sf[i] >= thr;
  return (cnt > 1 ? cnt : 1) - 1;
}

__device__ __forceinline__ int scfsi_of(int a, int b, int c) {
  const bool e01 = a == b, e12 = b == c;
  return e01 ? (e12 ? 2 : 1) : (e12 ? 3 : 0);
}

__device__ __forceinline__ int sf_bits(int s) {
  return s == 2 ? 6 : (s == 0 ? 18 : 12);
}

// copy n16 16-byte chunks from global to shared, the warp's lanes in turn
__device__ __forceinline__ void stage16(double* dst, const double* src,
                                        int n16, int lane) {
  const int4* s = reinterpret_cast<const int4*>(src);
  int4* d = reinterpret_cast<int4*>(dst);
  for (int i = lane; i < n16; i += 32) d[i] = __ldg(s + i);
}

__global__ void __launch_bounds__(kWarps * 32)
    mp2_allocate_kernel(int pass, const double* __restrict__ S, int F, int C,
                        long long n_frames, int sblimit, int bound, int joint,
                        const double* __restrict__ need_db,
                        const int* __restrict__ budgets,
                        const int* __restrict__ itab,
                        const double* __restrict__ snr_tab,
                        double* __restrict__ peaks, uint8_t* __restrict__ alloc,
                        uint8_t* __restrict__ scfsi,
                        uint8_t* __restrict__ sfidx,
                        uint16_t* __restrict__ codes) {
  extern __shared__ double smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long gid = (long long)blockIdx.x * kWarps + warp;
  const bool live_frame = gid < n_frames;
  const long long b = gid / F;
  const int f = (int)(gid - b * F);
  if (pass == 1) {
    if (!live_frame) return;
    for (int c = 0; c < C; ++c) {
      const double* col = S + (((b * C + c) * F + f) * kRows) * 32 + lane;
      double m = fabs(col[0]);
#pragma unroll 4
      for (int r = 1; r < kRows; ++r) {
        const double v = fabs(col[r * 32]);
        m = v > m ? v : m;
      }
      peaks[((b * F + f) * C + c) * 32 + lane] = m;
    }
    return;
  }
  // class tables, once a CTA
  int* tab = reinterpret_cast<int*>(smem);
  double* snr = smem + (kItab + 1) / 2;
  double* sw = snr + 32 * kClasses + warp * C * kRows * 32;  // this frame's S
  for (int i = threadIdx.x; i < kItab; i += kWarps * 32) tab[i] = itab[i];
  for (int i = threadIdx.x; i < 32 * kClasses; i += kWarps * 32)
    snr[i] = snr_tab[i];
  if (live_frame)
    for (int c = 0; c < C; ++c)
      stage16(sw + c * kRows * 32, S + ((b * C + c) * F + f) * kRows * 32,
              kRows * 32 / 2, lane);
  __syncthreads();
  if (!live_frame) return;

  const int sb = lane;
  const bool live = sb < sblimit;
  const bool shared_sb = joint && sb >= bound;     // a joint subband
  int sfi[2][3], sc[2], fc[2];
  double nd[2];
  for (int c = 0; c < C; ++c) {
    const double* col = sw + c * kRows * 32 + sb;
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      double m = fabs(col[(12 * p) * 32]);
      for (int r = 1; r < 12; ++r) {
        const double v = fabs(col[(12 * p + r) * 32]);
        m = v > m ? v : m;
      }
      sfi[c][p] = sf_index(m);
    }
    sc[c] = scfsi_of(sfi[c][0], sfi[c][1], sfi[c][2]);
    fc[c] = 2 + sf_bits(sc[c]);
    nd[c] = need_db[((b * F + f) * C + c) * 32 + sb];
  }
  int sfj[3] = {0, 0, 0};
  if (shared_sb) {
    // the mid signal's scalefactors; channel 0's slot pays both channels'
    // side info and needs the louder channel
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      double m = 0.0;
      for (int r = 0; r < 12; ++r) {
        const int o = (12 * p + r) * 32 + sb;
        const double v =
            fabs(__dmul_rn(__dadd_rn(sw[o], sw[kRows * 32 + o]), 0.5));
        m = (r == 0 || v > m) ? v : m;
      }
      sfj[p] = sf_index(m);
    }
    fc[0] = 4 + sf_bits(sc[0]) + sf_bits(sc[1]);
    nd[0] = nd[1] > nd[0] ? nd[1] : nd[0];
  }
  const int ncls = live ? tab[kNclsOff + sb] : 0;
  const int* bits = tab + kBitsOff + sb * (kClasses + 1);
  const double* snr_sb = snr + sb * kClasses;
  int al[2] = {0, 0};
  int spent = 0;
  const int budget = budgets[f];
  for (;;) {
    double g_best = -__longlong_as_double(0x7FF0000000000000LL);  // -inf
    int i_best = 0x7FFFFFFF;
    int cost[2] = {0, 0};
    for (int c = 0; c < C; ++c) {
      const int a = al[c];
      if (!live || a + 1 >= ncls || (c == 1 && shared_sb)) continue;
      cost[c] = bits[a + 1] - bits[a] + (a == 0 ? fc[c] : 0);
      const double gain = __dsub_rn(nd[c], snr_sb[a < ncls - 1 ? a : ncls - 1]);
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
    spent += __shfl_sync(kFull, cost[c_best], owner);
    if (sb == owner) al[c_best] += 1;
  }

  // quantisation and the outputs, every byte of this frame's rows
  const long long fc_base = (b * F + f) * C;
  for (int c = 0; c < C; ++c) {
    const int n = live ? tab[sb * kClasses + al[c]] : 0;
    const double nf = (double)n;
    const bool mid = shared_sb && c == 0;
    const double* col = sw + c * kRows * 32 + sb;
    uint16_t* out = codes + (fc_base + c) * kRows * 32 + sb;
    for (int r = 0; r < kRows; ++r) {
      uint16_t code = 0;
      if (n > 0) {
        const int p = r / 12;
        const double x = mid ? __dmul_rn(__dadd_rn(col[r * 32],
                                                   col[kRows * 32 + r * 32]),
                                         0.5)
                             : col[r * 32];
        const double sf = kMp2Sf[mid ? sfj[p] : sfi[c][p]];
        double t = __dmul_rn(__ddiv_rn(x, sf), nf);
        t = __dsub_rn(__dadd_rn(t, nf), 1.0);
        t = __dadd_rn(__ddiv_rn(t, 2.0), 0.5);
        double q = floor(t);
        q = q > 0.0 ? q : 0.0;
        q = q < nf - 1.0 ? q : nf - 1.0;
        code = (uint16_t)q;
      }
      out[r * 32] = code;
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

}  // namespace

extern "C" int mp2_allocate(int pass, const void* S, int B, int F, int C,
                            int sblimit, int bound, int joint,
                            const void* need_db, const void* budgets,
                            const void* itab, const void* snr, void* peaks,
                            void* alloc, void* scfsi, void* sfidx,
                            void* codes, void* stream) {
  if (B < 1 || F < 1 || C < 1 || C > 2 || sblimit < 1 || sblimit > 32 ||
      bound < 0 || bound > sblimit || (pass != 1 && pass != 2))
    return (int)cudaErrorInvalidValue;
  // a frame's rows of S are staged with 16-byte loads
  if ((reinterpret_cast<uintptr_t>(S) & 15) != 0)
    return (int)cudaErrorMisalignedAddress;
  const long long n_frames = (long long)B * F;
  const long long blocks = (n_frames + kWarps - 1) / kWarps;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  size_t smem = 0;
  if (pass == 2) {
    smem = (size_t)((kItab + 1) / 2 + 32 * kClasses +
                    kWarps * C * kRows * 32) * sizeof(double);
    cudaError_t e = cudaFuncSetAttribute(
        mp2_allocate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  mp2_allocate_kernel<<<(unsigned)blocks, kWarps * 32, smem,
                        (cudaStream_t)stream>>>(
      pass, (const double*)S, F, C, n_frames, sblimit, bound, joint,
      (const double*)need_db, (const int*)budgets, (const int*)itab,
      (const double*)snr, (double*)peaks, (uint8_t*)alloc, (uint8_t*)scfsi,
      (uint8_t*)sfidx, (uint16_t*)codes);
  return (int)cudaGetLastError();
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
