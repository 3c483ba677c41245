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
// 3/5/9-level codes split by division; a shared field goes to both
// channels). A read of n > 0 bits that crosses the frame end returns 0 and
// sets err (the host raises there); a zero-width read never flags; a frame
// whose header is not a Layer II header of this channel count, or whose size
// exceeds the row, is all zero with err set. Outputs, every byte written:
// codes u16 [N, C, 36, 32], levels i32 [N, C, 32], sfidx u8 [N, C, 3, 32],
// err bool [N].
//
// What bounds it on this card: the bytes bound it in principle. A frame
// of the AHX bank brings ~0.6 KB in and writes 2.3 KB of codes a channel
// plus 0.2 KB of levels and scalefactors (0.15 GB for its 49,152 frames:
// 0.0463 ms at 3.35 TB/s). The frame is not one serial chain of reads:
// each field's width depends only on an earlier section (the allocation
// widths on the header, the scfsi widths on the allocation, the
// scalefactor widths on scfsi, the sample layout on the allocation, the
// same for all 12 granules), so every field's position is a prefix sum.
// On "NVIDIA H100 80GB HBM3, 700.00 W" it ran 0.0827-0.0842 ms a launch
// back to back (55 % of the bytes bound; tools/time_mdct_mp2unpack.py); a
// single call through its wrapper also waits for the host to enqueue it
// (PERF.md). What is left is each
// warp's dependent path: the frame's copy from device memory, then four
// scans of 5 shuffles, each behind a shared-memory read, then 12 granules
// of reads and stores, at up to 64 warps an SM (40 registers for C = 1,
// 7,040 bytes of shared memory a 4-warp CTA).
//
// Design: one warp per frame, lane = subband. The warp copies the frame's
// bytes (from the 16-byte boundary below its start, up to the largest
// Layer II frame) into shared memory with coalesced 16-byte cp.async copies,
// byte loads for a chunk past the end of the input, and turns the words
// big-endian in place, so a read of n <= 16 bits at any bit is two shared
// loads and a funnel shift. The header comes from the staged copy. Each of
// the four sections is one exclusive warp scan of the per-lane field widths
// (for C = 2 a lane holds its (sb, 0) and (sb, 1) slots, in the twin's
// sb-major slot order); each lane then reads its own fields at their
// positions, all 12 granules of its sample fields at base + g x
// granule_bits + its offset. Grouped codes divide by 3, 5 or 9 with an
// exact multiply-high (every code < 2^16). The frame's err is a ballot of
// its lanes' flags. The outputs are written by all 32 lanes, coalesced: a
// row of 32 subbands is one 64-byte store of u16, zeros included, and an
// invalid frame is written as zeros, so the wrapper allocates with
// torch.empty.
#include <cstdint>
#include <cuda_runtime.h>

#include "hca_tables.inc"  // generated by _build.py (kMp2* tables)

namespace {

constexpr int kMaxCh = 2;
constexpr int kWarps = 4;            // frames (warps) per CTA
constexpr int kMaxFrame = 1729;      // largest Layer II frame: 384 kbps, 32 kHz
constexpr int kStageBytes = 1760;    // 15 + kMaxFrame rounded to 16, + 16
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
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

struct Frame {
  const uint32_t* w;  // staged big-endian words
  int base;           // bit of the frame's first byte in w
  int nbits;          // frame size * 8
  bool err;

  // MSB-first read of n (0..16) bits at frame bit p: past the frame end,
  // 0 and err; a zero-width read is 0 and never flags. Branch-free: a read
  // that is not taken loads the frame's first words.
  __device__ __forceinline__ uint32_t get(int p, int n) {
    const bool over = p + n > nbits;
    err |= n > 0 && over;
    const bool ok = n > 0 && !over;
    const int q = ok ? base + p : 0;
    const uint32_t hi = w[q >> 5], lo = w[(q >> 5) + 1];
    const uint32_t v = __funnelshift_l(lo, hi, q & 31) >> (32 - max(n, 1));
    return ok ? v : 0u;
  }
};

// v / n for n in {3, 5, 9} and v < 2^16 (exact: checked over every v)
__device__ __forceinline__ uint32_t div_small(uint32_t v, int n) {
  const uint32_t m = n == 3 ? 0xAAABu : (n == 5 ? 0xCCCDu : 0xE38Fu);
  const int s = n == 3 ? 17 : (n == 5 ? 18 : 19);
  return (v * m) >> s;
}

template <int C>
__global__ void __launch_bounds__(32 * kWarps)
mp2_unpack_kernel(const uint8_t* __restrict__ frames, int N, int W,
                  uint16_t* __restrict__ codes, int32_t* __restrict__ levels,
                  uint8_t* __restrict__ sfidx, bool* __restrict__ err) {
  __shared__ __align__(16) uint32_t stage_all[kWarps][kStageBytes / 4];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int f = blockIdx.x * kWarps + warp;
  if (f >= N) return;  // warp-uniform: no block barrier
  uint32_t* stage = stage_all[warp];

  // stage the frame: 16-byte chunks from the boundary below its start
  const long long total = (long long)N * W;
  const long long start = (long long)f * W;
  const long long a = start & ~15LL;
  const int off = (int)(start - a);
  const int len = min(W, kMaxFrame);
  const int chunks = (off + len + 15) >> 4;
  for (int c = lane; c < chunks; c += 32) {
    const long long g = a + 16LL * c;
    if (g + 16 <= total) {
      cp_async16(stage + 4 * c, frames + g);
    } else {  // the input's last chunk: bytes, zeros past its end
      uint32_t v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        uint32_t x = 0;
#pragma unroll
        for (int b = 3; b >= 0; --b) {
          const long long i = g + 4 * k + b;
          x = (x << 8) | (i < total ? (uint32_t)frames[i] : 0u);
        }
        v[k] = x;
      }
      reinterpret_cast<uint4*>(stage)[c] = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();
  for (int i = lane; i < 4 * chunks; i += 32)
    stage[i] = __byte_perm(stage[i], 0, 0x0123);  // big-endian words
  __syncwarp();

  // the header: 32 bits at the frame's first byte (zeros past W)
  uint32_t hw = __funnelshift_l(stage[(8 * off >> 5) + 1],
                                stage[8 * off >> 5], (8 * off) & 31);
  if (W < 4) hw &= ~(0xFFFFFFFFu >> (8 * W));
  const int version = (hw >> 19) & 3, bri = (hw >> 12) & 0xF;
  const int sri = (hw >> 10) & 3, mode = (hw >> 6) & 3;
  const int nch = mode == 3 ? 1 : 2;
  bool valid = ((hw >> 21) & 0x7FF) == 0x7FF && ((hw >> 17) & 3) == 2 &&
               (version == 2 || version == 3) && bri != 0 && bri != 15 &&
               sri != 3 && nch == C;
  const int v1 = version == 3;
  int table = 4, sblimit = 0, bound = 0, size = 0;
  if (valid) {
    table = v1 ? kMp2TableSelect[(sri * 2 + (nch == 1)) * 16 + bri] : 4;
    sblimit = kMp2Sblimit[table];
    bound = mode == 1 ? min((int)(((hw >> 4) & 3) + 1) * 4, sblimit)
                      : sblimit;
    size = 144 * kMp2Bitrate[v1 * 16 + bri] * 1000 / kMp2Rate[v1 * 4 + sri] +
           (int)((hw >> 9) & 1);
    valid = size <= W;
  }

  const int sb = lane;
  int32_t* lv_f = levels + (size_t)f * C * 32;
  uint8_t* sf_f = sfidx + (size_t)f * C * 3 * 32;
  uint16_t* q_f = codes + (size_t)f * C * 36 * 32;
  if (!valid) {
    for (int ch = 0; ch < C; ++ch) {
      lv_f[ch * 32 + sb] = 0;
#pragma unroll
      for (int k = 0; k < 3; ++k) sf_f[(ch * 3 + k) * 32 + sb] = 0;
#pragma unroll 12
      for (int r = 0; r < 36; ++r) q_f[(ch * 36 + r) * 32 + sb] = 0;
    }
    if (lane == 0) err[f] = true;
    return;
  }
  Frame fr{stage, 8 * off, 8 * size, false};
  int cur = ((hw >> 16) & 1) ? 32 : 48;
  int sum;
  const bool two = C == 2;
  const bool own1 = two && sb < bound;  // channel 1 has its own fields

  // section 1: the bit allocation, lane = subband, slots (sb, 0), (sb, 1)
  const int row = table * 32 + sb;
  const int nb = sb < sblimit ? kMp2Nbal[row] : 0;
  const int wa1 = own1 ? nb : 0;
  int p = cur + warp_scan(nb + wa1, lane, &sum);
  cur += sum;
  const int i0 = (int)fr.get(p, nb);
  const int i1 = own1 ? (int)fr.get(p + nb, wa1) : i0;
  const int n0 = kMp2Classes[row * 16 + i0];
  const int n1 = two ? kMp2Classes[row * 16 + i1] : 0;

  // section 2: scfsi, 2 bits per allocated slot
  const int ws0 = n0 ? 2 : 0, ws1 = n1 ? 2 : 0;
  p = cur + warp_scan(ws0 + ws1, lane, &sum);
  cur += sum;
  const int s0 = (int)fr.get(p, ws0);
  const int s1 = (int)fr.get(p + ws0, ws1);

  // section 3: the scalefactors, 3, 2, 1 or 2 six-bit fields by scfsi
  const int cnt0 = n0 ? (s0 == 0 ? 3 : (s0 == 2 ? 1 : 2)) : 0;
  const int cnt1 = n1 ? (s1 == 0 ? 3 : (s1 == 2 ? 1 : 2)) : 0;
  p = cur + warp_scan(6 * (cnt0 + cnt1), lane, &sum);
  cur += sum;
  int sfv[C][3];
#pragma unroll
  for (int ch = 0; ch < C; ++ch) {
    const int cnt = ch ? cnt1 : cnt0;
    const int s = ch ? s1 : s0;
    const int r0 = (int)fr.get(p, cnt > 0 ? 6 : 0);
    const int r1 = (int)fr.get(p + 6, cnt > 1 ? 6 : 0);
    const int r2 = (int)fr.get(p + 12, cnt > 2 ? 6 : 0);
    sfv[ch][0] = r0;
    sfv[ch][1] = (s == 0 || s == 3) ? r1 : r0;
    sfv[ch][2] = s == 0 ? r2 : (s == 2 ? r0 : r1);
    p += 6 * cnt;
  }

  // section 4: the sample fields of one granule; channel 1 reads its own
  // field only below the bound (above it, channel 0's field is shared)
  const int gb0 = n0 ? kMp2Gbits[row * 16 + i0] : 0;
  const int ub0 = n0 ? kMp2Ubits[row * 16 + i0] : 0;
  const int gb1 = own1 && n1 ? kMp2Gbits[row * 16 + i1] : 0;
  const int ub1 = own1 && n1 ? kMp2Ubits[row * 16 + i1] : 0;
  const int wq0 = gb0 + 3 * ub0, wq1 = gb1 + 3 * ub1;
  int granule;
  const int intra = warp_scan(wq0 + wq1, lane, &granule);

  for (int ch = 0; ch < C; ++ch) {
    lv_f[ch * 32 + sb] = ch ? n1 : n0;
#pragma unroll
    for (int k = 0; k < 3; ++k)
      sf_f[(ch * 3 + k) * 32 + sb] = (uint8_t)sfv[ch][k];
  }
  // per granule a slot reads one grouped field (gb bits) or three
  // ungrouped ones (ub bits each): a first read of gb + ub bits (one of the
  // two is 0), then two of ub bits (0 bits when grouped)
#pragma unroll 2
  for (int g = 0; g < 12; ++g) {
    uint32_t val[C][3];
#pragma unroll
    for (int ch = 0; ch < C; ++ch) {
      const int n = ch ? n1 : n0;
      const int gb = ch ? gb1 : gb0, ub = ch ? ub1 : ub0;
      const int at = cur + g * granule + intra + (ch ? wq0 : 0);
      const uint32_t r0 = fr.get(at, gb + ub);
      const uint32_t r1 = fr.get(at + ub, ub);
      const uint32_t r2 = fr.get(at + 2 * ub, ub);
      const uint32_t q1 = div_small(r0, n);
      const uint32_t q2 = div_small(q1, n);
      val[ch][0] = gb ? r0 - q1 * n : r0;
      val[ch][1] = gb ? q1 - q2 * n : r1;
      val[ch][2] = gb ? q2 : r2;
    }
#pragma unroll
    for (int ch = 0; ch < C; ++ch) {
      // channel 1 above the bound takes channel 0's shared field
      const bool from1 = ch == 1 && own1;
#pragma unroll
      for (int k = 0; k < 3; ++k)
        q_f[(ch * 36 + 3 * g + k) * 32 + sb] =
            (uint16_t)(from1 ? val[C - 1][k] : val[0][k]);
    }
  }
  const unsigned bad = __ballot_sync(kFull, fr.err);
  if (lane == 0) err[f] = bad != 0;
}

}  // namespace

extern "C" int mp2_unpack(const void* frames, int N, int W, int C,
                          void* codes, void* levels, void* sfidx, void* err,
                          void* stream) {
  if (N < 1 || W < 1 || C < 1 || C > kMaxCh) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(frames) & 15) != 0)
    return (int)cudaErrorMisalignedAddress;
  const int blocks = (N + kWarps - 1) / kWarps;
  auto kernel = C == 1 ? mp2_unpack_kernel<1> : mp2_unpack_kernel<2>;
  kernel<<<blocks, 32 * kWarps, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)frames, N, W, (uint16_t*)codes, (int32_t*)levels,
      (uint8_t*)sfidx, (bool*)err);
  return (int)cudaGetLastError();
}
