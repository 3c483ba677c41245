// MPEG Layer II analysis filterbank kernel for Hopper (sm_90a): K1
// mp2_analysis, with the encode's peaks taken from its results.
//
// Not a TPU Pallas kernel: in the JAX package the encoder's analysis is
// numpy on the host (pycricodecs_tpu/ops/mp2_kernels.py analyze_fast, the
// f64 lane of models/ahx.py encode_mp2), ending in a BLAS matmul Y @ M.T
// whose summation order is the BLAS build's, and the part peaks of
// models/ahx.py:170-192 follow it. The port fixes one order and holds the
// encode to that lane's bytes (no fixture's scalefactor pick, quantisation
// floor or allocation test flips; the spectra differ by at most 1.4e-17 on
// the AHX bank). Plain PyTorch twins: pycricodecs_tpu_torch/ops/
// mp2_kernels.py (analyze_plain) and ops/mp2_encode_device.py
// (part_peaks_plain, frame_peaks_plain), bit-equal by test.
//
// Computes, per (stream, channel) row of PCM16 and per 32-sample block t, in
// float64 with one rounding per op (the _rn intrinsics are never
// contracted; the build passes -fmad=false):
//   x = pcm / 32768 (exact), 0 before the row start;
//   Y[t][q] = 0.0 + C[q] * x(t - h, m), then += C[q + 64r] * x(t - h - 2r, m)
//     for r = 1..7, with q = 32h + m, x(j, m) = sample 32j + 31 - m and C
//     the analysis window D / 32 (kMp2Cwin);
//   S[t][k] = Y[t][0] * M[k][0], then += Y[t][q] * M[k][q] for q = 1..63;
// and from S the part peaks max |S| over each 12-row part and the frame
// peaks max |S| over each 36-row frame (a max is exact in any order).
// Input PCM i16 [B * C, T * 32], T a multiple of 36; outputs S f64
// [B * C, T, 32], part peaks f64 [B, F, C, 3, 32], frame peaks f64
// [B, F, C, 32] (F = T / 36).
//
// What bounds it on this card: operations. A block of 32 samples takes
// 1,024 f64 operations of window fold and 4,064 of matrixing against 64
// bytes in and 256 out, and with FMA off each multiply and add is its own
// DMUL or DADD. What holds it (the ablation in PERF.md): the matrixing,
// which alone runs at about 60-64 % of its f64 issue rate; taking a step's
// Y loads (3 of its 4 shared-memory loads) away moves it by 3-7 %, so the
// loads are not the cause, which is not known. Four lane layouts (3 x 4,
// 6 x 2, 6 x 4 and 9 x 4 sums a lane) did no better or, with fewer warps
// an SM, worse.
//
// Design: a persistent grid (as many CTAs as fit, three an SM) stages the
// transposed matrix Mt[q][k] once (kMp2AmT, a coalesced copy) and walks
// tiles of 72 blocks of one row: two whole frames, so a CTA owns its
// frames' peaks. The PCM of a tile and of the 15 blocks before it (the
// window's reach) arrives by 16-byte cp.async copies issued while the
// tile before it computes (zeros outside the row); it is widened to
// doubles, each lane writing its four 16-byte pieces in a rotated order so
// that a quarter-warp's stores hit eight distinct bank groups. Warp w then
// owns rows 12w .. 12w + 11 (one part) alone, meeting the other warps only
// at the tile's two CTA barriers; for each half h of q (q = 32h .. 32h + 31):
// - fold: lane m walks the part's rows of each parity; outputs t and t + 2
//   share 7 of their 8 samples, so it loads 13 samples a parity (a warp's
//   lanes read 32 neighbouring samples) for 6 outputs, its 8 window taps
//   in registers; Y goes to the warp's q-major buffer Yq[q - 32h][t - 12w]
//   (rows of 14 doubles);
// - matrixing: lane (rg = lane / 16, kg = lane % 16) keeps the 6 x 2 sums
//   of rows 12w + 6rg + i and subbands 2kg, 2kg + 1: a q step loads its 6
//   Y values as three 16-byte words (2 distinct addresses a load, one
//   wavefront) and its 2 Mt values as one (two wavefronts) for 24 f64
//   instructions.
// Epilogue: S from the registers, 16 bytes a store; a lane's max |S| over
// its 6 rows, one xor shuffle across rg, the part peak; the frame peak is
// the max of its three parts, through shared memory, taken after the next
// tile's first barrier.
#include <cstdint>
#include <cuda_runtime.h>

#include "hca_tables.inc"  // generated by _build.py (kMp2AmT, kMp2Cwin)

namespace {

constexpr int kFrameRows = 36;
constexpr int kTile = 2 * kFrameRows;  // blocks (rows of S) a tile
constexpr int kHalo = 15;              // blocks before a row its window reads
constexpr int kStaged = kTile + kHalo;
constexpr int kChunks = kStaged * 4;   // 16-byte PCM chunks a tile
constexpr int kWarps = 6;              // a warp per 12-row part
constexpr int kThreads = kWarps * 32;
constexpr int kYStride = 14;           // doubles a q row of a warp's Yq
constexpr int kYWarp = 32 * kYStride;  // doubles of a warp's Yq
constexpr int kYOff = kStaged * 32;
constexpr int kMtOff = kYOff + kWarps * kYWarp;
constexpr int kPkOff = kMtOff + 64 * 32;
constexpr int kRawOff = kPkOff + kWarps * 32;  // the raw PCM, int16
constexpr size_t kSmemBytes =
    (size_t)kRawOff * sizeof(double) + kChunks * 16;  // 67,264 bytes
constexpr unsigned kFull = 0xFFFFFFFFu;

// an int16 sample (sign-extended) / 32768: a multiply by 2^-15, exact
__device__ __forceinline__ double pcm_x(int v) {
  return __dmul_rn((double)v, 0x1p-15);
}

// the tile's PCM chunks into raw: 16-byte cp.async copies, zeros outside
// the row (a chunk lies wholly in or out of it: rows start on 64-byte
// boundaries of a 16-byte aligned base)
__device__ __forceinline__ void fetch_pcm(int4* raw, const int16_t* src,
                                          int t0, int T, int tid) {
  for (int i = tid; i < kChunks; i += kThreads) {
    const int j = t0 - kHalo + (i >> 2);
    if (j >= 0 && j < T) {
      const unsigned d = (unsigned)__cvta_generic_to_shared(raw + i);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                   "l"(src + (long long)j * 32 + (i & 3) * 8));
    } else {
      raw[i] = make_int4(0, 0, 0, 0);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Yq[lane][t - 12 warp] = Y[t][32H + lane] of the warp's rows 12 warp ..
// 12 warp + 11
template <int H>
__device__ __forceinline__ void fold(const double* xs, double* Yq, int warp,
                                     int lane) {
  const int q = 32 * H + lane;
  double w[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) w[r] = kMp2Cwin[q + 64 * r];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    // rows base + 2i, i < 6; x(t - H - 2r) sits at staged row
    // t + 15 - H - 2r = base + 1 - H + 2(i + 7 - r): xw[k] holds staged
    // row base + 1 - H + 2k
    const int base = 12 * warp + p;
    const double* col = xs + (base + 1 - H) * 32 + 31 - lane;
    double xw[13];
#pragma unroll
    for (int k = 0; k < 13; ++k) xw[k] = col[k * 64];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      double y = 0.0;
#pragma unroll
      for (int r = 0; r < 8; ++r)
        y = __dadd_rn(y, __dmul_rn(w[r], xw[i + 7 - r]));
      Yq[lane * kYStride + p + 2 * i] = y;
    }
  }
}

// acc[i][j] over q = 32H .. 32H + 31, rows 12 warp + 6 rg + i, subbands
// 2 kg + j
template <int H>
__device__ __forceinline__ void matrix(const double* Yq, const double* Mt,
                                       int rg, int kg, double (&acc)[6][2]) {
  const double2* yr = reinterpret_cast<const double2*>(Yq + 6 * rg);
  const double2* mc = reinterpret_cast<const double2*>(Mt + 32 * 32 * H) + kg;
#pragma unroll
  for (int qq = 0; qq < 32; ++qq) {
    double y[6];
#pragma unroll
    for (int v = 0; v < 3; ++v) {
      const double2 t = yr[qq * kYStride / 2 + v];
      y[2 * v] = t.x;
      y[2 * v + 1] = t.y;
    }
    const double2 mv = mc[qq * 16];
    const double m[2] = {mv.x, mv.y};
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        acc[i][j] = (H == 0 && qq == 0)
                        ? __dmul_rn(y[i], m[j])
                        : __dadd_rn(acc[i][j], __dmul_rn(y[i], m[j]));
  }
}

// the frame peaks of tile (row, tt): the max of each frame's three part
// peaks in pk, threads 0..63
__device__ __forceinline__ void frame_peaks_of(const double* pk, long long row,
                                               int tt, int C, int F,
                                               double* frame_peaks, int tid) {
  if (tid >= 64) return;
  const long long b = row / C;
  const int c = (int)(row - b * C);
  const int f = 2 * tt + (tid >> 5), k = tid & 31;
  const double* p3 = pk + 3 * (tid >> 5) * 32 + k;
  if (f < F)
    frame_peaks[((b * F + f) * C + c) * 32 + k] =
        fmax(fmax(p3[0], p3[32]), p3[64]);
}

__global__ void __launch_bounds__(kThreads, 3)
    mp2_analysis_kernel(const int16_t* __restrict__ pcm, int C, int F,
                        long long tiles, double* __restrict__ S,
                        double* __restrict__ part_peaks,
                        double* __restrict__ frame_peaks) {
  extern __shared__ double smem[];
  double* xs = smem;            // [kStaged][32]: blocks t0 - 15 ..
  double* Yq = smem + kYOff + (threadIdx.x >> 5) * kYWarp;  // the warp's
  double* Mt = smem + kMtOff;   // [64][32]
  double* pk = smem + kPkOff;   // [kWarps][32]: the tile's part peaks
  int4* raw = reinterpret_cast<int4*>(smem + kRawOff);  // [kChunks]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = lane >> 4, kg = lane & 15;
  const int T = F * kFrameRows;
  const int row_tiles = (F + 1) / 2;
  for (int i = tid; i < 64 * 32; i += kThreads) Mt[i] = kMp2AmT[i];
  long long tile = blockIdx.x;
  if (tile < tiles) {
    const long long row = tile / row_tiles;
    fetch_pcm(raw, pcm + row * (long long)T * 32,
              (int)(tile - row * row_tiles) * kTile, T, tid);
  }
  long long prev_row = -1;
  int prev_tt = 0;
  for (; tile < tiles; tile += gridDim.x) {
    const long long row = tile / row_tiles;
    const int tt = (int)(tile - row * row_tiles);
    const int t0 = tt * kTile;
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();   // raw has arrived; xs and pk are free
    if (prev_row >= 0)
      frame_peaks_of(pk, prev_row, prev_tt, C, F, frame_peaks, tid);
    // at store e, lane l writes its piece (e + l / 2) % 4
    for (int i = tid; i < kChunks; i += kThreads) {
      const int4 v = raw[i];
      double2* d = reinterpret_cast<double2*>(xs + i * 8);
      const int rot = (i >> 1) & 3;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = (e + rot) & 3;
        const int wd = c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
        d[c] = make_double2(pcm_x((int)(int16_t)(wd & 0xFFFF)),
                            pcm_x(wd >> 16));
      }
    }
    __syncthreads();   // xs is staged; raw is free
    const long long next = tile + gridDim.x;
    if (next < tiles) {
      const long long nrow = next / row_tiles;
      fetch_pcm(raw, pcm + nrow * (long long)T * 32,
                (int)(next - nrow * row_tiles) * kTile, T, tid);
    }
    double acc[6][2];
    fold<0>(xs, Yq, warp, lane);
    __syncwarp();
    matrix<0>(Yq, Mt, rg, kg, acc);
    __syncwarp();
    fold<1>(xs, Yq, warp, lane);
    __syncwarp();
    matrix<1>(Yq, Mt, rg, kg, acc);

    const long long b = row / C;
    const int c = (int)(row - b * C);
    const int fr = warp / 3, part = warp - 3 * fr;
    const int f = 2 * tt + fr;
    double pm[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      pm[j] = fabs(acc[0][j]);
#pragma unroll
      for (int i = 1; i < 6; ++i) pm[j] = fmax(pm[j], fabs(acc[i][j]));
      pm[j] = fmax(pm[j], __shfl_xor_sync(kFull, pm[j], 16));
    }
    if (f < F) {
      double2* dst = reinterpret_cast<double2*>(
          S + (row * T + t0 + 12 * warp + 6 * rg) * 32) + kg;
#pragma unroll
      for (int i = 0; i < 6; ++i)
        dst[i * 16] = make_double2(acc[i][0], acc[i][1]);
      if (rg == 0)
        reinterpret_cast<double2*>(
            part_peaks + (((b * F + f) * C + c) * 3 + part) * 32)[kg] =
            make_double2(pm[0], pm[1]);
    }
    if (rg == 0)
      reinterpret_cast<double2*>(pk + warp * 32)[kg] =
          make_double2(pm[0], pm[1]);
    prev_row = row;
    prev_tt = tt;
  }
  __syncthreads();
  if (prev_row >= 0)
    frame_peaks_of(pk, prev_row, prev_tt, C, F, frame_peaks, tid);
}

}  // namespace

extern "C" int mp2_analysis(const void* pcm, int B, int C, int T, void* S,
                            void* part_peaks, void* frame_peaks,
                            void* stream) {
  if (B < 1 || C < 1 || T < 1 || T % kFrameRows)
    return (int)cudaErrorInvalidValue;
  // PCM is staged in 16-byte chunks
  if ((reinterpret_cast<uintptr_t>(pcm) & 15) != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaError_t e = cudaFuncSetAttribute(
      mp2_analysis_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, mp2_analysis_kernel, kThreads, kSmemBytes)) !=
      cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int F = T / kFrameRows;
  const long long tiles = (long long)B * C * ((F + 1) / 2);
  const long long grid = tiles < (long long)sms * per_sm
                             ? tiles : (long long)sms * per_sm;
  mp2_analysis_kernel<<<(unsigned)grid, kThreads, kSmemBytes,
                        (cudaStream_t)stream>>>(
      (const int16_t*)pcm, C, F, tiles, (double*)S, (double*)part_peaks,
      (double*)frame_peaks);
  return (int)cudaGetLastError();
}
