// HCA decode transform kernel for Hopper (sm_90a): B3.
//
// Replaces (TPU Pallas kernel of the JAX package):
//   B3 pycricodecs_tpu/ops/pallas_kernels.py transform_fused_pallas
//      (body _make_transform_kernel), fed by hca_kernels._fused_transform
// Plain PyTorch twin: pycricodecs_tpu_torch/ops/hca_kernels.py
// (decode_transform_plain = reconstruct_spectra, imdct_butterflies,
// window_overlap_add, quantize_pcm16), byte-equal by test.
//
// Computes, per stream and subframe: dequantise (SCALING[sf] * RANGE[res]
// * qc), the v3 PNS noise add (spec + SCALE_CONVERSION[sci] * spec[src]
// where the mask is set, + 0.0 elsewhere, as the JAX fused path adds its
// noise term everywhere), HFR from the static source-band map (its source
// is the noise-filled value), intensity stereo on channel pairs, the 7
// add/sub + 7 twiddle stage DCT-IV, windowed overlap-add with the previous
// subframe, PCM16 quantise and channel interleave, writing i16
// [B, F, 8, 128, C].
//
// What bounds it on this card: per output sample it reads 2 bytes of qc
// (plus the per-frame sf/res bytes, and 3 map bytes with PNS) and writes 2
// bytes of PCM against ~35 f32 operations (28 of them the DCT-IV), so the
// bytes bound it: 0.078 ms at the HCA bank chunk at 3.35 TB/s.
//
// Design (B4's, csrc/hca_imdct.cu): rows are (stream b, unit), a unit
// being a discrete channel or an intensity primary with its secondary, over
// the stream's T = F * 8 subframes, so the overlap-add's carry crosses
// frame boundaries inside a stream and never crosses streams. A CTA takes
// 31 output subframes t0..t0+30 of one row plus the subframe before them
// as a halo: lane l owns subframe t0 - 1 + l (1/31 of the DCT work again,
// so CTAs run in any order). It has one warp per unit channel of the
// stream's widest unit (two where the stream has an intensity pair). The
// CTA first copies its qc rows (and with PNS its map rows) into the upper
// bytes of a padded shared tile row per subframe and unit channel, and the
// sf/res/intensity rows of the <= 5 frames it touches, with 16-byte
// cp.async, one wait. Then each warp stages half the subframes (or all),
// lanes over bands (4 consecutive bands a lane), in the twin's order:
// dequantise; PNS (the source is the raw dequantised band); HFR (the
// source is the noise-filled band); the zero band; intensity (the
// secondary from the primary's final value at the same band, so the same
// lane). The table lookups are issued before the row's first barrier. A
// step whose sources are other lanes' bands writes its inputs to the tile
// row, __syncwarp, gathers, __syncwarp: no lane writes a value another lane
// may still read. The final spectra land as float4s in the tile rows. Then
// warp w takes unit channel w, lanes over subframes: the DCT-IV from the
// row in registers (dct4_row, the generated straight-line schedule of
// hca_dct4.inc, no shared-memory stage network and no barrier), the carry
// (DCT values 0..63) handed to the next lane through the lane's own tile
// row, the overlap-add in the twin's order and __float2int_rz(wave *
// 32768) clamped, the PCM parked in the row's upper half. Last, the warps
// store the 31 subframes in turn: a unit that is all C channels (mono, or
// the pair (0, 1) of a stereo stream) writes whole contiguous rows with 8-
// or 16-byte stores, an adjacent even-aligned pair one 32-bit word per
// band, any other unit 16-bit values. Every float op is one rounded IEEE
// multiply, add or subtract, in the twin's order (the _rn intrinsics are
// never contracted; the build also passes -fmad=false).
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "hca_tables.inc"  // generated by _build.py from ops/hca_tables.py
#include "hca_dct4.inc"    // generated by _build.py: dct4_row

#define HCA_MAX_CH 16

namespace {

constexpr int kOut = 31;             // subframes a CTA writes
constexpr int kStride = 132;         // floats per tile row without PNS
constexpr int kStridePns = 164;      // with PNS: room for the maps
constexpr int kFrames = 5;           // frames 32 subframes can touch
constexpr int kFrameBytes = 272;     // sf 128, res 128, intensity 8, pad

struct TransformCfg {
  int F, C, T, tiles, units, nch_max, stride;
  int base_band, total_band;
  int apply_hfr, hfr_groups, zero_band;
  int unit_c0[HCA_MAX_CH];
  int unit_c1[HCA_MAX_CH];       // the unit's secondary, or -1
  int hfr[128];                  // is << 16 | group << 8 | src, per band
};

struct NoiseMaps {
  const uint8_t* src;   // [B, F, C, 8, 128] source band, or null: no PNS
  const uint8_t* sci;   // scale conversion index
  const bool* mask;
};

// 16 bytes (cp.async where both ends are 16-byte aligned, else bytes)
__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       bool aligned) {
  if (aligned) {
    __pipeline_memcpy_async(dst, src, 16);
  } else {
    uint8_t* d = static_cast<uint8_t*>(dst);
    const uint8_t* s = static_cast<const uint8_t*>(src);
#pragma unroll
    for (int i = 0; i < 16; ++i) d[i] = __ldg(s + i);
  }
}

__device__ __forceinline__ bool al16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ uint32_t pcm16(float wave) {
  int v = __float2int_rz(__fmul_rn(wave, 32768.0f));
  return (uint32_t)(uint16_t)(int16_t)min(max(v, -32768), 32767);
}

__global__ void __launch_bounds__(64)
hca_transform_kernel(const int16_t* __restrict__ qc,
                     const uint8_t* __restrict__ sf,
                     const uint8_t* __restrict__ res,
                     const uint8_t* __restrict__ inten, NoiseMaps nz,
                     TransformCfg cfg, int16_t* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31;
  const int w = tid >> 5, nw = blockDim.x >> 5;  // warps: 1, or 2 if pairs
  const int tile_i = blockIdx.x % cfg.tiles;
  const int ub = blockIdx.x / cfg.tiles;
  const int unit = ub % cfg.units;
  const int b = ub / cfg.units;
  const int C = cfg.C, F = cfg.F, T = cfg.T, stride = cfg.stride;
  const int c0 = cfg.unit_c0[unit], c1 = cfg.unit_c1[unit];
  const int nch = c1 >= 0 ? 2 : 1;
  const bool pns = nz.src != nullptr;
  const int t0 = tile_i * kOut;
  // tile row r of channel slot ch: subframe t0 - 1 + r
  float* tiles = smem;
  uint8_t* frames = reinterpret_cast<uint8_t*>(
      smem + cfg.nch_max * 32 * stride);
  const int raw_off = stride * 4 - 256;  // qc bytes at the row's top
  const int f_first = max(t0 - 1, 0) >> 3;
  const int f_last = min(t0 + kOut - 1, T - 1) >> 3;

  // -- 1. copies: qc (and map) rows, frame rows; one wait ------------------
  const bool a_qc = al16(qc), a_fr = al16(sf) && al16(res);
  const bool a_nz = pns && al16(nz.src) && al16(nz.sci) && al16(nz.mask);
  for (int ch = 0; ch < nch; ++ch) {
    const int c = ch ? c1 : c0;
    float* tile = tiles + ch * 32 * stride;
    for (int i = tid; i < 32 * 16; i += 32 * nw) {
      const int r = i >> 4, j = i & 15;
      const int t = t0 - 1 + r;
      if (t < 0 || t >= T) continue;
      const size_t row = (((size_t)b * F + (t >> 3)) * C + c) * 8 + (t & 7);
      copy16(reinterpret_cast<uint8_t*>(tile + r * stride) + raw_off + 16 * j,
             qc + row * 128 + 8 * j, a_qc);
    }
    if (pns) {
      for (int i = tid; i < 32 * 24; i += 32 * nw) {
        const int r = i / 24, j = i - r * 24;
        const int t = t0 - 1 + r;
        if (t < 0 || t >= T) continue;
        const size_t row = (((size_t)b * F + (t >> 3)) * C + c) * 8 + (t & 7);
        const int m = j >> 3, k = j & 7;
        const uint8_t* src = m == 0   ? nz.src
                             : m == 1 ? nz.sci
                                      : (const uint8_t*)nz.mask;
        uint8_t* dst = reinterpret_cast<uint8_t*>(tile + r * stride);
        copy16(dst + 128 * m + 16 * k, src + row * 128 + 16 * k, a_nz);
      }
    }
    for (int i = tid; i < (f_last - f_first + 1) * 17; i += 32 * nw) {
      const int fs = i / 17, j = i - fs * 17;
      const size_t fc = ((size_t)b * F + f_first + fs) * C + c;
      uint8_t* d = frames + (fs * 2 + ch) * kFrameBytes;
      if (j < 16) {
        const uint8_t* s = (j < 8 ? sf : res) + fc * 128 + 16 * (j & 7);
        copy16(d + 128 * (j >> 3) + 16 * (j & 7), s, a_fr);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) d[256 + e] = __ldg(inten + fc * 8 + e);
      }
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  // -- 2. spectra, lanes over bands (k = 4 * lane + e); warp w stages the
  // rows [32 w / nw, 32 (w + 1) / nw), both unit channels of each ---------
  int hsrc[4], hgrp[4];
  bool his[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int h = cfg.hfr[4 * lane + e];
    hsrc[e] = h & 0xFF;
    hgrp[e] = (h >> 8) & 0xFF;
    his[e] = (h >> 16) != 0;
  }
  float gain[2][4], hsc[4];
  int cur_f = -1;
  for (int r = w * 32 / nw; r < (w + 1) * 32 / nw; ++r) {
    const int t = t0 - 1 + r;
    float* row[2] = {tiles + r * stride, tiles + (32 + r) * stride};
    if (t < 0 || t >= T) {  // no staged bytes: zeros
#pragma unroll
      for (int ch = 0; ch < 2; ++ch)
        if (ch < nch)
          reinterpret_cast<float4*>(row[ch])[lane] =
              make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      continue;
    }
    const int f = t >> 3;
    const uint8_t* fr = frames + (f - f_first) * 2 * kFrameBytes;
    if (f != cur_f) {  // per-frame factors of this lane's bands
      cur_f = f;
#pragma unroll
      for (int ch = 0; ch < 2; ++ch) {
        if (ch < nch) {
          const uint8_t* p = fr + ch * kFrameBytes;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            gain[ch][e] = __fmul_rn(kScalingTable[p[4 * lane + e]],
                                    kRangeTable[p[128 + 4 * lane + e]]);
        }
      }
      if (cfg.apply_hfr) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int g = fr[128 - cfg.hfr_groups + hgrp[e]];
          hsc[e] = kScaleConversionTable[max(g - (int)fr[hsrc[e]] + 63, 0)];
        }
      }
    }
    // dequantise (from the row's staged qc and maps); the table lookups of
    // the later steps are issued here, ahead of the barriers
    float v[2][4], scv[2][4];
    uint32_t msrc[2], mmask[2];
#pragma unroll
    for (int ch = 0; ch < 2; ++ch) {
      if (ch < nch) {
        const uint8_t* rb = reinterpret_cast<const uint8_t*>(row[ch]);
        const uint2 q = reinterpret_cast<const uint2*>(rb + raw_off)[lane];
        const int16_t qv[4] = {(int16_t)(q.x & 0xFFFF), (int16_t)(q.x >> 16),
                               (int16_t)(q.y & 0xFFFF), (int16_t)(q.y >> 16)};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[ch][e] = __fmul_rn(gain[ch][e], (float)qv[e]);
        if (pns) {
          const uint32_t* m = reinterpret_cast<const uint32_t*>(rb);
          msrc[ch] = m[lane];
          const uint32_t sci = m[32 + lane];
          mmask[ch] = m[64 + lane];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            scv[ch][e] = kScaleConversionTable[(sci >> (8 * e)) & 0xFF];
        }
      }
    }
    float rl = 1.0f, rr = 1.0f;
    if (nch == 2) {
      rl = kIntensityRatioTable[fr[kFrameBytes + 256 + (t & 7)]];
      rr = __fsub_rn(2.0f, rl);
    }
    __syncwarp();  // every lane holds its staged bytes: the row is free
    if (pns) {     // + SC[sci] * raw[src] where masked, + 0.0 elsewhere
#pragma unroll
      for (int ch = 0; ch < 2; ++ch)
        if (ch < nch)
          reinterpret_cast<float4*>(row[ch])[lane] =
              make_float4(v[ch][0], v[ch][1], v[ch][2], v[ch][3]);
      __syncwarp();
#pragma unroll
      for (int ch = 0; ch < 2; ++ch) {
        if (ch < nch) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int src = (msrc[ch] >> (8 * e)) & 0xFF;
            float term = 0.0f;
            if ((mmask[ch] >> (8 * e)) & 0xFF)
              term = __fmul_rn(scv[ch][e], row[ch][src]);
            v[ch][e] = __fadd_rn(v[ch][e], term);
          }
        }
      }
      __syncwarp();
    }
    if (cfg.apply_hfr) {  // the primary: HFR from the noise-filled bands
      reinterpret_cast<float4*>(row[0])[lane] =
          make_float4(v[0][0], v[0][1], v[0][2], v[0][3]);
      __syncwarp();
      float h[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) h[e] = row[0][hsrc[e]];
      __syncwarp();
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (his[e]) v[0][e] = __fmul_rn(hsc[e], h[e]);
        if (4 * lane + e == cfg.zero_band) v[0][e] = 0.0f;
      }
    }
    if (nch == 2) {  // intensity: the secondary from the primary
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = 4 * lane + e;
        if (k >= cfg.base_band && k < cfg.total_band) {
          v[1][e] = __fmul_rn(v[0][e], rr);
          v[0][e] = __fmul_rn(v[0][e], rl);
        }
      }
    }
#pragma unroll
    for (int ch = 0; ch < 2; ++ch)
      if (ch < nch)
        reinterpret_cast<float4*>(row[ch])[lane] =
            make_float4(v[ch][0], v[ch][1], v[ch][2], v[ch][3]);
  }
  __syncthreads();

  // -- 3. warp w, unit channel w, lanes over subframes: DCT-IV, carry,
  // overlap-add ------------------------------------------------------------
  const bool none = t0 - 1 + lane < 0;  // a zero carry before the stream
  for (int ch = w; ch < nch; ch += nw) {
    float* tile = tiles + ch * 32 * stride;
    float* myrow = tile + lane * stride;
    float y[128];
    dct4_row(myrow, y);
    float4* h = reinterpret_cast<float4*>(myrow);
#pragma unroll
    for (int m = 0; m < 16; ++m)
      h[m] = none ? make_float4(0.0f, 0.0f, 0.0f, 0.0f)
                  : make_float4(y[4 * m], y[4 * m + 1], y[4 * m + 2],
                                y[4 * m + 3]);
    __syncwarp();
    // wave[63-p] and wave[64+p] both take dct[127-p] and prev[p]; the PCM
    // (halfword k) goes to bytes 256.. of this lane's row, which no other
    // lane reads
    const float4* pv = reinterpret_cast<const float4*>(
        tile + (lane > 0 ? lane - 1 : 0) * stride);
    uint4* pcm = reinterpret_cast<uint4*>(
        reinterpret_cast<uint8_t*>(myrow) + 256);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      uint32_t lo[8], hi[8];
#pragma unroll
      for (int mm = 0; mm < 2; ++mm) {
        const float4 p4 = pv[2 * i + mm];
        const float pr[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = 8 * i + 4 * mm + e;
          const float d = y[127 - p];
          lo[4 * mm + e] = pcm16(__fadd_rn(
              __fmul_rn(kImdctWindow[63 - p], d),
              __fmul_rn(kImdctWindow[64 + p], pr[e])));
          hi[4 * mm + e] = pcm16(__fsub_rn(
              __fmul_rn(kImdctWindow[64 + p], d),
              __fmul_rn(kImdctWindow[63 - p], pr[e])));
        }
      }
      // lo[n] is wave[63 - 8i - n], hi[n] is wave[64 + 8i + n]
      pcm[7 - i] = make_uint4(lo[7] | lo[6] << 16, lo[5] | lo[4] << 16,
                              lo[3] | lo[2] << 16, lo[1] | lo[0] << 16);
      pcm[8 + i] = make_uint4(hi[0] | hi[1] << 16, hi[2] | hi[3] << 16,
                              hi[4] | hi[5] << 16, hi[6] | hi[7] << 16);
    }
  }
  __syncthreads();

  // -- 4. store subframes t0..t0+30 (tile rows 1..31), warps in turn -------
  const bool whole = nch == C && (nch == 1 || c0 == 0);
  const bool pair32 = nch == 2 && c1 == c0 + 1 && (c0 & 1) == 0 &&
                      (C & 1) == 0;
  for (int r = 1 + w; r < 32; r += nw) {
    const int t = t0 - 1 + r;
    if (t >= T) break;
    int16_t* orow = out + ((size_t)b * T + t) * 128 * C;
    const uint2 a = reinterpret_cast<const uint2*>(
        reinterpret_cast<const uint8_t*>(tiles + r * stride) + 256)[lane];
    uint2 a1 = make_uint2(0u, 0u);
    if (nch == 2)
      a1 = reinterpret_cast<const uint2*>(reinterpret_cast<const uint8_t*>(
          tiles + (32 + r) * stride) + 256)[lane];
    // (c0, c1) words of bands 4 lane .. 4 lane + 3
    const uint32_t w[4] = {__byte_perm(a.x, a1.x, 0x5410),
                           __byte_perm(a.x, a1.x, 0x7632),
                           __byte_perm(a.y, a1.y, 0x5410),
                           __byte_perm(a.y, a1.y, 0x7632)};
    if (whole && nch == 2) {
      reinterpret_cast<uint4*>(orow)[lane] =
          make_uint4(w[0], w[1], w[2], w[3]);
    } else if (whole) {
      reinterpret_cast<uint2*>(orow)[lane] = a;
    } else if (pair32) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        *reinterpret_cast<uint32_t*>(orow + (4 * lane + e) * C + c0) = w[e];
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        orow[(4 * lane + e) * C + c0] = (int16_t)(w[e] & 0xFFFF);
        if (nch == 2) orow[(4 * lane + e) * C + c1] = (int16_t)(w[e] >> 16);
      }
    }
  }
}

}  // namespace

extern "C" int hca_transform(const void* qc, const void* sf, const void* res,
                             const void* inten, const void* noise_src,
                             const void* noise_sci, const void* noise_mask,
                             int B, int F, int C,
                             int base_band, int total_band, int apply_hfr,
                             int hfr_groups, int zero_band,
                             const int32_t* partner, const int32_t* hfr_is,
                             const int32_t* hfr_src, const int32_t* hfr_group,
                             void* out, void* stream) {
  if (C < 1 || C > HCA_MAX_CH || B < 1 || F < 1)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(out) & 15) != 0)
    return (int)cudaErrorMisalignedAddress;
  TransformCfg cfg;
  cfg.F = F;
  cfg.C = C;
  cfg.T = F * 8;
  cfg.tiles = (cfg.T + kOut - 1) / kOut;
  cfg.base_band = base_band;
  cfg.total_band = total_band;
  cfg.apply_hfr = apply_hfr;
  cfg.hfr_groups = hfr_groups;
  cfg.zero_band = zero_band;
  int secondary[HCA_MAX_CH] = {0};
  for (int c = 0; c < C; ++c) {
    if (partner[c] >= C || partner[c] == c) return (int)cudaErrorInvalidValue;
    if (partner[c] >= 0) secondary[partner[c]] = 1;
  }
  cfg.units = 0;
  cfg.nch_max = 1;
  for (int c = 0; c < C; ++c) {
    if (secondary[c]) continue;
    cfg.unit_c0[cfg.units] = c;
    cfg.unit_c1[cfg.units] = partner[c];
    if (partner[c] >= 0) cfg.nch_max = 2;
    ++cfg.units;
  }
  for (int k = 0; k < 128; ++k)
    cfg.hfr[k] = (hfr_is[k] ? 1 << 16 : 0) | (hfr_group[k] & 0xFF) << 8 |
                 (hfr_src[k] & 0xFF);
  NoiseMaps nz;
  nz.src = (const uint8_t*)noise_src;
  nz.sci = (const uint8_t*)noise_sci;
  nz.mask = (const bool*)noise_mask;
  if ((nz.src == nullptr) != (nz.sci == nullptr) ||
      (nz.src == nullptr) != (nz.mask == nullptr))
    return (int)cudaErrorInvalidValue;
  cfg.stride = nz.src ? kStridePns : kStride;
  const size_t smem = (size_t)cfg.nch_max * 32 * cfg.stride * sizeof(float) +
                      (size_t)kFrames * 2 * kFrameBytes;
  const long long blocks = (long long)B * cfg.units * cfg.tiles;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  hca_transform_kernel<<<(unsigned)blocks, 32 * cfg.nch_max, smem,
                         (cudaStream_t)stream>>>(
      (const int16_t*)qc, (const uint8_t*)sf, (const uint8_t*)res,
      (const uint8_t*)inten, nz, cfg, (int16_t*)out);
  return (int)cudaGetLastError();
}
