// CRILAYLA decompress (C1) and compress (C2) kernels for Hopper (sm_90a).
//
// Replace (the JAX package's native host lane; no Pallas kernel):
//   C1 pycricodecs_tpu/native/cricore.cpp:130 cri_layla_decompress
//   C2 pycricodecs_tpu/native/cricore.cpp:174 cri_layla_compress
// Plain versions: pycricodecs_tpu_torch/models/crilayla.py
// (_decompress_py, _compress_py), byte-equal by test; the JAX native's
// bytes by the recorded hashes.
//
// Format: a member is {"CRILAYLA", u32 decompress_size, u32 compressed_size}
// + a bit stream read backwards from its last byte + the 256 raw bytes that
// head the output. The host checks the magic and the sizes and passes, per
// member, the payload's offset, the two sizes and the output's offset.
//
// C1: one warp per member, all members of a call in one launch. Every token
// depends on the bit position the one before left, so a member is one serial
// chain: all 32 lanes run the bit reader alike (the same byte, broadcast;
// no divergence), lane 0 writes a literal, and a back-reference of length L
// at distance D = offset + 3 is copied by the lanes in pieces of at most
// min(D, 32) bytes (a piece no longer than D reads only bytes written
// before it, so an overlapping copy repeats its period as the serial copy
// does), with a __syncwarp between pieces. Failure cases, as the native's
// -1: a bit read below the payload's first byte, and a back-reference whose
// source is at or past the output's end. status[m] = 1 marks them; the host
// raises the JAX package's ValueError("Malformed CRILAYLA stream").
// steps[m] counts the tokens decoded (the serial chain's length).
//
// C2: one CTA per member. The greedy matcher is serial over the position
// n (from the end down to 0x100), but each step's search is parallel: the
// CTA's threads split the candidates i in [n + 3, min(n + 3 + 0x2000, len)),
// each loads its candidates' first bytes at once and extends a match
// backwards (k up to kmax + 1 = n - 0xFF) only where the first byte agrees.
// A block-wide max of the key (k << 13) | (0x1FFF - (i - n - 3)) picks the
// longest match and, on a tie, the earliest candidate: the reference's
// brute-force choice, which the native's hash chains also make. Thread 0
// then emits the token's bits into the member's work buffer backwards, with
// the native's flush order, length escapes (6, 13, 44 and the 255-runs),
// trailer (two zero bytes, then zeros up to (cap - m) % 4 == 0, with cap
// congruent to len mod 4) and refusals: status 1 for 0x100 bytes or fewer,
// status 2 when the stream outgrows its work buffer (never for a buffer of
// this size; kept as the native's `return 0`). start[m] is the stream's
// first byte in the work buffer; the host adds the header and the prefix.
//
// What bounds them on this card: the serial chains. A member's tokens (C1)
// and greedy steps (C2) run one after another; the bytes (each input read
// once, each output written once) are a few MB, microseconds at 3.35 TB/s.
// A C2 step is a load of each thread's candidate bytes, the match
// extensions, a warp shuffle max and two __syncthreads; a C1 token is a few
// dependent shifts and a byte load. Speed comes later: this design is the
// simple one that is right.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kDecompressWarps = 4;          // members (warps) per CTA
constexpr int kCompressThreads = 1024;       // one CTA per member
constexpr int kWindow = 0x2000;              // candidates a step
constexpr int kPerThread = kWindow / kCompressThreads;

__global__ void __launch_bounds__(32 * kDecompressWarps)
crilayla_decompress_kernel(const uint8_t* __restrict__ src,
                           const int64_t* __restrict__ meta, int M,
                           uint8_t* out, int32_t* status, int64_t* steps) {
  const int member = (int)((blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (member >= M) return;
  // meta row: payload offset, compressed size, decompress size, out offset
  const int64_t* row = meta + 4 * (int64_t)member;
  const uint8_t* p = src + row[0];
  const int64_t cs = row[1];
  const int64_t ds = row[2];
  uint8_t* o = out + row[3];
  for (int i = lane; i < 256; i += 32) o[i] = p[cs + i];

  int64_t pos = cs - 1;  // next byte of the stream, read backwards
  uint32_t acc = 0;
  uint32_t count = 0;
  bool under = false;
  auto get = [&](uint32_t n) -> uint32_t {
    while (count < n) {
      uint32_t b = 0;  // zeros past the start end a 255-run; flagged
      if (pos < 0) {
        under = true;
      } else {
        b = p[pos--];
      }
      acc = (acc << 8) | b;
      count += 8;
    }
    const uint32_t v = (acc >> (count - n)) & ((1u << n) - 1u);
    count -= n;
    return v;
  };

  const int64_t base = 256;
  const int64_t end = ds + 256;
  int64_t w = end - 1;  // written backwards
  int64_t tokens = 0;
  bool bad = false;
  while (w >= base) {
    if (under) break;
    ++tokens;
    if (get(1) == 0) {
      const uint32_t b = get(8);
      if (lane == 0) o[w] = (uint8_t)b;
      --w;
      continue;
    }
    const int64_t offset = get(13);
    int64_t len = get(2);
    if (len == 3) {
      len += get(3);
      if (len == 10) {
        len += get(5);
        if (len == 41) {
          uint32_t b;
          do {
            b = get(8);
            len += b;
          } while (b == 255);
        }
      }
    }
    int64_t r = w + offset + 3;
    if (r >= end) {
      bad = true;
      break;
    }
    const int64_t dist = offset + 3;
    int64_t left = len + 3;
    while (left > 0 && w >= base) {
      int64_t piece = left < dist ? left : dist;
      if (piece > 32) piece = 32;
      if (piece > w - base + 1) piece = w - base + 1;
      __syncwarp();  // the bytes this piece reads are visible to every lane
      if (lane < piece) o[w - lane] = o[r - lane];
      w -= piece;
      r -= piece;
      left -= piece;
    }
  }
  if (lane == 0) {
    status[member] = (bad || under) ? 1 : 0;
    steps[member] = tokens;
  }
}

__device__ __forceinline__ unsigned long long umax64(unsigned long long a,
                                                     unsigned long long b) {
  return a > b ? a : b;
}

__global__ void __launch_bounds__(kCompressThreads)
crilayla_compress_kernel(const uint8_t* __restrict__ src,
                         const int64_t* __restrict__ meta, uint8_t* work,
                         int64_t* start, int32_t* status, int64_t* steps) {
  __shared__ unsigned long long red[kCompressThreads / 32];
  __shared__ unsigned long long chosen;
  const int member = blockIdx.x;
  const int tid = threadIdx.x;
  // meta row: source offset, source length, work buffer offset
  const int64_t* row = meta + 3 * (int64_t)member;
  const uint8_t* s = src + row[0];
  const int64_t len = row[1];
  if (len < 0x101) {
    if (tid == 0) {
      status[member] = 1;
      start[member] = 0;
      steps[member] = 0;
    }
    return;
  }
  // congruent to len mod 4: it sets the stream's padding
  const int64_t cap = len + ((len / 2 + 0x403) & ~(int64_t)3);
  uint8_t* wk = work + row[2];

  // thread 0's bit writer
  int64_t m = cap - 1;
  unsigned long long d = 0;
  uint32_t T = 0;
  bool over = false;
  auto flush = [&]() -> bool {
    while (T >= 8) {
      if (m < 0) return false;
      wk[m--] = (uint8_t)((d >> (T - 8)) & 0xFF);
      T -= 8;
      d &= (T >= 64) ? ~0ull : ((1ull << T) - 1);
    }
    return true;
  };

  int64_t n = len - 1;
  int64_t nsteps = 0;
  while (n >= 0x100) {
    const int64_t j = (n + 3 + kWindow < len) ? n + 3 + kWindow : len;
    const int64_t kmax = n - 0x100;
    const uint8_t c0 = s[n];
    uint8_t first[kPerThread];
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const int64_t i = n + 3 + tid + (int64_t)u * kCompressThreads;
      first[u] = i < j ? s[i] : (uint8_t)~c0;
    }
    unsigned long long best = 0;
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      if (first[u] != c0) continue;
      const int64_t i = n + 3 + tid + (int64_t)u * kCompressThreads;
      int64_t k = 1;
      while (k <= kmax && s[n - k] == s[i - k]) ++k;
      best = umax64(best, ((unsigned long long)k << 13)
                              | (unsigned long long)(0x1FFF - (i - n - 3)));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      best = umax64(best, __shfl_xor_sync(kFull, best, o));
    if ((tid & 31) == 0) red[tid >> 5] = best;
    __syncthreads();
    if (tid < 32) {
      best = red[tid];  // kCompressThreads / 32 == 32 partials
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        best = umax64(best, __shfl_xor_sync(kFull, best, o));
      if (tid == 0) chosen = best;
    }
    __syncthreads();
    best = chosen;
    const int64_t blen = (int64_t)(best >> 13);
    if (tid == 0 && !over) {
      if (blen < 3) {
        d = (d << 9) | s[n];
        T += 9;
      } else {
        d = (((d << 1) | 1) << 13) | (0x1FFF - (best & 0x1FFF));
        T += 14;
        int64_t p = blen;
        if (p < 6) {
          d = (d << 2) | (unsigned long long)(p - 3);
          T += 2;
        } else if (p < 13) {
          d = (((d << 2) | 3) << 3) | (unsigned long long)(p - 6);
          T += 5;
        } else if (p < 44) {
          d = (((d << 5) | 0x1F) << 5) | (unsigned long long)(p - 13);
          T += 10;
        } else {
          d = (d << 10) | 0x3FF;
          T += 10;
          p -= 44;
          for (;;) {
            if (!flush()) {
              over = true;
              break;
            }
            if (p < 255) break;
            d = (d << 8) | 0xFF;
            T += 8;
            p -= 0xFF;
          }
          if (!over) {
            d = (d << 8) | (unsigned long long)p;
            T += 8;
          }
        }
      }
      if (!over && !flush()) over = true;
    }
    n -= blen < 3 ? 1 : blen;
    ++nsteps;
  }
  if (tid != 0) return;
  if (!over && T != 0) {
    if (m < 0) {
      over = true;
    } else {
      wk[m--] = (uint8_t)(d << (8 - T));
    }
  }
  if (!over && m < 2) over = true;
  if (!over) {
    wk[m--] = 0;
    wk[m] = 0;
    while (((cap - m) & 3) != 0) {
      if (m < 1) {
        over = true;
        break;
      }
      wk[--m] = 0;
    }
  }
  status[member] = over ? 2 : 0;
  start[member] = over ? 0 : m;
  steps[member] = nsteps;
}

}  // namespace

extern "C" int crilayla_decompress(const void* src, const void* meta, int M,
                                   void* out, void* status, void* steps,
                                   void* stream) {
  if (M < 1) return (int)cudaErrorInvalidValue;
  const int threads = 32 * kDecompressWarps;
  const int blocks = (M + kDecompressWarps - 1) / kDecompressWarps;
  crilayla_decompress_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)src, (const int64_t*)meta, M, (uint8_t*)out,
      (int32_t*)status, (int64_t*)steps);
  return (int)cudaGetLastError();
}

extern "C" int crilayla_compress(const void* src, const void* meta, int M,
                                 void* work, void* start, void* status,
                                 void* steps, void* stream) {
  if (M < 1) return (int)cudaErrorInvalidValue;
  crilayla_compress_kernel<<<M, kCompressThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)src, (const int64_t*)meta, (uint8_t*)work,
      (int64_t*)start, (int32_t*)status, (int64_t*)steps);
  return (int)cudaGetLastError();
}
