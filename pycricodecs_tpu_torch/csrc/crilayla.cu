// CRILAYLA decompress (C1) and compress (C2) kernels for Hopper (sm_90a).
//
// Replace (the JAX package's native host lane; no Pallas kernel):
//   C1 pycricodecs_tpu/native/cricore.cpp:130 cri_layla_decompress
//   C2 pycricodecs_tpu/native/cricore.cpp:174 cri_layla_compress
// Plain versions: pycricodecs_tpu_torch/models/crilayla.py
// (_decompress_py, _compress_py), byte-equal by test; the JAX native's
// bytes by the recorded hashes. Numpy models of every stage below:
// tests/test_torch_crilayla.py (change them with the kernels).
//
// Format: a member is {"CRILAYLA", u32 decompress_size, u32 compressed_size}
// + a bit stream read backwards from its last byte + the 256 raw bytes that
// head the output. The host checks the magic and the sizes and passes, per
// member, the payload's offset, the two sizes and the output's offset.
//
// C2 (compress) is three stages, eight launches, one wrapper call.
// 1. Search, parallel over positions x offsets. The greedy matcher's longest
//    match at a position n depends on the data alone, never on the parse:
//    candidates i = n + delta, delta in [3, 0x2002] (and n + delta < len),
//    a match's length k counts the equal pairs s[n - j] == s[n + delta - j]
//    down to byte 0x100, the longest wins and a tie goes to the smallest
//    delta. So best(n) is the max over delta of the key
//    (L(n, delta) << 13) | (0x1FFF - (delta - 3)) with the run length
//    L(n, delta) = s[n] == s[n + delta] ? L(n - 1, delta) + 1 : 0 and
//    L(0xFF, delta) = 0: no per-candidate extension loop, and the same work
//    on any data. A CTA takes a tile of kTile positions with the kHalo bytes
//    above it in shared memory; each of its 256 threads owns 32 deltas
//    (delta - 3 = warp * 1024 + 32 j + lane, so a warp's loads for one j
//    are 32 neighbouring bytes) and walks n up through the tile carrying
//    its keys; each n's max is a warp REDUX and a shared-memory atomicMax.
//    The run into a tile, L(n0 - 1, delta), may come from a run that began
//    many tiles below: c2_summary writes each tile's trailing run per delta
//    (kTile where the whole tile is equal), c2_carry combines them up each
//    member (all-equal adds kTile, anything else restarts), and no compare
//    reads past a tile. A 32-bit key holds L < 2^19; a tile whose carry
//    plus its length could reach that runs the 64-bit path (exact lengths,
//    a two-REDUX max), so a length is never cut.
// 2. Walk, serial only where the parse is. c2_spec walks every tile from
//    its top (n <- n - (L >= 3 ? L : 1)) in shared memory and marks the
//    positions it visits; c2_repair then follows the true parse from each
//    member's top: where it lands on a position the tile's walk visited,
//    the two parses agree from there on (greedy parses that meet stay
//    together), so it records that point and jumps to the tile's exit; only
//    where they differ does it walk (the tile staged in shared memory). A
//    position is a token where the true parse visits it: above the
//    meeting point the repair's marks, at and below it the tile walk's.
// 3. Emit, parallel over tokens. Each token's bit width (9 a literal;
//    16, 19, 24 for lengths 3-5, 6-12, 13-43; 24 + 8 (floor((L - 44) / 255)
//    + 1) from 44) is summed per tile (c2_count), the tiles' sums are
//    scanned from each member's top (c2_offsets, which also writes start,
//    status and steps), and c2_place scans a tile's tokens and ORs each
//    code into the zeroed work buffer. The native's flush writes the bit
//    string MSB first from the buffer's end backwards, which is the same as
//    a little-endian bit array in which stream bit b is bit 8 cap - 1 - b:
//    a token's code is a plain integer at bit 8 cap - b0 - width. The
//    trailer is zeros: the partial byte (d << (8 - T)), two zero bytes and
//    zeros until (cap - m) % 4 == 0, with cap = len + ((len / 2 + 0x403)
//    & ~3). Status 1 for 0x100 bytes or fewer; status 2 where the native
//    would `return 0` (over capacity; never for a buffer of this size).
//
// C1 (decompress) is two stages, 6 + 2 + ceil(log2 size) launches, one
// wrapper call.
// 1. Parse. Every token starts at the bit where the one before ended, and
//    one thread's parse is a chain of dependent decode steps run in
//    order, slow per token. So the stream is cut into chunks of kChunkBits
//    bits, and c1_spec parses every chunk at once from its first bit (a
//    thread a chunk; words fed through a two-word window, a token's width
//    selected from one funnel shift of it), recording its tokens, a bitmap
//    of their starts and its exit bit. That bit is rarely a token start,
//    but a parse that lands on a true token start agrees with the true
//    parse from there on. c1_repair follows the true parse from bit 0 (a
//    CTA a member, the chunk's words and bitmap staged in shared memory):
//    where it lands on a chunk parse's start it records that token and
//    jumps to the chunk's exit; elsewhere it parses tokens itself (on the
//    10 s ADX stream, ~20 a chunk, about 1 % of the tokens). c1_count,
//    c1_offsets and c1_place take each chunk's true tokens (its repair
//    tokens, then its parse's from the meeting token), scan their counts
//    and output bytes, and write one record a token that starts inside the
//    output (its top output position, counted from the LZ region so that
//    it fits 32 bits for any u32 decompress size; a literal's byte or a
//    copy's distance D = offset + 3). Status 1, with the native's semantics: a
//    back-reference whose source is at or past the output's end among
//    those tokens, or an underrun (the token that fills the output, or the
//    stream's last, reads past the stream: zeros there end a 255-run).
// 2. Materialise, parallel over output bytes: each byte finds its token by
//    a binary search of the records, a literal writes its byte, and a copy
//    byte at p points at p + k D, the first source above its own token (a
//    self-overlapping copy repeats its period). Pointer jumping
//    (ptr = ptr[ptr], at most ceil(log2 size) rounds, stopped once a round
//    changes nothing) brings every pointer to a literal; the bytes are then
//    gathered.
//
// What bounds them on this card: C2's search, ~7 instructions an
// (n, delta) pair, by the instruction rate (the 32-bit keys keep it so:
// the 64-bit path alone takes 1.6 times as long at chip_smoke.py phase
// 19's compressed archive); C1's and C2's serial repairs, which run only
// where the speculative parses do not meet the true one; launch latency
// on small calls. The bytes each moves are a few MB. Card memory: C2
// about 19.5 bytes a source byte, C1 about 17 an output byte plus 31 a
// stream byte.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kTile = 4096;                  // C2: positions a tile
constexpr int kWindow = 0x2000;              // C2: deltas 3 .. 0x2002
constexpr int kHalo = kWindow + 2;           // bytes above a tile it reads
constexpr int kDataBytes = (kTile + kHalo + 15) / 16 * 16;
constexpr int kSearchThreads = 256;
constexpr int kPerThread = kWindow / kSearchThreads;   // 32 deltas
constexpr uint32_t kNarrowMax = (1u << 19) - 1;        // L a u32 key holds
constexpr int kWalkThreads = 128;
constexpr int kEmitThreads = 256;
constexpr int kEmitPer = kTile / kEmitThreads;         // 16 positions
constexpr int kSearchSmem = 8 * kTile + kDataBytes;

static_assert(kPerThread == 32, "a thread owns 32 deltas");

// ---------------------------------------------------------------- C2 ----

// A tile g: its member m, that member's source offset and length, its first
// position n0 and its number of positions. meta rows: source offset,
// length, work offset, first tile; tiles rows: member, tile index.
struct Tile {
  int m;
  int64_t off, len, n0;
  int cnt;
};

__device__ __forceinline__ Tile tile_of(const int64_t* meta,
                                        const int32_t* tiles, int g) {
  Tile t;
  t.m = tiles[2 * g];
  t.off = meta[4 * t.m];
  t.len = meta[4 * t.m + 1];
  t.n0 = 0x100 + (int64_t)tiles[2 * g + 1] * kTile;
  const int64_t left = t.len - t.n0;
  t.cnt = (int)(left < kTile ? left : kTile);
  return t;
}

// s[n0 + x] for x in [0, kTile + kHalo), zero past the member's end (those
// pairs are masked as not equal)
__device__ __forceinline__ void stage_bytes(uint8_t* buf, const uint8_t* s,
                                            const Tile& t) {
  const int64_t avail = t.len - t.n0;
  for (int x = threadIdx.x; x < kTile + kHalo; x += blockDim.x)
    buf[x] = x < avail ? s[t.n0 + x] : 0;
}

// the largest x + 32 j for which the thread's pair (n0 + x, delta) lies
// inside the member, as an int: x + 32 j < lim
__device__ __forceinline__ int pair_limit(const Tile& t, int dr0) {
  int64_t lim = t.len - t.n0 - 3 - dr0;
  if (lim < 0) lim = 0;
  if (lim > (1 << 30)) lim = 1 << 30;
  return (int)lim;
}

__device__ __forceinline__ bool edge_tile(const Tile& t) {
  return t.n0 + t.cnt - 1 + 3 + (kWindow - 1) >= t.len;
}

// Each full tile below a member's top: per delta, the run of equal pairs
// that ends at the tile's top (kTile: the whole tile is one run).
__global__ void __launch_bounds__(kSearchThreads)
c2_summary_kernel(const uint8_t* __restrict__ src,
                  const int64_t* __restrict__ meta,
                  const int32_t* __restrict__ tiles, uint32_t* run) {
  __shared__ uint8_t buf[kDataBytes];
  const int g = blockIdx.x;
  const Tile t = tile_of(meta, tiles, g);
  if (t.n0 + kTile >= t.len) return;  // the top tile feeds no carry
  stage_bytes(buf, src + t.off, t);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int dr0 = warp * 1024 + lane;
  const int lim = pair_limit(t, dr0);
  for (int j = 0; j < kPerThread; ++j) {
    const int dr = dr0 + 32 * j;
    int k = 0;
    while (k < kTile) {
      const int x = kTile - 1 - k;
      if (x + 32 * j >= lim || buf[x] != buf[x + 3 + dr]) break;
      ++k;
    }
    run[(int64_t)g * kWindow + dr] = k;
  }
}

// Per member and delta, the run into each tile: all-equal tiles add kTile,
// any other tile's trailing run restarts it. In place: run[g] becomes the
// carry into tile g.
__global__ void __launch_bounds__(256)
c2_carry_kernel(const int64_t* __restrict__ meta, uint32_t* run) {
  const int m = blockIdx.x / (kWindow / 256);
  const int dr = (blockIdx.x % (kWindow / 256)) * 256 + threadIdx.x;
  const int64_t len = meta[4 * m + 1];
  if (len < 0x101) return;
  const int64_t nt = (len - 0x100 + kTile - 1) / kTile;
  uint32_t* r = run + meta[4 * m + 3] * kWindow + dr;
  uint32_t c = 0;  // < len: a member is below 2^32 bytes
  for (int64_t t = 0; t < nt; t += 8) {
    uint32_t tr[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      tr[u] = t + u < nt - 1 ? r[(t + u) * kWindow] : 0;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (t + u < nt) {
        r[(t + u) * kWindow] = c;
        c = tr[u] == kTile ? c + kTile : tr[u];
      }
    }
  }
}

// 32-bit keys: K = L * 8192 + (0x1FFF - (delta - 3)) carried per delta
template <bool kEdge>
__device__ __forceinline__ void search_narrow(const uint8_t* buf,
                                              const uint32_t* carry, int cnt,
                                              int dr0, int lim,
                                              uint32_t* red) {
  const int lane = threadIdx.x & 31;
  const uint32_t r0 = 0x1FFFu - (uint32_t)dr0;
  uint32_t K[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j)
    K[j] = carry[j] * 8192u + (r0 - 32u * j);
  const uint8_t* q = buf + 3 + dr0;
  for (int x = 0; x < cnt; ++x) {
    const uint32_t c = buf[x];
    uint32_t mx = 0;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      bool eq = q[x + 32 * j] == c;
      if (kEdge) eq = eq && x + 32 * j < lim;
      K[j] = eq ? K[j] + 8192u : r0 - 32u * j;
      mx = max(mx, K[j]);
    }
    mx = __reduce_max_sync(kFull, mx);
    if (lane == 0) atomicMax(red + x, mx);
  }
}

// 64-bit keys from exact lengths: each thread keeps its longest run (the
// smallest delta on a tie), the warp's max is two REDUX (high word, then
// the low word among the lanes that hold the high max)
template <bool kEdge>
__device__ __forceinline__ void search_wide(const uint8_t* buf,
                                            const uint32_t* carry, int cnt,
                                            int dr0, int lim,
                                            unsigned long long* red) {
  const int lane = threadIdx.x & 31;
  const uint32_t r0 = 0x1FFFu - (uint32_t)dr0;
  uint32_t L[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) L[j] = carry[j];
  const uint8_t* q = buf + 3 + dr0;
  for (int x = 0; x < cnt; ++x) {
    const uint32_t c = buf[x];
    uint32_t bl = 0, bo = r0;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      bool eq = q[x + 32 * j] == c;
      if (kEdge) eq = eq && x + 32 * j < lim;
      L[j] = eq ? L[j] + 1 : 0;
      if (L[j] > bl) {
        bl = L[j];
        bo = r0 - 32u * j;
      }
    }
    const unsigned long long key = ((unsigned long long)bl << 13) | bo;
    const uint32_t hi = (uint32_t)(key >> 32), lo = (uint32_t)key;
    const uint32_t mh = __reduce_max_sync(kFull, hi);
    const uint32_t ml = __reduce_max_sync(kFull, hi == mh ? lo : 0u);
    if (lane == 0)
      atomicMax(red + x, ((unsigned long long)mh << 32) | ml);
  }
}

// best(n) for every position of a tile (its key; length = key >> 13)
__global__ void __launch_bounds__(kSearchThreads, 2)
c2_search_kernel(const uint8_t* __restrict__ src,
                 const int64_t* __restrict__ meta,
                 const int32_t* __restrict__ tiles,
                 const uint32_t* __restrict__ run,
                 unsigned long long* __restrict__ best) {
  extern __shared__ __align__(16) uint8_t smem[];
  unsigned long long* red64 = reinterpret_cast<unsigned long long*>(smem);
  uint32_t* red32 = reinterpret_cast<uint32_t*>(smem);
  uint8_t* buf = smem + 8 * kTile;
  const int g = blockIdx.x;
  const Tile t = tile_of(meta, tiles, g);
  stage_bytes(buf, src + t.off, t);
  for (int x = threadIdx.x; x < kTile; x += blockDim.x) red64[x] = 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int dr0 = warp * 1024 + lane;
  uint32_t carry[kPerThread];
  uint32_t cmax = 0;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    carry[j] = run[(int64_t)g * kWindow + dr0 + 32 * j];
    cmax = max(cmax, carry[j]);
  }
  // a barrier too: the staged bytes and the zeroed keys are visible after it
  const bool wide = __syncthreads_or(cmax + (uint32_t)t.cnt > kNarrowMax);
  const int lim = pair_limit(t, dr0);
  if (edge_tile(t)) {
    if (wide)
      search_wide<true>(buf, carry, t.cnt, dr0, lim, red64);
    else
      search_narrow<true>(buf, carry, t.cnt, dr0, lim, red32);
  } else {
    if (wide)
      search_wide<false>(buf, carry, t.cnt, dr0, lim, red64);
    else
      search_narrow<false>(buf, carry, t.cnt, dr0, lim, red32);
  }
  __syncthreads();
  unsigned long long* out = best + t.off + t.n0;
  for (int x = threadIdx.x; x < t.cnt; x += blockDim.x)
    out[x] = wide ? red64[x] : (unsigned long long)red32[x];
}

__device__ __forceinline__ uint32_t step_of(unsigned long long key) {
  const unsigned long long L = key >> 13;
  return L >= 3 ? (uint32_t)L : 1u;
}

// Every tile's greedy walk from its own top: flags bit 0 on the positions
// it visits, its exit (the first position below the tile it reaches), and
// no meeting point yet (conv = n0 - 1).
__global__ void __launch_bounds__(kWalkThreads)
c2_spec_kernel(const int64_t* __restrict__ meta,
               const int32_t* __restrict__ tiles,
               const unsigned long long* __restrict__ best,
               uint8_t* __restrict__ flags, int64_t* __restrict__ texit,
               int64_t* __restrict__ conv) {
  __shared__ uint32_t st[kTile];
  __shared__ uint8_t fl[kTile];
  const int g = blockIdx.x;
  const Tile t = tile_of(meta, tiles, g);
  const unsigned long long* b = best + t.off + t.n0;
  for (int x = threadIdx.x; x < kTile; x += blockDim.x) {
    fl[x] = 0;
    if (x < t.cnt) st[x] = step_of(b[x]);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int64_t p = t.cnt - 1;
    while (p >= 0) {
      fl[p] = 1;
      p -= st[p];
    }
    texit[g] = t.n0 + p;
    conv[g] = t.n0 - 1;
  }
  __syncthreads();
  uint8_t* f = flags + t.off + t.n0;
  for (int x = threadIdx.x; x < t.cnt; x += blockDim.x) f[x] = fl[x];
}

// The true parse of each member from its top: where it lands on a tile
// walk's position it records the meeting point and jumps to that walk's
// exit; elsewhere it walks the tile (staged) and marks flags bit 1.
__global__ void __launch_bounds__(kWalkThreads)
c2_repair_kernel(const int64_t* __restrict__ meta,
                 const unsigned long long* __restrict__ best,
                 uint8_t* __restrict__ flags,
                 const int64_t* __restrict__ texit,
                 int64_t* __restrict__ conv) {
  __shared__ uint32_t st[kTile];
  __shared__ uint8_t fl[kTile];
  __shared__ long long sp;
  const int m = blockIdx.x;
  const int64_t off = meta[4 * m], len = meta[4 * m + 1];
  const int64_t g0 = meta[4 * m + 3];
  if (len < 0x101) return;
  int64_t p = len - 1;  // thread 0's position
  for (;;) {
    if (threadIdx.x == 0) {
      while (p >= 0x100) {
        const int64_t g = g0 + (p - 0x100) / kTile;
        if (!(flags[off + p] & 1)) break;
        conv[g] = p;
        p = texit[g];
      }
      sp = p;
    }
    __syncthreads();
    const int64_t q = sp;
    if (q < 0x100) break;
    const int64_t ti = (q - 0x100) / kTile;
    const int64_t n0 = 0x100 + ti * kTile;
    const int cnt = (int)(len - n0 < kTile ? len - n0 : kTile);
    for (int x = threadIdx.x; x < cnt; x += blockDim.x) {
      st[x] = step_of(best[off + n0 + x]);
      fl[x] = flags[off + n0 + x];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      while (p >= n0) {
        const int x = (int)(p - n0);
        if (fl[x] & 1) {
          conv[g0 + ti] = p;
          p = texit[g0 + ti];
          break;
        }
        flags[off + p] = fl[x] | 2;
        p -= st[x];
      }
    }
    __syncthreads();
  }
}

__device__ __forceinline__ uint32_t token_bits(unsigned long long key) {
  const unsigned long long L = key >> 13;
  if (L < 3) return 9;
  if (L < 6) return 16;
  if (L < 13) return 19;
  if (L < 44) return 24;
  return 24 + 8 * (uint32_t)((L - 44) / 255 + 1);
}

// a position is a token where the true parse visits it: above the tile's
// meeting point the repair's marks (bit 1), at and below it the tile
// walk's (bit 0)
__device__ __forceinline__ bool is_token(uint8_t f, int64_t n, int64_t cv) {
  return n <= cv ? (f & 1) : (f & 2);
}

// sum over a block of 256 threads (8 warps)
__device__ __forceinline__ uint32_t block_sum(uint32_t v, uint32_t* part) {
  v = __reduce_add_sync(kFull, v);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  uint32_t s = 0;
#pragma unroll
  for (int w = 0; w < kEmitThreads / 32; ++w) s += part[w];
  return s;
}

// each tile's tokens and their bits
__global__ void __launch_bounds__(kEmitThreads)
c2_count_kernel(const int64_t* __restrict__ meta,
                const int32_t* __restrict__ tiles,
                const unsigned long long* __restrict__ best,
                const uint8_t* __restrict__ flags,
                const int64_t* __restrict__ conv, int64_t* __restrict__ tbits,
                int64_t* __restrict__ tcnt) {
  __shared__ uint32_t part[2][kEmitThreads / 32];
  const int g = blockIdx.x;
  const Tile t = tile_of(meta, tiles, g);
  const int64_t cv = conv[g];
  uint32_t bits = 0, count = 0;
  for (int i = 0; i < kEmitPer; ++i) {
    const int x = threadIdx.x * kEmitPer + i;
    if (x >= t.cnt) break;
    const int64_t n = t.n0 + x;
    if (is_token(flags[t.off + n], n, cv)) {
      bits += token_bits(best[t.off + n]);
      ++count;
    }
  }
  bits = block_sum(bits, part[0]);
  count = block_sum(count, part[1]);
  if (threadIdx.x == 0) {
    tbits[g] = bits;
    tcnt[g] = count;
  }
}

// per member (one warp): the tiles' first bits, scanned from the member's
// top tile down; start, status and steps
__global__ void __launch_bounds__(32)
c2_offsets_kernel(const int64_t* __restrict__ meta,
                  const int64_t* __restrict__ tbits,
                  const int64_t* __restrict__ tcnt,
                  int64_t* __restrict__ toff, int64_t* __restrict__ start,
                  int32_t* __restrict__ status, int64_t* __restrict__ steps) {
  const int m = blockIdx.x;
  const int lane = threadIdx.x;
  const int64_t len = meta[4 * m + 1];
  if (len < 0x101) {
    if (lane == 0) {
      status[m] = 1;
      start[m] = 0;
      steps[m] = 0;
    }
    return;
  }
  const int64_t g0 = meta[4 * m + 3];
  const int64_t nt = (len - 0x100 + kTile - 1) / kTile;
  unsigned long long total = 0, tokens = 0;
  for (int64_t top = nt - 1; top >= 0; top -= 32) {
    const int64_t ti = top - lane;  // lane 0 holds the highest tile
    const unsigned long long v = ti >= 0 ? (unsigned long long)tbits[g0 + ti]
                                         : 0ull;
    const uint32_t c = ti >= 0 ? (uint32_t)tcnt[g0 + ti] : 0u;
    unsigned long long incl = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned long long y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    if (ti >= 0) toff[g0 + ti] = (int64_t)(total + incl - v);
    total += __shfl_sync(kFull, incl, 31);
    tokens += __reduce_add_sync(kFull, c);
  }
  if (lane == 0) {
    const int64_t cap = len + ((len / 2 + 0x403) & ~(int64_t)3);
    const int64_t nb = (int64_t)((total + 7) / 8);
    const int64_t padded = (nb + 2 + 3) & ~(int64_t)3;
    const bool over = nb > cap - 3 || padded > cap;
    status[m] = over ? 2 : 0;
    start[m] = over ? 0 : cap - padded;
    steps[m] = (int64_t)tokens;
  }
}

// OR the low n (<= 32) bits of v into the little-endian bit array w at bit a
__device__ __forceinline__ void or_bits(uint32_t* w, unsigned long long a,
                                        uint32_t v, int n) {
  const unsigned long long i = a >> 5;
  const int s = (int)(a & 31);
  atomicOr(w + i, v << s);
  if (s + n > 32) atomicOr(w + i + 1, v >> (32 - s));
}

__device__ __forceinline__ void or_ones(uint32_t* w, unsigned long long a,
                                        unsigned long long n) {
  while (n > 0) {
    const int s = (int)(a & 31);
    const unsigned long long k = 32 - s < n ? 32 - s : n;
    const uint32_t mask = (k == 32 ? kFull : ((1u << k) - 1u)) << s;
    atomicOr(w + (a >> 5), mask);
    a += k;
    n -= k;
  }
}

// each token's code at its bit: the tile's first bit plus the widths of the
// tokens above it in the tile (a suffix scan: higher positions come first
// in the stream)
__global__ void __launch_bounds__(kEmitThreads)
c2_place_kernel(const uint8_t* __restrict__ src,
                const int64_t* __restrict__ meta,
                const int32_t* __restrict__ tiles,
                const unsigned long long* __restrict__ best,
                const uint8_t* __restrict__ flags,
                const int64_t* __restrict__ conv,
                const int64_t* __restrict__ toff,
                const int32_t* __restrict__ status, uint32_t* work) {
  __shared__ uint32_t part[kEmitThreads / 32];
  const int g = blockIdx.x;
  const Tile t = tile_of(meta, tiles, g);
  if (status[t.m] != 0) return;
  const int64_t cv = conv[g];
  const int x0 = threadIdx.x * kEmitPer;
  uint32_t wd[kEmitPer];
  uint32_t own = 0;
#pragma unroll
  for (int i = 0; i < kEmitPer; ++i) {
    const int64_t n = t.n0 + x0 + i;
    wd[i] = x0 + i < t.cnt && is_token(flags[t.off + n], n, cv)
                ? token_bits(best[t.off + n]) : 0u;
    own += wd[i];
  }
  // suffix scan over the block's threads (thread 255 holds the top)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t incl = own;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_down_sync(kFull, incl, o);
    if (lane + o < 32) incl += y;
  }
  if (lane == 0) part[warp] = incl;
  __syncthreads();
  uint32_t above = incl - own;
  for (int w = warp + 1; w < kEmitThreads / 32; ++w) above += part[w];
  const int64_t len = t.len;
  const int64_t cap = len + ((len / 2 + 0x403) & ~(int64_t)3);
  const unsigned long long end_bit = 8ull * (unsigned long long)(
      meta[4 * t.m + 2] + cap);
  unsigned long long b0 = (unsigned long long)toff[g] + above;
#pragma unroll
  for (int i = kEmitPer - 1; i >= 0; --i) {
    if (wd[i] == 0) continue;
    const int64_t n = t.n0 + x0 + i;
    const unsigned long long a = end_bit - b0 - wd[i];  // the code's bit 0
    const unsigned long long key = best[t.off + n];
    const uint32_t L = (uint32_t)(key >> 13);
    const uint32_t off = 0x1FFFu - (uint32_t)(key & 0x1FFF);
    if (L < 3) {
      or_bits(work, a, src[t.off + n], 9);
    } else if (L < 6) {
      or_bits(work, a, (1u << 15) | (off << 2) | (L - 3), 16);
    } else if (L < 13) {
      or_bits(work, a, (1u << 18) | (off << 5) | (3u << 3) | (L - 6), 19);
    } else if (L < 44) {
      or_bits(work, a, (1u << 23) | (off << 10) | (0x1Fu << 5) | (L - 13),
              24);
    } else {
      const uint32_t q = (L - 44) / 255, r = (L - 44) - 255 * q;
      or_bits(work, a, r, 8);
      or_ones(work, a + 8, 8ull * q);
      or_bits(work, a + 8 + 8ull * q, (1u << 23) | (off << 10) | 0x3FFu,
              24);
    }
    b0 += wd[i];
  }
}

// ---------------------------------------------------------------- C1 ----

constexpr int kChunkBits = 16384;                 // C1: stream bits a chunk
constexpr int kChunkWords = kChunkBits / 32;
constexpr int kChunkCap = kChunkBits / 9 + 2;      // tokens that start in one
constexpr int kRepairThreads = 256;

// C1's member row: payload offset, compressed size, decompress size, output
// offset, first chunk; a chunk row: member, chunk index. Per chunk, int64
// fields (kC*): its tile parse's tokens and exit bit, the true parse's
// meeting token (-1: none) and repair tokens, then the true tokens' count
// and output bytes, and their first token index and output bytes before.
enum { kCSpecN, kCExit, kCConv, kCRepN, kCCount, kCOut, kCTok, kCObase,
       kCFields };
// Per member, int64: the first bad token (a back-reference past the end),
// the tokens needed, the underrun flag.
enum { kMBad, kMNtok, kMUnder, kMFields };

// The stream's words in reading order: the bytes from the payload's last
// down to its first, read as 16-byte blocks (three in flight ahead of the
// one in use); zeros below the payload's first byte.
struct WordReader {
  uintptr_t lo;    // the payload's first byte
  uintptr_t next;  // the next block to load
  uint4 b1, b2, b3;
  uint32_t q0, q1, q2, q3;
  int qn;

  __device__ __forceinline__ uint4 load(uintptr_t a) const {
    uint4 v = make_uint4(0, 0, 0, 0);
    if (a + 16 <= lo) return v;
    v = __ldg(reinterpret_cast<const uint4*>(a));
    if (a < lo) {
      uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uintptr_t aw = a + 4 * k;
        if (aw + 4 <= lo) {
          w[k] = 0;
        } else if (aw < lo) {
          w[k] &= ~((1u << (8 * (lo - aw))) - 1u);
        }
      }
    }
    return v;
  }

  // words from the one at address a (4-byte aligned) downwards
  __device__ __forceinline__ void start(uintptr_t lo_, uintptr_t a) {
    lo = lo_;
    const uintptr_t blk = a & ~(uintptr_t)15;
    const uint4 cur = load(blk);
    b1 = load(blk - 16);
    b2 = load(blk - 32);
    b3 = load(blk - 48);
    next = blk - 64;
    q0 = cur.w;
    q1 = cur.z;
    q2 = cur.y;
    q3 = cur.x;
    qn = 4;
    for (int k = (int)((blk + 12 - a) / 4); k > 0; --k) take();
  }

  __device__ __forceinline__ void reload() {
    q0 = b1.w;
    q1 = b1.z;
    q2 = b1.y;
    q3 = b1.x;
    qn = 4;
    b1 = b2;
    b2 = b3;
    b3 = load(next);
    next -= 16;
  }

  __device__ __forceinline__ uint32_t take() {
    const uint32_t w = q0;
    q0 = q1;
    q1 = q2;
    q2 = q3;
    if (--qn == 0) reload();
    return w;
  }
};

// Where a member's stream bits sit: stream bit b (b = 0 the first bit read,
// the top bit of the payload's last byte) is bit (b + 8 sk) % 32, from the
// top, of the word at address a0 - 4 ((b + 8 sk) / 32).
struct StreamMap {
  uintptr_t lo, a0;
  int sk;
  int64_t bits;  // 8 cs

  __device__ __forceinline__ StreamMap(const uint8_t* p, int64_t cs) {
    lo = (uintptr_t)p;
    const uintptr_t top = (uintptr_t)(p + cs);
    a0 = (top - 1) & ~(uintptr_t)3;
    sk = (int)(a0 + 4 - top);
    bits = 8 * cs;
  }
  __device__ __forceinline__ uint32_t word(int64_t i) const {  // random
    const uintptr_t a = a0 - 4 * (uintptr_t)i;
    if (a + 4 <= lo) return 0;
    uint32_t v = __ldg(reinterpret_cast<const uint32_t*>(a));
    if (a < lo) v &= ~((1u << (8 * (lo - a))) - 1u);
    return v;
  }
};

// One token from the 32 bits v at its start (the top bit first): its width
// before a long length's 255-run, its length code (41: a 255-run follows;
// a u32 that wraps as the native's does), and its record's low word
// (0x80000000 | byte, or the distance).
struct Token {
  bool lit;
  int width;
  uint32_t len;
  uint32_t info;
};

__device__ __forceinline__ Token decode(uint32_t v) {
  Token k;
  k.lit = (int32_t)v >= 0;
  const uint32_t l2 = (v >> 16) & 3, l3 = (v >> 13) & 7;
  const bool e2 = l2 == 3, e3 = l3 == 7;
  k.width = k.lit ? 9 : (!e2 ? 16 : (!e3 ? 19 : 24));
  k.len = k.lit ? 0u : (!e2 ? l2 : (!e3 ? 3u + l3 : 10u + ((v >> 8) & 31)));
  k.info = k.lit ? 0x80000000u | ((v >> 23) & 0xFF)
                 : ((v >> 18) & 0x1FFF) + 3;
  return k;
}

// a record: (output bytes << 32) | info, the output bytes a u32 as the
// native's length (len + 3 wraps with it); the token's end bit beside it
__device__ __forceinline__ unsigned long long token_rec(const Token& k) {
  return ((unsigned long long)(k.lit ? 1u : k.len + 3u) << 32) | k.info;
}

// Each chunk's tile parse (a thread a chunk): tokens from the chunk's first
// bit while they start inside it, each recorded with its end bit; a bitmap
// of their starts with the tokens before each word; the exit (the first
// start past the chunk). The same walk as the true parse, from a bit that
// may not be a token start: where the true parse meets one of its starts,
// the two agree from there on.
__global__ void __launch_bounds__(128)
c1_spec_kernel(const uint8_t* __restrict__ src,
               const int64_t* __restrict__ meta,
               const int32_t* __restrict__ chunks, int C,
               unsigned long long* __restrict__ srec,
               int64_t* __restrict__ send, uint32_t* __restrict__ bitmap,
               int32_t* __restrict__ pre, int64_t* __restrict__ cv) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= C) return;
  const int m = chunks[2 * k];
  const int64_t* row = meta + 5 * (int64_t)m;
  const StreamMap sm(src + row[0], row[1]);
  const int64_t s = (int64_t)chunks[2 * k + 1] * kChunkBits;
  const int64_t e = s + kChunkBits < sm.bits ? s + kChunkBits : sm.bits;
  const int64_t g = s + 8 * sm.sk;
  WordReader rd;
  rd.start(sm.lo, sm.a0 - 4 * (uintptr_t)(g >> 5));
  uint32_t wa = rd.take(), wb = rd.take();
  int o = (int)(g & 31);
  auto consume = [&](int n) {
    o += n;
    if (o >= 32) {
      o -= 32;
      wa = wb;
      wb = rd.take();
    }
  };
  unsigned long long* rec = srec + (int64_t)k * kChunkCap;
  int64_t* ends = send + (int64_t)k * kChunkCap;
  uint32_t* bm = bitmap + (int64_t)k * kChunkWords;
  int32_t* pr = pre + (int64_t)k * kChunkWords;
  int n = 0, cw = 0, before = 0;
  uint32_t acc = 0;
  int64_t b = s;
  while (b < e) {
    const int r = (int)(b - s);
    while (cw < (r >> 5)) {
      bm[cw] = acc;
      pr[cw] = before;
      before += __popc(acc);
      acc = 0;
      ++cw;
    }
    acc |= 1u << (r & 31);
    Token t = decode(__funnelshift_l(wb, wa, o));
    consume(t.width);
    int64_t width = t.width;
    if (!t.lit && t.len == 41) {
      uint32_t x;
      do {
        x = __funnelshift_l(wb, wa, o) >> 24;
        consume(8);
        width += 8;
        t.len += x;
      } while (x == 255);
    }
    b += width;
    rec[n] = token_rec(t);
    ends[n] = b;
    ++n;
  }
  while (cw < kChunkWords) {
    bm[cw] = acc;
    pr[cw] = before;
    before += __popc(acc);
    acc = 0;
    ++cw;
  }
  int64_t* c = cv + (int64_t)k * kCFields;
  c[kCSpecN] = n;
  c[kCExit] = b;
  c[kCConv] = -1;
  c[kCRepN] = 0;
}

// The true parse of each member from bit 0 (a CTA a member; thread 0
// parses): where it lands on a tile parse's start it records that token
// (the meeting point) and jumps to the chunk's exit; elsewhere it parses
// tokens itself (the chunk's words and start bitmap staged in shared
// memory) and records them as the chunk's repair tokens.
__global__ void __launch_bounds__(kRepairThreads)
c1_repair_kernel(const uint8_t* __restrict__ src,
                 const int64_t* __restrict__ meta,
                 const uint32_t* __restrict__ bitmap,
                 const int32_t* __restrict__ pre,
                 unsigned long long* __restrict__ rrec,
                 int64_t* __restrict__ rend, int64_t* __restrict__ cv) {
  __shared__ uint32_t words[kChunkWords + 4];
  __shared__ uint32_t sbm[kChunkWords];
  __shared__ int32_t spr[kChunkWords];
  __shared__ long long sb;
  const int m = blockIdx.x;
  const int64_t* row = meta + 5 * (int64_t)m;
  const StreamMap sm(src + row[0], row[1]);
  const int64_t c0 = row[4];
  int64_t b = 0;  // thread 0's bit
  // the meeting test: b starts a token of its chunk's tile parse
  auto meets = [&](int64_t k, int r, const uint32_t* bmw,
                   const int32_t* prw) -> bool {
    const uint32_t word = bmw[r >> 5];
    if (!((word >> (r & 31)) & 1)) return false;
    int64_t* c = cv + (c0 + k) * kCFields;
    c[kCConv] = prw[r >> 5] + __popc(word & ((1u << (r & 31)) - 1u));
    b = c[kCExit];
    return true;
  };
  for (;;) {
    if (threadIdx.x == 0) {
      while (b < sm.bits) {
        const int64_t k = b / kChunkBits;
        if (!meets(k, (int)(b - k * kChunkBits),
                   bitmap + (c0 + k) * kChunkWords,
                   pre + (c0 + k) * kChunkWords)) break;
      }
      sb = b;
    }
    __syncthreads();
    const int64_t q = sb;
    if (q >= sm.bits) break;
    const int64_t k = q / kChunkBits;
    const int64_t s = k * kChunkBits;
    const int64_t i0 = (s + 8 * sm.sk) >> 5;  // the chunk's first word
    for (int i = threadIdx.x; i < kChunkWords + 4; i += blockDim.x)
      words[i] = sm.word(i0 + i);
    for (int i = threadIdx.x; i < kChunkWords; i += blockDim.x) {
      sbm[i] = bitmap[(c0 + k) * kChunkWords + i];
      spr[i] = pre[(c0 + k) * kChunkWords + i];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int64_t* c = cv + (c0 + k) * kCFields;
      unsigned long long* rec = rrec + (c0 + k) * kChunkCap;
      int64_t* ends = rend + (c0 + k) * kChunkCap;
      int n = (int)c[kCRepN];
      const int64_t e = s + kChunkBits < sm.bits ? s + kChunkBits : sm.bits;
      // the 32 bits at bit x of the stream, from the staged words while
      // they hold them
      auto bits32 = [&](int64_t x) -> uint32_t {
        const int64_t gx = x + 8 * sm.sk;
        const int64_t i = (gx >> 5) - i0;
        const uint32_t hi = i + 1 < kChunkWords + 4 ? words[i]
                                                    : sm.word(i0 + i);
        const uint32_t lo = i + 1 < kChunkWords + 4 ? words[i + 1]
                                                    : sm.word(i0 + i + 1);
        return __funnelshift_l(lo, hi, (int)(gx & 31));
      };
      while (b < e && !meets(k, (int)(b - s), sbm, spr)) {
        Token t = decode(bits32(b));
        int64_t width = t.width;
        if (!t.lit && t.len == 41) {
          uint32_t x;
          do {
            x = bits32(b + width) >> 24;
            width += 8;
            t.len += x;
          } while (x == 255);
        }
        b += width;
        rec[n] = token_rec(t);
        ends[n] = b;
        ++n;
      }
      c[kCRepN] = n;
    }
    __syncthreads();
  }
}

// each chunk's true tokens (its repair tokens, then its tile parse's from
// the meeting token on): how many and their output bytes
__global__ void __launch_bounds__(128)
c1_count_kernel(int C, const unsigned long long* __restrict__ srec,
                const unsigned long long* __restrict__ rrec,
                int64_t* __restrict__ cv) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= C) return;
  int64_t* c = cv + (int64_t)k * kCFields;
  const int64_t rn = c[kCRepN], conv = c[kCConv], sn = c[kCSpecN];
  int64_t out = 0;
  const int64_t base = (int64_t)k * kChunkCap;
  for (int64_t i = 0; i < rn; ++i) out += rrec[base + i] >> 32;
  if (conv >= 0)
    for (int64_t i = conv; i < sn; ++i) out += srec[base + i] >> 32;
  c[kCCount] = rn + (conv >= 0 ? sn - conv : 0);
  c[kCOut] = out;
}

// per member (a warp): each chunk's first token and output bytes before it;
// a stream that ends before the output is full underruns
__global__ void __launch_bounds__(32)
c1_offsets_kernel(const int64_t* __restrict__ meta, int64_t* __restrict__ cv,
                  int64_t* __restrict__ mv) {
  const int m = blockIdx.x;
  const int lane = threadIdx.x;
  const int64_t* row = meta + 5 * (int64_t)m;
  const int64_t nc = (8 * row[1] + kChunkBits - 1) / kChunkBits;
  const int64_t c0 = row[4];
  long long tok = 0, out = 0;
  for (int64_t base = 0; base < nc; base += 32) {
    const int64_t k = base + lane;
    int64_t* c = cv + (c0 + k) * kCFields;
    const long long n = k < nc ? c[kCCount] : 0;
    const long long x = k < nc ? c[kCOut] : 0;
    long long in = n, ix = x;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(kFull, in, o);
      const long long z = __shfl_up_sync(kFull, ix, o);
      if (lane >= o) {
        in += y;
        ix += z;
      }
    }
    if (k < nc) {
      c[kCTok] = tok + in - n;
      c[kCObase] = out + ix - x;
    }
    tok += __shfl_sync(kFull, in, 31);
    out += __shfl_sync(kFull, ix, 31);
  }
  if (lane == 0) {
    int64_t* v = mv + (int64_t)m * kMFields;
    v[kMBad] = 0x7FFFFFFFFFFFFFFFll;
    v[kMNtok] = row[2] == 0 ? 0 : tok;
    v[kMUnder] = out < row[2];
  }
}

// each chunk's true tokens at their output positions: the records the
// materialisation reads (those that start inside the output), the first
// back-reference past the output's end, and at the token that fills the
// output, the tokens needed and whether it read past the stream
__global__ void __launch_bounds__(128)
c1_place_kernel(const int64_t* __restrict__ meta,
                const int32_t* __restrict__ chunks, int C,
                const unsigned long long* __restrict__ srec,
                const int64_t* __restrict__ send,
                const unsigned long long* __restrict__ rrec,
                const int64_t* __restrict__ rend,
                const int64_t* __restrict__ cv,
                unsigned long long* __restrict__ rec,
                int64_t* __restrict__ mv) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= C) return;
  const int m = chunks[2 * k];
  const int64_t* row = meta + 5 * (int64_t)m;
  const int64_t end = row[2] + 256;
  const int64_t* c = cv + (int64_t)k * kCFields;
  int64_t w = end - 1 - c[kCObase];
  int64_t idx = c[kCTok];
  if (w < 256) return;
  int64_t* v = mv + (int64_t)m * kMFields;
  unsigned long long* out = rec + row[3];
  const int64_t rn = c[kCRepN], conv = c[kCConv], sn = c[kCSpecN];
  const int64_t total = rn + (conv >= 0 ? sn - conv : 0);
  for (int64_t i = 0; i < total && w >= 256; ++i, ++idx) {
    const bool rep = i < rn;
    const int64_t j = (rep ? i : conv + i - rn) + (int64_t)k * kChunkCap;
    const unsigned long long r = rep ? rrec[j] : srec[j];
    const uint32_t info = (uint32_t)r;
    if (!(info & 0x80000000u) && w + info >= end)
      atomicMin(reinterpret_cast<unsigned long long*>(v + kMBad),
                (unsigned long long)idx);
    // the top position counted from the LZ region: below the decompress
    // size, a u32
    out[idx] = ((unsigned long long)(w - 256) << 32) | info;
    w -= (int64_t)(r >> 32);
    if (w < 256) {  // this token fills the output
      v[kMNtok] = idx + 1;
      if ((rep ? rend[j] : send[j]) > 8 * row[1]) v[kMUnder] = 1;
    }
  }
}

// per member (a warp): the 256-byte prefix, status and steps
__global__ void __launch_bounds__(32)
c1_finish_kernel(const uint8_t* __restrict__ src,
                 const int64_t* __restrict__ meta,
                 const int64_t* __restrict__ mv, uint8_t* __restrict__ out,
                 int32_t* __restrict__ status, int64_t* __restrict__ steps,
                 int64_t* __restrict__ ntok) {
  const int m = blockIdx.x;
  const int64_t* row = meta + 5 * (int64_t)m;
  const uint8_t* p = src + row[0] + row[1];
  uint8_t* o = out + row[3];
  for (int i = threadIdx.x; i < 256; i += 32) o[i] = p[i];
  if (threadIdx.x) return;
  const int64_t* v = mv + (int64_t)m * kMFields;
  const int64_t need = v[kMNtok];
  const bool bad = v[kMBad] < need;
  status[m] = (bad || v[kMUnder]) ? 1 : 0;
  steps[m] = bad ? v[kMBad] + 1 : need;
  ntok[m] = need;
}

// Each output byte: its member (a binary search of the output offsets,
// which ascend), its token (a binary search of the records, whose top
// positions, counted from the LZ region, descend), then a literal's byte,
// or a pointer to p + k D, the first source above the copy's own token.
// Bytes outside a token (the prefix, gaps, flagged members) point at
// themselves.
__global__ void __launch_bounds__(256)
c1_resolve_kernel(const int64_t* __restrict__ meta, int M,
                  const unsigned long long* __restrict__ rec,
                  const int64_t* __restrict__ ntok,
                  const int32_t* __restrict__ status,
                  uint8_t* __restrict__ out, int64_t* __restrict__ ptrs,
                  int64_t out_size) {
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= out_size) return;
  int a = 0, b = M - 1;
  while (a < b) {
    const int mid = (a + b + 1) >> 1;
    if (meta[5 * mid + 3] <= g) a = mid; else b = mid - 1;
  }
  const int m = a;
  const int64_t base = meta[5 * m + 3];
  const int64_t p = g - base;
  if (p < 256 || p >= meta[5 * m + 2] + 256 || status[m] != 0) {
    ptrs[g] = g;
    return;
  }
  const unsigned long long* r = rec + base;
  const int64_t q = p - 256;  // p in the LZ region
  int64_t lo = 0, hi = ntok[m] - 1;
  while (lo < hi) {
    const int64_t mid = (lo + hi + 1) >> 1;
    if ((int64_t)(r[mid] >> 32) >= q) lo = mid; else hi = mid - 1;
  }
  const unsigned long long e = r[lo];
  const int64_t wt = (int64_t)(e >> 32) + 256;
  const uint32_t info = (uint32_t)e;
  if (info & 0x80000000u) {
    out[g] = (uint8_t)info;
    ptrs[g] = g;
  } else {
    const int64_t k = (wt - p) / info + 1;
    ptrs[g] = g + k * info;
  }
}

// one round of pointer jumping; a round after one that changed nothing
// returns at once
__global__ void __launch_bounds__(256)
c1_jump_kernel(int64_t* ptrs, int64_t out_size, int32_t* changed, int r) {
  if (r > 0 && changed[r - 1] == 0) return;
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= out_size) return;
  const int64_t q = ptrs[g];
  if (q == g) return;
  const int64_t q2 = ptrs[q];
  if (q2 != q) {
    ptrs[g] = q2;
    changed[r] = 1;
  }
}

__global__ void __launch_bounds__(256)
c1_gather_kernel(const int64_t* __restrict__ ptrs, int64_t out_size,
                 uint8_t* out) {
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= out_size) return;
  const int64_t q = ptrs[g];
  if (q != g) out[g] = out[q];
}

}  // namespace

#define CRI_CHECK()                            \
  do {                                         \
    const cudaError_t e_ = cudaGetLastError(); \
    if (e_ != cudaSuccess) return (int)e_;     \
  } while (0)

// C1: meta [M, 5] (payload offset, compressed size, decompress size, output
// offset (ascending), first chunk), chunks i32 [C, 2] (member, chunk index);
// work arrays srec u64 / send i64 [C, kChunkCap] (the tile parses' tokens),
// rrec / rend the same (the repair's), bitmap u32 / pre i32 [C,
// kChunkWords], cv i64 [C, kCFields], mv i64 [M, kMFields], rec u64
// [out_size], ntok i64 [M], ptrs i64 [out_size], changed i32 [rounds].
extern "C" int crilayla_decompress(const void* src, const void* meta, int M,
                                   const void* chunks, int C, void* out,
                                   void* status, void* steps, void* srec,
                                   void* send, void* rrec, void* rend,
                                   void* bitmap, void* pre, void* cv,
                                   void* mv, void* rec, void* ntok,
                                   void* ptrs, void* changed,
                                   long long out_size, int rounds,
                                   void* stream) {
  if (M < 1 || C < 0 || rounds < 1 || out_size < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* sp = (const uint8_t*)src;
  const int64_t* mp = (const int64_t*)meta;
  const int32_t* cp = (const int32_t*)chunks;
  unsigned long long *sr = (unsigned long long*)srec,
                     *rr = (unsigned long long*)rrec;
  int64_t *se = (int64_t*)send, *re = (int64_t*)rend, *c = (int64_t*)cv,
          *mvp = (int64_t*)mv;
  cudaMemsetAsync(changed, 0, sizeof(int32_t) * rounds, s);
  CRI_CHECK();
  const unsigned cblocks = (unsigned)((C + 127) / 128);
  if (C > 0) {
    c1_spec_kernel<<<cblocks, 128, 0, s>>>(sp, mp, cp, C, sr, se,
                                           (uint32_t*)bitmap, (int32_t*)pre,
                                           c);
    CRI_CHECK();
    c1_repair_kernel<<<M, kRepairThreads, 0, s>>>(
        sp, mp, (const uint32_t*)bitmap, (const int32_t*)pre, rr, re, c);
    CRI_CHECK();
    c1_count_kernel<<<cblocks, 128, 0, s>>>(C, sr, rr, c);
    CRI_CHECK();
  }
  c1_offsets_kernel<<<M, 32, 0, s>>>(mp, c, mvp);
  CRI_CHECK();
  if (C > 0) {
    c1_place_kernel<<<cblocks, 128, 0, s>>>(
        mp, cp, C, sr, se, rr, re, c, (unsigned long long*)rec, mvp);
    CRI_CHECK();
  }
  c1_finish_kernel<<<M, 32, 0, s>>>(sp, mp, mvp, (uint8_t*)out,
                                    (int32_t*)status, (int64_t*)steps,
                                    (int64_t*)ntok);
  CRI_CHECK();
  const unsigned blocks = (unsigned)((out_size + 255) / 256);
  c1_resolve_kernel<<<blocks, 256, 0, s>>>(
      mp, M, (const unsigned long long*)rec, (const int64_t*)ntok,
      (const int32_t*)status, (uint8_t*)out, (int64_t*)ptrs, out_size);
  CRI_CHECK();
  for (int r = 0; r < rounds; ++r) {
    c1_jump_kernel<<<blocks, 256, 0, s>>>((int64_t*)ptrs, out_size,
                                          (int32_t*)changed, r);
    CRI_CHECK();
  }
  c1_gather_kernel<<<blocks, 256, 0, s>>>((const int64_t*)ptrs, out_size,
                                          (uint8_t*)out);
  CRI_CHECK();
  return 0;
}

// C2: meta [M, 4] (source offset, length, work offset, first tile), tiles
// i32 [G, 2] (member, tile index), work zeroed and readable as 32-bit words
// up to its last byte; work arrays best u64 [source size], run i32 [G,
// 0x2000] (u32),
// flags u8 [source size], tilev i64 [5, G] (exit, meeting point, bits,
// first bit, tokens).
extern "C" int crilayla_compress(const void* src, const void* meta, int M,
                                 const void* tiles, int G, void* work,
                                 void* start, void* status, void* steps,
                                 void* best, void* run, void* flags,
                                 void* tilev, void* stream) {
  if (M < 1 || G < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* sp = (const uint8_t*)src;
  const int64_t* mp = (const int64_t*)meta;
  const int32_t* tp = (const int32_t*)tiles;
  unsigned long long* bp = (unsigned long long*)best;
  uint8_t* fp = (uint8_t*)flags;
  int64_t* tv = (int64_t*)tilev;
  int64_t *texit = tv, *conv = tv + G, *tbits = tv + 2 * (int64_t)G,
          *toff = tv + 3 * (int64_t)G, *tcnt = tv + 4 * (int64_t)G;
  if (G > 0) {
    c2_summary_kernel<<<G, kSearchThreads, 0, s>>>(sp, mp, tp,
                                                   (uint32_t*)run);
    CRI_CHECK();
    c2_carry_kernel<<<M * (kWindow / 256), 256, 0, s>>>(mp, (uint32_t*)run);
    CRI_CHECK();
    c2_search_kernel<<<G, kSearchThreads, kSearchSmem, s>>>(
        sp, mp, tp, (const uint32_t*)run, bp);
    CRI_CHECK();
  }
  if (G > 0) {
    c2_spec_kernel<<<G, kWalkThreads, 0, s>>>(mp, tp, bp, fp, texit, conv);
    CRI_CHECK();
    c2_repair_kernel<<<M, kWalkThreads, 0, s>>>(mp, bp, fp, texit, conv);
    CRI_CHECK();
  }
  if (G > 0) {
    c2_count_kernel<<<G, kEmitThreads, 0, s>>>(mp, tp, bp, fp, conv, tbits,
                                               tcnt);
    CRI_CHECK();
  }
  c2_offsets_kernel<<<M, 32, 0, s>>>(mp, tbits, tcnt, toff, (int64_t*)start,
                                     (int32_t*)status, (int64_t*)steps);
  CRI_CHECK();
  if (G > 0) {
    c2_place_kernel<<<G, kEmitThreads, 0, s>>>(sp, mp, tp, bp, fp, conv,
                                               toff, (const int32_t*)status,
                                               (uint32_t*)work);
    CRI_CHECK();
  }
  return 0;
}
