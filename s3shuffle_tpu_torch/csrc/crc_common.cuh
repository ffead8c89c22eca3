// Segmented raw CRC of byte messages — shared by kernel K1 (crc_fold.cu)
// and kernel K3's literal-plane CRC (tlz_decode_fused.cu).
//
// A reflected CRC register is GF(2)-linear in (state, data). With a zero
// initial state, leading zero bytes leave the register at zero, so a message
// of `len` bytes can be placed right-aligned in a virtual window of n_seg
// segments of S bytes; segment j holds message bytes [j*S - pad, (j+1)*S -
// pad), pad = n_seg*S - len, and only segments n_seg - ceil(len/S) .. n_seg-1
// hold any. One CTA takes one segment's zero-init remainder, and the CTA of
// the message that arrives last (an atomic arrival counter) folds the
// remainders with A^(S*(n_seg-1-j)), given as 32 columns each (A(v) = XOR of
// cols[i] over the set bits i of v).
//
// Inside a segment (crc_segment_raw): S = CRC_SEG = 16 KiB, cut into CRC_NT
// chunks of CRC_CHUNK = 128 bytes, one per walking thread. The CTA stages the
// segment in shared memory with coalesced 8-byte loads (a chunk's words at a
// stride of CRC_CHUNK + 8 bytes, so the walkers' 8-byte reads hit 32
// distinct banks), each walker takes a slicing-by-8 table CRC of its chunk,
// and the CRC_NT chunk remainders fold in a log2(CRC_NT)-level tree: level l
// advances the left half by CRC_CHUNK * 2^l zero bytes. Levels 0-4 run in
// registers across a warp's lanes (shuffles), the rest in warp 0. A tree
// operator is applied through 8 nibble tables of 16 words each (built on
// the host): 8 lookups that never conflict on a bank, where a bit-serial
// apply takes up to 32 dependent steps. Every copy from global memory into
// shared memory (tables, the segment) issues its loads together before its
// stores: a copy loop that waits on each load in turn left the first
// version of this code latency-bound.
#pragma once

#include <cstdint>

#define CRC_SEG 16384
#define CRC_NT 128
#define CRC_CHUNK (CRC_SEG / CRC_NT)
#define CRC_WORDS (CRC_CHUNK / 8)
#define CRC_LEVELS 7  // log2(CRC_NT)
#define CRC_STAGE_WORDS (CRC_NT * (CRC_WORDS + 1))
#define CRC_NIB_WORDS (CRC_LEVELS * 8 * 16)
#define CRC_BATCH 8  // loads in flight per thread in a table copy

// Shared memory a CTA passes to the functions below.
struct CrcSmem {
  unsigned long long* stage;  // CRC_STAGE_WORDS
  uint32_t* tab8;             // 8 x 256 slicing-by-8 tables
  uint32_t* nib;              // CRC_LEVELS x 8 x 16 tree operator nibble tables
  uint32_t* red;              // CRC_NT / 32 + 1 words
};

// Copy n 16-byte words from global to shared memory, CRC_BATCH loads a
// thread in flight before their stores. All threads of the block call it.
static __device__ __forceinline__ void crc_copy16(uint4* dst, const uint4* __restrict__ src,
                                                  int n) {
  for (int base = threadIdx.x; base < n; base += CRC_BATCH * blockDim.x) {
    uint4 v[CRC_BATCH];
#pragma unroll
    for (int k = 0; k < CRC_BATCH; ++k) {
      const int i = base + k * blockDim.x;
      if (i < n) v[k] = __ldg(src + i);
    }
#pragma unroll
    for (int k = 0; k < CRC_BATCH; ++k) {
      const int i = base + k * blockDim.x;
      if (i < n) dst[i] = v[k];
    }
  }
}

// Copy the slicing-by-8 tables (8 x 256) and the tree operators' nibble
// tables (CRC_LEVELS x 8 x 16) into shared memory (both 16-byte aligned).
// All threads of the block call it; the caller synchronises before use.
static __device__ __forceinline__ void crc_load_tables(const uint32_t* __restrict__ g_tab8,
                                                       const uint32_t* __restrict__ g_nib,
                                                       const CrcSmem& sm) {
  crc_copy16(reinterpret_cast<uint4*>(sm.tab8), reinterpret_cast<const uint4*>(g_tab8),
             8 * 256 / 4);
  crc_copy16(reinterpret_cast<uint4*>(sm.nib), reinterpret_cast<const uint4*>(g_nib),
             CRC_NIB_WORDS / 4);
}

// A(v) from 32 columns in global memory (the segment fold: a few calls a
// message). The 32 loads are issued together: a loop over the set bits of v
// waits on each column in turn.
static __device__ __forceinline__ uint32_t crc_apply_cols(const uint32_t* __restrict__ cols,
                                                          uint32_t v) {
  uint32_t out = 0;
#pragma unroll
  for (int b = 0; b < 32; ++b) out ^= __ldg(cols + b) & (0u - ((v >> b) & 1u));
  return out;
}

// A(v) from one operator's 8 nibble tables.
static __device__ __forceinline__ uint32_t crc_apply_nib(const uint32_t* nib, uint32_t v) {
  uint32_t out = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) out ^= nib[k * 16 + ((v >> (4 * k)) & 15)];
  return out;
}

// One slicing-by-8 step: the remainder after 8 more message bytes `w`.
static __device__ __forceinline__ uint32_t crc_step8(uint32_t crc, unsigned long long w,
                                                     const uint32_t* T) {
  const uint32_t a = (uint32_t)w ^ crc;
  const uint32_t b = (uint32_t)(w >> 32);
  return T[7 * 256 + (a & 0xff)] ^ T[6 * 256 + ((a >> 8) & 0xff)] ^
         T[5 * 256 + ((a >> 16) & 0xff)] ^ T[4 * 256 + (a >> 24)] ^
         T[3 * 256 + (b & 0xff)] ^ T[2 * 256 + ((b >> 8) & 0xff)] ^
         T[1 * 256 + ((b >> 16) & 0xff)] ^ T[0 * 256 + (b >> 24)];
}

// Zero-init remainder continuation over bytes [lo, hi) of `base` (any
// alignment; `base` 8-byte aligned): byte steps up to an 8-byte boundary,
// slicing-by-8 over aligned words, byte steps for the tail.
static __device__ uint32_t crc_span(const uint8_t* __restrict__ base, long long lo,
                                    long long hi, const uint32_t* T) {
  uint32_t crc = 0;
  long long i = lo;
  for (; i < hi && (i & 7); ++i) crc = T[(crc ^ base[i]) & 0xff] ^ (crc >> 8);
  for (; i + 8 <= hi; i += 8)
    crc = crc_step8(crc, *reinterpret_cast<const unsigned long long*>(base + i), T);
  for (; i < hi; ++i) crc = T[(crc ^ base[i]) & 0xff] ^ (crc >> 8);
  return crc;
}

// Segment j's message bytes [*lo, *hi) of a `len`-byte message right-aligned
// in n_seg segments of `seg` bytes; empty (*hi <= *lo) before the message.
static __device__ __forceinline__ void crc_segment_span(long long len, int j, int n_seg,
                                                        long long seg, long long* lo,
                                                        long long* hi) {
  const long long pad = (long long)n_seg * seg - len;
  *hi = (long long)(j + 1) * seg - pad;
  *lo = *hi - seg > 0 ? *hi - seg : 0;
}

// Zero-init raw CRC of base[lo, hi), hi - lo <= CRC_SEG, `base` 8-byte
// aligned. All threads of the block call it (at least CRC_NT, a multiple of
// 32; the first CRC_NT walk); the result is returned to every thread (0 at
// once for an empty span).
static __device__ uint32_t crc_segment_raw(const uint8_t* __restrict__ base, long long lo,
                                           long long hi, const CrcSmem& sm) {
  if (hi <= lo) return 0u;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  uint32_t r = 0;
  if ((hi & 7) == 0) {
    if (t < CRC_NT) {
      // Each walking warp stages the 4 KiB its own lanes walk (coalesced
      // 8-byte loads, all in flight), then walks it: no warp waits for
      // another's loads. The window is [hi - CRC_SEG, hi); words before lo
      // are zero (leading zeros), a word straddling lo keeps its bytes from
      // lo on.
      const int w_first = warp * 32 * CRC_WORDS;
      const long long w0 = hi - CRC_SEG;
      unsigned long long v[CRC_WORDS];
#pragma unroll
      for (int k = 0; k < CRC_WORDS; ++k) {
        const long long p = w0 + 8LL * (w_first + lane + 32 * k);
        v[k] = 0;
        if (p + 8 > lo) {  // then p >= 0: a multiple of 8 above lo - 8
          v[k] = __ldg(reinterpret_cast<const unsigned long long*>(base + p));
          if (p < lo) v[k] &= ~0ULL << (8 * (lo - p));
        }
      }
#pragma unroll
      for (int k = 0; k < CRC_WORDS; ++k) {
        const int w = w_first + lane + 32 * k;
        sm.stage[(w / CRC_WORDS) * (CRC_WORDS + 1) + w % CRC_WORDS] = v[k];
      }
      __syncwarp();
      const unsigned long long* mine = sm.stage + t * (CRC_WORDS + 1);
#pragma unroll
      for (int i = 0; i < CRC_WORDS; ++i) r = crc_step8(r, mine[i], sm.tab8);
    }
  } else if (t < CRC_NT) {  // an unaligned end: byte-exact walk from global
    const long long w0 = hi - CRC_SEG;
    long long a = w0 + (long long)t * CRC_CHUNK, b = a + CRC_CHUNK;
    if (a < lo) a = lo;
    if (b > hi) b = hi;
    if (b > a) r = crc_span(base, a, b, sm.tab8);
  }
  // tree: levels 0-4 across the lanes of each walking warp
#pragma unroll
  for (int l = 0; l < 5; ++l) {
    const uint32_t other = __shfl_down_sync(0xffffffffu, r, 1 << l);
    if ((lane & ((2 << l) - 1)) == 0) r = crc_apply_nib(sm.nib + l * 128, r) ^ other;
  }
  if (lane == 0 && warp < CRC_NT / 32) sm.red[warp] = r;
  __syncthreads();
  if (warp == 0) {  // levels 5 .. CRC_LEVELS-1 across the walking warps
    r = lane < CRC_NT / 32 ? sm.red[lane] : 0u;
#pragma unroll
    for (int l = 5; l < CRC_LEVELS; ++l) {
      const uint32_t other = __shfl_down_sync(0xffffffffu, r, 1 << (l - 5));
      if ((lane & ((2 << (l - 5)) - 1)) == 0) r = crc_apply_nib(sm.nib + l * 128, r) ^ other;
    }
    if (lane == 0) sm.red[CRC_NT / 32] = r;
  }
  __syncthreads();
  const uint32_t v = sm.red[CRC_NT / 32];
  __syncthreads();  // stage and red may be reused by the caller
  return v;
}

// Publish this CTA's remainder `part` of segment `seg` of a message (into
// partials[seg * stride]) and count its arrival on `counter`; the message has
// `expected` segments, j0 = n_seg - expected .. n_seg - 1. The CTA that
// arrives last folds the remainders with seg_cols (n_seg x 32: row i is
// A^(S*i)), sets the counter back to 0 for the next call, and returns true
// in every thread with the message's CRC in *crc. All threads call it.
static __device__ bool crc_segments_join(uint32_t part, int* partials, int stride, int seg,
                                         int n_seg, int expected, int* counter,
                                         const uint32_t* __restrict__ seg_cols, uint32_t* s_join,
                                         uint32_t* crc) {
  const int t = threadIdx.x;
  if (t == 0) {
    partials[(long long)seg * stride] = (int)part;
    s_join[1] = 0u;
    __threadfence();
    s_join[0] = atomicAdd(counter, 1) == expected - 1;
  }
  __syncthreads();
  if (!s_join[0]) return false;
  __threadfence();
  uint32_t acc = 0u;
  for (int j = n_seg - expected + t; j < n_seg; j += blockDim.x) {
    const uint32_t v = (uint32_t)__ldcg(partials + (long long)j * stride);
    acc ^= crc_apply_cols(seg_cols + 32 * (n_seg - 1 - j), v);
  }
  for (int off = 16; off > 0; off >>= 1) acc ^= __shfl_xor_sync(0xffffffffu, acc, off);
  if ((t & 31) == 0 && acc) atomicXor(&s_join[1], acc);
  __syncthreads();
  *crc = s_join[1];
  if (t == 0) *counter = 0;
  __syncthreads();  // s_join may be reused by the caller
  return true;
}
