// Block-cooperative raw CRC of one message — shared by kernel K1
// (crc_fold.cu) and kernel K3 (tlz_decode_fused.cu).
//
// A reflected CRC register is GF(2)-linear in (state, data). With a zero
// initial state, leading zero bytes leave the register at zero, so a message
// of `len` bytes can be placed right-aligned in a virtual window of
// CRC_NT * chunk bytes: thread t takes the zero-init remainder of virtual
// bytes [t*chunk, (t+1)*chunk) with a slicing-by-8 table CRC, and the CRC_NT
// chunk remainders fold pairwise in a log2(CRC_NT)-level tree, where level l
// advances the left half by chunk * 2^l zero bytes (operator A^(chunk*2^l),
// given as 32 columns: A(v) = XOR of cols[i] over the set bits i of v).
#pragma once

#include <cstdint>

#define CRC_NT 512
#define CRC_LEVELS 9

// Copy the slicing-by-8 tables (8 x 256) and tree operators (LEVELS x 32)
// into shared memory. All threads of the block call it.
static __device__ __forceinline__ void crc_load_tables(
    const uint32_t* __restrict__ g_tab8, const uint32_t* __restrict__ g_cols,
    uint32_t* s_tab8, uint32_t* s_cols) {
  for (int i = threadIdx.x; i < 8 * 256; i += blockDim.x) s_tab8[i] = g_tab8[i];
  for (int i = threadIdx.x; i < CRC_LEVELS * 32; i += blockDim.x) s_cols[i] = g_cols[i];
}

static __device__ __forceinline__ uint32_t crc_apply_cols(const uint32_t* cols, uint32_t v) {
  uint32_t out = 0;
  while (v) {
    int b = __ffs(v) - 1;
    out ^= cols[b];
    v &= v - 1;
  }
  return out;
}

// Zero-init remainder continuation over bytes [lo, hi) of `base`
// (any alignment): byte steps up to an 8-byte boundary, slicing-by-8 over
// aligned words, byte steps for the tail.
static __device__ __forceinline__ uint32_t crc_span(
    const uint8_t* __restrict__ base, long long lo, long long hi, const uint32_t* T) {
  uint32_t crc = 0;
  long long i = lo;
  for (; i < hi && (i & 7); ++i) crc = T[(crc ^ base[i]) & 0xff] ^ (crc >> 8);
  for (; i + 8 <= hi; i += 8) {
    const uint2 w = *reinterpret_cast<const uint2*>(base + i);
    const uint32_t a = w.x ^ crc;
    const uint32_t b = w.y;
    crc = T[7 * 256 + (a & 0xff)] ^ T[6 * 256 + ((a >> 8) & 0xff)] ^
          T[5 * 256 + ((a >> 16) & 0xff)] ^ T[4 * 256 + (a >> 24)] ^
          T[3 * 256 + (b & 0xff)] ^ T[2 * 256 + ((b >> 8) & 0xff)] ^
          T[1 * 256 + ((b >> 16) & 0xff)] ^ T[0 * 256 + (b >> 24)];
  }
  for (; i < hi; ++i) crc = T[(crc ^ base[i]) & 0xff] ^ (crc >> 8);
  return crc;
}

// Raw zero-init CRC of msg[0, len), len <= CRC_NT * chunk. blockDim.x must
// be CRC_NT and `msg` 8-byte aligned. All threads call it; the result is
// returned to every thread. `s_red` holds CRC_NT words of shared memory.
static __device__ uint32_t crc_block_raw(
    const uint8_t* __restrict__ msg, long long len, int chunk,
    const uint32_t* s_tab8, const uint32_t* s_cols, uint32_t* s_red) {
  const int t = threadIdx.x;
  const long long pad = (long long)CRC_NT * chunk - len;
  long long lo = (long long)t * chunk - pad;
  long long hi = lo + chunk;
  if (lo < 0) lo = 0;
  if (hi > len) hi = len;
  s_red[t] = hi > lo ? crc_span(msg, lo, hi, s_tab8) : 0u;
  __syncthreads();
  for (int l = 0; l < CRC_LEVELS; ++l) {
    const int stride = 1 << l;
    if ((t & ((stride << 1) - 1)) == 0) {
      s_red[t] = crc_apply_cols(s_cols + 32 * l, s_red[t]) ^ s_red[t + stride];
    }
    __syncthreads();
  }
  const uint32_t v = s_red[0];
  __syncthreads();  // s_red may be reused by the caller
  return v;
}
