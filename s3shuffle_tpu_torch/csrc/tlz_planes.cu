// Kernel K2: TLZ v2 encode plane decisions.
//
// Replaces the JAX package's Pallas kernel _make_planes_kernel
// (s3shuffle_tpu/ops/tlz_pallas.py:77), which holds one whole block and a
// dozen (G, 8) intermediates in VMEM per grid step. A 256 KiB block does not
// fit in one SM's 227 KB of shared memory, so here one CTA owns a tile of
// TILE_G consecutive groups of one row and reads the row's bytes straight
// from global memory (the 16 MiB batch stays resident in the 50 MB L2);
// only the per-group decision planes of the tile and its halo live in shared
// memory.
//
// Group g's final planes depend on the promotion passes at g-1..g+1, which
// depend on pass 0 at g-3..g+1 — so each CTA computes pass 0 on its tile
// plus a 3-group left / 1-group right halo, then the two promotion passes
// (each reading only the previous pass's planes, exactly as the reference's
// two vectorized passes, not a running scan), then the continuation flag and
// the split tier. Out-of-row neighbours are (no match, distance 0), as the
// reference's zero-filled shifts.
//
// Bound: bytes. Inputs are read once (rows + candidates), five planes are
// written once; the compares are a few dozen integer ops per group.
#include <cuda_runtime.h>

#include <cstdint>

#define TLZ_GROUP 8
#define TLZ_MAX_DIST 65535
#define TILE_G 256

// 8 bytes at an arbitrary position of an 8-byte-aligned row (little endian).
// pos <= n_bytes - 8, so the second aligned word never passes the row end.
static __device__ __forceinline__ unsigned long long load8(const uint8_t* __restrict__ rb,
                                                           long long pos) {
  const long long a = pos & ~7LL;
  const int sh = (int)(pos & 7) * 8;
  const unsigned long long lo = *reinterpret_cast<const unsigned long long*>(rb + a);
  if (sh == 0) return lo;
  const unsigned long long hi = *reinterpret_cast<const unsigned long long*>(rb + a + 8);
  return (lo >> sh) | (hi << (64 - sh));
}

__global__ void __launch_bounds__(TILE_G) tlz_planes_kernel(
    const uint8_t* __restrict__ buf, const int* __restrict__ cand, long long n_groups,
    uint8_t* __restrict__ m_out, uint8_t* __restrict__ c_out, uint8_t* __restrict__ s_out,
    int* __restrict__ d_out, int* __restrict__ k_out) {
  __shared__ int s_d0[TILE_G + 4];
  __shared__ uint8_t s_m0[TILE_G + 4];
  __shared__ int s_d1[TILE_G + 3];
  __shared__ uint8_t s_m1[TILE_G + 3];
  __shared__ int s_d2[TILE_G + 2];
  __shared__ uint8_t s_m2[TILE_G + 2];

  const long long n_bytes = n_groups * TLZ_GROUP;
  const long long row = blockIdx.y;
  const long long g0 = (long long)blockIdx.x * TILE_G;
  const uint8_t* rb = buf + row * n_bytes;
  const int* cr = cand + row * n_groups;

  // pass 0: candidate verification, entries e <-> group g0 - 3 + e
  for (int e = threadIdx.x; e < TILE_G + 4; e += blockDim.x) {
    const long long g = g0 - 3 + e;
    uint8_t m = 0;
    int d = 0;
    if (g >= 0 && g < n_groups) {
      const long long c = cr[g];
      const long long dest = g * TLZ_GROUP;
      const long long dist = dest - c;
      if (c >= 0 && dist <= TLZ_MAX_DIST && load8(rb, c) == load8(rb, dest)) {
        m = 1;
        d = (int)dist;
      }
    }
    s_m0[e] = m;
    s_d0[e] = d;
  }
  __syncthreads();

  // pass 1: retry at the previous group's pass-0 distance; e <-> g0 - 2 + e
  for (int e = threadIdx.x; e < TILE_G + 3; e += blockDim.x) {
    const long long g = g0 - 2 + e;
    uint8_t m = 0;
    int d = 0;
    if (g >= 0 && g < n_groups) {
      m = s_m0[e + 1];
      d = s_d0[e + 1];
      const int pd = s_d0[e];
      if (s_m0[e] && pd > 0) {
        long long src = g * TLZ_GROUP - pd;
        if (src < 0) src = 0;
        if (load8(rb, src) == load8(rb, g * TLZ_GROUP)) {
          m = 1;
          d = pd;
        }
      }
    }
    s_m1[e] = m;
    s_d1[e] = d;
  }
  __syncthreads();

  // pass 2: the same retry on the pass-1 planes; e <-> g0 - 1 + e
  for (int e = threadIdx.x; e < TILE_G + 2; e += blockDim.x) {
    const long long g = g0 - 1 + e;
    uint8_t m = 0;
    int d = 0;
    if (g >= 0 && g < n_groups) {
      m = s_m1[e + 1];
      d = s_d1[e + 1];
      const int pd = s_d1[e];
      if (s_m1[e] && pd > 0) {
        long long src = g * TLZ_GROUP - pd;
        if (src < 0) src = 0;
        if (load8(rb, src) == load8(rb, g * TLZ_GROUP)) {
          m = 1;
          d = pd;
        }
      }
    }
    s_m2[e] = m;
    s_d2[e] = d;
  }
  __syncthreads();

  // continuation flag + split tier; thread t <-> group g0 + t
  const int t = threadIdx.x;
  const long long g = g0 + t;
  if (g >= n_groups) return;
  const uint8_t m = s_m2[t + 1];
  const int d = s_d2[t + 1];
  const uint8_t pm = s_m2[t];
  const int pd = s_d2[t];
  const uint8_t nm = s_m2[t + 2];
  const int nd = s_d2[t + 2];
  const uint8_t cont = m && pm && d == pd;

  const long long dest = g * TLZ_GROUP;
  const unsigned long long grp = load8(rb, dest);
  int prefix_run = 0;
  bool prefix_open = true;
  for (int j = 0; j < TLZ_GROUP; ++j) {
    long long idx = dest + j - pd;
    idx = idx < 0 ? 0 : (idx > n_bytes - 1 ? n_bytes - 1 : idx);
    const bool eq = rb[idx] == (uint8_t)(grp >> (8 * j));
    prefix_open = prefix_open && eq;
    prefix_run += prefix_open ? 1 : 0;
  }
  int suffix_len = 0;
  bool suffix_open = true;
  for (int j = TLZ_GROUP - 1; j >= 0; --j) {
    const long long raw = dest + j - nd;
    const long long idx = raw < 0 ? 0 : (raw > n_bytes - 1 ? n_bytes - 1 : raw);
    const bool eq = raw >= 0 && rb[idx] == (uint8_t)(grp >> (8 * j));
    suffix_open = suffix_open && eq;
    suffix_len += suffix_open ? 1 : 0;
  }
  const int ks = TLZ_GROUP - suffix_len;
  const uint8_t split = !m && pm && nm && pd > 0 && nd > 0 && ks >= 1 &&
                        ks <= TLZ_GROUP - 1 && ks <= prefix_run;
  const long long o = row * n_groups + g;
  m_out[o] = m;
  c_out[o] = cont;
  s_out[o] = split;
  d_out[o] = d;
  k_out[o] = ks;
}

extern "C" int tlz_planes_launch(const void* buf, const void* cand, long long n_rows,
                                 long long n_groups, void* m_out, void* c_out, void* s_out,
                                 void* d_out, void* k_out, void* stream) {
  if (n_rows <= 0 || n_groups <= 0) return 0;
  if (n_rows > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((n_groups + TILE_G - 1) / TILE_G), (unsigned)n_rows);
  tlz_planes_kernel<<<grid, TILE_G, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)buf, (const int*)cand, n_groups, (uint8_t*)m_out, (uint8_t*)c_out,
      (uint8_t*)s_out, (int*)d_out, (int*)k_out);
  return (int)cudaGetLastError();
}
