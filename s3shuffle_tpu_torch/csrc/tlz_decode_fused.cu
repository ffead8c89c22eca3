// Kernel K3: fused TLZ v2 decode + literal-plane CRC.
//
// Replaces the JAX package's Pallas kernel _make_decode_fused_kernel
// (s3shuffle_tpu/ops/tlz_pallas.py:230). One CTA of CRC_NT threads decodes
// one row:
//
//   1. rank scans over the group planes (a block-wide scan of per-thread
//      counts): each group's distance (stored distances in order; a
//      continuation shares its run leader's), split point and literal slot;
//      the per-group distances stay in shared memory (4 bytes x G) for the
//      neighbour lookups of split groups;
//   2. the per-byte source map (literal bytes are fixed points, match bytes
//      point at pos - distance, split bytes at pos - d_prev / pos - d_next,
//      every offset clamped into the row exactly like the reference) and the
//      sparse literal plane, written to global scratch;
//   3. pointer jumping, src = src[src], over a double-buffered global scratch
//      for up to ceil(log2(n_bytes)) rounds — the reference's rounds. A round
//      that changes nothing leaves src a fixed point of the doubling update,
//      so the loop stops there with the identical result;
//   4. the final gather from the sparse plane;
//   5. the raw CRC of the row's literal plane (its first n_lits * 8 bytes,
//      n_lits recomputed from the bitmaps), with K1's block function.
//
// Bound: bytes (the planes, literals and decoded rows each cross device
// memory once); the pointer-jump rounds re-read the 4-byte source map, which
// is this first version's cost above the bound.
#include <cuda_runtime.h>

#include <cstdint>

#include "crc_common.cuh"

#define TLZ_GROUP 8

// Inclusive block scan of one int per thread (CRC_NT threads).
static __device__ __forceinline__ int block_scan_incl(int v, int* s_buf) {
  const int t = threadIdx.x;
  s_buf[t] = v;
  __syncthreads();
  for (int off = 1; off < CRC_NT; off <<= 1) {
    const int add = t >= off ? s_buf[t - off] : 0;
    __syncthreads();
    s_buf[t] += add;
    __syncthreads();
  }
  const int r = s_buf[t];
  __syncthreads();
  return r;
}

__global__ void __launch_bounds__(CRC_NT) tlz_decode_fused_kernel(
    const uint8_t* __restrict__ m_in, const uint8_t* __restrict__ c_in,
    const uint8_t* __restrict__ s_in, const int* __restrict__ offs,
    const int* __restrict__ ks_in, const uint8_t* __restrict__ lits, long long n_groups,
    int chunk, const uint32_t* __restrict__ tab8, const uint32_t* __restrict__ cols,
    int* scratch_src, uint8_t* scratch_sparse,  // read and written: no __restrict__
    uint8_t* __restrict__ dec, long long* __restrict__ crc_out) {
  extern __shared__ int s_dist[];  // n_groups entries
  __shared__ uint32_t s_tab8[8 * 256];
  __shared__ uint32_t s_cols[CRC_LEVELS * 32];
  __shared__ uint32_t s_red[CRC_NT];
  __shared__ int s_scan[CRC_NT];

  const int t = threadIdx.x;
  const long long row = blockIdx.x;
  const long long n_bytes = n_groups * TLZ_GROUP;
  const long long gbase = row * n_groups;
  const long long bbase = row * n_bytes;
  const uint8_t* mr = m_in + gbase;
  const uint8_t* cr = c_in + gbase;
  const uint8_t* sr = s_in + gbase;
  const int* orow = offs + gbase;
  const int* krow = ks_in + gbase;
  const uint8_t* lrow = lits + bbase;
  int* src_a = scratch_src + row * 2 * n_bytes;
  int* src_b = src_a + n_bytes;
  uint8_t* sparse = scratch_sparse + bbase;

  crc_load_tables(tab8, cols, s_tab8, s_cols);

  // ---- 1. per-thread counts over a contiguous range of groups ----
  const long long per = (n_groups + CRC_NT - 1) / CRC_NT;
  const long long ga = t * per < n_groups ? t * per : n_groups;
  const long long gb = ga + per < n_groups ? ga + per : n_groups;
  int c_new = 0, c_split = 0, c_lit = 0, c_match = 0;
  for (long long g = ga; g < gb; ++g) {
    const bool m = mr[g] != 0, c = cr[g] != 0, s = sr[g] != 0;
    c_new += (m && !c);
    c_split += s;
    c_lit += (!m && !s);
    c_match += m;
  }
  const int new_end = block_scan_incl(c_new, s_scan);
  const int split_end = block_scan_incl(c_split, s_scan);
  const int lit_end = block_scan_incl(c_lit, s_scan);
  const int match_total = block_scan_incl(c_match, s_scan);  // thread CRC_NT-1 holds the total
  __shared__ int s_totals[2];
  if (t == CRC_NT - 1) {
    s_totals[0] = match_total;
    s_totals[1] = split_end;
  }

  // ---- per-group distances (rank gather of the stored distances) ----
  {
    int new_rank = new_end - c_new - 1;  // cumsum - 1 before this range
    for (long long g = ga; g < gb; ++g) {
      new_rank += (mr[g] != 0 && cr[g] == 0);
      s_dist[g] = orow[new_rank > 0 ? new_rank : 0];
    }
  }
  __syncthreads();

  // ---- 2. source map + sparse literal plane ----
  {
    int split_rank = split_end - c_split - 1;
    int lit_rank = lit_end - c_lit - 1;
    for (long long g = ga; g < gb; ++g) {
      const bool m = mr[g] != 0, s = sr[g] != 0;
      const bool lit = !m && !s;
      split_rank += s;
      lit_rank += lit;
      const long long p0 = g * TLZ_GROUP;
      const int dist = s_dist[g];
      const int k = krow[split_rank > 0 ? split_rank : 0];
      const int d_prev = g > 0 ? s_dist[g - 1] : 0;
      const int d_next = g + 1 < n_groups ? s_dist[g + 1] : 0;
      const uint8_t* lsrc = lrow + (long long)(lit_rank > 0 ? lit_rank : 0) * TLZ_GROUP;
      for (int j = 0; j < TLZ_GROUP; ++j) {
        const long long p = p0 + j;
        long long q = p;
        if (s) {
          q = p - (j < k ? d_prev : d_next);
        } else if (m) {
          q = p - dist;
        }
        if (s || m) q = q < 0 ? 0 : (q > n_bytes - 1 ? n_bytes - 1 : q);
        src_a[p] = (int)q;
        sparse[p] = lit ? lsrc[j] : 0;
      }
    }
  }
  __syncthreads();

  // ---- 3. pointer jumping with an exact early exit ----
  int rounds = 0;
  for (long long n = n_bytes > 2 ? n_bytes : 2; (1LL << rounds) < n; ++rounds) {
  }
  int* cur = src_a;
  int* nxt = src_b;
  for (int r = 0; r < rounds; ++r) {
    int changed = 0;
    for (long long p = t; p < n_bytes; p += CRC_NT) {
      const int a = cur[p];
      const int b = cur[a];
      nxt[p] = b;
      changed |= (b != a);
    }
    const int any = __syncthreads_or(changed);
    int* tmp = cur;
    cur = nxt;
    nxt = tmp;
    if (!any) break;
  }

  // ---- 4. final gather ----
  uint8_t* drow = dec + bbase;
  for (long long p = t; p < n_bytes; p += CRC_NT) drow[p] = sparse[cur[p]];

  // ---- 5. literal-plane CRC ----
  __syncthreads();
  const long long n_lits = n_groups - s_totals[0] - s_totals[1];
  const long long lit_len = n_lits > 0 ? n_lits * TLZ_GROUP : 0;
  const uint32_t v = crc_block_raw(lrow, lit_len, chunk, s_tab8, s_cols, s_red);
  if (t == 0) crc_out[row] = (long long)v;
}

extern "C" int tlz_decode_fused_launch(const void* m_in, const void* c_in, const void* s_in,
                                       const void* offs, const void* ks, const void* lits,
                                       long long n_rows, long long n_groups, int chunk,
                                       const void* tab8, const void* cols, void* scratch_src,
                                       void* scratch_sparse, void* dec, void* crc,
                                       void* stream) {
  if (n_rows <= 0 || n_groups <= 0) return 0;
  const long long n_bytes = n_groups * TLZ_GROUP;
  if (chunk % 8 != 0 || (long long)CRC_NT * chunk < n_bytes || n_bytes > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)n_groups * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      tlz_decode_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  tlz_decode_fused_kernel<<<(unsigned)n_rows, CRC_NT, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)m_in, (const uint8_t*)c_in, (const uint8_t*)s_in, (const int*)offs,
      (const int*)ks, (const uint8_t*)lits, n_groups, chunk, (const uint32_t*)tab8,
      (const uint32_t*)cols, (int*)scratch_src, (uint8_t*)scratch_sparse, (uint8_t*)dec,
      (long long*)crc);
  return (int)cudaGetLastError();
}
