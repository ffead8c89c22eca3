// Kernel K4: batched GF(2^8) parity encode of stripe groups.
//
// Replaces the JAX package's Pallas kernel _make_kernel
// (s3shuffle_tpu/coding/gf_pallas.py:76), which tiles (8 groups, 128 bytes)
// into VMEM and unrolls 8*k*m bit-selects of the constants
// gfmul(C[i][j], 1 << a). The function is the same here:
//
//   P[g, i, :] = XOR_j XOR_a  bit_a(D[g, j, :]) ? gfmul(C[i][j], 1 << a) : 0
//
// Bound on an H100: for the coded path's shapes (m, k <= 2) the bytes, each
// chunk byte read once and each parity byte written once (a [16, 2, 1 MiB]
// batch at m = 2 moves 64 MiB, ~20 us at 3.35 TB/s); for large m*k the
// integer operations. Design: one thread owns 16 contiguous bytes of one
// group's chunk row (one 16-byte load per data chunk, neighbouring threads on
// neighbouring addresses) and keeps up to GF_MT parity rows of those 16 bytes
// in registers, so every data byte is read once for all the CTA's parity
// rows. Per data chunk and bit a, the byte masks ((x >> a) & 0x01010101) *
// 0xFF are formed once on 4 packed bytes and shared by every parity row,
// which then costs one AND-XOR per word against the replicated constant. The
// constants (m*k*8 bytes) are staged in shared memory, GF_KT chunks at a
// time; all threads of a warp read the same constant (a broadcast). The
// ragged G and L edges are masked here: a row length that is not a multiple
// of 16 takes byte loads and stores.
#include <cuda_runtime.h>
#include <stdint.h>

#define GF_NT 256  // threads per CTA
#define GF_MT 8    // most parity rows one CTA keeps in registers
#define GF_KT 64   // data chunks whose constants are staged at a time

__device__ __forceinline__ void gf_load16(const uint8_t* __restrict__ row, long long l0,
                                          long long length, bool aligned, uint32_t x[4]) {
  if (aligned) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + l0));
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
    return;
  }
  x[0] = x[1] = x[2] = x[3] = 0u;
#pragma unroll
  for (int b = 0; b < 16; ++b)
    if (l0 + b < length) x[b >> 2] |= (uint32_t)row[l0 + b] << (8 * (b & 3));
}

__device__ __forceinline__ void gf_store16(uint8_t* __restrict__ row, long long l0,
                                           long long length, bool aligned,
                                           const uint32_t x[4]) {
  if (aligned) {
    *reinterpret_cast<uint4*>(row + l0) = make_uint4(x[0], x[1], x[2], x[3]);
    return;
  }
#pragma unroll
  for (int b = 0; b < 16; ++b)
    if (l0 + b < length) row[l0 + b] = (uint8_t)(x[b >> 2] >> (8 * (b & 3)));
}

// chunks [groups, k, length], consts [m, k, 8], out [groups, m, length]; CTA
// (x, y) covers GF_NT 16-byte vectors of one group and parity rows
// [y * MT, y * MT + MT).
template <int MT>
__global__ void __launch_bounds__(GF_NT) gf_encode_kernel(
    const uint8_t* __restrict__ chunks, const uint8_t* __restrict__ consts, int k, int m,
    long long length, long long blocks_per_row, uint8_t* __restrict__ out) {
  __shared__ uint32_t s_c[MT * GF_KT * 8];
  const long long g = blockIdx.x / blocks_per_row;
  const long long l0 = ((blockIdx.x % blocks_per_row) * GF_NT + threadIdx.x) * 16;
  const int i0 = blockIdx.y * MT;
  const bool active = l0 < length;
  const bool aligned = (length % 16) == 0;
  uint32_t acc[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0u;

  for (int jt = 0; jt < k; jt += GF_KT) {
    const int kt = min(GF_KT, k - jt);
    __syncthreads();  // the previous tile's constants are no longer read
    for (int e = threadIdx.x; e < MT * kt * 8; e += GF_NT) {
      const int i = e / (kt * 8);
      const int r = e - i * (kt * 8);  // j * 8 + a inside the tile
      const uint32_t c =
          (i0 + i < m) ? (uint32_t)consts[((long long)(i0 + i) * k + jt) * 8 + r] : 0u;
      s_c[i * GF_KT * 8 + r] = c * 0x01010101u;
    }
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < kt; ++j) {
      uint32_t x[4];
      gf_load16(chunks + (g * k + jt + j) * length, l0, length, aligned, x);
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        uint32_t bits[4];
#pragma unroll
        for (int w = 0; w < 4; ++w) bits[w] = ((x[w] >> a) & 0x01010101u) * 0xFFu;
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const uint32_t c = s_c[(i * GF_KT + j) * 8 + a];
#pragma unroll
          for (int w = 0; w < 4; ++w) acc[i][w] ^= bits[w] & c;
        }
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int i = 0; i < MT; ++i)
    if (i0 + i < m) gf_store16(out + (g * m + i0 + i) * length, l0, length, aligned, acc[i]);
}

template <int MT>
static int gf_launch(const uint8_t* chunks, const uint8_t* consts, long long groups, int k,
                     int m, long long length, uint8_t* out, cudaStream_t stream) {
  const long long vecs = (length + 15) / 16;
  const long long blocks_per_row = (vecs + GF_NT - 1) / GF_NT;
  const long long grid_x = groups * blocks_per_row;
  const long long grid_y = (m + MT - 1) / MT;
  if (grid_x > 0x7FFFFFFFLL || grid_y > 65535) return (int)cudaErrorInvalidValue;
  gf_encode_kernel<MT><<<dim3((unsigned)grid_x, (unsigned)grid_y), GF_NT, 0, stream>>>(
      chunks, consts, k, m, length, blocks_per_row, out);
  return (int)cudaGetLastError();
}

extern "C" int gf_encode_launch(const void* chunks, const void* consts, long long groups,
                                int k, int m, long long length, void* out, void* stream) {
  if (groups <= 0 || length <= 0 || m <= 0) return 0;
  if (k <= 0) return (int)cudaErrorInvalidValue;
  const uint8_t* c = (const uint8_t*)chunks;
  const uint8_t* t = (const uint8_t*)consts;
  uint8_t* o = (uint8_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (m < GF_MT ? m : GF_MT) {
    case 1: return gf_launch<1>(c, t, groups, k, m, length, o, s);
    case 2: return gf_launch<2>(c, t, groups, k, m, length, o, s);
    case 3: return gf_launch<3>(c, t, groups, k, m, length, o, s);
    case 4: return gf_launch<4>(c, t, groups, k, m, length, o, s);
    case 5: return gf_launch<5>(c, t, groups, k, m, length, o, s);
    case 6: return gf_launch<6>(c, t, groups, k, m, length, o, s);
    case 7: return gf_launch<7>(c, t, groups, k, m, length, o, s);
    default: return gf_launch<GF_MT>(c, t, groups, k, m, length, o, s);
  }
}
