// Kernel K1: batched raw CRC32/CRC32C remainders of byte rows.
//
// Replaces the JAX package's Pallas kernel _crc_fold_kernel
// (s3shuffle_tpu/ops/crc_pallas.py:68), an MXU bit-matrix tile fold. Here
// one CTA of CRC_NT threads takes one row: table CRCs of contiguous chunks,
// combined by a log-depth tree of GF(2) shift operators (crc_common.cuh).
// Bound: the bytes of the rows, each read once with 8-byte loads; every
// table lives in shared memory.
#include <cuda_runtime.h>

#include "crc_common.cuh"

__global__ void __launch_bounds__(CRC_NT) crc_fold_kernel(
    const uint8_t* __restrict__ rows, long long width, const int* __restrict__ lengths,
    int chunk, const uint32_t* __restrict__ tab8, const uint32_t* __restrict__ cols,
    long long* __restrict__ out) {
  __shared__ uint32_t s_tab8[8 * 256];
  __shared__ uint32_t s_cols[CRC_LEVELS * 32];
  __shared__ uint32_t s_red[CRC_NT];
  crc_load_tables(tab8, cols, s_tab8, s_cols);
  __syncthreads();
  const long long row = blockIdx.x;
  long long len = lengths ? (long long)lengths[row] : width;
  if (len < 0) len = 0;
  if (len > width) len = width;
  const uint32_t v = crc_block_raw(rows + row * width, len, chunk, s_tab8, s_cols, s_red);
  if (threadIdx.x == 0) out[row] = (long long)v;
}

extern "C" int crc_fold_launch(const void* rows, long long n_rows, long long width,
                               const void* lengths, int chunk, const void* tab8,
                               const void* cols, void* out, void* stream) {
  if (n_rows <= 0) return 0;
  if (width % 8 != 0 || chunk % 8 != 0 || (long long)CRC_NT * chunk < width)
    return (int)cudaErrorInvalidValue;
  crc_fold_kernel<<<(unsigned)n_rows, CRC_NT, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)rows, width, (const int*)lengths, chunk, (const uint32_t*)tab8,
      (const uint32_t*)cols, (long long*)out);
  return (int)cudaGetLastError();
}
