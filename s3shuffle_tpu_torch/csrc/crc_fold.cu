// Kernel K1: batched raw CRC32/CRC32C remainders of byte rows.
//
// Replaces the JAX package's Pallas kernel _crc_fold_kernel
// (s3shuffle_tpu/ops/crc_pallas.py:68), an MXU bit-matrix tile fold.
//
// Bound on an H100: bytes. Each message byte is read once (the main path's
// batch: 64 raw blocks of 256 KiB and 64 literal planes of n_lits*8 bytes,
// ~20 MB, 5.9 us at 3.35 TB/s). Beyond the bytes the slicing-by-8 walk does
// one shared-memory table lookup per byte (bank conflicts included), and
// every segment pays fixed latencies: its CTA's launch, the table copy, the
// tree, and the join's fence and atomic. PERF.md has the measured split
// (kernel_split.py).
//
// The first design gave each row one CTA: 128 CTAs for 132 SMs, half of
// them on short literal planes, so ~64 SMs each walked a whole 256 KiB row
// with uncoalesced per-thread loads, and the tree fold took 9 barrier
// levels with bit-serial operators. Here every row is cut into 16 KiB
// segments over its right-aligned window (crc_common.cuh) and the grid
// walks (row, segment) items, so a literal plane of n bytes costs about
// n / 16 KiB segments and every SM works; a segment is staged with
// coalesced loads and folded in registers with nibble-table operators; the
// row's last segment CTA folds the segment remainders.
//
// One CTA per (row, segment) item: a segment's work is a chain of
// latencies (the staging loads, the walk, the tree, the fence and atomic of
// the join), so CTAs that each take one item and overlap on an SM beat
// persistent CTAs that take several in turn (3x slower in the first cut of
// this design). Blocks run from every row's last segment backwards, so the
// segments that hold bytes come first; a block before a short message reads
// one length and exits before it loads the tables.
//
// Two row sets: rows [0, n_a) come from `rows_a` and rows [n_a, n_a + n_b)
// from `rows_b`, each with optional lengths (NULL: the whole width), so the
// main path hashes its raw blocks and literal planes in one launch without
// concatenating them. `counters` holds one arrival counter a row, zero
// between calls (the folding CTA sets its counter back to 0); `partials`
// holds n_seg segment remainders a row.
#include <cuda_runtime.h>

#include <atomic>

#include "crc_common.cuh"

__global__ void __launch_bounds__(CRC_NT) crc_fold_kernel(
    const uint8_t* __restrict__ rows_a, const int* __restrict__ len_a, long long n_a,
    const uint8_t* __restrict__ rows_b, const int* __restrict__ len_b, long long n_b,
    long long width, int n_seg, const uint32_t* __restrict__ tab8,
    const uint32_t* __restrict__ nib, const uint32_t* __restrict__ seg_cols, int* counters,
    int* partials, long long* __restrict__ out) {
  __shared__ __align__(16) unsigned long long s_stage[CRC_STAGE_WORDS];
  __shared__ __align__(16) uint32_t s_tab8[8 * 256];
  __shared__ __align__(16) uint32_t s_nib[CRC_NIB_WORDS];
  __shared__ uint32_t s_red[CRC_NT / 32 + 3];  // the tree's, then the join's 2
  const CrcSmem sm{s_stage, s_tab8, s_nib, s_red};
  const long long n_rows = n_a + n_b;
  const long long row = blockIdx.x % n_rows;
  const int seg = n_seg - 1 - (int)(blockIdx.x / n_rows);
  const bool in_a = row < n_a;
  const int* lens = in_a ? len_a : len_b;
  long long len = lens ? (long long)lens[in_a ? row : row - n_a] : width;
  len = len < 0 ? 0 : (len > width ? width : len);
  const long long span = (len + CRC_SEG - 1) / CRC_SEG;
  const int expected = span > 1 ? (int)span : 1;  // an empty message: its last segment
  if (seg < n_seg - expected) return;
  crc_load_tables(tab8, nib, sm);
  __syncthreads();
  const uint8_t* base = in_a ? rows_a + row * width : rows_b + (row - n_a) * width;
  long long lo, hi;
  crc_segment_span(len, seg, n_seg, CRC_SEG, &lo, &hi);
  const uint32_t part = crc_segment_raw(base, lo, hi, sm);
  uint32_t crc;
  if (crc_segments_join(part, partials + row * n_seg, 1, seg, n_seg, expected, counters + row,
                        seg_cols, s_red + CRC_NT / 32 + 1, &crc) &&
      threadIdx.x == 0)
    out[row] = (long long)crc;
}

extern "C" int crc_fold_launch(const void* rows_a, const void* len_a, long long n_a,
                               const void* rows_b, const void* len_b, long long n_b,
                               long long width, int n_seg, const void* tab8, const void* nib,
                               const void* seg_cols, void* counters, void* partials, void* out,
                               void* stream) {
  if (n_a + n_b <= 0) return 0;
  const long long items = (n_a + n_b) * n_seg;
  if (width % 8 != 0 || n_a < 0 || n_b < 0 || n_seg < 1 ||
      (long long)n_seg * CRC_SEG < width || items > (1LL << 31) - 1)
    return (int)cudaErrorInvalidValue;
  // as many CTAs on an SM as its shared memory holds, set once per device
  static std::atomic<bool> carveout_set[64];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  if (!carveout_set[device]) {
    err = cudaFuncSetAttribute(crc_fold_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    carveout_set[device] = true;
  }
  crc_fold_kernel<<<(unsigned)items, CRC_NT, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)rows_a, (const int*)len_a, n_a, (const uint8_t*)rows_b,
      (const int*)len_b, n_b, width, n_seg, (const uint32_t*)tab8, (const uint32_t*)nib,
      (const uint32_t*)seg_cols, (int*)counters, (int*)partials, (long long*)out);
  return (int)cudaGetLastError();
}
