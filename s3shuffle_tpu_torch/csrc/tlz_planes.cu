// Kernel K2: TLZ v2 encode plane decisions.
//
// Replaces the JAX package's Pallas kernel _make_planes_kernel
// (s3shuffle_tpu/ops/tlz_pallas.py:77), which holds one whole block and a
// dozen (G, 8) intermediates in VMEM per grid step.
//
// The function, exactly as the reference computes it: pass 0 verifies each
// group's candidate (c >= 0, dest - c <= 65535, the 8 bytes at c equal the
// group's); two promotion passes retry each group at its left neighbour's
// distance, each reading only the previous pass's planes; then the
// continuation flag, and the split tier: the suffix of the group that equals
// the bytes at the right neighbour's distance (every source byte clamped
// into the row and required >= 0) gives the split point ks, the prefix equal
// at the left neighbour's distance (clamped into the row) must reach it.
// Out-of-row neighbours are (no match, distance 0).
//
// Bound on an H100: bytes. The rows and candidates are read once, the five
// planes written once (a 64 x 256 KiB batch: 46 MiB, 14.4 us at
// 3.35 TB/s). Besides those the function gathers source windows anywhere
// in the row behind each group; they come from L2 (a 16 MiB batch in a
// 50 MB L2). What this design leaves is latency: a pass or the split tier
// that needs a window its group has not loaded waits an L2 round trip, and
// the warp waits with its slowest lane (PERF.md has the measured split,
// kernel_split.py).
//
// The first design ran one thread per group and loaded the group's own 8
// bytes four times, a source window in each of three passes, and 16 single
// bytes with two-sided clamps in the split tier, in int64, and exchanged the
// passes' planes through shared memory with a CTA barrier after each. Here:
//
// - A warp takes WARP_TILE = 124 consecutive groups of one row, 4 per lane
//   (lanes 0-30); lane 31 takes the four groups around the tile that the
//   passes read (3 left, 1 right). Neighbours' entries move between lanes
//   by shuffles: no shared memory, no barrier, no warp waits on another. (A
//   CTA-wide 1024-group tile with a shared-memory exchange and a barrier
//   per pass was no faster: the barriers are not what holds the kernel
//   back.) A lane loads its 4 candidates in one 16-byte load and its 32
//   bytes in two.
// - Each group keeps the last source window it loaded (position and 8
//   bytes) in registers and reuses it when a later pass or the split tier
//   asks for the same position; in a run of matches at one distance that
//   is every later ask. A window is two aligned 8-byte loads.
// - The split tier compares words: prefix_run is the count of zero bytes
//   at the low end of (window XOR group), the suffix at the high end. Only
//   a window that crosses the row's start or end takes a byte-by-byte clamped
//   load; source bytes before the row's start are forced unequal for the
//   suffix.
// - A pass's entry is one packed int per group: the distance, or INT_MIN
//   for no match.
// - Indices are int32 within a row (rows < 2^31 bytes, checked by the
//   wrapper); a lane's four planes are stored as one 4-byte store per bool
//   plane and one 16-byte store per int32 plane.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#define TLZ_GROUP 8
#define TLZ_MAX_DIST 65535
#define GPT 4                   // groups per lane
#define WARP_TILE (GPT * 31)    // groups per warp; lane 31 takes the halo
#define PLANES_WARPS 8          // warps per CTA
#define NO_MATCH INT_MIN
#define FULL_MASK 0xffffffffu

typedef unsigned long long u64;

static __device__ __forceinline__ u64 ld8(const uint8_t* p) {
  return __ldg(reinterpret_cast<const u64*>(p));
}

// The 8 bytes at row position s, each position clamped into [0, n - 1] as
// the reference's gathers clamp (little endian: byte j in bits 8j..8j+7).
static __device__ u64 window(const uint8_t* __restrict__ rb, int s, int n) {
  if (s >= 0 && s <= n - TLZ_GROUP) {
    const int a = s & ~7, sh = (s & 7) * 8;
    const u64 lo = ld8(rb + a);
    return sh ? (lo >> sh) | (ld8(rb + a + 8) << (64 - sh)) : lo;
  }
  u64 w = 0;
  for (int j = 0; j < TLZ_GROUP; ++j) {
    const long long i = (long long)s + j;
    w |= (u64)rb[i < 0 ? 0 : (i > n - 1 ? n - 1 : i)] << (8 * j);
  }
  return w;
}

// A group's state across the passes: its bytes and the last source window
// it loaded, with its position.
struct Group {
  u64 bytes;
  u64 win;
  int win_at;
};

static __device__ __forceinline__ u64 window_of(Group& g, const uint8_t* __restrict__ rb,
                                                long long s, int n) {
  // every position at or below -8 (at or above n) reads the same clamped
  // window, so the key fits an int
  const int at = (int)(s < -TLZ_GROUP ? -TLZ_GROUP : (s > n ? n : s));
  if (at != g.win_at) {
    g.win = window(rb, at, n);
    g.win_at = at;
  }
  return g.win;
}

// pass 0: the candidate at c, packed (distance, or NO_MATCH)
static __device__ __forceinline__ int verify(Group& g, int dest, int c,
                                             const uint8_t* __restrict__ rb, int n) {
  if (c < 0) return NO_MATCH;
  const int dist = dest - c;  // dest >= 0 and c >= 0: no overflow
  if (dist > TLZ_MAX_DIST) return NO_MATCH;
  return window_of(g, rb, c, n) == g.bytes ? dist : NO_MATCH;
}

// a promotion pass: retry at the left neighbour's distance `pv` of the
// previous pass; keep the group's own previous entry `own` otherwise
static __device__ __forceinline__ int promote(Group& g, int dest, int pv, int own,
                                              const uint8_t* __restrict__ rb, int n) {
  if (pv > 0) {  // a match at a positive distance (NO_MATCH is negative)
    const int s = dest - pv;
    if (window_of(g, rb, s < 0 ? 0 : s, n) == g.bytes) return pv;
  }
  return own;
}

// The final planes of one group from its pass-2 entry and its neighbours':
// bit 0 match, bit 1 continuation, bit 2 split; *dist and *ks.
static __device__ __forceinline__ int decide(Group& g, int dest, int v, int pv, int nv,
                                             const uint8_t* __restrict__ rb, int n, int* dist,
                                             int* ks) {
  const bool m = v != NO_MATCH, pm = pv != NO_MATCH, nm = nv != NO_MATCH;
  const int d = m ? v : 0, pd = pm ? pv : 0, nd = nm ? nv : 0;
  const bool cont = m && pm && d == pd;
  int suffix = TLZ_GROUP;  // nd == 0: every source byte is the byte itself
  if (nd != 0) {
    const long long s = (long long)dest - nd;
    u64 x = window_of(g, rb, s, n) ^ g.bytes;
    if (s < 0) {  // bytes whose source lies before the row are unequal
      const long long before = -s < TLZ_GROUP ? -s : TLZ_GROUP;
      x |= 0x0101010101010101ULL & (before == TLZ_GROUP ? ~0ULL : (1ULL << (8 * before)) - 1);
    }
    suffix = x ? __clzll(x) >> 3 : TLZ_GROUP;
  }
  const int k = TLZ_GROUP - suffix;
  bool split = false;
  if (!m && pm && nm && pd > 0 && nd > 0 && k >= 1 && k <= TLZ_GROUP - 1) {
    const u64 x = window_of(g, rb, (long long)dest - pd, n) ^ g.bytes;
    const int prefix = x ? (__ffsll((long long)x) - 1) >> 3 : TLZ_GROUP;
    split = k <= prefix;
  }
  *dist = d;
  *ks = k;
  return (m ? 1 : 0) | (cont ? 2 : 0) | (split ? 4 : 0);
}

__global__ void __launch_bounds__(32 * PLANES_WARPS) tlz_planes_kernel(
    const uint8_t* __restrict__ buf, const int* __restrict__ cand, int n_groups, int tiles,
    long long n_warps, uint8_t* __restrict__ m_out, uint8_t* __restrict__ c_out,
    uint8_t* __restrict__ s_out, int* __restrict__ d_out, int* __restrict__ k_out) {
  const long long wid = (long long)blockIdx.x * PLANES_WARPS + (threadIdx.x >> 5);
  if (wid >= n_warps) return;  // a whole warp: no lane is left to shuffle with
  const int lane = threadIdx.x & 31;
  const int n = n_groups * TLZ_GROUP;
  const long long row = wid / tiles;
  const int a = (int)(wid % tiles) * WARP_TILE;  // the tile's first group
  const uint8_t* rb = buf + row * n;
  const int* cr = cand + row * n_groups;
  // lane L < 31: groups a + 4L .. a + 4L + 3; lane 31: a - 3, a - 2, a - 1
  // and a + WARP_TILE, whose left neighbour is lane 30's last group
  const bool halo = lane == 31;
  const int gfirst = a + GPT * lane;
  const bool tile_lane = !halo && gfirst < n_groups;  // 4 | n_groups: all four or none
  const int src_left = halo ? 30 : (lane == 0 ? 31 : lane - 1);
  const int src_right = lane == 30 ? 31 : (lane + 1) & 31;

  Group grp[GPT];
  int c[GPT], v[GPT], gid[GPT];
  bool in_row[GPT];
#pragma unroll
  for (int k = 0; k < GPT; ++k) {
    gid[k] = halo ? (k < 3 ? a - 3 + k : a + WARP_TILE) : gfirst + k;
    in_row[k] = halo ? gid[k] >= 0 && gid[k] < n_groups : tile_lane;
    grp[k].win_at = INT_MIN;  // below every window position
    grp[k].win = 0;
    grp[k].bytes = 0;
    c[k] = -1;
    v[k] = NO_MATCH;
  }
  if (tile_lane) {
    const int4 cv = *reinterpret_cast<const int4*>(cr + gfirst);
    const uint4 b0 = __ldg(reinterpret_cast<const uint4*>(rb + gfirst * TLZ_GROUP));
    const uint4 b1 = __ldg(reinterpret_cast<const uint4*>(rb + gfirst * TLZ_GROUP + 16));
    c[0] = cv.x, c[1] = cv.y, c[2] = cv.z, c[3] = cv.w;
    grp[0].bytes = b0.x | (u64)b0.y << 32;
    grp[1].bytes = b0.z | (u64)b0.w << 32;
    grp[2].bytes = b1.x | (u64)b1.y << 32;
    grp[3].bytes = b1.z | (u64)b1.w << 32;
  } else if (halo) {
#pragma unroll
    for (int k = 0; k < GPT; ++k) {
      if (in_row[k]) {
        c[k] = cr[gid[k]];
        grp[k].bytes = ld8(rb + gid[k] * TLZ_GROUP);
      }
    }
  }

  // pass 0
#pragma unroll
  for (int k = 0; k < GPT; ++k)
    if (in_row[k]) v[k] = verify(grp[k], gid[k] * TLZ_GROUP, c[k], rb, n);
  // passes 1 and 2, each reading the previous pass's entries: a group's
  // left neighbour is the lane's previous group, or for the lane's first
  // group (and the halo's right group) the neighbouring lane's
#pragma unroll
  for (int pass = 1; pass <= 2; ++pass) {
    const int l3 = __shfl_sync(FULL_MASK, v[3], src_left);
    const int l2 = __shfl_sync(FULL_MASK, v[2], src_left);
    int left = halo ? NO_MATCH : (lane == 0 ? l2 : l3);  // out of the tile: unused
#pragma unroll
    for (int k = 0; k < GPT; ++k) {
      const int own = v[k];
      if (halo && k == GPT - 1) left = l3;
      if (in_row[k]) v[k] = promote(grp[k], gid[k] * TLZ_GROUP, left, own, rb, n);
      left = own;
    }
  }
  const int l3 = __shfl_sync(FULL_MASK, v[3], src_left);
  const int l2 = __shfl_sync(FULL_MASK, v[2], src_left);
  const int r0 = __shfl_sync(FULL_MASK, v[0], src_right);
  const int r3 = __shfl_sync(FULL_MASK, v[3], src_right);
  if (!tile_lane) return;

  // continuation flag + split tier on the tile's groups
  int flags[GPT], dist[GPT], ks[GPT];
  const int pv0 = lane == 0 ? l2 : l3, nv3 = lane == 30 ? r3 : r0;
#pragma unroll
  for (int k = 0; k < GPT; ++k) {
    const int pv = k == 0 ? pv0 : v[k - 1];
    const int nv = k == GPT - 1 ? nv3 : v[k + 1];
    flags[k] = decide(grp[k], gid[k] * TLZ_GROUP, v[k], pv, nv, rb, n, &dist[k], &ks[k]);
  }
  const long long o = row * n_groups + gfirst;
  uint32_t mb = 0, cb = 0, sb = 0;
#pragma unroll
  for (int k = 0; k < GPT; ++k) {
    mb |= (uint32_t)(flags[k] & 1) << (8 * k);
    cb |= (uint32_t)((flags[k] >> 1) & 1) << (8 * k);
    sb |= (uint32_t)((flags[k] >> 2) & 1) << (8 * k);
  }
  *reinterpret_cast<uint32_t*>(m_out + o) = mb;
  *reinterpret_cast<uint32_t*>(c_out + o) = cb;
  *reinterpret_cast<uint32_t*>(s_out + o) = sb;
  *reinterpret_cast<int4*>(d_out + o) = make_int4(dist[0], dist[1], dist[2], dist[3]);
  *reinterpret_cast<int4*>(k_out + o) = make_int4(ks[0], ks[1], ks[2], ks[3]);
}

extern "C" int tlz_planes_launch(const void* buf, const void* cand, long long n_rows,
                                 long long n_groups, void* m_out, void* c_out, void* s_out,
                                 void* d_out, void* k_out, void* stream) {
  if (n_rows <= 0 || n_groups <= 0) return 0;
  if (n_groups % GPT != 0 || n_groups * TLZ_GROUP > INT_MAX) return (int)cudaErrorInvalidValue;
  const long long tiles = (n_groups + WARP_TILE - 1) / WARP_TILE;
  const long long n_warps = tiles * n_rows;
  const long long blocks = (n_warps + PLANES_WARPS - 1) / PLANES_WARPS;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  tlz_planes_kernel<<<(unsigned)blocks, 32 * PLANES_WARPS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)buf, (const int*)cand, (int)n_groups, (int)tiles, n_warps,
      (uint8_t*)m_out, (uint8_t*)c_out, (uint8_t*)s_out, (int*)d_out, (int*)k_out);
  return (int)cudaGetLastError();
}
