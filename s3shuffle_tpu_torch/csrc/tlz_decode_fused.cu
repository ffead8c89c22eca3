// Kernel K3: fused TLZ v2 decode + literal-plane CRC.
//
// Replaces the JAX package's Pallas kernel _make_decode_fused_kernel
// (s3shuffle_tpu/ops/tlz_pallas.py:230, pl.pallas_call at :345). The
// function is unchanged: each staged row of planes decodes to its G*8 bytes
// (a literal byte is its own source, a match byte copies pos - distance, a
// split byte pos - d_prev below its split point and pos - d_next from it;
// offsets wrap in int32 and clamp into the row, and sources resolve by
// ceil(log2 n_bytes) rounds of pointer jumping), and the raw zero-init CRC
// of the row's first n_lits*8 literal bytes comes back beside it, n_lits
// recomputed from the bitmaps.
//
// Bound on an H100: bytes. The planes, the distances and split points, the
// literal bytes present and the decoded rows each cross device memory once
// (a 64 x 256 KiB TeraSort batch: ~27 MB, 8.0 us at 3.35 TB/s). Beyond that
// this design moves: the count launch's re-read of the bitmaps and
// distances (7 bytes a group, from L2), the per-segment source map (4 bytes
// a byte) and sparse literal plane, which stay in shared memory, and one
// look-back gather per byte whose source lies in an earlier segment, served
// by L2 from the decoded rows.
//
// Three launches on the caller's stream, no host sync:
//
//   1. tlz_decode_count_kernel: one CTA per (row, segment of SEG_GROUPS
//      groups) counts new / split / literal / match groups, flags a
//      negative stored distance, and zeroes the call's state (tickets,
//      ready flags, per-row arrival counters).
//   2. tlz_decode_seg_kernel, the segmented route: one CTA per (row,
//      segment), 1024 CTAs for a 64 x 32768-group batch where the first
//      version ran 64. A CTA takes a ticket from a global counter and maps
//      it segment-major (seg = t / B, row = t % B), so a row's segments get
//      increasing tickets; it only ever waits on smaller tickets, which are
//      running or done, whatever order the hardware starts CTAs in. Its
//      segment's ranks come from the counts of the segments before it. It
//      builds the segment's byte sources (int32 wrap, clamp) and sparse
//      literal bytes in shared memory and resolves in-segment chains by
//      pointer jumping there, in place: on rows whose every source is at or
//      before its position a chain only moves backward, so each step
//      replaces a pointer by a later member of its own chain and the loop
//      ends, in at most ceil(log2 S) + 1 rounds, with every byte at an
//      in-segment root (a literal byte, or a self-pointing byte worth 0) or
//      at one position before the segment. Those bytes are read from the
//      decoded output once the segments that hold them have published.
//      This is exact: a backward chain reaches its root within n - 1 <
//      2^ceil(log2 n) steps, which is where the reference's rounds leave it.
//      Look-back memory order: a segment writes its bytes, every thread
//      runs __threadfence(), the CTA synchronises, and one thread stores
//      its ready flag with release semantics (cuda::atomic_ref, device
//      scope). A waiting CTA polls the flags it needs with acquire loads,
//      synchronises, and reads the published bytes with ld.global.cg
//      (__ldcg), never through L1 or a read-only path.
//      Every CTA also takes the zero-init CRC of its S-byte slice of the
//      row's literal plane placed right-aligned in a virtual window of
//      n_seg * S bytes (leading zeros leave a zero-init CRC at 0), and the
//      last CTA of the row to arrive (a per-row atomic counter) folds the
//      slices with the operators A^(8*S*j): the segment CRC that kernel K1
//      runs on every row (crc_common.cuh, crc_segment_raw and
//      crc_segments_join). No CTA walks the whole plane.
//   3. tlz_decode_general_kernel, the general route: rows with a negative
//      stored distance (the only rows that can hold forward pointers,
//      cycles or int32 wraps; the parser never stages one) are decoded by
//      one CTA each with whole-row pointer jumping over a global int32 map
//      (one of gen_slots slots, reused row after row), with the exact early
//      exit. The segmented route leaves these rows' bytes alone and lists
//      them; every CTA of this launch returns at once when the list is
//      empty, as on the main path. Jumping runs in place: after r rounds
//      each pointer has advanced at least 2^r steps along its chain
//      whatever the interleaving, so after the reference's R rounds every
//      byte sits on the terminal cycle of its chain, as in the reference; a
//      cycle longer than one holds only non-literal bytes (worth 0), so the
//      decoded value is the reference's. The sparse literal plane is staged
//      in the output row itself, and the final gather reads it in place
//      (each gathered position keeps its value). A device counter adds one
//      per row decoded here.
//
// Segment size and occupancy: S = 16 KiB (2048 groups). The source map
// (64 KiB, reused to stage the CRC slice), sparse bytes (16 KiB), group
// distances and kinds (10 KiB) and the CRC tables (11.5 KiB) take 103,952
// bytes of dynamic shared memory, so two CTAs of 512 threads fit an SM's 228 KB
// (__launch_bounds__(512, 2): at most 64 registers a thread; the build
// reports 64 and no spills) and 1024 CTAs run in ~4 waves on 132 SMs; the
// in-segment jumping takes at most 15 rounds. A larger S would halve the
// CTAs an SM holds, a smaller one would lengthen each row's look-back
// chain. The count kernel uses 32 registers, the general kernel 40 (a
// 4-byte spill; it runs only on corrupt rows). chip_smoke.py prints the
// -Xptxas -v summary.
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <cuda/atomic>

#include "crc_common.cuh"

#define TLZ_GROUP 8
#define SEG_GROUPS 2048
#define SEG_BYTES (SEG_GROUPS * TLZ_GROUP)
#define DEC_NT 512  // threads of the segment and general CTAs
#define DEC_WARPS (DEC_NT / 32)
#define COUNT_NT 256

// call state (int32 words): [ticket, general rows listed, 2 spare]
// [row arrivals: B] [general row list: B] [records: B x n_seg x REC_WORDS]
#define ST_HEADER 4
#define REC_WORDS 8
enum { R_NEW = 0, R_SPLIT, R_LIT, R_MATCH, R_NEG, R_READY, R_PARTIAL };

// dynamic shared memory of the segment CTA
#define SM_SRC 0                                        // int32 x SEG_BYTES
#define SM_VAL (SM_SRC + 4 * SEG_BYTES)                 // uint8 x SEG_BYTES
#define SM_DIST (SM_VAL + SEG_BYTES)                    // int32 x (SEG_GROUPS + 2)
#define SM_KIND (SM_DIST + 4 * (SEG_GROUPS + 4))        // uint8 x SEG_GROUPS
#define SM_TAB8 (SM_KIND + SEG_GROUPS)                  // uint32 x 8 x 256
#define SM_NIB (SM_TAB8 + 4 * 8 * 256)                  // uint32 x CRC_NIB_WORDS
#define SEG_SMEM (SM_NIB + 4 * CRC_NIB_WORDS)
// the CRC's staging and tree words reuse the source map once it is dead
#define SM_CRC_RED (SM_SRC + 8 * CRC_STAGE_WORDS)

typedef cuda::atomic_ref<int, cuda::thread_scope_device> dev_flag;

struct CallState {
  int* ticket;
  int* gen_n;
  int* row_done;
  int* gen_rows;
  int* rec;
};

static __device__ __forceinline__ CallState call_state(int* state, long long n_rows) {
  CallState s;
  s.ticket = state;
  s.gen_n = state + 1;
  s.row_done = state + ST_HEADER;
  s.gen_rows = s.row_done + n_rows;
  s.rec = s.gen_rows + n_rows;
  return s;
}

static __device__ __forceinline__ int* record(const CallState& s, long long row, int seg,
                                              int n_seg) {
  return s.rec + (row * n_seg + seg) * REC_WORDS;
}

// Source of byte p at stored distance d: int32 wraparound as the
// reference computes it, then clamped into [0, n_bytes - 1].
static __device__ __forceinline__ int clamped_source(long long p, int d, long long n_bytes) {
  const int q = (int)((uint32_t)p - (uint32_t)d);
  return q < 0 ? 0 : (q > n_bytes - 1 ? (int)(n_bytes - 1) : q);
}

template <typename T>
static __device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---------------------------------------------------------------------------
// 1. counts per (row, segment)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(COUNT_NT) tlz_decode_count_kernel(
    const uint8_t* __restrict__ m_in, const uint8_t* __restrict__ c_in,
    const uint8_t* __restrict__ s_in, const int* __restrict__ offs, long long n_rows,
    long long n_groups, int seg_groups, int n_seg, int* state) {
  __shared__ int s_part[COUNT_NT / 32][5];
  const int t = threadIdx.x;
  const long long row = blockIdx.x % n_rows;
  const int seg = (int)(blockIdx.x / n_rows);
  const long long g0 = (long long)seg * seg_groups;
  const long long g1 = g0 + seg_groups < n_groups ? g0 + seg_groups : n_groups;
  const long long base = row * n_groups;
  int c_new = 0, c_split = 0, c_lit = 0, c_match = 0, neg = 0;
  for (long long g = g0 + t; g < g1; g += COUNT_NT) {
    const bool m = m_in[base + g] != 0, c = c_in[base + g] != 0, s = s_in[base + g] != 0;
    c_new += m && !c;
    c_split += s;
    c_lit += !m && !s;
    c_match += m;
    neg |= offs[base + g] < 0;
  }
  c_new = warp_sum(c_new);
  c_split = warp_sum(c_split);
  c_lit = warp_sum(c_lit);
  c_match = warp_sum(c_match);
  neg = warp_sum(neg);
  if ((t & 31) == 0) {
    s_part[t >> 5][0] = c_new;
    s_part[t >> 5][1] = c_split;
    s_part[t >> 5][2] = c_lit;
    s_part[t >> 5][3] = c_match;
    s_part[t >> 5][4] = neg;
  }
  __syncthreads();
  if (t < 5) {
    int v = 0;
    for (int w = 0; w < COUNT_NT / 32; ++w) v += s_part[w][t];
    CallState st = call_state(state, n_rows);
    int* rec = record(st, row, seg, n_seg);
    rec[t] = t == R_NEG ? (v != 0) : v;
    if (t == 0) {
      rec[R_READY] = 0;
      rec[R_PARTIAL] = 0;
      if (seg == 0) st.row_done[row] = 0;
      if (blockIdx.x == 0) {
        *st.ticket = 0;
        *st.gen_n = 0;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 2. the segmented route (+ every row's literal-plane CRC)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(DEC_NT, 2) tlz_decode_seg_kernel(
    const uint8_t* __restrict__ m_in, const uint8_t* __restrict__ c_in,
    const uint8_t* __restrict__ s_in, const int* __restrict__ offs,
    const int* __restrict__ ks_in, const uint8_t* __restrict__ lits, long long n_rows,
    long long n_groups, int seg_groups, int n_seg,
    const uint32_t* __restrict__ tab8, const uint32_t* __restrict__ nib,
    const uint32_t* __restrict__ seg_cols, int* state,
    uint8_t* dec,  // written here and read back by other CTAs: no __restrict__
    long long* __restrict__ crc_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_src = reinterpret_cast<int*>(smem + SM_SRC);
  uint8_t* s_val = smem + SM_VAL;
  int* s_dist = reinterpret_cast<int*>(smem + SM_DIST);  // [0] d_prev, [1 + g], [ng + 1] d_next
  uint8_t* s_kind = smem + SM_KIND;  // bit 0 match, bit 1 split, bits 4-7 split point in [0, 8]
  const CrcSmem crc_sm{reinterpret_cast<unsigned long long*>(smem + SM_SRC),
                       reinterpret_cast<uint32_t*>(smem + SM_TAB8),
                       reinterpret_cast<uint32_t*>(smem + SM_NIB),
                       reinterpret_cast<uint32_t*>(smem + SM_CRC_RED)};
  __shared__ int s_ticket, s_min;
  __shared__ int s_row[6];  // new / split / lit before the segment; match, split totals; negative
  __shared__ int s_wsum[3][DEC_WARPS];
  __shared__ uint32_t s_join[2];

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const CallState st = call_state(state, n_rows);
  if (t == 0) s_ticket = atomicAdd(st.ticket, 1);
  crc_load_tables(tab8, nib, crc_sm);
  __syncthreads();
  const int seg = (int)(s_ticket / n_rows);
  const long long row = s_ticket % n_rows;

  if (warp == 0) {  // the row as the count launch saw it
    int b_new = 0, b_split = 0, b_lit = 0, n_match = 0, n_split = 0, neg = 0;
    for (int j = lane; j < n_seg; j += 32) {
      const int* rec = record(st, row, j, n_seg);
      if (j < seg) {
        b_new += rec[R_NEW];
        b_split += rec[R_SPLIT];
        b_lit += rec[R_LIT];
      }
      n_match += rec[R_MATCH];
      n_split += rec[R_SPLIT];
      neg |= rec[R_NEG];
    }
    b_new = warp_sum(b_new);
    b_split = warp_sum(b_split);
    b_lit = warp_sum(b_lit);
    n_match = warp_sum(n_match);
    n_split = warp_sum(n_split);
    neg = warp_sum(neg);
    if (lane == 0) {
      s_row[0] = b_new;
      s_row[1] = b_split;
      s_row[2] = b_lit;
      s_row[3] = n_match;
      s_row[4] = n_split;
      s_row[5] = neg;
    }
  }
  __syncthreads();

  const long long n_bytes = n_groups * TLZ_GROUP;
  const int seg_bytes = seg_groups * TLZ_GROUP;
  const long long g0 = (long long)seg * seg_groups;
  const int ng = (int)(g0 + seg_groups < n_groups ? seg_groups : n_groups - g0);
  const int nb = ng * TLZ_GROUP;
  const int p0 = (int)(g0 * TLZ_GROUP);
  const long long gbase = row * n_groups;
  const uint8_t* lrow = lits + row * n_bytes;

  if (s_row[5] == 0) {
    const uint8_t* mr = m_in + gbase;
    const uint8_t* cr = c_in + gbase;
    const uint8_t* sr = s_in + gbase;
    const int* orow = offs + gbase;
    const int* krow = ks_in + gbase;
    // ---- per group: ranks (ballots within a warp, warp sums across), the
    // group's distance, kind and split point, its literal bytes ----
    int carry_new = s_row[0], carry_split = s_row[1], carry_lit = s_row[2];
    const unsigned below = (1u << lane) - 1u;
    for (int base = 0; base < ng; base += DEC_NT) {
      const int gl = base + t;
      const bool in = gl < ng;
      bool m = false, c = false, s = false;
      if (in) {
        m = mr[g0 + gl] != 0;
        c = cr[g0 + gl] != 0;
        s = sr[g0 + gl] != 0;
      }
      const bool is_new = m && !c;
      const bool is_lit = in && !m && !s;
      const unsigned b_new = __ballot_sync(0xffffffffu, is_new);
      const unsigned b_split = __ballot_sync(0xffffffffu, s);
      const unsigned b_lit = __ballot_sync(0xffffffffu, is_lit);
      if (lane == 0) {
        s_wsum[0][warp] = __popc(b_new);
        s_wsum[1][warp] = __popc(b_split);
        s_wsum[2][warp] = __popc(b_lit);
      }
      __syncthreads();
      int r_new = carry_new + __popc(b_new & below);
      int r_split = carry_split + __popc(b_split & below);
      int r_lit = carry_lit + __popc(b_lit & below);
      for (int w = 0; w < DEC_WARPS; ++w) {
        const int a = s_wsum[0][w], b = s_wsum[1][w], d = s_wsum[2][w];
        if (w < warp) {
          r_new += a;
          r_split += b;
          r_lit += d;
        }
        carry_new += a;
        carry_split += b;
        carry_lit += d;
      }
      __syncthreads();  // s_wsum is rewritten by the next chunk
      if (in) {
        // rank = inclusive count - 1 (clamped at 0, as the reference gathers)
        const int nr = r_new + is_new - 1;
        s_dist[gl + 1] = orow[nr > 0 ? nr : 0];
        int kc = 0;
        if (s) {
          const int k = krow[r_split];
          kc = k < 0 ? 0 : (k > TLZ_GROUP ? TLZ_GROUP : k);
        }
        s_kind[gl] = (uint8_t)((m ? 1 : 0) | (s ? 2 : 0) | (kc << 4));
        uint2 v = make_uint2(0u, 0u);
        if (is_lit) v = *reinterpret_cast<const uint2*>(lrow + (long long)r_lit * TLZ_GROUP);
        *reinterpret_cast<uint2*>(s_val + gl * TLZ_GROUP) = v;
      }
    }
    if (t == 0) {
      // the neighbours' distances: dist_of[g0 - 1] and dist_of[g0 + ng]
      const int rp = s_row[0] - 1;
      s_dist[0] = g0 > 0 ? orow[rp > 0 ? rp : 0] : 0;
      int dn = 0;
      const long long ge = g0 + ng;
      if (ge < n_groups) {
        const int rn = carry_new + (mr[ge] != 0 && cr[ge] == 0) - 1;
        dn = orow[rn > 0 ? rn : 0];
      }
      s_dist[ng + 1] = dn;
      s_min = p0;
    }
    __syncthreads();

    // ---- per byte: the source map ----
    for (int i = t; i < nb; i += DEC_NT) {
      const int gl = i >> 3, j = i & 7;
      const int kind = s_kind[gl];
      const long long p = (long long)p0 + i;
      int q = (int)p;
      if (kind & 2) {
        q = clamped_source(p, j < (kind >> 4) ? s_dist[gl] : s_dist[gl + 2], n_bytes);
      } else if (kind & 1) {
        q = clamped_source(p, s_dist[gl + 1], n_bytes);
      }
      s_src[i] = q;
    }
    __syncthreads();

    // ---- in-segment pointer jumping, in place. Bit k of `open` marks byte
    // t + k * DEC_NT while its source is in the segment and not a root ----
    uint32_t open = 0;
    for (int k = 0; k * DEC_NT + t < nb; ++k) {
      const int i = k * DEC_NT + t;
      const int a = s_src[i];
      if (a >= p0 && a != p0 + i) open |= 1u << k;
    }
    while (__syncthreads_or(open != 0)) {
      uint32_t rest = open;
      while (rest) {
        const int k = __ffs(rest) - 1;
        rest &= rest - 1;
        const int i = k * DEC_NT + t;
        const int a = s_src[i];
        const int b = s_src[a - p0];
        if (b == a) {
          open &= ~(1u << k);  // a is a root
        } else {
          s_src[i] = b;
          if (b < p0) open &= ~(1u << k);
        }
      }
    }

    // ---- look-back: wait for the segments that hold this segment's
    // out-of-segment sources ----
    int lo = p0;
    for (int i = t; i < nb; i += DEC_NT) lo = min(lo, s_src[i]);
    for (int off = 16; off > 0; off >>= 1) lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    if (lane == 0) atomicMin(&s_min, lo);
    __syncthreads();
    if (s_min < p0) {
      for (int j = s_min / seg_bytes + t; j < seg; j += DEC_NT) {
        dev_flag ready(record(st, row, j, n_seg)[R_READY]);
        // the wait is bounded: a segment that never publishes is a fault,
        // reported as a launch failure rather than a hung card
        for (long long spin = 0; ready.load(cuda::std::memory_order_acquire) == 0; ++spin) {
          if (spin > (1LL << 24)) __trap();
          __nanosleep(64);
        }
      }
    }
    __syncthreads();
    uint8_t* drow = dec + row * n_bytes;
    for (int i = t; i < nb; i += DEC_NT) {
      const int a = s_src[i];
      // in place: a root's slot keeps its own value, and no other slot is read
      s_val[i] = a >= p0 ? s_val[a - p0] : __ldcg(drow + a);
    }
    __syncthreads();
    for (int i = t * 8; i < nb; i += DEC_NT * 8)
      *reinterpret_cast<uint2*>(drow + p0 + i) = *reinterpret_cast<const uint2*>(s_val + i);
    __threadfence();
    __syncthreads();
    if (t == 0) {
      dev_flag ready(record(st, row, seg, n_seg)[R_READY]);
      ready.store(1, cuda::std::memory_order_release);
    }
  } else if (seg == 0 && t == 0) {
    st.gen_rows[atomicAdd(st.gen_n, 1)] = (int)row;  // decoded by the general route
  }

  // ---- this segment's slice of the literal-plane CRC ----
  const long long lit_groups = n_groups - s_row[3] - s_row[4];
  const long long lit_len = lit_groups > 0 ? lit_groups * TLZ_GROUP : 0;
  long long lo, hi;
  crc_segment_span(lit_len, seg, n_seg, seg_bytes, &lo, &hi);
  const uint32_t part = crc_segment_raw(lrow, lo, hi, crc_sm);  // the map is dead here
  uint32_t crc;
  if (crc_segments_join(part, record(st, row, 0, n_seg) + R_PARTIAL, REC_WORDS, seg, n_seg,
                        n_seg, st.row_done + row, seg_cols, s_join, &crc) &&
      t == 0)
    crc_out[row] = (long long)crc;
}

// ---------------------------------------------------------------------------
// 3. the general route
// ---------------------------------------------------------------------------

// Inclusive block scan of one int per thread (DEC_NT threads).
static __device__ __forceinline__ int block_scan_incl(int v, int* s_buf) {
  const int t = threadIdx.x;
  s_buf[t] = v;
  __syncthreads();
  for (int off = 1; off < DEC_NT; off <<= 1) {
    const int add = t >= off ? s_buf[t - off] : 0;
    __syncthreads();
    s_buf[t] += add;
    __syncthreads();
  }
  const int r = s_buf[t];
  __syncthreads();
  return r;
}

__global__ void __launch_bounds__(DEC_NT) tlz_decode_general_kernel(
    const uint8_t* __restrict__ m_in, const uint8_t* __restrict__ c_in,
    const uint8_t* __restrict__ s_in, const int* __restrict__ offs,
    const int* __restrict__ ks_in, const uint8_t* __restrict__ lits, long long n_rows,
    long long n_groups, int* state, int* scratch,
    unsigned long long* __restrict__ gen_counter, uint8_t* dec) {
  __shared__ int s_scan[DEC_NT];
  const int t = threadIdx.x;
  const CallState st = call_state(state, n_rows);
  const int n_gen = *st.gen_n;
  const long long n_bytes = n_groups * TLZ_GROUP;
  int* src = scratch + blockIdx.x * n_bytes;
  int rounds = 0;
  while ((1LL << rounds) < (n_bytes > 2 ? n_bytes : 2)) ++rounds;

  for (int li = blockIdx.x; li < n_gen; li += gridDim.x) {
    const long long row = st.gen_rows[li];
    const long long gbase = row * n_groups;
    const uint8_t* mr = m_in + gbase;
    const uint8_t* cr = c_in + gbase;
    const uint8_t* sr = s_in + gbase;
    const int* orow = offs + gbase;
    const int* krow = ks_in + gbase;
    const uint8_t* lrow = lits + row * n_bytes;
    uint8_t* drow = dec + row * n_bytes;

    // ranks over a contiguous range of groups per thread
    const long long per = (n_groups + DEC_NT - 1) / DEC_NT;
    const long long ga = t * per < n_groups ? t * per : n_groups;
    const long long gb = ga + per < n_groups ? ga + per : n_groups;
    int c_new = 0, c_split = 0, c_lit = 0;
    for (long long g = ga; g < gb; ++g) {
      const bool m = mr[g] != 0, c = cr[g] != 0, s = sr[g] != 0;
      c_new += m && !c;
      c_split += s;
      c_lit += !m && !s;
    }
    int new_rank = block_scan_incl(c_new, s_scan) - c_new - 1;  // rank before ga
    int split_rank = block_scan_incl(c_split, s_scan) - c_split - 1;
    int lit_rank = block_scan_incl(c_lit, s_scan) - c_lit - 1;
    int d_prev = ga > 0 ? orow[new_rank > 0 ? new_rank : 0] : 0;  // dist_of[ga - 1]

    // source map into the slot, sparse literal bytes into the output row
    for (long long g = ga; g < gb; ++g) {
      const bool m = mr[g] != 0, s = sr[g] != 0;
      const bool lit = !m && !s;
      new_rank += m && cr[g] == 0;
      split_rank += s;
      lit_rank += lit;
      const int dist = orow[new_rank > 0 ? new_rank : 0];
      int d_next = 0;
      if (g + 1 < n_groups) {
        const int rn = new_rank + (mr[g + 1] != 0 && cr[g + 1] == 0);
        d_next = orow[rn > 0 ? rn : 0];
      }
      const int k = krow[split_rank > 0 ? split_rank : 0];
      const uint8_t* lsrc = lrow + (long long)(lit_rank > 0 ? lit_rank : 0) * TLZ_GROUP;
      for (int j = 0; j < TLZ_GROUP; ++j) {
        const long long p = g * TLZ_GROUP + j;
        int q = (int)p;
        if (s) {
          q = clamped_source(p, j < k ? d_prev : d_next, n_bytes);
        } else if (m) {
          q = clamped_source(p, dist, n_bytes);
        }
        src[p] = q;
        drow[p] = lit ? lsrc[j] : 0;
      }
      d_prev = dist;
    }
    __syncthreads();

    // in-place pointer jumping, at most the reference's rounds
    for (int r = 0; r < rounds; ++r) {
      int changed = 0;
      for (long long p = t; p < n_bytes; p += DEC_NT) {
        const int a = __ldcg(src + p);
        const int b = __ldcg(src + a);
        if (b != a) {
          src[p] = b;
          changed = 1;
        }
      }
      if (!__syncthreads_or(changed)) break;
    }
    // final gather, in place: every gathered position is a fixed point or
    // a cycle member, whose own write leaves its value unchanged
    for (long long p = t; p < n_bytes; p += DEC_NT) drow[p] = __ldcg(drow + __ldcg(src + p));
    __syncthreads();
    if (t == 0) atomicAdd(gen_counter, 1ull);
  }
}

// ---------------------------------------------------------------------------

extern "C" int tlz_decode_fused_launch(const void* m_in, const void* c_in, const void* s_in,
                                       const void* offs, const void* ks, const void* lits,
                                       long long n_rows, long long n_groups,
                                       const void* tab8, const void* nib,
                                       const void* seg_cols, void* state,
                                       long long state_words, void* gen_scratch,
                                       int gen_slots, void* gen_counter, void* dec,
                                       void* crc, void* stream) {
  if (n_rows <= 0 || n_groups <= 0) return 0;
  const long long n_bytes = n_groups * TLZ_GROUP;
  const int seg_groups = (int)(n_groups < SEG_GROUPS ? n_groups : SEG_GROUPS);
  const long long n_seg = (n_groups + seg_groups - 1) / seg_groups;
  if (n_bytes > (1LL << 30) || (long long)seg_groups * TLZ_GROUP > CRC_SEG || gen_slots < 1 ||
      n_seg * n_rows > (1LL << 31) - 1 ||
      state_words < ST_HEADER + 2 * n_rows + REC_WORDS * n_rows * n_seg)
    return (int)cudaErrorInvalidValue;
  // the segment kernel's shared memory attribute, once per device
  static std::atomic<bool> attr_set[64];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  if (!attr_set[device]) {
    err = cudaFuncSetAttribute(tlz_decode_seg_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SEG_SMEM);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(tlz_decode_seg_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    attr_set[device] = true;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned grid = (unsigned)(n_seg * n_rows);
  tlz_decode_count_kernel<<<grid, COUNT_NT, 0, s>>>(
      (const uint8_t*)m_in, (const uint8_t*)c_in, (const uint8_t*)s_in, (const int*)offs,
      n_rows, n_groups, seg_groups, (int)n_seg, (int*)state);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tlz_decode_seg_kernel<<<grid, DEC_NT, SEG_SMEM, s>>>(
      (const uint8_t*)m_in, (const uint8_t*)c_in, (const uint8_t*)s_in, (const int*)offs,
      (const int*)ks, (const uint8_t*)lits, n_rows, n_groups, seg_groups, (int)n_seg,
      (const uint32_t*)tab8, (const uint32_t*)nib, (const uint32_t*)seg_cols, (int*)state,
      (uint8_t*)dec, (long long*)crc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tlz_decode_general_kernel<<<(unsigned)gen_slots, DEC_NT, 0, s>>>(
      (const uint8_t*)m_in, (const uint8_t*)c_in, (const uint8_t*)s_in, (const int*)offs,
      (const int*)ks, (const uint8_t*)lits, n_rows, n_groups, (int*)state,
      (int*)gen_scratch, (unsigned long long*)gen_counter, (uint8_t*)dec);
  return (int)cudaGetLastError();
}
