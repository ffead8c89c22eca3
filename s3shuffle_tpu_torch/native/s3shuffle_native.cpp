// Native host data-plane library of the PyTorch/CUDA port (CPU).
//
// A copy of the JAX package's s3shuffle_tpu/native/src/s3shuffle_native.cpp:
// the SLZ block codec (frame id 3), the LZ4 block-format codec (frame id 5)
// and the CRC32C / Adler32 helpers, with a C ABI for ctypes. The port keeps
// its own copy so it never loads the JAX package's build; the two produce
// the same frames byte for byte.
//
// Build: on first use by s3shuffle_tpu_torch/codec/native.py, with g++ and
// the flags of s3shuffle_tpu/native/Makefile, into build/native/ at the
// repository root (rebuilt when this file is newer than the library).

#include <cstdint>
#include <cstring>
#include <cstddef>

extern "C" {

// ---------------------------------------------------------------------------
// CRC32C (Castagnoli, reflected 0x82F63B78) — slicing-by-8
// ---------------------------------------------------------------------------

static uint32_t crc32c_table[8][256];
static bool crc32c_init_done = false;

static void crc32c_init() {
    for (int i = 0; i < 256; i++) {
        uint32_t crc = (uint32_t)i;
        for (int j = 0; j < 8; j++)
            crc = (crc & 1) ? (crc >> 1) ^ 0x82F63B78u : crc >> 1;
        crc32c_table[0][i] = crc;
    }
    for (int i = 0; i < 256; i++) {
        uint32_t crc = crc32c_table[0][i];
        for (int t = 1; t < 8; t++) {
            crc = crc32c_table[0][crc & 0xFF] ^ (crc >> 8);
            crc32c_table[t][i] = crc;
        }
    }
    crc32c_init_done = true;
}

#if defined(__x86_64__) && defined(__GNUC__)
// Hardware path: the SSE4.2 crc32 instruction implements exactly the
// Castagnoli polynomial (runtime-dispatched; the tables stay the portable
// fallback). Serial 8-byte feeding runs ~7-20 GB/s vs ~1.5 GB/s for
// slicing-by-8 — this pass runs over every stored byte on both the write
// (partition checksum) and read (validation) planes.
__attribute__((target("sse4.2")))
static uint32_t crc32c_hw(const uint8_t* data, size_t n, uint32_t state) {
    uint64_t c = state;
    while (n >= 8) {
        uint64_t v;
        memcpy(&v, data, 8);
        c = __builtin_ia32_crc32di(c, v);
        data += 8;
        n -= 8;
    }
    uint32_t c32 = (uint32_t)c;
    if (n >= 4) {
        uint32_t v;
        memcpy(&v, data, 4);
        c32 = __builtin_ia32_crc32si(c32, v);
        data += 4;
        n -= 4;
    }
    while (n--) c32 = __builtin_ia32_crc32qi(c32, *data++);
    return c32;
}
#endif

uint32_t slz_crc32c(const uint8_t* data, size_t n, uint32_t prev) {
    uint32_t crc = prev ^ 0xFFFFFFFFu;
#if defined(__x86_64__) && defined(__GNUC__)
    static const bool hw = __builtin_cpu_supports("sse4.2");
    if (hw) return crc32c_hw(data, n, crc) ^ 0xFFFFFFFFu;
#endif
    if (!crc32c_init_done) crc32c_init();
    while (n >= 8) {
        uint32_t lo, hi;
        memcpy(&lo, data, 4);
        memcpy(&hi, data + 4, 4);
        lo ^= crc;
        crc = crc32c_table[7][lo & 0xFF] ^ crc32c_table[6][(lo >> 8) & 0xFF] ^
              crc32c_table[5][(lo >> 16) & 0xFF] ^ crc32c_table[4][lo >> 24] ^
              crc32c_table[3][hi & 0xFF] ^ crc32c_table[2][(hi >> 8) & 0xFF] ^
              crc32c_table[1][(hi >> 16) & 0xFF] ^ crc32c_table[0][hi >> 24];
        data += 8;
        n -= 8;
    }
    while (n--) crc = crc32c_table[0][(crc ^ *data++) & 0xFF] ^ (crc >> 8);
    return crc ^ 0xFFFFFFFFu;
}

// ---------------------------------------------------------------------------
// Adler32 (mod 65521, deferred modulo)
// ---------------------------------------------------------------------------

uint32_t slz_adler32(const uint8_t* data, size_t n, uint32_t prev) {
    const uint32_t MOD = 65521;
    uint32_t a = prev & 0xFFFF, b = (prev >> 16) & 0xFFFF;
    while (n > 0) {
        size_t chunk = n > 5552 ? 5552 : n;  // max bytes before a,b overflow
        n -= chunk;
        for (size_t i = 0; i < chunk; i++) {
            a += *data++;
            b += a;
        }
        a %= MOD;
        b %= MOD;
    }
    return (b << 16) | a;
}

// ---------------------------------------------------------------------------
// SLZ: greedy LZ77 block codec (own wire format)
//
// Block payload = repeated groups:
//   varint L            literal run length
//   L literal bytes
//   u16le offset        (absent after the final literal run)
//   varint M            match length - MIN_MATCH
// A group's offset/match is absent exactly when the literals reach the end of
// the block (decoder knows the uncompressed length from the frame header).
// Max offset 65535; matches may overlap (RLE via offset < length).
// ---------------------------------------------------------------------------

static const size_t MIN_MATCH = 4;
static const uint32_t HASH_BITS = 14;

static inline uint32_t load32(const uint8_t* p) {
    uint32_t v;
    memcpy(&v, p, 4);
    return v;
}

static inline uint64_t load64(const uint8_t* p) {
    uint64_t v;
    memcpy(&v, p, 8);
    return v;
}

// Length of the common prefix of a and b, limited to `limit` bytes.
// 8 bytes per step + count-trailing-zeros on the XOR (little-endian).
static inline size_t match_length(const uint8_t* a, const uint8_t* b, size_t limit) {
    size_t len = 0;
    while (len + 8 <= limit) {
        uint64_t diff = load64(a + len) ^ load64(b + len);
        if (diff) return len + (size_t)(__builtin_ctzll(diff) >> 3);
        len += 8;
    }
    while (len < limit && a[len] == b[len]) len++;
    return len;
}

static inline uint32_t hash4(uint32_t v) {
    return (v * 2654435761u) >> (32 - HASH_BITS);
}

static inline uint8_t* put_varint(uint8_t* p, size_t v) {
    while (v >= 0x80) {
        *p++ = (uint8_t)(v | 0x80);
        v >>= 7;
    }
    *p++ = (uint8_t)v;
    return p;
}

static inline const uint8_t* get_varint(const uint8_t* p, const uint8_t* end, size_t* out) {
    size_t v = 0;
    int shift = 0;
    while (p < end) {
        uint8_t b = *p++;
        v |= (size_t)(b & 0x7F) << shift;
        if (!(b & 0x80)) {
            *out = v;
            return p;
        }
        shift += 7;
        if (shift > 35) break;
    }
    return nullptr;  // malformed
}

// Compress one block. Returns compressed size, or 0 if output would not fit
// in `cap` (caller stores the block raw via the framing escape).
size_t slz_compress(const uint8_t* src, size_t n, uint8_t* dst, size_t cap) {
    if (n == 0) return 0;
    uint32_t table[1u << HASH_BITS];
    memset(table, 0xFF, sizeof(table));  // 0xFFFFFFFF = empty

    const uint8_t* ip = src;
    const uint8_t* anchor = src;
    const uint8_t* iend = src + n;
    const uint8_t* mflimit = (n > MIN_MATCH + 8) ? iend - (MIN_MATCH + 8) : src;
    uint8_t* op = dst;
    uint8_t* oend = dst + cap;

    // LZ4-style skip acceleration: each consecutive miss advances the probe
    // a little further, so incompressible data is skipped at memory speed
    // instead of probing every byte.
    size_t search_accel = 1 << 6;
    while (ip < mflimit) {
        uint32_t h = hash4(load32(ip));
        uint32_t cand = table[h];
        table[h] = (uint32_t)(ip - src);
        if (cand != 0xFFFFFFFFu) {
            const uint8_t* cp = src + cand;
            if ((size_t)(ip - cp) <= 0xFFFF && load32(cp) == load32(ip)) {
                size_t mlen = MIN_MATCH + match_length(ip + MIN_MATCH, cp + MIN_MATCH,
                                                      (size_t)(iend - ip) - MIN_MATCH);
                // Lazy lookahead (cost-checked): a short greedy match often
                // shadows a longer one starting a byte later. Probe ip+1
                // while the current match is short; defer only when the
                // later match nets bytes after paying the extra literal
                // (mlen2 > mlen + 1). Long matches (≥64) skip the probe —
                // the gain is negligible and the probe isn't free.
                while (mlen < 64 && ip + 1 < mflimit &&
                       (size_t)(iend - (ip + 1)) > MIN_MATCH) {
                    uint32_t h2 = hash4(load32(ip + 1));
                    uint32_t cand2 = table[h2];
                    table[h2] = (uint32_t)(ip + 1 - src);
                    if (cand2 == 0xFFFFFFFFu) break;
                    const uint8_t* cp2 = src + cand2;
                    if ((size_t)(ip + 1 - cp2) > 0xFFFF ||
                        load32(cp2) != load32(ip + 1))
                        break;
                    size_t mlen2 =
                        MIN_MATCH + match_length(ip + 1 + MIN_MATCH, cp2 + MIN_MATCH,
                                                 (size_t)(iend - (ip + 1)) - MIN_MATCH);
                    if (mlen2 <= mlen + 1) break;
                    ip += 1;  // the skipped byte joins the literal run
                    cp = cp2;
                    mlen = mlen2;
                }
                size_t llen = (size_t)(ip - anchor);
                // emit: varint L, literals, u16 offset, varint (M - MIN_MATCH)
                if (op + llen + 12 > oend) return 0;
                op = put_varint(op, llen);
                memcpy(op, anchor, llen);
                op += llen;
                uint16_t off = (uint16_t)(ip - cp);
                *op++ = (uint8_t)(off & 0xFF);
                *op++ = (uint8_t)(off >> 8);
                op = put_varint(op, mlen - MIN_MATCH);
                // seed a few positions inside the match (long matches don't
                // need dense coverage; dense seeding dominated the hot loop)
                const uint8_t* seed_end = (ip + mlen < mflimit) ? ip + mlen : mflimit;
                size_t step = mlen <= 32 ? 2 : 8;
                for (const uint8_t* s = ip + 1; s < seed_end; s += step)
                    table[hash4(load32(s))] = (uint32_t)(s - src);
                ip += mlen;
                anchor = ip;
                search_accel = 1 << 6;
                continue;
            }
        }
        ip += (search_accel++ >> 6);
    }
    // final literal run
    size_t llen = (size_t)(iend - anchor);
    if (op + llen + 8 > oend) return 0;
    op = put_varint(op, llen);
    memcpy(op, anchor, llen);
    op += llen;
    return (size_t)(op - dst);
}

// Wild-copy decompressor: same format and validation as slz_decompress, but
// copies run in unconditional 16-byte steps. CONTRACT: src must have ≥16
// readable slack bytes past src+n, and dst ≥16 writable slack past dst+ulen
// (the batch entry point arranges both; per-block slop lands in the next
// block's region or the tail slack). Returns bytes produced, 0 if malformed.
static size_t slz_decompress_wild(const uint8_t* src, size_t n, uint8_t* dst, size_t ulen) {
    const uint8_t* ip = src;
    const uint8_t* iend = src + n;
    uint8_t* op = dst;
    uint8_t* oend = dst + ulen;

    while (ip < iend) {
        size_t llen;
        ip = get_varint(ip, iend, &llen);
        if (!ip || llen > (size_t)(oend - op) || llen > (size_t)(iend - ip)) return 0;
        for (size_t k = 0; k < llen; k += 16) {  // ≤15B slop: covered by slack
            uint64_t a = load64(ip + k), b = load64(ip + k + 8);
            memcpy(op + k, &a, 8);
            memcpy(op + k + 8, &b, 8);
        }
        op += llen;
        ip += llen;
        if (op == oend) break;  // final run, no match follows
        if (ip + 2 > iend) return 0;
        uint16_t off = (uint16_t)(ip[0] | (ip[1] << 8));
        ip += 2;
        size_t mlen;
        ip = get_varint(ip, iend, &mlen);
        if (!ip) return 0;
        mlen += MIN_MATCH;
        if (off == 0 || (size_t)(op - dst) < off || mlen > (size_t)(oend - op)) return 0;
        const uint8_t* match = op - off;
        if (off == 1) {  // RLE: one repeated byte
            memset(op, *match, mlen);
        } else if (off >= 16) {
            for (size_t k = 0; k < mlen; k += 16) {
                uint64_t a = load64(match + k), b = load64(match + k + 8);
                memcpy(op + k, &a, 8);
                memcpy(op + k + 8, &b, 8);
            }
        } else {
            // 2..15-byte period: seed one period, then double from the start
            // of the match output (log2(mlen/off) memcpys, all disjoint)
            size_t w = off < mlen ? off : mlen;
            for (size_t c = 0; c < w; c++) op[c] = match[c];
            while (w < mlen) {
                size_t c = w < mlen - w ? w : mlen - w;
                memcpy(op + w, op, c);
                w += c;
            }
        }
        op += mlen;
    }
    return (size_t)(op - dst);
}

// Decompress one block of known uncompressed size. Returns bytes produced,
// or 0 on malformed input.
size_t slz_decompress(const uint8_t* src, size_t n, uint8_t* dst, size_t ulen) {
    const uint8_t* ip = src;
    const uint8_t* iend = src + n;
    uint8_t* op = dst;
    uint8_t* oend = dst + ulen;

    while (ip < iend) {
        size_t llen;
        ip = get_varint(ip, iend, &llen);
        if (!ip || llen > (size_t)(oend - op) || llen > (size_t)(iend - ip)) return 0;
        memcpy(op, ip, llen);
        op += llen;
        ip += llen;
        if (op == oend) break;  // final run, no match follows
        if (ip + 2 > iend) return 0;
        uint16_t off = (uint16_t)(ip[0] | (ip[1] << 8));
        ip += 2;
        size_t mlen;
        ip = get_varint(ip, iend, &mlen);
        if (!ip) return 0;
        mlen += MIN_MATCH;
        if (off == 0 || (size_t)(op - dst) < off || mlen > (size_t)(oend - op)) return 0;
        const uint8_t* match = op - off;
        if (off >= mlen) {
            memcpy(op, match, mlen);
            op += mlen;
        } else if (off >= 8) {
            // overlapping but ≥8 apart: 8-byte steps are safe
            size_t i = 0;
            for (; i + 8 <= mlen; i += 8) memcpy(op + i, match + i, 8);
            for (; i < mlen; i++) op[i] = match[i];
            op += mlen;
        } else {
            // tight overlap (RLE-style) — byte-wise
            for (size_t i = 0; i < mlen; i++) *op++ = *match++;
        }
    }
    return (size_t)(op - dst);
}

// ---------------------------------------------------------------------------
// LZ4 block format (the public interchange format; spec: token byte with
// literal-length high nibble and matchlength-4 low nibble, 15 ⇒ 255-run
// extension bytes; literals; u16le match offset 1..65535; matches ≥ 4 bytes
// and may overlap). This is the "real LZ4" baseline the north star measures
// against (BASELINE.md: ≥3x lower write CPU vs JVM LZ4 at equal-or-better
// ratio) and an interchange codec: blocks produced here decode with any
// standard LZ4 implementation and vice versa. End-of-block rules honored:
// the last match starts ≥ 12 bytes before the end and never covers the
// final 5 bytes, which are always literals.
// ---------------------------------------------------------------------------

size_t lz4_compress(const uint8_t* src, size_t n, uint8_t* dst, size_t cap) {
    if (n == 0) return 0;
    uint8_t* op = dst;
    uint8_t* oend = dst + cap;
    const uint8_t* ip = src;
    const uint8_t* anchor = src;
    const uint8_t* iend = src + n;
    const uint8_t* mflimit = (n > 12) ? iend - 12 : src;

    uint32_t table[1u << HASH_BITS];
    memset(table, 0xFF, sizeof(table));

    size_t search_accel = 1 << 6;
    while (ip < mflimit) {
        uint32_t h = hash4(load32(ip));
        uint32_t cand = table[h];
        table[h] = (uint32_t)(ip - src);
        if (cand != 0xFFFFFFFFu) {
            const uint8_t* cp = src + cand;
            if ((size_t)(ip - cp) <= 0xFFFF && load32(cp) == load32(ip)) {
                // matches must leave the final 5 bytes as literals
                size_t limit = (size_t)(iend - 5 - ip);
                size_t mlen =
                    MIN_MATCH + match_length(ip + MIN_MATCH, cp + MIN_MATCH,
                                             limit - MIN_MATCH);
                size_t llen = (size_t)(ip - anchor);
                if (op + 1 + llen / 255 + 1 + llen + 2 > oend) return 0;
                uint8_t* token = op++;
                if (llen >= 15) {
                    *token = 15u << 4;
                    size_t rem = llen - 15;
                    while (rem >= 255) { *op++ = 255; rem -= 255; }
                    *op++ = (uint8_t)rem;
                } else {
                    *token = (uint8_t)(llen << 4);
                }
                memcpy(op, anchor, llen);
                op += llen;
                uint16_t off = (uint16_t)(ip - cp);
                *op++ = (uint8_t)(off & 0xFF);
                *op++ = (uint8_t)(off >> 8);
                size_t mcode = mlen - MIN_MATCH;
                if (mcode >= 15) {
                    *token |= 15;
                    mcode -= 15;
                    while (mcode >= 255) {
                        if (op >= oend) return 0;
                        *op++ = 255;
                        mcode -= 255;
                    }
                    if (op >= oend) return 0;
                    *op++ = (uint8_t)mcode;
                } else {
                    *token |= (uint8_t)mcode;
                }
                const uint8_t* seed_end = (ip + mlen < mflimit) ? ip + mlen : mflimit;
                size_t step = mlen <= 32 ? 2 : 8;
                for (const uint8_t* s = ip + 1; s < seed_end; s += step)
                    table[hash4(load32(s))] = (uint32_t)(s - src);
                ip += mlen;
                anchor = ip;
                search_accel = 1 << 6;
                continue;
            }
        }
        ip += (search_accel++ >> 6);
    }
    // final literal run (covers the ≥5 trailing literal bytes rule)
    size_t llen = (size_t)(iend - anchor);
    if (op + 1 + llen / 255 + 1 + llen > oend) return 0;
    uint8_t* token = op++;
    if (llen >= 15) {
        *token = 15u << 4;
        size_t rem = llen - 15;
        while (rem >= 255) { *op++ = 255; rem -= 255; }
        *op++ = (uint8_t)rem;
    } else {
        *token = (uint8_t)(llen << 4);
    }
    memcpy(op, anchor, llen);
    op += llen;
    return (size_t)(op - dst);
}

size_t lz4_decompress(const uint8_t* src, size_t n, uint8_t* dst, size_t ulen) {
    const uint8_t* ip = src;
    const uint8_t* iend = src + n;
    uint8_t* op = dst;
    uint8_t* oend = dst + ulen;

    while (ip < iend) {
        uint8_t token = *ip++;
        size_t llen = token >> 4;
        if (llen == 15) {
            uint8_t b;
            do {
                if (ip >= iend) return 0;
                b = *ip++;
                llen += b;
            } while (b == 255);
        }
        if (llen > (size_t)(iend - ip) || llen > (size_t)(oend - op)) return 0;
        memcpy(op, ip, llen);
        op += llen;
        ip += llen;
        if (ip >= iend) break;  // last sequence: literals only
        if (ip + 2 > iend) return 0;
        size_t off = (size_t)(ip[0] | (ip[1] << 8));
        ip += 2;
        size_t mlen = (size_t)(token & 15);
        if (mlen == 15) {
            uint8_t b;
            do {
                if (ip >= iend) return 0;
                b = *ip++;
                mlen += b;
            } while (b == 255);
        }
        mlen += MIN_MATCH;
        if (off == 0 || (size_t)(op - dst) < off || mlen > (size_t)(oend - op)) return 0;
        const uint8_t* match = op - off;
        if (off >= 8) {
            size_t i = 0;
            for (; i + 8 <= mlen; i += 8) memcpy(op + i, match + i, 8);
            for (; i < mlen; i++) op[i] = match[i];
            op += mlen;
        } else {
            for (size_t i = 0; i < mlen; i++) *op++ = *match++;
        }
    }
    return (size_t)(op - dst);
}

void lz4_compress_batch(const uint8_t* src, const int64_t* src_offsets, int64_t count,
                        uint8_t* dst, const int64_t* dst_offsets, int64_t* out_sizes) {
    for (int64_t i = 0; i < count; i++) {
        size_t n = (size_t)(src_offsets[i + 1] - src_offsets[i]);
        size_t cap = (size_t)(dst_offsets[i + 1] - dst_offsets[i]);
        out_sizes[i] = (int64_t)lz4_compress(src + src_offsets[i], n, dst + dst_offsets[i], cap);
    }
}

void lz4_decompress_batch(const uint8_t* src, const int64_t* src_offsets, int64_t count,
                          uint8_t* dst, const int64_t* dst_offsets, int64_t* out_sizes) {
    for (int64_t i = 0; i < count; i++) {
        size_t n = (size_t)(src_offsets[i + 1] - src_offsets[i]);
        size_t ulen = (size_t)(dst_offsets[i + 1] - dst_offsets[i]);
        out_sizes[i] = (int64_t)lz4_decompress(src + src_offsets[i], n,
                                               dst + dst_offsets[i], ulen);
    }
}

// Framed batch compression with the LZ4 block codec — same contract as
// slz_compress_framed.
int64_t lz4_compress_framed(const uint8_t* src, int64_t count, int64_t block_size,
                            uint8_t codec_id, uint8_t* dst) {
    uint8_t* op = dst;
    for (int64_t i = 0; i < count; i++) {
        const uint8_t* block = src + i * block_size;
        uint8_t* hdr = op;
        op += 9;
        size_t clen = lz4_compress(block, (size_t)block_size, op, (size_t)block_size - 1);
        uint8_t cid = codec_id;
        if (clen == 0) {
            memcpy(op, block, (size_t)block_size);
            clen = (size_t)block_size;
            cid = 0;
        }
        uint32_t ulen32 = (uint32_t)block_size, clen32 = (uint32_t)clen;
        hdr[0] = cid;
        for (int k = 0; k < 4; k++) {
            hdr[1 + k] = (uint8_t)(ulen32 >> (8 * k));
            hdr[5 + k] = (uint8_t)(clen32 >> (8 * k));
        }
        op += clen;
    }
    return (int64_t)(op - dst);
}

// ---------------------------------------------------------------------------
// TLZ v2 group decoder — the CPU host path for tpu-lz frames. The device
// decodes with parallel pointer-jumping gathers; on a sequential CPU the
// same semantics are a plain backward byte-copy per 8-byte group (kind 0 =
// literal, 1 = match at `dists[g]` back, 2 = split: bytes [0,k) copy at
// dists[g] back, bytes [k,8) at d2[g] back). Metadata parsing/validation
// happens in Python (ops/tlz.py); this loop re-checks reach-back bounds so
// corrupt inputs fail closed (-1) instead of reading out of bounds.
// ---------------------------------------------------------------------------

// ---------------------------------------------------------------------------
// TLZ v2 group encoder — the CPU fallback for the TPU codec's write path,
// emitting the same wire planes the device kernel produces (so mixed
// TPU/CPU fleets share one format). Greedy, sequential: a hash table over
// 8-byte windows at every byte position gives nearest-previous candidates;
// the previous group's distance is tried FIRST so continuation runs stay
// aligned for the cont bitmap; failed groups get a one-group-lookahead
// split check (prefix at the left run's distance, suffix at the next
// group's). Outputs: the three bitmaps + dists (u16) + ks (u8) + literal
// plane; counts via the return struct-free out params.
// ---------------------------------------------------------------------------

static const uint32_t TLZ_HASH_BITS = 15;

static inline uint32_t tlz_hash8(uint64_t v) {
    return (uint32_t)((v * 0x9E3779B185EBCA87ull) >> (64 - TLZ_HASH_BITS));
}

static inline void tlz_setbit(uint8_t* bm, int64_t i) {
    bm[i >> 3] |= (uint8_t)(1u << (i & 7));
}

int64_t tlz_encode_block(const uint8_t* src, int64_t n_groups,
                         uint8_t* match_bm, uint8_t* cont_bm, uint8_t* split_bm,
                         uint16_t* dists, int64_t* n_dists,
                         uint8_t* ks, int64_t* n_ks,
                         uint8_t* lits, int64_t* n_lit_groups) {
    // fail closed on oversized blocks: the alloca'd decision arrays below
    // must stay bounded regardless of the caller (the Python wrapper also
    // enforces MAX_BLOCK, but the C ABI cannot rely on it)
    if (n_groups < 0 || n_groups > (int64_t)(1 << 15)) return -1;
    int64_t n_bytes = n_groups * 8;
    int64_t bm_len = (n_groups + 7) / 8;
    memset(match_bm, 0, (size_t)bm_len);
    memset(cont_bm, 0, (size_t)bm_len);
    memset(split_bm, 0, (size_t)bm_len);

    // Candidate table: last position seen per 8-byte-window hash.
    // Deliberately NOT `static thread_local`: in this dlopen'd shared
    // library every access to a dynamic-TLS array goes through
    // __tls_get_addr, and with one table access per INPUT BYTE that
    // measured 5x slower end-to-end (125 vs ~690 MB/s) than a plain
    // stack table. 32768 x int32 = 128 KiB of stack is within every
    // supported default (glibc 8 MiB main / 2 MiB pthread stacks).
    int32_t table[1u << TLZ_HASH_BITS];
    memset(table, 0xFF, sizeof(table));  // all entries -1

    // per-group decisions, one-group lookahead for splits:
    //   kind[g]: 0 literal, 1 match; dist[g] valid for matches
    // (stack arrays sized for the 256 KiB cap = 32768 groups)
    uint16_t* gdist = (uint16_t*)__builtin_alloca((size_t)n_groups * 2);
    uint8_t* gkind = (uint8_t*)__builtin_alloca((size_t)n_groups);

    int64_t seeded = 0;  // table covers windows starting < seeded
    int64_t prev_dist = 0;
    int prev_match = 0;
    for (int64_t g = 0; g < n_groups; g++) {
        int64_t d = g * 8;
        // seed every byte position up to this group's start
        for (; seeded < d && seeded + 8 <= n_bytes; seeded++)
            table[tlz_hash8(load64(src + seeded))] = seeded;
        uint64_t w = load64(src + d);
        int64_t dist = 0;
        if (prev_match && d >= prev_dist && load64(src + d - prev_dist) == w) {
            dist = prev_dist;  // continuation-first keeps runs aligned
        } else {
            int64_t cand = table[tlz_hash8(w)];
            if (cand >= 0 && d - cand <= 0xFFFF && load64(src + cand) == w)
                dist = d - cand;
        }
        if (dist > 0) {
            gkind[g] = 1;
            gdist[g] = (uint16_t)dist;
            prev_dist = dist;
            prev_match = 1;
        } else {
            gkind[g] = 0;
            prev_match = 0;
        }
    }

    // emit planes with split detection between two match groups
    uint16_t* dq = dists;
    uint8_t* kq = ks;
    uint8_t* lp = lits;
    for (int64_t g = 0; g < n_groups; g++) {
        if (gkind[g] == 1) {
            tlz_setbit(match_bm, g);
            if (g > 0 && gkind[g - 1] == 1 && gdist[g] == gdist[g - 1])
                tlz_setbit(cont_bm, g);
            else
                *dq++ = gdist[g];
            continue;
        }
        int64_t d = g * 8;
        if (g > 0 && g + 1 < n_groups && gkind[g - 1] == 1 && gkind[g + 1] == 1) {
            int64_t dp = gdist[g - 1], dn = gdist[g + 1];
            // prefix run at the left distance; earliest suffix start at the
            // right distance. (The right neighbor always consumes a NEW
            // distance entry for the decoder to peek: its predecessor — this
            // split — is not a match, so its cont bit is never set.)
            int pref = 0;
            while (pref < 8 && src[d + pref] == src[d + pref - dp]) pref++;
            int suf = 8;
            while (suf > 0 && d + suf - 1 - dn >= 0 &&
                   src[d + suf - 1] == src[d + suf - 1 - dn])
                suf--;
            if (suf >= 1 && suf <= 7 && suf <= pref && d + suf - dn >= 0) {
                tlz_setbit(split_bm, g);
                *kq++ = (uint8_t)suf;
                continue;
            }
        }
        memcpy(lp, src + d, 8);
        lp += 8;
    }
    *n_dists = dq - dists;
    *n_ks = kq - ks;
    *n_lit_groups = (lp - lits) / 8;
    return 0;
}

// Single-pass variant consuming the PACKED metadata planes directly: walks
// the three bitmaps bit by bit, maintaining the running distance for cont
// elision and peeking the next stored distance for split groups. Strict
// consumption (-1 unless every dists/ks/lits byte is used exactly) makes
// mis-sized planes fail closed without any host-side pre-validation.
int64_t tlz_decode_block(const uint8_t* match_bm, const uint8_t* cont_bm,
                         const uint8_t* split_bm,
                         const uint16_t* dists, int64_t n_dists,
                         const uint8_t* ks, int64_t n_ks,
                         const uint8_t* lits, int64_t n_lit_groups,
                         int64_t n_groups, uint8_t* out) {
    const uint8_t* lp = lits;
    const uint8_t* lend = lits + n_lit_groups * 8;
    const uint16_t* dq = dists;
    const uint16_t* dend = dists + n_dists;
    const uint8_t* kq = ks;
    const uint8_t* kend = ks + n_ks;
    uint8_t* op = out;
    int64_t prev_dist = 0;
    int prev_match = 0;
    for (int64_t g = 0; g < n_groups; g++) {
        int m = (match_bm[g >> 3] >> (g & 7)) & 1;
        int c = (cont_bm[g >> 3] >> (g & 7)) & 1;
        int sp = (split_bm[g >> 3] >> (g & 7)) & 1;
        int64_t produced = op - out;
        if (m) {
            if (sp) return -1;  // split flag on a match group
            int64_t d;
            if (c) {
                if (!prev_match) return -1;
                d = prev_dist;
            } else {
                if (dq >= dend) return -1;
                d = *dq++;
            }
            if (d == 0 || d > produced) return -1;
            const uint8_t* srcp = op - d;
            for (int j = 0; j < 8; j++) op[j] = srcp[j];  // overlap-safe
            prev_dist = d;
            prev_match = 1;
        } else if (sp) {
            if (c) return -1;  // cont flag on a non-match group
            if (!prev_match || g + 1 >= n_groups) return -1;
            int nm = (match_bm[(g + 1) >> 3] >> ((g + 1) & 7)) & 1;
            int nc = (cont_bm[(g + 1) >> 3] >> ((g + 1) & 7)) & 1;
            if (!nm || nc) return -1;  // right neighbor must be a NEW match
            if (dq >= dend || kq >= kend) return -1;
            int64_t dn = *dq;  // peeked — the next match consumes it
            int k = *kq++;
            int64_t dp = prev_dist;
            if (k < 1 || k > 7 || dn == 0 || dp > produced || dn > produced + k)
                return -1;
            for (int j = 0; j < k; j++) op[j] = op[j - dp];
            for (int j = k; j < 8; j++) op[j] = op[j - dn];
            prev_match = 0;
        } else {
            if (c) return -1;
            if (lp + 8 > lend) return -1;
            memcpy(op, lp, 8);
            lp += 8;
            prev_match = 0;
        }
        op += 8;
    }
    if (lp != lend || dq != dend || kq != kend) return -1;
    return op - out;
}

// ---------------------------------------------------------------------------
// Batch entry points (one call per frame batch → fewer ctypes crossings)
// ---------------------------------------------------------------------------

// srcs/dsts are concatenated buffers with offset arrays (int64).
void slz_crc32c_batch(const uint8_t* data, const int64_t* offsets, int64_t count,
                      uint32_t* out) {
    for (int64_t i = 0; i < count; i++) {
        out[i] = slz_crc32c(data + offsets[i], (size_t)(offsets[i + 1] - offsets[i]), 0);
    }
}

// ---------------------------------------------------------------------------
// CRC32C stitching: crc(A || B) from crc(A), crc(B) and len(B). The
// init and final xor cancel, so crc(A || B) = x^(8 len(B)) · crc(A) ⊕ crc(B)
// in GF(2)[x] mod P (reflected bit order: x^0 is bit 31), as zlib's
// crc32_combine computes it.
// ---------------------------------------------------------------------------

static uint32_t crc32c_mulmod(uint32_t a, uint32_t b) {
    // a · b mod P; a is never 0 here (a power of x)
    uint32_t m = 1u << 31, p = 0;
    for (;;) {
        if (a & m) {
            p ^= b;
            if ((a & (m - 1)) == 0) break;
        }
        m >>= 1;
        b = (b & 1) ? (b >> 1) ^ 0x82F63B78u : b >> 1;
    }
    return p;
}

struct Crc32cPow2 {
    // x^(2^k) mod P for every k a 64-bit byte count reaches (3 + 63); the
    // powers do not repeat with period 32 under this polynomial
    uint32_t x2n[67];
    Crc32cPow2() {
        uint32_t p = 1u << 30;  // x^1
        x2n[0] = p;
        for (int k = 1; k < 67; k++) x2n[k] = p = crc32c_mulmod(p, p);
    }
};

static uint32_t crc32c_combine(uint32_t crc1, uint32_t crc2, int64_t len2) {
    static const Crc32cPow2 pow2;  // thread-safe one-time init
    uint32_t p = 1u << 31;  // x^0
    uint64_t n = (uint64_t)len2;
    for (int k = 3; n; n >>= 1, k++)  // x^(8 n) = product of x^(2^k), k from 3
        if (n & 1) p = crc32c_mulmod(pow2.x2n[k], p);
    return crc32c_mulmod(p, crc1) ^ crc2;
}

// Stored-byte CRC32C of `count` rows, row i being head_i || prefix_i || tail_i:
// head_i is bytes [i * head_len, (i + 1) * head_len) of `heads` (head_len may
// be 0), prefix_i the first prefix_lens[i] bytes at prefixes[i] (prefixes
// may be NULL: no prefixes), and tail_i is known only by its CRC32C
// tail_crcs[i] and length tail_lens[i] (a kernel's CRC of a literal plane or
// of a raw block). One call per launch batch; ctypes releases the GIL for it.
void slz_crc32c_stitch_batch(const uint8_t* heads, int64_t head_len,
                             const uint8_t* const* prefixes, const int64_t* prefix_lens,
                             const uint32_t* tail_crcs, const int64_t* tail_lens,
                             int64_t count, uint32_t* out) {
    for (int64_t i = 0; i < count; i++) {
        uint32_t crc = 0;
        if (head_len > 0) crc = slz_crc32c(heads + i * head_len, (size_t)head_len, 0);
        if (prefixes != nullptr && prefix_lens[i] > 0)
            crc = slz_crc32c(prefixes[i], (size_t)prefix_lens[i], crc);
        out[i] = crc32c_combine(crc, tail_crcs[i], tail_lens[i]);
    }
}

// ---------------------------------------------------------------------------
// TLZ v2 plane validation: accepts or rejects each row exactly as
// ops/tlz.py::_validate_planes_v2 does (that function raises on the rows
// rejected here, with its message). Not tlz_decode_block's rules, which
// accept another set: here a continuation takes the distance of the last
// new match before it, across non-match groups, and a split's right
// neighbour may be a continuation.
//
// Row r's planes are the unpacked 0/1 bytes is_match / is_cont / is_split
// [r * n_groups, (r + 1) * n_groups); its n_dists[r] stored distances at
// dists[r] and its n_ks[r] split points at ks[r], one per split group (the
// parser guarantees it; another count rejects the row). ok[r] = 1 accepts.
// ---------------------------------------------------------------------------

static int tlz_planes_v2_ok(const uint8_t* m, const uint8_t* c, const uint8_t* s,
                            int64_t n_groups, const int64_t* d, int64_t nd,
                            const uint8_t* ks, int64_t nk) {
    // rank: cumsum(is_new) - 1 at group g; a match's distance is
    // d[clip(rank, 0, nd - 1)] (the numpy expansion's clip)
    int64_t rank = -1, n_split = 0;
    for (int64_t g = 0; g < n_groups; g++) {
        if (m[g]) {
            if (!c[g]) rank++;
            if (rank < 0 || nd == 0) return 0;  // continuation run has no leader
            int64_t dist = d[rank < nd ? rank : nd - 1];
            if (dist < 1 || g * 8 - dist < 0) return 0;  // source distance out of range
        }
        if (s[g]) {
            if (g == 0 || g == n_groups - 1) return 0;  // split group at block edge
            if (!m[g - 1] || !m[g + 1]) return 0;       // without match neighbours
            if (n_split >= nk) return 0;
            int64_t k = ks[n_split++];
            if (k < 1 || k > 7) return 0;  // split point out of range
            // the right neighbour is a match, so nd > 0 (else it rejects above
            // once reached); its rank is this one plus its own newness
            if (nd == 0) return 0;
            int64_t r1 = rank + ((m[g + 1] && !c[g + 1]) ? 1 : 0);
            int64_t d_next = d[r1 < 0 ? 0 : (r1 < nd ? r1 : nd - 1)];
            if (g * 8 + k - d_next < 0) return 0;  // split suffix distance out of range
        }
    }
    return n_split == nk;
}

void tlz_validate_v2_batch(const uint8_t* is_match, const uint8_t* is_cont,
                           const uint8_t* is_split, int64_t n_groups,
                           const int64_t* const* dists, const int64_t* n_dists,
                           const uint8_t* const* ks, const int64_t* n_ks,
                           int64_t rows, uint8_t* ok) {
    for (int64_t r = 0; r < rows; r++) {
        int64_t off = r * n_groups;
        ok[r] = (uint8_t)tlz_planes_v2_ok(is_match + off, is_cont + off, is_split + off,
                                          n_groups, dists[r], n_dists[r], ks[r], n_ks[r]);
    }
}

void slz_compress_batch(const uint8_t* src, const int64_t* src_offsets, int64_t count,
                        uint8_t* dst, const int64_t* dst_offsets, int64_t* out_sizes) {
    for (int64_t i = 0; i < count; i++) {
        size_t n = (size_t)(src_offsets[i + 1] - src_offsets[i]);
        size_t cap = (size_t)(dst_offsets[i + 1] - dst_offsets[i]);
        out_sizes[i] = (int64_t)slz_compress(src + src_offsets[i], n, dst + dst_offsets[i], cap);
    }
}

// Batch decompress with the wild-copy decoder. CONTRACT: the src buffer has
// ≥16 readable bytes past src_offsets[count], and dst ≥16 writable bytes past
// dst_offsets[count] (per-block write slop lands in the next block's region,
// which is written afterwards in order, or in the tail slack).
void slz_decompress_batch(const uint8_t* src, const int64_t* src_offsets, int64_t count,
                          uint8_t* dst, const int64_t* dst_offsets, int64_t* out_sizes) {
    for (int64_t i = 0; i < count; i++) {
        size_t n = (size_t)(src_offsets[i + 1] - src_offsets[i]);
        size_t ulen = (size_t)(dst_offsets[i + 1] - dst_offsets[i]);
        out_sizes[i] = (int64_t)slz_decompress_wild(src + src_offsets[i], n,
                                                    dst + dst_offsets[i], ulen);
    }
}

// Ragged row gather for the columnar record plane: dst receives rows
// idx[0..n) of a ragged byte buffer (row i at src+offsets[i], length
// lens[i]), concatenated. One memcpy per row — numpy fancy indexing costs
// 8 bytes of int64 index per gathered byte; this costs nothing.
//
// Rows of ≤16 bytes (short keys dominate shuffle workloads) are copied as two
// unconditional 8-byte loads/stores when both buffers have ≥16 bytes of slack
// — a predictable branch instead of a variable-length memcpy call per row.
// src_size/dst_size bound the slack check; dst may be over-allocated.
// Gathers are memory-LATENCY bound (each row touches 1-2 cold cache lines in
// a large buffer); prefetching the source rows a few iterations ahead
// overlaps those misses.
static const int64_t GATHER_PF = 8;

void slz_ragged_gather(const uint8_t* src, size_t src_size, const int64_t* offsets,
                       const int32_t* lens, const int64_t* idx, int64_t n,
                       uint8_t* dst, size_t dst_size) {
    uint8_t* op = dst;
    const uint8_t* ssafe = src_size >= 16 ? src + src_size - 16 : src - 1;
    const uint8_t* dsafe = dst_size >= 16 ? dst + dst_size - 16 : dst - 1;
    for (int64_t i = 0; i < n; i++) {
        if (i + GATHER_PF < n) __builtin_prefetch(src + offsets[idx[i + GATHER_PF]]);
        int64_t row = idx[i];
        size_t len = (size_t)lens[row];
        const uint8_t* p = src + offsets[row];
        if (len <= 16 && p <= ssafe && op <= dsafe) {
            uint64_t a = load64(p), b = load64(p + 8);
            memcpy(op, &a, 8);
            memcpy(op + 8, &b, 8);
        } else {
            memcpy(op, p, len);
        }
        op += len;
    }
}

// Fixed-width row gather: row i lives at src + idx[i]*row_len, all rows
// row_len bytes. No offsets/lens arrays to read; ≤16-byte rows go through
// the branchless two-load copy. dst MUST be allocated with ≥ n*row_len + 16
// bytes (the Python wrapper over-allocates and returns a trimmed view).
void slz_gather_fixed(const uint8_t* src, size_t src_size, int64_t row_len,
                      const int64_t* idx, int64_t n, uint8_t* dst) {
    uint8_t* op = dst;
    if (row_len <= 16) {
        const uint8_t* ssafe = src_size >= 16 ? src + src_size - 16 : src - 1;
        for (int64_t i = 0; i < n; i++) {
            if (i + GATHER_PF < n) __builtin_prefetch(src + idx[i + GATHER_PF] * row_len);
            const uint8_t* p = src + idx[i] * row_len;
            if (p <= ssafe) {
                uint64_t a = load64(p), b = load64(p + 8);
                memcpy(op, &a, 8);
                memcpy(op + 8, &b, 8);
            } else {
                memcpy(op, p, (size_t)row_len);
            }
            op += row_len;
        }
    } else {
        // rows span ≥2 cache lines: prefetch both ends of the upcoming row
        for (int64_t i = 0; i < n; i++) {
            if (i + GATHER_PF < n) {
                const uint8_t* f = src + idx[i + GATHER_PF] * row_len;
                __builtin_prefetch(f);
                __builtin_prefetch(f + row_len - 1);
            }
            memcpy(op, src + idx[i] * row_len, (size_t)row_len);
            op += row_len;
        }
    }
}

// Segmented fixed-width row gather: row i lives at srcs[seg[i]] +
// local[i]*row_len. One call gathers a sorted permutation straight out of
// MANY source buffers (decoded frames, pending batches) into one contiguous
// output — replacing the concat-then-gather two-pass (the concat pass was a
// top-3 CPU cost in the r5 terasort profile). src_sizes[s] is the byte size
// of srcs[s]: short rows take the branchless two-load copy whenever the
// 16-byte read stays inside the SOURCE buffer (checked per row — segment
// buffers are independently sized, unlike slz_gather_fixed's single src);
// rows near a segment's end fall back to an exact memcpy of the SOURCE
// read, but the branchless path still STORES 16 bytes — dst MUST be
// allocated with >= n*row_len + 16 bytes whenever row_len <= 16 (the
// Python wrapper over-allocates and trims). A per-row memcpy call for
// 10-16 byte rows measured ~20% slower than concat+contiguous-gather,
// defeating the pass saving.
void slz_gather_fixed_segmented(const uint8_t* const* srcs,
                                const size_t* src_sizes, const int32_t* seg,
                                const int64_t* local, int64_t row_len,
                                int64_t n, uint8_t* dst) {
    uint8_t* op = dst;
    if (row_len <= 16) {
        for (int64_t i = 0; i < n; i++) {
            if (i + GATHER_PF < n)
                __builtin_prefetch(
                    srcs[seg[i + GATHER_PF]] + local[i + GATHER_PF] * row_len);
            int32_t s = seg[i];
            size_t off = (size_t)local[i] * (size_t)row_len;
            const uint8_t* p = srcs[s] + off;
            if (off + 16 <= src_sizes[s]) {
                uint64_t a = load64(p), b = load64(p + 8);
                memcpy(op, &a, 8);
                memcpy(op + 8, &b, 8);
            } else {
                memcpy(op, p, (size_t)row_len);
            }
            op += row_len;
        }
        return;
    }
    for (int64_t i = 0; i < n; i++) {
        if (i + GATHER_PF < n) {
            const uint8_t* f =
                srcs[seg[i + GATHER_PF]] + local[i + GATHER_PF] * row_len;
            __builtin_prefetch(f);
            if (row_len > 64) __builtin_prefetch(f + row_len - 1);
        }
        memcpy(op, srcs[seg[i]] + local[i] * row_len, (size_t)row_len);
        op += row_len;
    }
}

// ---------------------------------------------------------------------------
// Framed batch compression: compress `count` equal-size blocks from ONE
// contiguous buffer and emit the shared 9-byte frame header
// [u8 codec_id][u32le ulen][u32le clen] + payload back-to-back into dst
// (raw escape: codec_id 0 when compression doesn't shrink). One native call
// replaces per-block slicing, joining, header packing, and sink writes in
// the Python write path. dst capacity must be >= count * (block_size + 9).
// Returns total framed bytes.
// ---------------------------------------------------------------------------

int64_t slz_compress_framed(const uint8_t* src, int64_t count, int64_t block_size,
                            uint8_t codec_id, uint8_t* dst) {
    uint8_t* op = dst;
    for (int64_t i = 0; i < count; i++) {
        const uint8_t* block = src + i * block_size;
        uint8_t* hdr = op;
        op += 9;
        // cap block_size - 1: "didn't shrink" → raw escape
        size_t clen = slz_compress(block, (size_t)block_size, op, (size_t)block_size - 1);
        uint8_t cid = codec_id;
        if (clen == 0) {
            memcpy(op, block, (size_t)block_size);
            clen = (size_t)block_size;
            cid = 0;
        }
        uint32_t ulen32 = (uint32_t)block_size, clen32 = (uint32_t)clen;
        hdr[0] = cid;
        for (int k = 0; k < 4; k++) {  // explicit little-endian
            hdr[1 + k] = (uint8_t)(ulen32 >> (8 * k));
            hdr[5 + k] = (uint8_t)(clen32 >> (8 * k));
        }
        op += clen;
    }
    return (int64_t)(op - dst);
}

}  // extern "C"
