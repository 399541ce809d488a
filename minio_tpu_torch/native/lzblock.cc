// LZ77 byte-oriented block codec — the native transparent-compression
// hot loop (the reference's analog is klauspost/compress/s2's assembly
// block codec, SURVEY §2.7; the TPU is not a fit for LZ-family codecs,
// so this stays on the host as C++).
//
// Block format (literals/match token stream, LZ4-block-flavored):
//   token byte: high nibble = literal run length (15 = extended),
//               low nibble  = match length - 4   (15 = extended)
//   [extended literal length bytes*] [literals]
//   [2-byte little-endian match offset] [extended match length bytes*]
//   The final sequence carries literals only (offset omitted).
// Extended lengths: 255 bytes accumulate until a byte < 255.
//
// Exposed C API (ctypes):
//   lzb_max_compressed(n)                 -> worst-case output bound
//   lzb_compress(src, n, dst, cap)        -> compressed size, or 0 if
//                                            incompressible/cap hit
//   lzb_decompress(src, n, dst, cap)      -> output size, or -1 on
//                                            malformed input

#include <cstdint>
#include <cstring>
#include <cstddef>

namespace {

constexpr int MIN_MATCH = 4;
constexpr int HASH_BITS = 16;
constexpr int MAX_OFFSET = 65535;

inline uint32_t load32(const uint8_t* p) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    return v;
}

inline uint32_t hash4(uint32_t v) {
    return (v * 2654435761u) >> (32 - HASH_BITS);
}

inline uint8_t* put_len(uint8_t* op, size_t len) {
    while (len >= 255) { *op++ = 255; len -= 255; }
    *op++ = (uint8_t)len;
    return op;
}

}  // namespace

extern "C" {

size_t lzb_max_compressed(size_t n) {
    return n + n / 255 + 16;
}

// Greedy single-pass hash-chain-less LZ (one hash slot per bucket).
long lzb_compress(const uint8_t* src, size_t n, uint8_t* dst,
                  size_t cap) {
    if (n < 16 || cap < 16) return 0;
    uint32_t table[1 << HASH_BITS];
    std::memset(table, 0, sizeof(table));

    const uint8_t* ip = src;
    const uint8_t* iend = src + n;
    const uint8_t* match_limit = iend - 8;   // last bytes stay literals
    const uint8_t* anchor = src;
    uint8_t* op = dst;
    uint8_t* oend = dst + cap;

    while (ip < match_limit) {
        uint32_t h = hash4(load32(ip));
        size_t cand = table[h];
        table[h] = (uint32_t)(ip - src);
        const uint8_t* cp = src + cand;
        if (cand != 0 && cp < ip && (size_t)(ip - cp) <= MAX_OFFSET &&
            load32(cp) == load32(ip)) {
            // Extend the match forward.
            const uint8_t* m = cp + 4;
            const uint8_t* p = ip + 4;
            while (p < match_limit && *p == *m) { ++p; ++m; }
            size_t mlen = (size_t)(p - ip);
            if (mlen >= MIN_MATCH) {
                size_t lit = (size_t)(ip - anchor);
                // Worst-case emit size for this sequence.
                if (op + 1 + lit / 255 + 1 + lit + 2 + mlen / 255 + 1
                    > oend)
                    return 0;
                uint8_t* token = op++;
                size_t ml = mlen - MIN_MATCH;
                *token = (uint8_t)(((lit < 15 ? lit : 15) << 4) |
                                   (ml < 15 ? ml : 15));
                if (lit >= 15) op = put_len(op, lit - 15);
                std::memcpy(op, anchor, lit);
                op += lit;
                size_t off = (size_t)(ip - cp);
                *op++ = (uint8_t)(off & 0xff);
                *op++ = (uint8_t)(off >> 8);
                if (ml >= 15) op = put_len(op, ml - 15);
                ip = p;
                anchor = ip;
                continue;
            }
        }
        ++ip;
    }
    // Trailing literals-only sequence.
    size_t lit = (size_t)(iend - anchor);
    if (op + 1 + lit / 255 + 1 + lit > oend) return 0;
    uint8_t* token = op++;
    *token = (uint8_t)((lit < 15 ? lit : 15) << 4);
    if (lit >= 15) op = put_len(op, lit - 15);
    std::memcpy(op, anchor, lit);
    op += lit;

    size_t out = (size_t)(op - dst);
    if (out >= n) return 0;  // incompressible: caller stores raw
    return (long)out;
}

long lzb_decompress(const uint8_t* src, size_t n, uint8_t* dst,
                    size_t cap) {
    const uint8_t* ip = src;
    const uint8_t* iend = src + n;
    uint8_t* op = dst;
    uint8_t* oend = dst + cap;

    while (ip < iend) {
        uint8_t token = *ip++;
        // Literals.
        size_t lit = token >> 4;
        if (lit == 15) {
            uint8_t b;
            do {
                if (ip >= iend) return -1;
                b = *ip++;
                lit += b;
            } while (b == 255);
        }
        if (ip + lit > iend || op + lit > oend) return -1;
        std::memcpy(op, ip, lit);
        ip += lit;
        op += lit;
        if (ip >= iend) break;  // final literals-only sequence
        // Match.
        if (ip + 2 > iend) return -1;
        size_t off = (size_t)ip[0] | ((size_t)ip[1] << 8);
        ip += 2;
        if (off == 0 || (size_t)(op - dst) < off) return -1;
        size_t mlen = token & 0x0f;
        if (mlen == 15) {
            uint8_t b;
            do {
                if (ip >= iend) return -1;
                b = *ip++;
                mlen += b;
            } while (b == 255);
        }
        mlen += MIN_MATCH;
        if (op + mlen > oend) return -1;
        const uint8_t* m = op - off;
        // Byte copy: overlapping matches (off < mlen) must replicate.
        for (size_t i = 0; i < mlen; ++i) op[i] = m[i];
        op += mlen;
    }
    return (long)(op - dst);
}

}  // extern "C"
