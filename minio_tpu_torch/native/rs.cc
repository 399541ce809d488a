// GF(2^8) Reed-Solomon matrix apply — the host-side fast path.
//
// Field: x^8 + x^4 + x^3 + x^2 + 1 (0x11D), generator 2 — identical to
// ops/gf256.py, so outputs are byte-identical to the golden numpy codec.
//
// Technique: per-coefficient low/high-nibble product tables applied with
// byte shuffles ("Screaming Fast Galois Field Arithmetic", Plank et al.;
// the same published technique the reference's SIMD codec dependency
// implements in assembly — reimplemented here from the field definition,
// not ported). AVX2 when available at compile time, SSSE3 next, plain
// table loop otherwise.
//
// Exported C ABI:
//   rs_gf_apply(mat, r, k, data, n, out)
//     mat:  r*k coefficient bytes (row-major)
//     data: k rows of n bytes (row-major, contiguous)
//     out:  r rows of n bytes (written)

#include <cstdint>
#include <cstring>
#include <cstddef>
#include <thread>
#include <vector>

#if defined(__AVX2__) || defined(__SSSE3__)
#include <immintrin.h>
#endif

namespace {

struct Tables {
    uint8_t exp[512];
    uint8_t log[256];
    Tables() {
        int x = 1;
        for (int i = 0; i < 255; i++) {
            exp[i] = static_cast<uint8_t>(x);
            log[x] = static_cast<uint8_t>(i);
            x <<= 1;
            if (x & 0x100) x ^= 0x11D;
        }
        for (int i = 255; i < 512; i++) exp[i] = exp[i - 255];
        log[0] = 0;
    }
    inline uint8_t mul(uint8_t a, uint8_t b) const {
        if (a == 0 || b == 0) return 0;
        return exp[log[a] + log[b]];
    }
};

const Tables T;

// 16-entry product tables for coefficient c: lo[x] = c*x,
// hi[x] = c*(x<<4); c*b = lo[b & 15] ^ hi[b >> 4].
inline void nibble_tables(uint8_t c, uint8_t lo[16], uint8_t hi[16]) {
    for (int x = 0; x < 16; x++) {
        lo[x] = T.mul(c, static_cast<uint8_t>(x));
        hi[x] = T.mul(c, static_cast<uint8_t>(x << 4));
    }
}

// acc[0..n) ^= c * src[0..n)
void axpy_gf(uint8_t c, const uint8_t* src, uint8_t* acc, size_t n) {
    if (c == 0) return;
    uint8_t lo[16], hi[16];
    nibble_tables(c, lo, hi);
    size_t i = 0;
#if defined(__AVX2__)
    const __m128i lo128 = _mm_loadu_si128(
        reinterpret_cast<const __m128i*>(lo));
    const __m128i hi128 = _mm_loadu_si128(
        reinterpret_cast<const __m128i*>(hi));
    const __m256i tlo = _mm256_broadcastsi128_si256(lo128);
    const __m256i thi = _mm256_broadcastsi128_si256(hi128);
    const __m256i mask = _mm256_set1_epi8(0x0F);
    for (; i + 32 <= n; i += 32) {
        __m256i v = _mm256_loadu_si256(
            reinterpret_cast<const __m256i*>(src + i));
        __m256i vlo = _mm256_and_si256(v, mask);
        __m256i vhi = _mm256_and_si256(_mm256_srli_epi64(v, 4), mask);
        __m256i p = _mm256_xor_si256(_mm256_shuffle_epi8(tlo, vlo),
                                     _mm256_shuffle_epi8(thi, vhi));
        __m256i a = _mm256_loadu_si256(
            reinterpret_cast<const __m256i*>(acc + i));
        _mm256_storeu_si256(reinterpret_cast<__m256i*>(acc + i),
                            _mm256_xor_si256(a, p));
    }
#elif defined(__SSSE3__)
    const __m128i tlo = _mm_loadu_si128(
        reinterpret_cast<const __m128i*>(lo));
    const __m128i thi = _mm_loadu_si128(
        reinterpret_cast<const __m128i*>(hi));
    const __m128i mask = _mm_set1_epi8(0x0F);
    for (; i + 16 <= n; i += 16) {
        __m128i v = _mm_loadu_si128(
            reinterpret_cast<const __m128i*>(src + i));
        __m128i vlo = _mm_and_si128(v, mask);
        __m128i vhi = _mm_and_si128(_mm_srli_epi64(v, 4), mask);
        __m128i p = _mm_xor_si128(_mm_shuffle_epi8(tlo, vlo),
                                  _mm_shuffle_epi8(thi, vhi));
        __m128i a = _mm_loadu_si128(
            reinterpret_cast<const __m128i*>(acc + i));
        _mm_storeu_si128(reinterpret_cast<__m128i*>(acc + i),
                         _mm_xor_si128(a, p));
    }
#endif
    for (; i < n; i++) acc[i] ^= lo[src[i] & 0x0F] ^ hi[src[i] >> 4];
}

}  // namespace

namespace {

void apply_cols(const uint8_t* mat, size_t r, size_t k,
                const uint8_t* data, size_t n,
                size_t col0, size_t col1, uint8_t* out) {
    for (size_t i = 0; i < r; i++) {
        uint8_t* acc = out + i * n + col0;
        std::memset(acc, 0, col1 - col0);
        for (size_t j = 0; j < k; j++) {
            axpy_gf(mat[i * k + j], data + j * n + col0, acc,
                    col1 - col0);
        }
    }
}

}  // namespace

extern "C" {

// nthreads <= 1: single-threaded. Column ranges are independent (GF
// math is per-byte-column), so threads never share output bytes.
void rs_gf_apply_mt(const uint8_t* mat, size_t r, size_t k,
                    const uint8_t* data, size_t n, uint8_t* out,
                    size_t nthreads) {
    if (nthreads <= 1 || n < 2 * nthreads) {
        apply_cols(mat, r, k, data, n, 0, n, out);
        return;
    }
    std::vector<std::thread> ts;
    ts.reserve(nthreads);
    // 64-byte-aligned chunk boundaries keep SIMD lanes off seams.
    // Ceiling division: nthreads * chunk must cover ALL n columns.
    size_t chunk = (((n + nthreads - 1) / nthreads) + 63) & ~size_t(63);
    for (size_t t = 0; t < nthreads; t++) {
        size_t c0 = t * chunk;
        if (c0 >= n) break;
        size_t c1 = c0 + chunk < n ? c0 + chunk : n;
        ts.emplace_back(apply_cols, mat, r, k, data, n, c0, c1, out);
    }
    for (auto& th : ts) th.join();
}

void rs_gf_apply(const uint8_t* mat, size_t r, size_t k,
                 const uint8_t* data, size_t n, uint8_t* out) {
    apply_cols(mat, r, k, data, n, 0, n, out);
}

}  // extern "C"
