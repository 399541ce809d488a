// HighwayHash-256 — portable scalar C++ implementation.
//
// Host-side hot loop for bitrot checksums (the reference uses
// minio/highwayhash SIMD assembly; ref cmd/bitrot.go:35-46,
// cmd/bitrot-streaming.go:46). Byte-identical output is enforced by the
// Python tests against the magic pi-key golden vector.
//
// C API (ctypes):
//   hh256_hash(key32, data, len, out32)
//   hh256_chunks(key32, data, len, chunk_size, out) — hash consecutive
//     chunk_size-byte chunks (last may be short), out = 32B per chunk.
//     This is exactly the streaming-bitrot per-shard-block pattern.

#include <cstdint>
#include <cstring>
#include <cstddef>

#if defined(__x86_64__)
#include <immintrin.h>
#endif

namespace {

struct State {
  uint64_t v0[4], v1[4], mul0[4], mul1[4];
};

const uint64_t kInit0[4] = {0xdbe6d5d5fe4cce2fULL, 0xa4093822299f31d0ULL,
                            0x13198a2e03707344ULL, 0x243f6a8885a308d3ULL};
const uint64_t kInit1[4] = {0x3bd39e10cb0ef593ULL, 0xc0acf169b5f18a8cULL,
                            0xbe5466cf34e90c6cULL, 0x452821e638d01377ULL};

inline uint64_t Read64LE(const uint8_t* p) {
  uint64_t v;
  memcpy(&v, p, 8);
  return v;  // x86_64 is little-endian
}

inline void Reset(const uint64_t key[4], State* s) {
  for (int i = 0; i < 4; ++i) {
    s->mul0[i] = kInit0[i];
    s->mul1[i] = kInit1[i];
    s->v0[i] = kInit0[i] ^ key[i];
    s->v1[i] = kInit1[i] ^ ((key[i] >> 32) | (key[i] << 32));
  }
}

inline void ZipperMergeAndAdd(const uint64_t v1, const uint64_t v0,
                              uint64_t* add1, uint64_t* add0) {
  *add0 += (((v0 & 0xff000000ULL) | (v1 & 0xff00000000ULL)) >> 24) |
           (((v0 & 0xff0000000000ULL) | (v1 & 0xff000000000000ULL)) >> 16) |
           (v0 & 0xff0000ULL) | ((v0 & 0xff00ULL) << 32) |
           ((v1 & 0xff00000000000000ULL) >> 8) | (v0 << 56);
  *add1 += (((v1 & 0xff000000ULL) | (v0 & 0xff00000000ULL)) >> 24) |
           (v1 & 0xff0000ULL) | ((v1 & 0xff0000000000ULL) >> 16) |
           ((v1 & 0xff00ULL) << 24) | ((v0 & 0xff000000000000ULL) >> 8) |
           ((v1 & 0xffULL) << 48) | (v0 & 0xff00000000000000ULL);
}

inline void UpdateLanes(const uint64_t lanes[4], State* s) {
  for (int i = 0; i < 4; ++i) {
    s->v1[i] += s->mul0[i] + lanes[i];
    s->mul0[i] ^= (s->v1[i] & 0xffffffff) * (s->v0[i] >> 32);
    s->v0[i] += s->mul1[i];
    s->mul1[i] ^= (s->v0[i] & 0xffffffff) * (s->v1[i] >> 32);
  }
  ZipperMergeAndAdd(s->v1[1], s->v1[0], &s->v0[1], &s->v0[0]);
  ZipperMergeAndAdd(s->v1[3], s->v1[2], &s->v0[3], &s->v0[2]);
  ZipperMergeAndAdd(s->v0[1], s->v0[0], &s->v1[1], &s->v1[0]);
  ZipperMergeAndAdd(s->v0[3], s->v0[2], &s->v1[3], &s->v1[2]);
}

inline void UpdatePacket(const uint8_t* packet, State* s) {
  uint64_t lanes[4];
  for (int i = 0; i < 4; ++i) lanes[i] = Read64LE(packet + 8 * i);
  UpdateLanes(lanes, s);
}

inline void Rotate32By(uint64_t count, uint64_t lanes[4]) {
  for (int i = 0; i < 4; ++i) {
    uint32_t half0 = static_cast<uint32_t>(lanes[i] & 0xffffffff);
    uint32_t half1 = static_cast<uint32_t>(lanes[i] >> 32);
    uint32_t c = static_cast<uint32_t>(count) & 31;
    uint32_t r0 = c ? ((half0 << c) | (half0 >> (32 - c))) : half0;
    uint32_t r1 = c ? ((half1 << c) | (half1 >> (32 - c))) : half1;
    lanes[i] = (static_cast<uint64_t>(r1) << 32) | r0;
  }
}

inline void UpdateRemainder(const uint8_t* bytes, const size_t size_mod32,
                            State* s) {
  const size_t size_mod4 = size_mod32 & 3;
  const uint8_t* remainder = bytes + (size_mod32 & ~3);
  uint8_t packet[32] = {0};
  for (int i = 0; i < 4; ++i) {
    s->v0[i] += (static_cast<uint64_t>(size_mod32) << 32) + size_mod32;
  }
  Rotate32By(size_mod32, s->v1);
  memcpy(packet, bytes, size_mod32 & ~3);
  if (size_mod32 & 16) {
    for (int i = 0; i < 4; ++i) {
      packet[28 + i] = remainder[i + size_mod4 - 4];
    }
  } else if (size_mod4) {
    packet[16 + 0] = remainder[0];
    packet[16 + 1] = remainder[size_mod4 >> 1];
    packet[16 + 2] = remainder[size_mod4 - 1];
  }
  UpdatePacket(packet, s);
}

inline void PermuteAndUpdate(State* s) {
  uint64_t permuted[4];
  permuted[0] = (s->v0[2] >> 32) | (s->v0[2] << 32);
  permuted[1] = (s->v0[3] >> 32) | (s->v0[3] << 32);
  permuted[2] = (s->v0[0] >> 32) | (s->v0[0] << 32);
  permuted[3] = (s->v0[1] >> 32) | (s->v0[1] << 32);
  UpdateLanes(permuted, s);
}

inline void ModularReduction(uint64_t a3_unmasked, uint64_t a2, uint64_t a1,
                             uint64_t a0, uint64_t* m1, uint64_t* m0) {
  uint64_t a3 = a3_unmasked & 0x3FFFFFFFFFFFFFFFULL;
  *m1 = a1 ^ ((a3 << 1) | (a2 >> 63)) ^ ((a3 << 2) | (a2 >> 62));
  *m0 = a0 ^ (a2 << 1) ^ (a2 << 2);
}

inline void Finalize256(State* s, uint64_t hash[4]) {
  for (int i = 0; i < 10; ++i) PermuteAndUpdate(s);
  ModularReduction(s->v1[1] + s->mul1[1], s->v1[0] + s->mul1[0],
                   s->v0[1] + s->mul0[1], s->v0[0] + s->mul0[0], &hash[1],
                   &hash[0]);
  ModularReduction(s->v1[3] + s->mul1[3], s->v1[2] + s->mul1[2],
                   s->v0[3] + s->mul0[3], s->v0[2] + s->mul0[2], &hash[3],
                   &hash[2]);
}

// --- AVX2 hot loop ----------------------------------------------------------
//
// The four independent 64-bit lanes map 1:1 onto one __m256i, and the
// zipper merge is one per-128-bit-half byte shuffle (the control bytes
// below are DERIVED from ZipperMergeAndAdd's masks: output byte j of
// the low half takes input byte {3,12,2,5,14,1,15,0}[j] of the
// [v0_lane0||v0_lane1] 16-byte pair, and the high half
// {11,4,10,13,9,6,8,7} — matching the reference's SIMD shuffle
// pattern). Only the full-packet loop is vectorized; remainder and
// finalize reuse the scalar code on the stored-back state, keeping the
// tricky paths single-sourced. Byte-identity with the scalar path is
// pinned by tests/test_hh256.py's golden vectors.

#if defined(__x86_64__)
__attribute__((target("avx2")))
inline __m256i MulLo32(const __m256i a, const __m256i b_hi) {
  // (a & 0xffffffff) * (b >> 32) per 64-bit lane.
  return _mm256_mul_epu32(a, _mm256_srli_epi64(b_hi, 32));
}

__attribute__((target("avx2")))
size_t UpdatePacketsAVX2(const uint8_t* data, size_t len, State* s) {
  const __m256i zipper = _mm256_setr_epi8(
      3, 12, 2, 5, 14, 1, 15, 0, 11, 4, 10, 13, 9, 6, 8, 7,
      3, 12, 2, 5, 14, 1, 15, 0, 11, 4, 10, 13, 9, 6, 8, 7);
  __m256i v0 = _mm256_loadu_si256(reinterpret_cast<const __m256i*>(s->v0));
  __m256i v1 = _mm256_loadu_si256(reinterpret_cast<const __m256i*>(s->v1));
  __m256i mul0 =
      _mm256_loadu_si256(reinterpret_cast<const __m256i*>(s->mul0));
  __m256i mul1 =
      _mm256_loadu_si256(reinterpret_cast<const __m256i*>(s->mul1));
  size_t i = 0;
  for (; i + 32 <= len; i += 32) {
    const __m256i lanes =
        _mm256_loadu_si256(reinterpret_cast<const __m256i*>(data + i));
    v1 = _mm256_add_epi64(v1, _mm256_add_epi64(mul0, lanes));
    mul0 = _mm256_xor_si256(mul0, MulLo32(v1, v0));
    v0 = _mm256_add_epi64(v0, mul1);
    mul1 = _mm256_xor_si256(mul1, MulLo32(v0, v1));
    v0 = _mm256_add_epi64(v0, _mm256_shuffle_epi8(v1, zipper));
    v1 = _mm256_add_epi64(v1, _mm256_shuffle_epi8(v0, zipper));
  }
  _mm256_storeu_si256(reinterpret_cast<__m256i*>(s->v0), v0);
  _mm256_storeu_si256(reinterpret_cast<__m256i*>(s->v1), v1);
  _mm256_storeu_si256(reinterpret_cast<__m256i*>(s->mul0), mul0);
  _mm256_storeu_si256(reinterpret_cast<__m256i*>(s->mul1), mul1);
  return i;
}

inline bool HaveAVX2() {
  static const bool have = __builtin_cpu_supports("avx2");
  return have;
}
#else
inline bool HaveAVX2() { return false; }
inline size_t UpdatePacketsAVX2(const uint8_t*, size_t, State*) { return 0; }
#endif

inline void HashOne(const uint64_t key[4], const uint8_t* data, size_t len,
                    uint8_t out[32]) {
  State s;
  Reset(key, &s);
  size_t i = 0;
  if (HaveAVX2()) {
    i = UpdatePacketsAVX2(data, len, &s);
  } else {
    for (; i + 32 <= len; i += 32) UpdatePacket(data + i, &s);
  }
  if (len & 31) UpdateRemainder(data + i, len & 31, &s);
  uint64_t hash[4];
  Finalize256(&s, hash);
  memcpy(out, hash, 32);
}

}  // namespace

extern "C" {

void hh256_hash(const uint8_t* key32, const uint8_t* data, size_t len,
                uint8_t* out32) {
  uint64_t key[4];
  memcpy(key, key32, 32);
  HashOne(key, data, len, out32);
}

// Hash consecutive chunk_size chunks of data (last chunk may be short).
// out must hold 32 * ceil(len / chunk_size) bytes. Returns chunk count.
size_t hh256_chunks(const uint8_t* key32, const uint8_t* data, size_t len,
                    size_t chunk_size, uint8_t* out) {
  uint64_t key[4];
  memcpy(key, key32, 32);
  size_t n = 0;
  for (size_t off = 0; off < len; off += chunk_size, ++n) {
    size_t this_len = len - off < chunk_size ? len - off : chunk_size;
    HashOne(key, data + off, this_len, out + 32 * n);
  }
  return n;
}

}  // extern "C"
