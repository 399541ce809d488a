// HighwayHash-256 over B equal-length chunks, for sm_90a.
//
// Replaces: minio_tpu/ops/hh256_tpu.py `_hash_chunks_device` (jax.jit +
// lax.fori_loop, with `_update_lanes`, `_permute_and_update`,
// `_modular_reduction`, and the host-side `_init_state_np` and
// `_pack_remainder`). The TPU version emulates every u64 as a pair of u32;
// here the state is native uint64_t in registers.
//
// What it computes: the digest of ops/hh256.py for each row of a (B, L)
// byte array: L//32 full packets, then (when L % 32 != 0) the remainder
// packet built in the kernel exactly as `_update_remainder` builds it, then
// 10 permute-updates and the modular reduction. Output (B, 32) bytes.
//
// What bounds it on an H100: the bytes (B*L read, B*32 written) over
// 3.35 TB/s, and the operations (about 420 32-bit operations a packet)
// over the scalar rate, are both far below the third bound: each chunk is
// one serial chain, a packet's update needs the state the previous packet
// left. A chain runs no faster than the latency of one update, and the
// main path hands the kernel only a few hundred chains. So the design
// attacks that latency and keeps every chain fed:
//
// - Two threads per chain. A packet update touches lane i of the state
//   with lane i of the packet only, and the zipper merges only within the
//   lane pairs (0, 1) and (2, 3); the remainder update is per lane as
//   well. So one thread carries lanes {0, 1} (packet bytes 0-15) and its
//   neighbour lanes {2, 3} (bytes 16-31) through every packet, and their
//   halves meet only in the 10 permute rounds (which feed v0[2], v0[3]
//   into lanes 0, 1 and back: one __shfl_xor_sync a word) and never in the
//   reduction (h0, h1 come from lanes 0, 1, h2, h3 from lanes 2, 3). That
//   halves the serial instruction stream of a chain.
// - The zipper is byte permutations: each 32-bit half of a zipper term is
//   one or two PRMT (__byte_perm), not shifts and masks.
// - Bytes are staged through shared memory well ahead of the hash. Each
//   chain owns a ring of kStages windows of kWindow bytes. The two threads
//   of a chain fill the windows with cp.async 16-byte copies (32 bytes a
//   pair per instruction: whole sectors), kStages - 2 windows (3 KiB, about
//   100 packets) ahead of the packet being hashed. By Little's law a chain
//   that takes ~100 cycles a packet needs ~320 bytes in flight to cover
//   ~1,000 cycles of memory latency; the ring holds ten times that.
// - Rows start at any byte (frames of a shard file; at S = 873,814 every
//   other row starts at 2 mod 4). The ring holds the aligned 16-byte chunks
//   from the one that holds the row's first byte to the one that holds its
//   last: no misaligned access, and no read beyond the allocation's last
//   aligned 16-byte word. A thread reads its 16 packet bytes as two
//   aligned LDS.128, picks the five words that cover them and
//   funnel-shifts them into place. The chains' rings are offset by 8*(c%4)
//   words, so the 8 threads of each LDS.128 phase hit 32 distinct banks
//   when the rows share an alignment.
// - Sixteen chains a block, one warp: a few hundred chains spread over as
//   many SMs as they fill warps (400 chains: 25 SMs), each warp alone on
//   its scheduler, where its chain latency and not shared issue slots sets
//   the pace. Rows past B in the last block hash a copy of row B-1 and
//   store nothing, so every thread takes part in the barriers and shuffles.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int kChains = 16;                     // chains per block
constexpr int kThreads = 2 * kChains;           // one warp
constexpr int kWindow = 512;                    // bytes of a ring window
constexpr int kPackets = kWindow / 32;          // packets per window
constexpr int kStages = 8;                      // windows per ring
constexpr int kRingWords = kStages * kWindow / 4;   // 1024, a power of two
constexpr int kChunksPerWindow = kWindow / 16;
// Chain c's ring starts at word c*kRingStride + 8*(c % 4): the stride is a
// multiple of the 32 banks, and the pad leaves room for the offset.
constexpr int kRingStride = kRingWords + 32;
constexpr int kSmemBytes = kChains * kRingStride * 4;

__constant__ u64 kInit0[4] = {0xDBE6D5D5FE4CCE2FULL, 0xA4093822299F31D0ULL,
                              0x13198A2E03707344ULL, 0x243F6A8885A308D3ULL};
__constant__ u64 kInit1[4] = {0x3BD39E10CB0EF593ULL, 0xC0ACF169B5F18A8CULL,
                              0xBE5466CF34E90C6CULL, 0x452821E638D01377ULL};

// Half of the HighwayHash state: lanes 2h and 2h+1.
struct Half {
  u64 v0[2], v1[2], mul0[2], mul1[2];
};

__device__ __forceinline__ u64 swap32(u64 x) { return (x << 32) | (x >> 32); }

__device__ __forceinline__ u64 rot32_halves(u64 x, int c) {
  if (c == 0) return x;
  uint32_t lo = (uint32_t)x, hi = (uint32_t)(x >> 32);
  lo = (lo << c) | (lo >> (32 - c));
  hi = (hi << c) | (hi >> (32 - c));
  return ((u64)hi << 32) | lo;
}

__device__ __forceinline__ u64 mul32(u64 a, u64 b) {
  return (u64)(uint32_t)a * (uint32_t)(b >> 32);
}

// ops/hh256.py HighwayHash256._zipper_merge_and_add(v1, v0, add, i1, i0).
// With v0 bytes X0..X7 and v1 bytes Y0..Y7, add[i0] gains the bytes
// [X3 Y4 X2 X5 | Y6 X1 Y7 X0] and add[i1] [Y3 X4 Y2 Y5 | Y1 X6 Y0 X7].
__device__ __forceinline__ void zipper_add(u64 v1, u64 v0, u64& a1,
                                           u64& a0) {
  const uint32_t x0 = (uint32_t)v0, x1 = (uint32_t)(v0 >> 32);
  const uint32_t y0 = (uint32_t)v1, y1 = (uint32_t)(v1 >> 32);
  const uint32_t lo0 = __byte_perm(__byte_perm(x0, x1, 0x5203), y1, 0x3240);
  const uint32_t hi0 = __byte_perm(x0, y1, 0x0716);
  const uint32_t lo1 = __byte_perm(__byte_perm(y0, y1, 0x5203), x1, 0x3240);
  const uint32_t hi1 = __byte_perm(y0, x1, 0x7061);
  a0 += ((u64)hi0 << 32) | lo0;
  a1 += ((u64)hi1 << 32) | lo1;
}

// One packet update of this thread's two lanes.
__device__ __forceinline__ void update(Half& s, u64 l0, u64 l1) {
  s.v1[0] += s.mul0[0] + l0;
  s.v1[1] += s.mul0[1] + l1;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    s.mul0[i] ^= mul32(s.v1[i], s.v0[i]);
    s.v0[i] += s.mul1[i];
    s.mul1[i] ^= mul32(s.v0[i], s.v1[i]);
  }
  zipper_add(s.v1[1], s.v1[0], s.v0[1], s.v0[0]);
  zipper_add(s.v0[1], s.v0[0], s.v1[1], s.v1[0]);
}

__device__ __forceinline__ void mod_reduction(u64 a3u, u64 a2, u64 a1,
                                              u64 a0, u64& m1, u64& m0) {
  const u64 a3 = a3u & 0x3FFFFFFFFFFFFFFFULL;
  m1 = a1 ^ ((a3 << 1) | (a2 >> 63)) ^ ((a3 << 2) | (a2 >> 62));
  m0 = a0 ^ (a2 << 1) ^ (a2 << 2);
}

// Byte g of the remainder packet of a chunk whose last rem bytes start at
// `tail` (ops/hh256.py HighwayHash256._update_remainder's layout).
__device__ __forceinline__ uint32_t remainder_byte(const uint8_t* tail,
                                                   int rem, int g) {
  const int mod4 = rem & 3, off = rem & ~3;
  if (g < off) return tail[g];
  if (rem & 16) return g >= 28 ? tail[off + (g - 28) + mod4 - 4] : 0u;
  if (mod4) {
    if (g == 16) return tail[off];
    if (g == 17) return tail[off + (mod4 >> 1)];
    if (g == 18) return tail[off + mod4 - 1];
  }
  return 0u;
}

// This thread's two packet lanes: stream bytes [4w + shift, +16) of the
// ring, from the two aligned quads at word w (w a multiple of 4), the
// covering words picked by shift / 4 (bits o2, o1) and funnel-shifted by
// sh = 8 * (shift % 4) bits.
__device__ __forceinline__ void read_lanes(const uint32_t* ring, int w,
                                           int o2, int o1, unsigned sh,
                                           u64& l0, u64& l1) {
  const uint4 a = *reinterpret_cast<const uint4*>(ring + w);
  const uint4 b =
      *reinterpret_cast<const uint4*>(ring + ((w + 4) & (kRingWords - 1)));
  const uint32_t x[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  uint32_t y[6], z[5], wd[4];
#pragma unroll
  for (int q = 0; q < 6; ++q) y[q] = o2 ? x[q + 2] : x[q];
#pragma unroll
  for (int q = 0; q < 5; ++q) z[q] = o1 ? y[q + 1] : y[q];
#pragma unroll
  for (int q = 0; q < 4; ++q) wd[q] = __funnelshift_r(z[q], z[q + 1], sh);
  l0 = ((u64)wd[1] << 32) | wd[0];
  l1 = ((u64)wd[3] << 32) | wd[2];
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__global__ void __launch_bounds__(kThreads)
    hh256_kernel(const uint8_t* __restrict__ data, int64_t row_stride,
                 int64_t B, int64_t L, u64 k0, u64 k1, u64 k2, u64 k3,
                 u64* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int lane = threadIdx.x;
  const int c = lane >> 1;          // chain within the block
  const int h = lane & 1;           // which half of the state
  const int64_t row = (int64_t)blockIdx.x * kChains + c;
  const bool active = row < B;
  const uint8_t* p = data + (active ? row : B - 1) * row_stride;

  Half s;
  const u64 key0 = h ? k2 : k0, key1 = h ? k3 : k1;
  s.mul0[0] = kInit0[2 * h];
  s.mul0[1] = kInit0[2 * h + 1];
  s.mul1[0] = kInit1[2 * h];
  s.mul1[1] = kInit1[2 * h + 1];
  s.v0[0] = s.mul0[0] ^ key0;
  s.v0[1] = s.mul0[1] ^ key1;
  s.v1[0] = s.mul1[0] ^ swap32(key0);
  s.v1[1] = s.mul1[1] ^ swap32(key1);

  // The chain's bytes as a stream of aligned 16-byte chunks from `base`.
  const int shift = (int)((uintptr_t)p & 15);
  const uint8_t* base = p - shift;
  const int64_t n = L / 32;
  const int64_t nchunk = (shift + n * 32 + 15) >> 4;   // full packets only
  const int64_t nstage = (n + kPackets - 1) / kPackets;
  uint32_t* ring = smem + c * kRingStride + 8 * (c & 3);
  const uint32_t ring_addr = (uint32_t)__cvta_generic_to_shared(ring);
  const int o2 = (shift >> 3) & 1, o1 = (shift >> 2) & 1;
  const unsigned sh = 8u * (shift & 3);

  // Window st of the stream into its ring slot; the pair of threads copies
  // 32 contiguous bytes per instruction.
  auto issue = [&](int64_t st) {
#pragma unroll
    for (int i = 0; i < kChunksPerWindow / 2; ++i) {
      const int64_t q = st * kChunksPerWindow + 2 * i + h;
      if (q < nchunk)
        cp_async16(ring_addr + (uint32_t)((q * 16) & (kRingWords * 4 - 1)),
                   base + q * 16);
    }
  };

  for (int st = 0; st < kStages - 1; ++st) {
    issue(st);
    cp_async_commit();
  }
  for (int64_t st = 0; st < nstage; ++st) {
    issue(st + kStages - 1);        // the slot freed by window st - 1
    cp_async_commit();
    cp_async_wait<kStages - 2>();   // windows st and st + 1 have landed
    __syncthreads();
    const int64_t t0 = st * kPackets;
    const int cnt = n - t0 < kPackets ? (int)(n - t0) : kPackets;
    const int w0 = (int)((t0 * 8 + 4 * h) & (kRingWords - 1));
    u64 l0, l1;
    if (cnt == kPackets) {
      // A full window. The shared-memory reads do not depend on the state:
      // each packet's are issued before the previous packet's update.
      read_lanes(ring, w0, o2, o1, sh, l0, l1);
#pragma unroll
      for (int u = 0; u < kPackets; ++u) {
        u64 n0 = 0, n1 = 0;
        if (u + 1 < kPackets)
          read_lanes(ring, (w0 + 8 * (u + 1)) & (kRingWords - 1), o2, o1, sh,
                     n0, n1);
        update(s, l0, l1);
        l0 = n0;
        l1 = n1;
      }
    } else {
      for (int u = 0; u < cnt; ++u) {
        read_lanes(ring, (w0 + 8 * u) & (kRingWords - 1), o2, o1, sh, l0, l1);
        update(s, l0, l1);
      }
    }
    __syncthreads();                // every thread is done with window st
  }
  cp_async_wait<0>();

  const int rem = (int)(L % 32);
  if (rem) {
    const uint8_t* tail = p + n * 32;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      s.v0[i] += ((u64)rem << 32) + (u64)rem;
      s.v1[i] = rot32_halves(s.v1[i], rem);
    }
    uint32_t wd[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t v = 0;
#pragma unroll
      for (int a = 0; a < 4; ++a)
        v |= remainder_byte(tail, rem, 16 * h + 4 * q + a) << (8 * a);
      wd[q] = v;
    }
    update(s, ((u64)wd[1] << 32) | wd[0], ((u64)wd[3] << 32) | wd[2]);
  }

  // Permute rounds: lanes 2h, 2h+1 take swap32 of the partner's v0.
  for (int i = 0; i < 10; ++i) {
    const u64 p0 = __shfl_xor_sync(0xFFFFFFFFu, s.v0[0], 1);
    const u64 p1 = __shfl_xor_sync(0xFFFFFFFFu, s.v0[1], 1);
    update(s, swap32(p0), swap32(p1));
  }
  u64 m0, m1;
  mod_reduction(s.v1[1] + s.mul1[1], s.v1[0] + s.mul1[0],
                s.v0[1] + s.mul0[1], s.v0[0] + s.mul0[0], m1, m0);
  if (active) {
    u64* o = out + row * 4 + 2 * h;
    o[0] = m0;
    o[1] = m1;
  }
}

}  // namespace

// Row b of the (B, L) chunks starts at data + b*row_stride; its digest goes
// to out + 32*b (out must be 8-byte aligned). key0..key3 are the 32-byte key
// as little-endian u64 words.
extern "C" int hh256_launch(const void* data, int64_t row_stride, int64_t B,
                            int64_t L, uint64_t key0, uint64_t key1,
                            uint64_t key2, uint64_t key3, void* out,
                            void* stream) {
  if (B <= 0) return 0;
  if (L <= 0) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (B + kChains - 1) / kChains;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      hh256_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  hh256_kernel<<<(unsigned)blocks, kThreads, kSmemBytes,
                 (cudaStream_t)stream>>>((const uint8_t*)data, row_stride, B,
                                         L, key0, key1, key2, key3,
                                         (u64*)out);
  return (int)cudaGetLastError();
}
