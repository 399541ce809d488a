// GF(2^8) linear map over shard bytes, for sm_90a.
//
// Replaces: minio_tpu/ops/rs_pallas.py `_kernel` (launched by pl.pallas_call
// in `_apply_jit`), the repo's only Pallas kernel. It serves RS encode,
// degraded-read decode and heal: only the matrix differs between them.
//
// What it computes: out[b, i, s] = XOR_j M[i, j] * x[b, j, s] in GF(2^8),
// with M given as its (8r, 8k) GF(2) bit-plane lowering
// (gf256.gf_matrix_to_bitplane: row i*8+b is bit b of output byte i,
// column j*8+a is bit a of input byte j). The kernel works on packed bytes,
// four byte columns to a 32-bit word, and never counts bits:
//
//   M_{j,a} = bit a of every byte of x_j, spread to a full-byte mask
//             (shift bit a to bit 7, then PRMT replicates each byte's sign)
//   C_{i,j,a} = the byte sum_b bit(i*8+b, j*8+a) << b, in all four bytes
//   out_i ^= M_{j,a} & C_{i,j,a}              (one LOP3 per term)
//
// exact for any 0/1 bit-plane matrix (encode, decode, regen). The C words
// are packed on the host (rs_gpu.pack_bitplane, an (8k, r rounded up to 4)
// table cached per device) and staged in shared memory per block, where a
// warp-uniform LDS.128 fetches four of them for 16 LOP3s.
//
// What bounds it on an H100: the bytes are B*(k + r)*S (reads once, writes
// once) against 3.35 TB/s; the bit-plane product as int8 tensor-core work
// (2*(8r)*(8k)*S*B operations against 1,979 TOP/s) is lower for every RS
// (k, r) the data plane uses, so instruction issue must stay near the byte
// rate. The REGEN class's maps (12+4: k = 114, r = 240 and 114) are bound
// by that product instead, and this scheme's instruction count runs above
// it there.
// Counting bits (an AND + POPC per output bit of a column) cannot keep
// near the byte rate: POPC issues at a quarter of the integer rate on
// sm_90, 2.7 G of them at 8+4 over the main path's 41.9 M columns. Here a
// column costs
// k*(8 + 4r)/2 full-rate integer instructions plus k*ceil(r/4)/2 LDS.128
// (8+4: 96 + 4), all on packed words, and each thread takes 16
// neighbouring columns with 16-byte loads and stores: with the issue rate
// near the byte rate, the kernel sits close to the byte bound.
//
// Why not mma.sync on 0/1 planes: that needs the 8k input bits of every
// column unpacked into int8 planes (8 bytes of register traffic per input
// byte) and each int32 sum reduced mod 2 and repacked into bits, about as
// many integer instructions as the LOP3 form before a single product,
// for a map whose operation count is already below its byte bound.
//
// Layout: each thread takes 16 byte columns of one batch row, grid-stride
// over (b, column group); all offsets 64-bit. Rows and strides that are all
// 16-byte aligned take uint4 loads and stores of 16 neighbouring columns
// (bytes one by one only at the ragged end of S). Otherwise (a shard size
// that is not a multiple of 16, as 12+4's 873,814, or a row view at an odd
// offset) the thread moves bytes one by one, its 16 columns 32 apart so
// that each byte access of a warp covers 32 contiguous bytes. With
// copy_data the thread also writes the input bytes into the output's data
// rows (encode_blocks's data + parity layout, or the shard-major one), so
// no separate concatenation pass runs. More than 8 output rows run as
// passes of up to 8 (R is a template parameter: R*4 accumulator words).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 16;          // byte columns per thread
constexpr int kMaxRows = 8;        // output rows per pass
constexpr int kMaxBlocks = 4096;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

struct Args {
  const uint8_t* x;
  int64_t xb, xr;
  uint8_t* out;
  int64_t ob, orow, orow0;
  int copy_data;
  const uint32_t* ctab;  // (8k, rpad) C words
  int rpad, i0, k;
  int64_t B, S;
};

// Each byte of y becomes 0xFF when its bit 7 is set, else 0x00.
__device__ __forceinline__ uint32_t sign_bytes(uint32_t y) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(y), "r"(0u), "r"(0xBA98u));
  return r;
}

// A thread's 16 byte columns: contiguous on the vector path (one uint4 when
// all 16 are in range), 32 apart on the byte path, where the 32 threads of
// a warp take neighbouring columns so that each byte load or store of the
// warp covers 32 contiguous bytes. ncol: how many of the 16 are in range.
template <bool VEC>
constexpr int kColStride = VEC ? 1 : 32;

template <bool VEC>
__device__ __forceinline__ void load16(const uint8_t* p, int ncol,
                                       uint32_t w[4]) {
  if (VEC && ncol == kCols) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) w[q] = 0;
#pragma unroll
  for (int q = 0; q < kCols; ++q)
    if (q < ncol)
      w[q >> 2] |= (uint32_t)__ldg(p + q * kColStride<VEC>) << (8 * (q & 3));
}

template <bool VEC>
__device__ __forceinline__ void store16(uint8_t* p, int ncol,
                                        const uint32_t w[4]) {
  if (VEC && ncol == kCols) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    return;
  }
#pragma unroll
  for (int q = 0; q < kCols; ++q)
    if (q < ncol)
      p[q * kColStride<VEC>] = (uint8_t)(w[q >> 2] >> (8 * (q & 3)));
}

template <int R, bool VEC>
__global__ void __launch_bounds__(kThreads) gf_apply_kernel(Args g) {
  constexpr int RS = (R + 3) / 4;  // uint4 of C words per table row
  extern __shared__ uint4 ctab_s[];  // (8k, RS): rows i0 .. i0+R-1
  uint32_t* cw = reinterpret_cast<uint32_t*>(ctab_s);
  const int nwords = 8 * g.k * RS * 4;
  for (int e = threadIdx.x; e < nwords; e += blockDim.x) {
    const int row = e / (RS * 4), ii = e % (RS * 4);
    cw[e] = ii < R ? g.ctab[(int64_t)row * g.rpad + g.i0 + ii] : 0u;
  }
  __syncthreads();

  // An item is 16 columns of one thread (vector path) or 512 columns of
  // one warp (byte path), of one batch row; grid-stride over the items.
  constexpr int kStride = kColStride<VEC>;
  constexpr int kTile = kCols * kStride;
  const int64_t nt = (g.S + kTile - 1) / kTile;
  const int64_t items = g.B * nt;
  const int64_t step = (int64_t)gridDim.x * blockDim.x / kStride;
  const int lane = VEC ? 0 : (int)(threadIdx.x & 31);
  const int64_t first =
      ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / kStride;
  for (int64_t it = first; it < items; it += step) {
    const int64_t b = it / nt;
    const int64_t s0 = (it - b * nt) * kTile + lane;
    const int64_t left = (g.S - s0 + kStride - 1) / kStride;
    const int ncol = g.S <= s0 ? 0 : (left < kCols ? (int)left : kCols);
    const uint8_t* xp = g.x + b * g.xb + s0;
    uint8_t* op = g.out + b * g.ob + s0;
    uint32_t acc[R][4];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] = 0;
    for (int j = 0; j < g.k; ++j) {
      uint32_t w[4];
      load16<VEC>(xp + j * g.xr, ncol, w);
      if (g.copy_data) store16<VEC>(op + j * g.orow, ncol, w);
      const uint4* c = ctab_s + j * 8 * RS;
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        uint32_t m[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) m[q] = sign_bytes(w[q] << (7 - a));
#pragma unroll
        for (int gi = 0; gi < RS; ++gi) {
          const uint4 c4 = c[a * RS + gi];
          const uint32_t cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
          for (int ii = 0; ii < 4; ++ii) {
            if (gi * 4 + ii < R) {
#pragma unroll
              for (int q = 0; q < 4; ++q)
                acc[gi * 4 + ii][q] ^= m[q] & cv[ii];
            }
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
      store16<VEC>(op + (g.orow0 + g.i0 + i) * g.orow, ncol, acc[i]);
  }
}

template <int R, bool VEC>
cudaError_t run(const Args& a, unsigned blocks, cudaStream_t st) {
  const size_t smem = (size_t)8 * a.k * ((R + 3) / 4) * 16;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        gf_apply_kernel<R, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  gf_apply_kernel<R, VEC><<<blocks, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t run_rows(int R, const Args& a, unsigned blocks,
                     cudaStream_t st) {
  switch (R) {
    case 1: return run<1, VEC>(a, blocks, st);
    case 2: return run<2, VEC>(a, blocks, st);
    case 3: return run<3, VEC>(a, blocks, st);
    case 4: return run<4, VEC>(a, blocks, st);
    case 5: return run<5, VEC>(a, blocks, st);
    case 6: return run<6, VEC>(a, blocks, st);
    case 7: return run<7, VEC>(a, blocks, st);
    default: return run<8, VEC>(a, blocks, st);
  }
}

}  // namespace

// x[b, j, s] at x + b*x_bstride + j*x_rstride + s (j < k);
// parity byte i of batch b at out + b*o_bstride + (o_row0 + i)*o_rstride + s;
// with copy_data, data byte j at out + b*o_bstride + j*o_rstride + s.
// ctab: (8k, rpad) uint32 C words on the device, rpad = r rounded up to 4
// (rs_gpu.pack_bitplane).
extern "C" int gf_apply_launch(const void* x, int64_t x_bstride,
                               int64_t x_rstride, void* out,
                               int64_t o_bstride, int64_t o_rstride,
                               int64_t o_row0, int copy_data,
                               const void* ctab, int r, int k, int64_t B,
                               int64_t S, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (r <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  Args a{(const uint8_t*)x, x_bstride, x_rstride, (uint8_t*)out,
         o_bstride, o_rstride, o_row0, copy_data, (const uint32_t*)ctab,
         (r + 3) & ~3, 0, k, B, S};
  const uint64_t align = (uint64_t)(uintptr_t)x | (uint64_t)(uintptr_t)out |
                         (uint64_t)x_bstride | (uint64_t)x_rstride |
                         (uint64_t)o_bstride | (uint64_t)o_rstride;
  const bool vec = (align & 15) == 0;
  const int64_t threads = vec ? B * ((S + kCols - 1) / kCols)
                              : B * ((S + 32 * kCols - 1) / (32 * kCols)) * 32;
  const int64_t want = (threads + kThreads - 1) / kThreads;
  const unsigned blocks = (unsigned)(want < kMaxBlocks ? want : kMaxBlocks);
  cudaStream_t st = (cudaStream_t)stream;
  for (int i0 = 0; i0 < r; i0 += kMaxRows) {
    a.i0 = i0;
    a.copy_data = copy_data && i0 == 0;
    const int R = r - i0 < kMaxRows ? r - i0 : kMaxRows;
    const cudaError_t err = vec ? run_rows<true>(R, a, blocks, st)
                                : run_rows<false>(R, a, blocks, st);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
