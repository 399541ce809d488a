// Columnar S3 Select predicate scan, bind included, for sm_90a.
//
// Replaces: minio_tpu/ops/select_kernels.py:163 `_build_jit` together with
// `_bind_jit` (:113), `_run_jit` (:153) and the `val & valid & ~fb` of its
// eval_predicate (:93): the WHERE clause of a plan, traced under jax.jit
// once per plan, evaluated element by element on float32 images of the
// referenced columns that the host built first.
//
// What it computes: for every row i of one batch, the (pass, fallback) row
// masks, from the raw columns. The plan is lowered ONCE on the host
// (ops/select_kernels.py `lower_program`) into a postfix program of int4
// instructions (op | flags << 8, a, b, c), a pool of (value, valid)
// constants and a list of IN options; the opcodes, flags and dtype codes
// are those of select_kernels.py. Compiling CUDA per query would cost
// seconds of nvcc on the serving path, so one kernel runs every plan. Each
// referenced column arrives as its raw value buffer (float32, int32,
// uint32 or bool bytes) with a null and a miss byte mask where the column
// has them (a null pointer reads nothing). The kernel computes what the
// reference's bind did on the host: valid = !(null | miss), the float32
// image, and fallback = (|v| > 2^24) & valid for int columns. The 2^24
// test runs in unsigned arithmetic (v + 2^24 > 2^25 as u32), so INT32_MIN
// does not overflow; for |v| <= 2^24 the int -> float32 conversion is
// exact, and a row past it leaves `pass` through the fallback mask, so the
// conversion's rounding never reaches an answer. Comparisons are IEEE
// float32 (NaN compares false except for !=): build without fast math.
//
// What bounds it on an H100: bytes. Each referenced column is read once a
// row (4 bytes, 1 for bool, plus 1 for each mask it has) and two 1-byte
// masks are written: for a plan over three REQUIRED 4-byte columns 14
// bytes a row against 3.35 TB/s. The design keeps the instruction count
// near that:
// - Eight rows a thread (kRows), and every flag of a value (truth, valid,
//   miss) an 8-bit mask of those rows, so one logic instruction serves
//   eight rows and the instruction fetch, the switch and the reads of a
//   column's descriptor are paid once per eight rows. (Four and sixteen
//   rows a thread measured slower at query 2's shape on the H100.)
// - Every comparison of two leaves (a column or a constant) is one fused
//   instruction; BETWEEN and IN over leaves read their value once. What
//   is left on the stack is two bits a row (truth, valid), kept as 8-bit
//   entries in NW 32-bit registers shifted on push and pop (funnel shifts
//   with constant indices): no array is indexed at run time, so nothing
//   lives in local memory. The launcher picks NW from the program's depth:
//   1 word (depth <= 4), 2 (<= 8) or 16 (<= 64, select_kernels.MAX_STACK).
// - A column's fallback rows are found where the program reads it (OP_TOUCH
//   reads a column nothing else reads), so no pass reads a column for
//   them alone. A thread reads a 4-byte column with two 16-byte loads
//   where its rows are 16-byte aligned, bool values and masks with 4-byte
//   loads; unaligned starts and the ragged tail take scalar loads. The
//   masks are stored as
//   bytes in 4-byte stores, and a flag word is set when any fallback row
//   is, so the host copies that mask back only then.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 32;
constexpr int kRows = 8;                      // rows a thread
constexpr unsigned kAll = (1u << kRows) - 1;  // all of them, as a mask
constexpr int kVecs = kRows / 4;              // 16-byte loads a column
constexpr int kMaxWords = 64 * kRows / 32;    // a stack of MAX_STACK

enum Op : int {
  OP_CMP = 0,
  OP_BETWEEN = 1,
  OP_IN = 2,
  OP_PUSH = 3,
  OP_CMP_STACK = 4,
  OP_BETWEEN_STACK = 5,
  OP_IN_END = 6,
  OP_ISNULL_STACK = 7,
  OP_AND = 8,
  OP_OR = 9,
  OP_NOT = 10,
  OP_TOUCH = 11,
};

constexpr int kCmpShift = 8;
constexpr int kNeg = 1 << 11;
constexpr int kCompares = 1 << 12;
constexpr int kComparesHi = 1 << 13;
constexpr int kModeShift = 14;
constexpr int kMissing = 1 << 14;
constexpr int kNullKind = 1 << 16;

enum Mode : int { MODE_VALUE = 0, MODE_OPERAND = 1, MODE_ISNULL = 2,
                  MODE_ISMISSING = 3 };
enum Dtype : int { DT_F32 = 0, DT_I32 = 1, DT_U32 = 2, DT_BOOL = 3,
                   DT_ABSENT = 4 };

// The rows [i0, i0 + nr) of a thread; nr < kRows only at the tail.
struct Group {
  int64_t i0;
  int nr;
};

// One leaf at a thread's rows.
struct Rows {
  float v[kRows];
  unsigned valid;   // kRows-bit masks, bit r = row i0 + r
  unsigned miss;
};

// A stack of kRows-bit entries, the top in the low bits of w[0].
template <int NW>
struct BitStack {
  unsigned w[NW];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int i = 0; i < NW; ++i) w[i] = 0u;
  }
  __device__ __forceinline__ void push(unsigned e) {
#pragma unroll
    for (int i = NW - 1; i > 0; --i)
      w[i] = __funnelshift_l(w[i - 1], w[i], kRows);
    w[0] = (w[0] << kRows) | e;
  }
  __device__ __forceinline__ unsigned pop() {
    const unsigned e = w[0] & kAll;
#pragma unroll
    for (int i = 0; i < NW - 1; ++i)
      w[i] = __funnelshift_r(w[i], w[i + 1], kRows);
    w[NW - 1] >>= kRows;
    return e;
  }
};

// Bit r of the result: byte r of w is nonzero.
__device__ __forceinline__ unsigned nonzero_nibble(unsigned w) {
  const unsigned b = __vcmpne4(w, 0u) & 0x01010101u;
  return ((b * 0x01020408u) >> 24) & 0xFu;
}

// Byte r of the result: bit r of m (0 or 1).
__device__ __forceinline__ unsigned nibble_bytes(unsigned m) {
  return (m * 0x00204081u) & 0x01010101u;
}

// Row r's byte of the output at p: bit r of m; 4-byte stores where
// aligned.
__device__ __forceinline__ void store_mask(unsigned char* p, const Group& g,
                                           unsigned m) {
  if (g.nr == kRows && (reinterpret_cast<uintptr_t>(p) & 3) == 0) {
#pragma unroll
    for (int k = 0; k < kVecs; ++k)
      reinterpret_cast<unsigned*>(p)[k] = nibble_bytes((m >> (4 * k)) & 0xFu);
    return;
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    if (r < g.nr) p[r] = (unsigned char)((m >> r) & 1u);
}

// The mask of a thread's rows whose byte is nonzero: one 4-byte load
// for every four rows where aligned.
__device__ __forceinline__ unsigned load_mask(const unsigned char* p,
                                             const Group& g) {
  const unsigned char* q = p + g.i0;
  unsigned m = 0u;
  if (g.nr == kRows && (reinterpret_cast<uintptr_t>(q) & 3) == 0) {
#pragma unroll
    for (int k = 0; k < kVecs; ++k)
      m |= nonzero_nibble(__ldg(reinterpret_cast<const unsigned*>(q) + k))
           << (4 * k);
    return m;
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    if (r < g.nr && __ldg(q + r)) m |= 1u << r;
  return m;
}

// The 4-byte words of a thread's rows (zero past the tail): 16-byte
// loads where aligned.
__device__ __forceinline__ void load_words(const unsigned* p, const Group& g,
                                           unsigned (&w)[kRows]) {
  const unsigned* q = p + g.i0;
  if (g.nr == kRows && (reinterpret_cast<uintptr_t>(q) & 15) == 0) {
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(q) + k);
      w[4 * k] = v.x;
      w[4 * k + 1] = v.y;
      w[4 * k + 2] = v.z;
      w[4 * k + 3] = v.w;
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    w[r] = 0u;
    if (r < g.nr) w[r] = __ldg(q + r);
  }
}

// Column c's descriptor: values, null mask, miss mask (device pointers or
// 0) and dtype code, four int64 each.
struct Column {
  const void* vals;
  const unsigned char* null;
  const unsigned char* miss;
  int dtype;
};

__device__ __forceinline__ Column column(const long long* cols, int c) {
  const long long* d = cols + 4 * c;
  Column col;
  col.vals = reinterpret_cast<const void*>(__ldg(d));
  col.null = reinterpret_cast<const unsigned char*>(__ldg(d + 1));
  col.miss = reinterpret_cast<const unsigned char*>(__ldg(d + 2));
  col.dtype = (int)__ldg(d + 3);
  return col;
}

__device__ __forceinline__ void column_flags(const Column& col,
                                             const Group& g,
                                             unsigned& valid,
                                             unsigned& miss) {
  const unsigned nu = col.null ? load_mask(col.null, g) : 0u;
  miss = col.miss ? load_mask(col.miss, g) : 0u;
  valid = ~(nu | miss) & kAll;
}

// A leaf operand: column ref (>= 0) or pool constant ~ref. Reading an int
// column also ORs its rows past float32's exact-integer range, where
// valid, into fb (every read of a column adds the same rows).
__device__ __forceinline__ Rows read_leaf(int ref, const long long* cols,
                                          const float2* pool, const Group& g,
                                          unsigned& fb) {
  Rows x;
  if (ref < 0) {
    const float2 k = __ldg(pool + ~ref);
#pragma unroll
    for (int r = 0; r < kRows; ++r) x.v[r] = k.x;
    x.valid = k.y != 0.0f ? kAll : 0u;
    x.miss = 0u;
    return x;
  }
  const Column col = column(cols, ref);
  if (col.dtype == DT_ABSENT) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) x.v[r] = 0.0f;
    x.valid = 0u;
    x.miss = kAll;
    return x;
  }
  if (col.dtype == DT_BOOL) {
    const unsigned b =
        load_mask(static_cast<const unsigned char*>(col.vals), g);
#pragma unroll
    for (int r = 0; r < kRows; ++r) x.v[r] = (b >> r) & 1u ? 1.0f : 0.0f;
  } else {
    unsigned u[kRows];
    load_words(static_cast<const unsigned*>(col.vals), g, u);
    unsigned big = 0u;
    if (col.dtype == DT_F32) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) x.v[r] = __uint_as_float(u[r]);
    } else if (col.dtype == DT_I32) {   // |v| > 2^24, without overflow
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        x.v[r] = __int2float_rn((int)u[r]);
        big |= u[r] + (1u << 24) > (2u << 24) ? 1u << r : 0u;
      }
    } else {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        x.v[r] = __uint2float_rn(u[r]);
        big |= u[r] > (1u << 24) ? 1u << r : 0u;
      }
    }
    column_flags(col, g, x.valid, x.miss);
    fb |= big & x.valid;
    return x;
  }
  column_flags(col, g, x.valid, x.miss);
  return x;
}

struct Eq { __device__ bool operator()(float a, float b) const { return a == b; } };
struct Ne { __device__ bool operator()(float a, float b) const { return a != b; } };
struct Lt { __device__ bool operator()(float a, float b) const { return a < b; } };
struct Le { __device__ bool operator()(float a, float b) const { return a <= b; } };
struct Gt { __device__ bool operator()(float a, float b) const { return a > b; } };
struct Ge { __device__ bool operator()(float a, float b) const { return a >= b; } };

template <class C>
__device__ __forceinline__ unsigned rows_cmp(const Rows& a, const Rows& b,
                                             C cmp) {
  unsigned m = 0u;
#pragma unroll
  for (int r = 0; r < kRows; ++r) m |= cmp(a.v[r], b.v[r]) ? 1u << r : 0u;
  return m;
}

// The comparison `code` (select_kernels.CMP_CODES) of two leaves, row by
// row; the switch is the same for every thread.
__device__ __forceinline__ unsigned compare(int code, const Rows& a,
                                            const Rows& b) {
  switch (code) {
    case 0: return rows_cmp(a, b, Eq());
    case 1: return rows_cmp(a, b, Ne());
    case 2: return rows_cmp(a, b, Lt());
    case 3: return rows_cmp(a, b, Le());
    case 4: return rows_cmp(a, b, Gt());
    default: return rows_cmp(a, b, Ge());
  }
}

// The same comparison of two truth masks (False < True).
__device__ __forceinline__ unsigned compare_bits(int code, unsigned a,
                                                 unsigned b) {
  switch (code) {
    case 0: return ~(a ^ b);
    case 1: return a ^ b;
    case 2: return ~a & b;
    case 3: return ~a | b;
    case 4: return a & ~b;
    default: return a | ~b;
  }
}

template <int NW>
__global__ void __launch_bounds__(kThreads)
select_scan_kernel(const int4* __restrict__ prog, int n_ops,
                   const float2* __restrict__ pool,
                   const int* __restrict__ args,
                   const long long* __restrict__ cols, int ncols, int64_t n,
                   unsigned char* __restrict__ out_pass,
                   unsigned char* __restrict__ out_fb,
                   unsigned* __restrict__ any_fb) {
  const int64_t groups = (n + kRows - 1) / kRows;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  unsigned fb_seen = 0u;
  for (int64_t gi = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       gi < groups; gi += stride) {
    Group g;
    g.i0 = gi * kRows;
    g.nr = n - g.i0 < kRows ? (int)(n - g.i0) : kRows;
    const unsigned rows = (1u << g.nr) - 1u;
    unsigned fb = 0u;

    BitStack<NW> st, sv;   // truth, valid
    st.clear();
    sv.clear();
    for (int pc = 0; pc < n_ops; ++pc) {
      const int4 ins = __ldg(prog + pc);
      const int fl = ins.x;
      const int code = (fl >> kCmpShift) & 7;
      const unsigned neg = fl & kNeg ? kAll : 0u;
      switch (fl & 0xFF) {
        case OP_CMP: {
          const Rows a = read_leaf(ins.y, cols, pool, g, fb);
          const Rows b = read_leaf(ins.z, cols, pool, g, fb);
          const unsigned v = a.valid & b.valid;
          st.push(fl & kCompares ? compare(code, a, b) & v : 0u);
          sv.push(v);
          break;
        }
        case OP_BETWEEN: {
          const Rows x = read_leaf(ins.y, cols, pool, g, fb);
          const Rows lo = read_leaf(ins.z, cols, pool, g, fb);
          const Rows hi = read_leaf(ins.w, cols, pool, g, fb);
          const unsigned vlo = x.valid & lo.valid;
          const unsigned vhi = x.valid & hi.valid;
          const unsigned tlo = fl & kCompares ? rows_cmp(x, lo, Ge()) & vlo
                                              : 0u;
          const unsigned thi = fl & kComparesHi ? rows_cmp(x, hi, Le()) & vhi
                                                : 0u;
          const unsigned v = vlo & vhi;
          st.push(((tlo & thi) ^ neg) & v);
          sv.push(v);
          break;
        }
        case OP_IN: {
          const Rows x = read_leaf(ins.y, cols, pool, g, fb);
          unsigned hit = 0u;
          for (int k = 0; k < ins.w; ++k) {
            const Rows o =
                read_leaf(__ldg(args + ins.z + k), cols, pool, g, fb);
            hit |= rows_cmp(x, o, Eq()) & o.valid;
          }
          st.push((hit ^ neg) & x.valid);
          sv.push(x.valid);
          break;
        }
        case OP_PUSH: {
          const Rows x = read_leaf(ins.y, cols, pool, g, fb);
          const int mode = (fl >> kModeShift) & 3;
          if (mode == MODE_ISNULL) {
            st.push((~x.valid ^ neg) & kAll);
            sv.push(kAll);
          } else if (mode == MODE_ISMISSING) {
            st.push(x.miss ^ neg);
            sv.push(kAll);
          } else {
            unsigned truthy = 0u;
            if (!(fl & kNullKind)) {
#pragma unroll
              for (int r = 0; r < kRows; ++r)
                truthy |= x.v[r] != 0.0f ? 1u << r : 0u;
            }
            const unsigned t = truthy & x.valid;
            if (mode == MODE_VALUE) {
              st.push(t);
              sv.push(x.valid);
            } else {   // an operand of AND / OR / NOT: MISSING is truthy
              st.push(t | x.miss);
              sv.push(x.valid | x.miss);
            }
          }
          break;
        }
        case OP_CMP_STACK: {
          const unsigned tr = st.pop(), vr = sv.pop();
          const unsigned tl = st.pop(), vl = sv.pop();
          const unsigned v = vl & vr;
          st.push(fl & kCompares ? compare_bits(code, tl, tr) & v : 0u);
          sv.push(v);
          break;
        }
        case OP_BETWEEN_STACK: {
          const unsigned thi = st.pop(), vhi = sv.pop();
          const unsigned tlo = st.pop(), vlo = sv.pop();
          const unsigned v = vlo & vhi;
          st.push(((tlo & thi) ^ neg) & v);
          sv.push(v);
          break;
        }
        case OP_IN_END: {
          const unsigned hit = st.pop();
          sv.pop();
          st.pop();
          const unsigned v = sv.pop();
          st.push((hit ^ neg) & v);
          sv.push(v);
          break;
        }
        case OP_ISNULL_STACK: {   // a computed value is never MISSING
          st.pop();
          const unsigned v = sv.pop();
          st.push(((fl & kMissing ? 0u : ~v) ^ neg) & kAll);
          sv.push(kAll);
          break;
        }
        case OP_AND:
        case OP_OR: {
          const unsigned tb = st.pop(), vb = sv.pop();
          const unsigned ta = st.pop(), va = sv.pop();
          if ((fl & 0xFF) == OP_AND) {
            st.push(ta & tb);
            sv.push((va & ~ta) | (vb & ~tb) | (va & vb));
          } else {
            st.push(ta | tb);
            sv.push(ta | tb | (va & vb));
          }
          break;
        }
        case OP_NOT: {
          const unsigned t = st.pop(), v = sv.pop();
          st.push(~t & v);
          sv.push(v);
          break;
        }
        case OP_TOUCH:   // a column no other instruction reads: its fb
          read_leaf(ins.y, cols, pool, g, fb);
          break;
        default:
          break;
      }
    }
    fb &= rows;
    const unsigned pass = st.pop() & ~fb & rows;
    store_mask(out_pass + g.i0, g, pass);
    store_mask(out_fb + g.i0, g, fb);
    fb_seen |= fb;
  }
  if (__any_sync(0xffffffffu, fb_seen != 0u) && (threadIdx.x & 31) == 0)
    atomicOr(any_fb, 1u);
}

}  // namespace

// 32-bit words of the stack for a program of this depth: 1, 2 or
// kMaxWords; 0 past the kernel's depth.
extern "C" int select_scan_stack_words(int depth) {
  const int bits = depth * kRows;
  if (depth < 1 || bits > 32 * kMaxWords) return 0;
  return bits <= 32 ? 1 : bits <= 64 ? 2 : kMaxWords;
}

// prog: (n_ops, 4) int32 instructions, pool: (p, 2) float32 constants,
// args: int32 IN options, cols: (ncols, 4) int64 column descriptors
// (values, null, miss, dtype code), all on the device. out_pass / out_fb:
// n bytes, written 0 / 1; any_fb: one word, zeroed here and set to nonzero
// when a fallback row is. depth: the program's stack depth, 1..64, which
// picks the stack's width (select_scan_stack_words). The host checks that
// the program leaves one value.
extern "C" int select_scan_launch(const void* prog, int n_ops,
                                  const void* pool, const void* args,
                                  const void* cols, int ncols, int64_t n,
                                  int depth, void* out_pass, void* out_fb,
                                  void* any_fb, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t e = cudaMemsetAsync(any_fb, 0, sizeof(unsigned), s);
  if (e != cudaSuccess) return (int)e;
  const int words = select_scan_stack_words(depth);
  if (n_ops <= 0 || ncols < 0 || words == 0)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  int64_t blocks = ((n + kRows - 1) / kRows + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const int4* p = (const int4*)prog;
  const float2* k = (const float2*)pool;
  const int* a = (const int*)args;
  const long long* c = (const long long*)cols;
  unsigned char* op = (unsigned char*)out_pass;
  unsigned char* of = (unsigned char*)out_fb;
  unsigned* af = (unsigned*)any_fb;
  if (words == 1)
    select_scan_kernel<1><<<(unsigned)blocks, kThreads, 0, s>>>(
        p, n_ops, k, a, c, ncols, n, op, of, af);
  else if (words == 2)
    select_scan_kernel<2><<<(unsigned)blocks, kThreads, 0, s>>>(
        p, n_ops, k, a, c, ncols, n, op, of, af);
  else
    select_scan_kernel<kMaxWords><<<(unsigned)blocks, kThreads, 0, s>>>(
        p, n_ops, k, a, c, ncols, n, op, of, af);
  return (int)cudaGetLastError();
}
