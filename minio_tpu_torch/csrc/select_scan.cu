// Columnar S3 Select predicate scan (a predicate-program interpreter), for
// sm_90a.
//
// Replaces: minio_tpu/ops/select_kernels.py:163 `_build_jit` (with
// `_bind_jit` and `_run_jit`), which traces the s3select/compile.py node
// tree of a WHERE clause under jax.jit once per plan and evaluates it
// element by element on the float32 image of the referenced columns.
//
// What it computes: for every row i, SQL three-valued logic over the
// bound columns -> (val, valid) row masks. The plan is lowered ONCE on the
// host (ops/select_kernels.py `lower_program`) into a postfix program of
// int4 instructions (op, a, b, c) plus a float32 constant pool; the opcode
// numbers and the meaning of a, b, c are those of select_kernels.py OP_*.
// Compiling CUDA per query would cost seconds of nvcc on the serving path,
// so one interpreter, written once, runs every plan.
//
// Design: one thread per row, rows walked grid-stride with 64-bit offsets
// (any n, tails included). A per-thread stack of (val float, flags: bit 0
// valid, bit 1 miss) evaluates the program; bool values are 0.0 / 1.0.
// Every thread of a warp runs the same instruction, so the opcode switch
// does not diverge, and the instruction and column-pointer loads are
// warp-wide broadcasts through the read-only cache. Comparisons are IEEE
// float32 (NaN compares false except for !=): build without fast math.
//
// What bounds it on an H100: bytes. Each referenced column is read once
// per row (4 bytes of value, 1 of valid, 1 of miss) and two 1-byte masks
// are written, 6c + 2 bytes a row against 3.35 TB/s; the interpreter's
// few dozen scalar operations a row are far below the 67 T/s scalar rate.
// This first kernel re-reads a column that the program pushes twice (a
// BETWEEN pushes its value once for each bound) from the cache, keeps the
// stack in local memory, and issues 1-byte loads and stores, so it runs
// above that bound (times in PERF.md, from chip_smoke.py).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxStack = 64;   // select_kernels.MAX_STACK
constexpr int64_t kMaxBlocks = 132 * 16;

enum Op : int {
  OP_COL = 0,
  OP_CONST = 1,
  OP_CMP_NUM = 2,
  OP_CMP_BOOL = 3,
  OP_CMP_FALSE = 4,
  OP_BETWEEN = 5,
  OP_IN_OR = 6,
  OP_IN_END = 7,
  OP_ISNULL = 8,
  OP_AND = 9,
  OP_OR = 10,
  OP_NOT = 11,
};

constexpr unsigned kValid = 1u;
constexpr unsigned kMiss = 2u;

__device__ __forceinline__ bool compare(int code, float l, float r) {
  switch (code) {
    case 0: return l == r;
    case 1: return l != r;
    case 2: return l < r;
    case 3: return l <= r;
    case 4: return l > r;
    default: return l >= r;
  }
}

// (truth, defined) of a BoolOp / Not operand (compile.py _bool_operand):
// MISSING is truthy and defined; a value of kind null is never truthy.
__device__ __forceinline__ void bool_operand(float v, unsigned f,
                                             int null_kind, bool& truth,
                                             bool& defined) {
  const bool valid = f & kValid;
  const bool miss = f & kMiss;
  const bool truthy = !null_kind && v != 0.0f;
  truth = (truthy && valid) || miss;
  defined = valid || miss;
}

__global__ void select_scan_kernel(const int4* __restrict__ prog, int n_ops,
                                   const float* __restrict__ pool,
                                   const unsigned long long* __restrict__ cols,
                                   int64_t n, uint8_t* __restrict__ out_val,
                                   uint8_t* __restrict__ out_valid) {
  float sv[kMaxStack];
  unsigned sf[kMaxStack];
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    int sp = 0;
    for (int pc = 0; pc < n_ops; ++pc) {
      const int4 ins = __ldg(prog + pc);
      switch (ins.x) {
        case OP_COL: {
          const float* v = (const float*)__ldg(cols + 3 * ins.y);
          const uint8_t* valid = (const uint8_t*)__ldg(cols + 3 * ins.y + 1);
          const uint8_t* miss = (const uint8_t*)__ldg(cols + 3 * ins.y + 2);
          sv[sp] = __ldg(v + i);
          sf[sp] = (__ldg(valid + i) ? kValid : 0u) |
                   (__ldg(miss + i) ? kMiss : 0u);
          ++sp;
          break;
        }
        case OP_CONST:
          sv[sp] = __ldg(pool + ins.y);
          sf[sp] = (ins.z ? kValid : 0u) | (ins.w ? kMiss : 0u);
          ++sp;
          break;
        case OP_CMP_NUM:
        case OP_CMP_BOOL:
        case OP_CMP_FALSE: {
          --sp;
          const bool valid = (sf[sp - 1] & kValid) && (sf[sp] & kValid);
          bool val = false;
          if (ins.x != OP_CMP_FALSE) {
            val = compare(ins.y, sv[sp - 1], sv[sp]);
            if (ins.x == OP_CMP_NUM) val = val && valid;
          }
          sv[sp - 1] = val ? 1.0f : 0.0f;
          sf[sp - 1] = valid ? kValid : 0u;
          break;
        }
        case OP_BETWEEN: {
          --sp;
          bool val = sv[sp - 1] != 0.0f && sv[sp] != 0.0f;
          if (ins.y) val = !val;
          const bool valid = (sf[sp - 1] & kValid) && (sf[sp] & kValid);
          sv[sp - 1] = val ? 1.0f : 0.0f;
          sf[sp - 1] = valid ? kValid : 0u;
          break;
        }
        case OP_IN_OR: {
          --sp;
          const bool hit = sv[sp - 1] != 0.0f ||
                           (sv[sp] != 0.0f && (sf[sp] & kValid));
          sv[sp - 1] = hit ? 1.0f : 0.0f;
          break;
        }
        case OP_IN_END: {
          --sp;
          bool val = sv[sp] != 0.0f;
          if (ins.y) val = !val;
          sv[sp - 1] = val ? 1.0f : 0.0f;
          sf[sp - 1] &= kValid;
          break;
        }
        case OP_ISNULL: {
          bool val = ins.z ? (sf[sp - 1] & kMiss) != 0
                           : (sf[sp - 1] & kValid) == 0;
          if (ins.y) val = !val;
          sv[sp - 1] = val ? 1.0f : 0.0f;
          sf[sp - 1] = kValid;
          break;
        }
        case OP_AND:
        case OP_OR: {
          --sp;
          bool ta, va, tb, vb;
          bool_operand(sv[sp - 1], sf[sp - 1], ins.y, ta, va);
          bool_operand(sv[sp], sf[sp], ins.z, tb, vb);
          bool val, valid;
          if (ins.x == OP_AND) {
            val = ta && tb;
            valid = (va && !ta) || (vb && !tb) || (va && vb);
          } else {
            val = ta || tb;
            valid = val || (va && vb);
          }
          sv[sp - 1] = val ? 1.0f : 0.0f;
          sf[sp - 1] = valid ? kValid : 0u;
          break;
        }
        case OP_NOT: {
          bool t, defined;
          bool_operand(sv[sp - 1], sf[sp - 1], ins.y, t, defined);
          sv[sp - 1] = (!t && defined) ? 1.0f : 0.0f;
          sf[sp - 1] = defined ? kValid : 0u;
          break;
        }
        default:
          break;
      }
    }
    out_val[i] = sv[0] != 0.0f;
    out_valid[i] = (sf[0] & kValid) ? 1 : 0;
  }
}

}  // namespace

// prog: (n_ops, 4) int32 instructions and pool: float32 constants, on the
// device. cols: 3 * ncols u64 device pointers, per column (float32 values,
// uint8 valid, uint8 miss), each of n elements. out_val / out_valid: n
// bytes, written 0 / 1. The host checks the program's stack depth
// (<= kMaxStack) and that it leaves one value.
extern "C" int select_scan_launch(const void* prog, int n_ops,
                                  const void* pool, const void* cols,
                                  int ncols, int64_t n, void* out_val,
                                  void* out_valid, void* stream) {
  if (n <= 0) return 0;
  if (n_ops <= 0 || ncols < 0) return (int)cudaErrorInvalidValue;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  select_scan_kernel<<<(unsigned)blocks, kThreads, 0,
                       (cudaStream_t)stream>>>(
      (const int4*)prog, n_ops, (const float*)pool,
      (const unsigned long long*)cols, n, (uint8_t*)out_val,
      (uint8_t*)out_valid);
  return (int)cudaGetLastError();
}
