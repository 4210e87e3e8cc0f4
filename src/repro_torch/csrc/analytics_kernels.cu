// Aggregation kernels of the analytics hot path, written for Hopper
// (sm_90a) and bound through a plain C interface (ctypes, no PyTorch
// headers).  Each launcher returns the cudaError_t of its launch.
//
// They replace the three Pallas kernels of repro/analytics/kernels.py:
//
//   sage_fused_aggregate  <- _fused_kernel    (filter -> grouped reduce)
//   sage_segment_reduce   <- _segment_kernel  (grouped reduce by id)
//   sage_window_reduce    <- _window_kernel   (tumbling/sliding windows)
//
// What bounds them on the card: bytes.  Each row is read once (ids plus
// the columns the specs read, 4 B each) and does a handful of integer or
// float operations, far below the H100's ~20 operations per byte of
// HBM bandwidth.  The TPU kernels folded every row into a 128-segment
// block with a 128x128 lane-iota membership mask; here a row costs O(1)
// work instead of O(segments) (B1 and B2 below, B3 further down).
//
// The filter and value expressions arrive as a typed program (compiled on
// the host by repro_torch.analytics.kernels) in a __grid_constant__
// parameter block, so one build serves every query; every thread walks
// the same program, so the opcode switch does not diverge within a warp.
// Integer arithmetic wraps (two's complement) and `%` takes the sign of
// the divisor, as numpy and JAX define them.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr int kMaxCols = 16;
constexpr int kMaxCode = 128;
constexpr int kMaxLits = 64;
constexpr int kMaxStack = 16;
constexpr int kThreads = 256;            // B3's blocks

enum Op : int { kSum = 0, kCount = 1, kMin = 2, kMax = 3 };
enum DType : int { kI32 = 0, kF32 = 1 };

// Program opcodes; keep in sync with _OPCODES in analytics/kernels.py.
// An instruction is code = opcode | source << 8 | kRev, arg: the program
// runs on an accumulator A (the value of the top of the expression's
// stack).  LOAD sets A to its operand, PUSH spills A to stack level arg,
// a unary op maps A, and a binary op sets A = A op operand (with kRev,
// operand op A), the operand being a column slot, a literal or a spilled
// level, named by its source.
enum Code : int {
  C_LOAD = 0, C_PUSH = 1, C_I2F = 2, C_F2I = 3, C_F2B = 4,
  C_ADD_I = 10, C_SUB_I = 11, C_MUL_I = 12, C_MOD_I = 13,
  C_AND = 14, C_OR = 15, C_NOT_I = 16, C_NOT_B = 17,
  C_ADD_F = 20, C_SUB_F = 21, C_MUL_F = 22, C_DIV_F = 23, C_MOD_F = 24,
  C_GT_I = 30, C_GE_I = 31, C_LT_I = 32, C_LE_I = 33, C_EQ_I = 34,
  C_NE_I = 35,
  C_GT_F = 40, C_GE_F = 41, C_LT_F = 42, C_LE_F = 43, C_EQ_F = 44,
  C_NE_F = 45,
};
enum Src : int { S_NONE = 0, S_COL = 1, S_LIT = 2, S_STK = 3 };
constexpr int kRev = 1 << 10;

struct FusedParams {
  const int32_t* cols[kMaxCols];   // int32 or float32 bits, one per slot
  int code[kMaxCode];
  int arg[kMaxCode];
  int32_t lits[kMaxLits];          // int32 or float32 bits
  int n_pred;                      // pred program: code[0, n_pred)
  int n_val;                       // value program: code[n_pred, +n_val)
  int n_cols;                      // slots in use
};

template <typename T>
constexpr bool kIsF32 = std::is_same<T, float>::value;

__device__ __forceinline__ float bits_f(int32_t x) { return __int_as_float(x); }
__device__ __forceinline__ int32_t f_bits(float x) { return __float_as_int(x); }

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int32_t wrap_sub(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
}
__device__ __forceinline__ int32_t wrap_mul(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a * (uint32_t)b);
}

// floor modulo (numpy/JAX): x % 0 == 0, result takes the divisor's sign
__device__ __forceinline__ int32_t floor_mod_i(int32_t a, int32_t b) {
  if (b == 0 || b == -1) return 0;        // -1 also dodges INT_MIN % -1
  int32_t r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}
__device__ __forceinline__ float floor_mod_f(float a, float b) {
  float r = fmodf(a, b);
  if (r != 0.0f && ((r < 0.0f) != (b < 0.0f))) r = r + b;
  return r;
}

// ---------------------------------------------------------------------------
// folds shared by the kernels
// ---------------------------------------------------------------------------

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

template <typename T, int OP>
__device__ __forceinline__ T identity() {
  if constexpr (OP == kSum || OP == kCount) {
    return T(0);
  } else if constexpr (kIsF32<T>) {
    return OP == kMin ? __int_as_float(0x7f800000)     // +inf
                      : __int_as_float(0xff800000);    // -inf
  } else {
    return OP == kMin ? T(2147483647) : T(-2147483647 - 1);
  }
}

// where B1 and B2 start every segment: the reference's identities
// (repro.analytics.kernels._identity), whose int32 max is -INT32_MAX, so a
// segment of INT32_MIN values and an empty one both give -INT32_MAX there
template <typename T, int OP>
__device__ __forceinline__ T start() {
  if constexpr (!kIsF32<T> && OP == kMax) return T(-2147483647);
  else return identity<T, OP>();
}

// a fold of two partial results (counts add); f32 min/max propagate NaN
// as jnp.minimum / jnp.maximum do
template <typename T, int OP>
__device__ __forceinline__ T combine(T a, T b) {
  constexpr bool kAdd = OP == kSum || OP == kCount;
  if constexpr (kIsF32<T>) {
    return kAdd ? __fadd_rn(a, b)
         : OP == kMin ? nan_min(a, b) : nan_max(a, b);
  } else {
    return kAdd ? wrap_add(a, b)
         : OP == kMin ? (b < a ? b : a) : (b > a ? b : a);
  }
}

template <typename T>
__device__ __forceinline__ T from_bits(int32_t x) {
  if constexpr (kIsF32<T>) return bits_f(x);
  else return x;
}

// a fixed __shfl_xor_sync tree over the warp; every lane ends with the fold
template <typename T, int OP>
__device__ __forceinline__ T warp_fold(T acc) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    acc = combine<T, OP>(acc, __shfl_xor_sync(0xffffffffu, acc, o));
  return acc;
}

// float min/max have no native atomic: compare-and-swap on the bits,
// propagating NaN as jnp.minimum / jnp.maximum do
template <int OP>
__device__ __forceinline__ void atomic_minmax_f(float* addr, float v) {
  int* ia = reinterpret_cast<int*>(addr);
  int old = *reinterpret_cast<volatile int*>(ia);
  while (true) {
    const float cur = __int_as_float(old);
    const float nv = OP == kMin ? nan_min(cur, v) : nan_max(cur, v);
    const int nb = __float_as_int(nv);
    if (nb == old) return;
    const int prev = atomicCAS(ia, old, nb);
    if (prev == old) return;
    old = prev;
  }
}

// one row folded into global memory with an atomic (above kSmemSegments)
template <typename T, int OP>
__device__ __forceinline__ void atomic_fold(T* acc, int seg, T v) {
  if constexpr (OP == kSum) {
    atomicAdd(acc + seg, v);               // int32 wraps like np.add.at
  } else if constexpr (OP == kCount) {
    atomicAdd(acc + seg, T(1));
  } else if constexpr (kIsF32<T>) {
    atomic_minmax_f<OP>(acc + seg, v);
  } else if constexpr (OP == kMin) {
    atomicMin(acc + seg, v);
  } else {
    atomicMax(acc + seg, v);
  }
}

// ---------------------------------------------------------------------------
// B1 (fused filter -> grouped reduce) and B2 (grouped reduce by id)
//
// What bounds them: bytes (query (a): 4,194,304 ids and predicate values
// for every row, the value column for the survivors).  What held the
// first port back (measured on the H100): 0.0297 of its 0.0652 ms went to
// the loads, 0.0235 to walking the program a row at a time, 0.0036 to
// the fold, 0.0084 to a flush of global atomics from ~800 blocks.  The
// design reads each row once in 16-byte loads with many warps in flight
// and keeps every other cost per row a few instructions:
//
// * A persistent grid: one block of up to kMaxWarps warps an SM (fewer
//   blocks for a short call: kMinBlockRows rows a block at least), each
//   walking a contiguous run of rows in tiles of kRows rows a thread, an
//   int4 per array; a group of 4 rows that the run's end cuts, or whose
//   base pointer is not on 16 bytes, loads its rows one by one.  One
//   thread keeps a bulk L2 prefetch of the ids and columns kPrefetchTiles
//   tiles ahead.  B1 reads its value column only where a row survives,
//   B2's count never reads its values.
// * The program runs once per instruction for a thread's kRows rows: the
//   accumulator in registers, a spilled level in shared memory
//   ([level][row][thread]), so ptxas keeps no stack frame.
// * Tables in shared memory:
//     f32 sums over n_seg <= kLaneSegments: a table a thread
//       ([seg][thread], no bank conflicts), folded with a plain
//       read-modify-write, so the order of the sum is fixed;
//     every other op up to kLaneSegments: a table a warp, folded with
//       shared-memory atomics (query (c)'s 32-bin count: 32 x 32 words to
//       start and flush, no contention between warps);
//     up to kSmemSegments: one table a block, folded with shared-memory
//       atomics;
//     above: atomics into global memory.
//   f32 min/max fold as order-preserving int keys, so with native
//   atomicMin/atomicMax, NaN winning as in nan_min/nan_max.
// * Each block writes its partial plainly into scratch[G][n_seg] (the
//   start value and count 0 where it saw no row), and a second launch
//   (combine_kernel) folds the G partials of each segment in block order.
//
// So every result is the same bits from run to run except an f32 sum over
// more than kLaneSegments segments, whose shared (or global) atomics add
// in the order the warps arrive.  A table a warp, whose lanes sharing a
// segment fold by __match_any_sync and a fixed shuffle tree, made those
// sums repeat too, but 4,096 segments then fit 13 warps an SM, and the
// loads starved (0.0571 ms at query (a) against the first port's 0.0695
// in one run; PERF.md).
// ---------------------------------------------------------------------------

constexpr int kRows = 4;                 // rows a thread per tile
constexpr int kVecs = kRows / 4;         // its int4 loads per array
constexpr int kMaxWarps = 32;            // 1,024 threads a block at most
constexpr int kLaneSegments = 32;        // thread/warp tables up to here
constexpr int kSmemSegments = 8192;      // a table a block up to here
constexpr int64_t kMinBlockRows = 16384;
constexpr size_t kSmemBudget = 227 * 1024;
constexpr int kCombineParts = 32;        // second pass: 32 segments x 32
constexpr int kPrefetchTiles = 2;        // tiles the L2 prefetch runs ahead

enum Mode : int { kLane = 0, kBlock = 1, kGlobal = 2 };

// ask the copy engine to bring bytes (a multiple of 16, from a 16-byte
// boundary) into L2: no registers or shared memory, nothing to wait on
__device__ __forceinline__ void prefetch_l2(const void* p, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;"
               :: "l"(p), "r"(bytes) : "memory");
}

// one thread's rows in one tile: rows base[k] + j, j < 4; bit 4k + j of
// `live` says the row lies in the block's run
struct Span {
  int64_t base[kVecs];
  uint32_t live;
};

// c[row] for each row of the span whose bit is set in mask, else 0
__device__ __forceinline__ void load_rows(const int32_t* __restrict__ c,
                                          const Span& s, uint32_t mask,
                                          bool vec, int32_t (&out)[kRows]) {
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const uint32_t m = (mask >> (4 * k)) & 0xfu;
    if (vec && m == 0xfu) {
      const int4 q = __ldg(reinterpret_cast<const int4*>(c + s.base[k]));
      out[4 * k] = q.x;
      out[4 * k + 1] = q.y;
      out[4 * k + 2] = q.z;
      out[4 * k + 3] = q.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        out[4 * k + j] = (m >> j) & 1u ? __ldg(c + s.base[k] + j) : 0;
    }
  }
}

#define SAGE_ROWS(expr)                                    \
  _Pragma("unroll") for (int r = 0; r < kRows; ++r) {      \
    const int32_t x = A[r];                                \
    A[r] = (expr);                                         \
  }                                                        \
  break;

__device__ __forceinline__ void unary_rows(int op, int32_t (&A)[kRows]) {
  switch (op) {
    case C_I2F: SAGE_ROWS(f_bits((float)x))
    case C_F2I: SAGE_ROWS((int32_t)bits_f(x))          // truncates
    case C_F2B: SAGE_ROWS(bits_f(x) != 0.0f)           // NaN -> true
    case C_NOT_I: SAGE_ROWS(~x)
    case C_NOT_B: SAGE_ROWS(x ^ 1)
    default: break;
  }
}
#undef SAGE_ROWS

#define SAGE_ROWS(expr)                                    \
  _Pragma("unroll") for (int r = 0; r < kRows; ++r) {      \
    const int32_t l = A[r], y = B[r];                      \
    const float lf = bits_f(l), yf = bits_f(y);            \
    (void)lf; (void)yf;                                    \
    A[r] = (expr);                                         \
  }                                                        \
  break;

__device__ __forceinline__ void binary_rows(int op, int32_t (&A)[kRows],
                                            const int32_t (&B)[kRows]) {
  switch (op) {
    case C_ADD_I: SAGE_ROWS(wrap_add(l, y))
    case C_SUB_I: SAGE_ROWS(wrap_sub(l, y))
    case C_MUL_I: SAGE_ROWS(wrap_mul(l, y))
    case C_MOD_I: SAGE_ROWS(floor_mod_i(l, y))
    case C_AND: SAGE_ROWS(l & y)                         // no short-circuit
    case C_OR: SAGE_ROWS(l | y)
    case C_ADD_F: SAGE_ROWS(f_bits(__fadd_rn(lf, yf)))
    case C_SUB_F: SAGE_ROWS(f_bits(__fsub_rn(lf, yf)))
    case C_MUL_F: SAGE_ROWS(f_bits(__fmul_rn(lf, yf)))
    case C_DIV_F: SAGE_ROWS(f_bits(__fdiv_rn(lf, yf)))
    case C_MOD_F: SAGE_ROWS(f_bits(floor_mod_f(lf, yf)))
    case C_GT_I: SAGE_ROWS(l > y)
    case C_GE_I: SAGE_ROWS(l >= y)
    case C_LT_I: SAGE_ROWS(l < y)
    case C_LE_I: SAGE_ROWS(l <= y)
    case C_EQ_I: SAGE_ROWS(l == y)
    case C_NE_I: SAGE_ROWS(l != y)
    case C_GT_F: SAGE_ROWS(lf > yf)
    case C_GE_F: SAGE_ROWS(lf >= yf)
    case C_LT_F: SAGE_ROWS(lf < yf)
    case C_LE_F: SAGE_ROWS(lf <= yf)
    case C_EQ_F: SAGE_ROWS(lf == yf)
    case C_NE_F: SAGE_ROWS(lf != yf)
    default: break;
  }
}
#undef SAGE_ROWS

// run code[lo, hi) on the span's rows (columns read where `mask` is set);
// A ends as the program's value.  stk: this thread's first stack word,
// level l of row r at stk[(l * kRows + r) * blockDim.x].
__device__ __forceinline__ void run_rows(const FusedParams& p, int lo, int hi,
                                         const Span& s, uint32_t mask,
                                         bool vec, int32_t* stk,
                                         int32_t (&A)[kRows]) {
  const int nt = blockDim.x;
  for (int pc = lo; pc < hi; ++pc) {
    const int c = p.code[pc], a = p.arg[pc];
    const int op = c & 0xff, src = (c >> 8) & 3;
    if (op == C_PUSH) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) stk[(a * kRows + r) * nt] = A[r];
      continue;
    }
    if (src == S_NONE) {
      unary_rows(op, A);
      continue;
    }
    int32_t B[kRows];
    if (src == S_COL) {
      load_rows(p.cols[a], s, mask, vec, B);
    } else {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        B[r] = src == S_LIT ? p.lits[a] : stk[(a * kRows + r) * nt];
    }
    if (op == C_LOAD) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) A[r] = B[r];
      continue;
    }
    if (c & kRev) {
      int32_t L[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) L[r] = B[r];
#pragma unroll
      for (int r = 0; r < kRows; ++r) B[r] = A[r];
#pragma unroll
      for (int r = 0; r < kRows; ++r) A[r] = L[r];
    }
    binary_rows(op, A, B);
  }
}

// f32 min/max in a block table: an int key whose order is the float's
// (-0 below +0), NaN the least key for min and the greatest for max, so
// a NaN wins as it does in nan_min/nan_max
template <int OP>
__device__ __forceinline__ int f32_key(float v) {
  if (v != v) return OP == kMin ? (-2147483647 - 1) : 2147483647;
  const int b = __float_as_int(v);
  return b >= 0 ? b : b ^ 0x7fffffff;
}
__device__ __forceinline__ float key_f32(int k) {
  if (k == -2147483647 - 1 || k == 2147483647)
    return __int_as_float(0x7fc00000);
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

// one row folded into a block table with a shared-memory atomic
template <typename T, int OP>
__device__ __forceinline__ void block_fold(T* tab, int seg, T v) {
  if constexpr (OP == kSum) {
    atomicAdd(tab + seg, v);               // f32: in the order warps arrive
  } else if constexpr (OP == kCount) {
    atomicAdd(tab + seg, T(1));
  } else if constexpr (kIsF32<T>) {
    int* t = reinterpret_cast<int*>(tab) + seg;
    if constexpr (OP == kMin) atomicMin(t, f32_key<kMin>(v));
    else atomicMax(t, f32_key<kMax>(v));
  } else if constexpr (OP == kMin) {
    atomicMin(tab + seg, v);
  } else {
    atomicMax(tab + seg, v);
  }
}

// a block table's word for the start value (f32 min/max hold keys)
template <typename T, int OP>
__device__ __forceinline__ T block_start() {
  if constexpr (kIsF32<T> && (OP == kMin || OP == kMax))
    return __int_as_float(f32_key<OP>(start<T, OP>()));
  else return start<T, OP>();
}
template <typename T, int OP>
__device__ __forceinline__ T block_value(T word) {
  if constexpr (kIsF32<T> && (OP == kMin || OP == kMax))
    return key_f32(__float_as_int(word));
  else return word;
}
// two block-table words folded (f32 min/max: their keys)
template <typename T, int OP>
__device__ __forceinline__ T block_word(T a, T b) {
  if constexpr (kIsF32<T> && (OP == kMin || OP == kMax)) {
    const int x = __float_as_int(a), y = __float_as_int(b);
    return __int_as_float(OP == kMin ? (y < x ? y : x) : (y > x ? y : x));
  } else {
    return combine<T, OP>(a, b);
  }
}

// words of shared memory before the stack levels (`copies` block tables)
template <int MODE, bool CNT>
__host__ __device__ __forceinline__ int64_t table_words(int n_seg, int nt,
                                                        int copies) {
  if (MODE == kLane) return (int64_t)n_seg * nt * (CNT ? 2 : 1);
  if (MODE == kBlock) return (int64_t)n_seg * copies * (CNT ? 2 : 1);
  return 0;
}

// The body of B1 and B2: rows(s, keep, v) returns the rows of span s that
// survive (of `keep`, the rows with an id in [0, n_seg)) and sets v[r] for
// them.  part/part_cnt: this launch's [G][n_seg] partials (MODE != kGlobal);
// copies: kBlock's tables (one a warp, or 1); g_acc/g_cnt: the outputs
// (kGlobal only, prefilled).
template <typename T, int OP, int MODE, bool CNT, typename RowFn,
          typename PrefetchFn>
__device__ __forceinline__ void aggregate(
    const int32_t* __restrict__ ids, int64_t n, int64_t chunk, int n_seg,
    int copies, bool vec, T* __restrict__ part, int* __restrict__ part_cnt,
    T* __restrict__ g_acc, int* __restrict__ g_cnt, RowFn rows,
    PrefetchFn prefetch_cols) {
  extern __shared__ __align__(16) int smem[];
  const int nt = blockDim.x, tid = threadIdx.x;
  const int nw = nt >> 5, warp = tid >> 5, lane = tid & 31;
  T* tab = reinterpret_cast<T*>(smem);  // lane: [seg][nt]; block: [copy][seg]
  const int n_tab = MODE == kLane ? n_seg * nt : n_seg * copies;
  int* ctab = smem + n_tab;
  const int copy = copies > 1 ? warp * n_seg : 0;     // this warp's table
  if constexpr (MODE != kGlobal) {
    for (int i = tid; i < n_tab; i += nt)
      tab[i] = MODE == kLane ? start<T, OP>() : block_start<T, OP>();
    if (CNT)
      for (int i = tid; i < n_tab; i += nt) ctab[i] = 0;
    __syncthreads();
  }

  const int64_t r0 = (int64_t)blockIdx.x * chunk;
  const int64_t r1 = r0 + chunk < n ? r0 + chunk : n;
  const int64_t tile = (int64_t)kRows * nt;
  // one thread keeps the L2 prefetch kPrefetchTiles tiles ahead of the
  // block's loads (on 16-byte rows only: the copy engine's alignment)
  auto prefetch = [&](int64_t t) {
    if (!vec || tid != 0 || t >= r1) return;
    const uint32_t bytes =
        (uint32_t)((r1 - t < tile ? r1 - t : tile) * 4) & ~15u;
    if (bytes == 0) return;
    prefetch_l2(ids + t, bytes);
    prefetch_cols(t, bytes);
  };
  for (int d = 0; d < kPrefetchTiles; ++d) prefetch(r0 + d * tile);
  for (int64_t t0 = r0; t0 < r1; t0 += tile) {
    prefetch(t0 + kPrefetchTiles * tile);
    Span s;
    s.live = 0;
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      s.base[k] = t0 + 4 * ((int64_t)tid + (int64_t)k * nt);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (s.base[k] + j < r1) s.live |= 1u << (4 * k + j);
    }
    int32_t seg[kRows];
    load_rows(ids, s, s.live, vec, seg);
    uint32_t keep = 0;               // ids in [0, n_seg), in the run
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      keep |= (uint32_t)((uint32_t)seg[r] < (uint32_t)n_seg) << r;
    keep &= s.live;
    T v[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) v[r] = T(1);
    keep = rows(s, keep, v);

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const bool k = (keep >> r) & 1u;
      if constexpr (MODE == kLane) {
        if (k) {
          T* a = tab + seg[r] * nt + tid;
          *a = combine<T, OP>(*a, v[r]);
          if (CNT) ctab[seg[r] * nt + tid] += 1;
        }
      } else if constexpr (MODE == kBlock) {
        if (k) {
          block_fold<T, OP>(tab + copy, seg[r], v[r]);
          if (CNT) atomicAdd(ctab + copy + seg[r], 1);
        }
      } else {
        if (k) {
          atomic_fold<T, OP>(g_acc, seg[r], v[r]);
          if (CNT) atomicAdd(g_cnt + seg[r], 1);
        }
      }
    }
  }
  if constexpr (MODE == kGlobal) return;

  // the second pass may launch now; it waits for this grid to finish
  asm volatile("griddepcontrol.launch_dependents;");
  // the block's partial, each segment folded in a fixed order
  __syncthreads();
  T* out = part + (int64_t)blockIdx.x * n_seg;
  int* out_cnt = part_cnt + (int64_t)blockIdx.x * n_seg;
  if constexpr (MODE == kBlock) {
    for (int sg = tid; sg < n_seg; sg += nt) {
      T x = tab[sg];
      int c = CNT ? ctab[sg] : 0;
      for (int w = 1; w < copies; ++w) {      // order-free: ints or keys
        x = block_word<T, OP>(x, tab[w * n_seg + sg]);
        if (CNT) c += ctab[w * n_seg + sg];
      }
      out[sg] = block_value<T, OP>(x);
      if (CNT) out_cnt[sg] = c;
    }
  } else {
    // a warp a segment: lane l folds threads l, l + 32, ... in order, then
    // the fixed xor tree across the lanes
    for (int sg = warp; sg < n_seg; sg += nw) {
      T x = tab[sg * nt + lane];
      int c = CNT ? ctab[sg * nt + lane] : 0;
      for (int i = lane + 32; i < nt; i += 32) {
        x = combine<T, OP>(x, tab[sg * nt + i]);
        if (CNT) c += ctab[sg * nt + i];
      }
      x = warp_fold<T, OP>(x);
      if (CNT) c = warp_fold<int, kSum>(c);
      if (lane == 0) {
        out[sg] = x;
        if (CNT) out_cnt[sg] = c;
      }
    }
  }
}

template <typename T, int OP, int MODE>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
fused_kernel(const __grid_constant__ FusedParams p,
             const int32_t* __restrict__ ids, int64_t n, int64_t chunk,
             int n_seg, int copies, int vec, T* part, int* part_cnt,
             T* g_acc, int* g_cnt) {
  extern __shared__ __align__(16) int smem[];
  int32_t* stk = smem + table_words<MODE, true>(n_seg, blockDim.x, copies) +
                 threadIdx.x;
  aggregate<T, OP, MODE, true>(
      ids, n, chunk, n_seg, copies, vec != 0, part, part_cnt, g_acc, g_cnt,
      [&](const Span& s, uint32_t keep, T(&v)[kRows]) {
        int32_t A[kRows];
        if (p.n_pred) {
          run_rows(p, 0, p.n_pred, s, s.live, vec != 0, stk, A);
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            if (A[r] == 0) keep &= ~(1u << r);
        }
        if constexpr (OP != kCount) {
          if (p.n_val) {
            run_rows(p, p.n_pred, p.n_pred + p.n_val, s, keep, vec != 0, stk,
                     A);
#pragma unroll
            for (int r = 0; r < kRows; ++r) v[r] = from_bits<T>(A[r]);
          }
        }
        return keep;
      },
      [&](int64_t t, uint32_t bytes) {
        for (int i = 0; i < p.n_cols; ++i) prefetch_l2(p.cols[i] + t, bytes);
      });
}

template <typename T, int OP, int MODE>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
segment_kernel(const T* __restrict__ values, const int32_t* __restrict__ ids,
               int64_t n, int64_t chunk, int n_seg, int copies, int vec,
               T* part, T* g_acc) {
  aggregate<T, OP, MODE, false>(
      ids, n, chunk, n_seg, copies, vec != 0, part, nullptr, g_acc, nullptr,
      [&](const Span& s, uint32_t keep, T(&v)[kRows]) {
        if constexpr (OP != kCount) {        // count never reads its values
          int32_t b[kRows];
          load_rows(reinterpret_cast<const int32_t*>(values), s, keep,
                    vec != 0, b);
#pragma unroll
          for (int r = 0; r < kRows; ++r) v[r] = from_bits<T>(b[r]);
        }
        return keep;
      },
      [&](int64_t t, uint32_t bytes) {
        if constexpr (OP != kCount) prefetch_l2(values + t, bytes);
      });
}

// second pass: out[s] for the block's 32 segments, the G partials folded
// in block order, kCombineParts runs of ceil(G / kCombineParts) blocks (a
// warp a run at a time, a lane a segment), then the runs in order by warp
// 0.  Launched as a programmatic dependent of the first pass, so its
// launch overlaps that grid's end; griddepcontrol.wait holds it until the
// first pass has finished and its partials are visible.
template <typename T, int OP, bool CNT>
__global__ void __launch_bounds__(32 * kCombineParts)
combine_kernel(const T* __restrict__ part, const int* __restrict__ part_cnt,
               int G, int n_seg, T* __restrict__ out,
               int* __restrict__ out_cnt) {
  __shared__ T xs[kCombineParts * 32];
  __shared__ int cs[kCombineParts * 32];
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  const int sg = blockIdx.x * 32 + lane;
  const int per = (G + kCombineParts - 1) / kCombineParts;
  for (int q = threadIdx.x >> 5; q < kCombineParts; q += nw) {
    const int g1 = (q + 1) * per < G ? (q + 1) * per : G;
    T x = start<T, OP>();
    int c = 0;
    if (sg < n_seg) {
#pragma unroll 4
      for (int g = q * per; g < g1; ++g) {
        x = combine<T, OP>(x, __ldcg(part + (int64_t)g * n_seg + sg));
        if (CNT) c += __ldcg(part_cnt + (int64_t)g * n_seg + sg);
      }
    }
    xs[q * 32 + lane] = x;
    if (CNT) cs[q * 32 + lane] = c;
  }
  __syncthreads();
  if (threadIdx.x < 32 && sg < n_seg) {
    T x = xs[lane];
    int c = CNT ? cs[lane] : 0;
    for (int j = 1; j < kCombineParts; ++j) {
      x = combine<T, OP>(x, xs[j * 32 + lane]);
      if (CNT) c += cs[j * 32 + lane];
    }
    out[sg] = x;
    if (CNT) out_cnt[sg] = c;
  }
}

// the global-atomic path starts every segment from start() and count 0
template <typename T, int OP>
__global__ void fill_kernel(T* out, int* cnt, int n_seg) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_seg) {
    out[i] = start<T, OP>();
    if (cnt) cnt[i] = 0;
  }
}


// ---------------------------------------------------------------------------
// B3: window reduce, many threads folding each window straight from the
// sequence (no (n_windows, window) gather)
//
// What bounds it: bytes (each element read once by a tumbling window).
// A window of kBlockWindow elements or more takes a block of 256 threads,
// a shorter one a warp (8 windows a block): at 1,024 elements a block's
// one sweep of 16-byte loads (256 x 4 elements) already covers the
// window, so a longer window keeps every thread busy, and below it a
// block would leave threads idle while a warp's 32 lanes still cover the
// window in a few sweeps.  Query (d)'s 1,024 windows of 4,096 rows thus
// run as 1,024 blocks, not 4.  Lanes read consecutive int4/float4
// vectors (coalesced); values + w*slide lies on 16 bytes only when
// w*slide % 4 == 0, so each lane folds a scalar head up to the first
// aligned element, then the vectors, then a scalar tail.  The fold runs in
// registers, then a __shfl_xor_sync tree within the warp, then across the
// warps in shared memory.  f32 sums change their order (held to the
// caller's 1e-4 of the window's sum of |v|); int32 sums wrap, so their
// order does not matter; f32 min/max propagate NaN as amin/amax do.
// ---------------------------------------------------------------------------

constexpr int64_t kBlockWindow = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int64_t kMaxWindowGrid = int64_t(1) << 20;   // grid-stride above

template <typename T, int OP>
__device__ __forceinline__ T combine4(T acc, int4 q) {
  acc = combine<T, OP>(acc, from_bits<T>(q.x));
  acc = combine<T, OP>(acc, from_bits<T>(q.y));
  acc = combine<T, OP>(acc, from_bits<T>(q.z));
  return combine<T, OP>(acc, from_bits<T>(q.w));
}

// lane `lane` of `lanes` folds its share of v[0, len) (T is 4 bytes)
template <typename T, int OP>
__device__ __forceinline__ T fold_window(const T* __restrict__ v, int64_t len,
                                         int lane, int lanes) {
  T acc = identity<T, OP>();
  int64_t head = (4 - int64_t((reinterpret_cast<uintptr_t>(v) >> 2) & 3)) & 3;
  if (head > len) head = len;
  if (lane < head) acc = combine<T, OP>(acc, v[lane]);
  const int4* q = reinterpret_cast<const int4*>(v + head);
  const int64_t nq = (len - head) >> 2;
  int64_t i = lane;
  for (; i + 3 * lanes < nq; i += 4 * lanes) {   // 4 loads in flight a lane
    const int4 a = q[i], b = q[i + lanes], c = q[i + 2 * lanes],
               d = q[i + 3 * lanes];
    acc = combine4<T, OP>(acc, a);
    acc = combine4<T, OP>(acc, b);
    acc = combine4<T, OP>(acc, c);
    acc = combine4<T, OP>(acc, d);
  }
  for (; i < nq; i += lanes) acc = combine4<T, OP>(acc, q[i]);
  const int64_t tail = head + 4 * nq;
  if (lane < len - tail) acc = combine<T, OP>(acc, v[tail + lane]);
  return acc;
}

// one window a block (window >= kBlockWindow)
template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
window_block_kernel(const T* __restrict__ values, int64_t window,
                    int64_t slide, int64_t n_windows, T* __restrict__ out) {
  __shared__ T part[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int64_t w = blockIdx.x; w < n_windows; w += gridDim.x) {
    if constexpr (OP == kCount) {
      if (threadIdx.x == 0) out[w] = T(window);
      continue;
    }
    T acc = warp_fold<T, OP>(
        fold_window<T, OP>(values + w * slide, window, threadIdx.x, kThreads));
    if (lane == 0) part[warp] = acc;
    __syncthreads();
    if (warp == 0) {
      acc = lane < kWarps ? part[lane] : identity<T, OP>();
      acc = warp_fold<T, OP>(acc);
      if (lane == 0) out[w] = acc;
    }
    __syncthreads();   // part[] is read before the next window writes it
  }
}

// one window a warp (window < kBlockWindow), kWarps windows a block
template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
window_warp_kernel(const T* __restrict__ values, int64_t window,
                   int64_t slide, int64_t n_windows, T* __restrict__ out) {
  const int lane = threadIdx.x % 32;
  for (int64_t w = int64_t(blockIdx.x) * kWarps + threadIdx.x / 32;
       w < n_windows; w += int64_t(gridDim.x) * kWarps) {
    if constexpr (OP == kCount) {
      if (lane == 0) out[w] = T(window);
      continue;
    }
    const T acc = warp_fold<T, OP>(
        fold_window<T, OP>(values + w * slide, window, lane, 32));
    if (lane == 0) out[w] = acc;
  }
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

// B1/B2's grid on the shared-memory paths (its partials' row count): a
// block an SM, or one per kMinBlockRows rows of a shorter call; 0 above
// kSmemSegments, where nothing is staged
int aggregate_blocks(int64_t n, int n_seg) {
  if (n_seg > kSmemSegments) return 0;
  const int64_t want = (n + kMinBlockRows - 1) / kMinBlockRows;
  const int64_t sms = sm_count();
  return (int)(want < 1 ? 1 : want < sms ? want : sms);
}

struct Plan {
  int mode, threads, blocks, copies;
  size_t smem;
  int64_t chunk;
};

// Mode, warps and shared memory of one B1/B2 launch: as many warps (up to
// kMaxWarps) as the tables and the program's stack levels leave room for
// in kSmemBudget (thread tables of 32 segments: 28 warps for B1, 32 for
// B2; a block table of 4,096 segments: 32 KB, all 32 warps).  f32_sum:
// the fold must keep a fixed order (a thread table up to kLaneSegments).
Plan plan_for(int64_t n, int n_seg, bool cnt, int levels, bool f32_sum) {
  Plan pl;
  pl.copies = 1;
  const size_t stack = (size_t)levels * kRows * 32 * 4;   // a warp's levels
  const size_t words = cnt ? 2 : 1;                        // acc (+ cnt)
  size_t per_warp, fixed = 0;
  if (n_seg <= kLaneSegments && f32_sum) {
    pl.mode = kLane;
    per_warp = (size_t)32 * n_seg * 4 * words + stack;
  } else if (n_seg <= kLaneSegments) {
    pl.mode = kBlock;                  // a table a warp
    per_warp = (size_t)n_seg * 4 * words + stack;
  } else if (n_seg <= kSmemSegments) {
    pl.mode = kBlock;
    per_warp = stack;
    fixed = (size_t)n_seg * 4 * words;
  } else {
    pl.mode = kGlobal;
    per_warp = stack;
  }
  size_t warps = kMaxWarps;
  if (per_warp > 0 && (kSmemBudget - fixed) / per_warp < warps)
    warps = (kSmemBudget - fixed) / per_warp;
  pl.threads = (int)warps * 32;
  if (pl.mode == kBlock && n_seg <= kLaneSegments) pl.copies = (int)warps;
  pl.smem = fixed + warps * per_warp;
  if (pl.mode == kGlobal) {
    const int64_t want = (n + kMinBlockRows - 1) / kMinBlockRows;
    const int64_t most = 4 * (int64_t)sm_count();
    pl.blocks = (int)(want < 1 ? 1 : want < most ? want : most);
  } else {
    pl.blocks = aggregate_blocks(n, n_seg);
  }
  const int64_t per = (n + pl.blocks - 1) / pl.blocks;
  pl.chunk = (per + 3) / 4 * 4;        // runs start on 16 bytes
  if (pl.chunk < 4) pl.chunk = 4;
  return pl;
}

// stack levels a program spills to (1 + the largest PUSH level)
int stack_levels(const int* code, const int* arg, int n_code) {
  int levels = 0;
  for (int i = 0; i < n_code; ++i)
    if ((code[i] & 0xff) == C_PUSH && arg[i] + 1 > levels) levels = arg[i] + 1;
  return levels;
}

// raise the kernel's dynamic shared-memory limit to kSmemBudget once per
// device (the tables of a launch are sized under it); one flag per kernel
template <auto kernel>
cudaError_t allow_smem() {
  static std::atomic<uint32_t> done{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const uint32_t bit = 1u << (dev & 31);
  if (done.load() & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kSmemBudget);
  if (e == cudaSuccess) done.fetch_or(bit);
  return e;
}

bool on16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// the G partials of each segment, folded in block order
template <typename T, int OP, bool CNT>
cudaError_t launch_combine(const Plan& pl, const T* part, const int* part_cnt,
                           int n_seg, T* out, int* cnt, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n_seg + 31) / 32);
  cfg.blockDim = dim3(32 * kCombineParts);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, combine_kernel<T, OP, CNT>, part, part_cnt,
                            pl.blocks, n_seg, out, cnt);
}

template <typename T, int OP, int MODE>
cudaError_t launch_fused_mode(const Plan& pl, const FusedParams& p,
                              const int32_t* ids, int64_t n, T* acc, int* cnt,
                              int n_seg, int vec, int32_t* scratch,
                              cudaStream_t s) {
  auto k = fused_kernel<T, OP, MODE>;
  cudaError_t e = allow_smem<fused_kernel<T, OP, MODE>>();
  if (e != cudaSuccess) return e;
  T* part = reinterpret_cast<T*>(scratch);
  int* part_cnt = scratch + (int64_t)pl.blocks * n_seg;
  if (MODE == kGlobal) {
    fill_kernel<T, OP><<<(n_seg + 255) / 256, 256, 0, s>>>(acc, cnt, n_seg);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  k<<<pl.blocks, pl.threads, pl.smem, s>>>(p, ids, n, pl.chunk, n_seg,
                                           pl.copies, vec, part, part_cnt,
                                           acc, cnt);
  e = cudaGetLastError();
  if (e != cudaSuccess || MODE == kGlobal) return e;
  return launch_combine<T, OP, true>(pl, part, part_cnt, n_seg, acc, cnt, s);
}

template <typename T, int OP>
cudaError_t launch_fused(const FusedParams& p, int levels, const int32_t* ids,
                         int64_t n, T* acc, int* cnt, int n_seg, int vec,
                         int32_t* scratch, int64_t scratch_rows,
                         cudaStream_t s) {
  const Plan pl = plan_for(n, n_seg, true, levels, kIsF32<T> && OP == kSum);
  if (scratch_rows != aggregate_blocks(n, n_seg)) return cudaErrorInvalidValue;
  switch (pl.mode) {
    case kLane:
      return launch_fused_mode<T, OP, kLane>(pl, p, ids, n, acc, cnt, n_seg,
                                             vec, scratch, s);
    case kBlock:
      return launch_fused_mode<T, OP, kBlock>(pl, p, ids, n, acc, cnt,
                                              n_seg, vec, scratch, s);
    default:
      return launch_fused_mode<T, OP, kGlobal>(pl, p, ids, n, acc, cnt,
                                               n_seg, vec, scratch, s);
  }
}

template <typename T, int OP, int MODE>
cudaError_t launch_segment_mode(const Plan& pl, const T* v, const int32_t* ids,
                                int64_t n, T* out, int n_seg, int vec,
                                T* part, cudaStream_t s) {
  auto k = segment_kernel<T, OP, MODE>;
  cudaError_t e = allow_smem<segment_kernel<T, OP, MODE>>();
  if (e != cudaSuccess) return e;
  if (MODE == kGlobal) {
    fill_kernel<T, OP><<<(n_seg + 255) / 256, 256, 0, s>>>(out, nullptr,
                                                           n_seg);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  k<<<pl.blocks, pl.threads, pl.smem, s>>>(v, ids, n, pl.chunk, n_seg,
                                           pl.copies, vec, part, out);
  e = cudaGetLastError();
  if (e != cudaSuccess || MODE == kGlobal) return e;
  return launch_combine<T, OP, false>(pl, part, nullptr, n_seg, out, nullptr,
                                      s);
}

template <typename T, int OP>
cudaError_t launch_segment(const T* v, const int32_t* ids, int64_t n, T* out,
                           int n_seg, T* scratch, int64_t scratch_rows,
                           cudaStream_t s) {
  const Plan pl = plan_for(n, n_seg, false, 0, kIsF32<T> && OP == kSum);
  if (scratch_rows != aggregate_blocks(n, n_seg)) return cudaErrorInvalidValue;
  const int vec = on16(ids) && (OP == kCount || on16(v));
  switch (pl.mode) {
    case kLane:
      return launch_segment_mode<T, OP, kLane>(pl, v, ids, n, out, n_seg, vec,
                                               scratch, s);
    case kBlock:
      return launch_segment_mode<T, OP, kBlock>(pl, v, ids, n, out, n_seg,
                                                vec, scratch, s);
    default:
      return launch_segment_mode<T, OP, kGlobal>(pl, v, ids, n, out, n_seg,
                                                 vec, scratch, s);
  }
}


template <typename T, int OP>
cudaError_t launch_window(const T* v, int64_t window, int64_t slide,
                          int64_t n_windows, T* out, cudaStream_t s) {
  if (window >= kBlockWindow) {
    const int64_t blocks = n_windows < kMaxWindowGrid ? n_windows
                                                      : kMaxWindowGrid;
    window_block_kernel<T, OP><<<(unsigned)blocks, kThreads, 0, s>>>(
        v, window, slide, n_windows, out);
  } else {
    int64_t blocks = (n_windows + kWarps - 1) / kWarps;
    if (blocks > kMaxWindowGrid) blocks = kMaxWindowGrid;
    window_warp_kernel<T, OP><<<(unsigned)blocks, kThreads, 0, s>>>(
        v, window, slide, n_windows, out);
  }
  return cudaGetLastError();
}

template <typename T, int OP>
struct Kind {
  using type = T;
  static constexpr int op = OP;
};

// call f(Kind<T, OP>{}) for the runtime (dtype, op) pair
template <typename F>
int dispatch(int dtype, int op, F f) {
  if (dtype == kI32) {
    switch (op) {
      case kSum: return f(Kind<int32_t, kSum>{});
      case kCount: return f(Kind<int32_t, kCount>{});
      case kMin: return f(Kind<int32_t, kMin>{});
      case kMax: return f(Kind<int32_t, kMax>{});
    }
  } else if (dtype == kF32) {
    switch (op) {
      case kSum: return f(Kind<float, kSum>{});
      case kCount: return f(Kind<float, kCount>{});
      case kMin: return f(Kind<float, kMin>{});
      case kMax: return f(Kind<float, kMax>{});
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* sage_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// rows of the partials scratch B1 and B2 take for n rows and n_seg
// segments (B1: 2 x rows x n_seg int32 words, B2: rows x n_seg values)
int sage_aggregate_blocks(int64_t n, int n_seg) {
  if (n < 0 || n_seg <= 0) return 0;
  return aggregate_blocks(n, n_seg);
}

// cols: n_cols device pointers; code/arg: n_pred + n_val instructions;
// scratch: 2 x scratch_rows x n_seg int32 words, scratch_rows =
// sage_aggregate_blocks(n, n_seg), else cudaErrorInvalidValue
int sage_fused_aggregate(const void* const* cols, int n_cols,
                         const int* code, const int* arg, int n_pred,
                         int n_val, const int32_t* lits, int n_lits,
                         const int32_t* ids, int64_t n, void* acc, int* cnt,
                         int n_seg, int dtype, int op, void* scratch,
                         int64_t scratch_rows, void* stream) {
  if (n_cols < 0 || n_cols > kMaxCols || n_pred < 0 || n_val < 0 ||
      n_pred + n_val > kMaxCode || n_lits < 0 || n_lits > kMaxLits ||
      n_seg <= 0 || n < 0)
    return (int)cudaErrorInvalidValue;
  FusedParams p = {};
  int vec = on16(ids);
  for (int i = 0; i < n_cols; ++i) {
    p.cols[i] = static_cast<const int32_t*>(cols[i]);
    vec = vec && on16(cols[i]);
  }
  for (int i = 0; i < n_pred + n_val; ++i) {
    p.code[i] = code[i];
    p.arg[i] = arg[i];
  }
  for (int i = 0; i < n_lits; ++i) p.lits[i] = lits[i];
  p.n_pred = n_pred;
  p.n_val = n_val;
  p.n_cols = n_cols;
  const int levels = stack_levels(code, arg, n_pred + n_val);
  if (levels >= kMaxStack) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, op, [&](auto k) {
    using T = typename decltype(k)::type;
    return (int)launch_fused<T, decltype(k)::op>(
        p, levels, ids, n, static_cast<T*>(acc), cnt, n_seg, vec,
        static_cast<int32_t*>(scratch), scratch_rows, s);
  });
}

// scratch: scratch_rows x n_seg values, scratch_rows =
// sage_aggregate_blocks(n, n_seg), else cudaErrorInvalidValue
int sage_segment_reduce(const void* values, const int32_t* ids, int64_t n,
                        void* out, int n_seg, int dtype, int op,
                        void* scratch, int64_t scratch_rows, void* stream) {
  if (n_seg <= 0 || n < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, op, [&](auto k) {
    using T = typename decltype(k)::type;
    return (int)launch_segment<T, decltype(k)::op>(
        static_cast<const T*>(values), ids, n, static_cast<T*>(out), n_seg,
        static_cast<T*>(scratch), scratch_rows, s);
  });
}

int sage_window_reduce(const void* values, int64_t window, int64_t slide,
                       int64_t n_windows, void* out, int dtype, int op,
                       void* stream) {
  if (window <= 0 || slide <= 0 || n_windows <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, op, [&](auto k) {
    using T = typename decltype(k)::type;
    return (int)launch_window<T, decltype(k)::op>(
        static_cast<const T*>(values), window, slide, n_windows,
        static_cast<T*>(out), s);
  });
}

}  // extern "C"
