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
// block with a 128x128 lane-iota membership mask; here each thread owns
// one row at a time and folds it with an atomic into a block-private
// shared-memory accumulator (flushed to global memory with atomics once
// per block), or, above kSmemSegments segments, straight into global
// memory.  Either way a row costs O(1) work instead of O(segments).
//
// The filter and value expressions arrive as a typed postfix program
// (compiled on the host by repro_torch.analytics.kernels) in a
// __grid_constant__ parameter block, so one build serves every query;
// every thread walks the same program, so the opcode switch does not
// diverge within a warp.  Integer arithmetic wraps (two's complement)
// and `%` takes the sign of the divisor, as numpy and JAX define them.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxCols = 16;
constexpr int kMaxCode = 128;
constexpr int kMaxLits = 64;
constexpr int kMaxStack = 16;
constexpr int kThreads = 256;
// B1 keeps acc (4 B) + count (4 B) per segment: 8192 segments = 64 KB of
// dynamic shared memory, above the 48 KB default (cudaFuncSetAttribute);
// B2 keeps acc only (32 KB)
constexpr int kSmemSegments = 8192;

enum Op : int { kSum = 0, kCount = 1, kMin = 2, kMax = 3 };
enum DType : int { kI32 = 0, kF32 = 1 };

// program opcodes; keep in sync with _OPCODES in analytics/kernels.py
enum Code : int {
  C_COL = 0, C_LIT = 1, C_I2F = 2, C_F2I = 3, C_F2B = 4,
  C_ADD_I = 10, C_SUB_I = 11, C_MUL_I = 12, C_MOD_I = 13,
  C_AND = 14, C_OR = 15, C_NOT_I = 16, C_NOT_B = 17,
  C_ADD_F = 20, C_SUB_F = 21, C_MUL_F = 22, C_DIV_F = 23, C_MOD_F = 24,
  C_GT_I = 30, C_GE_I = 31, C_LT_I = 32, C_LE_I = 33, C_EQ_I = 34,
  C_NE_I = 35,
  C_GT_F = 40, C_GE_F = 41, C_LT_F = 42, C_LE_F = 43, C_EQ_F = 44,
  C_NE_F = 45,
};

struct FusedParams {
  const int32_t* cols[kMaxCols];   // int32 or float32 bits, one per slot
  int code[kMaxCode];
  int arg[kMaxCode];
  int32_t lits[kMaxLits];          // int32 or float32 bits
  int n_pred;                      // pred program: code[0, n_pred)
  int n_val;                       // value program: code[n_pred, +n_val)
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

// run code[lo, hi) on one row; the result is st[0] (int32 or f32 bits)
__device__ int32_t run_program(const FusedParams& p, int lo, int hi,
                               int64_t row) {
  int32_t st[kMaxStack];
  int sp = 0;
  for (int pc = lo; pc < hi; ++pc) {
    const int c = p.code[pc];
    const int a = p.arg[pc];
    if (c == C_COL) { st[sp++] = p.cols[a][row]; continue; }
    if (c == C_LIT) { st[sp++] = p.lits[a]; continue; }
    int32_t& x = st[sp - 1];
    switch (c) {
      case C_I2F: x = f_bits((float)x); continue;
      case C_F2I: x = (int32_t)bits_f(x); continue;   // truncates
      case C_F2B: x = bits_f(x) != 0.0f; continue;    // NaN -> true
      case C_NOT_I: x = ~x; continue;
      case C_NOT_B: x = x ^ 1; continue;
      default: break;
    }
    const int32_t y = st[--sp];
    int32_t& l = st[sp - 1];
    const float lf = bits_f(l), yf = bits_f(y);
    switch (c) {
      case C_ADD_I: l = wrap_add(l, y); break;
      case C_SUB_I: l = wrap_sub(l, y); break;
      case C_MUL_I: l = wrap_mul(l, y); break;
      case C_MOD_I: l = floor_mod_i(l, y); break;
      case C_AND: l = l & y; break;                    // no short-circuit
      case C_OR: l = l | y; break;
      case C_ADD_F: l = f_bits(__fadd_rn(lf, yf)); break;
      case C_SUB_F: l = f_bits(__fsub_rn(lf, yf)); break;
      case C_MUL_F: l = f_bits(__fmul_rn(lf, yf)); break;
      case C_DIV_F: l = f_bits(__fdiv_rn(lf, yf)); break;
      case C_MOD_F: l = f_bits(floor_mod_f(lf, yf)); break;
      case C_GT_I: l = l > y; break;
      case C_GE_I: l = l >= y; break;
      case C_LT_I: l = l < y; break;
      case C_LE_I: l = l <= y; break;
      case C_EQ_I: l = l == y; break;
      case C_NE_I: l = l != y; break;
      case C_GT_F: l = lf > yf; break;
      case C_GE_F: l = lf >= yf; break;
      case C_LT_F: l = lf < yf; break;
      case C_LE_F: l = lf <= yf; break;
      case C_EQ_F: l = lf == yf; break;
      case C_NE_F: l = lf != yf; break;
      default: break;
    }
  }
  return st[0];
}

// ---------------------------------------------------------------------------
// accumulators: one fold per row, atomic on shared or global memory
// ---------------------------------------------------------------------------

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
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

template <typename T, int OP>
__device__ __forceinline__ void fold(T* acc, int seg, T v) {
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

// Block-private accumulators for the first n_seg segments: shared
// memory holds acc[n_seg] and, for B1, cnt[n_seg] (the survivor counts
// it returns).  A thread folds its row into shared memory; the block then
// folds each segment into global memory once, skipping segments that no
// row reached (B1: cnt == 0; B2: acc still the identity, whose fold would
// change nothing).
template <typename T, int OP, bool WITH_CNT>
struct SmemAcc {
  T* acc;
  int* cnt;
  int n;
  __device__ void init(int n_seg) {
    extern __shared__ int smem[];
    acc = reinterpret_cast<T*>(smem);
    cnt = smem + n_seg;
    n = n_seg;
    for (int s = threadIdx.x; s < n_seg; s += blockDim.x) {
      acc[s] = identity<T, OP>();
      if (WITH_CNT) cnt[s] = 0;
    }
    __syncthreads();
  }
  __device__ __forceinline__ void add(int seg, T v) {
    fold<T, OP>(acc, seg, v);
    if (WITH_CNT) atomicAdd(cnt + seg, 1);
  }
  __device__ void flush(T* g_acc, int* g_cnt) {
    __syncthreads();
    for (int s = threadIdx.x; s < n; s += blockDim.x) {
      const T a = acc[s];
      if constexpr (WITH_CNT) {
        const int c = cnt[s];
        if (c == 0) continue;
        atomicAdd(g_cnt + s, c);
      } else {
        if (a == identity<T, OP>()) continue;   // NaN never equals: folded
      }
      if constexpr (OP == kCount) atomicAdd(g_acc + s, a);
      else fold<T, OP>(g_acc, s, a);
    }
  }
};

// ---------------------------------------------------------------------------
// B1: fused filter -> grouped reduce
// ---------------------------------------------------------------------------

template <typename T, int OP, bool SMEM>
__global__ void __launch_bounds__(kThreads)
fused_kernel(const __grid_constant__ FusedParams p, const int32_t* ids,
             int64_t n, T* g_acc, int* g_cnt, int n_seg) {
  SmemAcc<T, OP, true> sm;
  if (SMEM) sm.init(n_seg);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    const int seg = ids[r];
    if (seg < 0 || seg >= n_seg) continue;       // padding / dropped row
    if (p.n_pred && run_program(p, 0, p.n_pred, r) == 0) continue;
    T v = T(1);
    if (OP != kCount && p.n_val) {
      const int32_t b = run_program(p, p.n_pred, p.n_pred + p.n_val, r);
      if constexpr (kIsF32<T>) v = __int_as_float(b);
      else v = b;
    }
    if (SMEM) {
      sm.add(seg, v);
    } else {
      fold<T, OP>(g_acc, seg, v);
      atomicAdd(g_cnt + seg, 1);
    }
  }
  if (SMEM) sm.flush(g_acc, g_cnt);
}

// ---------------------------------------------------------------------------
// B2: grouped reduce by segment id
// ---------------------------------------------------------------------------

template <typename T, int OP, bool SMEM>
__global__ void __launch_bounds__(kThreads)
segment_kernel(const T* values, const int32_t* ids, int64_t n, T* g_acc,
               int n_seg) {
  SmemAcc<T, OP, false> sm;
  if (SMEM) sm.init(n_seg);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    const int seg = ids[r];
    if (seg < 0 || seg >= n_seg) continue;
    if (SMEM) sm.add(seg, values[r]);
    else fold<T, OP>(g_acc, seg, values[r]);
  }
  if (SMEM) sm.flush(g_acc, nullptr);
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
__device__ __forceinline__ T combine(T a, T b) {
  if constexpr (kIsF32<T>) {
    return OP == kSum ? __fadd_rn(a, b)
         : OP == kMin ? nan_min(a, b) : nan_max(a, b);
  } else {
    return OP == kSum ? wrap_add(a, b)
         : OP == kMin ? (b < a ? b : a) : (b > a ? b : a);
  }
}

template <typename T>
__device__ __forceinline__ T from_bits(int32_t x) {
  if constexpr (kIsF32<T>) return bits_f(x);
  else return x;
}

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

template <typename T, int OP>
__device__ __forceinline__ T warp_fold(T acc) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    acc = combine<T, OP>(acc, __shfl_xor_sync(0xffffffffu, acc, o));
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

// one resident wave of blocks (grid-stride loops cover the rest)
template <typename K>
int grid_for(K kernel, int64_t n, size_t smem) {
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                smem);
  if (per_sm < 1) per_sm = 1;
  const int64_t want = (n + kThreads - 1) / kThreads;
  const int64_t wave = (int64_t)per_sm * sm_count();
  return (int)(want < wave ? (want > 0 ? want : 1) : wave);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T, int OP>
cudaError_t launch_fused(const FusedParams& p, const int32_t* ids, int64_t n,
                         T* acc, int* cnt, int n_seg, cudaStream_t s) {
  if (n_seg <= kSmemSegments) {
    const size_t smem = (size_t)n_seg * 8;
    auto k = fused_kernel<T, OP, true>;
    cudaError_t e = allow_smem(k, smem);
    if (e != cudaSuccess) return e;
    k<<<grid_for(k, n, smem), kThreads, smem, s>>>(p, ids, n, acc, cnt, n_seg);
  } else {
    auto k = fused_kernel<T, OP, false>;
    k<<<grid_for(k, n, 0), kThreads, 0, s>>>(p, ids, n, acc, cnt, n_seg);
  }
  return cudaGetLastError();
}

template <typename T, int OP>
cudaError_t launch_segment(const T* v, const int32_t* ids, int64_t n, T* acc,
                           int n_seg, cudaStream_t s) {
  if (n_seg <= kSmemSegments) {
    const size_t smem = (size_t)n_seg * 4;
    auto k = segment_kernel<T, OP, true>;
    cudaError_t e = allow_smem(k, smem);
    if (e != cudaSuccess) return e;
    k<<<grid_for(k, n, smem), kThreads, smem, s>>>(v, ids, n, acc, n_seg);
  } else {
    auto k = segment_kernel<T, OP, false>;
    k<<<grid_for(k, n, 0), kThreads, 0, s>>>(v, ids, n, acc, n_seg);
  }
  return cudaGetLastError();
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

// cols: n_cols device pointers; code/arg: n_pred + n_val instructions
int sage_fused_aggregate(const void* const* cols, int n_cols,
                         const int* code, const int* arg, int n_pred,
                         int n_val, const int32_t* lits, int n_lits,
                         const int32_t* ids, int64_t n, void* acc, int* cnt,
                         int n_seg, int dtype, int op, void* stream) {
  if (n_cols < 0 || n_cols > kMaxCols || n_pred < 0 || n_val < 0 ||
      n_pred + n_val > kMaxCode || n_lits < 0 || n_lits > kMaxLits ||
      n_seg <= 0)
    return (int)cudaErrorInvalidValue;
  FusedParams p = {};
  for (int i = 0; i < n_cols; ++i)
    p.cols[i] = static_cast<const int32_t*>(cols[i]);
  for (int i = 0; i < n_pred + n_val; ++i) {
    p.code[i] = code[i];
    p.arg[i] = arg[i];
  }
  for (int i = 0; i < n_lits; ++i) p.lits[i] = lits[i];
  p.n_pred = n_pred;
  p.n_val = n_val;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, op, [&](auto k) {
    using T = typename decltype(k)::type;
    return (int)launch_fused<T, decltype(k)::op>(
        p, ids, n, static_cast<T*>(acc), cnt, n_seg, s);
  });
}

int sage_segment_reduce(const void* values, const int32_t* ids, int64_t n,
                        void* out, int n_seg, int dtype, int op,
                        void* stream) {
  if (n_seg <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, op, [&](auto k) {
    using T = typename decltype(k)::type;
    return (int)launch_segment<T, decltype(k)::op>(
        static_cast<const T*>(values), ids, n, static_cast<T*>(out), n_seg,
        s);
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
