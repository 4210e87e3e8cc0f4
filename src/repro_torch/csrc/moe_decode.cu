// The MoE block's expert products on a single-token step, reading only the
// experts that hold a kept slot; bound through a plain C interface (ctypes,
// no PyTorch headers).  The launcher returns the cudaError_t of its
// launches; sage_error_string (analytics_kernels.cu, the same library)
// names it.
//
//   sage_moe_experts_decode  <- no TPU kernel
//
// It replaces no TPU kernel: the reference runs its MoE through jnp (a
// grouped einsum over every expert), not through Pallas.  It was added
// (ROADMAP D11) because a decode step routes its whole batch as one group
// at a small capacity C, each token keeps top_k of E experts, and a
// batched product over all E experts (models/moe.py _expert_ffn) reads
// every expert's weights for slots then multiplied by a zero weight: at
// qwen2-moe-a2.7b's widths (E 60, d 2,048, f 1,408, f32) 2.08 GB a layer,
// where the 4 experts a batch-1 token keeps hold 0.138 GB.
//
// What it computes, for the dispatched slots x (E, C, d), the experts'
// w_gate, w_up (E, d, f) and w_down (E, f, d), and valid (E, C) (a slot
// that holds a kept token):
//   y[e, c] = (act(x[e, c] w_gate[e]) * (x[e, c] w_up[e])) w_down[e]
// where valid[e, c], and 0 elsewhere, also in every slot of an expert with
// no valid slot (its weights are never read), so that the caller's
// y * weight never meets an unset value.  act is SiLU (0) or the tanh GELU
// (1).  x, the weights and y are all f32 or all bf16; the products are
// FFMAs of f32 values with f32 sums, and h = act(g) * u stays f32 between
// the two launches.  The number of experts read is written to kept[0]
// (int64), which the caller counts.
//
// What bounds it on the card: bytes.  A kept expert is 3 d f words
// (34.6 MB at qwen2-moe's widths in f32) for 6 d f FLOP a slot, one
// operation for every ~2 bytes: far below the ~20 FLOP a byte at which the
// f32 pipes would bound it.  At batch 1 a layer reads 4 experts, 0.138 GB,
// ~41 us at 3.35 TB/s; so latency and bytes in flight decide, and the
// design answers that:
//   * which experts to read is decided inside each block from valid (a
//     warp's ballot over E), never on the host: no sync and no shape that
//     depends on the data, so a CUDA graph captures and replays it.  The
//     grid's second axis is R = min(E, tokens x top_k) ranks, the most
//     experts the call can keep; block (t, r) works on the r-th kept
//     expert in ascending order and returns at once if there is none;
//   * two launches: moe_gate_up_kernel writes h (R, C, f) for each kept
//     expert, moe_down_kernel reads it back (C f floats, from L2) and
//     writes y.  A block owns 32 output columns of one expert for every
//     slot, and its 8 warps split the reduction rows: a lane reads 4 rows
//     at a time, each a 16-byte vector of every matrix it reads, so in
//     f32 8 lanes read a row's 128 contiguous bytes and a block keeps 32
//     rows x 128 B of each matrix in flight (bf16: 4 lanes, 64 rows x
//     64 B).  At batch 1 that is 176 blocks for gate/up (44 column tiles
//     x 4 experts) and 256 for down, ~6 MB in flight in f32, enough to
//     cover the card's latency.  Of the tilings timed on the H100 (8 or 4
//     lanes a row, 4 or 8 rows a lane, the row loop unrolled twice), 32
//     columns a block was the fastest in both dtypes (PERF.md);
//   * weights are read once, streaming (evict-first); x (or h) is read as
//     4-row vectors through L1, shared by the blocks of an expert;
//   * the zeros: block (t, r) of the down launch also zeroes tile t of
//     every expert e = r (mod R) that holds no valid slot, so each
//     (expert, tile) is written by exactly one block, with no memset;
//   * no atomics.  A lane sums its rows in ascending order, the row
//     groups of a warp meet in a fixed shuffle tree, and the eight warps
//     in warp order through shared memory: every run, and every replay of
//     a graph, gives the same bits.
// Slots are taken S at a time (S = 1, 2, 4 or 8 f32, up to 4 bf16, the
// least that covers C), re-reading the tile for each S; the caller keeps C
// small (models/moe.py DECODE_MAX_SLOTS).  Any E, C, d, f: 16-byte loads
// where the rows allow them (f32: N % 4 == 0, bf16: N % 8 == 0, for the N
// columns read, and the reduction length a multiple of 4), element loads
// with bounds checks otherwise.  Built with --fmad=false: every product
// and add that should fuse is written as fmaf.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerLane = 4;
constexpr int kTile = 32;                    // output columns a block
constexpr unsigned kFull = 0xffffffffu;

// How a block of weights of type T is read: V elements (16 bytes) a lane
// and load, kLanes lanes along a row of the tile (8 x 16 B f32, 4 x 16 B
// bf16), kRowGroups rows at once a warp, kRowStep rows a block.
template <typename T>
struct Tiling {
  static constexpr int V = 16 / int(sizeof(T));
  static constexpr int kLanes = kTile / V;
  static constexpr int kRowGroups = 32 / kLanes;
  static constexpr int kRowStep = kWarps * kRowGroups * kRowsPerLane;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f(float v, bf16* p) {
  *p = __float2bfloat16_rn(v);
}

// 16 bytes of weights (one row, V columns), read streaming
__device__ __forceinline__ void unpack(const uint4 u, float (&w)[4]) {
  w[0] = __uint_as_float(u.x);
  w[1] = __uint_as_float(u.y);
  w[2] = __uint_as_float(u.z);
  w[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4 u, float (&w)[8]) {
  const unsigned q[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[2 * i] = __uint_as_float(q[i] << 16);
    w[2 * i + 1] = __uint_as_float(q[i] & 0xffff0000u);
  }
}

template <typename T>
__device__ __forceinline__ void load_w(const T* p, bool vec, int left,
                                       float (&w)[Tiling<T>::V]) {
  constexpr int V = Tiling<T>::V;
  if (vec) {
    unpack(__ldcs(reinterpret_cast<const uint4*>(p)), w);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) w[v] = v < left ? to_f(p[v]) : 0.f;
  }
}

// rows i .. i + 3 of one slot of x (or h), as one vector where vec
__device__ __forceinline__ void load_x4(const float* p, bool vec,
                                        float* x) {
  if (vec) {
    const float4 u = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = u.x;
    x[1] = u.y;
    x[2] = u.z;
    x[3] = u.w;
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r) x[r] = __ldg(p + r);
  }
}
__device__ __forceinline__ void load_x4(const bf16* p, bool vec, float* x) {
  if (vec) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    x[0] = __uint_as_float(u.x << 16);
    x[1] = __uint_as_float(u.x & 0xffff0000u);
    x[2] = __uint_as_float(u.y << 16);
    x[3] = __uint_as_float(u.y & 0xffff0000u);
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r) x[r] = __bfloat162float(p[r]);
  }
}

// this lane's rows i .. i + kRowsPerLane - 1 of one slot; rows past k read 0
template <typename TX>
__device__ __forceinline__ void load_x(const TX* p, bool vec, int i, int k,
                                       float (&x)[kRowsPerLane]) {
#pragma unroll
  for (int q = 0; q < kRowsPerLane; q += 4) {
    if (i + q + 4 <= k) {
      load_x4(p + i + q, vec, x + q);
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        x[q + r] = i + q + r < k ? to_f(p[i + q + r]) : 0.f;
    }
  }
}

__device__ __forceinline__ bool expert_kept(const unsigned char* valid, int e,
                                            int c) {
  for (int s = 0; s < c; ++s)
    if (valid[size_t(e) * c + s]) return true;
  return false;
}

// The r-th expert (ascending) holding a valid slot, or -1; every warp
// computes it alone, so no barrier is needed.  *n gets the number kept.
__device__ int ranked_expert(const unsigned char* valid, int e_count, int c,
                             int r, int* n) {
  const int lane = threadIdx.x & 31;
  int seen = 0, found = -1;
  for (int base = 0; base < e_count; base += 32) {
    const int e = base + lane;
    const unsigned m =
        __ballot_sync(kFull, e < e_count && expert_kept(valid, e, c));
    const int cnt = __popc(m);
    if (found < 0 && r < seen + cnt)
      found = base + int(__fns(m, 0, r - seen + 1));
    seen += cnt;
  }
  *n = seen;
  return found;
}

// Partial sums of this lane over its rows of M matrices (k rows x n
// columns, row-major, each w[m] already at this lane's first column) for
// ns <= S slots of x (row stride ldx), into acc; lanes whose columns lie
// past n (left <= 0) add nothing.
template <typename TW, typename TX, int S, int M>
__device__ __forceinline__ void accumulate(
    const TW* const (&w)[M], const TX* x, size_t ldx, int ns, int k, int n,
    int left, bool vec, float (&acc)[M][S][Tiling<TW>::V]) {
  using L = Tiling<TW>;
  constexpr int V = L::V;
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[m][s][v] = 0.f;
  if (left <= 0) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int first = (warp * L::kRowGroups + lane / L::kLanes) * kRowsPerLane;
  for (int i = first; i < k; i += L::kRowStep) {
    float wr[M][kRowsPerLane][V];
    float xr[S][kRowsPerLane];
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int r = 0; r < kRowsPerLane; ++r) {
        if (i + r < k) {
          load_w(w[m] + size_t(i + r) * n, vec, left, wr[m][r]);
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) wr[m][r][v] = 0.f;
        }
      }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (s < ns) {
        load_x(x + s * ldx, vec, i, k, xr[s]);
      } else {
#pragma unroll
        for (int r = 0; r < kRowsPerLane; ++r) xr[s][r] = 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerLane; ++r)
#pragma unroll
      for (int m = 0; m < M; ++m)
#pragma unroll
        for (int s = 0; s < S; ++s)
#pragma unroll
          for (int v = 0; v < V; ++v)
            acc[m][s][v] = fmaf(xr[s][r], wr[m][r][v], acc[m][s][v]);
  }
}

// The block's sums: the row groups of a warp through a fixed shuffle tree,
// then the warps in order through shared memory.  After the call thread
// t < S * kTile holds column t % kTile of slot t / kTile of each matrix in
// out[m] (other threads get 0).
template <typename TW, int S, int M>
__device__ __forceinline__ void block_sum(
    float (&acc)[M][S][Tiling<TW>::V], float (*red)[kWarps][S * kTile],
    float (&out)[M]) {
  using L = Tiling<TW>;
  constexpr int V = L::V;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float a = acc[m][s][v];
#pragma unroll
        for (int off = L::kLanes; off < 32; off *= 2)
          a += __shfl_xor_sync(kFull, a, off);
        acc[m][s][v] = a;
      }
  if (lane < L::kLanes) {
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int s = 0; s < S; ++s)
#pragma unroll
        for (int v = 0; v < V; ++v)
          red[m][warp][s * kTile + lane * V + v] = acc[m][s][v];
  }
  __syncthreads();
  constexpr int kOut = S * kTile;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    float t = 0.f;
    if (int(threadIdx.x) < kOut) {
      t = red[m][0][threadIdx.x];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) t += red[m][w][threadIdx.x];
    }
    out[m] = t;
  }
  __syncthreads();             // red is reused by the next slots
}

__device__ __forceinline__ float activate(float g, int act) {
  if (act == 0) return g / (1.f + expf(-g));                    // SiLU
  const float inner = 0.7978845608028654f * (g + 0.044715f * (g * g * g));
  return 0.5f * g * (1.f + tanhf(inner));                       // tanh GELU
}

// h[r, c, :] = act(x[e, c] w_gate[e]) * (x[e, c] w_up[e]) for the r-th kept
// expert e; block (t, r) writes columns [32 t, 32 t + 32) of f.
template <typename T, int S>
__global__ void __launch_bounds__(kThreads)
    moe_gate_up_kernel(const T* __restrict__ x, const T* __restrict__ wg,
                       const T* __restrict__ wu,
                       const unsigned char* __restrict__ valid, int e_count,
                       int c, int d, int f, int act, bool vec,
                       float* __restrict__ h, long long* __restrict__ kept) {
  using L = Tiling<T>;
  constexpr int V = L::V;
  __shared__ float red[2][kWarps][S * kTile];
  int n_kept;
  const int r = blockIdx.y;
  const int e = ranked_expert(valid, e_count, c, r, &n_kept);
  if (blockIdx.x == 0 && r == 0 && threadIdx.x == 0) kept[0] = n_kept;
  if (e < 0) return;
  const int lane = threadIdx.x & 31;
  const int col = blockIdx.x * kTile + (lane % L::kLanes) * V;
  const size_t off = size_t(e) * d * f + col;
  const T* const w[2] = {wg + off, wu + off};
  for (int c0 = 0; c0 < c; c0 += S) {
    const int ns = min(S, c - c0);
    float acc[2][S][V], sum[2];
    accumulate<T, T, S, 2>(w, x + (size_t(e) * c + c0) * d, size_t(d), ns, d,
                           f, f - col, vec, acc);
    block_sum<T, S, 2>(acc, red, sum);
    const int s = threadIdx.x / kTile;
    const int j = blockIdx.x * kTile + threadIdx.x % kTile;
    if (int(threadIdx.x) < S * kTile && s < ns && j < f)
      h[(size_t(r) * c + c0 + s) * f + j] = activate(sum[0], act) * sum[1];
  }
}

// y[e, c, :] = h[r, c] w_down[e] where valid[e, c], 0 elsewhere, for the
// r-th kept expert e; block (t, r) writes columns [32 t, 32 t + 32) of d,
// and zeroes them in every expert e' = r (mod R) that has no valid slot.
template <typename T, int S>
__global__ void __launch_bounds__(kThreads)
    moe_down_kernel(const float* __restrict__ h, const T* __restrict__ wd,
                    const unsigned char* __restrict__ valid, int e_count,
                    int c, int d, int f, int ranks, bool vec,
                    T* __restrict__ y) {
  using L = Tiling<T>;
  constexpr int V = L::V;
  __shared__ float red[1][kWarps][S * kTile];
  const int r = blockIdx.y;
  const int tile0 = blockIdx.x * kTile;
  for (int e2 = r; e2 < e_count; e2 += ranks) {
    if (expert_kept(valid, e2, c)) continue;
    for (int i = threadIdx.x; i < c * kTile; i += kThreads) {
      const int j = tile0 + i % kTile;
      if (j < d) from_f(0.f, y + (size_t(e2) * c + i / kTile) * d + j);
    }
  }
  int n_kept;
  const int e = ranked_expert(valid, e_count, c, r, &n_kept);
  if (e < 0) return;
  const int lane = threadIdx.x & 31;
  const int col = tile0 + (lane % L::kLanes) * V;
  const T* const w[1] = {wd + size_t(e) * f * d + col};
  for (int c0 = 0; c0 < c; c0 += S) {
    const int ns = min(S, c - c0);
    float acc[1][S][V], sum[1];
    accumulate<T, float, S, 1>(w, h + (size_t(r) * c + c0) * f, size_t(f), ns,
                               f, d, d - col, vec, acc);
    block_sum<T, S, 1>(acc, red, sum);
    const int s = threadIdx.x / kTile, j = tile0 + threadIdx.x % kTile;
    if (int(threadIdx.x) < S * kTile && s < ns && j < d) {
      const bool keep = valid[size_t(e) * c + c0 + s] != 0;
      from_f(keep ? sum[0] : 0.f, y + (size_t(e) * c + c0 + s) * d + j);
    }
  }
}

template <typename T, int S>
int launch(const T* x, const T* wg, const T* wu, const T* wd,
           const unsigned char* valid, int e_count, int c, int d, int f,
           int ranks, int act, float* h, T* y, long long* kept,
           cudaStream_t st) {
  constexpr int V = Tiling<T>::V;
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const bool base = aligned(x) && aligned(wg) && aligned(wu) &&
                    aligned(wd) && aligned(h);
  // 16-byte weight rows and 4-row vectors of x (of h) need these
  const bool vec_up = base && f % V == 0 && d % 4 == 0;
  const bool vec_down = base && d % V == 0 && f % 4 == 0;
  moe_gate_up_kernel<T, S>
      <<<dim3(unsigned((f + kTile - 1) / kTile), unsigned(ranks)), kThreads,
         0, st>>>(x, wg, wu, valid, e_count, c, d, f, act, vec_up, h, kept);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  moe_down_kernel<T, S>
      <<<dim3(unsigned((d + kTile - 1) / kTile), unsigned(ranks)), kThreads,
         0, st>>>(h, wd, valid, e_count, c, d, f, ranks, vec_down, y);
  return int(cudaGetLastError());
}

template <typename T, int kMaxS>
int launch_slots(const void* x, const void* wg, const void* wu,
                 const void* wd, const unsigned char* valid, int e_count,
                 int c, int d, int f, int ranks, int act, float* h, void* y,
                 long long* kept, cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(wg);
  const T* up = static_cast<const T*>(wu);
  const T* dp = static_cast<const T*>(wd);
  T* yp = static_cast<T*>(y);
  if (c <= 1)
    return launch<T, 1>(xp, gp, up, dp, valid, e_count, c, d, f, ranks, act,
                        h, yp, kept, st);
  if (c <= 2)
    return launch<T, 2>(xp, gp, up, dp, valid, e_count, c, d, f, ranks, act,
                        h, yp, kept, st);
  if (c <= 4 || kMaxS == 4)
    return launch<T, 4>(xp, gp, up, dp, valid, e_count, c, d, f, ranks, act,
                        h, yp, kept, st);
  return launch<T, kMaxS>(xp, gp, up, dp, valid, e_count, c, d, f, ranks,
                          act, h, yp, kept, st);
}

}  // namespace

extern "C" {

int sage_moe_experts_decode(const void* x, const void* w_gate,
                            const void* w_up, const void* w_down,
                            const unsigned char* valid, int e_count, int c,
                            int d, int f, int ranks, int act, int is_bf16,
                            float* h, void* y, long long* kept,
                            void* stream) {
  if (e_count <= 0 || c <= 0 || d <= 0 || f <= 0 || ranks <= 0 ||
      ranks > e_count || ranks > 65535 || (act != 0 && act != 1))
    return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_slots<bf16, 4>(x, w_gate, w_up, w_down, valid, e_count, c,
                                 d, f, ranks, act, h, y, kept, st);
  return launch_slots<float, 8>(x, w_gate, w_up, w_down, valid, e_count, c,
                                d, f, ranks, act, h, y, kept, st);
}

}  // extern "C"
