// B6 on bf16 x, B and C, written for Hopper's bf16 tensor cores (sm_90a)
// and bound through a plain C interface (ctypes, no PyTorch headers).
// The launcher returns the cudaError_t of its launches; sage_error_string
// (analytics_kernels.cu, the same library) names it.
//
//   sage_ssd_scan_bf16  <- _ssd_kernel  (repro/kernels/ssd_scan.py)
//
// It computes what sage_ssd_scan (ssm_kernels.cu) computes, with the same
// state-in / state-out contract: for each (batch, head), A = -exp(a_log),
//   S_t = exp(dt_t A) S_{t-1} + dt_t x_t B_t^T ,  y_t = S_t C_t
// from S_{-1} = s0 (or 0), in chunked form as the TPU kernel does
// (ssd_scan.py:40-76, which widens its bf16 blocks in VMEM).  x: (b, s,
// h, p) bf16; dt: (b, s, h) f32; a_log: (h,) f32; B, C: (b, s, g, n) bf16,
// head h reading group h / (H / G); s0 (or null), s_out: (b, h, p, n)
// f32; y: (b, s, h, p) bf16, rounded once.  All contiguous; B and C start
// on 16 bytes, x too when p % 8 == 0.  Scratch from the caller (f32):
// states (b, h, nc, p, n) and decay (b, h, nc), nc = ceil(s / 256); the
// caller passes the 256 and 64 it sized them by, and any other pair is
// refused with cudaErrorInvalidValue.
//
// What bounds it on the card: bytes.  At mamba2-130m's serving shape
// (b 4, s 16000, h 24, p 64, n 128, g 1) it moves 0.44 GB (0.131 ms at
// 3.35 TB/s) and needs 5.1e10 FLOP at its least (0.051 ms at 989 TFLOP/s).
// The f32 kernel's four launches took 0.034 (C B^T), 0.565 (the chunks'
// states), 0.138 (the carry) and 1.67 ms (y) of its 2.41 (PERF.md): the
// output pass is the bulk, and C B^T is 1.4 % of it.
// So here three launches, chunks in parallel as in the f32 kernel:
//   1. ssd_state_bf16_kernel, a block (one warpgroup) per (batch, head,
//      256-row chunk, 64 columns of p): the chunk's own end state
//      sum_l exp(cs_last - cs_l) dt_l x_l B_l^T into `states`, its decay
//      exp(cs_last) into `decay`;
//   2. ssd_carry_bf16_kernel (the f32 kernel's carry): walks the chunks
//      in turn from s0, leaves in `states` the state entering each chunk,
//      and writes s_out;
//   3. ssd_out_bf16_kernel, a block per (batch, head, chunk, p slice):
//      from the chunk's entering state, its four 64-row sub-chunks in
//      turn: scores = C B^T (here, not in a launch of their own: one
//      wgmma of exact bf16 products costs less than a round trip through
//      device memory), G = scores exp(cs_i - cs_j) dt_j [j <= i],
//      y = exp(cs) (C S^T) + G x, and S = S exp(cs_last) + (x w)^T B.
//
// Tensor cores: every product is a wgmma of bf16 operands with f32 sums.
// x, B and C are bf16 in memory, so they enter exactly.  The f32 operands
// (G, the state S, x w) are split, a = hi + lo with hi = bf16(a) and lo =
// bf16(a - hi), and take two wgmmas (hi, then lo) against the exact
// operand: about 2^-17 of each product is lost, against the limit of 1e-4
// of the (batch, head)'s max |value| (tests/test_torch_bf16_split.py).
//   C B^T          A = C, B = B (both K-major in shared memory)
//   C S^T          A = C, B = S hi and S lo (bf16 copies of S beside it)
//   G x            A = G hi / lo in registers (the scores' accumulator is,
//                  packed in pairs, G's A fragment), B = x read MN-major
//   (x w)^T B      A = (x w)^T hi / lo in registers, B = B read MN-major
// wgmma reads 16-bit operands in either major order, so x and B serve
// down their columns as they lie: no transposed copies.
//
// Shared memory.  The tiles are staged by cp.async (16-byte copies; 2-byte
// loads for x where p % 8 != 0, whose rows TMA could not address either)
// into the no-swizzle layout of hopper_bf16.cuh: a 64 x W tile is W / 8
// blocks of 64 rows x 16 B.  Pass 3 at n 128: B, C (16 KB each), x
// (8 KB), S hi and lo (16 KB each), S in f32 (34 KB), dt, exp(cs), the
// weights and the f64 cumsum: 107 KB, two blocks a multiprocessor.  S
// waits in f32 in shared memory between sub-chunks and enters the
// registers only for its update, so the y products and the update never
// hold their accumulators together (n / 2 registers a thread for S).
// The cumsums of dt A are f64 (an f32 one reaches -2,800 in a chunk at
// A = -16, and its ulp would land in every decay), each decay rounded
// once; exp is expf, but G's 64 x 64 decays a sub-chunk take one ex2 each
// (exp(d) = 2^(d log2 e), ~2^-21 relative at the small |d| that matter).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_bf16.cuh"

namespace {

using namespace sage_hopper;
using bf16 = __nv_bfloat16;

constexpr int kL = 64;          // rows per sub-chunk: a wgmma's M
constexpr int kLc = 256;        // rows per chunk: the states' step
constexpr int kP = 64;          // columns of p a block: a wgmma's M and N
constexpr int kThreads = 128;   // one warpgroup
constexpr int kCarryThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

// byte offset of (r, c) in a 64-row tile of the no-swizzle layout
__device__ __forceinline__ int tile_off(int r, int c) {
  return (c >> 3) * 1024 + r * 16 + (c & 7) * 2;
}

// a K-major (rows are M or N, columns K) and an MN-major (rows are K)
// descriptor of a 64-row tile at k-step kk
__device__ __forceinline__ uint64_t kmajor(const uint8_t* tile, int kk) {
  return desc(smem_u32(tile) + kk * 2048, 1024, 128, 0);
}
__device__ __forceinline__ uint64_t mnmajor(const uint8_t* tile, int kk) {
  return desc(smem_u32(tile) + kk * 256, 128, 1024, 0);
}

// rows [0, rows) x columns [0, cols) of a 64 x W tile from rows `ld`
// elements apart, the rest zero: 16-byte copies (a quarter warp takes one
// chunk of 8 rows, so a warp reads 64 contiguous bytes of each of 8 rows
// and writes 512 contiguous bytes) where `vec` (cols % 8 == 0, rows on 16
// bytes), else 2-byte loads.  The caller waits (cp_commit_wait_all),
// fences and syncs.
template <int W>
__device__ __forceinline__ void stage_tile(uint8_t* dst, const bf16* src,
                                           int64_t ld, int rows, int cols,
                                           bool vec) {
  constexpr int C8 = W / 8;
  if (vec) {
    for (int i = threadIdx.x; i < kL * C8; i += kThreads) {
      const int c8 = (i / 8) % C8, r = 8 * (i / (8 * C8)) + i % 8;
      const bool ok = r < rows && 8 * c8 < cols;
      cp16_zfill(dst + c8 * 1024 + r * 16, ok ? src + r * ld + 8 * c8 : src,
                 ok);
    }
  } else {
    for (int i = threadIdx.x; i < kL * W; i += kThreads) {
      const int c = i % W, r = i / W;
      const bool ok = r < rows && c < cols;
      *reinterpret_cast<bf16*>(dst + tile_off(r, c)) =
          ok ? src[r * ld + c] : __float2bfloat16(0.f);
    }
  }
}

// A = (x w)^T at k-step kk (rows: 16 columns of p a warp; k: rows
// 16 kk.. of the tile) split into hi and lo fragments
__device__ __forceinline__ void xw_frags(const uint8_t* xs, const float* w,
                                         int kk, int warp, int gq, int tq,
                                         uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int m = 16 * warp + gq + 8 * (e & 1);
    const int r = 16 * kk + 2 * tq + 8 * (e >> 1);
    const float x0 = __bfloat162float(
        *reinterpret_cast<const bf16*>(xs + tile_off(r, m)));
    const float x1 = __bfloat162float(
        *reinterpret_cast<const bf16*>(xs + tile_off(r + 1, m)));
    split2(__fmul_rn(x0, w[r]), __fmul_rn(x1, w[r + 1]), hi[e], lo[e]);
  }
}

// inclusive f64 cumsum of dt A over kL rows (warp 0 only, two rows a lane)
__device__ __forceinline__ void cumsum64(const float* dts, float A,
                                         double* css, int lane) {
  const double v0 = double(__fmul_rn(dts[2 * lane], A));
  const double v1 = v0 + double(__fmul_rn(dts[2 * lane + 1], A));
  double incl = v1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  double excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.0;
  css[2 * lane] = excl + v0;
  css[2 * lane + 1] = excl + v1;
}

// ---------------------------------------------------------------------------
// pass 1: each chunk's own end state and decay
// ---------------------------------------------------------------------------

template <int N>
struct StatePlan {
  static constexpr int kB = 0;                  // B tile (64 x N)
  static constexpr int kX = kB + N * 128;       // x tile (64 x 64)
  static constexpr int kW = kX + kP * 128;      // the chunk's 256 weights
  static constexpr int kSum = kW + 4 * kLc;     // f64 sums of the warps
  static constexpr size_t kBytes = kSum + 8 * (kThreads / 32);
};

template <int N>
__global__ void __launch_bounds__(kThreads)
ssd_state_bf16_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ a_log,
                      const bf16* __restrict__ bm, int64_t s, int h, int p,
                      int g, int nc, bool xvec, float* __restrict__ states,
                      float* __restrict__ decay) {
  using Ly = StatePlan<N>;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* bs = smem + Ly::kB;
  uint8_t* xs = smem + Ly::kX;
  float* wls = reinterpret_cast<float*>(smem + Ly::kW);
  double* wsum = reinterpret_cast<double*>(smem + Ly::kSum);

  const int nps = (p + kP - 1) / kP;
  const int c = blockIdx.x / nps, p0 = (blockIdx.x % nps) * kP;
  const int np_ = min(kP, p - p0);
  const int head = blockIdx.y;
  const int64_t bi = blockIdx.z;
  const int grp = head / (h / g);
  const float A = -expf(a_log[head]);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int64_t r0 = int64_t(c) * kLc;
  const int rows_c = int(s - r0 < kLc ? s - r0 : kLc);
  const int64_t xrow = int64_t(h) * p, bcrow = int64_t(g) * N;
  const bf16* xb = x + (bi * s + r0) * xrow + int64_t(head) * p + p0;
  const bf16* bb = bm + (bi * s + r0) * bcrow + int64_t(grp) * N;

  // the chunk's f64 cumsum of dt A (two rows a thread), then its weights
  const int ra = 2 * tid;
  const float dta = ra < rows_c ? dt[(bi * s + r0 + ra) * h + head] : 0.f;
  const float dtb =
      ra + 1 < rows_c ? dt[(bi * s + r0 + ra + 1) * h + head] : 0.f;
  const double va = double(__fmul_rn(dta, A));
  const double vb = va + double(__fmul_rn(dtb, A));
  double incl = vb;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  double before = 0.0, total = 0.0;
  for (int w = 0; w < kThreads / 32; ++w) {
    if (w < warp) before += wsum[w];
    total += wsum[w];
  }
  const double excl = before + (incl - vb);
  wls[ra] = __fmul_rn(expf(float(total - (excl + va))), dta);
  wls[ra + 1] = __fmul_rn(expf(float(total - (excl + vb))), dtb);
  if (tid == 0 && p0 == 0)
    decay[(bi * h + head) * nc + c] = expf(float(total));

  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  const int nsub = (rows_c + kL - 1) / kL;
  for (int k = 0; k < nsub; ++k) {
    const int rows = min(kL, rows_c - k * kL);
    stage_tile<N>(bs, bb + k * kL * bcrow, bcrow, rows, N, true);
    stage_tile<kP>(xs, xb + k * kL * xrow, xrow, rows, np_, xvec);
    cp_commit_wait_all();
    fence_async_smem();
    __syncthreads();   // the tiles (and, at k 0, the weights) are in
    uint32_t ah[kL / 16][4], al[kL / 16][4];
#pragma unroll
    for (int kk = 0; kk < kL / 16; ++kk)
      xw_frags(xs, wls + k * kL, kk, warp, gq, tq, ah[kk], al[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kL / 16; ++kk) {
      Wgmma<N>::template rs<1>(acc, ah[kk], mnmajor(bs, kk), 1);
      Wgmma<N>::template rs<1>(acc, al[kk], mnmajor(bs, kk), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    pin(acc);
    pin(ah);
    pin(al);
    __syncthreads();   // the tiles are read before they are refilled
  }

  float* out = states + (((bi * h + head) * nc + c) * p + p0) * N;
#pragma unroll
  for (int i = 0; i < N / 2; i += 2) {
    const int m = 16 * warp + gq + 8 * ((i % 4) >> 1);
    const int col = 8 * (i / 4) + 2 * tq;
    if (m < np_)
      *reinterpret_cast<float2*>(out + int64_t(m) * N + col) =
          make_float2(acc[i], acc[i + 1]);
  }
}

// ---------------------------------------------------------------------------
// pass 2: the states entering each chunk, and the final state (f32, as
// ssm_kernels.cu's ssd_carry_kernel)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kCarryThreads)
ssd_carry_bf16_kernel(const float* __restrict__ s0, float* __restrict__ states,
                      const float* __restrict__ decay, int h, int nc,
                      int64_t pn4, float* __restrict__ s_out) {
  const int64_t q = int64_t(blockIdx.x) * kCarryThreads + threadIdx.x;
  if (q >= pn4) return;
  const int64_t bh = int64_t(blockIdx.z) * h + blockIdx.y;
  float4 carry = s0 != nullptr
                     ? reinterpret_cast<const float4*>(s0)[bh * pn4 + q]
                     : make_float4(0.f, 0.f, 0.f, 0.f);
  float4* st = reinterpret_cast<float4*>(states) + bh * nc * pn4 + q;
  const float* dec = decay + bh * nc;
  float4 next = st[0];
  for (int c = 0; c < nc; ++c) {
    const float4 loc = next;
    if (c + 1 < nc) next = st[(c + 1) * pn4];
    const float d = dec[c];
    st[c * pn4] = carry;
    carry.x = __fadd_rn(__fmul_rn(carry.x, d), loc.x);
    carry.y = __fadd_rn(__fmul_rn(carry.y, d), loc.y);
    carry.z = __fadd_rn(__fmul_rn(carry.z, d), loc.z);
    carry.w = __fadd_rn(__fmul_rn(carry.w, d), loc.w);
  }
  reinterpret_cast<float4*>(s_out)[bh * pn4 + q] = carry;
}

// ---------------------------------------------------------------------------
// pass 3: y from each chunk's entering state
// ---------------------------------------------------------------------------

template <int N>
struct OutPlan {
  static constexpr int kSs = N + 8;             // row stride of S in f32
  static constexpr int kB = 0;                  // B tile (64 x N)
  static constexpr int kC = kB + N * 128;       // C tile (64 x N)
  static constexpr int kX = kC + N * 128;       // x tile (64 x 64)
  static constexpr int kSh = kX + kP * 128;     // S hi (p rows x N)
  static constexpr int kSl = kSh + N * 128;     // S lo
  static constexpr int kSf = kSl + N * 128;     // S, f32
  static constexpr int kDt = kSf + 4 * kP * kSs;
  static constexpr int kE = kDt + 4 * kL;       // exp(cs_i)
  static constexpr int kW = kE + 4 * kL;        // exp(cs_last - cs_l) dt_l
  static constexpr int kCs = kW + 4 * kL;       // the f64 cumsum
  static constexpr size_t kBytes = kCs + 8 * kL;
};

template <int N>
__global__ void __launch_bounds__(kThreads)
ssd_out_bf16_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ a_log,
                    const bf16* __restrict__ bm, const bf16* __restrict__ cm,
                    const float* __restrict__ states, int64_t s, int h, int p,
                    int g, int nc, bool xvec, bf16* __restrict__ y) {
  using Ly = OutPlan<N>;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* bs = smem + Ly::kB;
  uint8_t* cs_tile = smem + Ly::kC;
  uint8_t* xs = smem + Ly::kX;
  uint8_t* sh = smem + Ly::kSh;
  uint8_t* sl = smem + Ly::kSl;
  float* sf = reinterpret_cast<float*>(smem + Ly::kSf);
  float* dts = reinterpret_cast<float*>(smem + Ly::kDt);
  float* es = reinterpret_cast<float*>(smem + Ly::kE);
  float* wls = reinterpret_cast<float*>(smem + Ly::kW);
  double* css = reinterpret_cast<double*>(smem + Ly::kCs);

  const int nps = (p + kP - 1) / kP;
  const int c = blockIdx.x / nps, p0 = (blockIdx.x % nps) * kP;
  const int np_ = min(kP, p - p0);
  const int head = blockIdx.y;
  const int64_t bi = blockIdx.z;
  const int grp = head / (h / g);
  const float A = -expf(a_log[head]);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int64_t r0 = int64_t(c) * kLc;
  const int rows_c = int(s - r0 < kLc ? s - r0 : kLc);
  const int64_t xrow = int64_t(h) * p, bcrow = int64_t(g) * N;
  const bf16* xb = x + (bi * s + r0) * xrow + int64_t(head) * p + p0;
  bf16* yb = y + (bi * s + r0) * xrow + int64_t(head) * p + p0;
  const float* dtb = dt + (bi * s + r0) * h + head;
  const bf16* bb = bm + (bi * s + r0) * bcrow + int64_t(grp) * N;
  const bf16* cb = cm + (bi * s + r0) * bcrow + int64_t(grp) * N;
  const float* s_in = states + (((bi * h + head) * nc + c) * p + p0) * N;
  const int nsub = (rows_c + kL - 1) / kL;
  const bool ypair = p % 2 == 0;

  // the entering state (p slice x N; rows past the slice zero): f32, and
  // split into the bf16 tiles that C S^T reads
  for (int i = tid; i < kP * (N / 2); i += kThreads) {
    const int m = i / (N / 2), c2 = 2 * (i % (N / 2));
    const float2 v = m < np_
        ? *reinterpret_cast<const float2*>(s_in + int64_t(m) * N + c2)
        : make_float2(0.f, 0.f);
    *reinterpret_cast<float2*>(sf + m * Ly::kSs + c2) = v;
    uint32_t hi, lo;
    split2(v.x, v.y, hi, lo);
    *reinterpret_cast<uint32_t*>(sh + tile_off(m, c2)) = hi;
    *reinterpret_cast<uint32_t*>(sl + tile_off(m, c2)) = lo;
  }

  // this thread's accumulator rows (of y: time; of S: p) and columns
  const int i0 = 16 * warp + gq, i1 = i0 + 8;
  for (int k = 0; k < nsub; ++k) {
    const int rows = min(kL, rows_c - k * kL);
    stage_tile<N>(bs, bb + k * kL * bcrow, bcrow, rows, N, true);
    stage_tile<N>(cs_tile, cb + k * kL * bcrow, bcrow, rows, N, true);
    stage_tile<kP>(xs, xb + k * kL * xrow, xrow, rows, np_, xvec);
    if (tid < kL) dts[tid] = tid < rows ? dtb[(k * kL + tid) * int64_t(h)]
                                        : 0.f;
    cp_commit_wait_all();
    fence_async_smem();
    __syncthreads();   // the tiles, dt (and at k 0 the state) are in

    // scores = C B^T and y = C (S hi + S lo)^T, over n
    float sc[32], yacc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = yacc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      const uint64_t dc = kmajor(cs_tile, kk);
      Wgmma<64>::template ss<0, 0>(sc, dc, kmajor(bs, kk), 1);
      Wgmma<64>::template ss<0, 0>(yacc, dc, kmajor(sh, kk), 1);
      Wgmma<64>::template ss<0, 0>(yacc, dc, kmajor(sl, kk), 1);
    }
    wgmma_commit();
    if (warp == 0) cumsum64(dts, A, css, lane);   // under the products
    __syncthreads();
    const double cs_last = css[kL - 1];
    if (tid < kL) {
      es[tid] = expf(float(css[tid]));
      wls[tid] = __fmul_rn(expf(float(cs_last - css[tid])), dts[tid]);
    }
    wgmma_wait<0>();
    pin(sc);
    pin(yacc);
    __syncthreads();   // exp(cs) and the weights are in

    // y rows times exp(cs_i); G = scores exp(cs_i - cs_j) dt_j, j <= i,
    // split into the A fragments of G x
    const float e0 = es[i0], e1 = es[i1];
    const double c0 = css[i0], c1 = css[i1];
    uint32_t gh[kL / 16][4], gl[kL / 16][4];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const bool r8 = (i % 4) >> 1;
      const int row = r8 ? i1 : i0;
      const double ci = r8 ? c1 : c0;
      yacc[i] = __fmul_rn(yacc[i], r8 ? e1 : e0);
      yacc[i + 1] = __fmul_rn(yacc[i + 1], r8 ? e1 : e0);
      float v[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = 8 * (i / 4) + 2 * tq + u;
        // exp(cs_i - cs_j) as one ex2 (~2^-21 relative where it counts)
        v[u] = j <= row
                   ? __fmul_rn(__fmul_rn(sc[i + u],
                                         ex2(__fmul_rn(float(ci - css[j]),
                                                       kLog2e))),
                               dts[j])
                   : 0.f;
      }
      split2(v[0], v[1], gh[i / 8][(i % 8) / 2], gl[i / 8][(i % 8) / 2]);
    }
    // y += G x, x read MN-major
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kL / 16; ++kk) {
      Wgmma<64>::template rs<1>(yacc, gh[kk], mnmajor(xs, kk), 1);
      Wgmma<64>::template rs<1>(yacc, gl[kk], mnmajor(xs, kk), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    pin(yacc);
    pin(gh);
    pin(gl);
    bf16* yrow = yb + int64_t(k) * kL * xrow;
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int row = (i % 4) >> 1 ? i1 : i0;
      const int col = 8 * (i / 4) + 2 * tq;
      if (row >= rows || col >= np_) continue;
      bf16* dst = yrow + row * xrow + col;
      if (ypair && col + 1 < np_) {
        *reinterpret_cast<__nv_bfloat162*>(dst) =
            __floats2bfloat162_rn(yacc[i], yacc[i + 1]);
      } else {
        dst[0] = __float2bfloat16(yacc[i]);
        if (col + 1 < np_) dst[1] = __float2bfloat16(yacc[i + 1]);
      }
    }

    // S = S exp(cs_last) + (x w)^T B, for the chunk's next sub-chunk
    if (k + 1 < nsub) {
      const float decay_k = expf(float(cs_last));
      float sa[N / 2];
#pragma unroll
      for (int i = 0; i < N / 2; i += 2) {
        const int m = (i % 4) >> 1 ? i1 : i0;
        const float2 v = *reinterpret_cast<const float2*>(
            sf + m * Ly::kSs + 8 * (i / 4) + 2 * tq);
        sa[i] = __fmul_rn(v.x, decay_k);
        sa[i + 1] = __fmul_rn(v.y, decay_k);
      }
      uint32_t ah[kL / 16][4], al[kL / 16][4];
#pragma unroll
      for (int kk = 0; kk < kL / 16; ++kk)
        xw_frags(xs, wls, kk, warp, gq, tq, ah[kk], al[kk]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kL / 16; ++kk) {
        Wgmma<N>::template rs<1>(sa, ah[kk], mnmajor(bs, kk), 1);
        Wgmma<N>::template rs<1>(sa, al[kk], mnmajor(bs, kk), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      pin(sa);
      pin(ah);
      pin(al);
      __syncthreads();   // every wgmma that read S hi and lo is done
#pragma unroll
      for (int i = 0; i < N / 2; i += 2) {
        const int m = (i % 4) >> 1 ? i1 : i0;
        const int col = 8 * (i / 4) + 2 * tq;
        *reinterpret_cast<float2*>(sf + m * Ly::kSs + col) =
            make_float2(sa[i], sa[i + 1]);
        uint32_t hi, lo;
        split2(sa[i], sa[i + 1], hi, lo);
        *reinterpret_cast<uint32_t*>(sh + tile_off(m, col)) = hi;
        *reinterpret_cast<uint32_t*>(sl + tile_off(m, col)) = lo;
      }
    }
    __syncthreads();   // the tiles are read before they are refilled
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(bytes));
}

template <int N>
int launch_ssd_scan_bf16(const bf16* x, const float* dt, const float* a_log,
                         const bf16* bm, const bf16* cm, const float* s0,
                         int64_t b, int64_t s, int h, int p, int g, bf16* y,
                         float* s_out, float* states, float* decay,
                         cudaStream_t stream) {
  cudaError_t err =
      allow_smem(ssd_state_bf16_kernel<N>, StatePlan<N>::kBytes);
  if (err == cudaSuccess)
    err = allow_smem(ssd_out_bf16_kernel<N>, OutPlan<N>::kBytes);
  if (err != cudaSuccess) return int(err);
  const int nc = int((s + kLc - 1) / kLc);
  const int nps = (p + kP - 1) / kP;
  const bool xvec = p % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const dim3 chunks(unsigned(nc * nps), unsigned(h), unsigned(b));
  ssd_state_bf16_kernel<N><<<chunks, kThreads, StatePlan<N>::kBytes,
                             stream>>>(x, dt, a_log, bm, s, h, p, g, nc, xvec,
                                       states, decay);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  const int64_t pn4 = int64_t(p) * N / 4;
  const dim3 carry(unsigned((pn4 + kCarryThreads - 1) / kCarryThreads),
                   unsigned(h), unsigned(b));
  ssd_carry_bf16_kernel<<<carry, kCarryThreads, 0, stream>>>(
      s0, states, decay, h, nc, pn4, s_out);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  ssd_out_bf16_kernel<N><<<chunks, kThreads, OutPlan<N>::kBytes, stream>>>(
      x, dt, a_log, bm, cm, states, s, h, p, g, nc, xvec, y);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

int sage_ssd_scan_bf16(const void* x, const float* dt, const float* a_log,
                       const void* bm, const void* cm, const float* s0,
                       int64_t b, int64_t s, int h, int p, int g, int n,
                       void* y, float* s_out, float* states, float* decay,
                       int chunk_rows, int sub_rows, void* stream) {
  // the caller sized the scratch by chunk_rows and sub_rows: they must be
  // this kernel's own, or its passes would index past the scratch
  if (chunk_rows != kLc || sub_rows != kL) return int(cudaErrorInvalidValue);
  if (b <= 0 || b > 65535 || s <= 0 || h <= 0 || h > 65535 || p <= 0 ||
      g <= 0 || h % g != 0 ||
      (s + kLc - 1) / kLc * ((p + kP - 1) / kP) > int64_t(2147483647))
    return int(cudaErrorInvalidValue);
  // B and C are copied 16 bytes at a time
  if ((reinterpret_cast<uintptr_t>(bm) | reinterpret_cast<uintptr_t>(cm)) %
          16 != 0)
    return int(cudaErrorMisalignedAddress);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* bp = static_cast<const bf16*>(bm);
  const bf16* cp = static_cast<const bf16*>(cm);
  bf16* yp = static_cast<bf16*>(y);
  switch (n) {
    case 16:
      return launch_ssd_scan_bf16<16>(xp, dt, a_log, bp, cp, s0, b, s, h, p,
                                      g, yp, s_out, states, decay, st);
    case 32:
      return launch_ssd_scan_bf16<32>(xp, dt, a_log, bp, cp, s0, b, s, h, p,
                                      g, yp, s_out, states, decay, st);
    case 64:
      return launch_ssd_scan_bf16<64>(xp, dt, a_log, bp, cp, s0, b, s, h, p,
                                      g, yp, s_out, states, decay, st);
    case 128:
      return launch_ssd_scan_bf16<128>(xp, dt, a_log, bp, cp, s0, b, s, h, p,
                                       g, yp, s_out, states, decay, st);
    case 256:
      return launch_ssd_scan_bf16<256>(xp, dt, a_log, bp, cp, s0, b, s, h, p,
                                       g, yp, s_out, states, decay, st);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // extern "C"
