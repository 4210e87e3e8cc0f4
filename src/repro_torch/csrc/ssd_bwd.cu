// B6's backward: the gradient of the Mamba2 SSD scan (ssm_kernels.cu) for
// every input, written for Hopper (sm_90a) and bound through a plain C
// interface (ctypes, no PyTorch headers).  The launcher returns the
// cudaError_t of its launches; sage_error_string (analytics_kernels.cu)
// names it.
//
//   sage_ssd_scan_bwd  <- none: the reference differentiates ssd_chunked
//                         (repro/models/ssm.py) with jax.grad, and its
//                         Pallas kernel (repro/kernels/ssd_scan.py) has no
//                         custom_vjp.  Added so that training on the card
//                         stops recomputing and differentiating the plain
//                         scan in every layer.
//
// ---------------------------------------------------------------------------
// sage_ssd_scan_bwd
//
// The forward's chunked algorithm run in reverse (arXiv:2405.21060; the
// passes of mamba_ssm's ssd_combined backward), on the forward's own
// split: 256-row chunks whose entering states H_c the forward left in
// `states` (with their decays D_c in `decay`), walked in 64-row
// sub-chunks whose C B^T the forward left in `scores`.  With cs the
// cumsum of dt A (f64) from the chunk's or sub-chunk's start:
//   1. ssd_bwd_dstate_kernel, a block per (batch, head, chunk, p slice):
//      Q_c = sum_i exp(cs_i) dy_i (x) C_i into `dstates`;
//   2. ssd_bwd_carry_kernel, a thread per (batch, head, 4 entries of
//      p x n): from dH = dfinal (or 0), for c = nc - 1 .. 0 replaces Q_c
//      with dH (the gradient of the state leaving chunk c), then dH = D_c
//      dH + Q_c; writes the last dH to ds0;
//   3. ssd_bwd_chunk_kernel, a block per (batch, head, chunk, p slice):
//      walks the chunk's sub-chunks forward from H_c for the states H^k
//      entering them (the forward's own steps; all but the last go to the
//      `hsub` scratch), then back from the leaving gradient dH.  In each,
//      with M = C B^T exp(cs_i - cs_j), Wd = dy x^T exp(cs_i - cs_j) (j <=
//      i) and e_j = exp(cs_last - cs_j):
//        dx_j   = dt_j (e_j dH B_j + M^T dy),
//        dB'_j  = e_j dH^T x_j + Wd^T C            (dB = dt dB'),
//        dC_i   = exp(cs_i) dy_i H^k + Wd (dt B),
//        ddA_k  = sum_{i >= k > j} W_ij + sum_{i >= k} C_i . exp(cs_i) dy_i H
//                 + sum_{j < k} dt_j B_j . e_j dH^T x_j + exp(cs_last) <dH, H>,
//      W = Wd C B^T dt_j, each part a sum that cancels nothing (row sums
//      less column sums, autograd's form, leave ~1e-4 of d a_log in f32:
//      tests/test_torch_ssd_bwd.py), the 1-D sums in f64; then dH =
//      exp(cs_last) dH + (dy exp(cs))^T C.  dx is written whole; dB and
//      dC (summed over a group's heads and the p slices) and ddt's direct
//      part and ddA (summed over the p slices) go to per-slice partials;
//   4. ssd_bwd_dt_kernel, a block per head: ddt = sum ddt' + A sum ddA,
//      d a_log = A sum_rows dt ddA (f64);
//   5. ssd_bwd_bc_kernel, a thread per 4 entries of dB or dC: the partials
//      summed in a fixed order.
// No float atomics: the same inputs give the same bits.
// x, dy, dx: (b, s, h, p); dt, ddt: (b, s, h); a_log, da_log: (h,); B, C,
// dB, dC: (b, s, g, n); dfinal, ds0: (b, h, p, n), either may be null; all
// f32 and contiguous.  Scratch from the caller (f32): dstates (b, h, nc, p,
// n), hsub (b, h, nc, 2, p, n), dB and dC partials (b, s, g, (h / g) nps,
// n) each, ddt and ddA partials (b, h, nps, s) each, nps = ceil(p /
// p_slice); the caller passes the 256, 64 and p slice it sized them by,
// and any other is refused with cudaErrorInvalidValue.
//
// What bounds it on the card.  At mamba2-130m's training shape (b 8, s
// 2048, h 24, p 64, n 128, g 1) the gradient reads and writes 0.39 GB at
// least (0.117 ms at 3.35 TB/s).  These passes move ~1.7 GB, most of it
// the per-head partials of dB and dC and the sub-chunks' states (~0.5 ms),
// and take ~2.1e10 multiply-adds, each three TF32 products for the split
// (~0.25 ms at the tensor cores' rate).  Pass 3 keeps every operand of a
// sub-chunk in shared memory, one block a multiprocessor, and stages the
// next sub-chunk only once this one is done (no room for two).
//
// Tensor cores: every product as mma.sync m16n8k8 TF32 with split operands
// (3xTF32, tf32_mma.cuh), as in the forward.
//
// Shared memory of pass 3 (floats), one block a multiprocessor: B, C (64 x
// (N + 4)), x (64 x (P + 8)), dy (64 x (P + 4)), dt (64); H (P x (N + 4)),
// dH (P x (N + 8)); M and Wd (64 x 68; W takes M's place, 64 x 65, once
// dx is done); exp(cs), e_j; the rows' partial dots; the f64 cumsum and
// its two scans.  n 128, p slice 64: 212,288 B; n 256, p slice 16:
// 221,248 B.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ssd_tiles.cuh"
#include "tf32_mma.cuh"

namespace {

using namespace sage_mma;   // cp.async, split-TF32 fragments and products
using namespace sage_ssd;   // kL, kLc and the tile helpers

constexpr int kThreadsQ = 256;   // pass 1: a row of the chunk a thread
constexpr int kThreadsC = 512;   // pass 3: 16 warps, one block an SM
constexpr int kCarryThreads = 256;
constexpr int kReduceThreads = 256;
constexpr int kSubs = kLc / kL;  // sub-chunks a chunk
constexpr int kHsub = kSubs - 2; // entering states kept in `hsub` a chunk
static_assert(kThreadsQ == kLc, "pass 1 scans a row of the chunk a thread");

template <int N>
struct BwdCfg {
  static constexpr int kPQ = N <= 128 ? 64 : 32;   // pass 1's p slice
  static constexpr int kP = N <= 128 ? 64 : 16;    // pass 3's p slice
};

// A, element (m, k) at p[k * ld + m] (frag_a_cols without weights)
__device__ __forceinline__ FragA frag_a_t(const float* p, int ld, int g,
                                          int t) {
  const float* r0 = p + 2 * t * ld;
  const float* r1 = r0 + ld;
  return split_a(r0[g], r0[g + 8], r1[g], r1[g + 8]);
}

// B, element (k, col) at p[k * ld + col], times w[k] (w at the 8-step's k)
__device__ __forceinline__ FragB frag_b_cols_w(const float* p, int ld,
                                               const float* w, int g, int t) {
  FragB f;
  split(__fmul_rn(p[2 * t * ld + g], w[2 * t]), f.hi[0], f.lo[0]);
  split(__fmul_rn(p[(2 * t + 1) * ld + g], w[2 * t + 1]), f.hi[1], f.lo[1]);
  return f;
}

// the sum over the 4 lanes of a row quad (t = 0..3), in a fixed order
__device__ __forceinline__ float quad_sum(float v) {
  v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// ---------------------------------------------------------------------------
// pass 1: each chunk's sum_i exp(cs_i) dy_i (x) C_i
// ---------------------------------------------------------------------------

template <int N, int P>
struct QLayout {   // per stage (two): C (64 x (N + 4)), dy (64 x (P + 4))
  static constexpr int kStages = 2;
  static constexpr int kNs = N + 4;
  static constexpr int kYs = P + 4;
  static constexpr int kC = 0;
  static constexpr int kY = kC + kL * kNs;
  static constexpr int kStage = kY + kL * kYs;
  static constexpr int kW = kStages * kStage;   // the chunk's row weights
  static constexpr int kSum = kW + kLc;         // f64 sums of the warps
  static constexpr size_t kBytes =
      sizeof(float) * kSum + sizeof(double) * (kThreadsQ / 32);
};

template <int N, int P>
__global__ void __launch_bounds__(kThreadsQ, 2)
ssd_bwd_dstate_kernel(const float* __restrict__ dy,
                      const float* __restrict__ dt,
                      const float* __restrict__ a_log,
                      const float* __restrict__ cm, int64_t s, int h, int p,
                      int g, int nc, float* __restrict__ dstates) {
  using Ly = QLayout<N, P>;
  constexpr int kWarps = kThreadsQ / 32;
  constexpr int R = P / 16;              // 16-row p tiles
  constexpr int NW = N * R / kWarps;     // columns a warp
  constexpr int NT = NW / 8;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* wls = smem + Ly::kW;
  double* wsum = reinterpret_cast<double*>(smem + Ly::kSum);

  const int nps = (p + P - 1) / P;
  const int c = blockIdx.x / nps, p0 = (blockIdx.x % nps) * P;
  const int np_ = min(P, p - p0);
  const int head = blockIdx.y;
  const int64_t bi = blockIdx.z;
  const int grp = head / (h / g);
  const float A = -expf(a_log[head]);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int64_t r0 = int64_t(c) * kLc;
  const int rows_c = int(s - r0 < kLc ? s - r0 : kLc);
  const int64_t yrow = int64_t(h) * p, bcrow = int64_t(g) * N;
  const float* yb = dy + (bi * s + r0) * yrow + int64_t(head) * p + p0;
  const float* cb = cm + (bi * s + r0) * bcrow + int64_t(grp) * N;
  const bool yvec =
      p % 4 == 0 && (reinterpret_cast<uintptr_t>(dy) & 15) == 0;
  const int nsub = (rows_c + kL - 1) / kL;

  auto stage = [&](int k) {
    float* base = smem + (k & 1) * Ly::kStage;
    const int rows = min(kL, rows_c - k * kL);
    stage_tile<N, kThreadsQ>(base + Ly::kC, Ly::kNs, cb + k * kL * bcrow,
                             bcrow, rows, N, true);
    stage_tile<P, kThreadsQ>(base + Ly::kY, Ly::kYs, yb + k * kL * yrow,
                             yrow, rows, np_, yvec);
  };
  stage(0);
  cp_commit();

  // the chunk's f64 cumsum of dt A (a row a thread), then exp of it
  const float dtv = tid < rows_c ? dt[(bi * s + r0 + tid) * h + head] : 0.f;
  double v = double(dtv * A);
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) wsum[warp] = v;
  __syncthreads();
  double sum = 0.0;
  for (int w = 0; w < kWarps; ++w) {
    if (w == warp) v += sum;    // the warps before this one
    sum += wsum[w];
  }
  wls[tid] = expf(float(v));

  const int pp0 = 16 * (warp % R), n0 = NW * (warp / R);
  Acc<2> acc[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) zero(acc[j]);

  for (int k = 0; k < nsub; ++k) {
    if (k + 1 < nsub) stage(k + 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const float* base = smem + (k & 1) * Ly::kStage;
    const float* cs_tile = base + Ly::kC;
    const float* ys = base + Ly::kY;
    const int rows = min(kL, rows_c - k * kL);
    for (int k0 = 0; k0 < rows; k0 += 8) {
      const FragA a = frag_a_cols(ys + k0 * Ly::kYs + pp0, Ly::kYs,
                                  wls + k * kL + k0, gq, tq);
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mma3(acc[j], a, frag_b_cols(cs_tile + k0 * Ly::kNs + n0 + 8 * j,
                                    Ly::kNs, gq, tq));
    }
    __syncthreads();   // the stage is read before it is refilled
  }

  float* out = dstates + (((bi * h + head) * nc + c) * p + p0) * N;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = n0 + 8 * j + 2 * tq;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int pp = pp0 + gq + 8 * half;
      if (pp < np_)
        *reinterpret_cast<float2*>(out + int64_t(pp) * N + col) = make_float2(
            total(acc[j], 2 * half), total(acc[j], 2 * half + 1));
    }
  }
}

// ---------------------------------------------------------------------------
// pass 2: the gradient of the state leaving each chunk, and of s0
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kCarryThreads)
ssd_bwd_carry_kernel(const float* __restrict__ dfinal,
                     float* __restrict__ dstates,
                     const float* __restrict__ decay, int h, int nc,
                     int64_t pn4, float* __restrict__ ds0) {
  const int64_t q = int64_t(blockIdx.x) * kCarryThreads + threadIdx.x;
  if (q >= pn4) return;
  const int64_t bh = int64_t(blockIdx.z) * h + blockIdx.y;
  float4 grad = dfinal != nullptr
                    ? reinterpret_cast<const float4*>(dfinal)[bh * pn4 + q]
                    : make_float4(0.f, 0.f, 0.f, 0.f);
  float4* st = reinterpret_cast<float4*>(dstates) + bh * nc * pn4 + q;
  const float* dec = decay + bh * nc;
  float4 next = st[int64_t(nc - 1) * pn4];
  for (int c = nc - 1; c >= 0; --c) {
    const float4 loc = next;
    if (c > 0) next = st[int64_t(c - 1) * pn4];
    const float d = dec[c];
    st[int64_t(c) * pn4] = grad;
    grad.x = __fadd_rn(__fmul_rn(grad.x, d), loc.x);
    grad.y = __fadd_rn(__fmul_rn(grad.y, d), loc.y);
    grad.z = __fadd_rn(__fmul_rn(grad.z, d), loc.z);
    grad.w = __fadd_rn(__fmul_rn(grad.w, d), loc.w);
  }
  if (ds0 != nullptr) reinterpret_cast<float4*>(ds0)[bh * pn4 + q] = grad;
}

// ---------------------------------------------------------------------------
// pass 3: each chunk's rows, its sub-chunks walked forward and back
// ---------------------------------------------------------------------------

template <int N, int P>
struct ChunkLayout {
  static constexpr int kNTB = N / 8 < 4 ? N / 8 : 4;  // n8 tiles a dB'/dC item
  static constexpr int kNG = N / (8 * kNTB);          // their column groups
  static constexpr int kBs = N + 4;   // B rows (read both ways)
  static constexpr int kCs = N + 4;   // C rows (down the columns)
  static constexpr int kXs = P + 8;   // x rows (along the rows)
  static constexpr int kYs = P + 4;   // dy rows (both ways)
  static constexpr int kHs = N + 4;   // H rows (down the columns)
  static constexpr int kDs = N + 8;   // dH rows (both ways)
  static constexpr int kMs = kL + 4;  // M and Wd rows (both ways)
  static constexpr int kWs = kL + 1;  // W rows: a row a thread, a column
  static constexpr int kB = 0;
  static constexpr int kC = kB + kL * kBs;
  static constexpr int kX = kC + kL * kCs;
  static constexpr int kY = kX + kL * kXs;
  static constexpr int kDt = kY + kL * kYs;
  static constexpr int kH = kDt + kL;
  static constexpr int kD = kH + P * kHs;
  static constexpr int kM = kD + P * kDs;
  static constexpr int kWd = kM + kL * kMs;
  static constexpr int kE = kWd + kL * kMs;   // exp(cs_i)
  static constexpr int kEl = kE + kL;         // e_j (times dt_j walking on)
  static constexpr int kRows = kEl + kL;      // y_off, state, ddt: [kNG][kL]
  static constexpr int kDot = kRows + 3 * kNG * kL;   // the warps' <dH, H>
  static constexpr int kF64 = kDot + kThreadsC / 32;  // cumsum, 2 scans
  static constexpr size_t kBytes =
      sizeof(float) * kF64 + sizeof(double) * 3 * kL;
  static_assert(kL * kWs <= kL * kMs, "W fits in M's place");
  static_assert(kF64 % 2 == 0, "the f64 arrays start on 8 bytes");
};

template <int N, int P>
__global__ void __launch_bounds__(kThreadsC, 1)
ssd_bwd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ a_log,
                     const float* __restrict__ bm,
                     const float* __restrict__ cm,
                     const float* __restrict__ dy,
                     const float* __restrict__ states,
                     const float* __restrict__ dstates,
                     const float* __restrict__ scores, int64_t s, int h,
                     int p, int g, int nc, float* __restrict__ hsub,
                     float* __restrict__ dx, float* __restrict__ dbp,
                     float* __restrict__ dcp, float* __restrict__ ddtp,
                     float* __restrict__ ddap) {
  using Ly = ChunkLayout<N, P>;
  constexpr int kWarps = kThreadsC / 32;
  constexpr int NTB = Ly::kNTB, NG = Ly::kNG;
  constexpr int CG = P / 16;                     // dx: 16-column groups
  constexpr int R = P / 16;                      // state walks: p tiles
  constexpr int NS = kWarps / R < N / 8 ? kWarps / R : N / 8;
  constexpr int NW = N / NS;                     // their columns a warp
  constexpr int NT = NW / 8;
  constexpr int kGT = (kScoreTiles + kWarps - 1) / kWarps;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* bs = smem + Ly::kB;
  float* cs_t = smem + Ly::kC;
  float* xs = smem + Ly::kX;
  float* ys = smem + Ly::kY;
  float* dts = smem + Ly::kDt;
  float* hs = smem + Ly::kH;
  float* ds = smem + Ly::kD;
  float* ms = smem + Ly::kM;
  float* ws = ms;                                // W, once M is read
  float* wds = smem + Ly::kWd;
  float* es = smem + Ly::kE;
  float* els = smem + Ly::kEl;
  float* yoffp = smem + Ly::kRows;
  float* tstp = yoffp + NG * kL;
  float* ddtq = tstp + NG * kL;
  float* dots = smem + Ly::kDot;
  double* css = reinterpret_cast<double*>(smem + Ly::kF64);
  double* ysum = css + kL;
  double* tsum = ysum + kL;

  const int nps = (p + P - 1) / P;
  const int c = blockIdx.x / nps, ps = blockIdx.x % nps, p0 = ps * P;
  const int np_ = min(P, p - p0);
  const int head = blockIdx.y;
  const int64_t bi = blockIdx.z;
  const int r = h / g, grp = head / r;
  const int nr = r * nps;                        // partials a group
  const int slot = (head % r) * nps + ps;        // this block's
  const float A = -expf(a_log[head]);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int64_t r0 = int64_t(c) * kLc;
  const int rows_c = int(s - r0 < kLc ? s - r0 : kLc);
  const int nsub = (rows_c + kL - 1) / kL;
  const int64_t nsub_all = (s + kL - 1) / kL;
  const int64_t xrow = int64_t(h) * p, bcrow = int64_t(g) * N;
  const int64_t prow = int64_t(g) * nr * N;     // a row of the partials
  const int64_t bh = bi * h + head;
  const float* xb = x + (bi * s + r0) * xrow + int64_t(head) * p + p0;
  const float* yb = dy + (bi * s + r0) * xrow + int64_t(head) * p + p0;
  float* dxb = dx + (bi * s + r0) * xrow + int64_t(head) * p + p0;
  const float* dtb = dt + (bi * s + r0) * h + head;
  const float* bb = bm + (bi * s + r0) * bcrow + int64_t(grp) * N;
  const float* cb = cm + (bi * s + r0) * bcrow + int64_t(grp) * N;
  const int64_t part = ((bi * s + r0) * g + grp) * nr * N + int64_t(slot) * N;
  float* dbb = dbp + part;
  float* dcb = dcp + part;
  const float* h_in = states + ((bh * nc + c) * p + p0) * N;
  const float* dh_in = dstates + ((bh * nc + c) * p + p0) * N;
  float* hsb = hsub + ((bh * nc + c) * kHsub * p + p0) * N;
  const int64_t row_part = (bh * nps + ps) * s + r0;
  const bool xvec = p % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool yvec =
      p % 4 == 0 && (reinterpret_cast<uintptr_t>(dy) & 15) == 0;

  // a (P x N) state of the slice from rows N floats apart (rows past the
  // slice zero)
  auto load_state_tile = [&](float* dst, int ld, const float* src) {
    for (int i = tid; i < P * (N / 4); i += kThreadsC) {
      const int pp = i / (N / 4), c4 = 4 * (i % (N / 4));
      cp16(dst + pp * ld + c4, pp < np_ ? src + pp * N + c4 : src,
           pp < np_);
    }
  };
  // the sub-chunk's rows: B, x and dt; C and dy too walking back
  auto stage = [&](int k, bool back) {
    const int rows = min(kL, rows_c - k * kL);
    stage_tile<N, kThreadsC>(bs, Ly::kBs, bb + k * kL * bcrow, bcrow, rows,
                             N, true);
    stage_tile<P, kThreadsC>(xs, Ly::kXs, xb + k * kL * xrow, xrow, rows,
                             np_, xvec);
    if (back) {
      stage_tile<N, kThreadsC>(cs_t, Ly::kCs, cb + k * kL * bcrow, bcrow,
                               rows, N, true);
      stage_tile<P, kThreadsC>(ys, Ly::kYs, yb + k * kL * xrow, xrow, rows,
                               np_, yvec);
    }
    if (tid < kL) {
      const bool ok = tid < rows;
      cp4(dts + tid, ok ? dtb + (k * kL + tid) * int64_t(h) : dtb, ok);
    }
  };
  // T = T scale + (a w)^T b over the sub-chunk's rows: the forward's state
  // step (T = H, a = x, w = e dt, b = B) and the gradient's walking back
  // (T = dH, a = dy, w = exp(cs), b = C); a warp a (16 x NW) tile of T
  auto walk = [&](float* st_buf, int st_ld, const float* a, int a_ld,
                  const float* w, const float* bsrc, int b_ld, float scale) {
    if (warp >= R * NS) return;
    const int pp0 = 16 * (warp % R), n0 = NW * (warp / R);
    float* st = st_buf + pp0 * st_ld + n0;
    Acc<3> acc[NT];
    load_state(acc, st, st_ld, gq, tq, scale);
    for (int k0 = 0; k0 < kL; k0 += 8) {
      const FragA fa = frag_a_cols(a + k0 * a_ld + pp0, a_ld, w + k0, gq, tq);
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mma3(acc[j], fa, frag_b_cols(bsrc + k0 * b_ld + n0 + 8 * j, b_ld, gq,
                                     tq));
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(st + (gq + 8 * hh) * st_ld + 8 * j +
                                   2 * tq) =
            make_float2(total(acc[j], 2 * hh), total(acc[j], 2 * hh + 1));
  };

  load_state_tile(hs, Ly::kHs, h_in);
  load_state_tile(ds, Ly::kDs, dh_in);
  cp_commit();

  // the states entering the sub-chunks, from the chunk's: all but the
  // last to `hsub`, the last kept here
  for (int k = 0; k + 1 < nsub; ++k) {
    stage(k, false);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    if (warp == 0) cumsum64(dts, A, css, lane);
    __syncthreads();
    const double cs_last = css[kL - 1];
    if (tid < kL) els[tid] = expf(float(cs_last - css[tid])) * dts[tid];
    __syncthreads();
    walk(hs, Ly::kHs, xs, Ly::kXs, els, bs, Ly::kBs, expf(float(cs_last)));
    __syncthreads();
    if (k + 2 < nsub) {
      float* dst = hsb + int64_t(k) * p * N;
      for (int i = tid; i < np_ * (N / 4); i += kThreadsC) {
        const int pp = i / (N / 4), c4 = 4 * (i % (N / 4));
        *reinterpret_cast<float4*>(dst + pp * N + c4) =
            *reinterpret_cast<const float4*>(hs + pp * Ly::kHs + c4);
      }
    }
  }

  for (int k = nsub - 1; k >= 0; --k) {
    if (k + 1 < nsub)
      load_state_tile(hs, Ly::kHs,
                      k == 0 ? h_in : hsb + int64_t(k - 1) * p * N);
    stage(k, true);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    const int rows = min(kL, rows_c - k * kL);
    const int kend = (rows + 7) & ~7;

    // this warp's score tiles q2 = warp + 16 u (the forward's C B^T),
    // loaded while warp 0 scans
    int i0g[kGT], j0g[kGT];
    float2 sv[kGT][2];
    const float* sc = scores + ((bi * g + grp) * nsub_all + c * kSubs + k) *
                                   (kL * kL);
#pragma unroll
    for (int u = 0; u < kGT; ++u) {
      score_tile(warp + kWarps * u, i0g[u], j0g[u]);
      if (warp + kWarps * u < kScoreTiles && i0g[u] < rows) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          sv[u][hh] = *reinterpret_cast<const float2*>(
              sc + (i0g[u] + gq + 8 * hh) * kL + j0g[u] + 2 * tq);
      }
    }
    if (warp == 0) cumsum64(dts, A, css, lane);
    // <dH, H> over the slice: each thread's entries, then the warp's
    {
      float acc = 0.f;
      for (int i = tid; i < P * N; i += kThreadsC) {
        const int pp = i / N, col = i % N;
        acc = __fadd_rn(acc, __fmul_rn(ds[pp * Ly::kDs + col],
                                       hs[pp * Ly::kHs + col]));
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, o));
      if (lane == 0) dots[warp] = acc;
    }
    __syncthreads();
    const double cs_last = css[kL - 1];
    if (tid < kL) {
      es[tid] = expf(float(css[tid]));
      els[tid] = expf(float(cs_last - css[tid]));
    }

    // M = C B^T exp(cs_i - cs_j) and Wd = dy x^T exp(cs_i - cs_j) on the
    // causal tiles (0 above the diagonal and past the rows)
#pragma unroll
    for (int u = 0; u < kGT; ++u) {
      if (warp + kWarps * u >= kScoreTiles) continue;
      const int i0 = i0g[u], j0 = j0g[u];
      if (i0 >= rows) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int at = (i0 + gq + 8 * hh) * Ly::kMs + j0 + 2 * tq;
          *reinterpret_cast<float2*>(ms + at) = make_float2(0.f, 0.f);
          *reinterpret_cast<float2*>(wds + at) = make_float2(0.f, 0.f);
        }
        continue;
      }
      Acc<3> d;
      zero(d);
#pragma unroll 4
      for (int k0 = 0; k0 < P; k0 += 8)
        mma3(d, frag_a_rows(ys + i0 * Ly::kYs + k0, Ly::kYs, gq, tq),
             frag_b_rows(xs + j0 * Ly::kXs + k0, Ly::kXs, gq, tq));
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = i0 + gq + 8 * hh;
        const float a[2] = {sv[u][hh].x, sv[u][hh].y};
        float mv[2], wv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = j0 + 2 * tq + e;
          const float dec = j <= i ? expf(float(css[i] - css[j])) : 0.f;
          mv[e] = __fmul_rn(a[e], dec);
          wv[e] = __fmul_rn(total(d, 2 * hh + e), dec);
        }
        const int at = i * Ly::kMs + j0 + 2 * tq;
        *reinterpret_cast<float2*>(ms + at) = make_float2(mv[0], mv[1]);
        *reinterpret_cast<float2*>(wds + at) = make_float2(wv[0], wv[1]);
      }
    }
    __syncthreads();

    // dx = dt (e_j dH B_j + M^T dy): rows j0..j0+15, 16 columns
    for (int it = warp; it < 4 * CG; it += kWarps) {
      const int j0 = 16 * (it / CG), c0 = 16 * (it % CG);
      if (j0 >= rows || c0 >= np_) continue;
      Acc<3> acc[2];
      zero(acc[0]);
      zero(acc[1]);
#pragma unroll 4
      for (int k0 = 0; k0 < N; k0 += 8) {
        const FragA fa = frag_a_rows(bs + j0 * Ly::kBs + k0, Ly::kBs, gq, tq);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
          mma3(acc[jj], fa, frag_b_rows(ds + (c0 + 8 * jj) * Ly::kDs + k0,
                                        Ly::kDs, gq, tq));
      }
      const float e0 = els[j0 + gq], e1 = els[j0 + gq + 8];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[jj].big[e] = __fmul_rn(total(acc[jj], e), e < 2 ? e0 : e1);
          acc[jj].lh[e] = acc[jj].hl[e] = 0.f;
        }
      for (int k0 = j0; k0 < kend; k0 += 8) {
        const FragA fa = frag_a_t(ms + k0 * Ly::kMs + j0, Ly::kMs, gq, tq);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
          mma3(acc[jj], fa, frag_b_cols(ys + k0 * Ly::kYs + c0 + 8 * jj,
                                        Ly::kYs, gq, tq));
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = j0 + gq + 8 * (e >> 1);
          const int col = c0 + 8 * jj + 2 * tq + (e & 1);
          if (row < rows && col < np_)
            dxb[(int64_t(k) * kL + row) * xrow + col] =
                __fmul_rn(total(acc[jj], e), dts[row]);
        }
    }
    __syncthreads();   // M is read: W takes its place

    // W = Wd C B^T dt_j, rows kWs apart, for ddA's rectangle sums
#pragma unroll
    for (int u = 0; u < kGT; ++u) {
      if (warp + kWarps * u >= kScoreTiles) continue;
      const int i0 = i0g[u], j0 = j0g[u];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = i0 + gq + 8 * hh, j = j0 + 2 * tq;
        float w0 = 0.f, w1 = 0.f;
        if (i0 < rows) {
          const float2 wd =
              *reinterpret_cast<const float2*>(wds + i * Ly::kMs + j);
          w0 = __fmul_rn(__fmul_rn(wd.x, sv[u][hh].x), dts[j]);
          w1 = __fmul_rn(__fmul_rn(wd.y, sv[u][hh].y), dts[j + 1]);
        }
        ws[i * Ly::kWs + j] = w0;
        ws[i * Ly::kWs + j + 1] = w1;
      }
    }

    // dB' = e_j dH^T x_j + Wd^T C (dB = dt dB'), and dC = exp(cs_i) dy_i
    // H + Wd (dt B): rows r0..r0+15, NTB n8 tiles; the rows' dots with B
    // or C of the state's part and of the whole
    for (int it = warp; it < 8 * NG; it += kWarps) {
      const bool isb = it < 4 * NG;
      const int item = isb ? it : it - 4 * NG;
      const int i0 = 16 * (item / NG), cg = item % NG, n0 = 8 * NTB * cg;
      if (i0 >= rows) continue;
      const float* rows_of = isb ? bs : cs_t;    // dotted with the result
      const int rows_ld = isb ? Ly::kBs : Ly::kCs;
      Acc<3> acc[NTB];
#pragma unroll
      for (int jj = 0; jj < NTB; ++jj) zero(acc[jj]);
#pragma unroll 2
      for (int k0 = 0; k0 < P; k0 += 8) {
        const FragA fa =
            isb ? frag_a_rows(xs + i0 * Ly::kXs + k0, Ly::kXs, gq, tq)
                : frag_a_rows(ys + i0 * Ly::kYs + k0, Ly::kYs, gq, tq);
#pragma unroll
        for (int jj = 0; jj < NTB; ++jj)
          mma3(acc[jj], fa,
               isb ? frag_b_cols(ds + k0 * Ly::kDs + n0 + 8 * jj, Ly::kDs, gq,
                                 tq)
                   : frag_b_cols(hs + k0 * Ly::kHs + n0 + 8 * jj, Ly::kHs, gq,
                                 tq));
      }
      const float* rw = isb ? els : es;
      const float e0 = rw[i0 + gq], e1 = rw[i0 + gq + 8];
      float q0 = 0.f, q1 = 0.f;
#pragma unroll
      for (int jj = 0; jj < NTB; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = __fmul_rn(total(acc[jj], e), e < 2 ? e0 : e1);
          acc[jj].big[e] = v;
          acc[jj].lh[e] = acc[jj].hl[e] = 0.f;
          const int row = i0 + gq + 8 * (e >> 1);
          const float bv =
              rows_of[row * rows_ld + n0 + 8 * jj + 2 * tq + (e & 1)];
          if (e < 2) q0 = __fadd_rn(q0, __fmul_rn(bv, v));
          else q1 = __fadd_rn(q1, __fmul_rn(bv, v));
        }
      q0 = quad_sum(q0);
      q1 = quad_sum(q1);
      float* qs = (isb ? tstp : yoffp) + cg * kL;
      if (tq == 0) {
        qs[i0 + gq] = q0;
        qs[i0 + gq + 8] = q1;
      }
      if (isb) {
        for (int k0 = i0; k0 < kend; k0 += 8) {
          const FragA fa = frag_a_t(wds + k0 * Ly::kMs + i0, Ly::kMs, gq, tq);
#pragma unroll
          for (int jj = 0; jj < NTB; ++jj)
            mma3(acc[jj], fa, frag_b_cols(cs_t + k0 * Ly::kCs + n0 + 8 * jj,
                                          Ly::kCs, gq, tq));
        }
      } else {
        for (int k0 = 0; k0 < i0 + 16; k0 += 8) {
          const FragA fa = frag_a_rows(wds + i0 * Ly::kMs + k0, Ly::kMs, gq,
                                       tq);
#pragma unroll
          for (int jj = 0; jj < NTB; ++jj)
            mma3(acc[jj], fa, frag_b_cols_w(bs + k0 * Ly::kBs + n0 + 8 * jj,
                                            Ly::kBs, dts + k0, gq, tq));
        }
      }
      float d0 = 0.f, d1 = 0.f;
      float* out = isb ? dbb : dcb;
#pragma unroll
      for (int jj = 0; jj < NTB; ++jj)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = i0 + gq + 8 * hh;
          const int col = n0 + 8 * jj + 2 * tq;
          const float v0 = total(acc[jj], 2 * hh);
          const float v1 = total(acc[jj], 2 * hh + 1);
          if (isb) {   // ddt's direct part: B_j . dB'_j
            const float dd = __fadd_rn(__fmul_rn(bs[row * Ly::kBs + col], v0),
                                       __fmul_rn(bs[row * Ly::kBs + col + 1],
                                                 v1));
            if (hh == 0) d0 = __fadd_rn(d0, dd);
            else d1 = __fadd_rn(d1, dd);
          }
          if (row < rows) {
            const float sc_ = isb ? dts[row] : 1.f;
            *reinterpret_cast<float2*>(out + (int64_t(k) * kL + row) * prow +
                                       col) =
                make_float2(__fmul_rn(v0, sc_), __fmul_rn(v1, sc_));
          }
        }
      if (isb) {
        d0 = quad_sum(d0);
        d1 = quad_sum(d1);
        if (tq == 0) {
          ddtq[cg * kL + i0 + gq] = d0;
          ddtq[cg * kL + i0 + gq + 8] = d1;
        }
      }
    }
    __syncthreads();

    if (tid < kL) {
      // W's exclusive prefix along its row, in place: the sum over j < k
      float run = 0.f;
      float* row = ws + tid * Ly::kWs;
      for (int j = 0; j <= tid; ++j) {
        const float v = row[j];
        row[j] = run;
        run = __fadd_rn(run, v);
      }
    } else if (warp == 2 || warp == 3) {
      // f64 scans over the rows (two a lane): the y_off terms of rows i >=
      // k (from the bottom), the state's of rows j < k (from the top)
      const bool bottom = warp == 2;
      const int i0 = bottom ? kL - 1 - 2 * lane : 2 * lane;
      const int i1 = bottom ? i0 - 1 : i0 + 1;
      double v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = e ? i1 : i0;
        float q = 0.f;
        for (int cg = 0; cg < NG; ++cg)
          q = __fadd_rn(q, (bottom ? yoffp : tstp)[cg * kL + i]);
        if (!bottom) q = __fmul_rn(dts[i], q);
        v[e] = i < rows ? double(q) : 0.0;
      }
      double incl = v[0] + v[1];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double u = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += u;
      }
      double excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.0;
      if (bottom) {   // inclusive from the bottom
        ysum[i0] = excl + v[0];
        ysum[i1] = excl + v[0] + v[1];
      } else {        // exclusive from the top
        tsum[i0] = excl;
        tsum[i1] = excl + v[0];
      }
    }
    // dH = exp(cs_last) dH + (dy exp(cs))^T C: the gradient of the state
    // leaving the sub-chunk before
    if (k > 0)
      walk(ds, Ly::kDs, ys, Ly::kYs, es, cs_t, Ly::kCs, expf(float(cs_last)));
    __syncthreads();

    if (tid < kL && tid < rows) {
      float rect = 0.f;   // the rectangle i >= k > j of W
      for (int i = kL - 1; i >= tid; --i)
        rect = __fadd_rn(rect, ws[i * Ly::kWs + tid]);
      float dot = 0.f;
      for (int w = 0; w < kWarps; ++w) dot = __fadd_rn(dot, dots[w]);
      const double dda = double(rect) + ysum[tid] + tsum[tid] +
                         double(__fmul_rn(expf(float(cs_last)), dot));
      float dd = 0.f;
      for (int cg = 0; cg < NG; ++cg) dd = __fadd_rn(dd, ddtq[cg * kL + tid]);
      ddap[row_part + int64_t(k) * kL + tid] = float(dda);
      ddtp[row_part + int64_t(k) * kL + tid] = dd;
    }
    __syncthreads();   // every buffer is read before the next sub-chunk
  }
}

// ---------------------------------------------------------------------------
// pass 4: ddt and d a_log from the p slices' partials
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kReduceThreads)
ssd_bwd_dt_kernel(const float* __restrict__ dt,
                  const float* __restrict__ a_log,
                  const float* __restrict__ ddtp,
                  const float* __restrict__ ddap, int64_t b, int64_t s, int h,
                  int nps, float* __restrict__ ddt,
                  float* __restrict__ da_log) {
  __shared__ double sums[kReduceThreads / 32];
  const int head = blockIdx.x;
  const float A = -expf(a_log[head]);
  double acc = 0.0;
  for (int64_t i = threadIdx.x; i < b * s; i += kReduceThreads) {
    const int64_t bi = i / s, t = i % s;
    float dd = 0.f, da = 0.f;
    for (int q = 0; q < nps; ++q) {
      const int64_t o = ((bi * h + head) * nps + q) * s + t;
      dd = __fadd_rn(dd, ddtp[o]);
      da = __fadd_rn(da, ddap[o]);
    }
    ddt[i * h + head] = __fadd_rn(dd, __fmul_rn(A, da));
    acc += double(dt[i * h + head]) * double(da);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (threadIdx.x % 32 == 0) sums[threadIdx.x / 32] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    double total = 0.0;
    for (int w = 0; w < kReduceThreads / 32; ++w) total += sums[w];
    da_log[head] = float(double(A) * total);
  }
}

// ---------------------------------------------------------------------------
// pass 5: dB and dC, their partials summed in order
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kReduceThreads)
ssd_bwd_bc_kernel(const float* __restrict__ dbp, const float* __restrict__ dcp,
                  int64_t rows, int nr, int n4, float* __restrict__ db,
                  float* __restrict__ dc) {
  const int64_t q = int64_t(blockIdx.x) * kReduceThreads + threadIdx.x;
  if (q >= rows * n4) return;
  const int64_t row = q / n4;
  const int c4 = int(q % n4);
  const float4* src = reinterpret_cast<const float4*>(blockIdx.y ? dcp : dbp) +
                      row * nr * n4 + c4;
  float4 acc = src[0];
  for (int k = 1; k < nr; ++k) {
    const float4 v = src[int64_t(k) * n4];
    acc.x = __fadd_rn(acc.x, v.x);
    acc.y = __fadd_rn(acc.y, v.y);
    acc.z = __fadd_rn(acc.z, v.z);
    acc.w = __fadd_rn(acc.w, v.w);
  }
  reinterpret_cast<float4*>(blockIdx.y ? dc : db)[q] = acc;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(bytes));
}

template <int N>
int launch_ssd_scan_bwd(const float* x, const float* dt, const float* a_log,
                        const float* bm, const float* cm,
                        const float* states, const float* decay,
                        const float* scores, const float* dy,
                        const float* dfinal, int64_t b, int64_t s, int h,
                        int p, int g, float* dx, float* ddt, float* da_log,
                        float* db, float* dc, float* ds0, float* dstates,
                        float* hsub, float* dbp, float* dcp, float* ddtp,
                        float* ddap, cudaStream_t stream) {
  constexpr int PQ = BwdCfg<N>::kPQ, P = BwdCfg<N>::kP;
  using LQ = QLayout<N, PQ>;
  using LC = ChunkLayout<N, P>;
  cudaError_t err = allow_smem(ssd_bwd_dstate_kernel<N, PQ>, LQ::kBytes);
  if (err == cudaSuccess)
    err = allow_smem(ssd_bwd_chunk_kernel<N, P>, LC::kBytes);
  if (err != cudaSuccess) return int(err);
  const int nc = int((s + kLc - 1) / kLc);
  const int nps = (p + P - 1) / P;
  const dim3 qgrid(unsigned(nc * ((p + PQ - 1) / PQ)), unsigned(h),
                   unsigned(b));
  ssd_bwd_dstate_kernel<N, PQ><<<qgrid, kThreadsQ, LQ::kBytes, stream>>>(
      dy, dt, a_log, cm, s, h, p, g, nc, dstates);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  const int64_t pn4 = int64_t(p) * N / 4;
  const dim3 carry(unsigned((pn4 + kCarryThreads - 1) / kCarryThreads),
                   unsigned(h), unsigned(b));
  ssd_bwd_carry_kernel<<<carry, kCarryThreads, 0, stream>>>(
      dfinal, dstates, decay, h, nc, pn4, ds0);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  const dim3 chunks(unsigned(nc * nps), unsigned(h), unsigned(b));
  ssd_bwd_chunk_kernel<N, P><<<chunks, kThreadsC, LC::kBytes, stream>>>(
      x, dt, a_log, bm, cm, dy, states, dstates, scores, s, h, p, g, nc, hsub,
      dx, dbp, dcp, ddtp, ddap);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  ssd_bwd_dt_kernel<<<unsigned(h), kReduceThreads, 0, stream>>>(
      dt, a_log, ddtp, ddap, b, s, h, nps, ddt, da_log);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  const int64_t rows = b * s * g;
  const int n4 = N / 4;
  const dim3 bc(unsigned((rows * n4 + kReduceThreads - 1) / kReduceThreads),
                2);
  ssd_bwd_bc_kernel<<<bc, kReduceThreads, 0, stream>>>(
      dbp, dcp, rows, (h / g) * nps, n4, db, dc);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

int sage_ssd_scan_bwd(const float* x, const float* dt, const float* a_log,
                      const float* bm, const float* cm, const float* states,
                      const float* decay, const float* scores,
                      const float* dy, const float* dfinal, int64_t b,
                      int64_t s, int h, int p, int g, int n, float* dx,
                      float* ddt, float* da_log, float* db, float* dc,
                      float* ds0, float* dstates, float* hsub, float* dbp,
                      float* dcp, float* ddtp, float* ddap, int chunk_rows,
                      int sub_rows, int p_slice, void* stream) {
  // the caller sized the scratch by these: they must be this kernel's
  // own, or its passes would index past the scratch
  if (chunk_rows != kLc || sub_rows != kL ||
      p_slice != (n <= 128 ? BwdCfg<128>::kP : BwdCfg<256>::kP))
    return int(cudaErrorInvalidValue);
  if (b <= 0 || b > 65535 || s <= 0 || h <= 0 || h > 65535 || p <= 0 ||
      g <= 0 || h % g != 0 ||
      (s + kLc - 1) / kLc * ((p + 15) / 16) > int64_t(2147483647))
    return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SAGE_SSD_BWD(NN)                                                     \
  launch_ssd_scan_bwd<NN>(x, dt, a_log, bm, cm, states, decay, scores, dy,  \
                          dfinal, b, s, h, p, g, dx, ddt, da_log, db, dc,    \
                          ds0, dstates, hsub, dbp, dcp, ddtp, ddap, st)
  switch (n) {
    case 16:
      return SAGE_SSD_BWD(16);
    case 32:
      return SAGE_SSD_BWD(32);
    case 64:
      return SAGE_SSD_BWD(64);
    case 128:
      return SAGE_SSD_BWD(128);
    case 256:
      return SAGE_SSD_BWD(256);
    default:
      return int(cudaErrorInvalidValue);
  }
#undef SAGE_SSD_BWD
}

}  // extern "C"
