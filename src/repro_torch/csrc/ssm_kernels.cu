// The SSM kernel of the serving path, written for Hopper (sm_90a) and bound
// through a plain C interface (ctypes, no PyTorch headers).  The launcher
// returns the cudaError_t of its launches; sage_error_string
// (analytics_kernels.cu, the same library) names it.
//
//   sage_ssd_scan  <- _ssd_kernel  (repro/kernels/ssd_scan.py)
//
// ---------------------------------------------------------------------------
// sage_ssd_scan
//
// The Mamba2 SSD scan with state in and out.  For each (batch, head), with
// A = -exp(a_log[head]) and head h reading B/C group h / (H / G):
//   S_t = exp(dt_t A) S_{t-1} + dt_t x_t B_t^T ,  y_t = S_t C_t
// from S_{-1} = s0 (or 0), computed in chunked form as the TPU kernel does
// (ssd_scan.py:40-76): per chunk, with cs the in-chunk cumsum of dt A,
//   y_diag = (C B^T * exp(cs_i - cs_j) [j <= i] * dt_j) x ,
//   y_off  = exp(cs) * C S^T ,
//   S      = S exp(cs_last) + (x exp(cs_last - cs) dt)^T B .
// x, y: (b, s, h, p); dt: (b, s, h); a_log: (h,); B, C: (b, s, g, n);
// s0, s_out: (b, h, p, n); all f32 and contiguous, s0 may be null.
// Scratch from the caller (f32): scores (b, g, ceil(s / 64), 64, 64),
// states (b, h, nc, p, n) and decay (b, h, nc), nc = ceil(s / 256); the
// caller passes the 256 and 64 it sized them by (chunk_rows, sub_rows),
// and any other pair is refused with cudaErrorInvalidValue.
//
// What bounds it on the card: bytes.  At mamba2-130m's serving shape
// (b 4, s 16000, h 24, p 64, n 128, g 1) the function moves ~0.86 GB
// (0.258 ms at 3.35 TB/s) and needs ~5.1e10 FLOP at its least (the
// chunked form at chunk 1), 0.103 ms at the tensor cores' TF32 rate for
// f32 operands.  The three TF32 products this kernel takes for each one
// (the split below) are its own cost, not the function's.
// The TPU kernel ran a grid of (batch, head, chunk) with the chunk axis
// sequential.  Here the chunks run in parallel, in four launches:
//   0. ssd_scores_kernel, a block per (batch, group, 64-row sub-chunk):
//      the causal 16 x 8 tiles of the sub-chunk's C B^T into `scores`.
//      They depend on the group only, so the 24 heads of mamba2's one
//      group share them instead of each recomputing them;
//   1. ssd_state_kernel, a block per (batch, head, 256-row chunk, p
//      slice): the chunk's own end state sum_l exp(cs_last - cs_l) dt_l
//      x_l B_l^T (a p x n product over its rows) into `states`, and its
//      decay exp(cs_last) into `decay`;
//   2. ssd_carry_kernel, a thread per (batch, head, 4 entries of p x n):
//      walks the chunks in turn from s0, replaces each chunk's entry with
//      the state entering it, and writes s_out;
//   3. ssd_out_kernel, a block per (batch, head, chunk, p slice): from the
//      chunk's entering state it walks the chunk's 64-row sub-chunks,
//      weighting the shared scores by exp(cs_i - cs_j) dt_j into G, then
//      y = exp(cs) (C S^T) + G x for the whole p slice (64 columns: all
//      of mamba2's p; 32 at n 256, for shared memory), and carries S to
//      the next sub-chunk.
// 4 x 24 x 63 = 6,048 blocks at the serving shape, not 96 chains.
//
// Tensor cores: every product (C B^T, C S^T, G x and (x w)^T B) runs as
// mma.sync.aligned.m16n8k8 TF32 with fragments loaded from shared memory
// by each lane (the helpers are in tf32_mma.cuh, shared with B5).
// mma.sync, not wgmma: each operand is split in registers as it is loaded
// (below), which wgmma, reading its shared-memory operands itself (and
// K-major only for tf32), cannot do without hi and lo copies of every
// tile, and the tiles that contract over rows (x for G x, B and x w for
// the state) would have to be staged transposed.  Split TF32 (3xTF32): a
// = hi + lo with hi = a rounded to tf32 as cvt.rna.tf32 rounds it and lo =
// a - hi (truncated by the tensor cores); a b ~ lo_a hi_b + hi_a lo_b +
// hi_a hi_b with f32 accumulators, kept as independent chains, about
// f32's accuracy where plain TF32 keeps ~3 digits (the CPU emulation of
// tests/test_torch_ssd_split.py holds it to the sequential oracle).  The
// cumsums of dt A are f64 (at A = -16 an f32 scan left 6.1e-5 of error in
// exp of their differences), each decay rounded once; exp is expf.
//
// Shared memory (floats).  The contraction index is permuted within each
// 8-step so that a lane's two k values are adjacent: an operand stored
// along k loads as one float2, conflict-free at a row stride of 8 mod 32;
// one read down its columns loads two floats, conflict-free at 4 mod 32.
// B is read both ways (C B^T in pass 0, the state update in pass 3) and
// takes 4 mod 32 in pass 3, where it is only read down its columns.
//   OutLayout<N, P, STAGES> (pass 3, 16 warps), per stage: B (64 x (N +
//     4)), C (64 x (N + 8)), x (64 x (P + 4)), dt (64); then S (P x (N +
//     8)), G (64 x 72), the rows' exp(cs) and x weights (2 x 64), the f64
//     cumsum (64).  At n 128, p slice 64: 226,816 B with two stages
//     (cp.async stages the next sub-chunk while this one computes), one
//     block a multiprocessor; at n 256, p slice 32, one stage: 196,864 B.
//   StateLayout<N, P> (pass 1, 8 warps), per stage (two): B (64 x (N +
//     4)) and x (64 x (P + 4)); then the chunk's 256 x weights and 8 f64
//     warp sums.  At n 128: 103,488 B, two blocks a multiprocessor.
//   Pass 0: B and C (64 x (N + 8)), 69,632 B at n 128.
// The warps of pass 3 split the work: the 20 score tiles (warps 0-3 take
// two); y as (16-row tile, quarter of the p slice); the state as (16-row
// p tile, N / 4 columns at p slice 64).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ssd_tiles.cuh"
#include "tf32_mma.cuh"

namespace {

using namespace sage_mma;   // cp.async, split-TF32 fragments and products
using namespace sage_ssd;   // kL, kLc and the tile helpers

constexpr int kThreads0 = 256;  // pass 0: 8 warps
constexpr int kThreads1 = 256;  // pass 1: 8 warps, two blocks an SM
constexpr int kThreads3 = 512;  // pass 3: 16 warps, one block an SM
constexpr int kCarryThreads = 256;
constexpr int kGs = kL + 8;     // row stride of G
static_assert(kThreads1 == kLc, "pass 1 scans a row of the chunk a thread");

template <int N>
struct Cfg {
  static constexpr int kP = N <= 128 ? 64 : 32;       // p slice
  static constexpr int kStages = N <= 128 ? 2 : 1;    // pass 3 stages
};

template <int N, int P, int STAGES>
struct OutLayout {
  static constexpr int kBs = N + 4;   // B rows (read down the columns too)
  static constexpr int kCs_ = N + 8;  // C rows
  static constexpr int kSs = N + 8;   // S rows
  static constexpr int kXs = P + 4;   // x rows
  static constexpr int kB = 0;        // within a stage
  static constexpr int kC = kB + kL * kBs;
  static constexpr int kX = kC + kL * kCs_;
  static constexpr int kDt = kX + kL * kXs;
  static constexpr int kStage = kDt + kL;
  static constexpr int kS = STAGES * kStage;
  static constexpr int kG = kS + P * kSs;
  static constexpr int kE = kG + kL * kGs;   // exp(cs_i)
  static constexpr int kW = kE + kL;         // exp(cs_last - cs_l) dt_l
  static constexpr int kCs = kW + kL;        // f64: a 16-byte offset
  static constexpr size_t kBytes = sizeof(float) * kCs + sizeof(double) * kL;
};

template <int N, int P>
struct StateLayout {
  static constexpr int kStages = 2;
  static constexpr int kNs = N + 4;   // B rows
  static constexpr int kXs = P + 4;   // x rows
  static constexpr int kB = 0;
  static constexpr int kX = kB + kL * kNs;
  static constexpr int kStage = kX + kL * kXs;
  static constexpr int kW = kStages * kStage;   // the chunk's x weights
  static constexpr int kSum = kW + kLc;         // f64 sums of the warps
  static constexpr size_t kBytes =
      sizeof(float) * kSum + sizeof(double) * (kThreads1 / 32);
};

// ---------------------------------------------------------------------------
// pass 0: the causal C B^T tiles of every 64-row sub-chunk, once for each
// group (every head of the group reads them: 24 heads at mamba2's g 1)
// ---------------------------------------------------------------------------

template <int N>
__global__ void __launch_bounds__(kThreads0)
ssd_scores_kernel(const float* __restrict__ bm, const float* __restrict__ cm,
                  int64_t s, int g, float* __restrict__ scores) {
  constexpr int kNs = N + 8;
  constexpr int kWarps = kThreads0 / 32;
  extern __shared__ float4 smem4[];
  float* bs = reinterpret_cast<float*>(smem4);
  float* cs_tile = bs + kL * kNs;
  const int64_t sub = blockIdx.x, bi = blockIdx.z;
  const int grp = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int64_t t0 = sub * kL;
  const int rows = int(s - t0 < kL ? s - t0 : kL);
  const int64_t bcrow = int64_t(g) * N;
  const int64_t off = (bi * s + t0) * bcrow + int64_t(grp) * N;
  stage_tile<N, kThreads0>(bs, kNs, bm + off, bcrow, rows, N, true);
  stage_tile<N, kThreads0>(cs_tile, kNs, cm + off, bcrow, rows, N, true);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  float* out = scores + ((bi * g + grp) * gridDim.x + sub) * (kL * kL);
  for (int q2 = warp; q2 < kScoreTiles; q2 += kWarps) {
    int i0, j0;
    score_tile(q2, i0, j0);
    if (i0 >= rows) continue;
    Acc<3> acc;
    zero(acc);
#pragma unroll 4
    for (int k0 = 0; k0 < N; k0 += 8)
      mma3(acc, frag_a_rows(cs_tile + i0 * kNs + k0, kNs, gq, tq),
           frag_b_rows(bs + j0 * kNs + k0, kNs, gq, tq));
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<float2*>(out + (i0 + gq + 8 * hh) * kL + j0 +
                                 2 * tq) =
          make_float2(total(acc, 2 * hh), total(acc, 2 * hh + 1));
  }
}

// ---------------------------------------------------------------------------
// pass 1: each chunk's own end state and decay
// ---------------------------------------------------------------------------

template <int N, int P>
__global__ void __launch_bounds__(kThreads1, 2)
ssd_state_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ a_log, const float* __restrict__ bm,
                 int64_t s, int h, int p, int g, int nc,
                 float* __restrict__ states, float* __restrict__ decay) {
  using Ly = StateLayout<N, P>;
  constexpr int kWarps = kThreads1 / 32;
  constexpr int R = P / 16;              // 16-row p tiles
  constexpr int NW = N * R / kWarps;     // state columns a warp
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
  const int64_t xrow = int64_t(h) * p, bcrow = int64_t(g) * N;
  const float* xb = x + (bi * s + r0) * xrow + int64_t(head) * p + p0;
  const float* bb = bm + (bi * s + r0) * bcrow + int64_t(grp) * N;
  const bool xvec = p % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const int nsub = (rows_c + kL - 1) / kL;

  auto stage = [&](int k) {
    float* base = smem + (k & 1) * Ly::kStage;
    const int rows = min(kL, rows_c - k * kL);
    stage_tile<N, kThreads1>(base + Ly::kB, Ly::kNs, bb + k * kL * bcrow,
                             bcrow, rows, N, true);
    stage_tile<P, kThreads1>(base + Ly::kX, Ly::kXs, xb + k * kL * xrow,
                             xrow, rows, np_, xvec);
  };
  stage(0);
  cp_commit();

  // the chunk's f64 cumsum of dt A (a row a thread), then its x weights
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
  wls[tid] = expf(float(sum - v)) * dtv;
  if (tid == 0 && p0 == 0)
    decay[(bi * h + head) * nc + c] = expf(float(sum));

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
    const float* bs = base + Ly::kB;
    const float* xs = base + Ly::kX;
    const int rows = min(kL, rows_c - k * kL);
    for (int k0 = 0; k0 < rows; k0 += 8) {
      const FragA a = frag_a_cols(xs + k0 * Ly::kXs + pp0, Ly::kXs,
                                  wls + k * kL + k0, gq, tq);
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mma3(acc[j], a, frag_b_cols(bs + k0 * Ly::kNs + n0 + 8 * j, Ly::kNs,
                                    gq, tq));
    }
    __syncthreads();   // the stage is read before it is refilled
  }

  float* out = states + (((bi * h + head) * nc + c) * p + p0) * N;
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
// pass 2: the states entering each chunk, and the final state
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kCarryThreads)
ssd_carry_kernel(const float* __restrict__ s0, float* __restrict__ states,
                 const float* __restrict__ decay, int h, int nc, int64_t pn4,
                 float* __restrict__ s_out) {
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

template <int N, int P, int STAGES>
__global__ void __launch_bounds__(kThreads3, 1)
ssd_out_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a_log, const float* __restrict__ bm,
               const float* __restrict__ cm, const float* __restrict__ states,
               const float* __restrict__ scores, int64_t s, int h, int p,
               int g, int nc, float* __restrict__ y) {
  using Ly = OutLayout<N, P, STAGES>;
  constexpr int kWarps = kThreads3 / 32;
  constexpr int R = P / 16;                       // S: 16-row p tiles
  constexpr int NS = kWarps / R < N / 8 ? kWarps / R : N / 8;  // x columns
  constexpr int NW = N / NS;
  constexpr int NT = NW / 8;
  constexpr int YC = P / 4;                       // y: columns a warp
  constexpr int YT = YC / 8;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* ss = smem + Ly::kS;
  float* gs = smem + Ly::kG;
  float* es = smem + Ly::kE;
  float* wls = smem + Ly::kW;
  double* css = reinterpret_cast<double*>(smem + Ly::kCs);

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
  const int64_t xrow = int64_t(h) * p, bcrow = int64_t(g) * N;
  const float* xb = x + (bi * s + r0) * xrow + int64_t(head) * p + p0;
  float* yb = y + (bi * s + r0) * xrow + int64_t(head) * p + p0;
  const float* dtb = dt + (bi * s + r0) * h + head;
  const float* bb = bm + (bi * s + r0) * bcrow + int64_t(grp) * N;
  const float* cb = cm + (bi * s + r0) * bcrow + int64_t(grp) * N;
  const float* s_in = states + (((bi * h + head) * nc + c) * p + p0) * N;
  const bool xvec = p % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const int nsub = (rows_c + kL - 1) / kL;
  const int64_t nsub_all = (s + kL - 1) / kL;

  auto stage = [&](int k) {
    float* base = smem + (STAGES == 2 ? (k & 1) : 0) * Ly::kStage;
    const int rows = min(kL, rows_c - k * kL);
    stage_tile<N, kThreads3>(base + Ly::kB, Ly::kBs, bb + k * kL * bcrow,
                             bcrow, rows, N, true);
    stage_tile<N, kThreads3>(base + Ly::kC, Ly::kCs_, cb + k * kL * bcrow,
                             bcrow, rows, N, true);
    stage_tile<P, kThreads3>(base + Ly::kX, Ly::kXs, xb + k * kL * xrow,
                             xrow, rows, np_, xvec);
    if (tid < kL) {
      const bool ok = tid < rows;
      cp4(base + Ly::kDt + tid, ok ? dtb + (k * kL + tid) * int64_t(h) : dtb,
          ok);
    }
  };
  // the entering state (P x N; rows past the slice zero) with stage 0
  for (int i = tid; i < P * (N / 4); i += kThreads3) {
    const int pp = i / (N / 4), c4 = 4 * (i % (N / 4));
    cp16(ss + pp * Ly::kSs + c4, pp < np_ ? s_in + pp * N + c4 : s_in,
         pp < np_);
  }
  if (STAGES == 2) {
    stage(0);
    cp_commit();
  }

  for (int k = 0; k < nsub; ++k) {
    if (STAGES == 2) {
      if (k + 1 < nsub) stage(k + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      stage(k);
      cp_commit();
      cp_wait<0>();
    }
    __syncthreads();
    const float* base = smem + (STAGES == 2 ? (k & 1) : 0) * Ly::kStage;
    const float* bs = base + Ly::kB;
    const float* cs_tile = base + Ly::kC;
    const float* xs = base + Ly::kX;
    const float* dts = base + Ly::kDt;
    const int rows = min(kL, rows_c - k * kL);

    // this warp's score tiles q2 = warp + 16 u (pass 0), loaded while
    // warp 0 scans
    constexpr int kGT = (kScoreTiles + kWarps - 1) / kWarps;
    int i0g[kGT], j0g[kGT];
    float2 sv[kGT][2];
    const float* sc = scores + ((bi * g + grp) * nsub_all + c * (kLc / kL) +
                                k) * (kL * kL);
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
    __syncthreads();
    const double cs_last = css[kL - 1];
    if (tid < kL) {
      es[tid] = expf(float(css[tid]));
    } else if (tid < 2 * kL) {
      const int l = tid - kL;
      wls[l] = expf(float(cs_last - css[l])) * dts[l];
    }

    // G = C B^T weighted by exp(cs_i - cs_j) dt_j on the causal tiles
#pragma unroll
    for (int u = 0; u < kGT; ++u) {
      if (warp + kWarps * u >= kScoreTiles || i0g[u] >= rows) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = i0g[u] + gq + 8 * hh;
        const float a[2] = {sv[u][hh].x, sv[u][hh].y};
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = j0g[u] + 2 * tq + e;
          v[e] = j <= i ? a[e] * expf(float(css[i] - css[j])) * dts[j] : 0.f;
        }
        *reinterpret_cast<float2*>(gs + i * kGs + j0g[u] + 2 * tq) =
            make_float2(v[0], v[1]);
      }
    }
    __syncthreads();

    // y = exp(cs) (C S^T) + G x: rows i0..i0+15, a quarter of the slice
    {
      const int i0 = 16 * (warp / 4), c0 = YC * (warp % 4);
      if (i0 < rows && c0 < np_) {
        Acc<3> acc[YT];
#pragma unroll
        for (int j = 0; j < YT; ++j) zero(acc[j]);
#pragma unroll 4
        for (int k0 = 0; k0 < N; k0 += 8) {
          const FragA a = frag_a_rows(cs_tile + i0 * Ly::kCs_ + k0, Ly::kCs_,
                                      gq, tq);
#pragma unroll
          for (int j = 0; j < YT; ++j)
            mma3(acc[j], a, frag_b_rows(ss + (c0 + 8 * j) * Ly::kSs + k0,
                                        Ly::kSs, gq, tq));
        }
        const float e0 = es[i0 + gq], e1 = es[i0 + gq + 8];
#pragma unroll
        for (int j = 0; j < YT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[j].big[e] = __fmul_rn(total(acc[j], e), e < 2 ? e0 : e1);
            acc[j].lh[e] = acc[j].hl[e] = 0.f;
          }
        for (int k0 = 0; k0 < i0 + 16; k0 += 8) {
          const FragA a = frag_a_rows(gs + i0 * kGs + k0, kGs, gq, tq);
#pragma unroll
          for (int j = 0; j < YT; ++j)
            mma3(acc[j], a, frag_b_cols(xs + k0 * Ly::kXs + c0 + 8 * j,
                                        Ly::kXs, gq, tq));
        }
        float* yrow = yb + int64_t(k) * kL * xrow;
#pragma unroll
        for (int j = 0; j < YT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = i0 + gq + 8 * (e >> 1);
            const int col = c0 + 8 * j + 2 * tq + (e & 1);
            if (i < rows && col < np_) yrow[i * xrow + col] = total(acc[j], e);
          }
      }
    }

    // S = S exp(cs_last) + (x w)^T B, for the chunk's next sub-chunk
    if (k + 1 < nsub) {
      __syncthreads();   // every reader of the old S is done
      if (warp < R * NS) {
        const int pp0 = 16 * (warp % R), n0 = NW * (warp / R);
        float* st = ss + pp0 * Ly::kSs + n0;
        Acc<3> acc[NT];
        load_state(acc, st, Ly::kSs, gq, tq, expf(float(cs_last)));
        for (int k0 = 0; k0 < kL; k0 += 8) {
          const FragA a = frag_a_cols(xs + k0 * Ly::kXs + pp0, Ly::kXs,
                                      wls + k0, gq, tq);
#pragma unroll
          for (int j = 0; j < NT; ++j)
            mma3(acc[j], a, frag_b_cols(bs + k0 * Ly::kBs + n0 + 8 * j,
                                        Ly::kBs, gq, tq));
        }
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            *reinterpret_cast<float2*>(st + (gq + 8 * hh) * Ly::kSs + 8 * j +
                                       2 * tq) =
                make_float2(total(acc[j], 2 * hh), total(acc[j], 2 * hh + 1));
      }
    }
    __syncthreads();   // the stage, G and S are read before they change
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(bytes));
}

template <int N>
int launch_ssd_scan(const float* x, const float* dt, const float* a_log,
                    const float* bm, const float* cm, const float* s0,
                    int64_t b, int64_t s, int h, int p, int g, float* y,
                    float* s_out, float* states, float* decay,
                    float* scores, cudaStream_t stream) {
  constexpr int P = Cfg<N>::kP, STAGES = Cfg<N>::kStages;
  using LS = StateLayout<N, P>;
  using LO = OutLayout<N, P, STAGES>;
  const size_t score_bytes = sizeof(float) * 2 * kL * (N + 8);
  cudaError_t err = allow_smem(ssd_scores_kernel<N>, score_bytes);
  if (err == cudaSuccess)
    err = allow_smem(ssd_state_kernel<N, P>, LS::kBytes);
  if (err == cudaSuccess)
    err = allow_smem(ssd_out_kernel<N, P, STAGES>, LO::kBytes);
  if (err != cudaSuccess) return int(err);
  const int nc = int((s + kLc - 1) / kLc);
  const int nps = (p + P - 1) / P;
  const dim3 subs(unsigned((s + kL - 1) / kL), unsigned(g), unsigned(b));
  ssd_scores_kernel<N><<<subs, kThreads0, score_bytes, stream>>>(bm, cm, s, g,
                                                                scores);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  const dim3 chunks(unsigned(nc * nps), unsigned(h), unsigned(b));
  ssd_state_kernel<N, P><<<chunks, kThreads1, LS::kBytes, stream>>>(
      x, dt, a_log, bm, s, h, p, g, nc, states, decay);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  const int64_t pn4 = int64_t(p) * N / 4;
  const dim3 carry(unsigned((pn4 + kCarryThreads - 1) / kCarryThreads),
                   unsigned(h), unsigned(b));
  ssd_carry_kernel<<<carry, kCarryThreads, 0, stream>>>(s0, states, decay, h,
                                                       nc, pn4, s_out);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  ssd_out_kernel<N, P, STAGES><<<chunks, kThreads3, LO::kBytes, stream>>>(
      x, dt, a_log, bm, cm, states, scores, s, h, p, g, nc, y);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

int sage_ssd_scan(const float* x, const float* dt, const float* a_log,
                  const float* bm, const float* cm, const float* s0,
                  int64_t b, int64_t s, int h, int p, int g, int n, float* y,
                  float* s_out, float* states, float* decay, float* scores,
                  int chunk_rows, int sub_rows, void* stream) {
  // the caller sized the scratch by chunk_rows and sub_rows: they must be
  // this kernel's own, or its passes would index past the scratch
  if (chunk_rows != kLc || sub_rows != kL) return int(cudaErrorInvalidValue);
  if (b <= 0 || b > 65535 || s <= 0 || h <= 0 || h > 65535 || p <= 0 ||
      g <= 0 || h % g != 0 || (s + kLc - 1) / kLc * ((p + 63) / 32) >
                                  int64_t(2147483647))
    return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 16:
      return launch_ssd_scan<16>(x, dt, a_log, bm, cm, s0, b, s, h, p, g, y,
                                 s_out, states, decay, scores, st);
    case 32:
      return launch_ssd_scan<32>(x, dt, a_log, bm, cm, s0, b, s, h, p, g, y,
                                 s_out, states, decay, scores, st);
    case 64:
      return launch_ssd_scan<64>(x, dt, a_log, bm, cm, s0, b, s, h, p, g, y,
                                 s_out, states, decay, scores, st);
    case 128:
      return launch_ssd_scan<128>(x, dt, a_log, bm, cm, s0, b, s, h, p, g, y,
                                  s_out, states, decay, scores, st);
    case 256:
      return launch_ssd_scan<256>(x, dt, a_log, bm, cm, s0, b, s, h, p, g, y,
                                  s_out, states, decay, scores, st);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // extern "C"
