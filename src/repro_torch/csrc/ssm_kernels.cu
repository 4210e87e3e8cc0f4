// The SSM kernel of the serving path, written for Hopper (sm_90a) and bound
// through a plain C interface (ctypes, no PyTorch headers).  The launcher
// returns the cudaError_t of its launch; sage_error_string
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
//
// What bounds it on the card: operations.  At mamba2-130m's serving shape
// (b 4, s 16000, h 24, p 64, n 128, g 1) the function needs ~5.1e10 f32
// FLOP at its least (the chunked form at chunk 1), ~6.95e10 in 64-row
// chunks and ~1.26e11 at the reference's chunk 256, against ~0.86 GB of
// traffic.  The TPU kernel ran a grid of (batch, head, chunk) with the
// chunk axis sequential and a 256-row chunk's working set (~600 KB at
// chunk 256) in VMEM.  Here:
//   - a block owns one (batch, head, 16-column slice of p) and loops over
//     the sequence itself, the state slice (16 x n) carried in registers
//     and shared memory: 4 x 24 x 4 = 384 blocks at the serving shape
//     instead of 96 sequential chains.  The p columns are independent, so
//     each block recomputes its chunk's C B^T scores (accepted);
//   - the chunk is walked in 64-row sub-chunks, so the B, C, x, scores
//     and state tiles fit in ~101 KB of dynamic shared memory at n 128
//     (two blocks a multiprocessor).  The chunked form is exact for any
//     chunk length: only rounding differs from chunk 256;
//   - per sub-chunk: (1) stage B, C, x, dt (rows past s are zeros, dt 0,
//     so nothing is padded); (2) warp 0 scans dt A in f64, two rows a
//     lane and a shuffle scan: each decay is exp of a difference of two
//     cumsums that reach ~800 at A = -16, and an f32 tree scan leaves an
//     ulp of 800 (6e-5) in differences that matter, so they are taken in
//     f64 and rounded once; (3) warp w owns rows 8w..8w+7 and computes
//     the causal scores G only for the 16-column tiles those rows can
//     see, 4 rows x up to 4 columns a lane, float4 loads along n (rows
//     padded by 4 floats against bank conflicts), and the decay-weighted
//     x of the state update; (4) y = G x + exp(cs) C S^T, 4 rows x 1
//     column a lane; (5) the state update, one float4 of S a thread per
//     256 of them.
// CUDA cores, not tensor cores: products are explicit fmaf (the library
// builds with --fmad=false for B4 and B7), exp is expf.  wgmma/TMA and
// TF32 are for a later redesign.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kL = 64;          // rows per sub-chunk
constexpr int kPs = 16;         // p columns per block
constexpr int kThreads = 256;   // 8 warps; warp w owns rows 8w..8w+7
constexpr int kRowsPerWarp = kL / (kThreads / 32);

template <int N>
struct SsdLayout {
  static constexpr int kNs = N + 4;   // padded row stride of B, C, S
  static constexpr int kGs = kL + 1;  // row stride of the scores
  static constexpr int kB = 0;
  static constexpr int kC = kB + kL * kNs;
  static constexpr int kS = kC + kL * kNs;
  static constexpr int kX = kS + kPs * kNs;
  static constexpr int kXw = kX + kL * kPs;
  static constexpr int kG = kXw + kL * kPs;
  static constexpr int kCs = kG + kL * kGs;   // f64: an even offset
  static constexpr int kDt = kCs + 2 * kL;
  static constexpr size_t kBytes = sizeof(float) * (kDt + kL);
};

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = __fmaf_rn(a.x, b.x, acc);
  acc = __fmaf_rn(a.y, b.y, acc);
  acc = __fmaf_rn(a.z, b.z, acc);
  return __fmaf_rn(a.w, b.w, acc);
}

template <int N>
__global__ void __launch_bounds__(kThreads, 2)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a_log, const float* __restrict__ bm,
                const float* __restrict__ cm, const float* __restrict__ s0,
                int64_t s, int h, int p, int g, float* __restrict__ y,
                float* __restrict__ s_out) {
  using Ly = SsdLayout<N>;
  constexpr int kN4 = N / 4;                                  // float4 a row
  constexpr int kSReg = (kPs * kN4 + kThreads - 1) / kThreads;  // S float4s a thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* bs = smem + Ly::kB;
  float* cs_tile = smem + Ly::kC;
  float* ss = smem + Ly::kS;
  float* xs = smem + Ly::kX;
  float* xws = smem + Ly::kXw;
  float* gs = smem + Ly::kG;
  double* css = reinterpret_cast<double*>(smem + Ly::kCs);
  float* dts = smem + Ly::kDt;

  const int p0 = blockIdx.x * kPs;
  const int head = blockIdx.y;
  const int64_t bi = blockIdx.z;
  const int grp = head / (h / g);
  const float A = -expf(a_log[head]);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tx = lane % 16;                              // y: column p0 + tx
  const int row0 = warp * kRowsPerWarp + 4 * (lane / 16);  // rows row0..row0+3
  const int64_t xrow = int64_t(h) * p;                   // x, y step stride
  const int64_t bcrow = int64_t(g) * N;                  // B, C step stride
  const float* xb = x + bi * s * xrow + int64_t(head) * p + p0;
  float* yb = y + bi * s * xrow + int64_t(head) * p + p0;
  const float* dtb = dt + bi * s * h + head;
  const float* bb = bm + bi * s * bcrow + int64_t(grp) * N;
  const float* cb = cm + bi * s * bcrow + int64_t(grp) * N;
  const int64_t state_off = (bi * h + head) * int64_t(p) * N;

  // the state slice: float4 q = tid + kThreads*k of the (kPs, N/4) tile
  float4 sreg[kSReg];
#pragma unroll
  for (int k = 0; k < kSReg; ++k) {
    const int q = tid + kThreads * k;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q < kPs * kN4) {
      const int pp = q / kN4, n4 = q % kN4;
      if (s0 != nullptr && p0 + pp < p)
        v = reinterpret_cast<const float4*>(s0 + state_off +
                                            int64_t(p0 + pp) * N)[n4];
      *reinterpret_cast<float4*>(ss + pp * Ly::kNs + 4 * n4) = v;
    }
    sreg[k] = v;
  }

  for (int64_t t0 = 0; t0 < s; t0 += kL) {
    const int rows = int(s - t0 < kL ? s - t0 : kL);
    __syncthreads();   // the last sub-chunk's readers are done

    // (1) stage the sub-chunk; rows past s are zeros (dt 0: the identity)
    for (int i = tid; i < kL * kN4; i += kThreads) {
      const int r = i / kN4, c = i % kN4;
      float4 bv = make_float4(0.f, 0.f, 0.f, 0.f), cv = bv;
      if (r < rows) {
        bv = reinterpret_cast<const float4*>(bb + (t0 + r) * bcrow)[c];
        cv = reinterpret_cast<const float4*>(cb + (t0 + r) * bcrow)[c];
      }
      *reinterpret_cast<float4*>(bs + r * Ly::kNs + 4 * c) = bv;
      *reinterpret_cast<float4*>(cs_tile + r * Ly::kNs + 4 * c) = cv;
    }
    for (int i = tid; i < kL * kPs; i += kThreads) {
      const int r = i / kPs, c = i % kPs;
      xs[i] = (r < rows && p0 + c < p) ? xb[(t0 + r) * xrow + c] : 0.f;
    }
    if (tid < kL) dts[tid] = tid < rows ? dtb[(t0 + tid) * h] : 0.f;
    __syncthreads();

    // (2) inclusive cumsum of dt A in f64: two rows a lane, then a warp scan
    if (warp == 0) {
      const double v0 = double(dts[2 * lane] * A);
      const double v1 = v0 + double(dts[2 * lane + 1] * A);
      double incl = v1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double t = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += t;
      }
      double excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.0;
      css[2 * lane] = excl + v0;
      css[2 * lane + 1] = excl + v1;
    }
    __syncthreads();
    const double cs_last = css[kL - 1];

    // (3) causal scores G[i][j] = (C_i . B_j) exp(cs_i - cs_j) dt_j, j <= i,
    //     for the 16-column tiles warp w's rows can see
    const int nb = warp / 2 + 1;
    if (warp * kRowsPerWarp < rows) {
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
#pragma unroll 2
      for (int n = 0; n < N; n += 4) {
        float4 cv[4], bv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
          cv[a] = *reinterpret_cast<const float4*>(cs_tile + (row0 + a) * Ly::kNs + n);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (c < nb)
            bv[c] = *reinterpret_cast<const float4*>(bs + (tx + 16 * c) * Ly::kNs + n);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (c < nb) acc[a][c] = dot4(cv[a], bv[c], acc[a][c]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = row0 + a;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = tx + 16 * c;
          if (c < nb)
            gs[i * Ly::kGs + j] =
                j <= i ? acc[a][c] * expf(float(css[i] - css[j])) * dts[j] : 0.f;
        }
      }
    }
    // the decay-weighted x of the state update: x_l exp(cs_last - cs_l) dt_l
    for (int i = tid; i < kL * kPs; i += kThreads) {
      const int r = i / kPs;
      xws[i] = xs[i] * (expf(float(cs_last - css[r])) * dts[r]);
    }
    __syncthreads();

    // (4) y = G x + exp(cs) C S^T: rows row0..row0+3, column p0 + tx
    if (warp * kRowsPerWarp < rows) {
      float yd[4] = {0.f, 0.f, 0.f, 0.f}, yo[4] = {0.f, 0.f, 0.f, 0.f};
      const int jmax = min(warp * kRowsPerWarp + kRowsPerWarp, rows);
      for (int j = 0; j < jmax; ++j) {
        const float xv = xs[j * kPs + tx];
#pragma unroll
        for (int a = 0; a < 4; ++a)
          yd[a] = __fmaf_rn(gs[(row0 + a) * Ly::kGs + j], xv, yd[a]);
      }
#pragma unroll 4
      for (int n = 0; n < N; n += 4) {
        const float4 sv = *reinterpret_cast<const float4*>(ss + tx * Ly::kNs + n);
#pragma unroll
        for (int a = 0; a < 4; ++a)
          yo[a] = dot4(*reinterpret_cast<const float4*>(cs_tile + (row0 + a) * Ly::kNs + n),
                       sv, yo[a]);
      }
      if (p0 + tx < p) {
#pragma unroll
        for (int a = 0; a < 4; ++a)
          if (row0 + a < rows)
            yb[(t0 + row0 + a) * xrow + tx] = yd[a] + yo[a] * expf(float(css[row0 + a]));
      }
    }
    __syncthreads();   // every reader of the old state is done

    // (5) S = S exp(cs_last) + sum_l xw_l B_l
    const float decay = expf(float(cs_last));
#pragma unroll
    for (int k = 0; k < kSReg; ++k) {
      const int q = tid + kThreads * k;
      if (q < kPs * kN4) {
        const int pp = q / kN4, n4 = q % kN4;
        float4 u = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int l = 0; l < rows; ++l) {
          const float w = xws[l * kPs + pp];
          const float4 bv = *reinterpret_cast<const float4*>(bs + l * Ly::kNs + 4 * n4);
          u.x = __fmaf_rn(w, bv.x, u.x);
          u.y = __fmaf_rn(w, bv.y, u.y);
          u.z = __fmaf_rn(w, bv.z, u.z);
          u.w = __fmaf_rn(w, bv.w, u.w);
        }
        float4 v = sreg[k];
        v.x = v.x * decay + u.x;
        v.y = v.y * decay + u.y;
        v.z = v.z * decay + u.z;
        v.w = v.w * decay + u.w;
        sreg[k] = v;
        *reinterpret_cast<float4*>(ss + pp * Ly::kNs + 4 * n4) = v;
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kSReg; ++k) {
    const int q = tid + kThreads * k;
    if (q < kPs * kN4) {
      const int pp = q / kN4, n4 = q % kN4;
      if (p0 + pp < p)
        reinterpret_cast<float4*>(s_out + state_off + int64_t(p0 + pp) * N)[n4] =
            sreg[k];
    }
  }
}

template <int N>
int launch_ssd_scan(const float* x, const float* dt, const float* a_log,
                    const float* bm, const float* cm, const float* s0,
                    int64_t b, int64_t s, int h, int p, int g, float* y,
                    float* s_out, cudaStream_t stream) {
  const size_t smem = SsdLayout<N>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(unsigned((p + kPs - 1) / kPs), unsigned(h), unsigned(b));
  ssd_scan_kernel<N><<<grid, kThreads, smem, stream>>>(
      x, dt, a_log, bm, cm, s0, s, h, p, g, y, s_out);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

int sage_ssd_scan(const float* x, const float* dt, const float* a_log,
                  const float* bm, const float* cm, const float* s0,
                  int64_t b, int64_t s, int h, int p, int g, int n, float* y,
                  float* s_out, void* stream) {
  if (b <= 0 || b > 65535 || s <= 0 || h <= 0 || h > 65535 || p <= 0 ||
      g <= 0 || h % g != 0)
    return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 16:
      return launch_ssd_scan<16>(x, dt, a_log, bm, cm, s0, b, s, h, p, g, y, s_out, st);
    case 32:
      return launch_ssd_scan<32>(x, dt, a_log, bm, cm, s0, b, s, h, p, g, y, s_out, st);
    case 64:
      return launch_ssd_scan<64>(x, dt, a_log, bm, cm, s0, b, s, h, p, g, y, s_out, st);
    case 128:
      return launch_ssd_scan<128>(x, dt, a_log, bm, cm, s0, b, s, h, p, g, y, s_out, st);
    case 256:
      return launch_ssd_scan<256>(x, dt, a_log, bm, cm, s0, b, s, h, p, g, y, s_out, st);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // extern "C"
