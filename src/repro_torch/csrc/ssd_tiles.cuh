// The chunked SSD scan's shared pieces: its row counts and the helpers
// that stage, scan and tile 64-row sub-chunks, used by B6's forward
// (ssm_kernels.cu) and its backward (ssd_bwd.cu).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace sage_ssd {

using namespace sage_mma;

constexpr int kL = 64;          // rows per sub-chunk
constexpr int kLc = 256;        // rows per chunk: the states' step

// rows [0, rows) of a (kL x W) tile from rows `ld` floats apart, columns
// [0, cols) (cols % 4 == 0 when `vec`); the rest zero
template <int W, int THREADS>
__device__ __forceinline__ void stage_tile(float* dst, int dst_ld,
                                           const float* src, int64_t ld,
                                           int rows, int cols, bool vec) {
  if (vec) {
    for (int i = threadIdx.x; i < kL * (W / 4); i += THREADS) {
      const int r = i / (W / 4), c = 4 * (i % (W / 4));
      const bool ok = r < rows && c < cols;
      cp16(dst + r * dst_ld + c, ok ? src + r * ld + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < kL * W; i += THREADS) {
      const int r = i / W, c = i % W;
      const bool ok = r < rows && c < cols;
      cp4(dst + r * dst_ld + c, ok ? src + r * ld + c : src, ok);
    }
  }
}

// the causal 16 x 8 tiles of a 64 x 64 sub-chunk's scores: 16 x 16 tile
// q = r (r + 1) / 2 + cc (cc <= r), half u
constexpr int kScoreTiles = 20;
__device__ __forceinline__ void score_tile(int q2, int& i0, int& j0) {
  const int q = q2 / 2, u = q2 % 2;
  const int r = q < 1 ? 0 : q < 3 ? 1 : q < 6 ? 2 : 3;
  i0 = 16 * r;
  j0 = 16 * (q - r * (r + 1) / 2) + 8 * u;
}

// inclusive f64 cumsum of dt A over kL rows (warp 0 only, two rows a lane)
__device__ __forceinline__ void cumsum64(const float* dts, float A,
                                         double* css, int lane) {
  const double v0 = double(dts[2 * lane] * A);
  const double v1 = v0 + double(dts[2 * lane + 1] * A);
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

// the warp's (16 x 8 NT) tile of S (rows ld apart) times `scale`, as the
// big part of an Acc
template <int NT>
__device__ __forceinline__ void load_state(Acc<3> (&acc)[NT], const float* ss,
                                           int ld, int g, int t, float scale) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    zero(acc[j]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 v = *reinterpret_cast<const float2*>(
          ss + (g + 8 * h) * ld + 8 * j + 2 * t);
      acc[j].big[2 * h] = __fmul_rn(v.x, scale);
      acc[j].big[2 * h + 1] = __fmul_rn(v.y, scale);
    }
  }
}

}  // namespace sage_ssd
