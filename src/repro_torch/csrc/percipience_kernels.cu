// Heat-scan kernel of the percipience loop, written for Hopper (sm_90a)
// and bound through a plain C interface (ctypes, no PyTorch headers).
// The launcher returns the cudaError_t of its launch; sage_error_string
// (analytics_kernels.cu, the same library) names it.
//
//   sage_heat_scan  <- _heat_kernel  (repro/percipience/heat.py)
//
// It computes, for every tracked object j, the first-order linear
// recurrence h = a[t] * h + x[t] over its access history, oldest step
// first, from h = 0: the object's exponentially decayed heat at its
// last access.  a (decay factors in [0, 1]) and x (access weights) are
// (hist, nobj) float32, row-major, so step t of object j sits at
// t * nobj + j.
//
// What bounds it on the card: bytes.  Each element of a and x is read
// once and takes one multiply and one add, far below the H100's ~20
// operations per byte of HBM bandwidth.  The TPU kernel ran a grid over
// 128-object blocks with a fori_loop over the history, the running heat
// vector in VMEM.  Here one thread owns one object and keeps h in a
// register; the loop over t replaces the sequential grid dimension.  On
// the (hist, nobj) layout the 32 threads of a warp read 32 consecutive
// floats of a row, so every load is coalesced, and the loads of later
// steps do not depend on h, so the unrolled loop keeps several in
// flight.  Built with --fmad=false: a * h rounds before + x, as the
// plain PyTorch version's separate multiply and add do, so the two
// agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void heat_scan_kernel(const float* __restrict__ a,
                                 const float* __restrict__ x, int64_t hist,
                                 int64_t nobj, float* __restrict__ out) {
  const int64_t j = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= nobj) return;
  float h = 0.0f;
#pragma unroll 8
  for (int64_t t = 0; t < hist; ++t) {
    h = a[t * nobj + j] * h + x[t * nobj + j];
  }
  out[j] = h;
}

}  // namespace

extern "C" {

int sage_heat_scan(const float* a, const float* x, int64_t hist,
                   int64_t nobj, float* out, void* stream) {
  if (hist < 0 || nobj <= 0) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (nobj + kThreads - 1) / kThreads;
  heat_scan_kernel<<<unsigned(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(a, x, hist, nobj,
                                                          out);
  return (int)cudaGetLastError();
}

}  // extern "C"
