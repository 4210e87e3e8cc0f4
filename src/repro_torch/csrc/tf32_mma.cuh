// Split-TF32 tensor-core products and asynchronous copies, shared by the
// kernels that multiply f32 tiles on the tensor cores (B5 in
// model_kernels.cu, B6 in ssm_kernels.cu).
//
// Split TF32 (3xTF32): a = hi + lo (split() below); a b ~ lo_a hi_b +
// hi_a lo_b + hi_a hi_b with f32 accumulators, about f32's accuracy where plain TF32 keeps ~3 digits
// (tests/test_torch_ssd_split.py and tests/test_torch_attn_split.py
// emulate it on the CPU).  mma.sync, not wgmma: each operand is split in
// registers as a lane loads its fragment, which wgmma, reading its
// shared-memory operands itself, cannot do without hi and lo copies of
// every tile.
//
// m16n8k8 fragments (lane = 4 g + t): A holds rows g, g + 8 and B column g;
// the accumulator (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).  The
// contraction index is permuted within each 8-step (A's and B's k = t is
// element 2t, k = t + 4 element 2t + 1; a sum does not care), so a lane's
// two k values are adjacent and a row-major operand loads as one float2:
// conflict-free at a row stride of 8 mod 32 (frag_a_rows, frag_b_rows); one
// read down its columns loads two floats, conflict-free at 4 mod 32
// (frag_a_cols, frag_b_cols).  With it, an accumulator {c0, c1, c2, c3} is,
// reordered as {c0, c2, c1, c3}, the A fragment of the next product's
// 8-step over the accumulator's 8 columns.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sage_mma {

// ---- asynchronous copies (zero-filled where `ok` is false) ----------------

__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int K>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(K) : "memory");
}

// ---- split-TF32 tensor-core products ---------------------------------------

struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};
// the hi hi products and the two small cross terms, in three
// independent chains, or two where registers are short
template <int CHAINS>
struct Acc {
  float big[4], lh[4], hl[4];
};
template <>
struct Acc<2> {
  float big[4], lh[4];
};

// a = hi + lo for finite a: hi = a rounded to tf32, to nearest with ties
// away from zero, as cvt.rna.tf32.f32 rounds it (half a unit of the 13
// dropped bits added to the magnitude, then dropped), in two integer
// instructions (sm_90 has no instruction for cvt.rna.tf32, and ptxas
// expands each into four); lo = a - hi, passed as it is: the tensor cores
// read only the top 19 bits of a tf32 operand, so lo is truncated there
// (|lo| <= 2^-11 |a|, what truncation drops <= 2^-21 |a|)
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__fsub_rn(v, __uint_as_float(hi)));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b to about f32 accuracy
template <int CHAINS>
__device__ __forceinline__ void mma3(Acc<CHAINS>& d, const FragA& a,
                                     const FragB& b) {
  mma_tf32(d.lh, a.lo, b.hi);
  if constexpr (CHAINS == 3) mma_tf32(d.hl, a.hi, b.lo);
  else mma_tf32(d.lh, a.hi, b.lo);
  mma_tf32(d.big, a.hi, b.hi);
}

// d += a b to about f32 accuracy, into one accumulator (the small terms
// first): for accumulators too large to keep three times
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

template <int CHAINS>
__device__ __forceinline__ void zero(Acc<CHAINS>& d) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    d.big[e] = d.lh[e] = 0.f;
    if constexpr (CHAINS == 3) d.hl[e] = 0.f;
  }
}
template <int CHAINS>
__device__ __forceinline__ float total(const Acc<CHAINS>& d, int e) {
  if constexpr (CHAINS == 3)
    return __fadd_rn(d.big[e], __fadd_rn(d.lh[e], d.hl[e]));
  else
    return __fadd_rn(d.big[e], d.lh[e]);
}

__device__ __forceinline__ FragA split_a(float v0, float v1, float v2,
                                         float v3) {
  FragA f;
  split(v0, f.hi[0], f.lo[0]);
  split(v1, f.hi[1], f.lo[1]);
  split(v2, f.hi[2], f.lo[2]);
  split(v3, f.hi[3], f.lo[3]);
  return f;
}

// A, element (m, k) at p[m * ld + k]: rows g and g + 8, one float2 each
__device__ __forceinline__ FragA frag_a_rows(const float* p, int ld, int g,
                                             int t) {
  const float2 u = *reinterpret_cast<const float2*>(p + g * ld + 2 * t);
  const float2 v = *reinterpret_cast<const float2*>(p + (g + 8) * ld + 2 * t);
  return split_a(u.x, v.x, u.y, v.y);
}

// A, element (m, k) at p[k * ld + m], times w[k] (w at the 8-step's k)
__device__ __forceinline__ FragA frag_a_cols(const float* p, int ld,
                                             const float* w, int g, int t) {
  const float w0 = w[2 * t], w1 = w[2 * t + 1];
  const float* r0 = p + 2 * t * ld;
  const float* r1 = r0 + ld;
  return split_a(__fmul_rn(r0[g], w0), __fmul_rn(r0[g + 8], w0),
                 __fmul_rn(r1[g], w1), __fmul_rn(r1[g + 8], w1));
}

// A from an accumulator {c0, c1, c2, c3} of a 16 x 8 tile, as the 8-step
// over its 8 columns
__device__ __forceinline__ FragA frag_a_acc(const float (&c)[4]) {
  return split_a(c[0], c[2], c[1], c[3]);
}

// B, element (k, col) at p[col * ld + k]: one float2
__device__ __forceinline__ FragB frag_b_rows(const float* p, int ld, int g,
                                             int t) {
  const float2 u = *reinterpret_cast<const float2*>(p + g * ld + 2 * t);
  FragB f;
  split(u.x, f.hi[0], f.lo[0]);
  split(u.y, f.hi[1], f.lo[1]);
  return f;
}

// B, element (k, col) at p[k * ld + col]
__device__ __forceinline__ FragB frag_b_cols(const float* p, int ld, int g,
                                             int t) {
  FragB f;
  split(p[2 * t * ld + g], f.hi[0], f.lo[0]);
  split(p[(2 * t + 1) * ld + g], f.hi[1], f.lo[1]);
  return f;
}

}  // namespace sage_mma
