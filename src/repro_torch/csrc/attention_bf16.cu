// B5 on bf16 inputs, written for Hopper's bf16 tensor cores (sm_90a) and
// bound through a plain C interface (ctypes, no PyTorch headers).  The
// launcher returns the cudaError_t of its launch; sage_error_string
// (analytics_kernels.cu, the same library) names it.
//
//   sage_flash_attention_bf16  <- _attn_kernel
//                                 (repro/kernels/flash_attention.py)
//
// It computes what sage_flash_attention (model_kernels.cu) computes, on
// bf16 q, k, v, with a bf16 output, as the TPU kernel does on bf16 blocks
// (flash_attention.py:66-68 widens them in VMEM): s = scale q.k in f32 ;
// s = cap tanh(s / cap) when cap > 0 ; key j visible to query i iff
// j < sk, (j <= i when causal) and (j > i - window when window > 0) ;
// o_i = sum_j exp(s_ij - m_i) v_j / max(l_i, 1e-37) in f32, rounded once
// to bf16.  q, o: (b, h, sq, hd); k, v: (b, kv, sk, hd), contiguous, each
// starting on 16 bytes; hd 64, 128 or 256; query head h reads kv head
// h / (h / kv).  A query with no visible key gets 0.
//
// What bounds it on the card: operations.  At the [serve] shape (b 4,
// h 16, kv 1, s 4000, hd 256, window 2048) it needs 4.0e11 FLOP against
// 0.28 GB of bf16 traffic: 0.40 ms at the bf16 tensor cores' 989 TFLOP/s.
//
// Design (the shape of a Hopper attention kernel):
//   * TMA.  A block owns 64 NC query rows of one (batch, head) and walks
//     the key tiles any of its rows can see (the TPU kernel's skip of
//     fully masked blocks).  Q, and each tile of K and V, arrive by TMA
//     (cp.async.bulk.tensor, one 3-D tensor map each, built on the host
//     per call) as 64-column boxes with the 128-byte swizzle: hd 64 is one
//     128-byte row, hd 128 and 256 two and four boxes.  Rows past sq or sk
//     read as 0, and the mask hides the keys.
//   * Warps.  One producer warpgroup (one thread of it issues the copies)
//     keeps K and V two tiles deep on mbarriers (full: the bytes landed;
//     empty: every consumer warp is done with the stage, one arrival a
//     warp, which timed faster than one from every thread); NC consumer
//     warpgroups each own 64 query rows.
//   * S = Q K^T: one wgmma per 16 columns of hd, both operands in shared
//     memory (K-major).  bf16 x bf16 products are exact in f32, so this is
//     the reference's f32 dot up to the order of the sums.
//   * O += P V: P is f32 and must keep its precision (the limit, 1e-4 of
//     the row's max |o| plus 2^-8 of |o|, leaves no room for a rounding of
//     P to bf16, 2^-9: tests/test_torch_bf16_split.py).  Each P is split in
//     registers into hi = bf16(p) and lo = bf16(p - hi), and O takes two
//     wgmmas a k-step, hi V + lo V, A from registers (S's accumulator is,
//     packed in pairs, P's A fragment) and V from shared memory read
//     MN-major (wgmma transposes 16-bit operands itself).
//   * Softmax in f32 in registers: the row max and sum over a quad of
//     lanes (two shuffles), the sum kept per lane and reduced at the end;
//     exp is __expf (ex2.approx, ~2^-21 relative near 0); built with
//     --fmad=false, so the sum's rescale is written as one __fmaf_rn.  A
//     key tile hidden from all of a warpgroup's rows is skipped, and one
//     inside every row's visible range takes no mask.
//   * Registers.  O is hd / 2 f32 a thread (128 at hd 256), S and P hi/lo
//     BK / 2 each.  With two consumer warpgroups (168 registers a thread
//     at launch) and hd 128 or 256 the producer gives registers back
//     (setmaxnreg.dec to 40) and the consumers take them (inc to 232);
//     without it hd 128 spilled.
//   * Grid.  NC = 2 (128 query rows a block) where that gives at least
//     two blocks a multiprocessor, else NC = 1 (whisper's decoder: 4 x 20
//     x 3 tiles of 128 rows would not fill 132 multiprocessors twice).
//   Shared memory: Q (64 NC x hd), two stages of K and V (BK x hd each;
//   BK 128 keys, 64 at hd 256), six mbarriers: 193 KB at hd 256, NC 2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_bf16.cuh"

namespace {

using namespace sage_hopper;

template <int HD, int NC>
struct AttnPlan {
  static constexpr int kBq = 64 * NC;              // query rows a block
  static constexpr int kBk = HD == 256 ? 64 : 128;  // keys a tile
  static constexpr int kBoxes = HD / 64;           // 128-byte boxes a row
  static constexpr int kThreads = 128 * (NC + 1);  // + the producer
  static constexpr int kQBox = kBq * 128;          // bytes of a box of Q
  static constexpr int kKBox = kBk * 128;          // of K or V
  static constexpr int kTile = kBoxes * kKBox;     // a K (or V) tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kBoxes * kQBox;   // two stages
  static constexpr int kV = kK + 2 * kTile;        // two stages
  // mbarriers: q, kfull[2], vfull[2], empty[2]
  static constexpr int kBar = kV + 2 * kTile;
  // + 1,024 to align the start (the swizzle's 8-row groups)
  static constexpr size_t kBytes = kBar + 7 * 8 + 1024;
  static constexpr bool kRegs = HD >= 128 && NC == 2;   // setmaxnreg
};

template <int HD, int NC>
__global__ void __launch_bounds__(AttnPlan<HD, NC>::kThreads, 1)
flash_attention_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            __nv_bfloat16* __restrict__ o, int h, int kvh,
                            int sq, int sk, float scale, int causal,
                            int window, float softcap) {
  using L = AttnPlan<HD, NC>;
  constexpr int BK = L::kBk;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* qfull = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* kfull = qfull + 1;
  uint64_t* vfull = qfull + 3;
  uint64_t* empty = qfull + 5;

  const int bh = blockIdx.y;
  const int b = bh / h;
  const int kv = (bh % h) / (h / kvh);
  const int q_lo = blockIdx.x * L::kBq;
  const int q_hi = min(q_lo + L::kBq, sq) - 1;
  // the key tiles any row of this block can see
  const int k_begin = window > 0 ? max(0, q_lo - window + 1) / BK * BK : 0;
  const int k_end = causal ? min(sk, q_hi + 1) : sk;
  const int ntiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(kfull + s, 1);
      mbar_init(vfull + s, 1);
      mbar_init(empty + s, 4 * NC);   // one arrival a consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == NC) {
    // ------------------------------ producer ------------------------------
    if constexpr (L::kRegs) setmaxnreg_dec<40>();
    if (threadIdx.x == 128 * NC) {
      const int kvrow = b * kvh + kv;
      mbar_expect_tx(qfull, L::kBq * HD * 2);
      for (int c = 0; c < L::kBoxes; ++c)
        tma_load_3d(smem + L::kQ + c * L::kQBox, &tq, qfull, 64 * c, q_lo,
                    bh);
      for (int j = 0; j < ntiles; ++j) {
        const int st = j & 1;
        // the stage's previous tile (j - 2) is released
        if (j >= 2) mbar_wait(empty + st, ((j >> 1) - 1) & 1);
        const int k0 = k_begin + j * BK;
        mbar_expect_tx(kfull + st, BK * HD * 2);
        for (int c = 0; c < L::kBoxes; ++c)
          tma_load_3d(smem + L::kK + st * L::kTile + c * L::kKBox, &tk,
                      kfull + st, 64 * c, k0, kvrow);
        mbar_expect_tx(vfull + st, BK * HD * 2);
        for (int c = 0; c < L::kBoxes; ++c)
          tma_load_3d(smem + L::kV + st * L::kTile + c * L::kKBox, &tv,
                      vfull + st, 64 * c, k0, kvrow);
      }
    }
  } else {
    // ------------------------------ consumers -----------------------------
    if constexpr (L::kRegs) setmaxnreg_inc<232>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int r0 = q_lo + 64 * wg;           // the warpgroup's rows r0..r1
    const int r1 = min(r0 + 63, sq - 1);
    const int rw = r0 + 16 * warp + g;       // this thread's rows rw, rw + 8
    const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;
    const uint32_t q_base = smem_u32(smem + L::kQ) + 64 * wg * 128;

    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
    mbar_wait(qfull, 0);

    for (int j = 0; j < ntiles; ++j) {
      const int st = j & 1;
      const uint32_t par = (j >> 1) & 1;
      const int k0 = k_begin + j * BK;
      // a tile the mask hides from all the warpgroup's rows leaves them
      // as they are; every thread still waits for it, so that its release
      // of the stage counts in the right phase
      const bool live = r0 < sq && (!causal || k0 <= r1) &&
                        (window <= 0 || k0 + BK - 1 > r0 - window);
      mbar_wait(kfull + st, par);
      if (live) {
        // S = Q K^T over hd, 16 columns a wgmma
        float s[BK / 2];
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
        const uint32_t k_base = smem_u32(smem + L::kK + st * L::kTile);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          // box kk / 4, 32 bytes a k-step inside its 128-byte rows
          const uint32_t off = (kk % 4) * 32;
          Wgmma<BK>::template ss<0, 0>(
              s, desc(q_base + (kk / 4) * L::kQBox + off, 16, 1024, 1),
              desc(k_base + (kk / 4) * L::kKBox + off, 16, 1024, 1), 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        pin(s);

        // the tile lies inside what every row of the warpgroup can see
        const bool inside = k0 + BK <= sk && (!causal || k0 + BK - 1 <= r0) &&
                            (window <= 0 || k0 > r1 - window);
        // scale, soft-cap, mask; the rows' running max
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int e = i % 4;
          float x = __fmul_rn(s[i], scale);
          if (softcap > 0.f)
            x = __fmul_rn(softcap, tanhf(__fmul_rn(x, inv_cap)));
          if (!inside) {
            const int qpos = rw + 8 * (e >> 1);
            const int kpos = k0 + 8 * (i / 4) + 2 * t + (e & 1);
            bool ok = kpos < sk;
            if (causal) ok = ok && kpos <= qpos;
            if (window > 0) ok = ok && kpos > qpos - window;
            if (!ok) x = -INFINITY;
          }
          s[i] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
        float corr[2], base[2], psum[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m_run[r], mx[r]);
          // no visible key yet: p = 0 and nothing to rescale
          base[r] = m_new == -INFINITY ? 0.f : m_new;
          corr[r] = m_new == -INFINITY ? 1.f : __expf(m_run[r] - m_new);
          m_run[r] = m_new;
        }
        // P, split into the A fragments of P V: k-step kk is S's
        // columns 16 kk .. 16 kk + 15
        uint32_t ph[BK / 16][4], pl[BK / 16][4];
#pragma unroll
        for (int i = 0; i < BK / 2; i += 2) {
          const int r = (i % 4) >> 1;
          const float p0 = __expf(s[i] - base[r]);
          const float p1 = __expf(s[i + 1] - base[r]);
          psum[r] += p0;
          psum[r] += p1;
          split2(p0, p1, ph[i / 8][(i % 8) / 2], pl[i / 8][(i % 8) / 2]);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r)
          l_run[r] = __fmaf_rn(l_run[r], corr[r], psum[r]);
        if (corr[0] != 1.f || corr[1] != 1.f) {
#pragma unroll
          for (int i = 0; i < HD / 2; ++i)
            acc[i] = __fmul_rn(acc[i], corr[(i % 4) >> 1]);
        }

        // O += P_hi V + P_lo V, V read MN-major: rows 16 kk.. are k-step
        // kk, the next 64 columns a box (kKBox bytes) on
        mbar_wait(vfull + st, par);
        const uint32_t v_base = smem_u32(smem + L::kV + st * L::kTile);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t dv = desc(v_base + kk * 2048, L::kKBox, 1024, 1);
          Wgmma<HD>::template rs<1>(acc, ph[kk], dv, 1);
          Wgmma<HD>::template rs<1>(acc, pl[kk], dv, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        pin(acc);
        pin(ph);
        pin(pl);
      } else {
        mbar_wait(vfull + st, par);
      }
      // every lane of the warp is past its wgmma wait (.sync.aligned)
      if (lane == 0) mbar_arrive(empty + st);
    }

    if (r0 < sq) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float l = l_run[r];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        const float inv = 1.f / fmaxf(l, 1e-37f);
        const int qpos = rw + 8 * r;
        if (qpos >= sq) continue;
        __nv_bfloat16* orow = o + (int64_t(bh) * sq + qpos) * HD + 2 * t;
#pragma unroll
        for (int jj = 0; jj < HD / 8; ++jj)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * jj) =
              __floats2bfloat162_rn(__fmul_rn(acc[4 * jj + 2 * r], inv),
                                    __fmul_rn(acc[4 * jj + 2 * r + 1], inv));
      }
    }
  }
}

int num_sms() {
  static const int n = [] {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count > 0 ? count : 132;
  }();
  return n;
}

template <int HD, int NC>
int launch_flash_attention_bf16(const void* q, const void* k, const void* v,
                                void* o, int b, int h, int kvh, int sq, int sk,
                                float scale, int causal, int window,
                                float softcap, cudaStream_t stream) {
  using L = AttnPlan<HD, NC>;
  CUtensorMap tq, tk, tv;
  int err = encode_bf16_3d(&tq, q, HD, sq, uint64_t(b) * h, 64, L::kBq);
  if (err == 0)
    err = encode_bf16_3d(&tk, k, HD, sk, uint64_t(b) * kvh, 64, L::kBk);
  if (err == 0)
    err = encode_bf16_3d(&tv, v, HD, sk, uint64_t(b) * kvh, 64, L::kBk);
  if (err != 0) return err;
  const cudaError_t set = cudaFuncSetAttribute(
      flash_attention_bf16_kernel<HD, NC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(L::kBytes));
  if (set != cudaSuccess) return int(set);
  const dim3 grid((sq + L::kBq - 1) / L::kBq, b * h);
  flash_attention_bf16_kernel<HD, NC><<<grid, L::kThreads, L::kBytes,
                                        stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), h, kvh, sq, sk, scale,
      causal, window, softcap);
  return int(cudaGetLastError());
}

template <int HD>
int launch_hd(const void* q, const void* k, const void* v, void* o, int b,
              int h, int kvh, int sq, int sk, float scale, int causal,
              int window, float softcap, cudaStream_t stream) {
  // 128-row blocks where they fill every multiprocessor twice
  const int64_t tiles128 = int64_t((sq + 127) / 128) * b * h;
  if (tiles128 >= 2 * num_sms())
    return launch_flash_attention_bf16<HD, 2>(q, k, v, o, b, h, kvh, sq, sk,
                                              scale, causal, window, softcap,
                                              stream);
  return launch_flash_attention_bf16<HD, 1>(q, k, v, o, b, h, kvh, sq, sk,
                                            scale, causal, window, softcap,
                                            stream);
}

}  // namespace

extern "C" {

int sage_flash_attention_bf16(const void* q, const void* k, const void* v,
                              void* o, int b, int h, int kvh, int sq, int sk,
                              int hd, float scale, int causal, int window,
                              float softcap, void* stream) {
  if (b <= 0 || h <= 0 || kvh <= 0 || h % kvh != 0 || sq <= 0 || sk <= 0 ||
      b * h > 65535)
    return int(cudaErrorInvalidValue);
  // TMA reads from 16-byte boundaries
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16 != 0)
    return int(cudaErrorMisalignedAddress);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return launch_hd<64>(q, k, v, o, b, h, kvh, sq, sk, scale, causal,
                           window, softcap, st);
    case 128:
      return launch_hd<128>(q, k, v, o, b, h, kvh, sq, sk, scale, causal,
                            window, softcap, st);
    case 256:
      return launch_hd<256>(q, k, v, o, b, h, kvh, sq, sk, scale, causal,
                            window, softcap, st);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // extern "C"
