// Model kernels of the serving path, written for Hopper (sm_90a) and
// bound through a plain C interface (ctypes, no PyTorch headers).  Each
// launcher returns the cudaError_t of its launch; sage_error_string
// (analytics_kernels.cu, the same library) names it.
//
//   sage_flash_attention  <- _attn_kernel   (repro/kernels/flash_attention.py)
//   sage_rglru_scan       <- _rglru_kernel  (repro/kernels/rglru_scan.py)
//
// ---------------------------------------------------------------------------
// sage_flash_attention
//
// Online-softmax attention, f32 in and out, f32 accumulation:
//   s = scale * q.k ; s = cap * tanh(s / cap) when cap > 0 ;
//   key j is visible to query i iff j < sk, (j <= i when causal) and
//   (j > i - window when window > 0), positions equal to indices ;
//   o_i = sum_j exp(s_ij - m_i) v_j / max(l_i, 1e-37).
// q, o: (b, h, sq, hd); k, v: (b, kv, sk, hd), all contiguous; query head
// h reads kv head h / (h / kv), so GQA and MQA copy nothing.  A query with
// no visible key gets 0.
//
// What bounds it on the card: operations.  At the serving shape (b 4,
// h 16, kv 1, s 4000, hd 256, window 2048) it needs ~4.0e11 FLOP per
// launch against ~0.56 GB of traffic: 0.81 ms at the tensor cores' TF32
// rate.  The TPU kernel ran a grid over (batch, head, q block, kv block)
// with the kv axis sequential and the running max / sum / accumulator in
// VMEM scratch.  Here a block of 8 warps owns a 128-row query tile of one
// (batch, head) and walks 32-key tiles itself, from the first to the last
// tile any of its rows can see (the TPU kernel's skip of fully masked
// blocks; half the work at s 4000, window 2048).
//
// Tensor cores, split TF32 (tf32_mma.cuh): S = Q K^T and O += P V both run
// as mma.sync m16n8k8 with three TF32 products for each (lo hi + hi lo +
// hi hi).  Plain TF32 would leave ~1e-3 of each row's max |o| and any
// cheaper split 3-6e-4 (tests/test_torch_attn_split.py); the limit is 1e-4.
//
// Registers decide the layout.  A warp pair owns 32 query rows (two 16-row
// tiles) and each warp of it half of hd: its O (32 x hd / 2) is 128
// registers a lane at hd 256, S for 32 keys 32 more (252 in all, no
// spills).  Each warp takes the product over its half of hd for S; the
// pair adds the halves through shared memory in one order (half 0's +
// half 1's), so both warps hold the same S, make the same softmax, and
// each then adds its half of O.  S and P never leave the registers
// otherwise: with the permuted contraction index, S's accumulator for keys
// 8j..8j+7 is, reordered, P's A fragment for the 8-step j of P V.  The row
// max and sum take two quad shuffles; the sum is kept per lane and reduced
// once at the end; the running max and sum wait in shared memory between
// tiles.  A tile that the mask hides from all 32 rows is skipped, and one
// inside every row's visible range takes no mask.  exp is __expf
// (ex2.approx, ~2^-21 relative near 0, where the weights that matter lie);
// the soft-cap and the final divide multiply by a reciprocal.
//
// Shared memory (floats): the Q tile (128 x (hd + 8), read along hd) stays
// for the whole walk; K (32 x (hd + 8), read along hd) and V (32 x (hd + 4),
// read down its columns) have one buffer each, V's copy (cp.async) in
// flight under S = Q K^T and the next K's under the softmax and P V; then
// the pairs' halves of S and the running max and sum.  At hd 256: 226,816
// B, one block of 8 warps a multiprocessor (the registers allow no more).
//
// ---------------------------------------------------------------------------
// sage_rglru_scan
//
// h_t = a_t * h_{t-1} + x_t over the sequence for every (batch, channel),
// from h_{-1} = h0 (or 0): the RG-LRU's linear recurrence.  a, x, out:
// (b, s, w) f32 contiguous; h0: (b, w) or null.
//
// What bounds it on the card: bytes (three f32 streams, one multiply and
// one add per element).  The TPU kernel ran a grid of (batch, 512-lane
// width blocks, sequence chunks) with the chunk axis sequential and the
// state in VMEM.  Here one thread owns one (batch, channel) and keeps h in
// a register; its loop over t replaces the sequential grid axis.  A block
// is one warp of 32 channels (512 blocks at w 4096, b 4, all resident on
// the 132 multiprocessors) that streams [32 steps x 32 channels] tiles of
// a and x through four cp.async stages in shared memory: three tiles (24 KB)
// in flight a block, ~12 MB across the card, enough to keep HBM busy while
// the chain, a multiply and an add a step, reads its tiles back.  16-byte
// copies where w % 4 == 0, 4-byte copies otherwise; rows past s and
// channels past w are zero-filled and never stored.  h is stored as it is
// made, 32 consecutive channels (128 B) a step.
// Built with --fmad=false, and the multiply and the add are written
// rounded apart: a * h rounds before + x, as the plain version's separate
// multiply and add do, so the two agree bit for bit.  Starting from h0
// equals the TPU kernel's fold of h0 into step 0 (x_0 + a_0 * h0) bit for
// bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

using namespace sage_mma;   // cp.async, split-TF32 fragments and products

// ----------------------------- flash attention -----------------------------

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMT = 2;             // 16-row tiles a warp pair owns
constexpr int kBq = 16 * kMT * (kWarps / 2);   // query rows per block
constexpr int kBk = 32;            // keys per tile
constexpr int kKT = kBk / 8;       // 8-key tiles of S, 8-steps of P V

template <int HD>
struct AttnLayout {
  static constexpr int kQs = HD + 8;   // Q rows, read along hd (8 mod 32)
  static constexpr int kKs = HD + 8;   // K rows, read along hd (8 mod 32)
  static constexpr int kVs = HD + 4;   // V rows, read down columns (4 mod 32)
  static constexpr int kK = kBq * kQs;            // the K tile, after Q
  static constexpr int kV = kK + kBk * kKs;       // the V tile
  static constexpr int kX = kV + kBk * kVs;       // each pair's S
  static constexpr int kML = kX + (kWarps / 2) * 32 * 4 * kMT * kKT;
  // each lane's running max and part of the sum, for its 2 kMT rows
  static constexpr size_t kBytes =
      sizeof(float) * (kML + kWarps * 32 * 4 * kMT);
};

// the two warps of a pair (64 threads) meet at named barrier 1 + pair
__device__ __forceinline__ void pair_sync(int pair) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(pair + 1) : "memory");
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       int h, int kvh, int sq, int sk, float scale, int causal,
                       int window, float softcap) {
  using L = AttnLayout<HD>;
  constexpr int HH = HD / 2;      // the dims of a warp's half
  constexpr int NT = HH / 8;      // its 8-dim tiles of O
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int bh = blockIdx.y;
  const int b = bh / h;
  const int kv = (bh % h) / (h / kvh);
  const int q_lo = blockIdx.x * kBq;
  const int q_hi = min(q_lo + kBq, sq) - 1;
  const float* qb = q + int64_t(bh) * sq * HD;
  // K's and V's rows of this (batch, kv head) start kv_off floats in
  const int64_t kv_off = (int64_t(b) * kvh + kv) * sk * HD;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  for (int i = tid; i < kBq * (HD / 4); i += kThreads) {
    const int r = i / (HD / 4), c = 4 * (i % (HD / 4));
    const bool ok = q_lo + r < sq;
    cp16(smem + r * L::kQs + c, ok ? qb + int64_t(q_lo + r) * HD + c : qb, ok);
  }

  // the key tiles any row of this block can see
  const int k_begin = window > 0 ? max(0, q_lo - window + 1) / kBk * kBk : 0;
  const int k_end = causal ? min(sk, q_hi + 1) : sk;
  const int ntiles = k_end > k_begin ? (k_end - k_begin + kBk - 1) / kBk : 0;
  // rows [0, kBk) of tile j of K (or V) into its buffer
  auto stage = [&](const float* src, float* dst, int ld, int j) {
    const int k0 = k_begin + j * kBk;
    for (int i = tid; i < kBk * (HD / 4); i += kThreads) {
      const int r = i / (HD / 4), c = 4 * (i % (HD / 4));
      const bool ok = k0 + r < sk;
      cp16(dst + r * ld + c, ok ? src + int64_t(k0 + r) * HD + c : src, ok);
    }
  };
  if (ntiles > 0) stage(k + kv_off, smem + L::kK, L::kKs, 0);
  cp_commit();   // the Q tile and the first K tile

  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;
  // the pair's rows r0 + 16 mt + g and + 8; this warp's half of hd
  const int pair = warp / 2, half = warp % 2;
  const int r0 = q_lo + 16 * kMT * pair;
  const float* qw = smem + 16 * kMT * pair * L::kQs + half * HH;
  const float* ks = smem + L::kK + half * HH;
  const float* vs = smem + L::kV + half * HH;
  float4* xs = reinterpret_cast<float4*>(smem + L::kX) +
               pair * 32 * kMT * kKT + lane;
  float acc[kMT][NT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
  // m_run(mt, r), l_run(mt, r): this lane's rows' running max and its
  // part of their sums, in shared memory (the registers hold O)
  float* ml = smem + L::kML + warp * 32 * 4 * kMT + lane;
  auto m_run = [ml](int mt, int r) -> float& {
    return ml[32 * (4 * mt + 2 * r)];
  };
  auto l_run = [ml](int mt, int r) -> float& {
    return ml[32 * (4 * mt + 2 * r + 1)];
  };
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_run(mt, r) = -INFINITY;
      l_run(mt, r) = 0.f;
    }

  // K and V have one buffer each: V's copy runs under S = Q K^T and the
  // next K's under the softmax and P V
  for (int j = 0; j < ntiles; ++j) {
    cp_wait<0>();
    __syncthreads();   // K tile j has landed; P V of tile j - 1 is done
    stage(v + kv_off, smem + L::kV, L::kVs, j);
    cp_commit();
    const int k0 = k_begin + j * kBk;
    // a tile the mask hides from all the pair's rows would leave them as
    // they are
    const bool live = r0 < sq && (!causal || k0 <= r0 + 16 * kMT - 1) &&
                      (window <= 0 || k0 + kBk - 1 > r0 - window);

    // this warp's half of S = Q K^T, over its half of hd: rows
    // 16 mt + g, + 8; keys k0 + 8 n + 2 t, + 1
    float s[kMT][kKT][4];
    if (live) {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int n = 0; n < kKT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][n][e] = 0.f;
#pragma unroll 8
      for (int d = 0; d < HH; d += 8) {
        FragA a[kMT];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
          a[mt] = frag_a_rows(qw + 16 * mt * L::kQs + d, L::kQs, g, t);
#pragma unroll
        for (int n = 0; n < kKT; ++n) {
          const FragB bf =
              frag_b_rows(ks + 8 * n * L::kKs + d, L::kKs, g, t);
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) mma3(s[mt][n], a[mt], bf);
        }
      }
    }
    cp_wait<0>();
    __syncthreads();   // V tile j has landed; every warp is done with K
    if (j + 1 < ntiles) stage(k + kv_off, smem + L::kK, L::kKs, j + 1);
    cp_commit();
    if (!live) continue;

    // the pair adds its halves in one order (half 0's + half 1's, by
    // half 1), so both warps hold the same S and make the same softmax
    if (half == 0) {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int n = 0; n < kKT; ++n)
          xs[32 * (mt * kKT + n)] = make_float4(s[mt][n][0], s[mt][n][1],
                                                s[mt][n][2], s[mt][n][3]);
    }
    pair_sync(pair);
    if (half == 1) {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int n = 0; n < kKT; ++n) {
          const float4 o0 = xs[32 * (mt * kKT + n)];
          s[mt][n][0] = __fadd_rn(o0.x, s[mt][n][0]);
          s[mt][n][1] = __fadd_rn(o0.y, s[mt][n][1]);
          s[mt][n][2] = __fadd_rn(o0.z, s[mt][n][2]);
          s[mt][n][3] = __fadd_rn(o0.w, s[mt][n][3]);
          xs[32 * (mt * kKT + n)] = make_float4(s[mt][n][0], s[mt][n][1],
                                                s[mt][n][2], s[mt][n][3]);
        }
    }
    pair_sync(pair);
    if (half == 0) {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int n = 0; n < kKT; ++n) {
          const float4 o1 = xs[32 * (mt * kKT + n)];
          s[mt][n][0] = o1.x;
          s[mt][n][1] = o1.y;
          s[mt][n][2] = o1.z;
          s[mt][n][3] = o1.w;
        }
    }

    // the tile lies inside what every row of the pair can see: no mask
    const bool inside = k0 + kBk <= sk && (!causal || k0 + kBk - 1 <= r0) &&
                        (window <= 0 || k0 > r0 + 16 * kMT - 1 - window);
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      // scale, soft-cap, mask; the rows' running max
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < kKT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = __fmul_rn(s[mt][n][e], scale);
          if (softcap > 0.f)
            x = __fmul_rn(softcap, tanhf(__fmul_rn(x, inv_cap)));
          if (!inside) {
            const int qpos = r0 + 16 * mt + g + 8 * (e >> 1);
            const int kpos = k0 + 8 * n + 2 * t + (e & 1);
            bool ok = kpos < sk;
            if (causal) ok = ok && kpos <= qpos;
            if (window > 0) ok = ok && kpos > qpos - window;
            if (!ok) x = -INFINITY;
          }
          s[mt][n][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float corr[2], base[2], psum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_old = m_run(mt, r);
        const float m_new = fmaxf(m_old, mx[r]);
        // no visible key yet: p = 0 and nothing to rescale
        base[r] = m_new == -INFINITY ? 0.f : m_new;
        corr[r] = m_new == -INFINITY ? 1.f : __expf(m_old - m_new);
        m_run(mt, r) = m_new;
      }
#pragma unroll
      for (int n = 0; n < kKT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[mt][n][e] = __expf(s[mt][n][e] - base[e >> 1]);
          psum[e >> 1] += s[mt][n][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r)
        l_run(mt, r) = __fadd_rn(__fmul_rn(l_run(mt, r), corr[r]), psum[r]);
      // corr is 1 exactly where the row's max held: skip the rescale when
      // it held for all 16 rows
      if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          acc[mt][n][0] *= corr[0];
          acc[mt][n][1] *= corr[0];
          acc[mt][n][2] *= corr[1];
          acc[mt][n][3] *= corr[1];
        }
      }
    }

    // this warp's half of O += P V: S's 8-key tile n is the 8-step n
#pragma unroll
    for (int n = 0; n < kKT; ++n) {
      FragA pa[kMT];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) pa[mt] = frag_a_acc(s[mt][n]);
      const float* vrow = vs + 8 * n * L::kVs;
#pragma unroll
      for (int c = 0; c < NT; ++c) {
        const FragB bf = frag_b_cols(vrow + 8 * c, L::kVs, g, t);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) mma3(acc[mt][c], pa[mt], bf);
      }
    }
  }
  cp_wait<0>();

  if (r0 < sq) {
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float l = l_run(mt, r);
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        const float inv = 1.f / fmaxf(l, 1e-37f);
        const int qpos = r0 + 16 * mt + g + 8 * r;
        if (qpos >= sq) continue;
        float* orow = o + (int64_t(bh) * sq + qpos) * HD + half * HH + 2 * t;
#pragma unroll
        for (int n = 0; n < NT; ++n)
          *reinterpret_cast<float2*>(orow + 8 * n) =
              make_float2(__fmul_rn(acc[mt][n][2 * r], inv),
                          __fmul_rn(acc[mt][n][2 * r + 1], inv));
      }
  }
}

template <int HD>
int launch_flash_attention(const float* q, const float* k, const float* v,
                           float* o, int b, int h, int kvh, int sq, int sk,
                           float scale, int causal, int window, float softcap,
                           cudaStream_t stream) {
  const size_t smem = AttnLayout<HD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((sq + kBq - 1) / kBq, b * h);
  flash_attention_kernel<HD><<<grid, kThreads, smem, stream>>>(
      q, k, v, o, h, kvh, sq, sk, scale, causal, window, softcap);
  return int(cudaGetLastError());
}

// -------------------------------- rglru scan -------------------------------

constexpr int kScanC = 32;        // channels a block: one warp, a lane a chain
constexpr int kScanT = 32;        // steps a stage
constexpr int kScanStages = 4;

__global__ void __launch_bounds__(kScanC)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ x,
                  const float* __restrict__ h0, int64_t s, int64_t w, bool vec,
                  float* __restrict__ out) {
  __shared__ __align__(16) float as[kScanStages][kScanT][kScanC];
  __shared__ __align__(16) float xs[kScanStages][kScanT][kScanC];
  const int lane = threadIdx.x;
  const int64_t c0 = int64_t(blockIdx.x) * kScanC;
  const int64_t bi = blockIdx.y;
  const int nc = int(w - c0 < kScanC ? w - c0 : kScanC);   // live channels
  const int64_t base = bi * s * w + c0;
  const float* ab = a + base;
  const float* xb = x + base;
  const int64_t nstage = (s + kScanT - 1) / kScanT;

  auto stage = [&](int64_t j) {
    const int buf = int(j % kScanStages);
    const int64_t t0 = j * kScanT;
    const int rows = int(s - t0 < kScanT ? s - t0 : kScanT);
    if (vec) {   // nc % 4 == 0 and every row 16-byte aligned
      for (int i = lane; i < kScanT * (kScanC / 4); i += kScanC) {
        const int r = i / (kScanC / 4), c = 4 * (i % (kScanC / 4));
        const bool ok = r < rows && c < nc;
        const int64_t off = ok ? (t0 + r) * w + c : 0;
        cp16(&as[buf][r][c], ab + off, ok);
        cp16(&xs[buf][r][c], xb + off, ok);
      }
    } else {
      for (int r = 0; r < kScanT; ++r) {
        const bool ok = r < rows && lane < nc;
        const int64_t off = ok ? (t0 + r) * w + lane : 0;
        cp4(&as[buf][r][lane], ab + off, ok);
        cp4(&xs[buf][r][lane], xb + off, ok);
      }
    }
  };
  for (int j = 0; j < kScanStages - 1; ++j) {
    if (j < nstage) stage(j);
    cp_commit();
  }

  float hv = h0 != nullptr && lane < nc ? h0[bi * w + c0 + lane] : 0.0f;
  float* op = out + base + lane;
  for (int64_t j = 0; j < nstage; ++j) {
    // refill the buffer read one stage ago; then stage j has landed
    if (j + kScanStages - 1 < nstage) stage(j + kScanStages - 1);
    cp_commit();
    cp_wait<kScanStages - 1>();
    __syncwarp();
    const int buf = int(j % kScanStages);
    const int64_t t0 = j * kScanT;
    const int rows = int(s - t0 < kScanT ? s - t0 : kScanT);
    if (lane < nc) {
      if (rows == kScanT) {
#pragma unroll
        for (int r = 0; r < kScanT; ++r) {
          hv = __fadd_rn(__fmul_rn(as[buf][r][lane], hv), xs[buf][r][lane]);
          op[(t0 + r) * w] = hv;
        }
      } else {
        for (int r = 0; r < rows; ++r) {
          hv = __fadd_rn(__fmul_rn(as[buf][r][lane], hv), xs[buf][r][lane]);
          op[(t0 + r) * w] = hv;
        }
      }
    }
    __syncwarp();   // stage j is read before it is refilled
  }
  cp_wait<0>();
}

}  // namespace

extern "C" {

int sage_flash_attention(const float* q, const float* k, const float* v,
                         float* o, int b, int h, int kvh, int sq, int sk,
                         int hd, float scale, int causal, int window,
                         float softcap, void* stream) {
  if (b <= 0 || h <= 0 || kvh <= 0 || h % kvh != 0 || sq <= 0 || sk <= 0 ||
      b * h > 65535)
    return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return launch_flash_attention<64>(q, k, v, o, b, h, kvh, sq, sk, scale,
                                        causal, window, softcap, st);
    case 128:
      return launch_flash_attention<128>(q, k, v, o, b, h, kvh, sq, sk, scale,
                                         causal, window, softcap, st);
    case 256:
      return launch_flash_attention<256>(q, k, v, o, b, h, kvh, sq, sk, scale,
                                         causal, window, softcap, st);
    default:
      return int(cudaErrorInvalidValue);
  }
}

int sage_rglru_scan(const float* a, const float* x, const float* h0,
                    int64_t b, int64_t s, int64_t w, float* out,
                    void* stream) {
  if (b <= 0 || b > 65535 || s <= 0 || w <= 0 ||
      (w + kScanC - 1) / kScanC > int64_t(2147483647))
    return int(cudaErrorInvalidValue);
  const bool vec = w % 4 == 0 && (reinterpret_cast<uintptr_t>(a) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const dim3 grid(unsigned((w + kScanC - 1) / kScanC), unsigned(b));
  rglru_scan_kernel<<<grid, kScanC, 0, static_cast<cudaStream_t>(stream)>>>(
      a, x, h0, s, w, vec, out);
  return int(cudaGetLastError());
}

}  // extern "C"
