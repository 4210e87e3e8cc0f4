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
// h 16, kv 1, s 4000, hd 256, window 2048) it does ~4.0e11 f32 FLOP per
// launch against ~0.56 GB of traffic.  The TPU kernel ran a grid over
// (batch, head, q block, kv block) with the kv axis sequential and the
// running max / sum / accumulator in VMEM scratch.  Here one block of 256
// threads owns a 64-row query tile of one (batch, head) and loops over
// 32-key tiles itself, starting and stopping at the first and last tile
// any of its rows can see (the TPU kernel's skip of fully masked blocks;
// half the work at s 4000, window 2048).  Per key tile:
//   1. K and V tiles are staged in shared memory (the Q tile stays there
//      for the whole loop; dynamic shared memory, above 48 KB at hd 256);
//   2. S = Q K^T as a register-tiled product, 4 rows x 2 keys a thread,
//      reading float4 along hd; Q and K rows are padded by 4 floats so
//      the 16 keys a warp reads fall in distinct banks;
//   3. one warp per 8 rows, one lane per key: scale, soft-cap, mask, the
//      running max and sum by warp shuffles, P written over S;
//   4. O = O * corr + P V, 4 rows x hd/16 dims a thread held in
//      registers.
// CUDA cores, not tensor cores: the products use explicit fmaf (the
// library is built with --fmad=false for the scans' sake).  wgmma/TMA
// and TF32 are for a later redesign.
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
// a register; its loop over t replaces the sequential grid axis.  A warp
// reads 32 consecutive channels of one step, so every load and store is
// coalesced, and later steps' loads do not depend on h, so the unrolled
// loop keeps several in flight.  Built with --fmad=false: a * h rounds
// before + x, as the plain version's separate multiply and add do, so the
// two agree bit for bit.  Starting from h0 equals the TPU kernel's fold of
// h0 into step 0 (x_0 + a_0 * h0) bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ----------------------------- flash attention -----------------------------

constexpr int kBq = 64;        // query rows per block
constexpr int kBk = 32;        // keys per tile (one per lane in step 3)
constexpr int kThreads = 256;  // 16 x 16 threads; 8 warps x 8 rows
constexpr int kRowsPerWarp = kBq / (kThreads / 32);

template <int HD>
struct AttnLayout {
  static constexpr int kQs = HD + 4;   // padded row strides (floats)
  static constexpr int kKs = HD + 4;
  static constexpr int kVs = HD;
  static constexpr int kSs = kBk + 1;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kBq * kQs;
  static constexpr int kV = kK + kBk * kKs;
  static constexpr int kS = kV + kBk * kVs;
  static constexpr int kCorr = kS + kBq * kSs;
  static constexpr int kL = kCorr + kBq;
  static constexpr size_t kBytes = sizeof(float) * (kL + kBq);
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       int h, int kvh, int sq, int sk, float scale, int causal,
                       int window, float softcap) {
  using L = AttnLayout<HD>;
  constexpr int kV4 = HD / 4;     // float4 per row
  constexpr int kDj = HD / 64;    // float4 groups of O a thread owns
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qs = smem + L::kQ;
  float* ks = smem + L::kK;
  float* vs = smem + L::kV;
  float* ss = smem + L::kS;
  float* corr_s = smem + L::kCorr;
  float* l_s = smem + L::kL;

  const int bh = blockIdx.y;
  const int b = bh / h;
  const int kv = (bh % h) / (h / kvh);
  const int q_lo = blockIdx.x * kBq;
  const int q_hi = min(q_lo + kBq, sq) - 1;
  const float* qb = q + int64_t(bh) * sq * HD;
  const float* kb = k + (int64_t(b) * kvh + kv) * sk * HD;
  const float* vb = v + (int64_t(b) * kvh + kv) * sk * HD;
  float* ob = o + int64_t(bh) * sq * HD;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;

  for (int i = tid; i < kBq * kV4; i += kThreads) {
    const int r = i / kV4, c = i % kV4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q_lo + r < sq)
      val = reinterpret_cast<const float4*>(qb + int64_t(q_lo + r) * HD)[c];
    *reinterpret_cast<float4*>(qs + r * L::kQs + 4 * c) = val;
  }

  // the keys any row of this tile can see
  const int k_begin = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int k_end = causal ? min(sk, q_hi + 1) : sk;

  float m_run[kRowsPerWarp], l_run[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
  }
  float acc[4][4 * kDj];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int d = 0; d < 4 * kDj; ++d) acc[i][d] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += kBk) {
    __syncthreads();   // the Q tile is in; the last tile's readers are done
    for (int i = tid; i < kBk * kV4; i += kThreads) {
      const int r = i / kV4, c = i % kV4;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
      if (k0 + r < sk) {
        kk = reinterpret_cast<const float4*>(kb + int64_t(k0 + r) * HD)[c];
        vv = reinterpret_cast<const float4*>(vb + int64_t(k0 + r) * HD)[c];
      }
      *reinterpret_cast<float4*>(ks + r * L::kKs + 4 * c) = kk;
      *reinterpret_cast<float4*>(vs + r * L::kVs + 4 * c) = vv;
    }
    __syncthreads();

    // 2. S = Q K^T: rows ty*4 + i, keys tx + 16*j
    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv4[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (ty * 4 + i) * L::kQs + d);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        kv4[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * L::kKs + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float t = s[i][j];
          t = __fmaf_rn(qv[i].x, kv4[j].x, t);
          t = __fmaf_rn(qv[i].y, kv4[j].y, t);
          t = __fmaf_rn(qv[i].z, kv4[j].z, t);
          t = __fmaf_rn(qv[i].w, kv4[j].w, t);
          s[i][j] = t;
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) ss[(ty * 4 + i) * L::kSs + tx + 16 * j] = s[i][j];
    __syncthreads();

    // 3. online softmax: warp owns rows warp*8 + r, lane = key k0 + lane
    const int kpos = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = warp * kRowsPerWarp + r;
      const int qpos = q_lo + row;
      float x = ss[row * L::kSs + lane] * scale;
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      bool ok = kpos < sk;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && kpos > qpos - window;
      x = ok ? x : -INFINITY;
      const float m_new = fmaxf(m_run[r], warp_max(x));
      float p = 0.f, corr = 1.f;
      if (m_new != -INFINITY) {
        p = expf(x - m_new);
        corr = expf(m_run[r] - m_new);
      }
      l_run[r] = l_run[r] * corr + warp_sum(p);
      m_run[r] = m_new;
      ss[row * L::kSs + lane] = p;
      if (lane == 0) corr_s[row] = corr;
    }
    __syncthreads();

    // 4. O = O * corr + P V: rows ty*4 + i, dims tx*4 + 64*j + e
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float c = corr_s[ty * 4 + i];
#pragma unroll
      for (int d = 0; d < 4 * kDj; ++d) acc[i][d] *= c;
    }
#pragma unroll 4
    for (int kk = 0; kk < kBk; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ss[(ty * 4 + i) * L::kSs + kk];
#pragma unroll
      for (int j = 0; j < kDj; ++j) {
        const float4 vv =
            *reinterpret_cast<const float4*>(vs + kk * L::kVs + tx * 4 + 64 * j);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][4 * j + 0] = __fmaf_rn(p[i], vv.x, acc[i][4 * j + 0]);
          acc[i][4 * j + 1] = __fmaf_rn(p[i], vv.y, acc[i][4 * j + 1]);
          acc[i][4 * j + 2] = __fmaf_rn(p[i], vv.z, acc[i][4 * j + 2]);
          acc[i][4 * j + 3] = __fmaf_rn(p[i], vv.w, acc[i][4 * j + 3]);
        }
      }
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) l_s[warp * kRowsPerWarp + r] = l_run[r];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty * 4 + i;
    if (q_lo + row >= sq) continue;
    const float l = fmaxf(l_s[row], 1e-37f);
    float* orow = ob + int64_t(q_lo + row) * HD;
#pragma unroll
    for (int j = 0; j < kDj; ++j) {
      float4 out;
      out.x = acc[i][4 * j + 0] / l;
      out.y = acc[i][4 * j + 1] / l;
      out.z = acc[i][4 * j + 2] / l;
      out.w = acc[i][4 * j + 3] / l;
      *reinterpret_cast<float4*>(orow + tx * 4 + 64 * j) = out;
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

constexpr int kScanThreads = 256;

__global__ void rglru_scan_kernel(const float* __restrict__ a,
                                  const float* __restrict__ x,
                                  const float* __restrict__ h0, int64_t s,
                                  int64_t w, float* __restrict__ out) {
  const int64_t c = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (c >= w) return;
  const int64_t bi = blockIdx.y;
  const int64_t base = bi * s * w + c;
  float h = h0 != nullptr ? h0[bi * w + c] : 0.0f;
#pragma unroll 8
  for (int64_t t = 0; t < s; ++t) {
    h = a[base + t * w] * h + x[base + t * w];
    out[base + t * w] = h;
  }
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
  if (b <= 0 || b > 65535 || s <= 0 || w <= 0)
    return int(cudaErrorInvalidValue);
  const dim3 grid(unsigned((w + kScanThreads - 1) / kScanThreads), unsigned(b));
  rglru_scan_kernel<<<grid, kScanThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, x, h0, s, w, out);
  return int(cudaGetLastError());
}

}  // extern "C"
