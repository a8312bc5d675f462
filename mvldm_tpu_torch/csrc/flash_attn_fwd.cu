// Flash attention forward for Hopper (sm_90a), bf16 in / bf16 out.
//
// Replaces the TPU kernel `_flash_kernel` behind `flash_attention` in
// mvldm_tpu/ops/attention.py: out = softmax(scale * Q K^T + bias) V for
// q (B, H, Lq, D), k/v (B, H, Lk, D) and an optional f32 additive key bias
// (B, Lk) broadcast over heads and query rows.
//
// What bounds it on this card: at the model's joint cross-view shapes
// (L = 5 * 1024, D = 40) the work is ~4 * L^2 * D flops against ~4 * L * D
// bytes, far above the H100's ~295 flop/byte ridge, so it is bound by
// tensor-core operations, and the L x L score matrix must never reach
// device memory. One block per (batch * head, 64-query tile) walks the key
// tiles with an online softmax (running max and sum in f32); ragged Lq / Lk
// are masked in the kernel, never padded in device memory. Two bodies:
//   * head dims up to 160 (every UNet attention): FlashAttention-2 layout
//     on mma.sync m16n8k16, scores, P and the output accumulator in
//     registers (flash_fwd_reg_kernel). For training it also writes the f32
//     row log-sum-exp of the scaled and biased logits, (B, H, Lq), which the
//     backward kernels of flash_attn_bwd.cu rebuild P from (the TPU kernel's
//     `return_lse` output); a null lse pointer skips that store;
//   * head dim 512 (the VAE mid-block's single 512-wide head, whose
//     64-row f32 accumulator does not fit in registers): 32 x 32 tiles on
//     WMMA with the output accumulator in shared memory (flash_fwd_kernel).
// Neither has asynchronous copies, wgmma or warp specialisation yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// Copy rows [r0, r0 + R) of a row-major (L, D) bf16 matrix into a (R, DP)
// shared tile with row stride LD, zero-filling rows >= L and columns >= D.
// D % 8 == 0.
template <int DP, int R, int LD = DP>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int r0,
                                          int L, int D) {
  constexpr int kChunks = DP / 8;
  for (int idx = threadIdx.x; idx < R * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < L && c < D) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * D + c);
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

template <int DP, int BM, int BN>
constexpr size_t smem_bytes() {
  return (size_t)BM * DP * 2 + 2 * (size_t)BN * DP * 2 + (size_t)BM * BN * 4 +
         (size_t)BM * BN * 2 + (size_t)BM * DP * 4 + 3 * (size_t)BM * 4;
}

template <int DP, int BM, int BN>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const float* __restrict__ bias, bf16* __restrict__ out,
                     int H, int Lq, int Lk, int D, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BM * DP;
  bf16* Vs = Ks + BN * DP;
  float* Ss = reinterpret_cast<float*>(Vs + BN * DP);
  bf16* Ps = reinterpret_cast<bf16*>(Ss + BM * BN);
  float* Os = reinterpret_cast<float*>(Ps + BM * BN);
  float* m_s = Os + BM * DP;
  float* l_s = m_s + BM;
  float* a_s = l_s + BM;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = blockIdx.x * BM;
  const bf16* qb = q + (size_t)bh * Lq * D;
  const bf16* kb = k + (size_t)bh * Lk * D;
  const bf16* vb = v + (size_t)bh * Lk * D;
  const float* bias_row = bias ? bias + (size_t)b * Lk : nullptr;

  load_rows<DP, BM>(Qs, qb, q0, Lq, D);
  for (int idx = threadIdx.x; idx < BM * DP; idx += kThreads) Os[idx] = 0.f;
  for (int r = threadIdx.x; r < BM; r += kThreads) {
    m_s[r] = -1e30f;  // the TPU kernel's NEG_INF: exp(m_prev - m_new) stays finite
    l_s[r] = 0.f;
  }

  for (int k0 = 0; k0 < Lk; k0 += BN) {
    __syncthreads();  // previous tile's P V is done with Ks / Vs / Ps
    load_rows<DP, BN>(Ks, kb, k0, Lk, D);
    load_rows<DP, BN>(Vs, vb, k0, Lk, D);
    __syncthreads();

    // S = Q K^T (unscaled), one 16x16 tile per warp at a time.
    for (int f = warp; f < (BM / 16) * (BN / 16); f += kWarps) {
      const int i = f / (BN / 16), j = f % (BN / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, Qs + i * 16 * DP + kk * 16, DP);
        wmma::load_matrix_sync(fb, Ks + j * 16 * DP + kk * 16, DP);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(Ss + i * 16 * BN + j * 16, acc, BN,
                              wmma::mem_row_major);
    }
    __syncthreads();

    // Online softmax, one warp per row. Keys past Lk get -inf (p = 0);
    // masked keys carry the caller's bias (-1e30), as on the TPU.
    for (int r = warp; r < BM; r += kWarps) {
      float mx = -INFINITY;
      for (int c = lane; c < BN; c += 32) {
        const int kc = k0 + c;
        float s = -INFINITY;
        if (kc < Lk) {
          s = Ss[r * BN + c] * scale;
          if (bias_row) s += bias_row[kc];
        }
        Ss[r * BN + c] = s;
        mx = fmaxf(mx, s);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = lane; c < BN; c += 32) {
        const bf16 p = __float2bfloat16(__expf(Ss[r * BN + c] - m_new));
        Ps[r * BN + c] = p;
        sum += __bfloat162float(p);  // normalise by the values P V uses
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = __expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    for (int idx = threadIdx.x; idx < BM * DP; idx += kThreads)
      Os[idx] *= a_s[idx / DP];
    __syncthreads();

    // O += P V.
    for (int f = warp; f < (BM / 16) * (DP / 16); f += kWarps) {
      const int i = f / (DP / 16), j = f % (DP / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, Os + i * 16 * DP + j * 16, DP,
                             wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, Ps + i * 16 * BN + kk * 16, BN);
        wmma::load_matrix_sync(fb, Vs + kk * 16 * DP + j * 16, DP);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(Os + i * 16 * DP + j * 16, acc, DP,
                              wmma::mem_row_major);
    }
  }
  __syncthreads();

  bf16* ob = out + (size_t)bh * Lq * D;
  for (int idx = threadIdx.x; idx < BM * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    if (q0 + r < Lq) {
      ob[(size_t)(q0 + r) * D + d] = __float2bfloat16(Os[r * DP + d] / l_s[r]);
    }
  }
}

template <int DP, int BM, int BN>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bias, void* out, int B, int H, int Lq, int Lk,
                   int D, float scale, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<DP, BM, BN>();
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<DP, BM, BN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid((Lq + BM - 1) / BM, B * H);
  flash_fwd_kernel<DP, BM, BN><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(bias),
      static_cast<bf16*>(out), H, Lq, Lk, D, scale);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// Head dims up to 160: FlashAttention-2 layout on mma.sync. Each warp owns
// 16 query rows; its Q fragments, the 16 x 64 score tile, P and the f32
// output accumulator stay in registers (the m16n8k16 fragment layout is
// fixed by the PTX ISA, so the row statistics and the rescale are done in
// place and P is repacked from the score registers as the A operand of
// P V). Shared memory holds the Q tile, one K tile and one transposed V
// tile (rows padded by 8 elements, so the 32-bit fragment loads of a warp
// hit distinct banks), and the tile's key bias in the log2 domain.

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_16816(float* d, const uint32_t* a,
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

constexpr int kRegBM = 64, kRegBN = 64;

template <int DP>
constexpr size_t reg_smem_bytes() {
  return (size_t)(kRegBM + kRegBN) * (DP + 8) * 2 + (size_t)DP * (kRegBN + 8) * 2 +
         (size_t)kRegBN * 4;
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_reg_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const float* __restrict__ bias, bf16* __restrict__ out,
                         float* __restrict__ lse, int H, int Lq, int Lk, int D,
                         float scale) {
  constexpr int BM = kRegBM, BN = kRegBN;
  constexpr int QS = DP + 8;   // row stride of the Q and K tiles
  constexpr int VS = BN + 8;   // row stride of the transposed V tile
  constexpr int NT = DP / 8;   // output n-tiles per warp
  constexpr int KT = DP / 16;  // k-steps of Q K^T
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BM * QS;
  bf16* Vt = Ks + BN * QS;
  float* Bs = reinterpret_cast<float*>(Vt + DP * VS);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = blockIdx.x * BM;
  const bf16* kb = k + (size_t)bh * Lk * D;
  const bf16* vb = v + (size_t)bh * Lk * D;
  const float* bias_row = bias ? bias + (size_t)b * Lk : nullptr;
  const float sl2 = scale * kLog2e;

  load_rows<DP, BM, QS>(Qs, q + (size_t)bh * Lq * D, q0, Lq, D);
  __syncthreads();
  uint32_t qf[KT][4];
  const bf16* qw = Qs + warp * 16 * QS;
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    qf[kk][0] = ld32(qw + g * QS + kk * 16 + 2 * t);
    qf[kk][1] = ld32(qw + (g + 8) * QS + kk * 16 + 2 * t);
    qf[kk][2] = ld32(qw + g * QS + kk * 16 + 8 + 2 * t);
    qf[kk][3] = ld32(qw + (g + 8) * QS + kk * 16 + 8 + 2 * t);
  }

  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  // Rows g and g + 8 of the warp's 16; statistics in the log2 domain.
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int k0 = 0; k0 < Lk; k0 += BN) {
    __syncthreads();  // every warp is done with the previous K / V tile
    load_rows<DP, BN, QS>(Ks, kb, k0, Lk, D);
    for (int idx = threadIdx.x; idx < BN * (DP / 8); idx += kThreads) {
      const int r = idx / (DP / 8), c = (idx % (DP / 8)) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < Lk && c < D)
        val = *reinterpret_cast<const uint4*>(vb + (size_t)(k0 + r) * D + c);
      const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
      for (int i = 0; i < 8; ++i) Vt[(c + i) * VS + r] = e[i];
    }
    for (int c = threadIdx.x; c < BN; c += kThreads) {
      const int key = k0 + c;
      Bs[c] = key < Lk ? (bias_row ? bias_row[key] * kLog2e : 0.f) : -INFINITY;
    }
    __syncthreads();

    float sc[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
      const bf16* kr = Ks + (j * 8 + g) * QS + 2 * t;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk)
        mma_16816(sc[j], qf[kk], ld32(kr + kk * 16), ld32(kr + kk * 16 + 8));
    }

    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float bb = Bs[j * 8 + 2 * t + e];
        sc[j][e] = sc[j][e] * sl2 + bb;
        sc[j][2 + e] = sc[j][2 + e] * sl2 + bb;
        mx0 = fmaxf(mx0, sc[j][e]);
        mx1 = fmaxf(mx1, sc[j][2 + e]);
      }
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    uint32_t pf[BN / 16][4];
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const uint32_t lo = pack_bf16(exp2f(sc[j][0] - m0), exp2f(sc[j][1] - m0));
      const uint32_t hi = pack_bf16(exp2f(sc[j][2] - m1), exp2f(sc[j][3] - m1));
      // Normalise by the rounded values that P V uses.
      const __nv_bfloat162 lo2 = *reinterpret_cast<const __nv_bfloat162*>(&lo);
      const __nv_bfloat162 hi2 = *reinterpret_cast<const __nv_bfloat162*>(&hi);
      sum0 += __low2float(lo2) + __high2float(lo2);
      sum1 += __low2float(hi2) + __high2float(hi2);
      pf[j / 2][(j % 2) * 2] = lo;
      pf[j / 2][(j % 2) * 2 + 1] = hi;
    }
    l0 = l0 * a0 + quad_sum(sum0);
    l1 = l1 * a1 + quad_sum(sum1);

#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= a0;
      o[n][1] *= a0;
      o[n][2] *= a1;
      o[n][3] *= a1;
      const bf16* vr = Vt + (n * 8 + g) * VS + 2 * t;
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        mma_16816(o[n], pf[kk], ld32(vr + kk * 16), ld32(vr + kk * 16 + 8));
    }
  }

  bf16* ob = out + (size_t)bh * Lq * D;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  if (lse != nullptr && t == 0) {
    // m and log2(l) are in the log2 domain: lse = (m + log2 l) * ln 2.
    constexpr float kLn2 = 0.6931471805599453f;
    if (r0 < Lq) lse[(size_t)bh * Lq + r0] = (m0 + __log2f(l0)) * kLn2;
    if (r1 < Lq) lse[(size_t)bh * Lq + r1] = (m1 + __log2f(l1)) * kLn2;
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int d = n * 8 + 2 * t;
    if (d >= D) continue;
    if (r0 < Lq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r0 * D + d) =
          __floats2bfloat162_rn(o[n][0] * inv0, o[n][1] * inv0);
    if (r1 < Lq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r1 * D + d) =
          __floats2bfloat162_rn(o[n][2] * inv1, o[n][3] * inv1);
  }
}

template <int DP>
cudaError_t launch_reg(const void* q, const void* k, const void* v,
                       const void* bias, void* out, void* lse, int B, int H,
                       int Lq, int Lk, int D, float scale, cudaStream_t stream) {
  constexpr size_t bytes = reg_smem_bytes<DP>();
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_reg_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid((Lq + kRegBM - 1) / kRegBM, B * H);
  flash_fwd_reg_kernel<DP><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(bias),
      static_cast<bf16*>(out), static_cast<float*>(lse), H, Lq, Lk, D, scale);
  return cudaGetLastError();
}

}  // namespace

// Head dims served: D % 8 == 0 with D rounded up to 32, 48, 64, 80, 160
// (the UNet) or 512 (the VAE, forward only: no lse); any other returns
// cudaErrorInvalidValue. lse may be null; when not, f32 (B, H, Lq).
extern "C" int mvldm_flash_attn_fwd(const void* q, const void* k,
                                    const void* v, const void* bias, void* out,
                                    void* lse, int B, int H, int Lq, int Lk,
                                    int D, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dp = (D + 15) / 16 * 16;
  if (D % 8 != 0 || Lq <= 0 || Lk <= 0 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  switch (dp) {
    case 32: return (int)launch_reg<32>(q, k, v, bias, out, lse, B, H, Lq, Lk, D, scale, s);
    case 48: return (int)launch_reg<48>(q, k, v, bias, out, lse, B, H, Lq, Lk, D, scale, s);
    case 64: return (int)launch_reg<64>(q, k, v, bias, out, lse, B, H, Lq, Lk, D, scale, s);
    case 80: return (int)launch_reg<80>(q, k, v, bias, out, lse, B, H, Lq, Lk, D, scale, s);
    case 160: return (int)launch_reg<160>(q, k, v, bias, out, lse, B, H, Lq, Lk, D, scale, s);
    case 512:
      if (lse != nullptr) return (int)cudaErrorInvalidValue;
      return (int)launch<512, 32, 32>(q, k, v, bias, out, B, H, Lq, Lk, D, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
