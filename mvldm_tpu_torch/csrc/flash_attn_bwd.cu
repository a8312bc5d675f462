// Flash attention backward for Hopper (sm_90a): dQ, dK, dV and the key-bias
// gradient from the forward's residuals (q, k, v, out and the f32 row
// log-sum-exp that flash_attn_fwd.cu writes), bf16 in / bf16 out.
//
// Replaces the TPU kernels `_flash_bwd_dq_kernel` and `_flash_bwd_dkv_kernel`
// behind `flash_attention_bwd` in mvldm_tpu/ops/attention.py (the
// FlashAttention-2 backward). With s = scale * q k^T + bias:
//   p  = exp(s - lse)                 (rebuilt per tile, never stored)
//   dp = dO v^T,  ds = p * (dp - delta),  delta = rowsum(dO * O)
//   dq = scale * ds k,  dk = scale * ds^T q,  dv = p^T dO,
//   dbias[b*h, key] = sum over queries of ds (unscaled; the wrapper sums it
//   over heads).
//
// What bounds it on this card: like the forward, ~10 * L^2 * D flops (five
// L x L x D products over the two kernels) against ~8 * L * D bytes, far above
// the H100's ~295 flop/byte ridge at the joint cross-view shape (L = 5120),
// so it is bound by tensor-core operations, and no L x L tile may reach
// device memory. Two kernels, each on mma.sync m16n8k16 (bf16 in, f32
// accumulate), 4 warps, 16 rows per warp:
//   * mvldm_flash_attn_bwd_dq: one block per (batch * head, 64-query tile)
//     walks the key tiles (keys innermost, as on the TPU); its prologue
//     computes delta for its rows and writes it for the second kernel;
//   * mvldm_flash_attn_bwd_dkv: one block per (batch * head, 64-key tile)
//     walks the query tiles; the block's rows are keys, so it computes the
//     transposed tiles S^T = K Q^T and dP^T = V dO^T and its dK / dV
//     accumulators are per-warp registers. At head dim 160 two 16 x 160 f32
//     accumulators per warp do not fit in registers beside the score
//     tiles, so dK accumulates in shared memory there (each warp owns its
//     16 rows, no barrier needed).
// Head dims are padded to a multiple of 16 in shared memory only
// (zero-filled columns). Ragged lengths are masked in the kernels: keys past
// Lk get p = 0 (bias -inf), queries past Lq get lse = +inf (p = 0) and
// dO = 0, delta = 0 (ds = 0); nothing is padded in device memory. No
// asynchronous copies, wgmma or warp specialisation yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 64;  // block rows: queries (dQ) or keys (dK/dV)
constexpr int kCols = 64;  // inner tile: keys (dQ) or queries (dK/dV)
constexpr float kLog2e = 1.4426950408889634f;

// Copy rows [r0, r0 + R) of a row-major (L, D) bf16 matrix into a (R, DP)
// shared tile with row stride LD, zero-filling rows >= L and columns >= D.
// With a non-null `dst_t`, also store the transpose, (DP, R) with row
// stride LDT. D % 8 == 0.
template <int DP, int R, int LD, int LDT = 0>
__device__ __forceinline__ void load_rows(bf16* dst, bf16* dst_t,
                                          const bf16* src, int r0, int L,
                                          int D) {
  constexpr int kChunks = DP / 8;
  for (int idx = threadIdx.x; idx < R * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < L && c < D)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
    if (LDT > 0 && dst_t != nullptr) {
      const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
      for (int i = 0; i < 8; ++i) dst_t[(c + i) * LDT + r] = e[i];
    }
  }
}

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

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// A fragment (16 x 16, k-step kk) of a warp's 16 rows of a row-major tile.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* rows, int g,
                                       int t, int kk) {
  const bf16* p = rows + kk * 16 + 2 * t;
  a[0] = ld32(p + g * LD);
  a[1] = ld32(p + (g + 8) * LD);
  a[2] = ld32(p + g * LD + 8);
  a[3] = ld32(p + (g + 8) * LD + 8);
}

// m16n8k16 B fragment of n-tile n, k-step kk, from a tile stored with the
// n index as its row: B[k][n] = tile[n][k].
template <int LD>
__device__ __forceinline__ void mma_b(float* d, const uint32_t* a,
                                      const bf16* tile, int g, int t, int n,
                                      int kk) {
  const bf16* p = tile + (n * 8 + g) * LD + kk * 16 + 2 * t;
  mma_16816(d, a, ld32(p), ld32(p + 8));
}

// ------------------------------------------------------------------ dQ

template <int DP>
constexpr size_t dq_smem_bytes() {
  return (size_t)(2 * kRows + 2 * kCols) * (DP + 8) * 2 +
         (size_t)DP * (kCols + 8) * 2 + (size_t)kCols * 4;
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ out,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ bias,
                        float* __restrict__ delta, bf16* __restrict__ dq,
                        int H, int Lq, int Lk, int D, float scale) {
  constexpr int QS = DP + 8;      // row stride of Q, dO, K, V tiles
  constexpr int TS = kCols + 8;   // row stride of the transposed K tile
  constexpr int NT = DP / 8;      // dq n-tiles per warp
  constexpr int KT = DP / 16;     // k-steps over the head dim
  constexpr int CT = kCols / 8;   // score n-tiles per warp
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + kRows * QS;
  bf16* Ks = dOs + kRows * QS;
  bf16* Vs = Ks + kCols * QS;
  bf16* Kt = Vs + kCols * QS;
  float* Bs = reinterpret_cast<float*>(Kt + DP * TS);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = blockIdx.x * kRows;
  const size_t qoff = (size_t)bh * Lq * D;
  const size_t koff = (size_t)bh * Lk * D;
  const float* bias_row = bias ? bias + (size_t)b * Lk : nullptr;
  const float sl2 = scale * kLog2e;

  load_rows<DP, kRows, QS>(Qs, nullptr, q + qoff, q0, Lq, D);
  load_rows<DP, kRows, QS>(dOs, nullptr, dout + qoff, q0, Lq, D);
  __syncthreads();

  // Prologue: delta = rowsum(dO * O) in f32 for the warp's 16 rows, kept for
  // rows g and g + 8 and written for the dK/dV kernel.
  const bf16* Qw = Qs + warp * 16 * QS;
  const bf16* dOw = dOs + warp * 16 * QS;
  float dl0 = 0.f, dl1 = 0.f;
  for (int i = 0; i < 16; ++i) {
    const int r = q0 + warp * 16 + i;
    float acc = 0.f;
    if (r < Lq) {
      const bf16* orow = out + qoff + (size_t)r * D;
      for (int d = lane; d < D; d += 32)
        acc += __bfloat162float(orow[d]) * __bfloat162float(dOw[i * QS + d]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (i == g) dl0 = acc;
    if (i == g + 8) dl1 = acc;
    if (lane == 0 && r < Lq) delta[(size_t)bh * Lq + r] = acc;
  }
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const float lse0 = r0 < Lq ? lse[(size_t)bh * Lq + r0] * kLog2e : INFINITY;
  const float lse1 = r1 < Lq ? lse[(size_t)bh * Lq + r1] * kLog2e : INFINITY;

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int k0 = 0; k0 < Lk; k0 += kCols) {
    __syncthreads();  // every warp is done with the previous K / V tile
    load_rows<DP, kCols, QS, TS>(Ks, Kt, k + koff, k0, Lk, D);
    load_rows<DP, kCols, QS>(Vs, nullptr, v + koff, k0, Lk, D);
    for (int c = threadIdx.x; c < kCols; c += kThreads) {
      const int key = k0 + c;
      Bs[c] = key < Lk ? (bias_row ? bias_row[key] * kLog2e : 0.f) : -INFINITY;
    }
    __syncthreads();

    // P = exp(scale * Q K^T + bias - lse), in the log2 domain.
    float s[CT][4];
#pragma unroll
    for (int j = 0; j < CT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t a[4];
      load_a<QS>(a, Qw, g, t, kk);
#pragma unroll
      for (int j = 0; j < CT; ++j) mma_b<QS>(s[j], a, Ks, g, t, j, kk);
    }
#pragma unroll
    for (int j = 0; j < CT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float bb = Bs[j * 8 + 2 * t + e];
        s[j][e] = exp2f(s[j][e] * sl2 + bb - lse0);
        s[j][2 + e] = exp2f(s[j][2 + e] * sl2 + bb - lse1);
      }
    }

    // dP = dO V^T; dS = P * (dP - delta), packed as the A operand of dS K.
    float dp[CT][4];
#pragma unroll
    for (int j = 0; j < CT; ++j) dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t a[4];
      load_a<QS>(a, dOw, g, t, kk);
#pragma unroll
      for (int j = 0; j < CT; ++j) mma_b<QS>(dp[j], a, Vs, g, t, j, kk);
    }
    uint32_t dsf[kCols / 16][4];
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      dsf[j / 2][(j % 2) * 2] =
          pack_bf16(s[j][0] * (dp[j][0] - dl0), s[j][1] * (dp[j][1] - dl0));
      dsf[j / 2][(j % 2) * 2 + 1] =
          pack_bf16(s[j][2] * (dp[j][2] - dl1), s[j][3] * (dp[j][3] - dl1));
    }

    // dQ += dS K.
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int kk = 0; kk < kCols / 16; ++kk) mma_b<TS>(acc[n], dsf[kk], Kt, g, t, n, kk);
    }
  }

  bf16* dqb = dq + qoff;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int d = n * 8 + 2 * t;
    if (d >= D) continue;
    if (r0 < Lq)
      *reinterpret_cast<__nv_bfloat162*>(dqb + (size_t)r0 * D + d) =
          __floats2bfloat162_rn(acc[n][0] * scale, acc[n][1] * scale);
    if (r1 < Lq)
      *reinterpret_cast<__nv_bfloat162*>(dqb + (size_t)r1 * D + d) =
          __floats2bfloat162_rn(acc[n][2] * scale, acc[n][3] * scale);
  }
}

// -------------------------------------------------------------- dK / dV

// Head dims above 80 keep the dK accumulator in shared memory.
constexpr int kMaxDkRegDP = 80;

template <int DP>
constexpr size_t dkv_smem_bytes() {
  return (size_t)(2 * kRows + 2 * kCols) * (DP + 8) * 2 +
         2 * (size_t)DP * (kCols + 8) * 2 + 2 * (size_t)kCols * 4 +
         (DP > kMaxDkRegDP ? (size_t)kRows * (DP + 4) * 4 : 0);
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const float* __restrict__ bias, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, float* __restrict__ dbias,
                         int H, int Lq, int Lk, int D, float scale) {
  constexpr int QS = DP + 8;      // row stride of K, V, Q, dO tiles
  constexpr int TS = kCols + 8;   // row stride of the transposed Q, dO tiles
  constexpr int AS = DP + 4;      // row stride of the shared dK accumulator
  constexpr int NT = DP / 8;
  constexpr int KT = DP / 16;
  constexpr int CT = kCols / 8;
  constexpr bool kDkSmem = DP > kMaxDkRegDP;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + kRows * QS;
  bf16* Qs = Vs + kRows * QS;
  bf16* dOs = Qs + kCols * QS;
  bf16* Qt = dOs + kCols * QS;
  bf16* dOt = Qt + DP * TS;
  float* Ls = reinterpret_cast<float*>(dOt + DP * TS);
  float* Dl = Ls + kCols;
  float* dKs = Dl + kCols;  // (kRows, AS) f32, only when kDkSmem

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int k0 = blockIdx.x * kRows;
  const size_t qoff = (size_t)bh * Lq * D;
  const size_t koff = (size_t)bh * Lk * D;
  const float sl2 = scale * kLog2e;

  load_rows<DP, kRows, QS>(Ks, nullptr, k + koff, k0, Lk, D);
  load_rows<DP, kRows, QS>(Vs, nullptr, v + koff, k0, Lk, D);
  if (kDkSmem) {
    for (int i = threadIdx.x; i < kRows * AS; i += kThreads) dKs[i] = 0.f;
  }
  // The warp's rows are keys key0 = k0 + 16 * warp + g and key1 = key0 + 8.
  const int key0 = k0 + warp * 16 + g, key1 = key0 + 8;
  const float* bias_row = bias ? bias + (size_t)b * Lk : nullptr;
  const float bb0 = key0 < Lk ? (bias_row ? bias_row[key0] * kLog2e : 0.f) : -INFINITY;
  const float bb1 = key1 < Lk ? (bias_row ? bias_row[key1] * kLog2e : 0.f) : -INFINITY;
  const bf16* Kw = Ks + warp * 16 * QS;
  const bf16* Vw = Vs + warp * 16 * QS;
  float* dKw = dKs + warp * 16 * AS;

  float dva[NT][4];
  float dka[kDkSmem ? 1 : NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
#pragma unroll
  for (int n = 0; n < (kDkSmem ? 1 : NT); ++n)
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
  float db0 = 0.f, db1 = 0.f;

  for (int q0 = 0; q0 < Lq; q0 += kCols) {
    __syncthreads();  // every warp is done with the previous Q / dO tile
    load_rows<DP, kCols, QS, TS>(Qs, Qt, q + qoff, q0, Lq, D);
    load_rows<DP, kCols, QS, TS>(dOs, dOt, dout + qoff, q0, Lq, D);
    for (int c = threadIdx.x; c < kCols; c += kThreads) {
      const int qi = q0 + c;
      Ls[c] = qi < Lq ? lse[(size_t)bh * Lq + qi] * kLog2e : INFINITY;
      Dl[c] = qi < Lq ? delta[(size_t)bh * Lq + qi] : 0.f;
    }
    __syncthreads();

    // P^T = exp(scale * K Q^T + bias - lse): rows keys, columns queries.
    float s[CT][4];
#pragma unroll
    for (int j = 0; j < CT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t a[4];
      load_a<QS>(a, Kw, g, t, kk);
#pragma unroll
      for (int j = 0; j < CT; ++j) mma_b<QS>(s[j], a, Qs, g, t, j, kk);
    }
#pragma unroll
    for (int j = 0; j < CT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float l = Ls[j * 8 + 2 * t + e];
        s[j][e] = exp2f(s[j][e] * sl2 + bb0 - l);
        s[j][2 + e] = exp2f(s[j][2 + e] * sl2 + bb1 - l);
      }
    }

    // dP^T = V dO^T, then dS^T = P^T * (dP^T - delta) in place.
    float dp[CT][4];
#pragma unroll
    for (int j = 0; j < CT; ++j) dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t a[4];
      load_a<QS>(a, Vw, g, t, kk);
#pragma unroll
      for (int j = 0; j < CT; ++j) mma_b<QS>(dp[j], a, dOs, g, t, j, kk);
    }
#pragma unroll
    for (int j = 0; j < CT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float dl = Dl[j * 8 + 2 * t + e];
        dp[j][e] = s[j][e] * (dp[j][e] - dl);
        dp[j][2 + e] = s[j][2 + e] * (dp[j][2 + e] - dl);
        db0 += dp[j][e];
        db1 += dp[j][2 + e];
      }
    }

    // dV += P^T dO.
    {
      uint32_t pf[kCols / 16][4];
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        pf[j / 2][(j % 2) * 2] = pack_bf16(s[j][0], s[j][1]);
        pf[j / 2][(j % 2) * 2 + 1] = pack_bf16(s[j][2], s[j][3]);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int kk = 0; kk < kCols / 16; ++kk) mma_b<TS>(dva[n], pf[kk], dOt, g, t, n, kk);
      }
    }

    // dK += dS^T Q.
    uint32_t dsf[kCols / 16][4];
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      dsf[j / 2][(j % 2) * 2] = pack_bf16(dp[j][0], dp[j][1]);
      dsf[j / 2][(j % 2) * 2 + 1] = pack_bf16(dp[j][2], dp[j][3]);
    }
    if constexpr (kDkSmem) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        float* c0 = dKw + g * AS + n * 8 + 2 * t;
        float* c1 = c0 + 8 * AS;
        float c[4] = {c0[0], c0[1], c1[0], c1[1]};
#pragma unroll
        for (int kk = 0; kk < kCols / 16; ++kk) mma_b<TS>(c, dsf[kk], Qt, g, t, n, kk);
        c0[0] = c[0];
        c0[1] = c[1];
        c1[0] = c[2];
        c1[1] = c[3];
      }
    } else {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int kk = 0; kk < kCols / 16; ++kk) mma_b<TS>(dka[n], dsf[kk], Qt, g, t, n, kk);
      }
    }
  }

  bf16* dkb = dk + koff;
  bf16* dvb = dv + koff;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int d = n * 8 + 2 * t;
    if (d >= D) continue;
    float c[4];
    if constexpr (kDkSmem) {
      const float* c0 = dKw + g * AS + d;
      c[0] = c0[0];
      c[1] = c0[1];
      c[2] = c0[8 * AS];
      c[3] = c0[8 * AS + 1];
    } else {
      c[0] = dka[n][0];
      c[1] = dka[n][1];
      c[2] = dka[n][2];
      c[3] = dka[n][3];
    }
    if (key0 < Lk) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + (size_t)key0 * D + d) =
          __floats2bfloat162_rn(c[0] * scale, c[1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + (size_t)key0 * D + d) =
          __floats2bfloat162_rn(dva[n][0], dva[n][1]);
    }
    if (key1 < Lk) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + (size_t)key1 * D + d) =
          __floats2bfloat162_rn(c[2] * scale, c[3] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + (size_t)key1 * D + d) =
          __floats2bfloat162_rn(dva[n][2], dva[n][3]);
    }
  }
  db0 = quad_sum(db0);
  db1 = quad_sum(db1);
  if (dbias != nullptr && t == 0) {
    if (key0 < Lk) dbias[(size_t)bh * Lk + key0] = db0;
    if (key1 < Lk) dbias[(size_t)bh * Lk + key1] = db1;
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes, bool& configured) {
  if (configured) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) configured = true;
  return err;
}

template <int DP>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* out, const void* dout, const void* lse,
                      const void* bias, void* delta, void* dq, int B, int H,
                      int Lq, int Lk, int D, float scale, cudaStream_t stream) {
  constexpr size_t bytes = dq_smem_bytes<DP>();
  static bool configured = false;
  cudaError_t err = set_smem(flash_bwd_dq_kernel<DP>, bytes, configured);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + kRows - 1) / kRows, B * H);
  flash_bwd_dq_kernel<DP><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(out),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(bias), static_cast<float*>(delta),
      static_cast<bf16*>(dq), H, Lq, Lk, D, scale);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       const void* bias, void* dk, void* dv, void* dbias,
                       int B, int H, int Lq, int Lk, int D, float scale,
                       cudaStream_t stream) {
  constexpr size_t bytes = dkv_smem_bytes<DP>();
  static bool configured = false;
  cudaError_t err = set_smem(flash_bwd_dkv_kernel<DP>, bytes, configured);
  if (err != cudaSuccess) return err;
  dim3 grid((Lk + kRows - 1) / kRows, B * H);
  flash_bwd_dkv_kernel<DP><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(bias), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), static_cast<float*>(dbias), H, Lq, Lk, D, scale);
  return cudaGetLastError();
}

bool valid(int B, int H, int Lq, int Lk, int D) {
  return D % 8 == 0 && Lq > 0 && Lk > 0 && B * H <= 65535;
}

}  // namespace

// Head dims served: D % 8 == 0 with D rounded up to 32, 48, 64, 80 or 160;
// any other returns cudaErrorInvalidValue. q, out, dout, dq: (B, H, Lq, D);
// k, v, dk, dv: (B, H, Lk, D), all bf16; lse and delta: f32 (B, H, Lq);
// bias: null or f32 (B, Lk); dbias: null or f32 (B, H, Lk).

// dQ, and delta = rowsum(dout * out) written for mvldm_flash_attn_bwd_dkv.
extern "C" int mvldm_flash_attn_bwd_dq(const void* q, const void* k,
                                       const void* v, const void* out,
                                       const void* dout, const void* lse,
                                       const void* bias, void* delta, void* dq,
                                       int B, int H, int Lq, int Lk, int D,
                                       float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!valid(B, H, Lq, Lk, D)) return (int)cudaErrorInvalidValue;
  switch ((D + 15) / 16 * 16) {
    case 32: return (int)launch_dq<32>(q, k, v, out, dout, lse, bias, delta, dq, B, H, Lq, Lk, D, scale, s);
    case 48: return (int)launch_dq<48>(q, k, v, out, dout, lse, bias, delta, dq, B, H, Lq, Lk, D, scale, s);
    case 64: return (int)launch_dq<64>(q, k, v, out, dout, lse, bias, delta, dq, B, H, Lq, Lk, D, scale, s);
    case 80: return (int)launch_dq<80>(q, k, v, out, dout, lse, bias, delta, dq, B, H, Lq, Lk, D, scale, s);
    case 160: return (int)launch_dq<160>(q, k, v, out, dout, lse, bias, delta, dq, B, H, Lq, Lk, D, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dK, dV and (when dbias is not null; needs bias) the per-head key-bias
// gradient, from delta as mvldm_flash_attn_bwd_dq wrote it.
extern "C" int mvldm_flash_attn_bwd_dkv(const void* q, const void* k,
                                        const void* v, const void* dout,
                                        const void* lse, const void* delta,
                                        const void* bias, void* dk, void* dv,
                                        void* dbias, int B, int H, int Lq,
                                        int Lk, int D, float scale,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!valid(B, H, Lq, Lk, D) || (dbias != nullptr && bias == nullptr))
    return (int)cudaErrorInvalidValue;
  switch ((D + 15) / 16 * 16) {
    case 32: return (int)launch_dkv<32>(q, k, v, dout, lse, delta, bias, dk, dv, dbias, B, H, Lq, Lk, D, scale, s);
    case 48: return (int)launch_dkv<48>(q, k, v, dout, lse, delta, bias, dk, dv, dbias, B, H, Lq, Lk, D, scale, s);
    case 64: return (int)launch_dkv<64>(q, k, v, dout, lse, delta, bias, dk, dv, dbias, B, H, Lq, Lk, D, scale, s);
    case 80: return (int)launch_dkv<80>(q, k, v, dout, lse, delta, bias, dk, dv, dbias, B, H, Lq, Lk, D, scale, s);
    case 160: return (int)launch_dkv<160>(q, k, v, dout, lse, delta, bias, dk, dv, dbias, B, H, Lq, Lk, D, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
