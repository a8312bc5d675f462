// Flash attention backward for Hopper (sm_90a): dQ, dK, dV and the key-bias
// gradient from the forward's residuals (q, k, v, out and the f32 row
// log-sum-exp that flash_attn_fwd.cu writes), bf16 in / bf16 out.
//
// Replaces the TPU kernels `_flash_bwd_dq_kernel` (mvldm_tpu/ops/attention.py
// :282, keys innermost) and `_flash_bwd_dkv_kernel` (:324, queries innermost)
// behind `flash_attention_bwd` (the FlashAttention-2 backward). With
// s = scale * q k^T + bias:
//   p  = exp(s - lse)                 (rebuilt per tile, never stored)
//   dp = dO v^T,  ds = p * (dp - delta),  delta = rowsum(dO * O)
//   dq = scale * ds k,  dk = scale * ds^T q,  dv = p^T dO,
//   dbias[b*h, key] = sum over queries of ds (unscaled; the wrapper sums it
//   over heads).
//
// What bounds it on this card: the five L x L x D products (seven here, as
// S and dP are rebuilt in both kernels so that dQ needs no atomics) are far
// above the H100's ~295 flop/byte ridge at the training shapes, so tensor
// operations bound it; and at D = 40 the exponentials are a second bound of
// the same size: L^2 exp2 per (batch, head) per kernel at 16 a clock per SM
// take about as long as each kernel's products at the bf16 tensor rate.
//
// Design (hopper_tile.cuh holds the pieces): blocks of two warpgroups, each
// warpgroup owning 64 rows, so both share every streamed tile.
//   * mvldm_flash_attn_bwd_dkv: one block per (batch * head, 128 keys)
//     keeps K and V resident and its dK / dV accumulators in registers, and
//     walks the query tiles (queries innermost, as on the TPU) through a
//     three-stage ring of Q, dO, lse and delta tiles filled by cp.async, two
//     tiles ahead of the one in use. S^T = K Q^T and dP^T = V dO^T run on
//     wgmma with both operands in shared memory; exp2 of S^T runs while dP^T
//     is still in the tensor cores; dV += P^T dO and dK += dS^T Q run on
//     wgmma with A = P^T / dS^T packed to bf16 from the accumulator
//     registers and B read MN-major from the same Q / dO tiles, so no
//     transposed copy is made. dbias is the row sum of dS^T in registers.
//     At D = 160 the query tiles are 32 wide, so that the two 64 x 160 f32
//     accumulators and the score tiles fit in registers.
//   * mvldm_flash_attn_bwd_dq: one block per (batch * head, 128 queries)
//     keeps Q and dO resident and walks the key tiles through the same
//     ring (K, V, bias); S = Q K^T and dP = dO V^T from shared memory,
//     dQ += dS K with B = K read MN-major. Its prologue computes delta for
//     its rows with 16-byte loads and writes it for the dK/dV kernel.
// The exponentials of one warpgroup overlap the products of the other
// warpgroups resident on the SM. Tiles sit in shared memory in wgmma's
// no-swizzle blocked layout; D is padded to a multiple of 16 there only
// (40 -> 48), the D-wide products use N = D (m64n40). Ragged lengths are
// masked in the kernels: keys past Lk get p = 0 in dQ (bias -inf) and are
// not stored by dK/dV, queries past Lq get lse = +inf (p = 0) and dO = 0,
// delta = 0 (ds = 0) in dK/dV; rows past the end arrive zero-filled and
// nothing is padded in device memory.
#include "attn_tile.cuh"    // quad_sum
#include "hopper_tile.cuh"  // cp.async ring, wgmma, exp2_ftz, pack_a

namespace {

using attn_tile::quad_sum;
using namespace hopper_tile;

constexpr int kThreads = 256;  // two warpgroups
constexpr int kRows = 128;     // block rows: queries (dQ) or keys (dK/dV)
constexpr int kStages = 3;     // ring depth
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr int pad16(int d) { return (d + 15) / 16 * 16; }

// ------------------------------------------------------------------ dQ

template <int DN>
constexpr size_t dq_smem_bytes() {
  return ((size_t)2 * kRows + (size_t)kStages * 2 * 64) * pad16(DN) * 2 +
         (size_t)kStages * 64 * 4 + (size_t)kRows * 4;
}

template <int DN>
__global__ void __launch_bounds__(kThreads, DN <= 64 ? 2 : 1)
    flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ out,
                        const bf16* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ bias, float* __restrict__ delta,
                        bf16* __restrict__ dq, int H, int Lq, int Lk, int D, float scale) {
  constexpr int KP = pad16(DN);
  constexpr int BK = 64;  // keys per ring stage
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + kRows * KP;
  bf16* ring = dOs + kRows * KP;  // [stage][K tile | V tile]
  float* Bs = reinterpret_cast<float*>(ring + kStages * 2 * BK * KP);  // [stage][BK]
  float* Dls = Bs + kStages * BK;                                       // [kRows]

  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / H;
  const int q0 = blockIdx.x * kRows;
  const size_t qoff = (size_t)bh * Lq * D, koff = (size_t)bh * Lk * D;
  const float sl2 = scale * kLog2e;
  const int nk = (Lk + BK - 1) / BK;

  if (D < KP) {
    zero_pad_cols<kRows, KP, kThreads>(Qs, D);
    zero_pad_cols<kRows, KP, kThreads>(dOs, D);
    for (int s = 0; s < 2 * kStages; ++s) zero_pad_cols<BK, KP, kThreads>(ring + s * BK * KP, D);
  }
  auto load_kv = [&](int j) {  // key tile j into stage j % kStages
    if (j < nk) {
      const int s = j % kStages, k0 = j * BK;
      load_tile_async<BK, KP, kThreads>(ring + s * 2 * BK * KP, k + koff + (size_t)k0 * D,
                                        Lk - k0, D);
      load_tile_async<BK, KP, kThreads>(ring + (s * 2 + 1) * BK * KP,
                                        v + koff + (size_t)k0 * D, Lk - k0, D);
      if (tid < BK) {
        const int key = k0 + tid;
        float* dst = Bs + s * BK + tid;
        if (key >= Lk) *dst = -INFINITY;
        else if (bias != nullptr) cp_async4(dst, bias + (size_t)b * Lk + key);
        else *dst = 0.f;
      }
    }
    cp_async_commit();
  };
  load_tile_async<kRows, KP, kThreads>(Qs, q + qoff + (size_t)q0 * D, Lq - q0, D);
  load_tile_async<kRows, KP, kThreads>(dOs, dout + qoff + (size_t)q0 * D, Lq - q0, D);
  for (int j = 0; j < kStages - 1; ++j) load_kv(j);

  // Prologue: delta = rowsum(dO * O) in f32, one row per thread of the
  // first warpgroup, written for the dK/dV kernel.
  if (tid < kRows) {
    const int r = q0 + tid;
    float acc = 0.f;
    if (r < Lq) {
      const uint4* o4 = reinterpret_cast<const uint4*>(out + qoff + (size_t)r * D);
      const uint4* g4 = reinterpret_cast<const uint4*>(dout + qoff + (size_t)r * D);
      for (int c = 0; c < D / 8; ++c) {
        const uint4 ov = o4[c], gv = g4[c];
        const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* gp = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 of = __bfloat1622float2(op[i]), gf = __bfloat1622float2(gp[i]);
          acc = fmaf(of.x, gf.x, acc);
          acc = fmaf(of.y, gf.y, acc);
        }
      }
      delta[(size_t)bh * Lq + r] = acc;
    }
    Dls[tid] = acc;
  }
  __syncthreads();

  // The thread's rows: r0 = q0 + 64 wg + 16 warp + g and r1 = r0 + 8.
  const int lr0 = wg * 64 + (tid % 128) / 32 * 16 + g;
  const int r0 = q0 + lr0, r1 = r0 + 8;
  const float dl0 = Dls[lr0], dl1 = Dls[lr0 + 8];
  const float lse0 = r0 < Lq ? lse[(size_t)bh * Lq + r0] * kLog2e : 0.f;
  const float lse1 = r1 < Lq ? lse[(size_t)bh * Lq + r1] * kLog2e : 0.f;
  const bool active = q0 + wg * 64 < Lq;  // warpgroup-uniform

  float acc[DN / 2];
#pragma unroll
  for (int i = 0; i < DN / 2; ++i) acc[i] = 0.f;

  for (int j = 0; j < nk; ++j) {
    cp_async_wait<kStages - 2>();
    fence_proxy_async();
    __syncthreads();  // tile j is in; every warpgroup is done with stage (j - 1)
    load_kv(j + kStages - 1);
    if (!active) continue;
    const int st = j % kStages;
    const bf16* Kt = ring + st * 2 * BK * KP;
    const bf16* Vt = Kt + BK * KP;
    const float* Bt = Bs + st * BK;

    // S = Q K^T and dP = dO V^T, issued together; exp2 of S overlaps dP.
    float s[BK / 2], dp[BK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KP / 16; ++kk)
      wgmma_ss<BK>(s, desc_k_major<KP>(Qs, wg * 8, kk), desc_k_major<KP>(Kt, 0, kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < KP / 16; ++kk)
      wgmma_ss<BK>(dp, desc_k_major<KP>(dOs, wg * 8, kk), desc_k_major<KP>(Vt, 0, kk), kk);
    wgmma_commit();
    wgmma_wait<1>();
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float bb = Bt[n * 8 + 2 * t + e] * kLog2e;
        s[4 * n + e] = exp2_ftz(fmaf(s[4 * n + e], sl2, bb) - lse0);
        s[4 * n + 2 + e] = exp2_ftz(fmaf(s[4 * n + 2 + e], sl2, bb) - lse1);
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        dp[4 * n + e] = s[4 * n + e] * (dp[4 * n + e] - dl0);
        dp[4 * n + 2 + e] = s[4 * n + 2 + e] * (dp[4 * n + 2 + e] - dl1);
      }
    }

    // dQ += dS K, K read MN-major from the tile S was computed from.
    uint32_t da[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) pack_a(da[kk], dp, kk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs<DN, 1>(acc, da[kk], desc_mn_major<KP>(Kt, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
  }
  cp_async_wait<0>();

  bf16* dqb = dq + qoff;
#pragma unroll
  for (int n = 0; n < DN / 8; ++n) {
    const int d = n * 8 + 2 * t;
    if (d >= D) continue;
    if (r0 < Lq)
      *reinterpret_cast<__nv_bfloat162*>(dqb + (size_t)r0 * D + d) =
          __floats2bfloat162_rn(acc[4 * n] * scale, acc[4 * n + 1] * scale);
    if (r1 < Lq)
      *reinterpret_cast<__nv_bfloat162*>(dqb + (size_t)r1 * D + d) =
          __floats2bfloat162_rn(acc[4 * n + 2] * scale, acc[4 * n + 3] * scale);
  }
}

// -------------------------------------------------------------- dK / dV

// Query tile width: 64, or 32 at D = 160 (registers).
template <int DN>
__host__ __device__ constexpr int dkv_bq() { return DN > 80 ? 32 : 64; }

template <int DN>
constexpr size_t dkv_smem_bytes() {
  return ((size_t)2 * kRows + (size_t)kStages * 2 * dkv_bq<DN>()) * pad16(DN) * 2 +
         (size_t)kStages * 2 * dkv_bq<DN>() * 4;
}

template <int DN>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const float* __restrict__ bias, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, float* __restrict__ dbias, int H, int Lq,
                         int Lk, int D, float scale) {
  constexpr int KP = pad16(DN);
  constexpr int BQ = dkv_bq<DN>();
  constexpr bool kRegA = KP <= 64;  // K and V as register A operands
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + kRows * KP;
  bf16* ring = Vs + kRows * KP;  // [stage][Q tile | dO tile]
  float* stats = reinterpret_cast<float*>(ring + kStages * 2 * BQ * KP);  // [stage][lse | delta]

  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / H;
  const int k0 = blockIdx.x * kRows;
  const size_t qoff = (size_t)bh * Lq * D, koff = (size_t)bh * Lk * D;
  const float sl2 = scale * kLog2e;
  const int nq = (Lq + BQ - 1) / BQ;

  if (D < KP) {
    zero_pad_cols<kRows, KP, kThreads>(Ks, D);
    zero_pad_cols<kRows, KP, kThreads>(Vs, D);
    for (int s = 0; s < 2 * kStages; ++s) zero_pad_cols<BQ, KP, kThreads>(ring + s * BQ * KP, D);
  }
  auto load_q = [&](int j) {  // query tile j into stage j % kStages
    if (j < nq) {
      const int s = j % kStages, q0 = j * BQ;
      load_tile_async<BQ, KP, kThreads>(ring + s * 2 * BQ * KP, q + qoff + (size_t)q0 * D,
                                        Lq - q0, D);
      load_tile_async<BQ, KP, kThreads>(ring + (s * 2 + 1) * BQ * KP,
                                        dout + qoff + (size_t)q0 * D, Lq - q0, D);
      if (tid < BQ) {
        const int qi = q0 + tid;
        float* ls = stats + s * 2 * BQ + tid;
        if (qi < Lq) {
          cp_async4(ls, lse + (size_t)bh * Lq + qi);
          cp_async4(ls + BQ, delta + (size_t)bh * Lq + qi);
        } else {
          ls[0] = INFINITY;
          ls[BQ] = 0.f;
        }
      }
    }
    cp_async_commit();
  };
  load_tile_async<kRows, KP, kThreads>(Ks, k + koff + (size_t)k0 * D, Lk - k0, D);
  load_tile_async<kRows, KP, kThreads>(Vs, v + koff + (size_t)k0 * D, Lk - k0, D);
  for (int j = 0; j < kStages - 1; ++j) load_q(j);

  // The thread's rows are keys key0 = k0 + 64 wg + 16 warp + g and key0 + 8.
  const int key0 = k0 + wg * 64 + (tid % 128) / 32 * 16 + g, key1 = key0 + 8;
  const float* bias_row = bias ? bias + (size_t)b * Lk : nullptr;
  const float bb0 = (bias_row && key0 < Lk) ? bias_row[key0] * kLog2e : 0.f;
  const float bb1 = (bias_row && key1 < Lk) ? bias_row[key1] * kLog2e : 0.f;
  const bool active = k0 + wg * 64 < Lk;  // warpgroup-uniform
  uint32_t ka[kRegA ? KP / 16 : 1][4], va[kRegA ? KP / 16 : 1][4];
  if constexpr (kRegA) {
    cp_async_wait<kStages - 2>();  // K and V are in
    __syncthreads();
    const int row0 = wg * 64 + (tid % 128) / 32 * 16;
#pragma unroll
    for (int kk = 0; kk < KP / 16; ++kk) {
      ldsm_a<KP>(ka[kk], Ks, row0, kk);
      ldsm_a<KP>(va[kk], Vs, row0, kk);
    }
  }

  float dva[DN / 2], dka[DN / 2];
#pragma unroll
  for (int i = 0; i < DN / 2; ++i) dva[i] = dka[i] = 0.f;
  float db0 = 0.f, db1 = 0.f;

  for (int j = 0; j < nq; ++j) {
    cp_async_wait<kStages - 2>();
    fence_proxy_async();
    __syncthreads();  // tile j is in; every warpgroup is done with stage (j - 1)
    load_q(j + kStages - 1);
    if (!active) continue;
    const int st = j % kStages;
    const bf16* Qt = ring + st * 2 * BQ * KP;
    const bf16* dOt = Qt + BQ * KP;
    const float* Lt = stats + st * 2 * BQ;
    const float* Dt = Lt + BQ;

    // S^T = K Q^T and dP^T = V dO^T (rows keys, columns queries), issued
    // together; exp2 of S^T overlaps dP^T.
    float s[BQ / 2], dp[BQ / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KP / 16; ++kk) {
      if constexpr (kRegA) wgmma_rs<BQ, 0>(s, ka[kk], desc_k_major<KP>(Qt, 0, kk), kk);
      else wgmma_ss<BQ>(s, desc_k_major<KP>(Ks, wg * 8, kk), desc_k_major<KP>(Qt, 0, kk), kk);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < KP / 16; ++kk) {
      if constexpr (kRegA) wgmma_rs<BQ, 0>(dp, va[kk], desc_k_major<KP>(dOt, 0, kk), kk);
      else wgmma_ss<BQ>(dp, desc_k_major<KP>(Vs, wg * 8, kk), desc_k_major<KP>(dOt, 0, kk), kk);
    }
    wgmma_commit();
    wgmma_wait<1>();
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float l = Lt[n * 8 + 2 * t + e] * kLog2e;
        s[4 * n + e] = exp2_ftz(fmaf(s[4 * n + e], sl2, bb0) - l);
        s[4 * n + 2 + e] = exp2_ftz(fmaf(s[4 * n + 2 + e], sl2, bb1) - l);
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float dl = Dt[n * 8 + 2 * t + e];
        dp[4 * n + e] = s[4 * n + e] * (dp[4 * n + e] - dl);
        dp[4 * n + 2 + e] = s[4 * n + 2 + e] * (dp[4 * n + 2 + e] - dl);
        db0 += dp[4 * n + e];
        db1 += dp[4 * n + 2 + e];
      }
    }

    // dV += P^T dO and dK += dS^T Q, B read MN-major from the ring tiles.
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      pack_a(pa[kk], s, kk);
      pack_a(da[kk], dp, kk);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) wgmma_rs<DN, 1>(dva, pa[kk], desc_mn_major<KP>(dOt, kk), 1);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) wgmma_rs<DN, 1>(dka, da[kk], desc_mn_major<KP>(Qt, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
  }
  cp_async_wait<0>();

  bf16* dkb = dk + koff;
  bf16* dvb = dv + koff;
#pragma unroll
  for (int n = 0; n < DN / 8; ++n) {
    const int d = n * 8 + 2 * t;
    if (d >= D) continue;
    if (key0 < Lk) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + (size_t)key0 * D + d) =
          __floats2bfloat162_rn(dka[4 * n] * scale, dka[4 * n + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + (size_t)key0 * D + d) =
          __floats2bfloat162_rn(dva[4 * n], dva[4 * n + 1]);
    }
    if (key1 < Lk) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + (size_t)key1 * D + d) =
          __floats2bfloat162_rn(dka[4 * n + 2] * scale, dka[4 * n + 3] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + (size_t)key1 * D + d) =
          __floats2bfloat162_rn(dva[4 * n + 2], dva[4 * n + 3]);
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

template <int DN>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* out,
                      const void* dout, const void* lse, const void* bias, void* delta,
                      void* dq, int B, int H, int Lq, int Lk, int D, float scale,
                      cudaStream_t stream) {
  constexpr size_t bytes = dq_smem_bytes<DN>();
  static bool configured = false;
  cudaError_t err = set_smem(flash_bwd_dq_kernel<DN>, bytes, configured);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + kRows - 1) / kRows, B * H);
  flash_bwd_dq_kernel<DN><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(out),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(bias), static_cast<float*>(delta),
      static_cast<bf16*>(dq), H, Lq, Lk, D, scale);
  return cudaGetLastError();
}

template <int DN>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, const void* bias, void* dk,
                       void* dv, void* dbias, int B, int H, int Lq, int Lk, int D,
                       float scale, cudaStream_t stream) {
  constexpr size_t bytes = dkv_smem_bytes<DN>();
  static bool configured = false;
  cudaError_t err = set_smem(flash_bwd_dkv_kernel<DN>, bytes, configured);
  if (err != cudaSuccess) return err;
  dim3 grid((Lk + kRows - 1) / kRows, B * H);
  flash_bwd_dkv_kernel<DN><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(bias), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), static_cast<float*>(dbias), H, Lq, Lk, D, scale);
  return cudaGetLastError();
}

// The instance that serves head dim D (its width DN >= D; columns past D
// are zero in shared memory and not stored), or 0.
int instance(int B, int H, int Lq, int Lk, int D) {
  if (D % 8 != 0 || Lq <= 0 || Lk <= 0 || B * H > 65535) return 0;
  if (D <= 32) return 32;
  if (D == 40) return 40;
  if (D <= 64) return 64;
  if (D <= 80) return 80;
  if (D > 128 && D <= 160) return 160;
  return 0;
}

}  // namespace

// Head dims served: D % 8 == 0 with D <= 80 or 136 <= D <= 160; any other
// returns cudaErrorInvalidValue. q, out, dout, dq: (B, H, Lq, D);
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
  switch (instance(B, H, Lq, Lk, D)) {
    case 32: return (int)launch_dq<32>(q, k, v, out, dout, lse, bias, delta, dq, B, H, Lq, Lk, D, scale, s);
    case 40: return (int)launch_dq<40>(q, k, v, out, dout, lse, bias, delta, dq, B, H, Lq, Lk, D, scale, s);
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
  if (dbias != nullptr && bias == nullptr) return (int)cudaErrorInvalidValue;
  switch (instance(B, H, Lq, Lk, D)) {
    case 32: return (int)launch_dkv<32>(q, k, v, dout, lse, delta, bias, dk, dv, dbias, B, H, Lq, Lk, D, scale, s);
    case 40: return (int)launch_dkv<40>(q, k, v, dout, lse, delta, bias, dk, dv, dbias, B, H, Lq, Lk, D, scale, s);
    case 64: return (int)launch_dkv<64>(q, k, v, dout, lse, delta, bias, dk, dv, dbias, B, H, Lq, Lk, D, scale, s);
    case 80: return (int)launch_dkv<80>(q, k, v, dout, lse, delta, bias, dk, dv, dbias, B, H, Lq, Lk, D, scale, s);
    case 160: return (int)launch_dkv<160>(q, k, v, dout, lse, delta, bias, dk, dv, dbias, B, H, Lq, Lk, D, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
