// The f32 route of the main path's kernels for Hopper (sm_90a): f32 in, f32
// out, f32 arithmetic throughout (FFMA, no tensor cores: TF32 would round
// every operand to 11 bits, where the JAX package's f32 Pallas kernels keep
// f32 products), for models left at the default f32 precision.
//
// Replaces the same TPU kernels as the bf16 bodies, in f32:
//   * `_flash_kernel` (mvldm_tpu/ops/attention.py), forward with the
//     optional lse: mvldm_f32_flash_fwd;
//   * `_flash_bwd_dq_kernel` and `_flash_bwd_dkv_kernel` (same file):
//     mvldm_f32_flash_bwd_dq (also writes delta = rowsum(dO * O)) and
//     mvldm_f32_flash_bwd_dkv (dK, dV and the per-head key-bias gradient);
//   * `_attn_kernel` (mvldm_tpu/ops/fused_attn.py) and `_ff_kernel`
//     (mvldm_tpu/ops/fused_ff.py), each as a chain of launches:
//     mvldm_f32_layer_norm, mvldm_f32_gemm (head-split output, head-merged
//     input, + bias, + residual), the flash forward, and mvldm_f32_geglu.
//
// What bounds it: f32 FFMA, 67 TFLOP/s on the H100 SXM, ~1/15 of the bf16
// tensor rate; the L x L scores never reach device memory. The design is
// the simple one that is right first:
//   * attention: blocks of 8 warps, each warp 4 rows (32 rows a block, the
//     resident operand in shared memory); 32-row tiles of the streamed
//     operand through shared memory, padded to D + 4 floats a row where a
//     lane reads its own row 16 bytes at a time (no bank conflicts); lane j
//     owns key (or query) j of the tile for the dot products, reading the
//     warp's rows as 16-byte broadcasts; p (or dS) goes to the warp's
//     staging array in shared memory and comes back four keys at a time
//     while each lane accumulates columns lane, lane + 32, ...: ~1 shared
//     memory read for every 2 to 3 FMAs. The online softmax in f32 with
//     expf and warp shuffles. Keys and queries past the end are zero rows
//     with p = 0. Head dims multiples of 4, up to 512 forward, 160
//     backward.
//   * GEMM: out = A W^T with W a torch Linear weight (N, K) row-major, the
//     micro_matmul.cu FFMA tile (128 x 128 outputs a block of 256 threads,
//     8 x 8 a thread, both operands staged k-major, the next 8-deep step
//     in registers while the current one is multiplied).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8, kAttnThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4, kRows = kWarps * kRowsPerWarp;  // 32 rows a block
constexpr int kTileKeys = 32;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// rows [r0, r0 + kRows) of a (L, D) matrix into shared memory with a row
// pitch of `pitch` floats, zeros past L; 16-byte moves (D, pitch % 4 == 0).
__device__ __forceinline__ void load_rows(float* dst, const float* src, int r0, int L, int D,
                                          int pitch) {
  const int d4 = D / 4;
  for (int i = threadIdx.x; i < kRows * d4; i += kAttnThreads) {
    const int r = i / d4, c = i - r * d4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < L) v = reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * D)[c];
    *reinterpret_cast<float4*>(dst + r * pitch + 4 * c) = v;
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

__device__ __forceinline__ float at4(float4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Row pitch of a tile a lane reads its own row of, 16 bytes at a time:
// D + 4 floats, so the eight lanes of each quarter-warp phase hit eight
// distinct 16-byte bank groups where D % 8 == 0.
__host__ __device__ constexpr int lane_pitch(int D) { return D + 4; }

// acc[r][c] += sum_j w[r][j] * rows[j][c * 32 + lane] over the 32 rows of a
// tile (pitch `pitch`), w the warp's staged (kRowsPerWarp, 32) weights read
// four at a time; rows past the end hold zeros and their weights are 0.
template <int NC>
__device__ __forceinline__ void accumulate(float (*acc)[NC], const float* w, const float* rows,
                                           int pitch, int D, int lane) {
#pragma unroll 2
  for (int j = 0; j < kTileKeys; j += 4) {
    float4 wr[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) wr[r] = ld4(w + r * kTileKeys + j);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = c * 32 + lane;
        const float x = d < D ? rows[(j + jj) * pitch + d] : 0.f;
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) acc[r][c] = fmaf(at4(wr[r], jj), x, acc[r][c]);
      }
    }
  }
}

// ------------------------------------------------------------- forward

// out = softmax(scale q k^T + bias) v; lse = the row log-sum-exp of the
// scaled, biased logits (natural log). NC: columns a lane owns, D <= 32 NC.
template <int NC>
__global__ void __launch_bounds__(kAttnThreads)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ bias,
                  float* __restrict__ out, float* __restrict__ lse, int H, int Lq, int Lk,
                  int D, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int KP = lane_pitch(D);
  float* Qs = smem;                       // kRows x D
  float* Ks = Qs + kRows * D;             // kTileKeys x KP
  float* Vs = Ks + kTileKeys * KP;        // kTileKeys x D
  float* Ps = Vs + kTileKeys * D;         // kWarps x kRowsPerWarp x kTileKeys
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.y, b = bh / H, q0 = blockIdx.x * kRows;
  const float* kb = k + (size_t)bh * Lk * D;
  const float* vb = v + (size_t)bh * Lk * D;
  load_rows(Qs, q + (size_t)bh * Lq * D, q0, Lq, D, D);
  const float* Qw = Qs + warp * kRowsPerWarp * D;
  float* Pw = Ps + warp * kRowsPerWarp * kTileKeys;

  float m[kRowsPerWarp], l[kRowsPerWarp], o[kRowsPerWarp][NC];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) o[r][c] = 0.f;
  }
  for (int k0 = 0; k0 < Lk; k0 += kTileKeys) {
    __syncthreads();  // Q in; every warp done with the last tile
    load_rows(Ks, kb, k0, Lk, D, KP);
    load_rows(Vs, vb, k0, Lk, D, D);
    __syncthreads();
    const bool valid = k0 + lane < Lk;
    const float bj = bias != nullptr && valid ? bias[(size_t)b * Lk + k0 + lane] : 0.f;
    float s[kRowsPerWarp] = {};
    const float* Kj = Ks + lane * KP;
    for (int d = 0; d < D; d += 4) {
      const float4 kv = ld4(Kj + d);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) s[r] = dot4(ld4(Qw + r * D + d), kv, s[r]);
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float sr = valid ? fmaf(s[r], scale, bj) : -INFINITY;
      const float mn = fmaxf(m[r], warp_max(sr));
      const float alpha = m[r] == -INFINITY ? 0.f : expf(m[r] - mn);
      const float p = sr == -INFINITY ? 0.f : expf(sr - mn);
      l[r] = fmaf(l[r], alpha, warp_sum(p));
      m[r] = mn;
      Pw[r * kTileKeys + lane] = p;
#pragma unroll
      for (int c = 0; c < NC; ++c) o[r][c] *= alpha;
    }
    __syncwarp();
    accumulate<NC>(o, Pw, Vs, D, D, lane);
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = q0 + warp * kRowsPerWarp + r;
    if (row >= Lq) continue;
    const float inv = 1.f / l[r];
    float* ob = out + ((size_t)bh * Lq + row) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = c * 32 + lane;
      if (d < D) ob[d] = o[r][c] * inv;
    }
    if (lse != nullptr && lane == 0) lse[(size_t)bh * Lq + row] = m[r] + logf(l[r]);
  }
}

// ------------------------------------------------------------ backward

// dq = scale * sum_j ds_ij k_j, ds = p (dp - delta), p = exp(scale q k^T +
// bias - lse), dp = dO v^T; delta = rowsum(dO * O) is computed here and
// written for the dK/dV kernel.
template <int NC>
__global__ void __launch_bounds__(kAttnThreads)
    flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ o,
                     const float* __restrict__ g, const float* __restrict__ lse,
                     const float* __restrict__ bias, float* __restrict__ delta,
                     float* __restrict__ dq, int H, int Lq, int Lk, int D, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int KP = lane_pitch(D);
  float* Qs = smem;                   // kRows x D
  float* Gs = Qs + kRows * D;         // kRows x D
  float* Ks = Gs + kRows * D;         // kTileKeys x KP
  float* Vs = Ks + kTileKeys * KP;    // kTileKeys x KP
  float* Ss = Vs + kTileKeys * KP;    // kWarps x kRowsPerWarp x kTileKeys (ds)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.y, b = bh / H, q0 = blockIdx.x * kRows;
  const size_t qoff = (size_t)bh * Lq * D;
  const float* kb = k + (size_t)bh * Lk * D;
  const float* vb = v + (size_t)bh * Lk * D;
  load_rows(Qs, q + qoff, q0, Lq, D, D);
  load_rows(Gs, g + qoff, q0, Lq, D, D);
  const float* Qw = Qs + warp * kRowsPerWarp * D;
  const float* Gw = Gs + warp * kRowsPerWarp * D;
  float* Sw = Ss + warp * kRowsPerWarp * kTileKeys;

  float lr[kRowsPerWarp], dr[kRowsPerWarp], acc[kRowsPerWarp][NC];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = q0 + warp * kRowsPerWarp + r;
    float part = 0.f;
    if (row < Lq)
      for (int d = lane; d < D; d += 32)
        part = fmaf(g[qoff + (size_t)row * D + d], o[qoff + (size_t)row * D + d], part);
    dr[r] = warp_sum(part);
    lr[r] = row < Lq ? lse[(size_t)bh * Lq + row] : 0.f;
    if (row < Lq && lane == 0) delta[(size_t)bh * Lq + row] = dr[r];
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }
  for (int k0 = 0; k0 < Lk; k0 += kTileKeys) {
    __syncthreads();
    load_rows(Ks, kb, k0, Lk, D, KP);
    load_rows(Vs, vb, k0, Lk, D, KP);
    __syncthreads();
    const bool valid = k0 + lane < Lk;
    const float bj = bias != nullptr && valid ? bias[(size_t)b * Lk + k0 + lane] : 0.f;
    float s[kRowsPerWarp] = {}, dp[kRowsPerWarp] = {};
    const float* Kj = Ks + lane * KP;
    const float* Vj = Vs + lane * KP;
    for (int d = 0; d < D; d += 4) {
      const float4 kv = ld4(Kj + d), vv = ld4(Vj + d);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        s[r] = dot4(ld4(Qw + r * D + d), kv, s[r]);
        dp[r] = dot4(ld4(Gw + r * D + d), vv, dp[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float p = valid ? expf(fmaf(s[r], scale, bj) - lr[r]) : 0.f;
      Sw[r * kTileKeys + lane] = p * (dp[r] - dr[r]);
    }
    __syncwarp();
    accumulate<NC>(acc, Sw, Ks, KP, D, lane);
    __syncwarp();
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = q0 + warp * kRowsPerWarp + r;
    if (row >= Lq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = c * 32 + lane;
      if (d < D) dq[qoff + (size_t)row * D + d] = acc[r][c] * scale;
    }
  }
}

// dk = scale * sum_i ds_ij q_i, dv = sum_i p_ij dO_i, dbias_j = sum_i ds_ij
// (per head): each warp owns 4 keys, the queries stream in 32-row tiles.
template <int NC>
__global__ void __launch_bounds__(kAttnThreads)
    flash_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ g,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      const float* __restrict__ bias, float* __restrict__ dk,
                      float* __restrict__ dv, float* __restrict__ dbias, int H, int Lq, int Lk,
                      int D, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int QP = lane_pitch(D);
  constexpr int kStage = kWarps * kRowsPerWarp * kTileKeys;
  float* Ks = smem;                   // kRows x D
  float* Vs = Ks + kRows * D;         // kRows x D
  float* Qs = Vs + kRows * D;         // kTileKeys x QP (queries)
  float* Gs = Qs + kTileKeys * QP;    // kTileKeys x QP
  float* Ps = Gs + kTileKeys * QP;    // kWarps x kRowsPerWarp x kTileKeys (p)
  float* Ss = Ps + kStage;            // the same for ds
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.y, b = bh / H, k0 = blockIdx.x * kRows;
  const size_t koff = (size_t)bh * Lk * D, qoff = (size_t)bh * Lq * D;
  load_rows(Ks, k + koff, k0, Lk, D, D);
  load_rows(Vs, v + koff, k0, Lk, D, D);
  const float* Kw = Ks + warp * kRowsPerWarp * D;
  const float* Vw = Vs + warp * kRowsPerWarp * D;
  float* Pw = Ps + warp * kRowsPerWarp * kTileKeys;
  float* Sw = Ss + warp * kRowsPerWarp * kTileKeys;

  float br[kRowsPerWarp], db[kRowsPerWarp], dka[kRowsPerWarp][NC], dva[kRowsPerWarp][NC];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int key = k0 + warp * kRowsPerWarp + r;
    br[r] = bias != nullptr && key < Lk ? bias[(size_t)b * Lk + key] : 0.f;
    db[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) dka[r][c] = dva[r][c] = 0.f;
  }
  for (int q0 = 0; q0 < Lq; q0 += kTileKeys) {
    __syncthreads();
    load_rows(Qs, q + qoff, q0, Lq, D, QP);
    load_rows(Gs, g + qoff, q0, Lq, D, QP);
    __syncthreads();
    const bool valid = q0 + lane < Lq;
    const float li = valid ? lse[(size_t)bh * Lq + q0 + lane] : 0.f;
    const float di = valid ? delta[(size_t)bh * Lq + q0 + lane] : 0.f;
    float s[kRowsPerWarp] = {}, dp[kRowsPerWarp] = {};
    const float* Qi = Qs + lane * QP;
    const float* Gi = Gs + lane * QP;
    for (int d = 0; d < D; d += 4) {
      const float4 qv = ld4(Qi + d), gv = ld4(Gi + d);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        s[r] = dot4(qv, ld4(Kw + r * D + d), s[r]);
        dp[r] = dot4(gv, ld4(Vw + r * D + d), dp[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float p = valid ? expf(fmaf(s[r], scale, br[r]) - li) : 0.f;
      const float ds = p * (dp[r] - di);
      db[r] += ds;
      Pw[r * kTileKeys + lane] = p;
      Sw[r * kTileKeys + lane] = ds;
    }
    __syncwarp();
    accumulate<NC>(dva, Pw, Gs, QP, D, lane);
    accumulate<NC>(dka, Sw, Qs, QP, D, lane);
    __syncwarp();
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int key = k0 + warp * kRowsPerWarp + r;
    const float dbr = warp_sum(db[r]);
    if (key >= Lk) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = c * 32 + lane;
      if (d < D) {
        dk[koff + (size_t)key * D + d] = dka[r][c] * scale;
        dv[koff + (size_t)key * D + d] = dva[r][c];
      }
    }
    if (dbias != nullptr && lane == 0) dbias[(size_t)bh * Lk + key] = dbr;
  }
}

// ------------------------------------------------- LayerNorm, GEMM, GEGLU

// y = (x - mean) / sqrt(var + eps) * gamma + beta per row of C (biased
// variance, two passes over the row); a warp a row.
__global__ void __launch_bounds__(256)
    layer_norm_f32(const float* __restrict__ x, const float* __restrict__ gamma,
                   const float* __restrict__ beta, float* __restrict__ y, int M, int C,
                   float eps) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= M) return;
  const float* xr = x + (size_t)row * C;
  float sum = 0.f;
  for (int c = lane; c < C; c += 32) sum += xr[c];
  const float mean = warp_sum(sum) / C;
  float sq = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float t = xr[c] - mean;
    sq = fmaf(t, t, sq);
  }
  const float rstd = rsqrtf(warp_sum(sq) / C + eps);
  for (int c = lane; c < C; c += 32)
    y[(size_t)row * C + c] = (xr[c] - mean) * rstd * gamma[c] + beta[c];
}

// act[m, j] = h[m, j] * gelu_erf(h[m, F + j]) for h (M, 2F).
__global__ void __launch_bounds__(256)
    geglu_f32(const float* __restrict__ h, float* __restrict__ act, long long M, int F) {
  const long long n = M * F;
  for (long long i = (long long)blockIdx.x * 256 + threadIdx.x; i < n;
       i += (long long)gridDim.x * 256) {
    const long long m = i / F;
    const int j = (int)(i - m * F);
    const float gate = h[m * 2 * F + F + j];
    act[i] = h[m * 2 * F + j] * (0.5f * gate * (1.f + erff(gate * 0.70710678118654752f)));
  }
}

constexpr int kTile = 128, kDepth = 8, kGemmThreads = 256;

// Row r, columns c..c+3 of a (M, H*D) operand stored as (M / L, H, L, D)
// (heads > 0) or row-major (heads == 0); D % 4 == 0 keeps the four in one
// head.
__device__ __forceinline__ size_t at(int r, int c, int ncols, int heads, int L, int D) {
  if (heads == 0) return (size_t)r * ncols + c;
  const int n = r / L, l = r - n * L, h = c / D, d = c - h * D;
  return (((size_t)n * heads + h) * L + l) * D + d;
}

// out = A W^T (+ bias[n]) (+ res[m, n]); A (M, K), W (N, K) row-major (a
// torch Linear weight), out (M, N). a_heads / out_heads > 0: that operand
// is laid out as (M / L, heads, L, D) with heads * D its width.
__global__ void __launch_bounds__(kGemmThreads)
    gemm_f32(const float* __restrict__ a, const float* __restrict__ w,
             const float* __restrict__ bias, const float* __restrict__ res,
             float* __restrict__ out, int M, int N, int K, int a_heads, int out_heads, int L,
             int D) {
  __shared__ __align__(16) float As[2][kDepth][kTile];  // As[k][m]
  __shared__ __align__(16) float Ws[2][kDepth][kTile];  // Ws[k][n]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int lr = tid / 2, lk = (tid % 2) * 4;  // one float4 of A and one of W a step

  auto load = [&](int k0, float4& ra, float4& rw) {
    ra = make_float4(0.f, 0.f, 0.f, 0.f);
    rw = make_float4(0.f, 0.f, 0.f, 0.f);
    if (m0 + lr < M && k0 + lk < K)
      ra = *reinterpret_cast<const float4*>(a + at(m0 + lr, k0 + lk, K, a_heads, L, D));
    if (n0 + lr < N && k0 + lk < K)
      rw = *reinterpret_cast<const float4*>(w + (size_t)(n0 + lr) * K + k0 + lk);
  };
  auto store = [&](int s, const float4& ra, const float4& rw) {
    As[s][lk + 0][lr] = ra.x;
    As[s][lk + 1][lr] = ra.y;
    As[s][lk + 2][lr] = ra.z;
    As[s][lk + 3][lr] = ra.w;
    Ws[s][lk + 0][lr] = rw.x;
    Ws[s][lk + 1][lr] = rw.y;
    Ws[s][lk + 2][lr] = rw.z;
    Ws[s][lk + 3][lr] = rw.w;
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float4 ra, rw;
  load(0, ra, rw);
  store(0, ra, rw);
  __syncthreads();
  const int nk = (K + kDepth - 1) / kDepth;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < nk) load((kt + 1) * kDepth, ra, rw);
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      float av[8], wv[8];
      *reinterpret_cast<float4*>(av) = *reinterpret_cast<const float4*>(&As[s][kk][ty * 4]);
      *reinterpret_cast<float4*>(av + 4) =
          *reinterpret_cast<const float4*>(&As[s][kk][64 + ty * 4]);
      *reinterpret_cast<float4*>(wv) = *reinterpret_cast<const float4*>(&Ws[s][kk][tx * 4]);
      *reinterpret_cast<float4*>(wv + 4) =
          *reinterpret_cast<const float4*>(&Ws[s][kk][64 + tx * 4]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
    }
    if (kt + 1 < nk) store(s ^ 1, ra, rw);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + (i / 4) * 64 + ty * 4 + (i % 4);
    if (r >= M) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int c = n0 + hh * 64 + tx * 4;
      if (c >= N) continue;
      float4 y = make_float4(acc[i][4 * hh], acc[i][4 * hh + 1], acc[i][4 * hh + 2],
                             acc[i][4 * hh + 3]);
      if (bias != nullptr) {
        const float4 bv = *reinterpret_cast<const float4*>(bias + c);
        y.x += bv.x;
        y.y += bv.y;
        y.z += bv.z;
        y.w += bv.w;
      }
      if (res != nullptr) {
        const float4 xv = *reinterpret_cast<const float4*>(res + (size_t)r * N + c);
        y.x += xv.x;
        y.y += xv.y;
        y.z += xv.z;
        y.w += xv.w;
      }
      *reinterpret_cast<float4*>(out + at(r, c, N, out_heads, L, D)) = y;
    }
  }
}

// ------------------------------------------------------------- launches

// Dynamic shared memory past 48 KB needs the kernel's opt-in, once an
// instance (at its largest head dim), before any graph capture.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

bool bad_attn(int B, int H, int Lq, int Lk, int D, int max_d) {
  return B <= 0 || H <= 0 || (long long)B * H > 65535 || Lq <= 0 || Lk <= 0 || D <= 0 ||
         D % 4 || D > max_d;
}

dim3 attn_grid(int rows, int BH) { return dim3((rows + kRows - 1) / kRows, BH); }

constexpr int kStaged = kWarps * kRowsPerWarp * kTileKeys;  // one staged (p or ds) array

constexpr size_t fwd_bytes(int D) {
  return (size_t)(kRows * D + kTileKeys * lane_pitch(D) + kTileKeys * D + kStaged) * 4;
}
constexpr size_t bwd_bytes(int D) {
  return (size_t)(2 * kRows * D + 2 * kTileKeys * lane_pitch(D) + 2 * kStaged) * 4;
}

template <int NC>
int fwd(const float* q, const float* k, const float* v, const float* bias, float* out,
        float* lse, int B, int H, int Lq, int Lk, int D, float scale, cudaStream_t s) {
  static const cudaError_t err = allow_smem(flash_fwd_f32<NC>, fwd_bytes(32 * NC));
  if (err != cudaSuccess) return (int)err;
  const size_t bytes = fwd_bytes(D);
  flash_fwd_f32<NC><<<attn_grid(Lq, B * H), kAttnThreads, bytes, s>>>(q, k, v, bias, out, lse,
                                                                       H, Lq, Lk, D, scale);
  return (int)cudaGetLastError();
}

template <int NC>
int bwd_dq(const float* q, const float* k, const float* v, const float* o, const float* g,
           const float* lse, const float* bias, float* delta, float* dq, int B, int H, int Lq,
           int Lk, int D, float scale, cudaStream_t s) {
  static const cudaError_t err = allow_smem(flash_bwd_dq_f32<NC>, bwd_bytes(32 * NC));
  if (err != cudaSuccess) return (int)err;
  const size_t bytes = bwd_bytes(D);
  flash_bwd_dq_f32<NC><<<attn_grid(Lq, B * H), kAttnThreads, bytes, s>>>(
      q, k, v, o, g, lse, bias, delta, dq, H, Lq, Lk, D, scale);
  return (int)cudaGetLastError();
}

template <int NC>
int bwd_dkv(const float* q, const float* k, const float* v, const float* g, const float* lse,
            const float* delta, const float* bias, float* dk, float* dv, float* dbias, int B,
            int H, int Lq, int Lk, int D, float scale, cudaStream_t s) {
  static const cudaError_t err = allow_smem(flash_bwd_dkv_f32<NC>, bwd_bytes(32 * NC));
  if (err != cudaSuccess) return (int)err;
  const size_t bytes = bwd_bytes(D);
  flash_bwd_dkv_f32<NC><<<attn_grid(Lk, B * H), kAttnThreads, bytes, s>>>(
      q, k, v, g, lse, delta, bias, dk, dv, dbias, H, Lq, Lk, D, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, H, Lq, D), k/v (B, H, Lk, D), out like q, contiguous f32 with
// 16-byte aligned rows; bias (B, Lk) f32 or null; lse (B, H, Lq) f32 or
// null. D % 4 == 0, D <= 512.
extern "C" int mvldm_f32_flash_fwd(const void* q, const void* k, const void* v,
                                   const void* bias, void* out, void* lse, int B, int H, int Lq,
                                   int Lk, int D, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_attn(B, H, Lq, Lk, D, 512)) return (int)cudaErrorInvalidValue;
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* bf = static_cast<const float*>(bias);
  auto* of = static_cast<float*>(out);
  auto* lf = static_cast<float*>(lse);
  if (D <= 64) return fwd<2>(qf, kf, vf, bf, of, lf, B, H, Lq, Lk, D, scale, s);
  if (D <= 96) return fwd<3>(qf, kf, vf, bf, of, lf, B, H, Lq, Lk, D, scale, s);
  if (D <= 160) return fwd<5>(qf, kf, vf, bf, of, lf, B, H, Lq, Lk, D, scale, s);
  return fwd<16>(qf, kf, vf, bf, of, lf, B, H, Lq, Lk, D, scale, s);
}

// As the forward, plus o and g (dO) like q, lse (B, H, Lq); writes delta
// (B, H, Lq) and dq like q. D % 4 == 0, D <= 160.
extern "C" int mvldm_f32_flash_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* o, const void* g, const void* lse,
                                      const void* bias, void* delta, void* dq, int B, int H,
                                      int Lq, int Lk, int D, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_attn(B, H, Lq, Lk, D, 160)) return (int)cudaErrorInvalidValue;
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* of = static_cast<const float*>(o);
  const auto* gf = static_cast<const float*>(g);
  const auto* lf = static_cast<const float*>(lse);
  const auto* bf = static_cast<const float*>(bias);
  auto* df = static_cast<float*>(delta);
  auto* dqf = static_cast<float*>(dq);
  if (D <= 64) return bwd_dq<2>(qf, kf, vf, of, gf, lf, bf, df, dqf, B, H, Lq, Lk, D, scale, s);
  if (D <= 96) return bwd_dq<3>(qf, kf, vf, of, gf, lf, bf, df, dqf, B, H, Lq, Lk, D, scale, s);
  return bwd_dq<5>(qf, kf, vf, of, gf, lf, bf, df, dqf, B, H, Lq, Lk, D, scale, s);
}

// dk, dv like k; dbias (B, H, Lk) f32 or null (per head, the caller sums
// over heads). D % 4 == 0, D <= 160.
extern "C" int mvldm_f32_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* g, const void* lse, const void* delta,
                                       const void* bias, void* dk, void* dv, void* dbias, int B,
                                       int H, int Lq, int Lk, int D, float scale,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_attn(B, H, Lq, Lk, D, 160)) return (int)cudaErrorInvalidValue;
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* gf = static_cast<const float*>(g);
  const auto* lf = static_cast<const float*>(lse);
  const auto* df = static_cast<const float*>(delta);
  const auto* bf = static_cast<const float*>(bias);
  auto* dkf = static_cast<float*>(dk);
  auto* dvf = static_cast<float*>(dv);
  auto* dbf = static_cast<float*>(dbias);
  if (D <= 64)
    return bwd_dkv<2>(qf, kf, vf, gf, lf, df, bf, dkf, dvf, dbf, B, H, Lq, Lk, D, scale, s);
  if (D <= 96)
    return bwd_dkv<3>(qf, kf, vf, gf, lf, df, bf, dkf, dvf, dbf, B, H, Lq, Lk, D, scale, s);
  return bwd_dkv<5>(qf, kf, vf, gf, lf, df, bf, dkf, dvf, dbf, B, H, Lq, Lk, D, scale, s);
}

// x, y (M, C); gamma, beta (C,).
extern "C" int mvldm_f32_layer_norm(const void* x, const void* gamma, const void* beta, void* y,
                                    int M, int C, float eps, void* stream) {
  if (M <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  layer_norm_f32<<<(M + 7) / 8, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<float*>(y), M, C, eps);
  return (int)cudaGetLastError();
}

// out (M, N) = A W^T (+ bias) (+ res), see gemm_f32. N, K and (with heads)
// D multiples of 4; every pointer 16-byte aligned.
extern "C" int mvldm_f32_gemm(const void* a, const void* w, const void* bias, const void* res,
                              void* out, int M, int N, int K, int a_heads, int out_heads, int L,
                              int D, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 4 || K % 4 || (M + kTile - 1) / kTile > 65535)
    return (int)cudaErrorInvalidValue;
  if ((a_heads || out_heads) && (L <= 0 || D <= 0 || D % 4 || M % L))
    return (int)cudaErrorInvalidValue;
  if ((a_heads && a_heads * D != K) || (out_heads && out_heads * D != N))
    return (int)cudaErrorInvalidValue;
  if (out_heads && res != nullptr) return (int)cudaErrorInvalidValue;
  dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile);
  gemm_f32<<<grid, kGemmThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(res), static_cast<float*>(out),
      M, N, K, a_heads, out_heads, L, D);
  return (int)cudaGetLastError();
}

// h (M, 2F) -> act (M, F).
extern "C" int mvldm_f32_geglu(const void* h, void* act, long long M, int F, void* stream) {
  if (M <= 0 || F <= 0) return (int)cudaErrorInvalidValue;
  const long long n = M * F;
  const int blocks = (int)((n + 255) / 256 < 132 * 16 ? (n + 255) / 256 : 132 * 16);
  geglu_f32<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h), static_cast<float*>(act), M, F);
  return (int)cudaGetLastError();
}
