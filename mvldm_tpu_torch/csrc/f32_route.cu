// The f32 route of the main path's kernels for Hopper (sm_90a): f32 in, f32
// out, with f32 accuracy throughout, for models left at the default f32
// precision. A single TF32 product would round every operand to 11 bits,
// where the JAX package's f32 Pallas kernels keep f32 products.
//
// Replaces the same TPU kernels as the bf16 bodies, in f32:
//   * `_flash_kernel` (mvldm_tpu/ops/attention.py), forward with the
//     optional lse: mvldm_f32_flash_fwd up to head dim 160; past it (the
//     VAE's 512) three launches a chunk of heads, which the wrapper chains
//     (ops/f32_route.py): S = scale Q K^T + bias by mvldm_f32_gemm_batched
//     into a scratch of scores, mvldm_f32_attn_rows (lse and P = exp(S -
//     lse) in place), O = P V by mvldm_f32_gemm_batched;
//   * `_flash_bwd_dq_kernel` and `_flash_bwd_dkv_kernel` (same file):
//     mvldm_f32_flash_bwd_dq (also writes delta = rowsum(dO * O)) and
//     mvldm_f32_flash_bwd_dkv (dK, dV and the per-head key-bias gradient);
//   * `_attn_kernel` (mvldm_tpu/ops/fused_attn.py) and `_ff_kernel`
//     (mvldm_tpu/ops/fused_ff.py), each as a chain of launches:
//     mvldm_f32_layer_norm, mvldm_f32_gemm (head-split output, head-merged
//     input, + bias, + residual), the flash forward, and mvldm_f32_geglu.
//
// What bounds it: the products, on the tensor cores as split TF32, three
// TF32 products for each f32 one at 494.7 TFLOP/s (FFMA's rate is 67 on the
// H100 SXM). Every product is split TF32 on wgmma:
//   * forward at head dims up to 160, and the backward (dQ, dK / dV /
//     dbias), see "forward" and "backward" below: warpgroups of 64 rows,
//     the resident operand's hi / lo tiles loaded once, the streamed tiles
//     split on their way into shared memory and stored transposed where
//     wgmma needs them K-major (V for O += P V), P and dS split in
//     registers, no atomics; the L x L scores never reach device memory.
//   * forward at head dims 161-512: no flash design fits there (a 64-row Q
//     as hi / lo takes 256 KB of shared memory, a 64 x 512 O 256 registers
//     a thread), so the scores go through device memory (4 MB a head at the
//     VAE's L = 1024), and both products run on the GEMM tile;
//   * GEMM: f32_gemm_tile.cuh (two warpgroups, 128 x 128 outputs a block,
//     a three-stage ring of split, swizzled tiles; W (N, K) as it lies, V
//     (K, N) transposed on its way in).
// LayerNorm, GEGLU and the row pass are plain SIMT passes bound by bytes.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_tile.cuh"      // quad_max, quad_sum
#include "f32_gemm_tile.cuh"  // the split-TF32 GEMM tile
#include "hopper_tile.cuh"    // split tf32, wgmma, descriptors

namespace {

using attn_tile::quad_max;
using attn_tile::quad_sum;
using namespace hopper_tile;

constexpr unsigned kFull = 0xffffffffu;

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

// -------------------------------------------------------- split TF32
//
// The forward (D <= 160) and the backward on the tensor cores as split TF32
// (hopper_tile.cuh): every product of an f32 tile pair runs as three tf32
// wgmma (hi hi, hi lo, lo hi). Blocks of one or two warpgroups, each owning
// 64 rows; the resident operand's hi and lo tiles are loaded once. The
// streamed tiles go global -> registers (16-byte loads, issued before the
// products of the tile in use) -> split -> shared memory, stored as they
// lie (K-major operand of S and dP) and, where a product contracts over
// their rows, transposed (the K-major operand of O = P V, dQ = dS K, dV =
// P^T dO and dK = dS^T Q, which wgmma cannot read MN-major in tf32). P and
// dS stay in registers and go in as A fragments, split there.

// Head-dim instances (DN >= D, columns past D zero) and their tiles:
// warpgroups a block, streamed rows a stage and stages, as shared memory
// allows (a split f32 tile takes four times a bf16 one).
__host__ __device__ constexpr int split_dn(int D) {
  return D <= 16 ? 16 : D <= 40 ? 40 : D <= 64 ? 64 : D <= 80 ? 80 : 160;
}
// The forward: two warpgroups a block up to D = 80 where more than 64 queries
// share the keys, else one (a block of 64 rows; two such blocks fit an SM
// at D <= 80); three stages where they fit, as the products of a tile
// overlap the next tile's (see flash_fwd_tf32).
__host__ __device__ constexpr int fwd_wgs(int DN, int Lq) { return DN <= 80 && Lq > 64 ? 2 : 1; }
__host__ __device__ constexpr int fwd_bc(int DN, int WGS) {
  return WGS == 2 ? (DN <= 64 ? 64 : 32) : DN <= 40 ? 32 : 16;
}
__host__ __device__ constexpr int dq_wgs(int DN) { return DN <= 64 ? 2 : 1; }
__host__ __device__ constexpr int dq_bc(int DN) { return DN <= 40 ? 64 : DN <= 80 ? 32 : 16; }
__host__ __device__ constexpr int dq_stages(int DN) { return DN <= 80 ? 2 : 1; }
__host__ __device__ constexpr int dkv_wgs(int DN) { return DN <= 64 ? 2 : 1; }
__host__ __device__ constexpr int dkv_bc(int DN) {
  return DN <= 40 ? 32 : DN <= 80 ? 16 : 8;
}
__host__ __device__ constexpr int dkv_stages(int DN) { return DN <= 80 ? 2 : 1; }

// The long sums (O and dQ over the keys, dK and dV over the queries) leave
// the tensor cores' accumulator every kFlushRows rows: its error grows with
// the number of products summed, as if each HGMMA rounded toward zero (on
// an H100, 2.4e-5 relative at 5120 keys against 1.9e-6 with chunks of
// 256), so each chunk's sum is added in f32 (FADD, round to nearest) into
// a second register accumulator where the registers allow (*_reg_total),
// else into the output rows in device memory (the first chunk writes), and
// the next chunk's first product overwrites the accumulator. The same
// thread owns each output element throughout, so the order of the sums is
// fixed. (S = Q K^T sums over D <= 160: at most 60 HGMMA, fewer than a
// chunk's 96.)
constexpr int kFlushRows = 256;
__host__ __device__ constexpr bool fwd_reg_total(int DN) { return DN <= 80; }
__host__ __device__ constexpr bool dq_reg_total(int DN) { return DN <= 64; }
__host__ __device__ constexpr bool dkv_reg_total(int DN) { return DN <= 64; }

constexpr size_t kMaxSmem = 232448;  // a block's dynamic shared memory on the H100
__host__ __device__ constexpr size_t fwd_bytes_ns(int DN, int WGS, int NS) {
  return ((size_t)2 * WGS * 64 * DN + (size_t)NS * fwd_bc(DN, WGS) * (4 * DN + 1)) * 4;
}
__host__ __device__ constexpr int fwd_stages(int DN, int WGS) {
  return fwd_bytes_ns(DN, WGS, 3) <= kMaxSmem ? 3 : 2;
}
constexpr size_t fwd_split_bytes(int DN, int WGS) {
  return fwd_bytes_ns(DN, WGS, fwd_stages(DN, WGS));
}
constexpr size_t dq_bytes(int DN) {
  return ((size_t)4 * dq_wgs(DN) * 64 * DN + (size_t)dq_stages(DN) * dq_bc(DN) * (6 * DN + 1) +
          dq_wgs(DN) * 64) * 4;
}
constexpr size_t dkv_bytes(int DN) {
  return ((size_t)4 * dkv_wgs(DN) * 64 * DN +
          (size_t)dkv_stages(DN) * dkv_bc(DN) * (8 * DN + 2)) * 4;
}

// x split into hi and lo, stored at element off of the hi and lo tiles
// (unless hi is null).
__device__ __forceinline__ void store_split4(float* hi, float* lo, int off, float4 x, float4& h,
                                             float4& l) {
  split_tf32(x.x, h.x, l.x);
  split_tf32(x.y, h.y, l.y);
  split_tf32(x.z, h.z, l.z);
  split_tf32(x.w, h.w, l.w);
  if (hi == nullptr) return;
  *reinterpret_cast<float4*>(hi + off) = h;
  *reinterpret_cast<float4*>(lo + off) = l;
}

// Rows [r0, r0 + R) of an (L, D) f32 matrix as hi and lo R x DN tiles
// (zeros past L and past D), by THREADS threads, one 16-byte load each at a
// time; for the resident operands, loaded once.
template <int R, int DN, int THREADS>
__device__ __forceinline__ void stage_split(float* hi, float* lo, const float* src, int rows,
                                            int D) {
  constexpr int NC = DN / 4;
  for (int idx = threadIdx.x; idx < R * NC; idx += THREADS) {
    const int rr = idx % 8, cg = (idx / 8) % NC, rg = idx / (8 * NC);
    const int r = rg * 8 + rr;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows && 4 * cg < D)
      x = __ldg(reinterpret_cast<const float4*>(src + (size_t)r * D) + cg);
    float4 h, l;
    store_split4(hi, lo, (rg * NC + cg) * 32 + rr * 4, x, h, l);
  }
}

// One streamed tile of R rows held in registers between its load (before
// the products of the tile in use) and its store into the next stage.
template <int R, int DN, int THREADS>
struct StreamTile {
  static constexpr int NC = DN / 4, CHUNKS = R * NC, N = (CHUNKS + THREADS - 1) / THREADS;
  float4 x[N];

  __device__ __forceinline__ void load(const float* src, int rows, int D) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      const int rr = idx % 8, cg = (idx / 8) % NC, r = idx / (8 * NC) * 8 + rr;
      x[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (idx < CHUNKS && r < rows && 4 * cg < D)
        x[i] = __ldg(reinterpret_cast<const float4*>(src + (size_t)r * D) + cg);
    }
  }

  // hi / lo as an R x DN tile (unless hi is null); with thi != nullptr also
  // transposed, as a DN x R tile whose columns (the rows here) are in
  // tf32_kperm order.
  __device__ __forceinline__ void store(float* hi, float* lo, float* thi, float* tlo) const {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      if (idx >= CHUNKS) continue;
      const int rr = idx % 8, cg = (idx / 8) % NC, rg = idx / (8 * NC);
      float4 h, l;
      store_split4(hi, lo, (rg * NC + cg) * 32 + rr * 4, x[i], h, l);
      if (thi == nullptr) continue;
      const int col = rg * 8 + tf32_kperm(rr);
      const float hs[4] = {h.x, h.y, h.z, h.w}, ls[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = f32_tile_off<R>(4 * cg + j, col);
        thi[t] = hs[j];
        tlo[t] = ls[j];
      }
    }
  }
};

// d = A B over DN / 8 k steps, A rows [64 wg, +64) of the resident split
// tile (ah, al), B the streamed split tile (bh, bl), both K-major with DN
// columns; N = B's rows.
template <int N, int DN>
__device__ __forceinline__ void split_product_ss(float* d, const float* ah, const float* al,
                                                 const float* bh, const float* bl, int wg) {
#pragma unroll
  for (int kk = 0; kk < DN / 8; ++kk) {
    wgmma_tf32_ss<N>(d, desc_tf32<DN>(ah, wg * 8, kk), desc_tf32<DN>(bh, 0, kk), kk > 0);
    wgmma_tf32_ss<N>(d, desc_tf32<DN>(ah, wg * 8, kk), desc_tf32<DN>(bl, 0, kk), 1);
    wgmma_tf32_ss<N>(d, desc_tf32<DN>(al, wg * 8, kk), desc_tf32<DN>(bh, 0, kk), 1);
  }
}

// d = (d if accumulate) + A B, A the split fragments of a 64 x BC
// accumulator (BC / 8 k steps), B the transposed split tile (DN rows, BC
// columns).
template <int DN, int BC>
__device__ __forceinline__ void split_product_rs(float* d, const uint32_t (*ah)[4],
                                                 const uint32_t (*al)[4], const float* bh,
                                                 const float* bl, int accumulate) {
#pragma unroll
  for (int kk = 0; kk < BC / 8; ++kk) {
    wgmma_tf32_rs<DN>(d, ah[kk], desc_tf32<BC>(bh, 0, kk), kk > 0 || accumulate);
    wgmma_tf32_rs<DN>(d, ah[kk], desc_tf32<BC>(bl, 0, kk), 1);
    wgmma_tf32_rs<DN>(d, al[kk], desc_tf32<BC>(bh, 0, kk), 1);
  }
}

// out[r, :D] = acc * mul_r (+ out[r, :D] * keep_r unless first) for the
// thread's rows r0 and r1 = r0 + 8 of a 64-row accumulator with DN columns
// (rows >= L are not stored).
template <int DN>
__device__ __forceinline__ void blend_rows(float* out, const float* acc, int r0, int r1, int L,
                                           int D, int t, float2 keep, float2 mul, bool first) {
#pragma unroll
  for (int n = 0; n < DN / 8; ++n) {
    const int d = n * 8 + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = h ? r1 : r0;
      if (d >= D || r >= L) continue;
      const float kh = h ? keep.y : keep.x, mh = h ? mul.y : mul.x;
      float2* p = reinterpret_cast<float2*>(out + (size_t)r * D + d);
      float2 x = make_float2(acc[4 * n + 2 * h] * mh, acc[4 * n + 2 * h + 1] * mh);
      if (!first) {
        const float2 y = *p;
        x.x = fmaf(y.x, kh, x.x);
        x.y = fmaf(y.y, kh, x.y);
      }
      *p = x;
    }
  }
}

constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;

// out = softmax(scale q k^T + bias) v and its lse (natural log) for D <=
// 160. One block a (batch * head, 64 WGS queries); Q resident, the keys
// stream: S = Q K^T (both from shared memory, K as it lies), the online
// softmax in f32 in log2 units (ex2.approx), O += P V (P split in
// registers, V^T from the tile's stage). The products of consecutive tiles
// overlap: a warpgroup issues S(j) and then P(j-1) V(j-1) together, and
// computes the softmax of S(j) while the second runs, so three stages hold
// the tile being stored, S(j)'s and P(j-1) V(j-1)'s (with two, a barrier
// before each store waits for P(j-2) V(j-2) everywhere). O leaves the
// accumulator every kFlushRows keys, into registers (fwd_reg_total) or the
// output rows, rescaled there by the product c of the alphas since the
// last time.
template <int DN, int WGS>
__global__ void __launch_bounds__(WGS * 128, 1)
    flash_fwd_tf32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ bias,
                   float* __restrict__ out, float* __restrict__ lse, int H, int Lq, int Lk,
                   int D, float scale) {
  constexpr int T = WGS * 128, BR = WGS * 64;
  constexpr int BC = fwd_bc(DN, WGS), NS = fwd_stages(DN, WGS), TILE = BR * DN, ST = BC * DN;
  constexpr int TPC = kFlushRows / BC;  // tiles a chunk of the O sum
  extern __shared__ __align__(128) float smem[];
  float* Qh = smem;
  float* Ql = Qh + TILE;
  float* ring = Ql + TILE;         // [stage][K hi | K lo | V^T hi | V^T lo]
  float* Bs = ring + NS * 4 * ST;  // [stage][BC] key bias in log2 units, -inf past Lk

  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int gq = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / H, q0 = blockIdx.x * BR;
  const float* kb = k + (size_t)bh * Lk * D;
  const float* vb = v + (size_t)bh * Lk * D;
  const int nk = (Lk + BC - 1) / BC;
  const float sl2 = scale * kLog2e;

  StreamTile<BC, DN, T> kt, vt;
  float bnext = 0.f;
  auto load = [&](int j) {
    const int k0 = j * BC;
    kt.load(kb + (size_t)k0 * D, Lk - k0, D);
    vt.load(vb + (size_t)k0 * D, Lk - k0, D);
    if (tid < BC) {
      const int key = k0 + tid;
      bnext = key >= Lk         ? -INFINITY
              : bias != nullptr ? bias[(size_t)b * Lk + key] * kLog2e
                                : 0.f;
    }
  };
  // Tile j into its stage, visible to wgmma after the barrier; then the
  // next tile's loads are issued.
  auto stage = [&](int j) {
    if (NS == 2) __syncthreads();  // P(j-2) V(j-2) is done with the stage
    float* S = ring + (j % NS) * 4 * ST;
    kt.store(S, S + ST, nullptr, nullptr);
    vt.store(nullptr, nullptr, S + 2 * ST, S + 3 * ST);
    if (tid < BC) Bs[(j % NS) * BC + tid] = bnext;
    fence_proxy_async();
    __syncthreads();  // tile j (and, the first time, Q) is in
    if (j + 1 < nk) load(j + 1);
  };
  load(0);
  stage_split<BR, DN, T>(Qh, Ql, q + ((size_t)bh * Lq + q0) * D, Lq - q0, D);

  // The thread's rows: r0 = q0 + 64 wg + 16 warp + gq and r0 + 8.
  const int r0 = q0 + wg * 64 + (tid % 128) / 32 * 16 + gq, r1 = r0 + 8;
  const bool active = q0 + wg * 64 < Lq;  // warpgroup-uniform
  float* ob = out + (size_t)bh * Lq * D;

  // Per row: the running max m (log2 units), the sum l and the product c.
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, c0 = 1.f, c1 = 1.f;
  float acc[DN / 2] = {}, tot[fwd_reg_total(DN) ? DN / 2 : 1] = {};
  float s[BC / 2];
  uint32_t ph[BC / 8][4], pl[BC / 8][4];

  // s = the probabilities of tile j (S(j) in, scaled and biased in log2
  // units), m and l updated; returns the rescale of what came before.
  auto softmax = [&](int j, float& a0, float& a1) {
    const float* Bt = Bs + (j % NS) * BC;
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < BC / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float bj = Bt[n * 8 + 2 * t + e];
        s[4 * n + e] = fmaf(s[4 * n + e], sl2, bj);
        s[4 * n + 2 + e] = fmaf(s[4 * n + 2 + e], sl2, bj);
        mx0 = fmaxf(mx0, s[4 * n + e]);
        mx1 = fmaxf(mx1, s[4 * n + 2 + e]);
      }
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    // A row with no finite logit yet subtracts 0: its p stay 0, not NaN.
    const float z0 = mx0 == -INFINITY ? 0.f : mx0, z1 = mx1 == -INFINITY ? 0.f : mx1;
    a0 = exp2_ftz(m0 - z0);
    a1 = exp2_ftz(m1 - z1);
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int n = 0; n < BC / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[4 * n + e] = exp2_ftz(s[4 * n + e] - z0);
        s[4 * n + 2 + e] = exp2_ftz(s[4 * n + 2 + e] - z1);
        rs0 += s[4 * n + e];
        rs1 += s[4 * n + 2 + e];
      }
    }
    l0 = fmaf(l0, a0, quad_sum(rs0));
    l1 = fmaf(l1, a1, quad_sum(rs1));
    m0 = mx0;
    m1 = mx1;
  };
  // O's chunk of tiles [j0, ...) has left the accumulator: into tot, or
  // into the output rows (divided by l if it is the last).
  auto flush = [&](int j0, bool last) {
    if constexpr (fwd_reg_total(DN)) {
#pragma unroll
      for (int i = 0; i < DN / 2; ++i) tot[i] = fmaf(tot[i], i % 4 < 2 ? c0 : c1, acc[i]);
    } else {
      const float i0 = last ? 1.f / l0 : 1.f, i1 = last ? 1.f / l1 : 1.f;
      blend_rows<DN>(ob, acc, r0, r1, Lq, D, t, make_float2(c0 * i0, c1 * i1),
                     make_float2(i0, i1), j0 == 0);
    }
    c0 = c1 = 1.f;
  };
  // acc and c rescaled by this tile's alphas; P(j) split into A fragments.
  auto rescale_pack = [&](float a0, float a1) {
    c0 *= a0;
    c1 *= a1;
#pragma unroll
    for (int n = 0; n < DN / 8; ++n) {
      acc[4 * n] *= a0;
      acc[4 * n + 1] *= a0;
      acc[4 * n + 2] *= a1;
      acc[4 * n + 3] *= a1;
    }
#pragma unroll
    for (int kk = 0; kk < BC / 8; ++kk) pack_a_tf32(ph[kk], pl[kk], s, kk);
  };

  stage(0);
  if (active) {
    wgmma_fence();
    split_product_ss<BC, DN>(s, Qh, Ql, ring, ring + ST, wg);
    wgmma_commit();
    wgmma_wait<0>();
    float a0, a1;
    softmax(0, a0, a1);
    rescale_pack(a0, a1);
  }
  for (int j = 1; j < nk; ++j) {
    stage(j);
    if (!active) continue;
    const float* S = ring + (j % NS) * 4 * ST;
    const float* P = ring + ((j - 1) % NS) * 4 * ST;
    wgmma_fence();
    split_product_ss<BC, DN>(s, Qh, Ql, S, S + ST, wg);
    wgmma_commit();
    split_product_rs<DN, BC>(acc, ph, pl, P + 2 * ST, P + 3 * ST, (j - 1) % TPC != 0);
    wgmma_commit();
    wgmma_wait<1>();
    float a0, a1;
    softmax(j, a0, a1);
    wgmma_wait<0>();
    if (j % TPC == 0) flush(j - TPC, false);
    rescale_pack(a0, a1);
  }
  if (!active) return;
  const float* P = ring + ((nk - 1) % NS) * 4 * ST;
  wgmma_fence();
  split_product_rs<DN, BC>(acc, ph, pl, P + 2 * ST, P + 3 * ST, (nk - 1) % TPC != 0);
  wgmma_commit();
  wgmma_wait<0>();
  flush((nk - 1) / TPC * TPC, true);
  if constexpr (fwd_reg_total(DN))
    blend_rows<DN>(ob, tot, r0, r1, Lq, D, t, make_float2(0.f, 0.f),
                   make_float2(1.f / l0, 1.f / l1), true);
  if (lse != nullptr && t == 0) {
    if (r0 < Lq) lse[(size_t)bh * Lq + r0] = fmaf(m0, kLn2, logf(l0));
    if (r1 < Lq) lse[(size_t)bh * Lq + r1] = fmaf(m1, kLn2, logf(l1));
  }
}

// dq = scale * sum_j ds_ij k_j, ds = p (dp - delta), p = exp(scale q k^T +
// bias - lse), dp = dO v^T; delta = rowsum(dO * O) is computed here and
// written for the dK/dV kernel. One block a (batch * head, 64 or 128
// queries); Q and dO resident, the keys stream.
template <int DN>
__global__ void __launch_bounds__(dq_wgs(DN) * 128, 1)
    flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ o,
                     const float* __restrict__ g, const float* __restrict__ lse,
                     const float* __restrict__ bias, float* __restrict__ delta,
                     float* __restrict__ dq, int H, int Lq, int Lk, int D, float scale) {
  constexpr int T = dq_wgs(DN) * 128, BR = dq_wgs(DN) * 64;
  constexpr int BC = dq_bc(DN), NS = dq_stages(DN), TILE = BR * DN, ST = BC * DN;
  extern __shared__ __align__(128) float smem[];
  float* Qh = smem;
  float* Ql = Qh + TILE;
  float* Gh = Ql + TILE;
  float* Gl = Gh + TILE;
  float* ring = Gl + TILE;         // [stage][K hi | K lo | V hi | V lo | K^T hi | K^T lo]
  float* Bs = ring + NS * 6 * ST;  // [stage][BC] key bias, -inf past Lk
  float* Dls = Bs + NS * BC;       // [BR] delta

  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int gq = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / H, q0 = blockIdx.x * BR;
  const size_t qoff = (size_t)bh * Lq * D + (size_t)q0 * D;
  const float* kb = k + (size_t)bh * Lk * D;
  const float* vb = v + (size_t)bh * Lk * D;
  const int nk = (Lk + BC - 1) / BC;

  StreamTile<BC, DN, T> kt, vt;
  float bnext = 0.f;
  auto load = [&](int j) {
    const int k0 = j * BC;
    kt.load(kb + (size_t)k0 * D, Lk - k0, D);
    vt.load(vb + (size_t)k0 * D, Lk - k0, D);
    if (tid < BC) {
      const int key = k0 + tid;
      bnext = key >= Lk ? -INFINITY : bias != nullptr ? bias[(size_t)b * Lk + key] : 0.f;
    }
  };
  load(0);
  stage_split<BR, DN, T>(Qh, Ql, q + qoff, Lq - q0, D);
  stage_split<BR, DN, T>(Gh, Gl, g + qoff, Lq - q0, D);
  if (tid < BR) {  // delta = rowsum(dO * O) in f32, one row a thread
    float acc = 0.f;
    if (q0 + tid < Lq) {
      const float4* o4 = reinterpret_cast<const float4*>(o + qoff + (size_t)tid * D);
      const float4* g4 = reinterpret_cast<const float4*>(g + qoff + (size_t)tid * D);
      for (int c = 0; c < D / 4; ++c) {
        const float4 ov = __ldg(o4 + c), gv = __ldg(g4 + c);
        acc = fmaf(ov.w, gv.w, fmaf(ov.z, gv.z, fmaf(ov.y, gv.y, fmaf(ov.x, gv.x, acc))));
      }
      delta[(size_t)bh * Lq + q0 + tid] = acc;
    }
    Dls[tid] = acc;
  }

  // The thread's rows: lr0 = 64 wg + 16 warp + gq and lr0 + 8.
  const int lr0 = wg * 64 + (tid % 128) / 32 * 16 + gq;
  const int r0 = q0 + lr0, r1 = r0 + 8;
  const float lse0 = r0 < Lq ? lse[(size_t)bh * Lq + r0] : INFINITY;
  const float lse1 = r1 < Lq ? lse[(size_t)bh * Lq + r1] : INFINITY;
  const bool active = q0 + wg * 64 < Lq;  // warpgroup-uniform

  float acc[DN / 2], tot[dq_reg_total(DN) ? DN / 2 : 1] = {};
  float dl0 = 0.f, dl1 = 0.f;

  for (int c0 = 0; c0 < nk; c0 += kFlushRows / BC) {
    const int c1 = min(nk, c0 + kFlushRows / BC);
    for (int j = c0; j < c1; ++j) {
      float* S = ring + (j % NS) * 6 * ST;
      float* Bt = Bs + (j % NS) * BC;
      if (NS == 1) __syncthreads();  // every warpgroup is done with tile j - 1
      kt.store(S, S + ST, S + 4 * ST, S + 5 * ST);
      vt.store(S + 2 * ST, S + 3 * ST, nullptr, nullptr);
      if (tid < BC) Bt[tid] = bnext;
      fence_proxy_async();
      __syncthreads();  // tile j (and, the first time, Q, dO, delta) is in
      if (j == 0) {
        dl0 = Dls[lr0];
        dl1 = Dls[lr0 + 8];
      }
      if (j + 1 < nk) load(j + 1);
      if (!active) continue;

      // S = Q K^T and dP = dO V^T, issued together; exp of S overlaps dP.
      float s[BC / 2], dp[BC / 2];
      wgmma_fence();
      split_product_ss<BC, DN>(s, Qh, Ql, S, S + ST, wg);
      wgmma_commit();
      split_product_ss<BC, DN>(dp, Gh, Gl, S + 2 * ST, S + 3 * ST, wg);
      wgmma_commit();
      wgmma_wait<1>();
#pragma unroll
      for (int n = 0; n < BC / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float bj = Bt[n * 8 + 2 * t + e];
          s[4 * n + e] = expf(fmaf(s[4 * n + e], scale, bj) - lse0);
          s[4 * n + 2 + e] = expf(fmaf(s[4 * n + 2 + e], scale, bj) - lse1);
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int n = 0; n < BC / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          dp[4 * n + e] = s[4 * n + e] * (dp[4 * n + e] - dl0);
          dp[4 * n + 2 + e] = s[4 * n + 2 + e] * (dp[4 * n + 2 + e] - dl1);
        }
      }

      // dQ += dS K, B = K^T from the same stage.
      uint32_t ah[BC / 8][4], al[BC / 8][4];
#pragma unroll
      for (int kk = 0; kk < BC / 8; ++kk) pack_a_tf32(ah[kk], al[kk], dp, kk);
      wgmma_fence();
      split_product_rs<DN, BC>(acc, ah, al, S + 4 * ST, S + 5 * ST, j > c0);
      wgmma_commit();
      wgmma_wait<0>();
    }
    if constexpr (dq_reg_total(DN)) {
#pragma unroll
      for (int i = 0; i < DN / 2; ++i) tot[i] += acc[i];
    } else if (active) {
      blend_rows<DN>(dq + (size_t)bh * Lq * D, acc, r0, r1, Lq, D, t, make_float2(1.f, 1.f),
                     make_float2(scale, scale), c0 == 0);
    }
  }
  if constexpr (dq_reg_total(DN))
    if (active)
      blend_rows<DN>(dq + (size_t)bh * Lq * D, tot, r0, r1, Lq, D, t, make_float2(1.f, 1.f),
                     make_float2(scale, scale), true);
}

// dk = scale * sum_i ds_ij q_i, dv = sum_i p_ij dO_i, dbias_j = sum_i ds_ij
// (per head). One block a (batch * head, 64 or 128 keys); K and V
// resident, the queries stream.
template <int DN>
__global__ void __launch_bounds__(dkv_wgs(DN) * 128, 1)
    flash_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ g,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      const float* __restrict__ bias, float* __restrict__ dk,
                      float* __restrict__ dv, float* __restrict__ dbias, int H, int Lq, int Lk,
                      int D, float scale) {
  constexpr int T = dkv_wgs(DN) * 128, BR = dkv_wgs(DN) * 64;
  constexpr int BC = dkv_bc(DN), NS = dkv_stages(DN), TILE = BR * DN, ST = BC * DN;
  extern __shared__ __align__(128) float smem[];
  float* Kh = smem;
  float* Kl = Kh + TILE;
  float* Vh = Kl + TILE;
  float* Vl = Vh + TILE;
  float* ring = Vl + TILE;         // [stage][Q hi | lo | dO hi | lo | Q^T hi | lo | dO^T hi | lo]
  float* Ls = ring + NS * 8 * ST;  // [stage][lse (+inf past Lq) | delta (0 past Lq)]

  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int gq = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / H, k0 = blockIdx.x * BR;
  const size_t koff = (size_t)bh * Lk * D + (size_t)k0 * D;
  const float* qb = q + (size_t)bh * Lq * D;
  const float* gb = g + (size_t)bh * Lq * D;
  const int nq = (Lq + BC - 1) / BC;

  StreamTile<BC, DN, T> qt, gt;
  float lnext = 0.f, dnext = 0.f;
  auto load = [&](int j) {
    const int i0 = j * BC;
    qt.load(qb + (size_t)i0 * D, Lq - i0, D);
    gt.load(gb + (size_t)i0 * D, Lq - i0, D);
    if (tid < BC) {
      const int qi = i0 + tid;
      lnext = qi < Lq ? lse[(size_t)bh * Lq + qi] : INFINITY;
      dnext = qi < Lq ? delta[(size_t)bh * Lq + qi] : 0.f;
    }
  };
  load(0);
  stage_split<BR, DN, T>(Kh, Kl, k + koff, Lk - k0, D);
  stage_split<BR, DN, T>(Vh, Vl, v + koff, Lk - k0, D);

  // The thread's rows are keys key0 = k0 + 64 wg + 16 warp + gq and key0 + 8.
  const int key0 = k0 + wg * 64 + (tid % 128) / 32 * 16 + gq, key1 = key0 + 8;
  const float bb0 = bias != nullptr && key0 < Lk ? bias[(size_t)b * Lk + key0] : 0.f;
  const float bb1 = bias != nullptr && key1 < Lk ? bias[(size_t)b * Lk + key1] : 0.f;
  const bool active = k0 + wg * 64 < Lk;  // warpgroup-uniform

  float dva[DN / 2], dka[DN / 2];
  float dvt[dkv_reg_total(DN) ? DN / 2 : 1] = {}, dkt[dkv_reg_total(DN) ? DN / 2 : 1] = {};
  float db0 = 0.f, db1 = 0.f;

  for (int c0 = 0; c0 < nq; c0 += kFlushRows / BC) {
    const int c1 = min(nq, c0 + kFlushRows / BC);
    for (int j = c0; j < c1; ++j) {
      float* S = ring + (j % NS) * 8 * ST;
      float* Lt = Ls + (j % NS) * 2 * BC;
      if (NS == 1) __syncthreads();  // every warpgroup is done with tile j - 1
      qt.store(S, S + ST, S + 4 * ST, S + 5 * ST);
      gt.store(S + 2 * ST, S + 3 * ST, S + 6 * ST, S + 7 * ST);
      if (tid < BC) {
        Lt[tid] = lnext;
        Lt[BC + tid] = dnext;
      }
      fence_proxy_async();
      __syncthreads();  // tile j (and, the first time, K and V) is in
      if (j + 1 < nq) load(j + 1);
      if (!active) continue;

      // S^T = K Q^T and dP^T = V dO^T (rows keys, columns queries).
      float s[BC / 2], dp[BC / 2];
      wgmma_fence();
      split_product_ss<BC, DN>(s, Kh, Kl, S, S + ST, wg);
      wgmma_commit();
      split_product_ss<BC, DN>(dp, Vh, Vl, S + 2 * ST, S + 3 * ST, wg);
      wgmma_commit();
      wgmma_wait<1>();
#pragma unroll
      for (int n = 0; n < BC / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float li = Lt[n * 8 + 2 * t + e];
          s[4 * n + e] = expf(fmaf(s[4 * n + e], scale, bb0) - li);
          s[4 * n + 2 + e] = expf(fmaf(s[4 * n + 2 + e], scale, bb1) - li);
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int n = 0; n < BC / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float di = Lt[BC + n * 8 + 2 * t + e];
          dp[4 * n + e] = s[4 * n + e] * (dp[4 * n + e] - di);
          dp[4 * n + 2 + e] = s[4 * n + 2 + e] * (dp[4 * n + 2 + e] - di);
          db0 += dp[4 * n + e];
          db1 += dp[4 * n + 2 + e];
        }
      }

      // dV += P^T dO and dK += dS^T Q, B = dO^T and Q^T from the same stage.
      uint32_t ph[BC / 8][4], pl[BC / 8][4], sh[BC / 8][4], sl[BC / 8][4];
#pragma unroll
      for (int kk = 0; kk < BC / 8; ++kk) {
        pack_a_tf32(ph[kk], pl[kk], s, kk);
        pack_a_tf32(sh[kk], sl[kk], dp, kk);
      }
      wgmma_fence();
      split_product_rs<DN, BC>(dva, ph, pl, S + 6 * ST, S + 7 * ST, j > c0);
      split_product_rs<DN, BC>(dka, sh, sl, S + 4 * ST, S + 5 * ST, j > c0);
      wgmma_commit();
      wgmma_wait<0>();
    }
    if constexpr (dkv_reg_total(DN)) {
#pragma unroll
      for (int i = 0; i < DN / 2; ++i) {
        dkt[i] += dka[i];
        dvt[i] += dva[i];
      }
    } else if (active) {
      blend_rows<DN>(dk + (size_t)bh * Lk * D, dka, key0, key1, Lk, D, t, make_float2(1.f, 1.f),
                     make_float2(scale, scale), c0 == 0);
      blend_rows<DN>(dv + (size_t)bh * Lk * D, dva, key0, key1, Lk, D, t, make_float2(1.f, 1.f),
                     make_float2(1.f, 1.f), c0 == 0);
    }
  }
  if constexpr (dkv_reg_total(DN)) {
    if (active) {
      blend_rows<DN>(dk + (size_t)bh * Lk * D, dkt, key0, key1, Lk, D, t, make_float2(1.f, 1.f),
                     make_float2(scale, scale), true);
      blend_rows<DN>(dv + (size_t)bh * Lk * D, dvt, key0, key1, Lk, D, t, make_float2(1.f, 1.f),
                     make_float2(1.f, 1.f), true);
    }
  }

  db0 = quad_sum(db0);
  db1 = quad_sum(db1);
  if (dbias != nullptr && t == 0) {
    if (key0 < Lk) dbias[(size_t)bh * Lk + key0] = db0;
    if (key1 < Lk) dbias[(size_t)bh * Lk + key1] = db1;
  }
}

// ------------------------------------------------------ LayerNorm, GEGLU

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

// ------------------------------------------------------- the row pass

// lse[z][r] = log sum_c exp(s[z][r, c]) over the cols keys of each row of
// the scores (natural log; -inf for a row of -inf), and P = exp(s - lse) in
// place over those keys. A warp a row, three passes over it (max, sum,
// P): the first reads device memory, the other two the row as the first
// left it in L1.
__global__ void __launch_bounds__(256)
    attn_rows_f32(float* __restrict__ s, float* __restrict__ lse, int rows, int cols, int lds,
                  long long ss, long long sl) {
  const int z = blockIdx.y, row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  float* sr = s + z * ss + (size_t)row * lds;
  auto load = [&](int c) {  // keys c .. c + 3, -inf past cols (lds % 4 == 0: in the row)
    float4 x = *reinterpret_cast<const float4*>(sr + c);
    if (c + 4 > cols) {
      x.w = -INFINITY;
      if (c + 2 >= cols) x.z = -INFINITY;
      if (c + 1 >= cols) x.y = -INFINITY;
    }
    return x;
  };
  float m = -INFINITY;
  for (int c = 4 * lane; c < cols; c += 128) {
    const float4 x = load(c);
    m = fmaxf(m, fmaxf(fmaxf(x.x, x.y), fmaxf(x.z, x.w)));
  }
  m = warp_max(m);
  const float z0 = m == -INFINITY ? 0.f : m;
  float l = 0.f;
  for (int c = 4 * lane; c < cols; c += 128) {
    const float4 x = load(c);
    l += expf(x.x - z0) + expf(x.y - z0) + expf(x.z - z0) + expf(x.w - z0);
  }
  const float ls = z0 + logf(warp_sum(l));
  if (lane == 0) lse[z * sl + row] = ls;
  const float zp = ls == -INFINITY ? INFINITY : ls;  // p = 0 on a row of -inf
  for (int c = 4 * lane; c < cols; c += 128) {
    const float4 x = load(c);
    const float4 y = make_float4(expf(x.x - zp), expf(x.y - zp), expf(x.z - zp), expf(x.w - zp));
    if (c + 4 <= cols) {
      *reinterpret_cast<float4*>(sr + c) = y;
    } else {
      sr[c] = y.x;
      if (c + 1 < cols) sr[c + 1] = y.y;
      if (c + 2 < cols) sr[c + 2] = y.z;
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

template <int DN, int WGS>
int fwd_split_wgs(const float* q, const float* k, const float* v, const float* bias, float* out,
                  float* lse, int B, int H, int Lq, int Lk, int D, float scale, cudaStream_t s) {
  constexpr size_t bytes = fwd_split_bytes(DN, WGS);
  static_assert(bytes <= kMaxSmem, "forward: shared memory");
  static const cudaError_t err = allow_smem(flash_fwd_tf32<DN, WGS>, bytes);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_tf32<DN, WGS><<<dim3((Lq + 64 * WGS - 1) / (64 * WGS), B * H), 128 * WGS, bytes, s>>>(
      q, k, v, bias, out, lse, H, Lq, Lk, D, scale);
  return (int)cudaGetLastError();
}

template <int DN>
int fwd_split(const float* q, const float* k, const float* v, const float* bias, float* out,
              float* lse, int B, int H, int Lq, int Lk, int D, float scale, cudaStream_t s) {
  if constexpr (DN <= 80)
    if (fwd_wgs(DN, Lq) == 2)
      return fwd_split_wgs<DN, 2>(q, k, v, bias, out, lse, B, H, Lq, Lk, D, scale, s);
  return fwd_split_wgs<DN, 1>(q, k, v, bias, out, lse, B, H, Lq, Lk, D, scale, s);
}

template <int DN>
int bwd_dq(const float* q, const float* k, const float* v, const float* o, const float* g,
           const float* lse, const float* bias, float* delta, float* dq, int B, int H, int Lq,
           int Lk, int D, float scale, cudaStream_t s) {
  constexpr int rows = dq_wgs(DN) * 64;
  constexpr size_t bytes = dq_bytes(DN);
  static_assert(bytes <= kMaxSmem, "dQ: shared memory");
  static const cudaError_t err = allow_smem(flash_bwd_dq_f32<DN>, bytes);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_f32<DN><<<dim3((Lq + rows - 1) / rows, B * H), 2 * rows, bytes, s>>>(
      q, k, v, o, g, lse, bias, delta, dq, H, Lq, Lk, D, scale);
  return (int)cudaGetLastError();
}

template <int DN>
int bwd_dkv(const float* q, const float* k, const float* v, const float* g, const float* lse,
            const float* delta, const float* bias, float* dk, float* dv, float* dbias, int B,
            int H, int Lq, int Lk, int D, float scale, cudaStream_t s) {
  constexpr int rows = dkv_wgs(DN) * 64;
  constexpr size_t bytes = dkv_bytes(DN);
  static_assert(bytes <= kMaxSmem, "dK/dV: shared memory");
  static const cudaError_t err = allow_smem(flash_bwd_dkv_f32<DN>, bytes);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkv_f32<DN><<<dim3((Lk + rows - 1) / rows, B * H), 2 * rows, bytes, s>>>(
      q, k, v, g, lse, delta, bias, dk, dv, dbias, H, Lq, Lk, D, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, H, Lq, D), k/v (B, H, Lk, D), out like q, contiguous f32 with
// 16-byte aligned rows; bias (B, Lk) f32 or null; lse (B, H, Lq) f32 or
// null. D % 4 == 0, D <= 160 (past it the forward is the three launches of
// the wrapper, whose scratch comes from the caller's allocator).
extern "C" int mvldm_f32_flash_fwd(const void* q, const void* k, const void* v,
                                   const void* bias, void* out, void* lse, int B, int H, int Lq,
                                   int Lk, int D, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_attn(B, H, Lq, Lk, D, 160)) return (int)cudaErrorInvalidValue;
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* bf = static_cast<const float*>(bias);
  auto* of = static_cast<float*>(out);
  auto* lf = static_cast<float*>(lse);
  switch (split_dn(D)) {
    case 16: return fwd_split<16>(qf, kf, vf, bf, of, lf, B, H, Lq, Lk, D, scale, s);
    case 40: return fwd_split<40>(qf, kf, vf, bf, of, lf, B, H, Lq, Lk, D, scale, s);
    case 64: return fwd_split<64>(qf, kf, vf, bf, of, lf, B, H, Lq, Lk, D, scale, s);
    case 80: return fwd_split<80>(qf, kf, vf, bf, of, lf, B, H, Lq, Lk, D, scale, s);
    default: return fwd_split<160>(qf, kf, vf, bf, of, lf, B, H, Lq, Lk, D, scale, s);
  }
}

// The dynamic shared memory of the forward's instance for Lq queries of
// head dim D (bytes): the flash kernel's up to D = 160, the GEMM tile's past
// it (D <= 512), or cudaErrorInvalidValue.
extern "C" int mvldm_f32_flash_fwd_smem(int Lq, int D, int* smem) {
  if (Lq <= 0 || D <= 0 || D % 4 || D > 512) return (int)cudaErrorInvalidValue;
  const int dn = split_dn(D);
  *smem = (int)(D > 160 ? f32_gemm::kSmemBytes : fwd_split_bytes(dn, fwd_wgs(dn, Lq)));
  return 0;
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
  switch (split_dn(D)) {
    case 16: return bwd_dq<16>(qf, kf, vf, of, gf, lf, bf, df, dqf, B, H, Lq, Lk, D, scale, s);
    case 40: return bwd_dq<40>(qf, kf, vf, of, gf, lf, bf, df, dqf, B, H, Lq, Lk, D, scale, s);
    case 64: return bwd_dq<64>(qf, kf, vf, of, gf, lf, bf, df, dqf, B, H, Lq, Lk, D, scale, s);
    case 80: return bwd_dq<80>(qf, kf, vf, of, gf, lf, bf, df, dqf, B, H, Lq, Lk, D, scale, s);
    default: return bwd_dq<160>(qf, kf, vf, of, gf, lf, bf, df, dqf, B, H, Lq, Lk, D, scale, s);
  }
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
  switch (split_dn(D)) {
    case 16:
      return bwd_dkv<16>(qf, kf, vf, gf, lf, df, bf, dkf, dvf, dbf, B, H, Lq, Lk, D, scale, s);
    case 40:
      return bwd_dkv<40>(qf, kf, vf, gf, lf, df, bf, dkf, dvf, dbf, B, H, Lq, Lk, D, scale, s);
    case 64:
      return bwd_dkv<64>(qf, kf, vf, gf, lf, df, bf, dkf, dvf, dbf, B, H, Lq, Lk, D, scale, s);
    case 80:
      return bwd_dkv<80>(qf, kf, vf, gf, lf, df, bf, dkf, dvf, dbf, B, H, Lq, Lk, D, scale, s);
    default:
      return bwd_dkv<160>(qf, kf, vf, gf, lf, df, bf, dkf, dvf, dbf, B, H, Lq, Lk, D, scale, s);
  }
}

// The dynamic shared memory of the two backward kernels' instance for head
// dim D (bytes), or cudaErrorInvalidValue.
extern "C" int mvldm_f32_flash_bwd_smem(int D, int* dq_smem, int* dkv_smem) {
  if (D <= 0 || D % 4 || D > 160) return (int)cudaErrorInvalidValue;
  const int dn = split_dn(D);
  *dq_smem = (int)dq_bytes(dn);
  *dkv_smem = (int)dkv_bytes(dn);
  return 0;
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

// out (M, N) = A W^T (+ bias) (+ res); A (M, K) row-major or, with a_heads,
// (M / L, a_heads, L, D); W (N, K) row-major (a torch Linear weight); out
// (M, N) row-major or, with out_heads, (M / L, out_heads, L, D) (no
// residual then); res (M, N). N, K and (with heads) D multiples of 4; every
// pointer 16-byte aligned.
extern "C" int mvldm_f32_gemm(const void* a, const void* w, const void* bias, const void* res,
                              void* out, int M, int N, int K, int a_heads, int out_heads, int L,
                              int D, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 4 || K % 4) return (int)cudaErrorInvalidValue;
  if ((a_heads || out_heads) && (L <= 0 || D <= 0 || D % 4 || M % L))
    return (int)cudaErrorInvalidValue;
  if ((a_heads && a_heads * D != K) || (out_heads && out_heads * D != N))
    return (int)cudaErrorInvalidValue;
  if (out_heads && res != nullptr) return (int)cudaErrorInvalidValue;
  f32_gemm::Args p = {};
  p.a = static_cast<const float*>(a);
  p.b = static_cast<const float*>(w);
  p.bias = static_cast<const float*>(bias);
  p.res = static_cast<const float*>(res);
  p.out = static_cast<float*>(out);
  p.M = M;
  p.N = N;
  p.K = K;
  p.lda = p.ldb = K;
  p.ldo = N;
  p.bias_div = 1;
  p.alpha = 1.f;
  p.a_heads = a_heads;
  p.out_heads = out_heads;
  p.L = L;
  p.D = D;
  return (int)f32_gemm::launch<0>(p, 1, static_cast<cudaStream_t>(stream));
}

// batch products out[z] = alpha A[z] B[z] (+ bias row (z + bias_z0) /
// bias_div, bias_ld apart): A[z] (M, K) rows lda apart at a + z sa; B[z]
// (N, K) rows ldb apart at b + z sb or, with b_kn, (K, N); out[z] (M, N)
// rows ldo apart at out + z so. Any K; lda, ldb, ldo (and with b_kn N)
// multiples of 4, the matrices 16-byte aligned.
extern "C" int mvldm_f32_gemm_batched(const void* a, const void* b, const void* bias, void* out,
                                      int batch, int M, int N, int K, int lda, int ldb, int ldo,
                                      long long sa, long long sb, long long so, int b_kn,
                                      int bias_div, int bias_z0, int bias_ld, float alpha,
                                      void* stream) {
  if (batch <= 0 || M <= 0 || N <= 0 || K <= 0 || lda < K || ldo < N || lda % 4 || ldb % 4 ||
      ldo % 4 || sa % 4 || sb % 4 || so % 4 || ldb < (b_kn ? N : K) || (b_kn && N % 4) ||
      (bias != nullptr && (bias_div <= 0 || bias_z0 < 0 || bias_ld < N)))
    return (int)cudaErrorInvalidValue;
  f32_gemm::Args p = {};
  p.a = static_cast<const float*>(a);
  p.b = static_cast<const float*>(b);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<float*>(out);
  p.M = M;
  p.N = N;
  p.K = K;
  p.lda = lda;
  p.ldb = ldb;
  p.ldo = ldo;
  p.sa = sa;
  p.sb = sb;
  p.so = so;
  p.bias_div = bias_div;
  p.bias_z0 = bias_z0;
  p.bias_ld = bias_ld;
  p.alpha = alpha;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(b_kn ? f32_gemm::launch<1>(p, batch, s) : f32_gemm::launch<0>(p, batch, s));
}

// The GEMM tile's dynamic shared memory (bytes).
extern "C" int mvldm_f32_gemm_smem(int* smem) {
  *smem = (int)f32_gemm::kSmemBytes;
  return 0;
}

// The row pass over batch score blocks s[z] (rows x cols, rows lds apart, at
// s + z ss): lse[z][r] at lse + z sl + r, and P in place (see
// attn_rows_f32). lds a multiple of 4 and s 16-byte aligned.
extern "C" int mvldm_f32_attn_rows(void* s, void* lse, int batch, int rows, int cols, int lds,
                                   long long ss, long long sl, void* stream) {
  if (batch <= 0 || batch > 65535 || rows <= 0 || cols <= 0 || lds < cols || lds % 4 || ss % 4)
    return (int)cudaErrorInvalidValue;
  attn_rows_f32<<<dim3((rows + 7) / 8, batch), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(s), static_cast<float*>(lse), rows, cols, lds, ss, sl);
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
