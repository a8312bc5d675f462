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
// device memory. At D = 40 the L^2 exponentials are a second bound of the
// same size (16 exp2 a clock per SM), so they have to run while the tensor
// cores work. Ragged Lq / Lk are masked in the kernel, never padded in
// device memory; keys past Lk get a bias of -inf (p = 0), masked keys carry
// the caller's -1e30 as on the TPU. P is normalised by the bf16-rounded
// values that P V uses. Two bodies, both on wgmma (pieces in
// hopper_tile.cuh):
//   * head dims up to 160 (every UNet attention, and 128, the padded head
//     of the attention microbenchmark's flash probe), flash_fwd_kernel:
//     blocks of one or two warpgroups, 64 query rows each, with Q resident;
//     K, V and the tile's key-bias row stream through a four-stage cp.async
//     ring, 64 keys a stage, so tile j + 1 has landed when tile j's P V
//     ends and two more are in flight. S = Q K^T runs as wgmma with both
//     operands K-major in shared memory; the online softmax works on the
//     accumulator registers (quad reductions, one FFMA for scale * log2 e
//     plus bias, ex2.approx); P goes from the f32 accumulator into the bf16
//     A fragment in registers and O += P V runs with V read MN-major from
//     the same tile (no transposed copy). Tiles use wgmma's 128-byte
//     swizzle where D is a whole 128-byte row (64, 128) and the no-swizzle
//     blocked layout with D padded to 16 elsewhere (40 -> 48, 80, 160),
//     which moves fewer bytes than 64-column swizzle slices would. Where
//     the padding leaves spare columns (D = 40), V carries ones in them, so
//     P V also yields each row's sum of the bf16 P it used, in f32 and
//     rescaled with O: the softmax does no per-element sums. The
//     exponentials of one warpgroup overlap the products of the others on
//     the SM: up to D = 64 the kernel fits 128 registers, so two blocks
//     (four warpgroups) share an SM. One warpgroup per block where the
//     grid of 128-row blocks would not fill the card (small L), and one
//     ring stage where the keys fit one tile (V lands while S runs). For
//     training it also writes the f32 row log-sum-exp of the scaled and
//     biased logits, (B, H, Lq), which the backward kernels of
//     flash_attn_bwd.cu rebuild P from (the TPU kernel's `return_lse`
//     output); a null lse pointer skips that store;
//   * head dim 512 (the VAE mid-block's single 512-wide head, whose 64-row
//     f32 accumulator does not fit one warpgroup's registers),
//     flash_fwd_d512_kernel: blocks of 64 queries and two warpgroups; the
//     first computes S = Q K^T (32 k steps) and the softmax and puts bf16 P
//     in shared memory, then each warpgroup accumulates its own 256 columns
//     of O with wgmma from shared memory; K and V tiles of 32 keys through a
//     two-stage ring, all tiles 128-byte swizzled.
#include "attn_tile.cuh"    // quad_max, quad_sum
#include "hopper_tile.cuh"  // cp.async ring, wgmma, exp2_ftz, pack_a

#include <type_traits>

namespace {

using attn_tile::quad_max;
using attn_tile::quad_sum;
using namespace hopper_tile;

constexpr int kBN = 64;  // keys per ring stage

__host__ __device__ constexpr int pad16(int d) { return (d + 15) / 16 * 16; }

// Ring stages: tile j in use, tile j + 1 landed for the next S and two in
// flight; or one stage where the keys fit one tile (small L: less shared
// memory and fewer registers, so more blocks an SM hide the few steps'
// latency). Two blocks an SM up to D = 64 (at most 128 registers).
template <int DN>
__host__ __device__ constexpr int min_blocks() { return DN <= 64 ? 2 : 1; }
// 128-byte swizzled tiles where D is a whole 128-byte row (64, 128).
template <int DN>
__host__ __device__ constexpr bool swizzled() { return DN % 64 == 0; }
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes, bool& configured) {
  if (configured) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) configured = true;
  return err;
}

// ------------------------------------------------------- head dims <= 160

template <int DN, int NWG, int NS>
constexpr size_t fwd_smem_bytes() {
  return ((size_t)NWG * 64 + (size_t)NS * 2 * kBN) * pad16(DN) * 2 + (size_t)NS * kBN * 4 +
         1024;
}

template <int DN, int NWG, int NS>
__global__ void __launch_bounds__(NWG * 128, min_blocks<DN>())
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const float* __restrict__ bias,
                     bf16* __restrict__ out, float* __restrict__ lse, int H, int Lq,
                     int Lk, int D, float scale) {
  constexpr int KP = pad16(DN), KS = KP / 16;  // tile width, k steps of S
  constexpr int BM = NWG * 64, kThreads = NWG * 128, kStages = NS;
  constexpr bool kSw = swizzled<DN>();
  // Where the padded tile has spare columns past DN (eight: D = 40), V
  // carries ones there: P V then also yields each row's sum of the bf16 P
  // it used, in f32 and rescaled with O, in every lane's n8 block DN / 8
  // (no separate row sums or quad reductions in the softmax).
  constexpr bool kOnes = !kSw && KP > DN;
  constexpr int NPV = kOnes ? DN + 8 : DN;  // width of the P V product
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>((reinterpret_cast<uintptr_t>(smem) + 1023) & ~uintptr_t(1023));
  bf16* ring = Qs + BM * KP;  // [stage][K tile | V tile]
  float* Bs = reinterpret_cast<float*>(ring + kStages * 2 * kBN * KP);  // [stage][kBN]

  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / H;
  const int q0 = blockIdx.x * BM;
  const size_t qoff = (size_t)bh * Lq * D, koff = (size_t)bh * Lk * D;
  const float sl2 = scale * kLog2e;
  const int nk = (Lk + kBN - 1) / kBN;

  // Tiles in the layout the descriptors below read.
  auto load_tile = [&](auto rows_c, bf16* dst, const bf16* src, int rows) {
    constexpr int R = decltype(rows_c)::value;
    if constexpr (kSw) load_tile_sw128<R, KP, kThreads>(dst, src, rows, D);
    else load_tile_async<R, KP, kThreads>(dst, src, rows, D);
  };
  auto zero_pad = [&](auto rows_c, bf16* dst) {
    constexpr int R = decltype(rows_c)::value;
    if constexpr (kSw) zero_pad_sw128<R, KP, kThreads>(dst, D);
    else zero_pad_cols<R, KP, kThreads>(dst, D);
  };
  using RowsQ = std::integral_constant<int, BM>;
  using RowsK = std::integral_constant<int, kBN>;
  auto desc_q = [&](int kk) {
    return kSw ? desc_k_sw128<BM>(Qs, wg * 64, kk) : desc_k_major<KP>(Qs, wg * 8, kk);
  };
  auto desc_kt = [&](const bf16* Kt, int kk) {
    return kSw ? desc_k_sw128<kBN>(Kt, 0, kk) : desc_k_major<KP>(Kt, 0, kk);
  };
  auto desc_vt = [&](const bf16* Vt, int kk) {
    return kSw ? desc_mn_sw128<kBN>(Vt, kk) : desc_mn_major<KP>(Vt, kk);
  };
  if (D < KP) {
    zero_pad(RowsQ{}, Qs);
    for (int s = 0; s < 2 * kStages; ++s) {
      bf16* tile = ring + s * kBN * KP;
      if (!kOnes || s % 2 == 0) {
        zero_pad(RowsK{}, tile);
      } else {  // V: zeros, and 1.0 in columns DN .. DN + 7 of every row
        constexpr int NC = KP / 8;
        const int dc = D / 8, pad = NC - dc;
        for (int idx = threadIdx.x; idx < kBN * pad; idx += kThreads) {
          const int rr = idx % 8, cg = dc + (idx / 8) % pad, rg = idx / (8 * pad);
          *reinterpret_cast<uint4*>(tile + (rg * NC + cg) * 64 + rr * 8) =
              cg == DN / 8 ? make_uint4(0x3F803F80u, 0x3F803F80u, 0x3F803F80u, 0x3F803F80u)
                           : make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
  }
  auto load_k = [&](int j) {  // K and the key-bias row of tile j into stage j % kStages
    const int st = j % kStages, k0 = j * kBN;
    load_tile(RowsK{}, ring + st * 2 * kBN * KP, k + koff + (size_t)k0 * D, Lk - k0);
    if (tid < kBN) {
      const int key = k0 + tid;
      float* dst = Bs + st * kBN + tid;
      if (key >= Lk) *dst = -INFINITY;
      else if (bias != nullptr) cp_async4(dst, bias + (size_t)b * Lk + key);
      else *dst = 0.f;
    }
  };
  auto load_v = [&](int j) {
    const int st = j % kStages, k0 = j * kBN;
    load_tile(RowsK{}, ring + (st * 2 + 1) * kBN * KP, v + koff + (size_t)k0 * D, Lk - k0);
  };
  auto load_kv = [&](int j) {  // one commit group a tile, empty past the last
    if (j < nk) {
      load_k(j);
      load_v(j);
    }
    cp_async_commit();
  };
  load_tile(RowsQ{}, Qs, q + qoff + (size_t)q0 * D, Lq - q0);
  if constexpr (NS == 1) {
    // Q and K in one group, V in the next: S starts while V lands.
    load_k(0);
    cp_async_commit();
    load_v(0);
    cp_async_commit();
  } else {
    for (int j = 0; j < kStages - 1; ++j) load_kv(j);  // Q rides with tile 0
  }

  const bool active = q0 + wg * 64 < Lq;  // warpgroup-uniform
  float s[kBN / 2], o[NPV / 2];
#pragma unroll
  for (int i = 0; i < NPV / 2; ++i) o[i] = 0.f;
  // Rows g and g + 8 of the warp's 16; statistics in the log2 domain.
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  cp_async_wait<NS == 1 ? 1 : kStages - 2>();  // Q and K of tile 0 are in
  fence_proxy_async();
  __syncthreads();
  if (active) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_ss<kBN>(s, desc_q(kk), desc_kt(ring, kk), kk);
    wgmma_commit();
    wgmma_wait<0>();
  }

  for (int j = 0; j < nk; ++j) {
    if constexpr (NS > 1) {
      cp_async_wait<kStages - 3>();
      fence_proxy_async();
      __syncthreads();  // tile j + 1 is in; every warpgroup is done with stage j - 1
      load_kv(j + kStages - 1);
    } else {
      cp_async_wait<0>();
      fence_proxy_async();
      __syncthreads();  // V is in
    }
    if (!active) continue;
    const int st = j % kStages;
    const bf16* Vt = ring + (st * 2 + 1) * kBN * KP;
    const float* Bt = Bs + st * kBN;

    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float bb = Bt[n * 8 + 2 * t + e] * kLog2e;
        s[4 * n + e] = fmaf(s[4 * n + e], sl2, bb);
        s[4 * n + 2 + e] = fmaf(s[4 * n + 2 + e], sl2, bb);
        mx0 = fmaxf(mx0, s[4 * n + e]);
        mx1 = fmaxf(mx1, s[4 * n + 2 + e]);
      }
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float a0 = exp2_ftz(m0 - mn0), a1 = exp2_ftz(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    uint32_t pa[kBN / 16][4];
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n) {
      const uint32_t lo = pack2_bf16(exp2_ftz(s[4 * n] - m0), exp2_ftz(s[4 * n + 1] - m0));
      const uint32_t hi = pack2_bf16(exp2_ftz(s[4 * n + 2] - m1), exp2_ftz(s[4 * n + 3] - m1));
      if constexpr (!kOnes) {  // normalise by the rounded values that P V uses
        const float2 lo2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&lo));
        const float2 hi2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
        sum0 += lo2.x + lo2.y;
        sum1 += hi2.x + hi2.y;
      }
      pa[n / 2][(n % 2) * 2] = lo;
      pa[n / 2][(n % 2) * 2 + 1] = hi;
    }
    if constexpr (!kOnes) {
      l0 = l0 * a0 + quad_sum(sum0);
      l1 = l1 * a1 + quad_sum(sum1);
    }
#pragma unroll
    for (int n = 0; n < NPV / 8; ++n) {
      o[4 * n] *= a0;
      o[4 * n + 1] *= a0;
      o[4 * n + 2] *= a1;
      o[4 * n + 3] *= a1;
    }

    // O += P V, V read MN-major from the tile it landed in.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) wgmma_rs<NPV, 1>(o, pa[kk], desc_vt(Vt, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    if (j + 1 < nk) {  // S for tile j + 1, landed before the barrier above
      const bf16* Kn = ring + ((j + 1) % kStages) * 2 * kBN * KP;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) wgmma_ss<kBN>(s, desc_q(kk), desc_kt(Kn, kk), kk);
      wgmma_commit();
      wgmma_wait<0>();
    }
  }
  cp_async_wait<0>();

  bf16* ob = out + qoff;
  const int r0 = q0 + wg * 64 + (tid % 128) / 32 * 16 + g, r1 = r0 + 8;
  if constexpr (kOnes) {  // every lane holds a column DN + 2t of the row sums
    l0 = o[4 * (DN / 8)];
    l1 = o[4 * (DN / 8) + 2];
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  if (lse != nullptr && t == 0) {
    // m and log2(l) are in the log2 domain: lse = (m + log2 l) * ln 2.
    if (r0 < Lq) lse[(size_t)bh * Lq + r0] = (m0 + __log2f(l0)) * kLn2;
    if (r1 < Lq) lse[(size_t)bh * Lq + r1] = (m1 + __log2f(l1)) * kLn2;
  }
#pragma unroll
  for (int n = 0; n < DN / 8; ++n) {
    const int d = n * 8 + 2 * t;
    if (d >= D) continue;
    if (r0 < Lq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r0 * D + d) =
          __floats2bfloat162_rn(o[4 * n] * inv0, o[4 * n + 1] * inv0);
    if (r1 < Lq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r1 * D + d) =
          __floats2bfloat162_rn(o[4 * n + 2] * inv1, o[4 * n + 3] * inv1);
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

template <int DN, int NWG, int NS>
cudaError_t launch_nwg(const void* q, const void* k, const void* v, const void* bias, void* out,
                       void* lse, int B, int H, int Lq, int Lk, int D, float scale,
                       cudaStream_t stream) {
  constexpr size_t bytes = fwd_smem_bytes<DN, NWG, NS>();
  static bool configured = false;
  cudaError_t err = set_smem(flash_fwd_kernel<DN, NWG, NS>, bytes, configured);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + NWG * 64 - 1) / (NWG * 64), B * H);
  flash_fwd_kernel<DN, NWG, NS><<<grid, NWG * 128, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(bias), static_cast<bf16*>(out), static_cast<float*>(lse), H, Lq,
      Lk, D, scale);
  return cudaGetLastError();
}

// Two warpgroups (128 query rows) a block where that grid still fills the
// card; one (64 rows) at small L, where half of a 128-row block would idle
// and too few blocks would run. One ring stage where the keys fit one tile.
template <int DN>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const void* bias, void* out,
                       void* lse, int B, int H, int Lq, int Lk, int D, float scale,
                       cudaStream_t stream) {
  const bool two = Lq > 64 && (long long)((Lq + 127) / 128) * B * H >= sm_count();
  if (Lk <= kBN) {
    if (two) return launch_nwg<DN, 2, 1>(q, k, v, bias, out, lse, B, H, Lq, Lk, D, scale, stream);
    return launch_nwg<DN, 1, 1>(q, k, v, bias, out, lse, B, H, Lq, Lk, D, scale, stream);
  }
  if (two) return launch_nwg<DN, 2, 4>(q, k, v, bias, out, lse, B, H, Lq, Lk, D, scale, stream);
  return launch_nwg<DN, 1, 4>(q, k, v, bias, out, lse, B, H, Lq, Lk, D, scale, stream);
}

// ------------------------------------------------------------ head dim 512

constexpr int kBigD = 512, kBigBM = 64, kBigBN = 32, kBigThreads = 256;

constexpr size_t d512_smem_bytes() {
  return ((size_t)kBigBM * kBigD + 2 * 2 * (size_t)kBigBN * kBigD + (size_t)kBigBM * kBigBN) * 2 +
         2 * (size_t)kBigBN * 4 + 2 * (size_t)kBigBM * 4 + 1024;
}

__global__ void __launch_bounds__(kBigThreads, 1)
    flash_fwd_d512_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const float* __restrict__ bias,
                          bf16* __restrict__ out, int H, int Lq, int Lk, float scale) {
  constexpr int D = kBigD, BN = kBigBN;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>((reinterpret_cast<uintptr_t>(smem) + 1023) & ~uintptr_t(1023));
  bf16* ring = Qs + kBigBM * D;             // [stage][K tile | V tile], swizzled like Q
  bf16* Ps = ring + 2 * 2 * BN * D;         // bf16 P, 64 x 32 blocked
  float* Bs = reinterpret_cast<float*>(Ps + kBigBM * BN);  // [stage][BN]
  float* alpha = Bs + 2 * BN;               // per row: the rescale, then 1 / l
  float* lsum = alpha + kBigBM;

  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / H;
  const int q0 = blockIdx.x * kBigBM;
  const size_t qoff = (size_t)bh * Lq * D, koff = (size_t)bh * Lk * D;
  const float sl2 = scale * kLog2e;
  const int nk = (Lk + BN - 1) / BN;

  auto load_kv = [&](int j) {
    if (j < nk) {
      const int s = j % 2, k0 = j * BN;
      load_tile_sw128<BN, D, kBigThreads>(ring + s * 2 * BN * D, k + koff + (size_t)k0 * D,
                                          Lk - k0, D);
      load_tile_sw128<BN, D, kBigThreads>(ring + (s * 2 + 1) * BN * D,
                                          v + koff + (size_t)k0 * D, Lk - k0, D);
      if (tid < BN) {
        const int key = k0 + tid;
        float* dst = Bs + s * BN + tid;
        if (key >= Lk) *dst = -INFINITY;
        else if (bias != nullptr) cp_async4(dst, bias + (size_t)b * Lk + key);
        else *dst = 0.f;
      }
    }
    cp_async_commit();
  };
  load_tile_sw128<kBigBM, D, kBigThreads>(Qs, q + qoff + (size_t)q0 * D, Lq - q0, D);
  load_kv(0);

  // The thread's rows of the block's 64 (both warpgroups cover all 64).
  const int lr0 = (tid % 128) / 32 * 16 + g, lr1 = lr0 + 8;
  float o[2][64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[0][i] = o[1][i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int j = 0; j < nk; ++j) {
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();  // tile j is in; every warpgroup is done with tile j - 1 and P
    load_kv(j + 1);
    const int st = j % 2;
    const bf16* Kt = ring + st * 2 * BN * D;
    const bf16* Vt = Kt + BN * D;
    if (wg == 0) {
      float s[BN / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BN>(s, desc_k_sw128<kBigBM>(Qs, 0, kk), desc_k_sw128<BN>(Kt, 0, kk), kk);
      wgmma_commit();
      wgmma_wait<0>();
      const float* Bt = Bs + st * BN;
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float bb = Bt[n * 8 + 2 * t + e] * kLog2e;
          s[4 * n + e] = fmaf(s[4 * n + e], sl2, bb);
          s[4 * n + 2 + e] = fmaf(s[4 * n + 2 + e], sl2, bb);
          mx0 = fmaxf(mx0, s[4 * n + e]);
          mx1 = fmaxf(mx1, s[4 * n + 2 + e]);
        }
      }
      const float mn0 = fmaxf(m0, quad_max(mx0));
      const float mn1 = fmaxf(m1, quad_max(mx1));
      const float a0 = exp2_ftz(m0 - mn0), a1 = exp2_ftz(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
        const uint32_t lo = pack2_bf16(exp2_ftz(s[4 * n] - m0), exp2_ftz(s[4 * n + 1] - m0));
        const uint32_t hi = pack2_bf16(exp2_ftz(s[4 * n + 2] - m1), exp2_ftz(s[4 * n + 3] - m1));
        const float2 lo2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&lo));
        const float2 hi2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
        sum0 += lo2.x + lo2.y;
        sum1 += hi2.x + hi2.y;
        // P (row r, columns 8n + 2t, + 1) into the 64 x 32 blocked tile.
        *reinterpret_cast<uint32_t*>(Ps + ((lr0 / 8) * (BN / 8) + n) * 64 + (lr0 % 8) * 8 + 2 * t) = lo;
        *reinterpret_cast<uint32_t*>(Ps + ((lr1 / 8) * (BN / 8) + n) * 64 + (lr1 % 8) * 8 + 2 * t) = hi;
      }
      l0 = l0 * a0 + quad_sum(sum0);
      l1 = l1 * a1 + quad_sum(sum1);
      if (t == 0) {
        alpha[lr0] = a0;
        alpha[lr1] = a1;
      }
      fence_proxy_async();
    }
    __syncthreads();  // P and the rescale are in shared memory

    const float a0 = alpha[lr0], a1 = alpha[lr1];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        o[h][4 * n] *= a0;
        o[h][4 * n + 1] *= a0;
        o[h][4 * n + 2] *= a1;
        o[h][4 * n + 3] *= a1;
      }
    // O[:, 256 wg + 128 h + ...] += P V, V read MN-major.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        wgmma_ss<128, 1>(o[h], desc_k_major<BN>(Ps, 0, kk),
                         desc_mn_sw128<BN>(Vt + (wg * 256 + h * 128) / 64 * (BN * 64), kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
  }
  cp_async_wait<0>();
  if (wg == 0 && t == 0) {
    lsum[lr0] = l0;
    lsum[lr1] = l1;
  }
  __syncthreads();

  bf16* ob = out + qoff;
  const int r0 = q0 + lr0, r1 = q0 + lr1;
  const float inv0 = 1.f / lsum[lr0], inv1 = 1.f / lsum[lr1];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      const int d = wg * 256 + h * 128 + n * 8 + 2 * t;
      if (r0 < Lq)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r0 * D + d) =
            __floats2bfloat162_rn(o[h][4 * n] * inv0, o[h][4 * n + 1] * inv0);
      if (r1 < Lq)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r1 * D + d) =
            __floats2bfloat162_rn(o[h][4 * n + 2] * inv1, o[h][4 * n + 3] * inv1);
    }
}

cudaError_t launch_d512(const void* q, const void* k, const void* v, const void* bias, void* out,
                        int B, int H, int Lq, int Lk, float scale, cudaStream_t stream) {
  constexpr size_t bytes = d512_smem_bytes();
  static bool configured = false;
  cudaError_t err = set_smem(flash_fwd_d512_kernel, bytes, configured);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + kBigBM - 1) / kBigBM, B * H);
  flash_fwd_d512_kernel<<<grid, kBigThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(bias), static_cast<bf16*>(out), H, Lq, Lk, scale);
  return cudaGetLastError();
}

}  // namespace

// Head dims served: D % 8 == 0 with D rounded up to 32, 48, 64, 80, 160
// (the UNet), 128 (the microbenchmark's padded head) or 512 (the VAE,
// forward only: no lse); any other returns cudaErrorInvalidValue. The
// instance's width (the products' N) is D rounded up to 32, 40, 64, 80, 128
// or 160; columns past D are zero in shared memory and not stored. lse may
// be null; when not, f32 (B, H, Lq).
extern "C" int mvldm_flash_attn_fwd(const void* q, const void* k,
                                    const void* v, const void* bias, void* out,
                                    void* lse, int B, int H, int Lq, int Lk,
                                    int D, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D % 8 != 0 || Lq <= 0 || Lk <= 0 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  switch (pad16(D)) {
    case 32: return (int)launch_fwd<32>(q, k, v, bias, out, lse, B, H, Lq, Lk, D, scale, s);
    case 48:
      if (D == 40) return (int)launch_fwd<40>(q, k, v, bias, out, lse, B, H, Lq, Lk, D, scale, s);
      return (int)launch_fwd<64>(q, k, v, bias, out, lse, B, H, Lq, Lk, D, scale, s);
    case 64: return (int)launch_fwd<64>(q, k, v, bias, out, lse, B, H, Lq, Lk, D, scale, s);
    case 80: return (int)launch_fwd<80>(q, k, v, bias, out, lse, B, H, Lq, Lk, D, scale, s);
    case 128: return (int)launch_fwd<128>(q, k, v, bias, out, lse, B, H, Lq, Lk, D, scale, s);
    case 160: return (int)launch_fwd<160>(q, k, v, bias, out, lse, B, H, Lq, Lk, D, scale, s);
    case 512:
      if (lse != nullptr) return (int)cudaErrorInvalidValue;
      return (int)launch_d512(q, k, v, bias, out, B, H, Lq, Lk, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
