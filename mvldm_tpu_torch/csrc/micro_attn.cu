// The attention probes of the microbenchmark for Hopper (sm_90a): fullk and
// the f32-dot flash of tools/bench_attn_micro.py, bf16 q (B*H, Lq, D) and
// k, v (B*H, Lk, D) in, bf16 out, no bias. The bf16-dot flash probe is the
// production forward (flash_attn_fwd.cu) with no bias, so it times the
// kernel that sampling and training run.
//
// Replaces the TPU kernels `_fullk_kernel` (exact softmax with the whole
// K/V row resident in VMEM, three modes) and `_flash_kernel` in f32 dots
// (online softmax over key blocks, v augmented with a ones column for the
// normaliser). At the probe shapes both are bound by tensor-core operations
// (~L / 2 flop per byte at L >= 320, far above the H100's ~295 flop/byte
// ridge) and, at D = 40, as much by the L^2 exponentials (16 exp2 a clock
// per SM); the L x L score matrix never reaches device memory.
//
// One body for all four modes, on wgmma (pieces in hopper_tile.cuh), laid
// out as the production forward: blocks of two warpgroups of 64 query
// rows with Q resident; K and V tiles of 64 keys through a four-stage
// cp.async ring (tile j in use, j + 1 landed, two in flight); S = Q K^T as
// wgmma SS with both operands K-major; the softmax on the accumulator
// registers (one FFMA and one ex2.approx a score); P repacked into the bf16
// A fragment in registers; O += P V as wgmma RS with V read MN-major from
// the tile it landed in, so V is never transposed. D is padded to 16 in
// shared memory only. Ragged Lq / Lk are masked in the kernel: rows past
// Lq are zero and not stored; keys past Lk are zero rows of K and V, and
// the last tile, where it is ragged, sets their scores to -inf once (p = 0).
//
// Modes:
//   flash        the TPU's f32 dots. q and k are bf16 values, exact in
//                TF32, so S on bf16 wgmma has the same products as TF32,
//                summed in f32. P V is the one product that needs more than
//                bf16: p is split into hi = bf16(p) and lo = bf16(p - hi)
//                (~16 bits of mantissa against TF32's 11) and both run as
//                bf16 wgmma against the same V tile: three bf16 products,
//                0.75 of the tensor time of TF32's two at half rate, with no
//                f32 or transposed copy of V (TF32 wgmma reads B K-major
//                only). Online max in f32. At D = 40 V's eight padding
//                columns hold ones, so P V also yields each row's sum of
//                hi + lo (the TPU kernel's ones column of v_aug); at other
//                D each thread sums its unrounded p;
//   fullk max    the whole row is not resident (at L = 5120, D = 40 one
//                (b, h)'s K and V take 800 KB against 227 KB of shared
//                memory), so the function without an online rescale takes
//                two passes over the keys through the same ring: S alone
//                for the row max, then p = exp2((s - max) scale log2 e),
//                l = the sum of the unrounded f32 p and O += bf16(p) V
//                (1.5x the tensor work of one pass);
//   fullk nomax  the second pass alone with p = exp2(s scale log2 e);
//   fullk none   one pass of scale * (bf16(s) V), the matmul floor: the
//                tensor work with no softmax.
#include "attn_tile.cuh"    // quad_max, quad_sum
#include "hopper_tile.cuh"  // cp.async ring, wgmma, exp2_ftz, pack2_bf16

namespace {

using attn_tile::quad_max;
using attn_tile::quad_sum;
using namespace hopper_tile;

constexpr int kBN = 64;      // keys per ring stage
constexpr int kStages = 4;   // ring stages
constexpr int kNWG = 2;      // warpgroups a block, 64 query rows each
constexpr int kBM = kNWG * 64, kThreads = kNWG * 128;
constexpr int kFlash = 0, kFullkMax = 1, kFullkNoMax = 2, kFullkNone = 3;
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr int pad16(int d) { return (d + 15) / 16 * 16; }

// Two blocks (four warpgroups) an SM where the body fits 128 registers
// with no spill: up to D = 48, and fullk without the max up to 80; one
// above.
template <int DN, int MODE>
__host__ __device__ constexpr int min_blocks() {
  return pad16(DN) <= (MODE == kFullkNoMax || MODE == kFullkNone ? 80 : 48) ? 2 : 1;
}

template <int DN>
constexpr size_t smem_bytes() {
  return ((size_t)kBM + (size_t)kStages * 2 * kBN) * pad16(DN) * 2;
}

// hi = bf16(a, b) and lo = bf16(a - hi.x, b - hi.y): hi + lo holds ~16
// bits of each f32 mantissa.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  hi = pack2_bf16(a, b);
  const float2 h = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
  lo = pack2_bf16(a - h.x, b - h.y);
}

// Keys past Lk (zero rows of K) out of the max and the sums: their scores
// to -inf, on a ragged tile only (the last), so once a row.
__device__ __forceinline__ void mask_keys(float* s, int k0, int Lk, int t) {
  if (k0 + kBN <= Lk) return;
#pragma unroll
  for (int n = 0; n < kBN / 8; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (k0 + n * 8 + 2 * t + e >= Lk) s[4 * n + e] = s[4 * n + 2 + e] = -INFINITY;
}

// S = Q K^T of the warpgroup's 64 rows against a 64-key tile, unscaled.
template <int KP>
__device__ __forceinline__ void scores(float* s, const bf16* Qs, int wg, const bf16* Kt) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KP / 16; ++kk)
    wgmma_ss<kBN>(s, desc_k_major<KP>(Qs, wg * 8, kk), desc_k_major<KP>(Kt, 0, kk), kk);
  wgmma_commit();
  wgmma_wait<0>();
}

// O += A V over the tile's 64 keys, V read MN-major.
template <int KP>
__device__ __forceinline__ void pv(float* o, uint32_t (*a)[4], const bf16* Vt) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) wgmma_rs<KP, 1>(o, a[kk], desc_mn_major<KP>(Vt, kk), 1);
}

template <int DN, int MODE>
__global__ void __launch_bounds__(kThreads, min_blocks<DN, MODE>())
    micro_attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ out, int Lq, int Lk,
                      int D, float scale) {
  constexpr int KP = pad16(DN);
  constexpr bool kTwoPass = MODE == kFullkMax;
  // D = 40 (DN = 40 is launched for D == 40 only): ones in V's padding
  // columns give the flash row sums from P V itself, in every lane's last
  // n8 block.
  constexpr bool kOnes = MODE == kFlash && KP > DN;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* ring = Qs + kBM * KP;  // [stage][K tile | V tile]

  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kBM;
  const size_t qoff = (size_t)blockIdx.y * Lq * D, koff = (size_t)blockIdx.y * Lk * D;
  const float sl2 = scale * kLog2e;  // exp(x * scale) = exp2(x * sl2)
  const int nk = (Lk + kBN - 1) / kBN;
  const int nsteps = kTwoPass ? 2 * nk : nk;  // max: the keys for the row max, then again

  if (D < KP) {
    zero_pad_cols<kBM, KP, kThreads>(Qs, D);
    for (int s = 0; s < 2 * kStages; ++s) {
      bf16* tile = ring + s * kBN * KP;
      if (!kOnes || s % 2 == 0) {
        zero_pad_cols<kBN, KP, kThreads>(tile, D);
      } else {  // V: 1.0 in the column group DN / 8 (columns 40 .. 47) of every row
        for (int idx = tid; idx < kBN; idx += kThreads)
          *reinterpret_cast<uint4*>(tile + ((idx / 8) * (KP / 8) + DN / 8) * 64 + (idx % 8) * 8) =
              make_uint4(0x3F803F80u, 0x3F803F80u, 0x3F803F80u, 0x3F803F80u);
      }
    }
  }
  // Step j's tile of keys: its K, and its V where the step runs P V, into
  // stage j % kStages; one commit group a step, empty past the last.
  auto load_step = [&](int j) {
    if (j < nsteps) {
      const bool second = kTwoPass && j >= nk;
      const int k0 = (second ? j - nk : j) * kBN, st = j % kStages;
      load_tile_async<kBN, KP, kThreads>(ring + st * 2 * kBN * KP, k + koff + (size_t)k0 * D,
                                         Lk - k0, D);
      if (!kTwoPass || second)
        load_tile_async<kBN, KP, kThreads>(ring + (st * 2 + 1) * kBN * KP,
                                           v + koff + (size_t)k0 * D, Lk - k0, D);
    }
    cp_async_commit();
  };
  load_tile_async<kBM, KP, kThreads>(Qs, q + qoff + (size_t)q0 * D, Lq - q0, D);
  for (int j = 0; j < kStages - 1; ++j) load_step(j);  // Q rides with step 0

  const bool active = q0 + wg * 64 < Lq;  // warpgroup-uniform
  float s[kBN / 2], o[KP / 2];
#pragma unroll
  for (int i = 0; i < KP / 2; ++i) o[i] = 0.f;
  // Rows g and g + 8 of the warp's 16: the row max of the raw scores and
  // m * sl2 (0 without a max); this thread's part of the row sums.
  float m0 = -INFINITY, m1 = -INFINITY, ms0 = 0.f, ms1 = 0.f, l0 = 0.f, l1 = 0.f;

  cp_async_wait<kStages - 2>();  // Q and step 0 are in
  fence_proxy_async();
  __syncthreads();
  if (active) scores<KP>(s, Qs, wg, ring);

  for (int j = 0; j < nsteps; ++j) {
    cp_async_wait<kStages - 3>();
    fence_proxy_async();
    __syncthreads();  // step j + 1 is in; every warpgroup is done with stage j - 1
    load_step(j + kStages - 1);
    if (!active) continue;
    const bool first = kTwoPass && j < nk;
    const int k0 = (kTwoPass && !first ? j - nk : j) * kBN;
    const bf16* Vt = ring + ((j % kStages) * 2 + 1) * kBN * KP;

    // The matmul floor adds the zero V rows of keys past Lk as they are.
    if constexpr (MODE != kFullkNone) mask_keys(s, k0, Lk, t);

    if (first) {  // fullk max, pass 1: the row max only
#pragma unroll
      for (int n = 0; n < kBN / 8; ++n) {
        m0 = fmaxf(m0, fmaxf(s[4 * n], s[4 * n + 1]));
        m1 = fmaxf(m1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
      }
      if (j == nk - 1) {
        m0 = quad_max(m0);
        m1 = quad_max(m1);
        ms0 = m0 * sl2;
        ms1 = m1 * sl2;
      }
    } else if constexpr (MODE == kFlash) {
      float tm0 = -INFINITY, tm1 = -INFINITY;
#pragma unroll
      for (int n = 0; n < kBN / 8; ++n) {
        tm0 = fmaxf(tm0, fmaxf(s[4 * n], s[4 * n + 1]));
        tm1 = fmaxf(tm1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
      }
      const float mn0 = fmaxf(m0, quad_max(tm0)), mn1 = fmaxf(m1, quad_max(tm1));
      const float a0 = exp2_ftz((m0 - mn0) * sl2), a1 = exp2_ftz((m1 - mn1) * sl2);
      m0 = mn0;
      m1 = mn1;
      ms0 = m0 * sl2;
      ms1 = m1 * sl2;
      uint32_t ph[kBN / 16][4], pl[kBN / 16][4];
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int n = 0; n < kBN / 8; ++n) {
        const float p0 = exp2_ftz(fmaf(s[4 * n], sl2, -ms0));
        const float p1 = exp2_ftz(fmaf(s[4 * n + 1], sl2, -ms0));
        const float p2 = exp2_ftz(fmaf(s[4 * n + 2], sl2, -ms1));
        const float p3 = exp2_ftz(fmaf(s[4 * n + 3], sl2, -ms1));
        if constexpr (!kOnes) {
          sum0 += p0 + p1;
          sum1 += p2 + p3;
        }
        split_bf16(p0, p1, ph[n / 2][(n % 2) * 2], pl[n / 2][(n % 2) * 2]);
        split_bf16(p2, p3, ph[n / 2][(n % 2) * 2 + 1], pl[n / 2][(n % 2) * 2 + 1]);
      }
      if constexpr (!kOnes) {
        l0 = fmaf(l0, a0, sum0);
        l1 = fmaf(l1, a1, sum1);
      }
#pragma unroll
      for (int n = 0; n < KP / 8; ++n) {
        o[4 * n] *= a0;
        o[4 * n + 1] *= a0;
        o[4 * n + 2] *= a1;
        o[4 * n + 3] *= a1;
      }
      wgmma_fence();
      pv<KP>(o, ph, Vt);
      pv<KP>(o, pl, Vt);
      wgmma_commit();
      wgmma_wait<0>();
    } else {  // fullk: bf16(p) V with the sum of the unrounded p, or bf16(s) V
      uint32_t pa[kBN / 16][4];
#pragma unroll
      for (int n = 0; n < kBN / 8; ++n) {
        float p0 = s[4 * n], p1 = s[4 * n + 1], p2 = s[4 * n + 2], p3 = s[4 * n + 3];
        if constexpr (MODE != kFullkNone) {
          p0 = exp2_ftz(fmaf(p0, sl2, -ms0));
          p1 = exp2_ftz(fmaf(p1, sl2, -ms0));
          p2 = exp2_ftz(fmaf(p2, sl2, -ms1));
          p3 = exp2_ftz(fmaf(p3, sl2, -ms1));
          l0 += p0 + p1;
          l1 += p2 + p3;
        }
        pa[n / 2][(n % 2) * 2] = pack2_bf16(p0, p1);
        pa[n / 2][(n % 2) * 2 + 1] = pack2_bf16(p2, p3);
      }
      wgmma_fence();
      pv<KP>(o, pa, Vt);
      wgmma_commit();
      wgmma_wait<0>();
    }
    if (j + 1 < nsteps) scores<KP>(s, Qs, wg, ring + ((j + 1) % kStages) * 2 * kBN * KP);
  }
  cp_async_wait<0>();
  if (!active) return;

  float inv0 = scale, inv1 = scale;  // the matmul floor
  if constexpr (kOnes) {  // every lane holds a ones column of the last n8 block
    inv0 = 1.f / o[4 * (KP / 8 - 1)];
    inv1 = 1.f / o[4 * (KP / 8 - 1) + 2];
  } else if constexpr (MODE != kFullkNone) {
    inv0 = 1.f / quad_sum(l0);
    inv1 = 1.f / quad_sum(l1);
  }
  bf16* ob = out + qoff;
  const int r0 = q0 + wg * 64 + (tid % 128) / 32 * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int n = 0; n < KP / 8; ++n) {
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

template <int DN, int MODE>
int launch(const void* q, const void* k, const void* v, void* out, int BH, int Lq, int Lk,
           int D, float scale, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<DN>();
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(micro_attn_kernel<DN, MODE>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid((Lq + kBM - 1) / kBM, BH);
  micro_attn_kernel<DN, MODE><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), Lq, Lk, D, scale);
  return (int)cudaGetLastError();
}

bool bad_shape(int BH, int Lq, int Lk, int D) {
  return D % 8 != 0 || BH <= 0 || BH > 65535 || Lq <= 0 || Lk <= 0;
}

template <int MODE>
int dispatch_fullk(const void* q, const void* k, const void* v, void* out, int BH, int Lq,
                   int Lk, int D, float scale, cudaStream_t s) {
  if (bad_shape(BH, Lq, Lk, D)) return (int)cudaErrorInvalidValue;
  switch (pad16(D)) {
    case 48: return launch<48, MODE>(q, k, v, out, BH, Lq, Lk, D, scale, s);
    case 80: return launch<80, MODE>(q, k, v, out, BH, Lq, Lk, D, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Head dims: D % 8 == 0 rounding up to 48, 80, 128 or 160 (flash), 48 or
// 80 (fullk); any other returns cudaErrorInvalidValue. mode 0 / 1 / 2 is
// fullk with the max / without it / "none".
extern "C" int mvldm_micro_flash_tf32(const void* q, const void* k, const void* v,
                                      void* out, int BH, int Lq, int Lk, int D,
                                      float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(BH, Lq, Lk, D)) return (int)cudaErrorInvalidValue;
  if (D == 40) return launch<40, kFlash>(q, k, v, out, BH, Lq, Lk, D, scale, s);
  switch (pad16(D)) {
    case 48: return launch<48, kFlash>(q, k, v, out, BH, Lq, Lk, D, scale, s);
    case 80: return launch<80, kFlash>(q, k, v, out, BH, Lq, Lk, D, scale, s);
    case 128: return launch<128, kFlash>(q, k, v, out, BH, Lq, Lk, D, scale, s);
    case 160: return launch<160, kFlash>(q, k, v, out, BH, Lq, Lk, D, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int mvldm_micro_fullk(const void* q, const void* k, const void* v, void* out,
                                 int BH, int Lq, int Lk, int D, float scale, int mode,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return dispatch_fullk<kFullkMax>(q, k, v, out, BH, Lq, Lk, D, scale, s);
    case 1: return dispatch_fullk<kFullkNoMax>(q, k, v, out, BH, Lq, Lk, D, scale, s);
    case 2: return dispatch_fullk<kFullkNone>(q, k, v, out, BH, Lq, Lk, D, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
