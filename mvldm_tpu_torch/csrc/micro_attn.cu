// The attention probes of the microbenchmark for Hopper (sm_90a): fullk and
// the f32-dot flash of tools/bench_attn_micro.py, bf16 q (B*H, Lq, D) and
// k, v (B*H, Lk, D) in, bf16 out, no bias. The bf16-dot flash probe is the
// production forward (flash_attn_fwd.cu) with no bias, so it times the
// kernel that sampling and training run.
//
// Replaces the TPU kernels `_fullk_kernel` (exact softmax with the whole
// K/V row resident in VMEM, three modes) and `_flash_kernel` in f32 dots
// (online softmax over key blocks, v augmented with a ones column for the
// normaliser). Both are bound by tensor-core operations at the probe
// shapes (~L / 2 flop per byte at L >= 320, far above the H100's
// ~295 flop/byte ridge), and the L x L score matrix must not reach device
// memory. One block of four warps takes 64 query rows (16 per warp) and
// walks 64-key tiles; ragged Lq / Lk are masked in the kernel (rows past Lq
// are not stored, keys past Lk get p = 0 and zero K / V rows), never padded
// in device memory; D is padded to a multiple of 16 in shared memory only.
// The layout is the production forward's, with its helpers
// (attn_tile.cuh): Q fragments, the 16 x 64 score tile, P and the f32
// output accumulator in registers, P taken from the score registers as the
// A operand of P V, V stored transposed with padded rows.
//
// Modes:
//   flash tf32   the TPU's f32 dots on mma.sync m16n8k8 TF32: q and k are
//                bf16 values, exact in TF32, so the scores are exact f32
//                sums; online max and sum in f32; p is rounded to TF32
//                (2^-11 relative) for P V and the sum adds those rounded
//                values;
//   fullk max    the whole row is not resident (at L = 5120, D = 40 one
//                (b, h)'s K and V take 800 KB against 227 KB of shared
//                memory), so the same function without an online rescale
//                takes two passes: the keys once for the row max, then
//                again for p = exp((s - max) * scale), l = sum of the
//                unrounded f32 p and acc += bf16(p) V (1.5x the tensor
//                work of one pass);
//   fullk nomax  the second pass alone with p = exp(s * scale);
//   fullk none   one pass of scale * (bf16(s) V), the matmul floor.
#include "attn_tile.cuh"  // bf16, ld32, mma_16816, pack_bf16, quad_*, load_rows

namespace {

using attn_tile::bf16;
using attn_tile::ld32;
using attn_tile::load_rows;
using attn_tile::mma_16816;
using attn_tile::pack_bf16;
using attn_tile::quad_max;
using attn_tile::quad_sum;

constexpr int kThreads = 128;  // load_rows' default block size
constexpr int BM = 64, BN = 64;  // query rows per block, keys per tile
constexpr int kFlashTf32 = 0, kFullkMax = 1, kFullkNoMax = 2, kFullkNone = 3;
constexpr float kNegInf = -1e30f;  // the TPU kernel's initial running max

// d += a (16x8, row) * b (8x8, col) in TF32 with f32 accumulation. Thread
// (g = lane / 4, t = lane % 4) holds a0 (row g, k t), a1 (g + 8, t),
// a2 (g, t + 4), a3 (g + 8, t + 4), b0 (k t, col g), b1 (k t + 4, col g).
__device__ __forceinline__ void mma_1688_tf32(float* d, const uint32_t* a,
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The f32 bits (exact in TF32) of the low / high bf16 of a pair word.
__device__ __forceinline__ uint32_t lo_f32(uint32_t w) { return w << 16; }
__device__ __forceinline__ uint32_t hi_f32(uint32_t w) { return w & 0xffff0000u; }

__device__ __forceinline__ float to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// One 16-deep step of a warp's 16 x 8 score slice from the bf16 pair words
// of Q (a, the m16n8k16 A fragment) and K (b0, b1). TF32 takes it as two
// 8-deep steps in which k index t stands for head dim 2t and t + 4 for
// 2t + 1, on both operands alike, so the same pair words feed them.
template <bool TF32>
__device__ __forceinline__ void qk_step(float* d, const uint32_t* a, uint32_t b0,
                                        uint32_t b1) {
  if constexpr (TF32) {
    const uint32_t a0[4] = {lo_f32(a[0]), lo_f32(a[1]), hi_f32(a[0]), hi_f32(a[1])};
    mma_1688_tf32(d, a0, lo_f32(b0), hi_f32(b0));
    const uint32_t a1[4] = {lo_f32(a[2]), lo_f32(a[3]), hi_f32(a[2]), hi_f32(a[3])};
    mma_1688_tf32(d, a1, lo_f32(b1), hi_f32(b1));
  } else {
    mma_16816(d, a, b0, b1);
  }
}

template <int DP>
constexpr size_t smem_bytes() {
  return (size_t)(BM + BN) * (DP + 8) * 2 + (size_t)DP * (BN + 8) * 2;
}

template <int DP, int MODE>
__global__ void __launch_bounds__(kThreads)
    attn_probe_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ out, int Lq,
                      int Lk, int D, float scale) {
  constexpr bool kFlash = MODE == kFlashTf32;  // online softmax, TF32 dots
  constexpr int QS = DP + 8;   // row stride of the Q and K tiles
  constexpr int VS = BN + 8;   // row stride of the transposed V tile
  constexpr int NT = DP / 8;   // output n-tiles per warp
  constexpr int KT = DP / 16;  // 16-deep steps of Q K^T
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BM * QS;
  bf16* Vt = Ks + BN * QS;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * BM;
  const bf16* kb = k + bh * Lk * D;
  const bf16* vb = v + bh * Lk * D;
  const float sl2 = scale * kLog2e;  // exp(x * scale) = exp2(x * sl2)

  load_rows<DP, BM, QS>(Qs, q + bh * Lq * D, q0, Lq, D);
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

  // S = Q K^T of the K tile in shared memory, unscaled; rows g and g + 8.
  auto scores = [&](float (&sc)[BN / 8][4]) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
      const bf16* kr = Ks + (j * 8 + g) * QS + 2 * t;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk)
        qk_step<kFlash>(sc[j], qf[kk], ld32(kr + kk * 16), ld32(kr + kk * 16 + 8));
    }
  };

  // Row maxima of the raw scores (the TPU kernels' m), and row sums of p.
  float m0 = kFlash ? kNegInf : -INFINITY, m1 = m0, l0 = 0.f, l1 = 0.f;
  if constexpr (MODE == kFullkNoMax) m0 = m1 = 0.f;
  if constexpr (MODE == kFullkMax) {
    for (int k0 = 0; k0 < Lk; k0 += BN) {
      __syncthreads();  // every warp is done with the previous K tile
      load_rows<DP, BN, QS>(Ks, kb, k0, Lk, D);
      __syncthreads();
      float sc[BN / 8][4];
      scores(sc);
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (k0 + j * 8 + 2 * t + e < Lk) {
            mx0 = fmaxf(mx0, sc[j][e]);
            mx1 = fmaxf(mx1, sc[j][2 + e]);
          }
      m0 = fmaxf(m0, quad_max(mx0));
      m1 = fmaxf(m1, quad_max(mx1));
    }
  }

  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int k0 = 0; k0 < Lk; k0 += BN) {
    __syncthreads();  // every warp is done with the previous K / V tile
    load_rows<DP, BN, QS>(Ks, kb, k0, Lk, D);
    load_rows<DP, BN, VS, true>(Vt, vb, k0, Lk, D);
    __syncthreads();
    float sc[BN / 8][4];
    scores(sc);

    uint32_t pf[BN / 16][4];  // the bf16 A operand of P V (fullk)
    float a0 = 1.f, a1 = 1.f;
    if constexpr (MODE == kFullkNone) {
      // Masked keys have zero K and V rows: s = 0 adds nothing.
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        pf[j / 2][(j % 2) * 2] = pack_bf16(sc[j][0], sc[j][1]);
        pf[j / 2][(j % 2) * 2 + 1] = pack_bf16(sc[j][2], sc[j][3]);
      }
    } else {
      if constexpr (kFlash) {
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (k0 + j * 8 + 2 * t + e < Lk) {
              mx0 = fmaxf(mx0, sc[j][e]);
              mx1 = fmaxf(mx1, sc[j][2 + e]);
            }
        const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
        a0 = exp2f((m0 - mn0) * sl2);
        a1 = exp2f((m1 - mn1) * sl2);
        m0 = mn0;
        m1 = mn1;
      }
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool valid = k0 + j * 8 + 2 * t + e < Lk;
          float p0 = valid ? exp2f((sc[j][e] - m0) * sl2) : 0.f;
          float p1 = valid ? exp2f((sc[j][2 + e] - m1) * sl2) : 0.f;
          if constexpr (kFlash) {  // fullk sums the unrounded p
            p0 = to_tf32(p0);
            p1 = to_tf32(p1);
          }
          sum0 += p0;
          sum1 += p1;
          sc[j][e] = p0;
          sc[j][2 + e] = p1;
        }
        if constexpr (!kFlash) {
          pf[j / 2][(j % 2) * 2] = pack_bf16(sc[j][0], sc[j][1]);
          pf[j / 2][(j % 2) * 2 + 1] = pack_bf16(sc[j][2], sc[j][3]);
        }
      }
      l0 = l0 * a0 + quad_sum(sum0);
      l1 = l1 * a1 + quad_sum(sum1);
    }

#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if constexpr (kFlash) {
        o[n][0] *= a0;
        o[n][1] *= a0;
        o[n][2] *= a1;
        o[n][3] *= a1;
      }
      const bf16* vr = Vt + (n * 8 + g) * VS + 2 * t;
      if constexpr (kFlash) {
        // Key tile j as an 8-deep step: k index t stands for key 2t and
        // t + 4 for 2t + 1, so the score registers are the A fragment and
        // one pair word of the transposed V tile the B fragment.
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const uint32_t a[4] = {__float_as_uint(sc[j][0]), __float_as_uint(sc[j][2]),
                                 __float_as_uint(sc[j][1]), __float_as_uint(sc[j][3])};
          const uint32_t w = ld32(vr + j * 8);
          mma_1688_tf32(o[n], a, lo_f32(w), hi_f32(w));
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          mma_16816(o[n], pf[kk], ld32(vr + kk * 16), ld32(vr + kk * 16 + 8));
      }
    }
  }

  bf16* ob = out + bh * Lq * D;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int d = n * 8 + 2 * t;
    if (d >= D) continue;
    float v0 = o[n][0], v1 = o[n][1], v2 = o[n][2], v3 = o[n][3];
    if constexpr (MODE == kFullkNone) {
      v0 *= scale;
      v1 *= scale;
      v2 *= scale;
      v3 *= scale;
    } else {
      v0 /= l0;
      v1 /= l0;
      v2 /= l1;
      v3 /= l1;
    }
    if (r0 < Lq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r0 * D + d) =
          __floats2bfloat162_rn(v0, v1);
    if (r1 < Lq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r1 * D + d) =
          __floats2bfloat162_rn(v2, v3);
  }
}

template <int DP, int MODE>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int BH,
                   int Lq, int Lk, int D, float scale, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<DP>();
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(attn_probe_kernel<DP, MODE>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid((Lq + BM - 1) / BM, BH);
  attn_probe_kernel<DP, MODE><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), Lq, Lk, D, scale);
  return cudaGetLastError();
}

template <int MODE>
int dispatch(const void* q, const void* k, const void* v, void* out, int BH, int Lq,
             int Lk, int D, float scale, cudaStream_t s) {
  if (D % 8 != 0 || BH <= 0 || BH > 65535 || Lq <= 0 || Lk <= 0)
    return (int)cudaErrorInvalidValue;
  constexpr bool kFullk = MODE != kFlashTf32;
  switch ((D + 15) / 16 * 16) {
    case 48: return (int)launch<48, MODE>(q, k, v, out, BH, Lq, Lk, D, scale, s);
    case 80: return (int)launch<80, MODE>(q, k, v, out, BH, Lq, Lk, D, scale, s);
    case 128:
      if constexpr (!kFullk) return (int)launch<128, MODE>(q, k, v, out, BH, Lq, Lk, D, scale, s);
      break;
    case 160:
      if constexpr (!kFullk) return (int)launch<160, MODE>(q, k, v, out, BH, Lq, Lk, D, scale, s);
      break;
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Head dims: D % 8 == 0 rounding up to 48, 80, 128 or 160 (flash), 48 or
// 80 (fullk); any other returns cudaErrorInvalidValue. mode 0 / 1 / 2 is
// fullk with the max / without it / "none".
extern "C" int mvldm_micro_flash_tf32(const void* q, const void* k, const void* v,
                                      void* out, int BH, int Lq, int Lk, int D,
                                      float scale, void* stream) {
  return dispatch<kFlashTf32>(q, k, v, out, BH, Lq, Lk, D, scale,
                              static_cast<cudaStream_t>(stream));
}

extern "C" int mvldm_micro_fullk(const void* q, const void* k, const void* v, void* out,
                                 int BH, int Lq, int Lk, int D, float scale, int mode,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return dispatch<kFullkMax>(q, k, v, out, BH, Lq, Lk, D, scale, s);
    case 1: return dispatch<kFullkNoMax>(q, k, v, out, BH, Lq, Lk, D, scale, s);
    case 2: return dispatch<kFullkNone>(q, k, v, out, BH, Lq, Lk, D, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
