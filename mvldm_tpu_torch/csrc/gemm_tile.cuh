// Tiled bf16 GEMM with the prologues and epilogues of the fused transformer
// sub-blocks (fused_ln_attn.cu, fused_ln_geglu_ff.cu).
//
//   out[M, N] = epilogue( A[M, K] @ W[N, K]^T )
//
// W is a torch Linear weight, (out_features, in_features) row-major, read
// as a column-major K x N operand. A comes from one of:
//   kALn     x (M, K) bf16 with the LayerNorm applied while the tile is
//            staged (f32 statistics, then rounded to bf16 as the JAX
//            kernels round LN(x) to the weight dtype before the product);
//   kAHeads  the attention output (N, H, L, D), read as tokens x (H*D);
//   kAPlain  a row-major (M, K) bf16 matrix.
// Epilogues, all in f32 before one rounding to bf16:
//   kEpiQkv    gridDim.z = 3 selects W/out among q, k, v; q is multiplied
//              by qscale; the result is scattered to (N, H, L, D);
//   kEpiResid  + bias[n] + resid[m, n];
//   kEpiGeglu  two accumulators, h from W rows [0, N) and the gate from
//              rows [N, 2N): (h + b[n]) * gelu_erf(g + b[N + n]).
// A 128 x 64 output tile per block of eight warps (each 32 x 32) on
// mma.sync m16n8k16 with f32 accumulators in registers; the K loop stages
// the next 32-deep A and W tiles through registers into the other half of
// a double buffer while the current one is multiplied, so one barrier per
// step suffices. The epilogue works on the accumulator registers directly.
// Requires K % 8 == 0 and N % 8 == 0.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gemm_tile {

typedef __nv_bfloat16 bf16;

constexpr int kALn = 0, kAHeads = 1, kAPlain = 2;
constexpr int kEpiQkv = 0, kEpiResid = 1, kEpiGeglu = 2;

constexpr int BM = 128, BN = 64, BK = 32;
constexpr int LDS = BK + 8;  // padded smem rows: fragment loads hit distinct banks
constexpr int kThreads = 256;
constexpr int kAChunks = BM * BK / 8 / kThreads;  // uint4 chunks of A per thread
constexpr int kBChunks = BN * BK / 8 / kThreads;  // per weight tile

struct Args {
  const bf16* a;        // A source (see A modes)
  const float* ln_g;    // kALn: LayerNorm scale (K)
  const float* ln_b;    // kALn: LayerNorm bias (K)
  float eps;
  int M, N, K;
  const bf16* w[3];     // (N, K) weights; kEpiGeglu: w[0] is (2N, K)
  const float* bias;    // (N), kEpiGeglu: (2N)
  const bf16* resid;    // kEpiResid: (M, N)
  bf16* out[3];
  int heads, seq, head_dim;  // (N, H, L, D) layout for kAHeads / kEpiQkv
  float qscale;
};

template <int NB>
__host__ __device__ constexpr size_t smem_bytes() {
  return 2 * ((size_t)BM * LDS + (size_t)NB * BN * LDS) * 2 + 2 * BM * 4;
}

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
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

__device__ __forceinline__ void store2(bf16* p, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}

template <int AMODE, int EPI>
__global__ void __launch_bounds__(kThreads) gemm_kernel(Args args) {
  constexpr int NB = (EPI == kEpiGeglu) ? 2 : 1;
  constexpr int kTileA = BM * LDS, kTileB = NB * BN * LDS;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* buf = reinterpret_cast<bf16*>(smem);  // [2][A tile | W tile(s)]
  float* mu = reinterpret_cast<float*>(smem + 2 * (kTileA + kTileB) * 2);
  float* rs = mu + BM;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int z = (EPI == kEpiQkv) ? blockIdx.z : 0;
  const int M = args.M, N = args.N, K = args.K;
  const bf16* W = args.w[z];

  if (AMODE == kALn) {
    for (int r = warp; r < BM; r += kThreads / 32) {
      const int gr = m0 + r;
      float mean = 0.f, var = 0.f;
      if (gr < M) {
        const bf16* row = args.a + (size_t)gr * K;
        float s = 0.f;
        for (int c = lane; c < K; c += 32) s += __bfloat162float(row[c]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        mean = s / K;
        float s2 = 0.f;
        for (int c = lane; c < K; c += 32) {
          const float d = __bfloat162float(row[c]) - mean;
          s2 += d * d;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) s2 += __shfl_xor_sync(0xffffffffu, s2, o);
        var = s2 / K;
      }
      if (lane == 0) {
        mu[r] = mean;
        rs[r] = rsqrtf(var + args.eps);
      }
    }
    __syncthreads();
  }

  // Global -> register staging of one K step.
  uint4 ra[kAChunks], rb[NB][kBChunks];
  auto gload = [&](int k0) {
#pragma unroll
    for (int s = 0; s < kAChunks; ++s) {
      const int idx = threadIdx.x + s * kThreads;
      const int r = idx / (BK / 8), c8 = (idx % (BK / 8)) * 8;
      const int gr = m0 + r, gc = k0 + c8;
      ra[s] = make_uint4(0u, 0u, 0u, 0u);
      if (gr < M && gc < K) {
        const bf16* src;
        if (AMODE == kAHeads) {
          const int n = gr / args.seq, l = gr % args.seq;
          const int h = gc / args.head_dim, d = gc % args.head_dim;
          src = args.a +
                (((size_t)n * args.heads + h) * args.seq + l) * args.head_dim + d;
        } else {
          src = args.a + (size_t)gr * K + gc;
        }
        ra[s] = *reinterpret_cast<const uint4*>(src);
      }
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int s = 0; s < kBChunks; ++s) {
        const int idx = threadIdx.x + s * kThreads;
        const int r = idx / (BK / 8), c8 = (idx % (BK / 8)) * 8;
        const int gn = n0 + r, gc = k0 + c8;
        rb[nb][s] = make_uint4(0u, 0u, 0u, 0u);
        if (gn < N && gc < K)
          rb[nb][s] = *reinterpret_cast<const uint4*>(
              W + ((size_t)nb * N + gn) * K + gc);
      }
  };
  // Registers -> shared half ``b`` (the LayerNorm is applied here).
  auto sstore = [&](int b, int k0) {
    bf16* As = buf + b * (kTileA + kTileB);
    bf16* Bs = As + kTileA;
#pragma unroll
    for (int s = 0; s < kAChunks; ++s) {
      const int idx = threadIdx.x + s * kThreads;
      const int r = idx / (BK / 8), c8 = (idx % (BK / 8)) * 8;
      uint4 val = ra[s];
      if (AMODE == kALn && m0 + r < M && k0 + c8 < K) {
        bf16* e = reinterpret_cast<bf16*>(&val);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int gc = k0 + c8 + i;
          e[i] = __float2bfloat16((__bfloat162float(e[i]) - mu[r]) * rs[r] *
                                      args.ln_g[gc] + args.ln_b[gc]);
        }
      }
      *reinterpret_cast<uint4*>(As + r * LDS + c8) = val;
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int s = 0; s < kBChunks; ++s) {
        const int idx = threadIdx.x + s * kThreads;
        const int r = idx / (BK / 8), c8 = (idx % (BK / 8)) * 8;
        *reinterpret_cast<uint4*>(Bs + (nb * BN + r) * LDS + c8) = rb[nb][s];
      }
  };

  const int wm = warp / 2, wn = warp % 2;  // 4 x 2 warps of 32 x 32
  float acc[NB][2][4][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[nb][i][j][0] = acc[nb][i][j][1] = acc[nb][i][j][2] = acc[nb][i][j][3] = 0.f;

  const int nk = (K + BK - 1) / BK;
  gload(0);
  sstore(0, 0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) gload((kt + 1) * BK);  // in flight during the MMAs
    const bf16* As = buf + (kt & 1) * (kTileA + kTileB);
    const bf16* Bs = As + kTileA;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const bf16* ap = As + (wm * 32 + i * 16 + g) * LDS + kk * 16 + 2 * t;
        af[i][0] = ld32(ap);
        af[i][1] = ld32(ap + 8 * LDS);
        af[i][2] = ld32(ap + 8);
        af[i][3] = ld32(ap + 8 * LDS + 8);
      }
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bf16* bp = Bs + (nb * BN + wn * 32 + j * 8 + g) * LDS + kk * 16 + 2 * t;
          const uint32_t b0 = ld32(bp), b1 = ld32(bp + 8);
#pragma unroll
          for (int i = 0; i < 2; ++i) mma_16816(acc[nb][i][j], af[i], b0, b1);
        }
    }
    if (kt + 1 < nk) sstore((kt + 1) & 1, (kt + 1) * BK);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gr = m0 + wm * 32 + i * 16 + g + 8 * h;
        const int gc = n0 + wn * 32 + j * 8 + 2 * t;
        if (gr >= M || gc >= N) continue;
        const float v0 = acc[0][i][j][2 * h], v1 = acc[0][i][j][2 * h + 1];
        if (EPI == kEpiQkv) {
          const float s = (z == 0) ? args.qscale : 1.f;
          const int n = gr / args.seq, l = gr % args.seq;
          const int hh = gc / args.head_dim, d = gc % args.head_dim;
          store2(args.out[z] +
                     (((size_t)n * args.heads + hh) * args.seq + l) * args.head_dim + d,
                 v0 * s, v1 * s);
        } else if (EPI == kEpiResid) {
          const size_t o = (size_t)gr * N + gc;
          const __nv_bfloat162 r2 = *reinterpret_cast<const __nv_bfloat162*>(args.resid + o);
          store2(args.out[0] + o, v0 + args.bias[gc] + __low2float(r2),
                 v1 + args.bias[gc + 1] + __high2float(r2));
        } else {
          const float* gate = acc[NB - 1][i][j];
          const float g0 = gate[2 * h] + args.bias[N + gc];
          const float g1 = gate[2 * h + 1] + args.bias[N + gc + 1];
          store2(args.out[0] + (size_t)gr * N + gc,
                 (v0 + args.bias[gc]) * gelu_erf(g0),
                 (v1 + args.bias[gc + 1]) * gelu_erf(g1));
        }
      }
}

template <int AMODE, int EPI>
cudaError_t launch(const Args& args, int nz, cudaStream_t stream) {
  constexpr int NB = (EPI == kEpiGeglu) ? 2 : 1;
  constexpr size_t bytes = smem_bytes<NB>();
  static_assert(bytes <= 48 * 1024, "gemm tile exceeds default shared memory");
  if (args.N % 8 != 0 || args.K % 8 != 0) return cudaErrorInvalidValue;
  dim3 grid((args.N + BN - 1) / BN, (args.M + BM - 1) / BM, nz);
  gemm_kernel<AMODE, EPI><<<grid, kThreads, bytes, stream>>>(args);
  return cudaGetLastError();
}

}  // namespace gemm_tile
