// The matmul probe of the attention microbenchmark for Hopper (sm_90a):
// out (M, N) = A (M, K) @ B (K, N), both row-major as given, f32
// accumulation, output in the inputs' dtype.
//
// Replaces the TPU kernel of `matmul_probe` in tools/bench_attn_micro.py
// (a Pallas `dot_general(preferred_element_type=f32).astype` gridded over M).
// The probe's question on this card is the rate a hand-written tile reaches
// against cuBLAS, so:
//   * bf16 runs the GEMM core of the fused transformer blocks
//     (gemm_tile.cuh: 128 x 64 tiles of eight warps on mma.sync m16n8k16,
//     register-staged double buffer) with B staged as (K, N) rows and read
//     by ldmatrix.trans, and a plain epilogue. At 4096 x 1024 x 1024 it is
//     bound by tensor-core operations (8.6 GFLOP against 10.5 MB).
//   * f32 must not go through TF32 (arbitrary f32 inputs would lose ~1e-3),
//     so it is a register-blocked FFMA kernel bound by the FP32 rate: a
//     128 x 128 output tile per block of 256 threads, each thread an 8 x 8
//     block split as rows {ty*4 + i, 64 + ty*4 + i} and columns
//     {tx*4 + j, 64 + tx*4 + j}, so its shared-memory reads are float4s that
//     hit distinct banks; A is staged transposed (k-major) and B as is, the
//     next 8-deep step is loaded into registers while the current one is
//     multiplied.
#include "gemm_tile.cuh"

namespace {

constexpr int kTile = 128, kDepth = 8, kF32Threads = 256;

__global__ void __launch_bounds__(kF32Threads)
    matmul_f32_kernel(const float* __restrict__ a, const float* __restrict__ b,
                      float* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) float As[2][kDepth][kTile];  // As[k][m]
  __shared__ __align__(16) float Bs[2][kDepth][kTile];  // Bs[k][n]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  // Each thread stages one float4 of A (row ar, k ak..ak+3) and one of B
  // (k row br, columns bc..bc+3) per step.
  const int ar = tid / 2, ak = (tid % 2) * 4;
  const int br = tid / 32, bc = (tid % 32) * 4;

  auto load = [&](int k0, float4& ra, float4& rb) {
    ra = make_float4(0.f, 0.f, 0.f, 0.f);
    rb = make_float4(0.f, 0.f, 0.f, 0.f);
    if (m0 + ar < M && k0 + ak < K)
      ra = *reinterpret_cast<const float4*>(a + (size_t)(m0 + ar) * K + k0 + ak);
    if (k0 + br < K && n0 + bc < N)
      rb = *reinterpret_cast<const float4*>(b + (size_t)(k0 + br) * N + n0 + bc);
  };
  auto store = [&](int s, const float4& ra, const float4& rb) {
    As[s][ak + 0][ar] = ra.x;
    As[s][ak + 1][ar] = ra.y;
    As[s][ak + 2][ar] = ra.z;
    As[s][ak + 3][ar] = ra.w;
    *reinterpret_cast<float4*>(&Bs[s][br][bc]) = rb;
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float4 ra, rb;
  load(0, ra, rb);
  store(0, ra, rb);
  __syncthreads();
  const int nk = (K + kDepth - 1) / kDepth;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < nk) load((kt + 1) * kDepth, ra, rb);  // in flight during the FMAs
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      float av[8], bv[8];
      *reinterpret_cast<float4*>(av) = *reinterpret_cast<const float4*>(&As[s][kk][ty * 4]);
      *reinterpret_cast<float4*>(av + 4) =
          *reinterpret_cast<const float4*>(&As[s][kk][64 + ty * 4]);
      *reinterpret_cast<float4*>(bv) = *reinterpret_cast<const float4*>(&Bs[s][kk][tx * 4]);
      *reinterpret_cast<float4*>(bv + 4) =
          *reinterpret_cast<const float4*>(&Bs[s][kk][64 + tx * 4]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (kt + 1 < nk) store(s ^ 1, ra, rb);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + (i / 4) * 64 + ty * 4 + (i % 4);
    if (r >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = n0 + h * 64 + tx * 4;
      if (c < N)
        *reinterpret_cast<float4*>(out + (size_t)r * N + c) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
    }
  }
}

}  // namespace

// f32 != 0 selects the f32 kernel, else bf16. N and K must be multiples of
// 8 (16-byte rows); anything else returns cudaErrorInvalidValue.
extern "C" int mvldm_micro_matmul(const void* a, const void* b, void* out, int M,
                                  int N, int K, int f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0 || N % 8 != 0 || K % 8 != 0 ||
      (M + kTile - 1) / kTile > 65535)
    return (int)cudaErrorInvalidValue;
  if (f32) {
    dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile);
    matmul_f32_kernel<<<grid, kF32Threads, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<float*>(out), M, N, K);
    return (int)cudaGetLastError();
  }
  gemm_tile::Args args = {};
  args.a = static_cast<const gemm_tile::bf16*>(a);
  args.M = M;
  args.N = N;
  args.K = K;
  args.w[0] = static_cast<const gemm_tile::bf16*>(b);
  args.out[0] = static_cast<gemm_tile::bf16*>(out);
  return (int)gemm_tile::launch<gemm_tile::kAPlain, gemm_tile::kEpiPlain, true>(args, 1, s);
}
