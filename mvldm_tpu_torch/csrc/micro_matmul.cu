// The matmul probe of the attention microbenchmark for Hopper (sm_90a):
// out (M, N) = A (M, K) @ B (K, N), both row-major as given, f32
// accumulation, output in the inputs' dtype.
//
// Replaces the TPU kernel of `matmul_probe` in tools/bench_attn_micro.py
// (a Pallas `dot_general(preferred_element_type=f32).astype` gridded over M).
// The probe's question on this card is the rate a hand-written tile reaches
// against cuBLAS, so:
//   * bf16 runs the GEMM core of the fused transformer blocks
//     (gemm_tile.cuh: two warpgroups on wgmma, 256 x 128 tiles through a
//     four-stage cp.async ring where they fill the card, else 128 x 128
//     through three) with B staged as (K, N) rows as given and read through
//     the MN-major descriptor, and a plain epilogue.
//     At 4096 x 1024 x 1024 it is bound by tensor-core operations (8.6 GFLOP
//     against 10.5 MB).
//   * f32 must keep f32 accuracy (a single TF32 product would lose ~1e-3 on
//     arbitrary f32 inputs), so it runs the f32 route's split-TF32 tile
//     (f32_gemm_tile.cuh: each f32 product as three TF32 wgmma, B staged
//     as (K, N) rows and stored transposed on its way into shared memory,
//     the sum leaving the tensor cores' accumulator every 256 of K). Bound
//     by the three TF32 products at 494.7 TFLOP/s.
#include "f32_gemm_tile.cuh"
#include "gemm_tile.cuh"

// f32 != 0 selects the f32 kernel, else bf16. N and K must be multiples of
// 8 (16-byte rows); anything else returns cudaErrorInvalidValue.
extern "C" int mvldm_micro_matmul(const void* a, const void* b, void* out, int M,
                                  int N, int K, int f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0 || N % 8 != 0 || K % 8 != 0) return (int)cudaErrorInvalidValue;
  if (f32) {
    f32_gemm::Args p = {};
    p.a = static_cast<const float*>(a);
    p.b = static_cast<const float*>(b);
    p.out = static_cast<float*>(out);
    p.M = M;
    p.N = N;
    p.K = K;
    p.lda = K;
    p.ldb = p.ldo = N;
    p.bias_div = 1;
    p.alpha = 1.f;
    return (int)f32_gemm::launch<1>(p, 1, s);
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
