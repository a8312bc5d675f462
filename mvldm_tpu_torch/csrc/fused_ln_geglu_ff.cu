// Fused LayerNorm -> GEGLU feed-forward -> residual for Hopper (sm_90a):
//   y = x + W2 (h * gelu_erf(g)) + b2,   [h | g] = LN(x) W1 + b1.
//
// Replaces the TPU kernel `_ff_kernel` behind `_ff_pallas` in
// mvldm_tpu/ops/fused_ff.py. The TPU kernel's premise is that W1 and W2
// stay resident in VMEM while token tiles stream through; on Hopper W1
// alone is 6.5 MB at C = 640, far beyond a block's 227 KB of shared
// memory, so the function runs as two launches:
//   (1) mvldm_ff_geglu: GEMM against W1 whose block normalises its 128
//       rows of x once (f32 statistics, eps 1e-6, LN(x) rounded to bf16
//       before the product as in the JAX kernel; C <= 640, the JAX
//       package's gate) and keeps them resident while W1 streams, with a
//       GEGLU epilogue with CUDA's erff (the TPU kernel's Abramowitz-Stegun
//       erf existed only because Mosaic lacks erf); each B tile stacks 64 h
//       rows and their 64 gate rows, so one product yields both halves of
//       the same output tile and the (tokens, 8C) product never reaches
//       device memory; only act = h * gelu(g), (tokens, 4C) in bf16, does.
//   (2) mvldm_ff_out: GEMM against W2 with a "+ b2 + x" epilogue.
// What bounds it on this card: at 20 frames x 1024 tokens x C = 320 the
// two GEMMs do ~2.7e11 flops on ~30 MB, above the ridge, so tensor-core
// operations bound it; the design keeps the 8C-wide intermediate and the
// f32 LayerNorm out of device memory and writes act once in bf16.
#include "gemm_tile.cuh"

using gemm_tile::Args;
using gemm_tile::bf16;

extern "C" int mvldm_ff_geglu(const void* x, const void* ln_g,
                              const void* ln_b, const void* w1,
                              const void* b1, void* act, int M, int C, int F,
                              float eps, void* stream) {
  if (C % 8 != 0 || C > gemm_tile::kMaxLnK) return (int)cudaErrorInvalidValue;
  Args a = {};
  a.a = static_cast<const bf16*>(x);
  a.ln_g = static_cast<const float*>(ln_g);
  a.ln_b = static_cast<const float*>(ln_b);
  a.eps = eps;
  a.M = M; a.N = F; a.K = C;
  a.w[0] = static_cast<const bf16*>(w1);
  a.bias = static_cast<const float*>(b1);
  a.out[0] = static_cast<bf16*>(act);
  return (int)gemm_tile::launch<gemm_tile::kALn, gemm_tile::kEpiGeglu>(
      a, 1, static_cast<cudaStream_t>(stream));
}

extern "C" int mvldm_ff_out(const void* act, const void* w2, const void* b2,
                            const void* x, void* y, int M, int C, int F,
                            void* stream) {
  if (F % 8 != 0) return (int)cudaErrorInvalidValue;
  Args a = {};
  a.a = static_cast<const bf16*>(act);
  a.M = M; a.N = C; a.K = F;
  a.w[0] = static_cast<const bf16*>(w2);
  a.bias = static_cast<const float*>(b2);
  a.resid = static_cast<const bf16*>(x);
  a.out[0] = static_cast<bf16*>(y);
  return (int)gemm_tile::launch<gemm_tile::kAPlain, gemm_tile::kEpiResid>(
      a, 1, static_cast<cudaStream_t>(stream));
}
