// Fused LayerNorm -> multi-head self-attention -> output projection ->
// residual, y = x + W_o MHA(LN(x)) + b_o, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_attn_kernel` behind `_attn_pallas` in
// mvldm_tpu/ops/fused_attn.py. The TPU kernel keeps all four weight
// matrices in 16 MB of VMEM and runs one token row-block per program; a
// Hopper block has at most 227 KB of shared memory, so the function is
// split into three launches on the same stream:
//   (a) mvldm_ln_qkv: one GEMM against W_q / W_k / W_v (gridDim.z = 3)
//       whose block normalises its 128 rows of x once (f32 statistics, eps
//       1e-6) and keeps LN(x) resident in shared memory while the weight
//       tiles stream, with the softmax scale folded into q, written bf16 as
//       (N, H, L, D); C <= 640, the JAX package's gate for this kernel;
//   (b) the attention core: mvldm_flash_attn_fwd from flash_attn_fwd.cu,
//       called by the Python wrapper with scale 1 and no bias;
//   (c) mvldm_attn_out_proj: the head-merged output times W_o with a
//       "+ b_o + x" epilogue.
// What bounds it on this card: at C = 320 / 640 and L = 1024 / 256 the
// projections are small GEMMs (K = C) and the attention core is
// operation-bound; LN(x) and the q/k/v tiles never exist in f32 in device
// memory, and the residual add happens in the out-projection epilogue, so
// the activation is read once and written once outside the q/k/v/o
// intermediates.
#include "gemm_tile.cuh"

using gemm_tile::Args;
using gemm_tile::bf16;

extern "C" int mvldm_ln_qkv(const void* x, const void* ln_g, const void* ln_b,
                            const void* wq, const void* wk, const void* wv,
                            void* q, void* k, void* v, int M, int C, int HD,
                            int heads, int seq, int head_dim, float eps,
                            float qscale, void* stream) {
  if (C % 8 != 0 || C > gemm_tile::kMaxLnK || head_dim % 8 != 0 || heads * head_dim != HD ||
      M % seq != 0)
    return (int)cudaErrorInvalidValue;
  Args a = {};
  a.a = static_cast<const bf16*>(x);
  a.ln_g = static_cast<const float*>(ln_g);
  a.ln_b = static_cast<const float*>(ln_b);
  a.eps = eps;
  a.M = M; a.N = HD; a.K = C;
  a.w[0] = static_cast<const bf16*>(wq);
  a.w[1] = static_cast<const bf16*>(wk);
  a.w[2] = static_cast<const bf16*>(wv);
  a.out[0] = static_cast<bf16*>(q);
  a.out[1] = static_cast<bf16*>(k);
  a.out[2] = static_cast<bf16*>(v);
  a.heads = heads; a.seq = seq; a.head_dim = head_dim;
  a.qscale = qscale;
  return (int)gemm_tile::launch<gemm_tile::kALn, gemm_tile::kEpiQkv>(
      a, 3, static_cast<cudaStream_t>(stream));
}

extern "C" int mvldm_attn_out_proj(const void* o, const void* wo,
                                   const void* bo, const void* x, void* y,
                                   int M, int C, int HD, int heads, int seq,
                                   int head_dim, void* stream) {
  if (HD % 8 != 0 || head_dim % 8 != 0 || heads * head_dim != HD || M % seq != 0)
    return (int)cudaErrorInvalidValue;
  Args a = {};
  a.a = static_cast<const bf16*>(o);
  a.M = M; a.N = C; a.K = HD;
  a.w[0] = static_cast<const bf16*>(wo);
  a.bias = static_cast<const float*>(bo);
  a.resid = static_cast<const bf16*>(x);
  a.out[0] = static_cast<bf16*>(y);
  a.heads = heads; a.seq = seq; a.head_dim = head_dim;
  return (int)gemm_tile::launch<gemm_tile::kAHeads, gemm_tile::kEpiResid>(
      a, 1, static_cast<cudaStream_t>(stream));
}
