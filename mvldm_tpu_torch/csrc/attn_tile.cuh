// Helpers of the attention kernels that keep the FlashAttention-2 register
// layout on mma.sync m16n8k16 (flash_attn_fwd.cu, micro_attn.cu): tile
// loads with zero fill, bf16 packing, and the reductions over the four
// lanes (t = lane % 4) that hold one row of an m16n8 accumulator fragment.
#pragma once

#include "gemm_tile.cuh"  // bf16, ld32, mma_16816

namespace attn_tile {

using gemm_tile::bf16;
using gemm_tile::ld32;
using gemm_tile::mma_16816;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Rows [r0, r0 + R) of a row-major (L, D) bf16 matrix into an (R, DP)
// shared tile with row stride LD, zero past L and D, by a block of THREADS
// threads; with TRANS, into a (DP, R) tile with row stride LD (the
// transposed V of P V). D % 8 == 0.
template <int DP, int R, int LD = DP, bool TRANS = false, int THREADS = 128>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int r0, int L,
                                          int D) {
  constexpr int kChunks = DP / 8;
  for (int idx = threadIdx.x; idx < R * kChunks; idx += THREADS) {
    const int r = idx / kChunks, c = (idx % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < L && c < D)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * D + c);
    if constexpr (TRANS) {
      const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
      for (int i = 0; i < 8; ++i) dst[(c + i) * LD + r] = e[i];
    } else {
      *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
    }
  }
}

}  // namespace attn_tile
