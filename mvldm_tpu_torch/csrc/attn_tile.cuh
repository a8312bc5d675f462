// Helpers of the attention kernels that keep the FlashAttention-2 register
// layout on mma.sync m16n8k16 (micro_attn.cu's TF32 and fullk bodies), and
// the row reductions the wgmma kernels share with them: tile loads with zero
// fill, bf16 packing, the m16n8k16 product, and the reductions over the four
// lanes (t = lane % 4) that hold one row of an m16n8 (or wgmma) accumulator.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn_tile {

typedef __nv_bfloat16 bf16;

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
