// Row reductions of the attention kernels (flash_attn_fwd.cu,
// flash_attn_bwd.cu, micro_attn.cu): the max and the sum over the four
// lanes (t = lane % 4) that hold one row of a wgmma accumulator.
#pragma once

#include <cuda_runtime.h>

namespace attn_tile {

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace attn_tile
