// The exp probe of the attention microbenchmark for Hopper (sm_90a):
// out = exp(x) elementwise on f32.
//
// Replaces the TPU kernel of `exp_probe` in tools/bench_attn_micro.py (one
// Pallas block computing jnp.exp over a VMEM-resident (L, L) tile). On this
// card the pass is bound by bytes: 8 bytes an element against a few
// instructions of expf (the accurate one, not __expf, so the kernel keeps
// the plain version's f32 values to an ulp or two). Each thread moves
// 16-byte vectors, neighbouring threads on neighbouring addresses, over a
// grid-strided loop; the tail of n % 4 elements is done one at a time.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 blocks on each of the H100's 132 SMs

__global__ void __launch_bounds__(kThreads)
    exp_kernel(const float* __restrict__ x, float* __restrict__ out, long long n) {
  const long long n4 = n / 4;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  for (long long i = first; i < n4; i += stride) {
    float4 v = reinterpret_cast<const float4*>(x)[i];
    v.x = expf(v.x);
    v.y = expf(v.y);
    v.z = expf(v.z);
    v.w = expf(v.w);
    reinterpret_cast<float4*>(out)[i] = v;
  }
  for (long long i = n4 * 4 + first; i < n; i += stride) out[i] = expf(x[i]);
}

}  // namespace

// x and out 16-byte aligned; n >= 0.
extern "C" int mvldm_micro_exp(const void* x, void* out, long long n, void* stream) {
  if (n < 0 || reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  long long blocks = (n / 4 + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  exp_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n);
  return (int)cudaGetLastError();
}
