// The exp probe of the attention microbenchmark for Hopper (sm_90a):
// out = exp(x) elementwise on f32.
//
// Replaces the TPU kernel of `exp_probe` in tools/bench_attn_micro.py (one
// Pallas block computing jnp.exp over a VMEM-resident (L, L) tile). On this
// card the pass is bound by bytes: 8 bytes an element against a few
// instructions of expf (the accurate one, not __expf, so the kernel keeps
// the plain version's f32 values to an ulp or two). The design keeps bytes
// in flight: one wave of blocks (as many as the SMs hold at once, no tail
// wave), each thread issuing kUnroll independent 16-byte loads, neighbouring
// threads on neighbouring addresses, before its first expf, over a
// grid-strided loop; loads and stores carry the streaming hint (evict
// first: each byte is touched once). The tail of n % 4 elements is done one
// at a time.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;  // 16-byte loads in flight per thread

__global__ void __launch_bounds__(kThreads)
    exp_kernel(const float* __restrict__ x, float* __restrict__ out, long long n) {
  const long long n4 = n / 4;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* o4 = reinterpret_cast<float4*>(out);
  const long long step = (long long)gridDim.x * kThreads * kUnroll;
  for (long long i0 = (long long)blockIdx.x * kThreads * kUnroll + threadIdx.x; i0 < n4;
       i0 += step) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + (long long)u * kThreads;
      if (i < n4) v[u] = __ldcs(x4 + i);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + (long long)u * kThreads;
      if (i >= n4) continue;
      v[u].x = expf(v[u].x);
      v[u].y = expf(v[u].y);
      v[u].z = expf(v[u].z);
      v[u].w = expf(v[u].w);
      __stcs(o4 + i, v[u]);
    }
  }
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  for (long long i = n4 * 4 + first; i < n; i += (long long)gridDim.x * kThreads)
    out[i] = expf(x[i]);
}

// Blocks that fill every SM of the current device once (its SM count times
// the blocks of kThreads an SM holds), read once.
long long one_wave() {
  static const long long blocks = [] {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, exp_kernel, kThreads, 0) !=
            cudaSuccess)
      return 0LL;
    return (long long)sms * per_sm;
  }();
  return blocks;
}

}  // namespace

// x and out 16-byte aligned; n >= 0.
extern "C" int mvldm_micro_exp(const void* x, void* out, long long n, void* stream) {
  if (n < 0 || reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const long long wave = one_wave();
  if (wave <= 0) return (int)cudaErrorInvalidConfiguration;
  long long blocks = (n / 4 + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  if (blocks < 1) blocks = 1;
  if (blocks > wave) blocks = wave;
  exp_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n);
  return (int)cudaGetLastError();
}
