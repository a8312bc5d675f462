// Fused AdamW on f32 masters for Hopper (sm_90a): the gradient
// accumulation, the clip and the AdamW / Adam update of
// training/optim.Optimizer.apply, over every parameter tensor in one launch.
//
// Replaces no TPU kernel: the JAX package leaves its optax chain to XLA,
// which fuses the elementwise ops of a step. On this card the chain is
// bound by bytes (a dozen flops an element against 6-32 bytes), and the
// foreach chain it replaces moves ~270 bytes a parameter over a cycle of
// two micro-steps in ~20 passes with f32 temporaries. Here each byte moves
// once:
//   accumulate: acc <- acc + (g - acc) / (n + 1), g bf16 or f32; on the
//     first micro-step of a cycle acc is not read (the update leaves it
//     zero), so 6 bytes a parameter, then 10;
//   update: reads g (acc, or this step's gradient without accumulation),
//     p, mu and nu once, writes p, mu, nu and acc's zero once: 32 bytes.
// The clip's norm stays on the device: the update reads it from device
// memory (or takes a host value a multi-rank strategy reduced) and selects
// g / norm * clip when !(norm < clip), as optax's select does, a
// non-finite norm included.
//
// Numerics: every operation is the f32 one of the foreach chain on the
// card, in its order, rounded on its own (__fmul_rn / __fadd_rn / __fdiv_rn
// / __fsqrt_rn, so nvcc contracts nothing into an FMA), with the f32
// scalars the chain computes with. PyTorch's CUDA ops divide by a host
// scalar as a product with its f32 reciprocal (1.0f / s, correctly
// rounded), and so does this: the running mean's 1 / (n + 1), the clip's
// 1 / norm (__frcp_rn of the norm it reads), the bias corrections'
// 1 / bc1 and 1 / bc2; a tensor by a tensor (mu_hat / denom) is a true
// quotient. Given the same norm the result is bitwise the chain's.
//
// Design for a memory-bound pass: a persistent grid (one wave of the
// blocks an SM holds) walks a flat work list of (tensor, chunk of kChunk
// elements) items in a device table built once for a state; each thread
// keeps kUnroll independent 16-byte loads of every array in flight,
// neighbouring threads on neighbouring addresses, with the streaming
// (evict-first) hint, since each byte is touched once. A tensor whose
// pointers are not 16-byte aligned (8 for a bf16 gradient) goes one
// element at a time, and so does the tail of a chunk past a multiple of 4.
//
// The gradients are new tensors every micro-step; their pointers come by
// value in the kernel's parameters (up to 32 KB with CUDA 12.1 and later:
// kCapacity tensors a launch), so no host copy and no sync precedes a
// launch; more tensors take more launches.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;             // 16-byte loads of each array in flight per thread
constexpr long long kChunk = 1 << 16;  // elements a work item; ops/fused_adamw.CHUNK

#if CUDART_VERSION >= 12010
constexpr int kCapacity = 3200;  // 9 bytes a tensor of the 32,764 a launch's parameters hold
#else
constexpr int kCapacity = 400;   // of 4,096
#endif

// One tensor of the state: its f32 master, moments, accumulator (null
// without accumulation) and size; ops/fused_adamw.Plan writes it as 5 int64.
struct Entry {
  float* p;
  float* mu;
  float* nu;
  float* acc;
  long long n;
};
static_assert(sizeof(Entry) == 40, "Entry is 5 int64 in ops/fused_adamw.py");

// A launch's share of the work list, and this step's gradients of the
// tensors [tensor_begin, tensor_begin + kCapacity) it covers.
struct Work {
  const Entry* table;
  const int2* items;  // (tensor, chunk), sorted by tensor
  int item_begin, item_end, tensor_begin;
  const void* grads[kCapacity];
  unsigned char bf16[kCapacity];
};

struct Hyper {
  float b1, one_minus_b1, b2, one_minus_b2, rcp_bc1, rcp_bc2, eps, wd, neg_lr, clip;
  double clip_d;          // the threshold as the host compares it (norm < clip in double)
  const float* norm_ptr;  // the clip's norm on the device, or null: norm_val
  float norm_val;
  int has_clip, has_wd;
};

__device__ __forceinline__ bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

__device__ __forceinline__ float4 load4(const float* p, long long i) {
  return __ldcs(reinterpret_cast<const float4*>(p + i));
}

__device__ __forceinline__ void store4(float* p, long long i, float4 v) {
  __stcs(reinterpret_cast<float4*>(p + i), v);
}

// Four gradient elements in f32 (a bf16 value widens exactly: its bits on top).
__device__ __forceinline__ float4 load_grad4(const void* g, bool bf16, long long i) {
  if (bf16) {
    const uint2 r = __ldcs(reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(g) + i));
    return make_float4(__uint_as_float(r.x << 16), __uint_as_float(r.x & 0xffff0000u),
                       __uint_as_float(r.y << 16), __uint_as_float(r.y & 0xffff0000u));
  }
  return __ldcs(reinterpret_cast<const float4*>(static_cast<const float*>(g) + i));
}

__device__ __forceinline__ float load_grad(const void* g, bool bf16, long long i) {
  if (bf16) return __bfloat162float(static_cast<const __nv_bfloat16*>(g)[i]);
  return static_cast<const float*>(g)[i];
}

// optax.MultiSteps' running mean: acc + (g - acc) / (n + 1), the division
// a product with rcp = 1 / (n + 1) in f32.
__device__ __forceinline__ float running_mean(float a, float g, float rcp) {
  return __fadd_rn(a, __fmul_rn(__fsub_rn(g, a), rcp));
}

// The clip, then scale_by_adam, the decoupled decay and the learning rate,
// in the foreach chain's order (training/optim.py, Optimizer._adam).
__device__ __forceinline__ void adam(float g, float& p, float& m, float& v, const Hyper& h,
                                     bool clip, float rcp_norm) {
  if (clip) g = __fmul_rn(__fmul_rn(g, rcp_norm), h.clip);
  m = __fadd_rn(__fmul_rn(g, h.one_minus_b1), __fmul_rn(m, h.b1));
  v = __fadd_rn(__fmul_rn(__fmul_rn(g, g), h.one_minus_b2), __fmul_rn(v, h.b2));
  float u = __fdiv_rn(__fmul_rn(m, h.rcp_bc1),
                      __fadd_rn(__fsqrt_rn(__fmul_rn(v, h.rcp_bc2)), h.eps));
  if (h.has_wd) u = __fadd_rn(u, __fmul_rn(p, h.wd));
  p = __fadd_rn(p, __fmul_rn(u, h.neg_lr));
}

// The vector part of item [start, end) ends at vend (start is a multiple of 4).
__device__ __forceinline__ long long vector_end(long long start, long long end, bool vec) {
  return vec ? start + ((end - start) & ~3LL) : start;
}

template <bool kFirst>
__global__ void __launch_bounds__(kThreads)
    accumulate_kernel(const __grid_constant__ Work w, float rcp_count) {
  constexpr long long kStride = (long long)kThreads * 4;
  for (int item = w.item_begin + blockIdx.x; item < w.item_end; item += gridDim.x) {
    const int2 it = w.items[item];
    const Entry e = w.table[it.x];
    const void* g = w.grads[it.x - w.tensor_begin];
    const bool bf16 = w.bf16[it.x - w.tensor_begin];
    const long long start = (long long)it.y * kChunk;
    const long long end = start + kChunk < e.n ? start + kChunk : e.n;
    const bool vec = aligned(e.acc, 16) && aligned(g, bf16 ? 8 : 16);
    const long long vend = vector_end(start, end, vec);
    for (long long i0 = start + (long long)threadIdx.x * 4; i0 < vend; i0 += kStride * kUnroll) {
      float4 gv[kUnroll], av[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = i0 + u * kStride;
        if (i < vend) {
          gv[u] = load_grad4(g, bf16, i);
          av[u] = kFirst ? make_float4(0.f, 0.f, 0.f, 0.f) : load4(e.acc, i);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = i0 + u * kStride;
        if (i >= vend) continue;
        float4 a = av[u];
        a.x = running_mean(a.x, gv[u].x, rcp_count);
        a.y = running_mean(a.y, gv[u].y, rcp_count);
        a.z = running_mean(a.z, gv[u].z, rcp_count);
        a.w = running_mean(a.w, gv[u].w, rcp_count);
        store4(e.acc, i, a);
      }
    }
    for (long long i = vend + threadIdx.x; i < end; i += kThreads)
      e.acc[i] = running_mean(kFirst ? 0.f : e.acc[i], load_grad(g, bf16, i), rcp_count);
  }
}

// kFromAcc: g is the accumulator, zeroed after; otherwise this step's gradient.
template <bool kFromAcc>
__global__ void __launch_bounds__(kThreads)
    update_kernel(const __grid_constant__ Work w, const __grid_constant__ Hyper h) {
  constexpr long long kStride = (long long)kThreads * 4;
  const float norm = h.norm_ptr ? *h.norm_ptr : h.norm_val;
  const bool clip = h.has_clip && !((double)norm < h.clip_d);
  const float rcp_norm = __frcp_rn(norm);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int item = w.item_begin + blockIdx.x; item < w.item_end; item += gridDim.x) {
    const int2 it = w.items[item];
    const Entry e = w.table[it.x];
    const void* g = kFromAcc ? static_cast<const void*>(e.acc) : w.grads[it.x - w.tensor_begin];
    const bool bf16 = kFromAcc ? false : w.bf16[it.x - w.tensor_begin];
    const long long start = (long long)it.y * kChunk;
    const long long end = start + kChunk < e.n ? start + kChunk : e.n;
    const bool vec = aligned(e.p, 16) && aligned(e.mu, 16) && aligned(e.nu, 16) &&
                     aligned(g, bf16 ? 8 : 16);
    const long long vend = vector_end(start, end, vec);
    for (long long i0 = start + (long long)threadIdx.x * 4; i0 < vend; i0 += kStride * kUnroll) {
      float4 gv[kUnroll], pv[kUnroll], mv[kUnroll], vv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = i0 + u * kStride;
        if (i < vend) {
          gv[u] = load_grad4(g, bf16, i);
          pv[u] = load4(e.p, i);
          mv[u] = load4(e.mu, i);
          vv[u] = load4(e.nu, i);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = i0 + u * kStride;
        if (i >= vend) continue;
        adam(gv[u].x, pv[u].x, mv[u].x, vv[u].x, h, clip, rcp_norm);
        adam(gv[u].y, pv[u].y, mv[u].y, vv[u].y, h, clip, rcp_norm);
        adam(gv[u].z, pv[u].z, mv[u].z, vv[u].z, h, clip, rcp_norm);
        adam(gv[u].w, pv[u].w, mv[u].w, vv[u].w, h, clip, rcp_norm);
        store4(e.p, i, pv[u]);
        store4(e.mu, i, mv[u]);
        store4(e.nu, i, vv[u]);
        if (kFromAcc) store4(e.acc, i, zero);
      }
    }
    for (long long i = vend + threadIdx.x; i < end; i += kThreads) {
      float p = e.p[i], m = e.mu[i], v = e.nu[i];
      adam(load_grad(g, bf16, i), p, m, v, h, clip, rcp_norm);
      e.p[i] = p;
      e.mu[i] = m;
      e.nu[i] = v;
      if (kFromAcc) e.acc[i] = 0.f;
    }
  }
}

// The blocks of kThreads that fill every SM of the current device once.
template <typename Kernel>
long long one_wave(Kernel kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0) != cudaSuccess)
    return 0;
  return (long long)sms * per_sm;
}

int fill(Work& w, const void* table, const void* items, int item_begin, int item_end,
         int tensor_begin, int n_grads, const unsigned long long* grads,
         const unsigned char* bf16) {
  if (!table || !items || item_begin < 0 || item_end < item_begin || n_grads < 0 ||
      n_grads > kCapacity || (n_grads > 0 && (!grads || !bf16)))
    return (int)cudaErrorInvalidValue;
  w.table = static_cast<const Entry*>(table);
  w.items = static_cast<const int2*>(items);
  w.item_begin = item_begin;
  w.item_end = item_end;
  w.tensor_begin = tensor_begin;
  for (int i = 0; i < n_grads; ++i) {
    w.grads[i] = reinterpret_cast<const void*>(grads[i]);
    w.bf16[i] = bf16[i];
  }
  return (int)cudaSuccess;
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, long long wave, int items, void* stream, Args... args) {
  if (wave <= 0) return (int)cudaErrorInvalidConfiguration;
  const long long blocks = items < wave ? items : wave;
  kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

// Gradients a launch takes.
extern "C" int mvldm_fused_adamw_capacity() { return kCapacity; }

// acc <- acc + (g - acc) * rcp_count over items [item_begin, item_end) of the
// plan's work list, whose tensors start at tensor_begin; grads[i] (bf16 when
// bf16[i]) is tensor tensor_begin + i's gradient. first: acc is zero and not read.
extern "C" int mvldm_fused_adamw_accumulate(const void* table, const void* items,
                                            int item_begin, int item_end, int tensor_begin,
                                            int n_grads, const unsigned long long* grads,
                                            const unsigned char* bf16, float rcp_count, int first,
                                            void* stream) {
  Work w;
  const int err = fill(w, table, items, item_begin, item_end, tensor_begin, n_grads, grads, bf16);
  if (err != (int)cudaSuccess || item_end == item_begin) return err;
  if (first) {
    static const long long wave = one_wave(accumulate_kernel<true>);
    return launch(accumulate_kernel<true>, wave, item_end - item_begin, stream, w, rcp_count);
  }
  static const long long wave = one_wave(accumulate_kernel<false>);
  return launch(accumulate_kernel<false>, wave, item_end - item_begin, stream, w, rcp_count);
}

// The clip and AdamW update of items [item_begin, item_end): from the
// accumulators (from_acc, n_grads 0; each zeroed after) or from this step's
// gradients as in mvldm_fused_adamw_accumulate. norm_ptr: the clip's norm
// on the device, or null to take norm_val.
extern "C" int mvldm_fused_adamw_update(const void* table, const void* items, int item_begin,
                                        int item_end, int tensor_begin, int n_grads,
                                        const unsigned long long* grads,
                                        const unsigned char* bf16, int from_acc, float b1,
                                        float one_minus_b1, float b2, float one_minus_b2,
                                        float rcp_bc1, float rcp_bc2, float eps, float wd,
                                        float neg_lr,
                                        float clip, double clip_d, int has_clip, int has_wd,
                                        const void* norm_ptr, float norm_val, void* stream) {
  Work w;
  const int err = fill(w, table, items, item_begin, item_end, tensor_begin, n_grads, grads, bf16);
  if (err != (int)cudaSuccess || item_end == item_begin) return err;
  Hyper h;
  h.b1 = b1;
  h.one_minus_b1 = one_minus_b1;
  h.b2 = b2;
  h.one_minus_b2 = one_minus_b2;
  h.rcp_bc1 = rcp_bc1;
  h.rcp_bc2 = rcp_bc2;
  h.eps = eps;
  h.wd = wd;
  h.neg_lr = neg_lr;
  h.clip = clip;
  h.clip_d = clip_d;
  h.norm_ptr = static_cast<const float*>(norm_ptr);
  h.norm_val = norm_val;
  h.has_clip = has_clip;
  h.has_wd = has_wd;
  if (from_acc) {
    static const long long wave = one_wave(update_kernel<true>);
    return launch(update_kernel<true>, wave, item_end - item_begin, stream, w, h);
  }
  static const long long wave = one_wave(update_kernel<false>);
  return launch(update_kernel<false>, wave, item_end - item_begin, stream, w, h);
}
