// GroupNorm over channels-last (NHWC) bf16 feature maps for Hopper (sm_90a),
// with the ResNet block's time-embedding add and the SiLU fused:
//   y = act(GroupNorm(x + add[n, c]))            (ops/group_norm.py)
// Statistics in f32, the affine map and the SiLU on the f32 value, one
// rounding to bf16; the output is channels-last.
//
// Replaces no TPU kernel: the JAX package leaves GroupNorm to XLA, which
// fuses the add before it and the SiLU after it into its passes
// (mvldm_tpu/models/layers.py, GroupNorm). On this card the stock chain is
// aten's GroupNorm, which reads NCHW only (a channels-last input is copied
// first), a SiLU pass and an add pass, and cuDNN, whose sm_90 convolutions
// run NHWC, transposes in and out of every convolution of an NCHW UNet. This
// kernel lets the UNet stay channels-last from its first convolution to its
// last.
//
// Bound: bytes. One read and one write of x, 4 bytes an element, at
// 3.35 TB/s; some 15 flops an element.
//
// Statistics: one pass of shifted sums. Each group's sums are of
// d = x + add - K and d^2, K the group's first value in the sample (pixel 0,
// its first channel), which every CTA reads; then mean = K + S / m and
// var = Q / m - (S / m)^2. K is a value of the group, so (mean - K)^2 is of
// the order of var and the difference loses no more than a few f32 ulps.
//
// Design. A sample's slab (hw pixels x c channels) is contiguous in NHWC. It
// is cut into `ctas` stripes of `pixels` pixels, and
//  * cluster route (the slab fits the shared memory of a cluster of at most
//    8 CTAs): a thread block cluster a sample, a CTA a stripe. Each CTA
//    loads its stripe into shared memory once (16-byte cp.async, each
//    thread on its neighbour's next 16 bytes, in four groups whose sums it
//    takes as they land), reduces its group sums across the cluster through
//    distributed shared memory, and normalises from shared memory with one
//    16-byte store a thread and pixel: x is read once and y written once.
//    The grid is persistent: as many clusters as the card holds, each
//    walking the samples.
//  * two-pass route (a larger slab: the VAE's, and 960 channels at 32 x 32):
//    gn_stats_kernel streams each stripe from global memory and writes its
//    groups' sums; gn_finalize_kernel adds a sample's stripes in order (in
//    double); gn_apply_kernel reads x again and writes y: 3 byte-passes.
// Threads: c / 8 vector columns x `rows` pixel rows, a multiple of a warp;
// a thread always holds the same 8 channels, which span at most two groups
// (the wrapper checks), and sums them over its pixels in f32. Group sums
// are folded in a fixed order (each warp a group: lane by lane, then a
// shuffle tree; CTA rank by rank across the cluster), so a result depends
// on the sample's own values and the plan alone, which depends on
// (hw, c, groups): a sample gives the same bits in any batch.
// The host writes mean and rstd (n, groups) f32 for the backward.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxSmem = 232448;  // 227 KB: the most dynamic shared memory a block takes
constexpr int kMaxCluster = 8;    // the portable cluster size
constexpr int kChunks = 4;        // copy groups a stripe loads in
constexpr int kRounds = 4;        // groups a warp reduces across the cluster (<= kRounds x warps)

using bf16 = __nv_bfloat16;

struct Params {
  const bf16* x;       // (n, hw, c)
  const bf16* add;     // (n, c), or null
  const bf16* weight;  // (c)
  const bf16* bias;    // (c)
  bf16* y;             // (n, hw, c)
  float* mean;         // (n, groups), or null on the cluster route: not written
  float* rstd;         // (n, groups)
  float2* partial;     // two-pass route: (n, ctas, groups) of a stripe's (S, Q)
  int n, hw, c, groups, cg, pixels, ctas, silu;
  float eps;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

// Wait until at most `pending` (< kChunks) copy groups of this thread are in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
}

// Sixteen bytes of bf16 in f32 (a bf16 value widens exactly: its bits on top).
__device__ __forceinline__ void unpack8(const uint4 r, float* f) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    f[2 * j] = __uint_as_float(w[j] << 16);
    f[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
    w[j] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// A thread's 8 channels, 8v .. 8v + 7: lanes j < split lie in group g_lo,
// the others in g_hi; its pixel rows are row, row + rows, ...
struct Lanes {
  int v, row, rows, g_lo, g_hi, split;
};

__device__ __forceinline__ Lanes lanes(const Params& p) {
  Lanes l;
  const int vc = p.c / 8;
  l.v = threadIdx.x % vc;
  l.row = threadIdx.x / vc;
  l.rows = blockDim.x / vc;
  l.g_lo = 8 * l.v / p.cg;
  l.g_hi = (8 * l.v + 7) / p.cg;
  l.split = l.g_hi == l.g_lo ? 8 : l.g_hi * p.cg - 8 * l.v;
  return l;
}

// Group g's shift K: its first value in sample n.
__device__ __forceinline__ float shift_of(const Params& p, int n, int g) {
  const int ch = g * p.cg;
  const float x = __bfloat162float(p.x[(size_t)n * p.hw * p.c + ch]);
  return p.add ? x + __bfloat162float(p.add[(size_t)n * p.c + ch]) : x;
}

// The add of each of the thread's channels in sample n (0 without one).
__device__ __forceinline__ void load_add(const Params& p, const Lanes& l, int n, float* a) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
    a[j] = p.add ? __bfloat162float(p.add[(size_t)n * p.c + 8 * l.v + j]) : 0.f;
}

// A thread's running sums of d = x + a - K and d^2, lane by lane; ak = a - K.
struct Acc {
  float s[8], q[8];
};

__device__ __forceinline__ void accumulate(Acc& acc, const uint4 in, const float* ak) {
  float f[8];
  unpack8(in, f);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float d = f[j] + ak[j];
    acc.s[j] += d;
    acc.q[j] = fmaf(d, d, acc.q[j]);
  }
}

// (S_lo, Q_lo, S_hi, Q_hi): the thread's sums folded into its two groups.
__device__ __forceinline__ float4 fold_lanes(const Acc& acc, const Lanes& l) {
  float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j < l.split) {
      t.x += acc.s[j];
      t.y += acc.q[j];
    } else {
      t.z += acc.s[j];
      t.w += acc.q[j];
    }
  }
  return t;
}

// out[g] = group g's (S, Q) over the block's threads, from each thread's
// fold_lanes in red: a warp a group, a lane a pixel row over the group's
// columns, then a shuffle tree.
__device__ __forceinline__ void fold_groups(const float4* red, float2* out, const Params& p) {
  const int vc = p.c / 8, rows = blockDim.x / vc;
  const int lane = threadIdx.x % 32, warps = blockDim.x / 32;
  for (int g = threadIdx.x / 32; g < p.groups; g += warps) {
    const int c0 = g * p.cg, v0 = c0 / 8, v1 = (c0 + p.cg - 1) / 8;
    float s = 0.f, q = 0.f;
    for (int r = lane; r < rows; r += 32)
      for (int v = v0; v <= v1; ++v) {
        const float4 t = red[r * vc + v];
        const bool lo = 8 * v >= c0;  // else g is the column's upper group
        s += lo ? t.x : t.z;
        q += lo ? t.y : t.w;
      }
#pragma unroll
    for (int off = 16; off; off >>= 1) {
      s += __shfl_down_sync(0xffffffffu, s, off);
      q += __shfl_down_sync(0xffffffffu, q, off);
    }
    if (lane == 0) out[g] = make_float2(s, q);
  }
}

// A group's mean and rstd from its shift and sums over 1 / inv_m values.
__device__ __forceinline__ float2 moments(float k, float s, float q, float inv_m, float eps) {
  const float ds = s * inv_m;
  return make_float2(k + ds, rsqrtf(fmaxf(q * inv_m - ds * ds, 0.f) + eps));
}

// z = (x + a - mean) * rstd * weight + bias = (x + off) * scale + shift,
// then z * sigmoid(z), rounded once.
__device__ __forceinline__ uint4 normalise(const uint4 in, const float* off, const float* scale,
                                           const float* shift, int silu) {
  float f[8];
  unpack8(in, f);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float z = fmaf(f[j] + off[j], scale[j], shift[j]);
    if (silu) z = __fdividef(z, 1.f + __expf(-z));
    f[j] = z;
  }
  return pack8(f);
}

// Issue the copies of chunk k (of kChunks, by pixels) of an npix x c stripe
// as one copy group.
__device__ __forceinline__ void issue_chunk(bf16* s, const bf16* x, int npix, int c, int k) {
  const int v0 = k * npix / kChunks * c / 8, v1 = (k + 1) * npix / kChunks * c / 8;
  for (int i = v0 + threadIdx.x; i < v1; i += blockDim.x) cp_async16(s + 8 * i, x + 8 * i);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The cluster route. The grid holds as many clusters as the card runs at
// once (gridDim.y), each a sample at a time: blockIdx.y, then every
// gridDim.y-th sample after it; a CTA loads the next sample's stripe chunk
// by chunk as it normalises and stores this one's. Shared memory: the
// stripe, each thread's
// fold_lanes, the CTA's group sums (two buffers, by the parity of the
// sample's turn), each group's (mean, rstd), each group's shift, the
// weight and the bias in f32.
// Two CTAs an SM (64 registers a thread), so that one CTA's loads overlap
// the other's statistics and stores.
__global__ void __launch_bounds__(kMaxThreads, 2) gn_cluster_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = blockIdx.x;  // the cluster spans x: a sample's stripes
  const int p0 = rank * p.pixels, npix = min(p.pixels, p.hw - p0);
  bf16* stripe = reinterpret_cast<bf16*>(smem);
  float4* red = reinterpret_cast<float4*>(smem + (size_t)p.pixels * p.c * sizeof(bf16));
  float2* const parts = reinterpret_cast<float2*>(red + blockDim.x);
  float2* stat = parts + 2 * p.groups;
  float* kshift = reinterpret_cast<float*>(stat + p.groups);
  float* weight = kshift + p.groups;
  float* bias = weight + p.c;
  const float inv_count = 1.f / ((float)p.hw * (float)p.cg);
  const int lane = threadIdx.x % 32, warps = blockDim.x / 32;
  const Lanes l = lanes(p);
  for (int ch = threadIdx.x; ch < p.c; ch += blockDim.x) {
    weight[ch] = __bfloat162float(p.weight[ch]);
    bias[ch] = __bfloat162float(p.bias[ch]);
  }
  const auto stripe_of = [&](int n) { return p.x + ((size_t)n * p.hw + p0) * p.c; };
  if (blockIdx.y < p.n)
    for (int k = 0; k < kChunks; ++k) issue_chunk(stripe, stripe_of(blockIdx.y), npix, p.c, k);

  for (int n = blockIdx.y, turn = 0; n < p.n; n += gridDim.y, ++turn) {
    // A CTA may write its next turn's sums while another still reads this
    // turn's; it writes the turn after only past the next cluster.sync,
    // which every CTA reaches after its reads.
    float2* part = parts + (turn & 1) * p.groups;
    const int next = n + gridDim.y;
    for (int g = threadIdx.x; g < p.groups; g += blockDim.x) kshift[g] = shift_of(p, n, g);
    float a[8], ak[8];
    load_add(p, l, n, a);
    Acc acc;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc.s[j] = acc.q[j] = 0.f;
    int q = l.row;
    for (int k = 0; k < kChunks; ++k) {
      cp_async_wait(kChunks - 1 - k);
      __syncthreads();
      if (k == 0) {
#pragma unroll
        for (int j = 0; j < 8; ++j) ak[j] = a[j] - kshift[j < l.split ? l.g_lo : l.g_hi];
      }
      for (const int end = (k + 1) * npix / kChunks; q < end; q += l.rows)
        accumulate(acc, *reinterpret_cast<const uint4*>(stripe + (size_t)q * p.c + 8 * l.v), ak);
    }
    red[threadIdx.x] = fold_lanes(acc, l);
    __syncthreads();
    fold_groups(red, part, p);
    cluster.sync();
    // A warp a group: lane r reads rank r's sums, then a shuffle tree. A
    // warp's (at most kRounds) groups are read at once.
    float2 t[kRounds];
#pragma unroll
    for (int i = 0; i < kRounds; ++i) {
      const int g = threadIdx.x / 32 + i * warps;
      t[i] = g < p.groups && lane < p.ctas ? *cluster.map_shared_rank(part + g, lane)
                                           : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < kRounds; ++i) {
      const int g = threadIdx.x / 32 + i * warps;
#pragma unroll
      for (int off = 4; off; off >>= 1) {
        t[i].x += __shfl_down_sync(0xffffffffu, t[i].x, off);
        t[i].y += __shfl_down_sync(0xffffffffu, t[i].y, off);
      }
      if (lane == 0 && g < p.groups) {
        const float2 ms = moments(kshift[g], t[i].x, t[i].y, inv_count, p.eps);
        stat[g] = ms;
        if (rank == 0 && p.mean) {
          p.mean[n * p.groups + g] = ms.x;
          p.rstd[n * p.groups + g] = ms.y;
        }
      }
    }
    // After the last sample a CTA leaves only once every CTA has read its
    // sums: they live in its shared memory.
    if (next >= p.n) asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    __syncthreads();

    float scale[8], shift[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 ms = stat[j < l.split ? l.g_lo : l.g_hi];
      a[j] -= ms.x;
      scale[j] = ms.y * weight[8 * l.v + j];
      shift[j] = bias[8 * l.v + j];
    }
    bf16* y = p.y + ((size_t)n * p.hw + p0) * p.c;
    int r = l.row;
    for (int k = 0; k < kChunks; ++k) {
      for (const int end = (k + 1) * npix / kChunks; r < end; r += l.rows) {
        const size_t off = (size_t)r * p.c + 8 * l.v;
        *reinterpret_cast<uint4*>(y + off) = normalise(
            *reinterpret_cast<const uint4*>(stripe + off), a, scale, shift, p.silu);
      }
      if (next < p.n) {
        __syncthreads();  // chunk k is read: load the next sample's into it
        issue_chunk(stripe, stripe_of(next), npix, p.c, k);
      }
    }
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Two-pass route, pass 1: stripe k of sample n, streamed from global memory
// -> its groups' (S, Q).
__global__ void __launch_bounds__(kMaxThreads) gn_stats_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* red = reinterpret_cast<float4*>(smem);
  float2* part = reinterpret_cast<float2*>(red + blockDim.x);
  const int n = blockIdx.y, k = blockIdx.x;
  const int p0 = k * p.pixels, npix = min(p.pixels, p.hw - p0);
  const bf16* x = p.x + ((size_t)n * p.hw + p0) * p.c;
  const Lanes l = lanes(p);
  float ak[8];
  load_add(p, l, n, ak);
  const float k_lo = shift_of(p, n, l.g_lo), k_hi = shift_of(p, n, l.g_hi);
#pragma unroll
  for (int j = 0; j < 8; ++j) ak[j] -= j < l.split ? k_lo : k_hi;
  Acc acc;
#pragma unroll
  for (int j = 0; j < 8; ++j) acc.s[j] = acc.q[j] = 0.f;
  for (int q = l.row; q < npix; q += l.rows)  // cached: gn_apply_kernel reads it again
    accumulate(acc, __ldg(reinterpret_cast<const uint4*>(x + (size_t)q * p.c + 8 * l.v)), ak);
  red[threadIdx.x] = fold_lanes(acc, l);
  __syncthreads();
  fold_groups(red, part, p);
  __syncthreads();
  for (int g = threadIdx.x; g < p.groups; g += blockDim.x)
    p.partial[((size_t)n * p.ctas + k) * p.groups + g] = part[g];
}

// Two-pass route, pass 2: each group's stripes added in order, in double.
__global__ void gn_finalize_kernel(const Params p) {
  const int n = blockIdx.x;
  for (int g = threadIdx.x; g < p.groups; g += blockDim.x) {
    const float2* part = p.partial + (size_t)n * p.ctas * p.groups + g;
    double s = 0.0, q = 0.0;
    for (int k = 0; k < p.ctas; ++k) {
      const float2 t = part[(size_t)k * p.groups];
      s += t.x;
      q += t.y;
    }
    const double m = (double)p.hw * p.cg, ds = s / m;
    p.mean[n * p.groups + g] = (float)(shift_of(p, n, g) + ds);
    p.rstd[n * p.groups + g] = rsqrtf((float)fmax(q / m - ds * ds, 0.0) + p.eps);
  }
}

// Two-pass route, pass 3: stripe k of sample n normalised from global memory.
__global__ void __launch_bounds__(kMaxThreads) gn_apply_kernel(const Params p) {
  const int n = blockIdx.y, k = blockIdx.x;
  const int p0 = k * p.pixels, npix = min(p.pixels, p.hw - p0);
  const size_t base = ((size_t)n * p.hw + p0) * p.c;
  const Lanes l = lanes(p);
  float off[8], scale[8], shift[8];
  load_add(p, l, n, off);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int g = n * p.groups + (j < l.split ? l.g_lo : l.g_hi), ch = 8 * l.v + j;
    off[j] -= p.mean[g];
    scale[j] = p.rstd[g] * __bfloat162float(p.weight[ch]);
    shift[j] = __bfloat162float(p.bias[ch]);
  }
  for (int q = l.row; q < npix; q += l.rows) {
    const size_t o = base + (size_t)q * p.c + 8 * l.v;
    *reinterpret_cast<uint4*>(p.y + o) =
        normalise(__ldcs(reinterpret_cast<const uint4*>(p.x + o)), off, scale, shift, p.silu);
  }
}

// Clusters of the launch's shape the card runs at once (cached by shape).
int active_clusters(const cudaLaunchConfig_t& cfg) {
  static struct {
    unsigned ctas, threads;
    size_t smem;
    int clusters;
  } cache[16];
  static int cached = 0;
  for (int i = 0; i < cached; ++i)
    if (cache[i].ctas == cfg.gridDim.x && cache[i].threads == cfg.blockDim.x &&
        cache[i].smem == cfg.dynamicSmemBytes)
      return cache[i].clusters;
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, gn_cluster_kernel, &cfg) != cudaSuccess)
    return 0;
  if (cached < 16) {
    cache[cached].ctas = cfg.gridDim.x;
    cache[cached].threads = cfg.blockDim.x;
    cache[cached].smem = cfg.dynamicSmemBytes;
    cache[cached++].clusters = clusters;
  }
  return clusters;
}

}  // namespace

// y = act(GroupNorm(x + add)) over n samples of hw x c channels-last bf16;
// mean and rstd (n, groups) f32 out (on the cluster route only where mean is
// not null; the two-pass route needs them). ctas stripes of `pixels` pixels a
// sample, `threads` (c / 8 x rows, a multiple of 32) a CTA. partial null:
// the cluster route (ctas <= 8); else the two-pass route with
// (n, ctas, groups) float2 scratch.
extern "C" int mvldm_group_norm_nhwc(const void* x, const void* add, const void* weight,
                                     const void* bias, void* y, void* mean, void* rstd,
                                     void* partial, int n, int hw, int c, int groups, int ctas,
                                     int pixels, int threads, float eps, int silu,
                                     void* stream) {
  Params p;
  p.x = static_cast<const bf16*>(x);
  p.add = static_cast<const bf16*>(add);
  p.weight = static_cast<const bf16*>(weight);
  p.bias = static_cast<const bf16*>(bias);
  p.y = static_cast<bf16*>(y);
  p.mean = static_cast<float*>(mean);
  p.rstd = static_cast<float*>(rstd);
  p.partial = static_cast<float2*>(partial);
  p.n = n;
  p.hw = hw;
  p.c = c;
  p.groups = groups;
  p.cg = c / groups;
  p.pixels = pixels;
  p.ctas = ctas;
  p.silu = silu;
  p.eps = eps;
  const size_t sums = (size_t)threads * sizeof(float4) + (size_t)3 * groups * sizeof(float2) +
                      (size_t)(groups + 2 * c) * sizeof(float);
  const size_t smem = (partial ? 0 : (size_t)pixels * c * sizeof(bf16)) + sums;
  if (c % 8 || c % groups || threads % (c / 8) || threads % 32 || threads > kMaxThreads ||
      groups > kRounds * (threads / 32) ||
      smem > kMaxSmem || (long long)ctas * pixels < hw || (long long)(ctas - 1) * pixels >= hw ||
      n < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  if (!partial) {
    if (ctas > kMaxCluster) return (int)cudaErrorInvalidValue;
    static const cudaError_t attr = cudaFuncSetAttribute(
        gn_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (attr != cudaSuccess) return (int)attr;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(ctas, 1, 1);
    cfg.blockDim = dim3(threads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cudaLaunchAttribute cluster[1];
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = ctas;
    cluster[0].val.clusterDim.y = 1;
    cluster[0].val.clusterDim.z = 1;
    cfg.attrs = cluster;
    cfg.numAttrs = 1;
    const int clusters = active_clusters(cfg);
    if (clusters < 1) return (int)cudaErrorLaunchOutOfResources;
    cfg.gridDim.y = clusters < n ? clusters : n;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, gn_cluster_kernel, p);
    return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
  }

  gn_stats_kernel<<<dim3(ctas, n), threads, sums, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_finalize_kernel<<<n, groups < 1024 ? groups : 1024, 0, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_apply_kernel<<<dim3(ctas, n), threads, 0, s>>>(p);
  return (int)cudaGetLastError();
}
