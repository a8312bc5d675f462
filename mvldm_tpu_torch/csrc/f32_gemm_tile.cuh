// The f32 GEMM tile for Hopper (sm_90a): f32 in, f32 out, with f32 accuracy,
// on the tensor cores as split TF32. Behind every f32 product of the f32
// route (f32_route.cu: the fused blocks' projections, and S = Q K^T and
// O = P V of the attention forward at head dims past 160) and the matmul
// probe's f32 route (micro_matmul.cu).
//
//   out[z][m, n] = alpha * sum_k A[z][m, k] B[z](k, n) (+ bias[n]) (+ res[m, n])
//
// A is (M, K) row-major with rows lda apart, or (M / L, heads, L, D), the
// attention output read as tokens x (heads * D). B is (N, K) row-major (a
// torch Linear weight, or K in S = Q K^T) or, with KN, (K, N) row-major (the
// probe's B, V in O = P V). The output is (M, N) with rows ldo apart, or
// head-split (M / L, heads, L, D). The bias row of batch z is (z + bias_z0)
// / bias_div (the attention's key bias, one row per batch entry of B * H
// heads). Grid z runs batch entries, each at its own strides.
//
// What bounds it: the products. Each f32 product is three TF32 products,
// hi hi + hi lo + lo hi with hi = tf32(x), lo = tf32(x - hi) (rounded by
// cvt.rna), at 494.7 TFLOP/s against FFMA's 67, the same split as the f32
// flash kernels.
//
// Design: a block of two warpgroups owns 128 output rows (64 each) and 128
// columns, and runs wgmma m64n128k8 on TF32 operands from shared memory, its
// f32 accumulator in registers (64 a thread). K streams 32 deep a stage. Raw
// f32 tiles land by cp.async in a ring of three stages, issued two stages
// ahead (zero-filled past M, N and K through cp.async's source size); each
// thread splits the chunks it copied into a ring of two hi / lo stages in
// wgmma's 128-byte swizzled layout while the tensor cores run the other
// stage, so neither the loads' latency nor the split waits in line before
// the products. (Staging the loads in registers instead left each stage
// waiting on its loads; PERF.md has the measurements.) TF32 wgmma reads B
// K-major only, so a (K, N) B is stored transposed: each thread splits four
// k rows of four columns into four 16-byte chunks along k, eight
// neighbouring lanes on eight distinct chunks of a row (no bank conflicts,
// also in the raw tile, whose chunks are kept XOR-swizzled). The
// accumulator's error grows
// with the products summed into it, so it leaves wgmma every kFlushK of K
// into an f32 register total (round to nearest), and the next chunk's first
// product overwrites it; the same thread owns each output throughout, so
// the order of the sums is fixed. The epilogue adds bias and residual in
// f32.
#pragma once

#include "hopper_tile.cuh"

namespace f32_gemm {
// Internal linkage: every library that includes this header keeps its own
// kernels.
namespace {

using namespace hopper_tile;

constexpr int BM = 128, BN = 128, BK = 32;  // block rows, columns, k depth of a stage
constexpr int kThreads = 256;
constexpr int kSplitStages = 2, kRawStages = 3;  // hi / lo tiles for wgmma; raw tiles in flight
constexpr int kFlushK = 256;                // K summed in the accumulator before it leaves
constexpr int kHalf = BM * BK;              // floats of a hi, lo or raw tile (A and B alike)
constexpr int kSplitFloats = 4 * kHalf;     // a split stage: A hi | A lo | B hi | B lo
constexpr int kRawFloats = 2 * kHalf;       // a raw stage: A | B
constexpr size_t kSmemBytes =
    ((size_t)kSplitStages * kSplitFloats + (size_t)kRawStages * kRawFloats) * 4 + 1024;
static_assert(BM == BN && BK == 32, "one 128 x 32 tile shape, one swizzle atom deep");

struct Args {
  const float* a;
  const float* b;
  const float* bias;  // or null
  const float* res;   // (M, N), rows ldo apart, or null
  float* out;
  int M, N, K, lda, ldb, ldo;
  long long sa, sb, so;  // batch strides (grid z), in floats
  int bias_div, bias_z0, bias_ld;
  float alpha;
  int a_heads, out_heads, L, D;  // head layouts (batch 1)
};

// Offset of row r, column c of a (M, heads * D) operand stored as (M / L,
// heads, L, D): row part and column part.
__device__ __forceinline__ size_t head_row(int r, int heads, int L, int D) {
  const int n = r / L;
  return ((size_t)n * heads * L + (r - n * L)) * D;
}
__device__ __forceinline__ size_t head_col(int c, int L, int D) {
  const int h = c / D;
  return (size_t)h * L * D + (c - h * D);
}

// 16 bytes global -> shared, of which the first `bytes` are read and the
// rest zero-filled (bytes 0: nothing is read; src must still be valid).
__device__ __forceinline__ void cp_async_n(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// Bytes of the four columns [k, k + 4) of a row that exist: 16, fewer at K's
// edge, 0 past K or for a row past M or N (null).
__device__ __forceinline__ int k_bytes(const float* row, int k, int K) {
  return row == nullptr || k >= K ? 0 : K - k >= 4 ? 16 : 4 * (K - k);
}

__device__ __forceinline__ void split_store(float* hi, float* lo, int off, float4 x) {
  float4 h, l;
  split_tf32(x.x, h.x, l.x);
  split_tf32(x.y, h.y, l.y);
  split_tf32(x.z, h.z, l.z);
  split_tf32(x.w, h.w, l.w);
  *reinterpret_cast<float4*>(hi + off) = h;
  *reinterpret_cast<float4*>(lo + off) = l;
}

__device__ __forceinline__ float comp(float4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// KN: B is (K, N) row-major (else (N, K)). An int, so the instances carry
// readable names in SASS and ptxas logs (gemm_tf32x3<0>, <1>).
template <int KN>
__global__ void __launch_bounds__(kThreads, 1) gemm_tf32x3(const Args p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // [split stage][A hi | A lo | B hi | B lo], 1024-byte aligned; then
  // [raw stage][A | B].
  float* split =
      reinterpret_cast<float*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* raw = split + kSplitStages * kSplitFloats;
  const int tid = threadIdx.x, lane = tid % 32;
  // Broadcast from lane 0, so the compiler sees the warpgroup index as
  // uniform and keeps every wgmma on a non-divergent path.
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN, z = blockIdx.z;
  const int M = p.M, N = p.N, K = p.K;
  const int nk = (K + BK - 1) / BK;
  const float* a = p.a + z * p.sa;
  const float* b = p.b + z * p.sb;

  // Each thread copies four 16-byte chunks of A and four of B a stage, and
  // later splits the same chunks (so no barrier stands between its copies
  // and its split). A and a (N, K) B: rows lr + 32 i, chunk lc (eight lanes
  // a row). A (K, N) B: k rows 4 lc + i of columns 4 lr to 4 lr + 3, kept
  // at chunk lr ^ lc of their raw rows (eight lanes on eight banks) and
  // stored as rows 4 lr + i, chunk lc, of the transposed split tile.
  const int lr = tid >> 3, lc = tid & 7;
  const float* arow[4];
  const float* brow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + lr + 32 * i, n = n0 + lr + 32 * i;
    arow[i] = r >= M ? nullptr
              : p.a_heads ? a + head_row(r, p.a_heads, p.L, p.D)
                          : a + (size_t)r * p.lda;
    brow[i] = KN ? (n0 + 4 * lr < N ? b + n0 + 4 * lr : nullptr)  // (K, N) B: N % 4 == 0
                 : (n >= N ? nullptr : b + (size_t)n * p.ldb);
  }
  const int kn_chunk = (lr & ~7) | ((lr ^ lc) & 7);

  // Tile j (zeros past M, N and K) into raw stage j % kRawStages; one
  // commit group a call, empty past the last tile.
  auto copy = [&](int j) {
    if (j < nk) {
      float* R = raw + (j % kRawStages) * kRawFloats;
      const int k = j * BK + 4 * lc;
      const size_t acol = p.a_heads ? head_col(k, p.L, p.D) : k;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = k_bytes(arow[i], k, K);
        cp_async_n(R + (lr + 32 * i) * 32 + 4 * lc, n ? arow[i] + acol : p.a, n);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (KN) {
          const int kr = j * BK + 4 * lc + i;
          const bool ok = brow[i] != nullptr && kr < K;
          cp_async_n(R + kHalf + (4 * lc + i) * BN + 4 * kn_chunk,
                     ok ? brow[i] + (size_t)kr * p.ldb : p.b, ok ? 16 : 0);
        } else {
          const int n = k_bytes(brow[i], k, K);
          cp_async_n(R + kHalf + (lr + 32 * i) * 32 + 4 * lc, n ? brow[i] + k : p.b, n);
        }
      }
    }
    cp_async_commit();
  };
  // This thread's chunks of raw tile j, split into split stage s.
  auto split_tile = [&](int j, int s) {
    const float* R = raw + (j % kRawStages) * kRawFloats;
    float* S = split + s * kSplitFloats;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = lr + 32 * i;
      split_store(S, S + kHalf, sw128_f32(r, lc),
                  *reinterpret_cast<const float4*>(R + r * 32 + 4 * lc));
    }
    if constexpr (KN) {
      float4 x[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        x[i] = *reinterpret_cast<const float4*>(R + kHalf + (4 * lc + i) * BN + 4 * kn_chunk);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        split_store(S + 2 * kHalf, S + 3 * kHalf, sw128_f32(4 * lr + i, lc),
                    make_float4(comp(x[0], i), comp(x[1], i), comp(x[2], i), comp(x[3], i)));
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = lr + 32 * i;
        split_store(S + 2 * kHalf, S + 3 * kHalf, sw128_f32(r, lc),
                    *reinterpret_cast<const float4*>(R + kHalf + r * 32 + 4 * lc));
      }
    }
  };

  float acc[BN / 2], tot[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) tot[i] = 0.f;

#pragma unroll
  for (int j = 0; j < kRawStages; ++j) copy(j);
  cp_async_wait<kRawStages - 1>();
  split_tile(0, 0);
  fence_proxy_async();
  __syncthreads();
  constexpr int TPC = kFlushK / BK;  // stages a chunk of the sum
  for (int c0 = 0; c0 < nk; c0 += TPC) {
    const int c1 = min(nk, c0 + TPC);
    for (int j = c0; j < c1; ++j) {
      const float* S = split + (j % kSplitStages) * kSplitFloats;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        const uint64_t ah = desc_sw128_f32(S, wg * 64, kk);
        const uint64_t al = desc_sw128_f32(S + kHalf, wg * 64, kk);
        const uint64_t bh = desc_sw128_f32(S + 2 * kHalf, 0, kk);
        const uint64_t bl = desc_sw128_f32(S + 3 * kHalf, 0, kk);
        wgmma_tf32_ss<BN>(acc, ah, bh, j > c0 || kk > 0);
        wgmma_tf32_ss<BN>(acc, ah, bl, 1);
        wgmma_tf32_ss<BN>(acc, al, bh, 1);
      }
      wgmma_commit();
      // Tile j + 1 into the other split stage while products j run: its raw
      // chunks have landed, and products j - 1 (the stage's last readers)
      // are done everywhere after the wait and the barrier.
      cp_async_wait<kRawStages - 2>();
      wgmma_wait<1>();
      __syncthreads();
      if (j + 1 < nk) split_tile(j + 1, (j + 1) % kSplitStages);
      fence_proxy_async();
      copy(j + kRawStages);  // into the raw stage of tile j, split at step j - 1
      __syncthreads();       // tile j + 1 is in
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) tot[i] += acc[i];
  }
  cp_async_wait<0>();

  const float* bias =
      p.bias == nullptr ? nullptr : p.bias + (size_t)((z + p.bias_z0) / p.bias_div) * p.bias_ld;
  const float* res = p.res == nullptr ? nullptr : p.res + z * p.so;
  float* out = p.out + z * p.so;
  const int rw = m0 + wg * 64 + ((tid % 128) / 32) * 16 + g;  // the thread's rows rw, rw + 8
#pragma unroll
  for (int jn = 0; jn < BN / 8; ++jn) {
    const int c = n0 + jn * 8 + 2 * t;
    if (c >= N) continue;
    const bool two = c + 1 < N;
    float b0 = 0.f, b1 = 0.f;
    if (bias != nullptr) {
      b0 = bias[c];
      b1 = two ? bias[c + 1] : 0.f;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rw + 8 * h;
      if (r >= M) continue;
      float v0 = fmaf(tot[4 * jn + 2 * h], p.alpha, b0);
      float v1 = fmaf(tot[4 * jn + 2 * h + 1], p.alpha, b1);
      if (res != nullptr) {  // rows ldo apart, ldo % 4 == 0: c is 8-byte aligned
        const float* rr = res + (size_t)r * p.ldo + c;
        if (two) {
          const float2 x = *reinterpret_cast<const float2*>(rr);
          v0 += x.x;
          v1 += x.y;
        } else {
          v0 += rr[0];
        }
      }
      float* o = p.out_heads ? out + head_row(r, p.out_heads, p.L, p.D) + head_col(c, p.L, p.D)
                             : out + (size_t)r * p.ldo + c;
      if (two)
        *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
      else
        *o = v0;
    }
  }
}

// Launch over `batch` entries (grid z). The caller has checked the shapes:
// lda, ldb, ldo and (with KN) N multiples of 4, operands 16-byte aligned,
// with heads D % 4 == 0 and K (A) or N (out) = heads * D.
template <int KN>
cudaError_t launch(const Args& p, int batch, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemm_tf32x3<KN>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, batch);
  if (p.M <= 0 || p.N <= 0 || p.K <= 0 || batch <= 0 || batch > 65535 || grid.y > 65535)
    return cudaErrorInvalidValue;
  gemm_tf32x3<KN><<<grid, kThreads, kSmemBytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace f32_gemm
