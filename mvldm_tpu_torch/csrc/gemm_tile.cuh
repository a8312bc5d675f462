// Tiled bf16 GEMM for Hopper (sm_90a) with the prologues and epilogues of
// the fused transformer sub-blocks (fused_ln_attn.cu, fused_ln_geglu_ff.cu),
// and the plain bf16 product of the matmul probe (micro_matmul.cu).
//
//   out[M, N] = epilogue( A[M, K] @ W[N, K]^T )
//
// W is a torch Linear weight, (out_features, in_features) row-major, which
// is a K-major B operand as it lies; with the template flag WKN it is a
// row-major (K, N) matrix instead (the probe's a @ b, b as given), read
// through the MN-major descriptor of the same bytes, so no transposed copy
// is made. A comes from one of:
//   kALn     x (M, K) bf16 with the LayerNorm applied (f32 statistics, then
//            rounded to bf16 as the JAX kernels round LN(x) to the weight
//            dtype before the product); K <= kMaxLnK;
//   kAHeads  the attention output (N, H, L, D), read as tokens x (H*D); each
//            16-byte chunk stays inside one head (D % 8 == 0);
//   kAPlain  a row-major (M, K) bf16 matrix.
// Epilogues, all in f32 before one rounding to bf16:
//   kEpiQkv    gridDim.z = 3 selects W/out among q, k, v; q is multiplied
//              by qscale; the result is scattered to (N, H, L, D);
//   kEpiResid  + bias[n] + resid[m, n];
//   kEpiGeglu  h from W rows [0, N) and the gate from rows [N, 2N):
//              (h + b[n]) * gelu_erf(g + b[N + n]);
//   kEpiPlain  the product alone.
//
// What bounds it on this card: at the fused blocks' shapes (10 x 1024
// tokens, K = C = 320 or H*D = 320, N up to 8C) and the probe's 4096 x 1024
// x 1024 the products are far above the ~295 flop/byte ridge, so the
// tensor cores bound it, and only wgmma reaches their rate.
//
// Design: a block of two warpgroups owns 128 output rows (64 each) and
// multiplies them by 128-row B tiles with wgmma m64n128k16, the f32
// accumulator in registers (64 a thread). For GEGLU the B tile stacks the h
// rows [n0, n0 + 64) and the gate rows [N + n0, N + n0 + 64) of W1, so one
// product yields both accumulators side by side (n8 blocks j and j + 8) and
// the output tile is 128 x 64. Tiles sit in shared memory in wgmma's
// 128-byte swizzled layout, 64 deep a stage (one swizzle atom), and stream
// through a cp.async ring; ragged M, N and K edges are zero-filled through
// cp.async's source size. kAPlain / kAHeads stream A and W through three
// stages, two blocks an SM. kALn keeps the block's 128 rows of LN(x)
// resident: x lands once by cp.async, each warp takes the statistics of two
// rows at a time from 16-byte shared-memory reads held in registers (mean,
// then the centred variance: no second pass over memory) and normalises
// them in place, then only W streams; the blocks of a row block share its
// output tiles (blockIdx.x, + gridDim.x, ...), so the LayerNorm is paid once
// per block for several tiles. Two blocks an SM with two stages where two
// LN(x) blocks fit (C <= 320), else one with four. The matmul probe, where
// enough blocks fill the card, takes 256-row blocks (two m64 row blocks a
// warpgroup, one block an SM, four stages), which halves its reads of B,
// and its output tile leaves through shared memory in 16-byte stores. The
// epilogues work on the accumulator registers, whose row mapping per warp
// is the m16n8 one (rows 16w + g and + 8, columns 8j + 2t). Requires
// K % 8 == 0 and N % 8 == 0.
#pragma once

#include "hopper_tile.cuh"

namespace gemm_tile {
// Internal linkage: every library that includes this header keeps its own
// kernels (two builds of it may be loaded in one process side by side).
namespace {

using hopper_tile::bf16;

constexpr int kALn = 0, kAHeads = 1, kAPlain = 2;
constexpr int kEpiQkv = 0, kEpiResid = 1, kEpiGeglu = 2, kEpiPlain = 3;

constexpr int BM = 128;       // block rows: two warpgroups of 64
constexpr int BNW = 128;      // B tile rows (n) per product
constexpr int kThreads = 256;
constexpr int kMaxLnK = 640;  // kALn: the resident LN(x) block, 128 x K bf16

struct Args {
  const bf16* a;        // A source (see A modes)
  const float* ln_g;    // kALn: LayerNorm scale (K)
  const float* ln_b;    // kALn: LayerNorm bias (K)
  float eps;
  int M, N, K;
  const bf16* w[3];     // (N, K) weights; kEpiGeglu: w[0] is (2N, K)
  const float* bias;    // (N), kEpiGeglu: (2N)
  const bf16* resid;    // kEpiResid: (M, N)
  bf16* out[3];
  int heads, seq, head_dim;  // (N, H, L, D) layout for kAHeads / kEpiQkv
  float qscale;
};

constexpr int BK = 64;  // k depth of a ring stage: one 128-byte swizzle atom

// Output columns of a tile.
template <int EPI>
__host__ __device__ constexpr int out_cols() { return EPI == kEpiGeglu ? BNW / 2 : BNW; }

template <int AMODE, int MW>
__host__ __device__ constexpr int a_tile() { return AMODE == kALn ? 0 : MW * BM * BK; }

// Dynamic shared memory: a ring of NS stages, kALn's LN(x) block, and 1 KB
// to align the swizzle atoms.
template <int AMODE, int MW>
size_t smem_bytes(int K, int NS) {
  size_t bytes = (size_t)NS * (a_tile<AMODE, MW>() + BNW * BK) * 2 + 1024;
  if (AMODE == kALn) bytes += (size_t)BM * ((K + BK - 1) / BK * BK) * 2;
  return bytes;
}

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
}

__device__ __forceinline__ void store2(bf16* p, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}

// NS ring stages; MW m64 row blocks a warpgroup (block rows 128 MW). Two
// blocks an SM (at most 128 registers) unless the LN(x) block needs most of
// the shared memory (NS = 4) or MW = 2 (a 128-register accumulator).
template <int AMODE, int EPI, bool WKN, int NS, int MW>
__global__ void __launch_bounds__(kThreads, NS == 4 || MW == 2 ? 1 : 2) gemm_kernel(Args args) {
  using namespace hopper_tile;
  constexpr int BNO = out_cols<EPI>();
  constexpr bool kResA = AMODE == kALn;
  constexpr int kRows = MW * BM;
  constexpr int kTileA = a_tile<AMODE, MW>(), kTileB = BNW * BK;
  constexpr int kStages = NS;
  constexpr int kAhead = kStages - 1;  // stages loading ahead of the one in use
  static_assert(!kResA || MW == 1, "kALn: 128-row blocks");
  static_assert(!WKN || (AMODE == kAPlain && EPI == kEpiPlain), "(K, N) W: the probe only");
  static_assert(kMaxLnK / 8 <= 3 * 32, "kALn: three 16-byte chunks of a row per lane");
  extern __shared__ __align__(128) unsigned char smem[];
  // [stage][A tile | B tile], 1024-byte aligned; then kALn's LN(x) block,
  // KA / 64 swizzled column slices of BM x 64.
  bf16* ring = reinterpret_cast<bf16*>((reinterpret_cast<uintptr_t>(smem) + 1023) & ~uintptr_t(1023));
  bf16* As = ring + kStages * (kTileA + kTileB);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // Broadcast from lane 0, so the compiler sees the warpgroup index as
  // uniform and keeps every wgmma on a non-divergent path.
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * kRows;
  const int M = args.M, N = args.N, K = args.K;
  const int nk = (K + BK - 1) / BK;
  const int KA = nk * BK;  // columns of the resident A block
  // Output tiles: n tiles of each of the nz products (q, k, v for kEpiQkv);
  // the block takes tiles blockIdx.x, + gridDim.x, ...
  constexpr int nz = (EPI == kEpiQkv) ? 3 : 1;
  const int n_tiles = (N + BNO - 1) / BNO;
  const int total = (nz * n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x * nk;
  auto tile_of = [&](int j) { return (int)blockIdx.x + j / nk * (int)gridDim.x; };
  auto pick = [](auto* const* p, int z) { return z == 0 ? p[0] : z == 1 ? p[1] : p[2]; };

  // Each thread copies four 16-byte chunks of every A tile and four of
  // every B tile; their rows and shared-memory offsets are fixed, so a
  // stage costs a few instructions a chunk.
  constexpr int kChunks = BM * 8 / kThreads, kChunksA = MW * kChunks;
  static_assert(BNW * 8 / kThreads == kChunks && BK * (BNW / 8) / kThreads == kChunks, "chunks");
  const int lr = tid >> 3, lc = tid & 7;   // K-major tiles: rows lr + 32 i, chunk lc
  const int wr = tid >> 4, wc = tid & 15;  // (K, N) B: k rows wr + 16 i, chunk wc
  const bf16* a_row[kChunksA];             // A source of each row (its token for kAHeads)
#pragma unroll
  for (int i = 0; i < kChunksA; ++i) {
    const int gr = m0 + lr + 32 * i;
    a_row[i] = args.a;
    if (gr < M) {
      if constexpr (AMODE == kAHeads) {
        const int n = gr / args.seq, l = gr - n * args.seq;
        a_row[i] += ((size_t)n * args.heads * args.seq + l) * args.head_dim;
      } else {
        a_row[i] += (size_t)gr * K;
      }
    }
  }

  // Ring stage of flat step j = (this block's tile j / nk, k step j % nk).
  auto load = [&](int j) {
    if (j < total) {
      const int s = j % kStages, ks = j % nk;
      const int tile = tile_of(j), z = tile / n_tiles;
      const int n0 = (tile - z * n_tiles) * BNO, k0 = ks * BK;
      const bf16* W = pick(args.w, z);
      bf16* At = ring + s * (kTileA + kTileB);
      bf16* Bt = At + kTileA;
      const int gc = k0 + lc * 8;
      if constexpr (!kResA) {
        size_t coff = gc;  // column offset inside a row's source
        if constexpr (AMODE == kAHeads) {
          const int h = gc / args.head_dim;
          coff = (size_t)h * args.seq * args.head_dim + (gc - h * args.head_dim);
        }
#pragma unroll
        for (int i = 0; i < kChunksA; ++i) {
          const int r = lr + 32 * i;
          const bool valid = m0 + r < M && gc < K;
          cp_async16(At + sw128(r, lc), valid ? a_row[i] + coff : args.a, valid);
        }
      }
      if constexpr (WKN) {
        const int gn = n0 + wc * 8;
#pragma unroll
        for (int i = 0; i < kChunks; ++i) {
          const int kr = wr + 16 * i, gk = k0 + kr;
          const bool valid = gk < K && gn < N;
          cp_async16(Bt + (wc >> 3) * (BK * 64) + sw128(kr, wc & 7),
                     valid ? W + (size_t)gk * N + gn : W, valid);
        }
      } else {
        // W rows n (GEGLU: h rows in tile rows 0-63, their gate rows in 64-127).
#pragma unroll
        for (int i = 0; i < kChunks; ++i) {
          const int r = lr + 32 * i;
          const int n = (EPI == kEpiGeglu) ? n0 + (r & (BNW / 2 - 1)) : n0 + r;
          const int gn = (EPI == kEpiGeglu && r >= BNW / 2) ? N + n : n;
          const bool valid = n < N && gc < K;
          cp_async16(Bt + sw128(r, lc), valid ? W + (size_t)gn * K + gc : W, valid);
        }
      }
    }
    cp_async_commit();
  };

  if constexpr (kResA) {
    // x lands raw (rows past M and columns past K zero), W's first stages
    // behind it; then each warp normalises its rows in place.
    for (int idx = tid; idx < BM * (KA / 8); idx += kThreads) {
      const int r = idx / (KA / 8), c = idx % (KA / 8);
      const bool valid = m0 + r < M && c * 8 < K;
      cp_async16(As + (c >> 3) * (BM * 64) + sw128(r, c & 7),
                 valid ? args.a + (size_t)(m0 + r) * K + c * 8 : args.a, valid);
    }
    cp_async_commit();
    for (int j = 0; j < kAhead; ++j) load(j);
    cp_async_wait<kAhead>();
    __syncthreads();
    // Each warp takes two rows at a time (independent reductions side by
    // side); a lane holds chunks lane, lane + 32, lane + 64 of a row and
    // the LayerNorm scale and bias of those columns.
    const int nc = K / 8;
    float lg[3][8], lb[3][8];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int col = (lane + 32 * i) * 8 + e;
        lg[i][e] = col < K ? args.ln_g[col] : 0.f;
        lb[i][e] = col < K ? args.ln_b[col] : 0.f;
      }
    for (int r0 = 2 * warp; r0 < BM && m0 + r0 < M; r0 += 2 * (kThreads / 32)) {
      auto chunk = [&](int r, int c) { return As + (c >> 3) * (BM * 64) + sw128(r, c & 7); };
      float x[2][3][8], mean[2], rs[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const int c = lane + 32 * i;
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (c < nc) v = *reinterpret_cast<const uint4*>(chunk(r0 + q, c));
          const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(p[e]);
            x[q][i][2 * e] = f.x;
            x[q][i][2 * e + 1] = f.y;
            sum += f.x + f.y;
          }
        }
        mean[q] = sum;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        mean[0] += __shfl_xor_sync(0xffffffffu, mean[0], o);
        mean[1] += __shfl_xor_sync(0xffffffffu, mean[1], o);
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        mean[q] /= K;
        float s2 = 0.f;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          if (lane + 32 * i < nc) {
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const float d = x[q][i][e] - mean[q];
              s2 += d * d;
            }
          }
        }
        rs[q] = s2;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        rs[0] += __shfl_xor_sync(0xffffffffu, rs[0], o);
        rs[1] += __shfl_xor_sync(0xffffffffu, rs[1], o);
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        rs[q] = rsqrtf(rs[q] / K + args.eps);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const int c = lane + 32 * i;
          if (c >= nc) continue;
          uint4 v;
          uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            w[e] = pack2_bf16((x[q][i][2 * e] - mean[q]) * rs[q] * lg[i][2 * e] + lb[i][2 * e],
                              (x[q][i][2 * e + 1] - mean[q]) * rs[q] * lg[i][2 * e + 1] +
                                  lb[i][2 * e + 1]);
          *reinterpret_cast<uint4*>(chunk(r0 + q, c)) = v;
        }
      }
    }
  } else {
    for (int j = 0; j < kAhead; ++j) load(j);
  }

  float acc[MW][BNW / 2];
#pragma unroll
  for (int mw = 0; mw < MW; ++mw)
#pragma unroll
    for (int i = 0; i < BNW / 2; ++i) acc[mw][i] = 0.f;

  for (int j = 0; j < total; ++j) {
    cp_async_wait<kAhead - 1>();
    fence_proxy_async();
    __syncthreads();  // stage j is in (and LN(x) written); all are done with stage j - 1
    const int ks = j % nk;
    const bf16* At = ring + (j % kStages) * (kTileA + kTileB);
    const bf16* Bt = At + kTileA;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const bf16* a0 = kResA ? As + ks * (BM * 64) : At;
      const uint64_t db = WKN ? make_desc_sw128(Bt + kk * 2 * 512, BK * 128, 1024)
                              : make_desc_sw128(Bt + kk * 16, 16, 1024);
#pragma unroll
      for (int mw = 0; mw < MW; ++mw) {
        const uint64_t da = make_desc_sw128(a0 + (wg * MW + mw) * 8 * 512 + kk * 16, 16, 1024);
        wgmma_ss<BNW, WKN ? 1 : 0>(acc[mw], da, db, ks > 0 || kk > 0);
      }
    }
    wgmma_commit();
    load(j + kAhead);  // into the stage of j - 1, while step j runs in the tensor cores
    wgmma_wait<0>();
    if (ks != nk - 1) continue;

    const int tile = tile_of(j), z = tile / n_tiles;
    const int n0 = (tile - z * n_tiles) * BNO;
    if constexpr (EPI == kEpiPlain && MW == 2) {
      // The probe's one 256 x 128 tile leaves through shared memory (the
      // ring is free now), so each global store is a whole 16-byte chunk
      // of a row rather than 4 bytes of eight rows.
      constexpr int kLd = BNW + 8;  // padded rows: conflict-free fragment writes
      bf16* Cs = ring;
      __syncthreads();  // every warpgroup is done reading the ring
#pragma unroll
      for (int mw = 0; mw < MW; ++mw)
#pragma unroll
        for (int jn = 0; jn < BNW / 8; ++jn)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = (wg * MW + mw) * 64 + (warp % 4) * 16 + g + 8 * h;
            *reinterpret_cast<__nv_bfloat162*>(Cs + r * kLd + jn * 8 + 2 * t) =
                __floats2bfloat162_rn(acc[mw][4 * jn + 2 * h], acc[mw][4 * jn + 2 * h + 1]);
          }
      __syncthreads();
      for (int idx = tid; idx < kRows * (BNW / 8); idx += kThreads) {
        const int r = idx / (BNW / 8), c = idx % (BNW / 8) * 8;
        if (m0 + r < M && n0 + c < N)
          *reinterpret_cast<uint4*>(args.out[0] + (size_t)(m0 + r) * N + n0 + c) =
              *reinterpret_cast<const uint4*>(Cs + r * kLd + c);
      }
    } else if constexpr (EPI == kEpiGeglu) {
      // The h and gate biases go into the accumulator as they are read (held
      // for the whole tile beside it, the 32 of them spill at two blocks an
      // SM); then (h + b_h) * gelu(g + b_g) per element.
      float* hv = acc[0];
      float* gv = acc[0] + 4 * (BNO / 8);
#pragma unroll
      for (int jn = 0; jn < BNO / 8; ++jn) {
        const int gc = n0 + jn * 8 + 2 * t;
        const bool ok = gc < N;
        const float bh0 = ok ? args.bias[gc] : 0.f, bh1 = ok ? args.bias[gc + 1] : 0.f;
        const float bg0 = ok ? args.bias[N + gc] : 0.f, bg1 = ok ? args.bias[N + gc + 1] : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          hv[4 * jn + 2 * h] += bh0;
          hv[4 * jn + 2 * h + 1] += bh1;
          gv[4 * jn + 2 * h] += bg0;
          gv[4 * jn + 2 * h + 1] += bg1;
        }
      }
#pragma unroll
      for (int jn = 0; jn < BNO / 8; ++jn)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int gr = m0 + wg * 64 + (warp % 4) * 16 + g + 8 * h;
          const int gc = n0 + jn * 8 + 2 * t;
          if (gr >= M || gc >= N) continue;
          store2(args.out[0] + (size_t)gr * N + gc,
                 hv[4 * jn + 2 * h] * gelu_erf(gv[4 * jn + 2 * h]),
                 hv[4 * jn + 2 * h + 1] * gelu_erf(gv[4 * jn + 2 * h + 1]));
        }
    } else {
#pragma unroll
      for (int mw = 0; mw < MW; ++mw)
#pragma unroll
        for (int jn = 0; jn < BNO / 8; ++jn)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int gr = m0 + (wg * MW + mw) * 64 + (warp % 4) * 16 + g + 8 * h;
            const int gc = n0 + jn * 8 + 2 * t;
            if (gr >= M || gc >= N) continue;
            const float v0 = acc[mw][4 * jn + 2 * h], v1 = acc[mw][4 * jn + 2 * h + 1];
            if constexpr (EPI == kEpiQkv) {
              const float s = (z == 0) ? args.qscale : 1.f;
              const int n = gr / args.seq, l = gr % args.seq;
              const int hh = gc / args.head_dim, d = gc % args.head_dim;
              store2(pick(args.out, z) + (((size_t)n * args.heads + hh) * args.seq + l) * args.head_dim + d,
                     v0 * s, v1 * s);
            } else if constexpr (EPI == kEpiPlain) {
              store2(args.out[0] + (size_t)gr * N + gc, v0, v1);
            } else {
              const size_t o = (size_t)gr * N + gc;
              const float2 r2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(args.resid + o));
              store2(args.out[0] + o, v0 + args.bias[gc] + r2.x, v1 + args.bias[gc + 1] + r2.y);
            }
          }
    }
  }
  cp_async_wait<0>();
}

inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

template <int AMODE, int EPI, bool WKN, int NS, int MW = 1>
cudaError_t launch_ns(const Args& args, int nz, int blocks_per_sm, cudaStream_t stream) {
  const size_t bytes = smem_bytes<AMODE, MW>(args.K, NS);
  static size_t configured = 0;  // the largest size allowed so far
  if (bytes > configured) {
    cudaError_t err = cudaFuncSetAttribute(gemm_kernel<AMODE, EPI, WKN, NS, MW>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    configured = bytes;
  }
  const int row_blocks = (args.M + MW * BM - 1) / (MW * BM);
  const int tiles = nz * ((args.N + out_cols<EPI>() - 1) / out_cols<EPI>());
  int gx = tiles;
  if (AMODE == kALn) {
    // The blocks of one row block share its tiles, so each normalises its
    // rows once for tiles / gx of them: as few blocks as fill the card.
    const int fill = blocks_per_sm * sm_count() / row_blocks;
    gx = fill < 1 ? 1 : (fill < tiles ? fill : tiles);
  }
  if (row_blocks > 65535) return cudaErrorInvalidValue;
  gemm_kernel<AMODE, EPI, WKN, NS, MW><<<dim3(gx, row_blocks), kThreads, bytes, stream>>>(args);
  return cudaGetLastError();
}

// nz = 3 for kEpiQkv (q, k, v), else 1.
template <int AMODE, int EPI, bool WKN = false>
cudaError_t launch(const Args& args, int nz, cudaStream_t stream) {
  if (args.M <= 0 || args.N <= 0 || args.K <= 0 || args.N % 8 != 0 || args.K % 8 != 0 ||
      nz != (EPI == kEpiQkv ? 3 : 1))
    return cudaErrorInvalidValue;
  if (AMODE == kALn && args.K > kMaxLnK) return cudaErrorInvalidValue;
  if ((AMODE == kAHeads || EPI == kEpiQkv) && (args.head_dim % 8 != 0 || args.seq <= 0))
    return cudaErrorInvalidValue;
  if constexpr (AMODE != kALn) {
    if constexpr (WKN) {
      // The probe: 256-row blocks (one an SM, four stages) halve the reads
      // of B from L2 wherever they still fill the card.
      const int tiles = (args.N + BNW - 1) / BNW;
      if ((long long)((args.M + 2 * BM - 1) / (2 * BM)) * tiles * 8 >= 7LL * sm_count())
        return launch_ns<AMODE, EPI, WKN, 4, 2>(args, nz, 1, stream);
    }
    return launch_ns<AMODE, EPI, WKN, 3>(args, nz, 2, stream);
  } else {
    // Two blocks an SM while two LN(x) blocks and two stages fit (C <= 320),
    // else one with four stages.
    if (2 * smem_bytes<AMODE, 1>(args.K, 2) <= 232448)
      return launch_ns<AMODE, EPI, WKN, 2>(args, nz, 2, stream);
    return launch_ns<AMODE, EPI, WKN, 4>(args, nz, 1, stream);
  }
}

}  // namespace
}  // namespace gemm_tile
