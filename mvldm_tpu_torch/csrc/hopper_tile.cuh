// Hopper (sm_90a) building blocks shared by the attention kernels and the
// GEMM tile: the asynchronous copy ring (cp.async with zero fill and
// commit / wait groups), warpgroup matrix multiplies (wgmma) with their
// shared-memory descriptors and fence / commit / wait wrappers, the tile
// layout both read, exp2 on the special-function unit and the repacking of
// an f32 accumulator into a bf16 A fragment; and the split-TF32 pieces of
// the f32 route (f32 tiles, tf32 wgmma, hi / lo A fragments, at the end).
//
// Tile layout ("core-matrix blocked", wgmma's no-swizzle canonical form): a
// tile of R rows x KP bf16 columns (R % 8 == 0, KP % 16 == 0) is stored as
// 8 x 8 core matrices of 128 contiguous bytes, 16 bytes per row; the core
// matrix of row group rg and column group cg starts at element
// (rg * KP / 8 + cg) * 64. Each 16-byte chunk of a row-major source row is
// one core-matrix row, so a tile arrives by 16-byte cp.async with no
// transposing copy, and the same bytes serve wgmma both ways:
//   * K-major (the columns are the contraction, as for Q K^T): leading
//     byte offset 128 (next column group), stride byte offset KP * 16
//     (next row group); a 16-deep k step advances the start by 256 bytes;
//   * MN-major (the rows are the contraction, as for P^T dO): leading byte
//     offset KP * 16 (next row group, along k), stride byte offset 128
//     (next column group, along n); a k step advances by 2 row groups.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper_tile {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------- asynchronous copies

// 16 bytes global -> shared; with !valid the 16 bytes are zero-filled and
// nothing is read (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared (rows of f32 statistics, aligned to 4 bytes only).
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Make this thread's generic-proxy writes to shared memory (cp.async
// results, plain stores) visible to the async proxy that wgmma reads with;
// follow it with a barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows [0, rows) of a row-major (rows, D) bf16 source (row stride D) into
// an R x KP tile in the blocked layout above, by THREADS threads, one
// 16-byte cp.async per chunk. Rows >= rows are zero-filled; column groups
// >= D / 8 are not written (zero them once with zero_pad_cols). Consecutive
// threads fill one core matrix, so the shared stores do not conflict.
template <int R, int KP, int THREADS>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src, int rows, int D) {
  constexpr int NC = KP / 8;
  const int dc = D / 8;
  for (int idx = threadIdx.x; idx < R * NC; idx += THREADS) {
    const int rr = idx % 8, cg = (idx / 8) % NC, rg = idx / (8 * NC);
    if (cg >= dc) continue;
    const int r = rg * 8 + rr;
    const bool valid = r < rows;
    cp_async16(dst + (rg * NC + cg) * 64 + rr * 8, valid ? src + (size_t)r * D + cg * 8 : src,
               valid);
  }
}

// Zero the column groups [D / 8, KP / 8) of an R x KP blocked tile (plain
// stores; fence_proxy_async and a barrier before wgmma reads them).
template <int R, int KP, int THREADS>
__device__ __forceinline__ void zero_pad_cols(bf16* dst, int D) {
  constexpr int NC = KP / 8;
  const int dc = D / 8;
  const int pad = NC - dc;
  for (int idx = threadIdx.x; idx < R * pad; idx += THREADS) {
    const int rr = idx % 8, cg = dc + (idx / 8) % pad, rg = idx / (8 * pad);
    *reinterpret_cast<uint4*>(dst + (rg * NC + cg) * 64 + rr * 8) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// ------------------------------------------------------------ elementwise

// 2^x on the special-function unit, denormal results flushed to zero (p
// below 2^-126 adds nothing to a bf16 product).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack2_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Packs k step kk (16 columns) of a 64-row accumulator into the A
// fragment of the next product: the accumulator's n8 blocks 2kk and
// 2kk + 1 hold exactly the m16n8k16 A layout of those columns.
__device__ __forceinline__ void pack_a(uint32_t* a, const float* acc, int kk) {
  const float* c = acc + 8 * kk;
  a[0] = pack2_bf16(c[0], c[1]);
  a[1] = pack2_bf16(c[2], c[3]);
  a[2] = pack2_bf16(c[4], c[5]);
  a[3] = pack2_bf16(c[6], c[7]);
}

// ------------------------------------------------------------------ wgmma

// Shared-memory matrix descriptor, no swizzle: start address, leading and
// stride byte offsets (16-byte units), base offset 0, layout type 0.
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// Descriptor of k step kk of an operand whose contraction runs along the
// columns (K-major) or along the rows (MN-major) of a blocked tile with KP
// columns, starting at row group rg0.
template <int KP>
__device__ __forceinline__ uint64_t desc_k_major(const bf16* tile, int rg0, int kk) {
  return make_desc(tile + (rg0 * (KP / 8) + 2 * kk) * 64, 128, KP * 16);
}
template <int KP>
__device__ __forceinline__ uint64_t desc_mn_major(const bf16* tile, int kk) {
  return make_desc(tile + 2 * kk * (KP / 8) * 64, KP * 16, 128);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// m64nNk16, bf16 in, f32 accumulate; d is the warpgroup's N / 2 f32
// accumulator registers per thread (warp w of the group holds rows
// 16w + g and 16w + g + 8, g = lane / 4; n8 block j in d[4j .. 4j + 3]).
// acc = 0 overwrites d. wgmma_ss_nN: A and B from shared memory, both
// K-major. wgmma_rs_nN<TB>: A from registers (the m16n8k16 A fragment of
// the warp's 16 rows), B from shared memory, K-major (TB = 0) or MN-major
// (TB = 1).

__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n40(float* d, const uint32_t* a, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19}, "
      "{%20, %21, %22, %23}, %24, p, 1, 1, %26;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n48(float* d, const uint32_t* a, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, %30;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n80(float* d, const uint32_t* a, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, %46;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n160(float* d, const uint32_t* a, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, "
      "{%80, %81, %82, %83}, %84, p, 1, 1, %86;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TB));
}


template <int N, int TB = 0>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db, int acc) {
  static_assert(N == 32 || N == 64 || N == 128, "wgmma_ss: N");
  static_assert(TB == 0 || N == 128, "wgmma_ss: MN-major B at N = 128 only");
  if constexpr (N == 32) wgmma_ss_n32(d, da, db, acc);
  else if constexpr (N == 64) wgmma_ss_n64(d, da, db, acc);
  else wgmma_ss_n128<TB>(d, da, db, acc);
}

template <int N, int TB>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db, int acc) {
  static_assert(N == 32 || N == 40 || N == 48 || N == 64 || N == 80 || N == 128 || N == 160,
                "wgmma_rs: N");
  if constexpr (N == 32) wgmma_rs_n32<TB>(d, a, db, acc);
  else if constexpr (N == 40) wgmma_rs_n40<TB>(d, a, db, acc);
  else if constexpr (N == 48) wgmma_rs_n48<TB>(d, a, db, acc);
  else if constexpr (N == 64) wgmma_rs_n64<TB>(d, a, db, acc);
  else if constexpr (N == 80) wgmma_rs_n80<TB>(d, a, db, acc);
  else if constexpr (N == 128) wgmma_rs_n128<TB>(d, a, db, acc);
  else wgmma_rs_n160<TB>(d, a, db, acc);
}

// ----------------------------------------------------- 128-byte swizzle
//
// wgmma's 128-byte swizzled layout, which the tensor cores read at full
// rate (the no-swizzle layout above hands them 16 bytes of a row per
// access): rows of 64 bf16 (128 bytes) in 1024-byte atoms of 8 rows, the
// 16-byte chunk c of row r stored at chunk c ^ (r % 8) of its row; atoms
// must start at 1024-byte aligned shared addresses (the swizzle XORs
// address bits 4-6 with bits 7-9).
//   * K-major (rows are M or N, the 64 columns a k slice): stride byte
//     offset 1024 (next 8 rows); a 16-deep k step advances the start by
//     32 bytes inside the atom.
//   * MN-major (rows are k, the 64 columns an N slice): stride byte offset
//     1024 (next 8 k rows), leading byte offset the distance to the atoms
//     of the next 64 columns; a k step advances by two atoms.

// Element offset of chunk c (0..7) of row r in a swizzled tile of 64 columns.
__device__ __forceinline__ int sw128(int r, int c) {
  return (r >> 3) * 512 + (r & 7) * 64 + ((c ^ r) & 7) * 8;
}

__device__ __forceinline__ uint64_t make_desc_sw128(const void* p, uint32_t lbo, uint32_t sbo) {
  return make_desc(p, lbo, sbo) | (1ull << 62);
}

// Rows [0, rows) x columns [0, D) of a row-major (rows, D) bf16 source
// into an R x KP swizzled tile (KP % 64 == 0: KP / 64 column slices of
// R x 64, each R / 8 atoms), by THREADS threads. Rows >= rows are
// zero-filled; chunks past D are not written (zero them once with
// zero_pad_sw128).
template <int R, int KP, int THREADS>
__device__ __forceinline__ void load_tile_sw128(bf16* dst, const bf16* src, int rows, int D) {
  constexpr int NC = KP / 8;
  const int dc = D / 8;
  for (int idx = threadIdx.x; idx < R * NC; idx += THREADS) {
    const int r = idx / NC, c = idx % NC;
    if (c >= dc) continue;
    const bool valid = r < rows;
    cp_async16(dst + (c >> 3) * (R * 64) + sw128(r, c & 7),
               valid ? src + (size_t)r * D + c * 8 : src, valid);
  }
}

// Zero the chunks [D / 8, KP / 8) of every row of an R x KP swizzled tile
// (plain stores; fence_proxy_async and a barrier before wgmma reads them).
template <int R, int KP, int THREADS>
__device__ __forceinline__ void zero_pad_sw128(bf16* dst, int D) {
  const int dc = D / 8, pad = KP / 8 - dc;
  for (int idx = threadIdx.x; idx < R * pad; idx += THREADS) {
    const int r = idx / pad, c = dc + idx - r * pad;
    *reinterpret_cast<uint4*>(dst + (c >> 3) * (R * 64) + sw128(r, c & 7)) =
        make_uint4(0u, 0u, 0u, 0u);
  }
}

// Descriptor of k step kk (16 columns) of rows [row0, row0 + 64 or N) of
// an R-row swizzled tile read K-major, and of k step kk (16 rows) of an
// R-row swizzled tile read MN-major (N across its column slices).
template <int R>
__device__ __forceinline__ uint64_t desc_k_sw128(const bf16* tile, int row0, int kk) {
  return make_desc_sw128(tile + (kk >> 2) * (R * 64) + row0 * 64 + (kk & 3) * 16, 16, 1024);
}
template <int R>
__device__ __forceinline__ uint64_t desc_mn_sw128(const bf16* tile, int kk) {
  return make_desc_sw128(tile + kk * 2 * 512, R * 128, 1024);
}

// The m16n8k16 A fragment (k step kk) of rows [row0, row0 + 16) of a
// blocked tile with KP columns, by ldmatrix: lane l addresses row l % 8 of
// core matrix l / 8 (rows +8 for odd, columns +8 for the upper two).
template <int KP>
__device__ __forceinline__ void ldsm_a(uint32_t* a, const bf16* tile, int row0, int kk) {
  const int lane = threadIdx.x % 32, m = lane / 8;
  const bf16* p = tile + ((row0 / 8 + (m & 1)) * (KP / 8) + 2 * kk + (m >> 1)) * 64 + (lane % 8) * 8;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(smem_u32(p)));
}

// ---------------------------------------------------- tf32 (split f32)
//
// f32 products on the tensor cores as three TF32 products (3xTF32):
// a b ~ ah bh + ah bl + al bh with ah = tf32(a), al = tf32(a - ah), which
// keeps ~22 bits of each operand against TF32's 11. wgmma on .tf32 reads
// the top 19 bits of each 32-bit element and drops the rest, so hi and lo
// are rounded (cvt.rna) before they are stored or passed.
//
// f32 tile layout: the blocked layout above with core matrices of 8 rows x
// 4 f32 (still 128 contiguous bytes, 16 bytes a row); the core matrix of
// row group rg and column group cg of an R x KP tile (KP % 8 == 0) starts
// at element (rg * KP / 4 + cg) * 32. wgmma reads .tf32 operands K-major
// only (no transpose bit): leading byte offset 128 (next column group),
// stride byte offset KP * 32 (next row group); an 8-deep k step advances
// the start by two column groups (256 bytes).

// x rounded to TF32 (nearest, ties away), its low 13 bits zero.
__device__ __forceinline__ float tf32_round(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return __uint_as_float(y & 0xffffe000u);
}

__device__ __forceinline__ void split_tf32(float x, float& hi, float& lo) {
  hi = tf32_round(x);
  lo = tf32_round(x - hi);
}

// Element offset of (r, c) in an f32 tile with KP columns.
template <int KP>
__device__ __forceinline__ int f32_tile_off(int r, int c) {
  return ((r >> 3) * (KP / 4) + (c >> 2)) * 32 + (r & 7) * 4 + (c & 3);
}

// Descriptor of k step kk (8 columns) of rows [8 rg0, ...) of an f32 tile
// with KP columns, read K-major.
template <int KP>
__device__ __forceinline__ uint64_t desc_tf32(const float* tile, int rg0, int kk) {
  return make_desc(tile + (rg0 * (KP / 4) + 2 * kk) * 32, 128, KP * 32);
}

// The 128-byte swizzled f32 tile (the GEMM tile's): rows of 32 f32 (128
// bytes) in 1024-byte atoms of 8 rows, the 16-byte chunk c (columns 4c to
// 4c + 3) of row r stored at chunk c ^ (r % 8) of its row; the tile starts
// 1024-byte aligned. Read K-major: stride byte offset 1024 (next 8 rows); an
// 8-deep k step advances the start by 32 bytes inside the atom.
__device__ __forceinline__ int sw128_f32(int r, int c) { return r * 32 + ((c ^ r) & 7) * 4; }

// Descriptor of k step kk of rows [row0, ...) of a swizzled f32 tile.
__device__ __forceinline__ uint64_t desc_sw128_f32(const float* tile, int row0, int kk) {
  return make_desc_sw128(tile + row0 * 32 + kk * 8, 16, 1024);
}

// The m64nNk8 tf32 A fragment holds columns t and t + 4 (t = lane % 4) of
// the warp's rows g and g + 8 in a[0], a[2] and a[1], a[3]; a 64-row f32
// accumulator holds columns 2t and 2t + 1 of n8 block kk in d[4kk ..]. So
// the accumulator goes in as it lies, with column 2t read as k = t and
// 2t + 1 as k = t + 4, and the B operand's k rows are stored in the same
// order: row j of an 8-row group goes to position tf32_kperm(j).
__host__ __device__ constexpr int tf32_kperm(int j) { return (j & 1) * 4 + (j >> 1); }

// k step kk of a 64-row f32 accumulator as the hi and lo A fragments.
__device__ __forceinline__ void pack_a_tf32(uint32_t* hi, uint32_t* lo, const float* acc, int kk) {
  const float* c = acc + 4 * kk;
  const float x[4] = {c[0], c[2], c[1], c[3]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float h, l;
    split_tf32(x[i], h, l);
    hi[i] = __float_as_uint(h);
    lo[i] = __float_as_uint(l);
  }
}

// m64nNk8, tf32 in, f32 accumulate, the accumulator as for bf16 above.
// wgmma_tf32_ss_nN: A and B from shared memory; wgmma_tf32_rs_nN: A from
// registers (the fragment above). Both operands K-major.

__device__ __forceinline__ void wgmma_tf32_ss_n8(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3}, "
      "%4, %5, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_tf32_ss_n16(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_tf32_ss_n32(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_tf32_ss_n64(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_tf32_rs_n16(float* d, const uint32_t* a, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_tf32_rs_n40(float* d, const uint32_t* a, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19}, "
      "{%20, %21, %22, %23}, %24, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_tf32_rs_n64(float* d, const uint32_t* a, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_tf32_rs_n80(float* d, const uint32_t* a, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_tf32_rs_n160(float* d, const uint32_t* a, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, "
      "{%80, %81, %82, %83}, %84, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_tf32_ss_n128(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

template <int N>
__device__ __forceinline__ void wgmma_tf32_ss(float* d, uint64_t da, uint64_t db, int acc) {
  static_assert(N == 8 || N == 16 || N == 32 || N == 64 || N == 128, "wgmma_tf32_ss: N");
  if constexpr (N == 8) wgmma_tf32_ss_n8(d, da, db, acc);
  else if constexpr (N == 16) wgmma_tf32_ss_n16(d, da, db, acc);
  else if constexpr (N == 32) wgmma_tf32_ss_n32(d, da, db, acc);
  else if constexpr (N == 64) wgmma_tf32_ss_n64(d, da, db, acc);
  else wgmma_tf32_ss_n128(d, da, db, acc);
}

template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float* d, const uint32_t* a, uint64_t db, int acc) {
  static_assert(N == 16 || N == 40 || N == 64 || N == 80 || N == 160, "wgmma_tf32_rs: N");
  if constexpr (N == 16) wgmma_tf32_rs_n16(d, a, db, acc);
  else if constexpr (N == 40) wgmma_tf32_rs_n40(d, a, db, acc);
  else if constexpr (N == 64) wgmma_tf32_rs_n64(d, a, db, acc);
  else if constexpr (N == 80) wgmma_tf32_rs_n80(d, a, db, acc);
  else wgmma_tf32_rs_n160(d, a, db, acc);
}

}  // namespace hopper_tile
