// Hopper building blocks for hand-written tensor-core kernels: cp.async
// 16-byte copies with zero fill into 128-byte-swizzled tiles, wgmma shared
// memory descriptors for those tiles, and the wgmma m64nNk16 bf16 -> f32
// products the flash-attention backward needs, with their register layouts.
//
// Tile layout (SW128).  A [rows][dp] bf16 tile (dp a multiple of 64) is kept
// as dp / 64 column blocks of [rows][64]; row r of a block is 128 bytes at
// r * 128, and its 16-byte chunk c is stored at chunk c ^ (r % 8), the
// swizzle that a descriptor with layout type 1 names.  Every tile starts on
// a 1024-byte boundary.  One tile serves two ways:
//   * K-major (the product's k runs along dp): the k step kk of 16 columns
//     starts at block kk / 4, byte (kk % 4) * 32; 8-row groups are 1024
//     bytes apart (SBO), LBO is unused.  Used for A and for B of X Y^T.
//   * MN-major (k runs along the rows, n along dp; the transpose bit): the
//     k step of 16 rows starts at byte kk * 2048; 8-row groups are 1024
//     bytes apart (SBO) and the 64-column blocks rows * 128 bytes (LBO).
//     Used for B of X Y, with Y as it lies in memory.
//
// Register layouts (per warpgroup of 128 threads; warp w, lane l):
//   * accumulator of m64nN: element (row, col) with row = 16 w + l / 4 + 8 i,
//     col = 8 j + 2 (l % 4) + e is register d[4 j + 2 i + e];
//   * A operand of m64nNk16 from registers: four bf16x2, rows 16 w + l / 4
//     (+ 8 in a[1], a[3]), columns 2 (l % 4) + {0, 1} (+ 8 in a[2], a[3]).
//   So columns 16 kk .. 16 kk + 15 of an accumulator, rounded to bf16, are
//   the A operand of k step kk of the next product (acc_to_a).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace ptt {
namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes when !valid (the
// source is then not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}

// 4 bytes, or 4 zero bytes when !valid
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most N of this thread's commit groups are in flight, then
// make the copies visible to wgmma (the async proxy); a block barrier must
// follow before other threads' copies count
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// rows x dp bf16 from src (row stride `stride` elements) into an SW128 tile;
// rows >= rows_valid and columns >= d are zero.  THREADS threads share it,
// 16 bytes each per copy, neighbouring threads on neighbouring chunks; a
// thread keeps its chunk column and steps down the rows by a multiple of 8,
// so its swizzle is the same for every copy.
template <int ROWS, int DP, int THREADS>
__device__ __forceinline__ void load_tile_sw128(__nv_bfloat16* tile, const __nv_bfloat16* src,
                                                int64_t stride, int rows_valid, int d, int tid) {
  constexpr int kChunks = DP / 8;  // 16-byte chunks a row
  constexpr int kRowStep = THREADS / kChunks;
  static_assert(THREADS % kChunks == 0 && kRowStep % 8 == 0 && ROWS % kRowStep == 0,
                "whole rows a step, the swizzle fixed");
  const int c = tid % kChunks, r0 = tid / kChunks;
  const bool col_ok = c * 8 < d;
  const uint32_t dst = smem_u32(tile) + (c / 8) * (ROWS * 128) + r0 * 128 +
                       (((c % 8) ^ (r0 % 8)) << 4);
  const __nv_bfloat16* from = src + r0 * stride + c * 8;
#pragma unroll
  for (int n = 0; n < ROWS / kRowStep; ++n) {
    const bool valid = col_ok && r0 + n * kRowStep < rows_valid;
    cp_async16(dst + n * kRowStep * 128, valid ? from + n * kRowStep * stride : src, valid);
  }
}

// descriptor of an SW128 tile at shared address `addr` (1024-byte aligned
// tile, plus the k step's byte offset)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo_bytes >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// k step kk (16 columns) of a K-major tile of `rows` rows
__device__ __forceinline__ uint64_t desc_kmajor(const void* tile, int rows, int kk) {
  return desc_sw128(smem_u32(tile) + (kk / 4) * rows * 128 + (kk % 4) * 32, 16);
}

// k step kk (16 rows) of an MN-major tile of `rows` rows
__device__ __forceinline__ uint64_t desc_mnmajor(const void* tile, int rows, int kk) {
  return desc_sw128(smem_u32(tile) + kk * 2048, rows * 128);
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

// keep the compiler from moving reads or writes of registers across the
// wgmma fence and wait instructions around them
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// columns 16 kk .. 16 kk + 15 of an m64nN f32 accumulator as the bf16 A
// operand of k step kk
template <int R>
__device__ __forceinline__ void acc_to_a(const float (&acc)[R], int kk, uint32_t (&a)[4]) {
  a[0] = pack_bf16x2(acc[8 * kk + 0], acc[8 * kk + 1]);
  a[1] = pack_bf16x2(acc[8 * kk + 2], acc[8 * kk + 3]);
  a[2] = pack_bf16x2(acc[8 * kk + 4], acc[8 * kk + 5]);
  a[3] = pack_bf16x2(acc[8 * kk + 6], acc[8 * kk + 7]);
}

// d (+)= A B^T: A and B K-major SW128 tiles (descriptors), d an m64n64 f32
// accumulator; scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t desc_a,
                                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (+)= A B^T with A from registers (acc_to_a layout) and B a K-major SW128
// tile, d an m64n64 f32 accumulator
__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_m64n64_tb(float (&d)[32], const uint32_t (&a)[4],
                                                  uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_m64n128_tb(float (&d)[64], const uint32_t (&a)[4],
                                                  uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// d += A B with A from registers (acc_to_a layout) and B an MN-major SW128
// tile (the transpose bit), d an m64n64 or m64n128 f32 accumulator
template <int N>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[N / 2], const uint32_t (&a)[4],
                                            uint64_t desc_b, int scale_d);
template <>
__device__ __forceinline__ void wgmma_rs_tb<64>(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t desc_b, int scale_d) {
  wgmma_rs_m64n64_tb(d, a, desc_b, scale_d);
}
template <>
__device__ __forceinline__ void wgmma_rs_tb<128>(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t desc_b, int scale_d) {
  wgmma_rs_m64n128_tb(d, a, desc_b, scale_d);
}

}  // namespace sm90
}  // namespace ptt
