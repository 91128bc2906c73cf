// f32 products on Hopper's tensor cores for the f32 flash-attention backward
// (flash_attention_bwd.cu): mma.sync m16n8k8 with TF32 operands and f32
// accumulators, each f32 product split in three TF32 products (3xTF32).
//
// TF32 keeps 10 of f32's 23 mantissa bits, so one TF32 product keeps about
// three decimal digits.  An f32 x splits as hi = tf32(x), rounded to
// nearest, and lo = tf32(x - hi) (x - hi is exact in f32, |lo| <= 2^-11
// |x|); then a b = hi_a hi_b + hi_a lo_b + lo_a hi_b + lo_a lo_b, where the
// last term is below 2^-22 |a b| and is dropped.  The product of two TF32
// values is exact in the f32 accumulator's significand, so the three
// products keep about f32's error.  The two small products are issued
// first, so that they reach the accumulator before the large one does.
//
// The tensor core reads a .tf32 register's top 19 bits and drops the 13
// below, so lo is passed as the f32 x - hi and enters the product
// truncated toward zero (an error below 2^-21 |a b|): rounding it to
// nearest first, two more instructions a split, took 12% longer at the
// training shape in an A/B on an H100 (chip_smoke.py's flash_bwd_tf32_ab).
//
// Register layouts of m16n8k8 with .tf32 operands (a warp's lane = 4 g + t,
// g < 8, t < 4; PTX ISA, "Matrix fragments for mma.m16n8k8"):
//   * A (16 x 8, row-major): a0 (row g, k t), a1 (g + 8, t), a2 (g, t + 4),
//     a3 (g + 8, t + 4);
//   * B (8 x 8, column-major): b0 (k t, column g), b1 (k t + 4, g);
//   * C and D (16 x 8, f32): c0 (row g, column 2 t), c1 (g, 2 t + 1),
//     c2 (g + 8, 2 t), c3 (g + 8, 2 t + 1).
#pragma once

#include <stdint.h>

namespace ptt {
namespace sm90 {

// the bits of cvt.rna.tf32.f32 (to nearest, ties away from zero; the 13
// low bits zero) in two integer instructions: half a TF32 ulp added to the
// magnitude, the bits below TF32's mantissa cleared
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo: hi TF32, lo the f32 rest (the tensor core reads it as TF32)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a b, one TF32 product of m16n8k8
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in about f32's precision: lo_a hi_b, hi_a lo_b, then hi_a hi_b
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4], const uint32_t (&b_hi)[2],
                                           const uint32_t (&b_lo)[2]) {
  mma_tf32(d, a_lo, b_hi);
  mma_tf32(d, a_hi, b_lo);
  mma_tf32(d, a_hi, b_hi);
}

}  // namespace sm90
}  // namespace ptt
