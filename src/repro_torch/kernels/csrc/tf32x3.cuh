// f32-accurate products on Hopper's tensor cores (3xTF32), shared by
// ridge_gram.cu, flash_attention_tf32.cu and mamba2_scan.cu.
//
// A TF32 operand keeps 10 of float32's 23 mantissa bits.  Each f32 value a is
// split into a TF32 high part and a TF32 low part,
//   hi = rna(a),  lo = rna(a - hi)   (rna: to nearest, ties away from zero),
// so that a = hi + lo to about 2^-22 relative, and a product a b is taken as
// hi_a hi_b + hi_a lo_b + lo_a hi_b: three mma.sync.m16n8k8 TF32 products
// with f32 accumulation, the dropped lo_a lo_b being ~2^-22 of a b.  That is
// 495 / 3 = 165 TFLOP/s of f32-accurate work on an H100 SXM, against 67
// TFLOP/s of FP32 FFMA.  One TF32 product alone (hi_a hi_b) carries ~2^-11
// relative error per term, which misses the port's f32 bounds.
//
// Fragment layout of m16n8k8 TF32, g = lane / 4, t = lane % 4:
//   A (16 x 8, row): a0 = (g, t), a1 = (g + 8, t), a2 = (g, t + 4),
//                    a3 = (g + 8, t + 4)
//   B (8 x 8, col):  b0 = (k t, n g), b1 = (k t + 4, n g)
//   C (16 x 8):      c0, c1 = (g, 2t), (g, 2t + 1);
//                    c2, c3 = (g + 8, 2t), (g + 8, 2t + 1)
// ldmatrix moves 16-bit elements, so the kernels load these 32-bit fragments
// with plain shared-memory loads, from rows padded so that the 8 rows (or the
// 4 columns) a load touches fall in distinct banks.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

// a rounded to TF32, to nearest with ties away from zero: half of the
// dropped 13-bit field added to the magnitude bits, then the field cleared.
// For finite a this is cvt.rna.tf32.f32, which sm_90a emulates in 4
// instructions (an inf/nan test among them) where this takes 2; the
// kernels' operands are finite.
__device__ __forceinline__ uint32_t rna_tf32(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
}

// a = hi + lo, both TF32 (their low 13 bits zero), each rounded to nearest;
// a - hi is exact in f32
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi,
                                           uint32_t& lo) {
  hi = rna_tf32(a);
  lo = rna_tf32(a - __uint_as_float(hi));
}

// a = hi + lo with hi rounded to nearest and lo = a - hi exact in f32 but
// not rounded to TF32: the tensor core reads the top 19 bits of a TF32
// operand, so lo enters the product truncated, ~2^-21 of a where the
// rounded lo of split_tf32 leaves ~2^-22.  Three instructions where
// split_tf32 takes five; the CPU emulation of the SSD kernel, which uses
// it, stays within its bound (tests/test_torch_scan_order.py).
__device__ __forceinline__ void split_tf32_fast(float a, uint32_t& hi,
                                                uint32_t& lo) {
  hi = rna_tf32(a);
  lo = __float_as_uint(a - __uint_as_float(hi));
}

// d += a b on one m16n8k8 tile: TF32 a (16 x 8, row) and b (8 x 8, col),
// f32 d
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The kernels issue the three products of a 3xTF32 step as three passes
// over their independent accumulator tiles, the small terms first (lo_a
// hi_b, then hi_a lo_b, then hi_a hi_b, as CUTLASS's OpMultiplyAddFastF32
// orders them), so that consecutive mma never wait on each other.  The mma
// are not volatile, so the compiler may interleave them further.

// d = a b on one m16n8k8 tile from a zero accumulator.  The tensor core
// truncates the sum it forms (it rounds toward zero), so each mma into an
// accumulator drops up to one unit in its last place, the same way for
// terms of one sign: over the hundreds or thousands of mma of a long sum of
// such terms the drift reaches 1e-6 to 1e-4 of the result.  A long sum is
// formed in short runs from zero (a k8 step in the Gram, a tile of keys in
// attention), each run added to it with a rounded FP32 add.
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.0f));
}

}  // namespace tf32x3
