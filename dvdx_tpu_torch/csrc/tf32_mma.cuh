// Float32-accurate products on the tensor cores: the three-pass TF32 split
// (CUTLASS's OpMultiplyAddFastF32) over mma.sync.m16n8k8.tf32, and the
// cp.async copies that stage its operand tiles. Used by the float32 forms'
// product (f32_rows.cuh: f32_gemm) and attention (attention_f32.cuh:
// attention_f32_mma).
//
// The tensor cores take float32 only as TF32: 10 mantissa bits, about 1e-3
// relative, far from float32's 2^-24. Each operand is split as x = big +
// small, big = x rounded to TF32 (to nearest, ties away from zero, by
// integer add and mask) and small = x - big (exact in f32), passed as its
// f32 bits: the tensor core reads a TF32 operand's top 19 bits, so small is
// truncated to TF32 there, within 2^-21 |x|. A product is then
//   a b ~ a_small b_big + a_big b_small + a_big b_big,
// three TF32 passes accumulated in f32, the small ones first. What it drops
// (a_small b_small, 2^-22 |a b|, and small's truncation) is near float32's
// own rounding. The tensor core also truncates each sum it accumulates, so
// a chain of mma.sync into one accumulator drifts toward zero by about half
// an ulp a step: 2.4e-5 relative after the 1080 steps of float32 flash's
// P.V over 2880 keys, measured on the H100. So callers keep each chain
// short (12 steps of a 32-deep K slice, 24 of a 64-key tile) in an
// accumulator of its own and add it to the running sum in f32 (round to
// nearest). Both stay within 1e-5 of the largest float32 output
// (tests/test_torch_tf32_split.py emulates the split, the truncated sums
// and the kernels' chains at the path's depths; one pass, or one chain
// over all of K, misses that bound). On the H100 the integer split, the
// per-slice and per-tile chains and register-rich blocks (one an SM for the
// product, two for the attention) ran both kernels faster than
// cvt.rna.tf32.f32 for both parts, a sum rounded to nearest after every
// k-step and blocks capped at 128 or 168 registers, at the same error
// (PERF.md §6). Its peak on the H100 SXM is 495 / 3 = 165
// TFLOP/s of f32-accurate operations, 2.5 times the CUDA cores' 67.
//
// mma.sync.m16n8k8 (PTX ISA, tf32 fragments), g = lane / 4, t = lane % 4:
//   A (16 x 8, row):  a0 (g, t)  a1 (g + 8, t)  a2 (g, t + 4)  a3 (g + 8, t + 4)
//   B (8 x 8, col):   b0 (k = t, n = g)  b1 (k = t + 4, n = g)
//   C (16 x 8, f32):  c0 (g, 2t)  c1 (g, 2t + 1)  c2 (g + 8, 2t)  c3 (g + 8, 2t + 1)
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace dvdx {
namespace f32 {

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// big: x rounded to TF32 (to nearest, ties away from zero: half a TF32 ulp
// added to the magnitude, the low 13 bits cleared); small: x - big, exact,
// as f32 bits (the tensor core truncates it to TF32)
__device__ __forceinline__ void tf32_split(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// D += A (16 x 8) B (8 x 8), TF32 operands, f32 accumulator
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The three passes on split fragments, small ones first, into d (a short
// chain: see the note above)
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4], uint32_t b0_big,
                                           uint32_t b1_big, uint32_t b0_small,
                                           uint32_t b1_small) {
  mma_tf32(d, a_small, b0_big, b1_big);
  mma_tf32(d, a_big, b0_small, b1_small);
  mma_tf32(d, a_big, b0_big, b1_big);
}

// B fragment from shared memory: b0 at p[0], b1 at p[b1_off], each split
__device__ __forceinline__ void b_frag(const float* p, int b1_off, uint32_t& b0_big,
                                       uint32_t& b1_big, uint32_t& b0_small,
                                       uint32_t& b1_small) {
  tf32_split(p[0], b0_big, b0_small);
  tf32_split(p[b1_off], b1_big, b1_small);
}

// ---- cp.async --------------------------------------------------------------

// 16 bytes, of which the first src_bytes (0..16) are read and the rest
// zero-filled; src 16-byte aligned
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(shared_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes, read if src_bytes == 4, zero if 0
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(shared_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace f32
}  // namespace dvdx
