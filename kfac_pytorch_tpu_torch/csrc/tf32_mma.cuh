// 3xTF32 tensor-core products and cp.async copies, for Hopper (sm_90a).
//
// Shared by csrc/flash_attention.cu (kernels 5–7), csrc/fused_apply.cu
// (kernel 3) and csrc/patch_cov.cu (kernels 1 and 1g). Every product of
// those kernels runs as mma.sync m16n8k8 TF32 in 3xTF32, as CUTLASS's
// OpMultiplyAddFastF32 does: each float32 operand is split in registers as
// x = big + small (big = x rounded to TF32, small = the remainder truncated
// to TF32), and a·b ≈ a_small·b_big + a_big·b_small + a_big·b_big, summed
// in float32: about float32 accuracy at three TF32 products per product.
//
// Fragments of m16n8k8 (g = lane / 4, t = lane % 4):
//   A 16x8: a0 (g, t)  a1 (g+8, t)  a2 (g, t+4)  a3 (g+8, t+4)
//   B 8x8:  b0 (k=t, n=g)  b1 (k=t+4, n=g)
//   C 16x8: c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

// The 3xTF32 split, as CUTLASS's OpMultiplyAddFastF32 makes it: x = big +
// small + O(2^-21 |x|). big is x rounded to TF32 (10 mantissa bits) to
// nearest, ties away from zero: half a TF32 ulp added to the magnitude
// bits, the 13 low bits cleared — what cvt.rna.tf32.f32 computes for finite
// x, in 2 integer operations where sm_90a's cvt takes 4. small is the
// remainder x − big, exact in float32, truncated to TF32.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) & 0xffffe000u;
}

// c += a·b on one m16n8k8 TF32 tile
__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a·b in 3xTF32: the two cross terms first, then big·big;
// small·small is dropped. a is split by the caller (it serves a row of
// tiles), b = (b0, b1) here.
__device__ __forceinline__ void mma_3xtf32(float c[4], const uint32_t ab[4],
                                           const uint32_t as[4], float b0,
                                           float b1) {
  uint32_t bb0, bs0, bb1, bs1;
  split(b0, bb0, bs0);
  split(b1, bb1, bs1);
  mma_tf32(c, as, bb0, bb1);
  mma_tf32(c, ab, bs0, bs1);
  mma_tf32(c, ab, bb0, bb1);
}

// An A fragment's four values, split
__device__ __forceinline__ void split4(float x0, float x1, float x2, float x3,
                                       uint32_t big[4], uint32_t small[4]) {
  split(x0, big[0], small[0]);
  split(x1, big[1], small[1]);
  split(x2, big[2], small[2]);
  split(x3, big[3], small[3]);
}

// 16 bytes from global to shared memory; the first src_bytes (0..16) are
// copied, the rest zero-filled. Both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(src_bytes));
}

// 8 bytes; the first src_bytes (0 or 8) copied, the rest zero-filled.
// Both addresses 8-byte aligned.
__device__ __forceinline__ void cp_async8(float* dst, const float* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(s), "l"(src), "r"(src_bytes));
}

// one float; zero where !valid
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N groups of copies are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

}  // namespace tf32x3
