// Tensor-core and asynchronous-copy helpers shared by the port's mma.sync
// kernels (`attention_fused.cu`, `conv3x3_fused.cu`, `stem_fused.cu`): cp.async
// into shared memory, ldmatrix and stmatrix fragments, the bf16 m16n8k16
// product, and the TF32 m16n8k8 product with the split that makes three of
// them a float32 product (3xTF32). The tensor cores sum each product into
// the float32 accumulator cut toward zero, not rounded to nearest: a 3xTF32
// sum of K products lands ~10x further from float64 than an FMA sum at K =
// 576 (`tests/test_torch_port_tf32x3_conv.py` models it), far inside 1e-4.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace ddt {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// src_bytes = 0 zero-fills the destination without reading `src`.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// At most N groups are still in flight (this thread's copies).
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Four 8x8 b16 matrices to shared memory; lanes 8i .. 8i+7 give the row
// addresses of matrix i, whose fragment is r_i (the layout of an mma C
// fragment packed to bf16x2).
__device__ __forceinline__ void stsm_x4(uint32_t addr, uint32_t r0, uint32_t r1, uint32_t r2, uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(r0),
               "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo: the lower column
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += a (16x8, row) * b (8x8, col), TF32 in (10 explicit mantissa bits),
// f32 accumulate. Fragments (g = lane / 4, t = lane % 4): a0 row g col t, a1
// row g + 8 col t, a2 row g col t + 4, a3 row g + 8 col t + 4; b0 row t col
// g, b1 row t + 4 col g; d as the bf16 product's (rows g, g + 8, cols 2t, 2t + 1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x as big + small for 3xTF32 (CUTLASS's FastF32 split): big is x rounded
// to TF32 to nearest, ties away from zero, by adding half a TF32 ulp to the
// bits and clearing the 13 low ones (the value cvt.rna.tf32.f32 gives for
// every finite x, in 2 instructions against its 4 with the NaN checks);
// small = x - big, exact in f32, goes to the mma as it stands, which reads
// its top 19 bits (TF32 truncation). |small| <= 2^-11 |x|, so x = big +
// tf32(small) to 2^-22 |x|. A NaN x keeps a NaN small, so NaN propagates.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(__fsub_rn(x, __uint_as_float(big)));
}

// The four values of an ldmatrix.x4 fragment (a 32-bit element a register),
// split as `split_tf32`.
__device__ __forceinline__ void split_tf32x4(const uint32_t (&r)[4], uint32_t (&big)[4], uint32_t (&small)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) split_tf32(__uint_as_float(r[q]), big[q], small[q]);
}

// d += a b in float32 accuracy from split operands (3xTF32): small.big and
// big.small first, then big.big, all into d; small.small (below 2^-22 of
// |a b|) is left out. One TF32 product keeps 2^-11 of each term, three keep
// about 2^-21.
__device__ __forceinline__ void mma_tf32x3(float (&d)[4], const uint32_t (&ab)[4], const uint32_t (&as)[4],
                                           const uint32_t (&bb)[2], const uint32_t (&bs)[2]) {
  mma_tf32(d, as, bb[0], bb[1]);
  mma_tf32(d, ab, bs[0], bs[1]);
  mma_tf32(d, ab, bb[0], bb[1]);
}

}  // namespace ddt
