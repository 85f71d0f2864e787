// mma.sync building blocks shared by csrc/ssd_chunk.cu and csrc/ssd_bwd.cu:
// cp.async copies, ldmatrix loads, the m16n8k16 bf16 product with fp32
// sums, and the split of fp32 values into bf16 pieces. Each source
// includes it before its own code; everything here has internal linkage,
// so each library keeps its own copy.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 .bf16 with .f32 accumulators),
// with g = lane / 4 and t = lane % 4:
//   accumulator c[0..1] = (row g, cols 2t, 2t + 1), c[2..3] = (row g + 8,
//     the same cols);
//   A a[0] = (row g, k 2t, 2t + 1), a[1] = (row g + 8, k 2t, 2t + 1),
//     a[2] and a[3] the same at k + 8 (two bf16 a register, the lower k in
//     the low half);
//   B b[0] = (k 2t, 2t + 1, col g), b[1] = the same at k + 8.
// So two neighbouring 8-column accumulator tiles, packed to bf16, are the
// A fragment of a product over those 16 columns.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !valid (src is not read then)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
// 8 or 4 bytes global -> shared (through L1), zero-filled when !valid
template <int BYTES>
__device__ __forceinline__ void cp_async_small(void* dst, const void* src,
                                               bool valid) {
  static_assert(BYTES == 4 || BYTES == 8, "cp.async.ca takes 4 or 8 bytes");
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "n"(BYTES), "r"(valid ? BYTES : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4],
                                        const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4],
                                          const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a b, m16n8k16, bf16 in, fp32 sums (not volatile: the compiler may
// interleave independent products)
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float lo_f(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float hi_f(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

// (u, v) as three bf16 pairs whose sums are u and v to ~2^-27 relative:
// each piece is the round-to-nearest bf16 of what the earlier ones left
// (a value minus its bf16 rounding is exact in fp32)
__device__ __forceinline__ void split3(float u, float v, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(u, v);
  u -= __low2float(h);
  v -= __high2float(h);
  const __nv_bfloat162 m = __floats2bfloat162_rn(u, v);
  u -= __low2float(m);
  v -= __high2float(m);
  hi = bits(h);
  mid = bits(m);
  lo = bits(__floats2bfloat162_rn(u, v));
}

// the first two pieces of split3 (sums within ~2^-17 relative)
__device__ __forceinline__ void split2(float u, float v, uint32_t& hi,
                                       uint32_t& mid) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(u, v);
  hi = bits(h);
  mid = bits(__floats2bfloat162_rn(u - __low2float(h), v - __high2float(h)));
}

}  // namespace
