// Tensor-core building blocks shared by the port's mma.sync kernels
// (ssd.cu, mlstm.cu): ldmatrix fragment loads, the m16n8k16 bf16 product
// with f32 sums, and the split of f32 values into bf16 terms.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// four 8 x 8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8. trans: each thread gets a column pair instead
// of a row pair (the B operand of a row-major K x N tile).
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const __nv_bfloat16* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row))
               : "memory");
}
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const __nv_bfloat16* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row))
               : "memory");
}

// (x0, x1) as hi + lo bf16 pairs: hi = x truncated to bf16 (exact in f32), lo
// = the remainder rounded to bf16, so hi + lo holds x to 2^-16 relative
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const uint32_t b0 = __float_as_uint(x0), b1 = __float_as_uint(x1);
  hi = __byte_perm(b0, b1, 0x7632);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - __uint_as_float(b0 & 0xffff0000u),
                                                 x1 - __uint_as_float(b1 & 0xffff0000u));
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// (x0, x1) as N bf16 pairs: every term but the last the remainder truncated
// to bf16 (exact in f32), the last the remainder rounded, so the N terms
// hold x to 2^-(8 N) relative (N = 2: split2; N = 3: about f32's 2^-24)
template <int N>
__device__ __forceinline__ void splitn(float x0, float x1, uint32_t (&t)[N]) {
#pragma unroll
  for (int k = 0; k + 1 < N; ++k) {
    const uint32_t b0 = __float_as_uint(x0), b1 = __float_as_uint(x1);
    t[k] = __byte_perm(b0, b1, 0x7632);
    x0 -= __uint_as_float(b0 & 0xffff0000u);
    x1 -= __uint_as_float(b1 & 0xffff0000u);
  }
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0, x1);
  t[N - 1] = *reinterpret_cast<const uint32_t*>(&l);
}

// D += A (16 x 16, row) . B (16 x 8, col), bf16 in, f32 sums
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ldmatrix row addresses. Pattern A, for a 16 x 16 A fragment of a
// row-major tile (rows = M) and, transposed, for the B fragments of two
// column tiles of a row-major K x N tile: matrices (rows +0, cols +0),
// (+8, +0), (+0, +8), (+8, +8). Pattern B, for the B fragments of two
// column tiles of an N x K tile (rows = N) and, transposed, for an A
// fragment of a K x M tile: (+0, +0), (+0, +8), (+8, +0), (+8, +8).
__device__ __forceinline__ int row_a(int lane) { return (lane & 7) + ((lane >> 3) & 1) * 8; }
__device__ __forceinline__ int col_a(int lane) { return (lane >> 4) * 8; }
__device__ __forceinline__ int row_b(int lane) { return (lane & 7) + (lane >> 4) * 8; }
__device__ __forceinline__ int col_b(int lane) { return ((lane >> 3) & 1) * 8; }

}  // namespace
