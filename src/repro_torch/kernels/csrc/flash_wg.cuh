// Tensor-core pieces shared by K5's bfloat16 kernels on wgmma: the forward's
// flash_fwd_wg (flash_attention.cu, head dims up to 128) and flash_fwd_wide
// (flash_attention_wide.cu, head dim 192), and the backward's wide build
// (flash_attention_bwd_wide.cu).
//
// * wgmma: matrix descriptors for 32-byte-swizzle tiles, the fences, and the
//   m64nNk16 bf16 products with f32 sums (A from shared memory or registers).
// * The forward's online softmax of one 64-key tile on S's accumulator and
//   P's split into hi + lo bf16 parts.
// * TMA and mbarriers: 4-D tensor-map loads and 1-D bulk copies that report
//   to an mbarrier, the barriers' init, arrive and parity wait, setmaxnreg
//   and named barriers for warp-specialized blocks, and the host's encoding
//   of a (batch, seq, head, width) bf16 tensor as a tensor map whose box is
//   one 16-column slab of `rows` rows.
//
// Shared tiles are "slab-major": a slab is 16 columns (32 bytes) of every row
// of a tile, row r at r * 32 bytes with its two 16-byte halves swapped when
// bit 2 of r is set (the hardware's Swizzle<1,4,3>, TMA's SWIZZLE_32B). A tile
// in this layout is a K-major operand whose k-step kk is slab kk, and an
// MN-major operand whose k-step kk is rows 16 kk .. 16 kk + 15 of every slab.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTcBQ = 128;  // query rows per block of the forward's tensor-core kernels
constexpr int kTcBK = 64;   // keys per K/V tile

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* plan;  // bf16: (q tile, first key, end key) per block order; f32: unused
  float* lse;       // (B, H, Sq) log-sum-exp of each row's scaled scores, or null
  int64_t q_sb, q_ss, q_sh;  // element strides of q (B, Sq, H, hd); inner stride 1
  int64_t k_sb, k_ss, k_sh;  // k (B, Sk, KV, hd)
  int64_t v_sb, v_ss, v_sh;  // v (B, Sk, KV, hd_v)
  int64_t o_sb, o_ss, o_sh;  // o (B, Sq, H, hd_v)
  int batch, sq, sk, h, kv;
  float scale;
  int causal;
  int window;  // 0 = full
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 2^x on the special-function unit (flushes subnormal results to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) { return *reinterpret_cast<const uint32_t*>(&v); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return bits(__floats2bfloat162_rn(lo, hi));
}

// (x0, x1) as hi + lo bf16 pairs: hi = x truncated to bf16 (exact in f32),
// lo = the remainder (|lo| < 2^-7 |x|) rounded to bf16, so hi + lo holds x to
// 2^-16 relative with one conversion per pair
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const uint32_t b0 = __float_as_uint(x0), b1 = __float_as_uint(x1);
  hi = __byte_perm(b0, b1, 0x7632);
  lo = pack_bf16(x0 - __uint_as_float(b0 & 0xffff0000u), x1 - __uint_as_float(b1 & 0xffff0000u));
}

// wgmma matrix descriptor: 32-byte swizzle, byte offsets lbo/sbo
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | static_cast<uint64_t>(3) << 62;
}
// k-step kk of a slab-major tile of `rows` rows as a K-major operand (its
// rows are the operand's M or N)
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int rows, int kk) {
  return wg_desc(tile + kk * rows * 32, rows * 32, 256);
}
// k-step kk of a slab-major tile of `rows` rows as an MN-major B operand
// (its rows are the operand's K, its columns N)
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int rows, int kk) {
  return wg_desc(tile + kk * 16 * 32, rows * 32, 256);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
__device__ __forceinline__ void wg_wait1() { asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory"); }
// Keep registers that an in-flight wgmma reads or writes out of the
// compiler's hands: an empty asm that "writes" them, placed after the wait.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) asm volatile("" : "+r"(r[i][k])::"memory");
}

// d (m64n32, f32) (+)= A·B, A and B bf16 in shared memory (both K-major)
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (m64n64, f32) (+)= A·B, A and B bf16 in shared memory (both K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (m64n32, f32) = A·B, A and B bf16 in shared memory (both K-major): the
// first k-step, whose d is an output only, so no copy of d's old values
// lands between the issue of a product in flight and its wait
__device__ __forceinline__ void wgmma_ss_n32_first(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, 0, 1, 1, 0, 0;\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15])
      : "l"(da), "l"(db));
}

// d (m64n64, f32) = A·B as wgmma_ss_n32_first
__device__ __forceinline__ void wgmma_ss_n64_first(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, 0, 1, 1, 0, 0;\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db));
}

// d (m64n16, f32) += A·B, A bf16 in registers, B bf16 in shared memory, MN-major
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64n32, f32) += A·B, A bf16 in registers, B bf16 in shared memory, MN-major
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64n64, f32) += A·B, A bf16 in registers, B bf16 in shared memory, MN-major
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64n80, f32) += A·B, A bf16 in registers, B bf16 in shared memory, MN-major
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64n128, f32) += A·B, A bf16 in registers, B bf16 in shared memory, MN-major
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64n192, f32) += A·B, A bf16 in registers, B bf16 in shared memory, MN-major
__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64nN, f32) += A·B at N = the accumulator's columns, A in registers
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 16) wgmma_rs_n16(d, a, db);
  else if constexpr (N == 32) wgmma_rs_n32(d, a, db);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (N == 80) wgmma_rs_n80(d, a, db);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db);
  else {
    static_assert(N == 192, "wgmma_rs: no product at this width");
    wgmma_rs_n192(d, a, db);
  }
}

// S = Q·Kᵀ for one warpgroup's 64 of the block's kTcBQ query rows against a
// tile of kTcBK keys (both slab-major), as m64n64k16 products over HD
template <int HD>
__device__ __forceinline__ void issue_s(float (&s)[32], uint32_t qs, uint32_t kt, int wg) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_ss_n64(s, wg_desc(qs + kk * kTcBQ * 32 + wg * 64 * 32, kTcBQ * 32, 256), kmajor(kt, kTcBK, kk), kk > 0);
}

// O += P·V over a tile of kTcBK keys, P as hi + lo bf16 fragments, V
// slab-major (the MN-major B operand), HDV the width of V and O
template <int HDV>
__device__ __forceinline__ void issue_pv(float (&o)[HDV / 2], const uint32_t (&ph)[4][4],
                                         const uint32_t (&pl)[4][4], uint32_t vt) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t dv = mnmajor(vt, kTcBK, kk);
    wgmma_rs<HDV>(o, ph[kk], dv);
    wgmma_rs<HDV>(o, pl[kk], dv);
  }
}

// The softmax of one 64-key tile of S for this thread's two rows (row0, row0
// + 8): masks the tile if it crosses a frontier (-inf, so a wholly masked
// row adds exactly nothing), takes the running max m in the base-2 domain
// (m = max(s) * scale * log2 e; scale > 0), turns s into p = 2^(s * scale *
// log2 e - m), adds the row sums into l and returns the correction factors
// 2^(m_old - m_new) of the two rows.
__device__ __forceinline__ void softmax_tile(float (&s)[32], float& m0, float& m1, float& l0,
                                             float& l1, float& c0, float& c1, float sl2, bool edge,
                                             int k0, int row0, int t4, const FlashArgs& a) {
  const float kInf = __int_as_float(0x7f800000);
  float mx0 = -kInf, mx1 = -kInf;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    if (edge) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + 2 * t4 + (e & 1);
        const int row = e < 2 ? row0 : row0 + 8;
        bool ok = key < a.sk;
        if (a.causal) ok = ok && key <= row;
        if (a.window > 0) ok = ok && key > row - a.window;
        s[4 * n + e] = ok ? s[4 * n + e] : -kInf;
      }
    }
    mx0 = fmaxf(mx0, fmaxf(s[4 * n], s[4 * n + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
  }
  // a row's 64 scores sit in the four lanes of a quad
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  mx0 = fmaxf(m0, mx0 * sl2);
  mx1 = fmaxf(m1, mx1 * sl2);
  c0 = ex2(m0 - mx0);
  c1 = ex2(m1 - mx1);
  m0 = mx0;
  m1 = mx1;
  float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    s[4 * n] = ex2(fmaf(s[4 * n], sl2, -m0));
    s[4 * n + 1] = ex2(fmaf(s[4 * n + 1], sl2, -m0));
    s[4 * n + 2] = ex2(fmaf(s[4 * n + 2], sl2, -m1));
    s[4 * n + 3] = ex2(fmaf(s[4 * n + 3], sl2, -m1));
    ps0 += s[4 * n] + s[4 * n + 1];
    ps1 += s[4 * n + 2] + s[4 * n + 3];
  }
  l0 = l0 * c0 + ps0;
  l1 = l1 * c1 + ps1;
}

// P (the softmaxed S, in S's accumulator layout, which is the A operand's:
// two key n-tiles per k-step) as hi + lo bf16 fragments
__device__ __forceinline__ void split_p(const float (&s)[32], uint32_t (&ph)[4][4], uint32_t (&pl)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    split_bf16(s[8 * kk], s[8 * kk + 1], ph[kk][0], pl[kk][0]);
    split_bf16(s[8 * kk + 2], s[8 * kk + 3], ph[kk][1], pl[kk][1]);
    split_bf16(s[8 * kk + 4], s[8 * kk + 5], ph[kk][2], pl[kk][2]);
    split_bf16(s[8 * kk + 6], s[8 * kk + 7], ph[kk][3], pl[kk][3]);
  }
}

// ------------------------------------------------------------ TMA and mbarriers

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// make the barriers' init visible to the async proxy (TMA) before any use
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// one arrival that also announces `bytes` of copies to come
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
// wait until the barrier's phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// the box of `map` at (c0, c1, c2, c3) into shared memory at dst, reported
// to the mbarrier at bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
      "[%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
// `bytes` (a multiple of 16, both addresses 16-byte aligned) from src into
// shared memory at dst, reported to the mbarrier at bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   dst),
               "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}
// the HD / 16 slabs of rows [r0, r0 + rows) of one head as a slab-major tile
template <int HD>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar, int rows, int r0,
                                         int head, int b) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) tma_load(dst + kk * rows * 32, map, bar, 16 * kk, r0, head, b);
}

template <int N>
__device__ __forceinline__ void regs_dec() { asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N)); }
template <int N>
__device__ __forceinline__ void regs_inc() { asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N)); }
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// -------------------------------------------------------------- host: tensor maps

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, from the libcuda the process loaded
// (PyTorch's), so the library links no driver stub
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* h = dlopen("libcuda.so.1", RTLD_LAZY | RTLD_NOLOAD);
    if (h == nullptr) h = dlopen("libcuda.so.1", RTLD_LAZY);
    return h == nullptr ? nullptr : reinterpret_cast<EncodeTiled>(dlsym(h, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// A (batch, seq, heads, width) bf16 tensor at `base` with element strides
// (sb, ss, sh) and inner stride 1 as a 4-D tensor map (width, seq, heads,
// batch) whose box is one 16-column slab of `rows` rows of one head, in
// 32-byte swizzle: a slab of a slab-major tile. Rows past `seq` read as
// zeros. A dim of one element takes a stride the encoder accepts, since it
// is never stepped. False where the encoder refuses.
inline bool slab_map(CUtensorMap* map, const void* base, int width, int seq, int heads, int batch, int64_t sb,
                     int64_t ss, int64_t sh, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const int64_t row_bytes = static_cast<int64_t>(width) * 2;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(width), static_cast<cuuint64_t>(seq > 0 ? seq : 1),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(batch)};
  const int64_t s1 = seq > 1 ? ss * 2 : row_bytes, s2 = heads > 1 ? sh * 2 : row_bytes,
                s3 = batch > 1 ? sb * 2 : row_bytes;
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s1), static_cast<cuuint64_t>(s2),
                                 static_cast<cuuint64_t>(s3)};
  const cuuint32_t box[4] = {16, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// The wide builds at q/k head dim 192 (flash_attention_wide.cu,
// flash_attention_bwd_wide.cu), reached from the C entries of
// flash_attention.cu and flash_attention_bwd.cu. Each returns a cudaError_t.
int flash_fwd_wide_launch(const void* q, const void* k, const void* v, void* o, const int* plan, float* lse,
                          const int64_t* strides, int batch, int sq, int sk, int h, int kv, int hd, int hd_v,
                          float scale, int causal, int window, cudaStream_t stream);
// bytes of shared memory a block of the wide forward at (hd, hd_v) takes; -1 where not built
int flash_fwd_wide_smem(int hd, int hd_v);
