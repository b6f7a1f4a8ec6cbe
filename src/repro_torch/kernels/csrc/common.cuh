// Shared device code of the port's row kernels (rmsnorm.cu, fused.cu).
//
// One template serves K1 rmsnorm, K3 affine_rmsnorm and K4
// rmsnorm_residual: `kAffine` applies the stages as an element is loaded,
// `kResidual` adds a second input (in f32) and writes the sum to a second
// output. The reduction is the same code in every instantiation.
//
// Every float operation is an explicit round-to-nearest intrinsic
// (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn): nvcc may not contract a
// product and a sum into an FMA, so
//   * map_chain's stages round exactly as PyTorch's eager `x * s + o`
//     (two kernels, two roundings), and
//   * affine_rmsnorm runs the very same norm code as rmsnorm after the
//     same stages, so the fused path is bitwise equal to the unfused one.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

constexpr int kMaxStages = 16;  // longest senml_parse chain one launch takes
constexpr int kNarrowD = 8;     // rows up to this width: one thread per row
constexpr int kRowThreads = 256;

// (scale, offset) stages, passed by value as a kernel argument.
struct Stages {
  int n;
  float scale[kMaxStages];
  float offset[kMaxStages];
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// x <- x * s + o for each stage in order, each product and sum rounded.
__device__ __forceinline__ float apply_stages(float v, const Stages& st) {
  for (int s = 0; s < st.n; ++s) v = __fadd_rn(__fmul_rn(v, st.scale[s]), st.offset[s]);
  return v;
}

// 1 / sqrt(sumsq / d + eps), rounded step by step as the plain version.
__device__ __forceinline__ float rms_inv(float sumsq, int d, float eps) {
  const float var = __fdiv_rn(sumsq, static_cast<float>(d));
  return __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Residual rows (kResidual): `res` with its own row stride, and the sum
// x + res written, rounded to T, to `added` (packed rows of d).
struct Residual {
  const void* res;
  int64_t res_stride;
  void* added;
};

// Element j of row r as the norm sees it: the stages applied (kAffine), or
// the residual added in f32 and the rounded sum stored (kResidual).
template <typename T, bool kAffine, bool kResidual>
__device__ __forceinline__ float load_elem(const T* xr, int64_t r, int j, const Stages& st,
                                           const Residual& rs, int d, bool store_added) {
  float a = load_f32(xr + j);
  if (kAffine) a = apply_stages(a, st);
  if (kResidual) {
    a = __fadd_rn(a, load_f32(static_cast<const T*>(rs.res) + r * rs.res_stride + j));
    if (store_added) store_f32(static_cast<T*>(rs.added) + r * d + j, a);
  }
  return a;
}

// The row norm shared by rmsnorm, affine_rmsnorm and rmsnorm_residual.
//
// Narrow rows (d <= kNarrowD, the (B, 5) event batches): one thread per
// row, the row held in registers, squares summed in column order.
template <typename T, bool kAffine, bool kResidual>
__global__ void rms_rows_narrow(const T* __restrict__ x, int64_t stride,
                                const float* __restrict__ scale, T* __restrict__ y,
                                int64_t rows, int d, float eps, Stages st, Residual rs) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const T* xr = x + r * stride;
  float v[kNarrowD];
  float sumsq = 0.0f;
#pragma unroll
  for (int j = 0; j < kNarrowD; ++j) {
    if (j < d) {
      const float a = load_elem<T, kAffine, kResidual>(xr, r, j, st, rs, d, true);
      v[j] = a;
      sumsq = __fadd_rn(sumsq, __fmul_rn(a, a));
    }
  }
  const float inv = rms_inv(sumsq, d, eps);
#pragma unroll
  for (int j = 0; j < kNarrowD; ++j)
    if (j < d) store_f32(y + r * d + j, __fmul_rn(__fmul_rn(v[j], inv), scale[j]));
}

// Wide rows (model widths, up to 18432): one block of kRowThreads per row.
// Each thread sums a strided slice, then a fixed shuffle tree and one warp
// over the per-warp sums reduce the block: the order is the same on every
// run. The second pass re-reads the row (from L2 at these widths).
template <typename T, bool kAffine, bool kResidual>
__global__ void rms_rows_wide(const T* __restrict__ x, int64_t stride,
                              const float* __restrict__ scale, T* __restrict__ y,
                              int64_t rows, int d, float eps, Stages st, Residual rs) {
  __shared__ float warp_sums[kRowThreads / 32];
  __shared__ float row_inv;
  const int64_t r = blockIdx.x;
  const T* xr = x + r * stride;
  T* yr = y + r * d;
  float part = 0.0f;
  for (int j = threadIdx.x; j < d; j += kRowThreads) {
    const float a = load_elem<T, kAffine, kResidual>(xr, r, j, st, rs, d, true);
    part = __fadd_rn(part, __fmul_rn(a, a));
  }
  part = warp_sum(part);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = part;
  __syncthreads();
  if (warp == 0) {
    float s = lane < kRowThreads / 32 ? warp_sums[lane] : 0.0f;
    s = warp_sum(s);
    if (lane == 0) row_inv = rms_inv(s, d, eps);
  }
  __syncthreads();
  const float inv = row_inv;
  for (int j = threadIdx.x; j < d; j += kRowThreads) {
    const float a = load_elem<T, kAffine, kResidual>(xr, r, j, st, rs, d, false);
    store_f32(yr + j, __fmul_rn(__fmul_rn(a, inv), scale[j]));
  }
}

template <typename T, bool kAffine, bool kResidual = false>
cudaError_t launch_rms_rows(const T* x, int64_t stride, const float* scale, T* y,
                            int64_t rows, int d, float eps, const Stages& st,
                            cudaStream_t stream, Residual rs = Residual{nullptr, 0, nullptr}) {
  if (rows == 0) return cudaSuccess;
  if (d <= kNarrowD) {
    const int64_t blocks = (rows + kRowThreads - 1) / kRowThreads;
    rms_rows_narrow<T, kAffine, kResidual>
        <<<static_cast<unsigned>(blocks), kRowThreads, 0, stream>>>(
            x, stride, scale, y, rows, d, eps, st, rs);
  } else {
    rms_rows_wide<T, kAffine, kResidual><<<static_cast<unsigned>(rows), kRowThreads, 0, stream>>>(
        x, stride, scale, y, rows, d, eps, st, rs);
  }
  return cudaGetLastError();
}

inline Stages make_stages(const float* scale, const float* offset, int n) {
  Stages st;
  st.n = n;
  for (int i = 0; i < n && i < kMaxStages; ++i) {
    st.scale[i] = scale[i];
    st.offset[i] = offset[i];
  }
  return st;
}

}  // namespace rt
