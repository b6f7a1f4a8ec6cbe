// Shared device code of the port's row kernels (rmsnorm.cu, fused.cu).
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

// The row norm shared by rmsnorm and affine_rmsnorm. `kAffine` applies the
// stages to each element as it is loaded; the reduction is the same code.
//
// Narrow rows (d <= kNarrowD, the (B, 5) event batches): one thread per
// row, the row held in registers, squares summed in column order.
template <typename T, bool kAffine>
__global__ void rms_rows_narrow(const T* __restrict__ x, int64_t stride,
                                const float* __restrict__ scale, T* __restrict__ y,
                                int64_t rows, int d, float eps, Stages st) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const T* xr = x + r * stride;
  float v[kNarrowD];
  float sumsq = 0.0f;
#pragma unroll
  for (int j = 0; j < kNarrowD; ++j) {
    if (j < d) {
      float a = load_f32(xr + j);
      if (kAffine) a = apply_stages(a, st);
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
template <typename T, bool kAffine>
__global__ void rms_rows_wide(const T* __restrict__ x, int64_t stride,
                              const float* __restrict__ scale, T* __restrict__ y,
                              int64_t rows, int d, float eps, Stages st) {
  __shared__ float warp_sums[kRowThreads / 32];
  __shared__ float row_inv;
  const int64_t r = blockIdx.x;
  const T* xr = x + r * stride;
  T* yr = y + r * d;
  float part = 0.0f;
  for (int j = threadIdx.x; j < d; j += kRowThreads) {
    float a = load_f32(xr + j);
    if (kAffine) a = apply_stages(a, st);
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
    float a = load_f32(xr + j);
    if (kAffine) a = apply_stages(a, st);
    store_f32(yr + j, __fmul_rn(__fmul_rn(a, inv), scale[j]));
  }
}

template <typename T, bool kAffine>
cudaError_t launch_rms_rows(const T* x, int64_t stride, const float* scale, T* y,
                            int64_t rows, int d, float eps, const Stages& st,
                            cudaStream_t stream) {
  if (rows == 0) return cudaSuccess;
  if (d <= kNarrowD) {
    const int64_t blocks = (rows + kRowThreads - 1) / kRowThreads;
    rms_rows_narrow<T, kAffine><<<static_cast<unsigned>(blocks), kRowThreads, 0, stream>>>(
        x, stride, scale, y, rows, d, eps, st);
  } else {
    rms_rows_wide<T, kAffine><<<static_cast<unsigned>(rows), kRowThreads, 0, stream>>>(
        x, stride, scale, y, rows, d, eps, st);
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
