// K2 map_chain and K3 affine_rmsnorm: the multi-op kernels of fused
// segment chains (senml_parse* -> senml_parse | rmsnorm).
//
// Replace the Pallas kernels repro/kernels/fused.py:map_chain (pallas_call
// at :78) and :affine_rmsnorm (pallas_call at :103). Both read each
// element once and write it once: the memory rate bounds them, and at the
// (B, 5) shapes of the stream path, launch latency. Fusion saves the
// intermediate streams' round trips through device memory. Contract:
// bitwise equal to the unfused op-by-op path on the same card, which the
// explicit _rn intrinsics in common.cuh guarantee (no FMA contraction,
// K3's norm is K1's code).
#include "common.cuh"

namespace {

__global__ void map_chain_kernel(const float* __restrict__ x, int64_t stride,
                                 float* __restrict__ y, int64_t rows, int d, rt::Stages st) {
  const int64_t n = rows * d;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += step) {
    const int64_t r = i / d;
    const int64_t c = i - r * d;
    y[i] = rt::apply_stages(x[r * stride + c], st);
  }
}

}  // namespace

extern "C" int rt_map_chain(const float* x, int64_t stride, float* y, int64_t rows, int d,
                            const float* stage_scale, const float* stage_offset, int n_stages,
                            void* stream) {
  if (n_stages < 0 || n_stages > rt::kMaxStages) return cudaErrorInvalidValue;
  const int64_t n = rows * d;
  if (n == 0) return cudaSuccess;
  const rt::Stages st = rt::make_stages(stage_scale, stage_offset, n_stages);
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond ~32 blocks per SM
  map_chain_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(x, stride, y, rows, d, st);
  return cudaGetLastError();
}

extern "C" int rt_affine_rmsnorm(const float* x, int64_t stride, const float* scale, float* y,
                                 int64_t rows, int d, float eps, const float* stage_scale,
                                 const float* stage_offset, int n_stages, void* stream) {
  if (n_stages < 0 || n_stages > rt::kMaxStages) return cudaErrorInvalidValue;
  const rt::Stages st = rt::make_stages(stage_scale, stage_offset, n_stages);
  return rt::launch_rms_rows<float, true>(x, stride, scale, y, rows, d, eps, st,
                                          static_cast<cudaStream_t>(stream));
}
