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
// K3's norm is K1's code and K1's plan). Inputs are float32 (the stream
// path, where that contract holds) or bfloat16; as in the Pallas kernels,
// the stages and the norm run in f32 and the result is rounded to x's
// dtype once, at the end.
#include "common.cuh"

namespace {

template <typename T>
__global__ void map_chain_kernel(const T* __restrict__ x, int64_t stride, T* __restrict__ y,
                                 int64_t rows, int d, rt::Stages st) {
  const int64_t n = rows * d;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += step) {
    const int64_t r = i / d;
    const int64_t c = i - r * d;
    rt::store_f32(y + i, rt::apply_stages(rt::load_f32(x + r * stride + c), st));
  }
}

template <typename T>
cudaError_t launch_map_chain(const void* x, int64_t stride, void* y, int64_t rows, int d,
                             const rt::Stages& st, cudaStream_t stream) {
  const int64_t n = rows * d;
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond ~32 blocks per SM
  map_chain_kernel<T><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      static_cast<const T*>(x), stride, static_cast<T*>(y), rows, d, st);
  return cudaGetLastError();
}

}  // namespace

extern "C" int rt_map_chain(const void* x, int64_t stride, void* y, int64_t rows, int d,
                            const float* stage_scale, const float* stage_offset, int n_stages,
                            int is_bf16, void* stream) {
  if (n_stages < 0 || n_stages > rt::kMaxStages) return cudaErrorInvalidValue;
  if (rows * d == 0) return cudaSuccess;
  const rt::Stages st = rt::make_stages(stage_scale, stage_offset, n_stages);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_map_chain<__nv_bfloat16>(x, stride, y, rows, d, st, s)
                 : launch_map_chain<float>(x, stride, y, rows, d, st, s);
}

// plan: K1's (kernels/rmsnorm.py:row_plan), as (route, threads, chunks, vec)
extern "C" int rt_affine_rmsnorm(const void* x, int64_t stride, const float* scale, void* y,
                                 int64_t rows, int d, float eps, const float* stage_scale,
                                 const float* stage_offset, int n_stages, int is_bf16, int route,
                                 int threads, int chunks, int vec, void* stream) {
  if (n_stages < 0 || n_stages > rt::kMaxStages) return cudaErrorInvalidValue;
  const rt::Stages st = rt::make_stages(stage_scale, stage_offset, n_stages);
  const rt::RowPlan plan{route, threads, chunks, vec};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return rt::launch_rms_rows<__nv_bfloat16, true>(
        static_cast<const __nv_bfloat16*>(x), stride, scale, static_cast<__nv_bfloat16*>(y),
        rows, d, eps, st, plan, s);
  }
  return rt::launch_rms_rows<float, true>(static_cast<const float*>(x), stride, scale,
                                          static_cast<float*>(y), rows, d, eps, st, plan, s);
}
