// rmsnorm_bwd: the gradients of K1 rmsnorm and K4 rmsnorm_residual
// (rmsnorm.cu), for training.
//
// Replaces no Pallas kernel: the reference trains through jnp and no Pallas
// kernel of it has a custom_vjp. The port's forward on the card is K1/K4,
// so their gradient is a kernel too. The plain versions are
// kernels/ref.py:rmsnorm_bwd_ref and rmsnorm_residual_bwd_ref (autograd of
// the forwards' plain versions). Per row of d values a (K1: x; K4: the f32
// sum h = x + res) with rstd = 1 / sqrt(mean(a^2) + eps), the incoming
// gradient g of y = a rstd scale, and for K4 the incoming gradient gh of h:
//   da_j   = rstd scale_j g_j - a_j rstd^3 (sum_k g_k scale_k a_k) / d   (+ gh_j for K4)
//   dscale = sum over rows of g_j a_j rstd
// K4 returns da as both dx and dres. x (and res) may be strided views (a row
// stride each, inner stride 1), in f32 or bf16; every sum in f32; dx in x's
// dtype, dscale in f32.
//
// What bounds it: bytes. Each row reads x (and res), g (and gh) and writes
// dx; dscale's per-block partials are a small fraction at model widths
// (qwen3-4b: 2048 rows of 2560 at the seams, 65536 rows of 128 at q-norm).
//
// Design: two launches, no atomics, so a training step repeats bit for bit.
//   1. rms_bwd_rows: a warp a row, rows dealt over a grid of a fixed number
//      of blocks (a function of the shape alone, kernels/rmsnorm.py:
//      bwd_plan). A pass over the row sums a^2 and g scale a (lane-strided,
//      then the xor tree), a second pass writes da and adds g a rstd into
//      the warp's own row of dscale partials in shared memory. At the end
//      the block sums its warps' partials in warp order into its row of
//      the scratch `part`.
//   2. rms_bwd_scale: a thread a column sums `part` over the blocks in
//      order.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

struct RmsBwdArgs {
  const void* x;
  int64_t x_stride;
  const void* res;  // K4: the residual, or null
  int64_t res_stride;
  const void* g;    // incoming gradient of y, packed rows
  const void* gh;   // K4: incoming gradient of h, packed rows, or null
  const float* scale;
  void* dx;         // packed rows
  float* part;      // (blocks, d) dscale partials
  float* dscale;    // (d,)
  int64_t rows;
  int d, warps;
  float eps;
};

template <typename T>
__device__ __forceinline__ float row_value(const RmsBwdArgs& a, int64_t r, int j) {
  float v = rt::load_f32(static_cast<const T*>(a.x) + r * a.x_stride + j);
  if (a.res) v = __fadd_rn(v, rt::load_f32(static_cast<const T*>(a.res) + r * a.res_stride + j));
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) rms_bwd_rows(RmsBwdArgs a) {
  extern __shared__ float acc[];  // [warps][d]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, d = a.d;
  if (warp < a.warps) {
    float* mine = acc + warp * d;
    for (int j = lane; j < d; j += 32) mine[j] = 0.0f;
    const int64_t step = static_cast<int64_t>(gridDim.x) * a.warps;
    for (int64_t r = static_cast<int64_t>(blockIdx.x) * a.warps + warp; r < a.rows; r += step) {
      const T* gr = static_cast<const T*>(a.g) + r * d;
      float sumsq = 0.0f, dot = 0.0f;
      for (int j = lane; j < d; j += 32) {
        const float v = row_value<T>(a, r, j);
        sumsq = fmaf(v, v, sumsq);
        dot = fmaf(rt::load_f32(gr + j) * a.scale[j], v, dot);
      }
      sumsq = rt::warp_sum(sumsq);
      dot = rt::warp_sum(dot);
      const float rstd = rt::rms_inv(sumsq, d, a.eps);
      const float c = rstd * rstd * rstd * dot / static_cast<float>(d);
      T* dxr = static_cast<T*>(a.dx) + r * d;
      const T* ghr = a.gh ? static_cast<const T*>(a.gh) + r * d : nullptr;
      for (int j = lane; j < d; j += 32) {
        const float v = row_value<T>(a, r, j), gj = rt::load_f32(gr + j);
        float dv = rstd * a.scale[j] * gj - v * c;
        if (ghr) dv += rt::load_f32(ghr + j);
        rt::store_f32(dxr + j, dv);
        mine[j] = fmaf(gj, v * rstd, mine[j]);
      }
    }
  }
  __syncthreads();
  float* out = a.part + static_cast<int64_t>(blockIdx.x) * d;
  for (int j = threadIdx.x; j < d; j += kThreads) {
    float s = 0.0f;
    for (int w = 0; w < a.warps; ++w) s += acc[w * d + j];
    out[j] = s;
  }
}

__global__ void __launch_bounds__(kThreads) rms_bwd_scale(RmsBwdArgs a, int blocks) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= a.d) return;
  float s = 0.0f;
  for (int b = 0; b < blocks; ++b) s += a.part[static_cast<int64_t>(b) * a.d + j];
  a.dscale[j] = s;
}

template <typename T>
int launch(const RmsBwdArgs& a, int blocks, cudaStream_t st) {
  const int smem = static_cast<int>(sizeof(float)) * a.warps * a.d;
  cudaError_t e = cudaFuncSetAttribute(rms_bwd_rows<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  rms_bwd_rows<T><<<blocks, kThreads, smem, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  rms_bwd_scale<<<(a.d + kThreads - 1) / kThreads, kThreads, 0, st>>>(a, blocks);
  return cudaGetLastError();
}

}  // namespace

// x (and res, K4, else null) rows of d values with their row strides, f32
// (is_bf16 = 0) or bf16; g (and gh, K4, else null) packed rows of x's dtype;
// scale (d,) f32; dx packed rows of x's dtype; part (blocks, d) f32 scratch;
// dscale (d,) f32. `warps` warps of a block of 256 threads take rows (at
// most 8; warps d floats of shared memory a block), `blocks` blocks: the
// plan of kernels/rmsnorm.py:bwd_plan.
extern "C" int rt_rmsnorm_bwd(const void* x, int64_t x_stride, const void* res, int64_t res_stride,
                              const void* g, const void* gh, const float* scale, void* dx, float* part,
                              float* dscale, int64_t rows, int d, float eps, int warps, int blocks,
                              int is_bf16, void* stream) {
  if (d < 1 || warps < 1 || warps > kThreads / 32 || blocks < 1) return cudaErrorInvalidValue;
  const RmsBwdArgs a{x, x_stride, res, res_stride, g, gh, scale, dx, part, dscale, rows, d, warps, eps};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(a, blocks, st) : launch<float>(a, blocks, st);
}
