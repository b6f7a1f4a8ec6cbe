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
// What bounds it: bytes. Each row reads x (and res), g (and gh) once and
// writes dx once; dscale's per-block partials are a small fraction at model
// widths (qwen3-4b: 2048 rows of 2560 at the seams, 65536 and 16384 rows of
// 128 at the q- and k-norms).
//
// Design: two launches, no atomics, every sum in an order fixed by the shape
// (the host's plan, kernels/rmsnorm.py:bwd_plan), so a training step repeats
// bit for bit.
//   1. The row pass. On K1's register route (rmsnorm.py:row_plan, up to 256
//      threads a row here: 128 threads of 3 16-byte chunks at 2560 bf16, 16
//      threads of one chunk at 128), rms_bwd_regs: a group of `threads`
//      threads takes a row, each thread loading its chunks of x, res, g and
//      gh at once, 16 bytes at a time where the rows allow it; one fixed
//      tree across the group (shuffles, then shared memory beyond a warp)
//      gives sum a^2 and sum g scale a, and the thread writes its chunks of
//      da from the values it holds: each element is read once. The thread
//      keeps its gains and its columns' dscale partials in registers over
//      the rows its group takes: `iters` rows, row = (block groups + group)
//      + it (blocks groups). At the end the block's groups add their
//      partials in group order into the block's row of the scratch `part`.
//      Rows too wide for that (rms_bwd_rows): a warp a row in two passes,
//      each warp's partials a row of shared memory.
//   2. rms_bwd_scale: a block per 32 columns sums the blocks' partials, each
//      of its 32 x 32 threads a chain over every 32nd block, then a fixed
//      tree over the 32 chains.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;   // the row pass's blocks
constexpr int kSumCols = 32;    // columns a block of the dscale sum takes
constexpr int kSumChains = 32;  // its chains over the blocks' partials

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
  int d, groups, iters;
  float eps;
};

// -- the register route --------------------------------------------------------------

// a chunk's values as the norm saw them: x in f32, res added in f32 (K4)
template <typename T, bool kRes>
__device__ __forceinline__ void chunk_values(const uint4& xb, const uint4& rb, float (&v)[rt::Chunk<T>::kN]) {
  constexpr int N = rt::Chunk<T>::kN;
  rt::unpack(xb, v);
  if (kRes) {
    float r[N];
    rt::unpack(rb, r);
#pragma unroll
    for (int e = 0; e < N; ++e) v[e] = __fadd_rn(v[e], r[e]);
  }
}

template <typename T, bool kRes, int KC>
__global__ void __launch_bounds__(kThreads) rms_bwd_regs(RmsBwdArgs a, rt::RowPlan p) {
  constexpr int N = rt::Chunk<T>::kN;
  extern __shared__ float acc[];                      // [groups][d]: the groups' partials
  __shared__ float red[2][2][kThreads / 32];          // [iteration % 2][sum a^2, dot][warp]
  const int tpr = p.threads, d = a.d;
  const int t = threadIdx.x & (tpr - 1), grp = threadIdx.x / tpr;
  const bool vec = p.vec != 0;
  const T* x = static_cast<const T*>(a.x);
  const T* res = static_cast<const T*>(a.res);
  const T* g = static_cast<const T*>(a.g);
  const T* gh = static_cast<const T*>(a.gh);
  int n[KC];
  float sc[KC][N], ds[KC][N];
#pragma unroll
  for (int c = 0; c < KC; ++c) {
    const int j0 = (t + c * tpr) * N;
    n[c] = max(0, min(N, d - j0));
#pragma unroll
    for (int e = 0; e < N; ++e) sc[c][e] = ds[c][e] = 0.0f;
    if (n[c] > 0) rt::load_scale<N>(a.scale + j0, n[c], vec, sc[c]);
  }
  const int64_t first = static_cast<int64_t>(blockIdx.x) * a.groups + grp;
  const int64_t step = static_cast<int64_t>(gridDim.x) * a.groups;
  for (int it = 0; it < a.iters; ++it) {  // the same count in every thread: the barrier below is uniform
    const int64_t r = first + it * step;
    const bool live = r < a.rows;
    uint4 xb[KC], rb[KC], gb[KC], hb[KC];
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      const int j0 = (t + c * tpr) * N;
      xb[c] = rb[c] = gb[c] = hb[c] = make_uint4(0u, 0u, 0u, 0u);
      if (live && n[c] > 0) {
        xb[c] = rt::load_raw(x + r * a.x_stride + j0, n[c], vec);
        if (kRes) rb[c] = rt::load_raw(res + r * a.res_stride + j0, n[c], vec);
        gb[c] = rt::load_raw(g + r * d + j0, n[c], vec);
        if (gh) hb[c] = rt::load_raw(gh + r * d + j0, n[c], vec);
      }
    }
    // the loads zero-fill past the row, so every value past it adds 0
    float sumsq = 0.0f, dot = 0.0f;
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      float v[N], gv[N];
      chunk_values<T, kRes>(xb[c], rb[c], v);
      rt::unpack(gb[c], gv);
#pragma unroll
      for (int e = 0; e < N; ++e) {
        sumsq = fmaf(v[e], v[e], sumsq);
        dot = fmaf(gv[e] * sc[c][e], v[e], dot);
      }
    }
    for (int o = min(tpr, 32) / 2; o > 0; o >>= 1) {
      sumsq += __shfl_xor_sync(0xffffffffu, sumsq, o);
      dot += __shfl_xor_sync(0xffffffffu, dot, o);
    }
    if (tpr > 32) {  // uniform in the block
      const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, wpr = tpr / 32, w0 = warp / wpr * wpr;
      if (lane == 0) {
        red[it % 2][0][warp] = sumsq;
        red[it % 2][1][warp] = dot;
      }
      __syncthreads();
      sumsq = rt::warp_sum(lane < wpr ? red[it % 2][0][w0 + lane] : 0.0f);
      dot = rt::warp_sum(lane < wpr ? red[it % 2][1][w0 + lane] : 0.0f);
    }
    if (!live) continue;
    const float rstd = rt::rms_inv(sumsq, d, a.eps);
    const float cc = rstd * rstd * rstd * dot / static_cast<float>(d);
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      if (n[c] == 0) continue;
      float v[N], gv[N], hv[N], o[N];
      chunk_values<T, kRes>(xb[c], rb[c], v);
      rt::unpack(gb[c], gv);
      rt::unpack(hb[c], hv);
#pragma unroll
      for (int e = 0; e < N; ++e) {
        o[e] = rstd * sc[c][e] * gv[e] - v[e] * cc + hv[e];
        ds[c][e] = fmaf(gv[e], v[e] * rstd, ds[c][e]);
      }
      rt::store_chunk<T, N>(static_cast<T*>(a.dx) + r * d + (t + c * tpr) * N, n[c], vec, o);
    }
  }
#pragma unroll
  for (int c = 0; c < KC; ++c)
#pragma unroll
    for (int e = 0; e < N; ++e)
      if (e < n[c]) acc[grp * d + (t + c * tpr) * N + e] = ds[c][e];
  __syncthreads();
  float* out = a.part + static_cast<int64_t>(blockIdx.x) * d;
  for (int j = threadIdx.x; j < d; j += kThreads) {
    float s = 0.0f;
    for (int w = 0; w < a.groups; ++w) s += acc[w * d + j];
    out[j] = s;
  }
}

template <typename T, bool kRes, int KC>
void launch_regs(const RmsBwdArgs& a, const rt::RowPlan& p, int blocks, cudaStream_t st) {
  if constexpr (KC > 1) {
    if (p.chunks < KC) {
      launch_regs<T, kRes, KC - 1>(a, p, blocks, st);
      return;
    }
  }
  const int smem = static_cast<int>(sizeof(float)) * a.groups * a.d;
  rms_bwd_regs<T, kRes, KC><<<blocks, kThreads, smem, st>>>(a, p);
}

// -- rows too wide for the register route ----------------------------------------------

template <typename T>
__device__ __forceinline__ float row_value(const RmsBwdArgs& a, int64_t r, int j) {
  float v = rt::load_f32(static_cast<const T*>(a.x) + r * a.x_stride + j);
  if (a.res) v = __fadd_rn(v, rt::load_f32(static_cast<const T*>(a.res) + r * a.res_stride + j));
  return v;
}

// a warp a row (a.groups warps a block): a pass sums a^2 and g scale a
// (lane-strided, then the xor tree), a second writes da and adds g a rstd
// into the warp's own row of partials
template <typename T>
__global__ void __launch_bounds__(kThreads) rms_bwd_rows(RmsBwdArgs a) {
  extern __shared__ float acc[];  // [warps][d]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, d = a.d;
  if (warp < a.groups) {
    float* mine = acc + warp * d;
    for (int j = lane; j < d; j += 32) mine[j] = 0.0f;
    const int64_t step = static_cast<int64_t>(gridDim.x) * a.groups;
    for (int64_t r = static_cast<int64_t>(blockIdx.x) * a.groups + warp; r < a.rows; r += step) {
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
    for (int w = 0; w < a.groups; ++w) s += acc[w * d + j];
    out[j] = s;
  }
}

// -- the dscale sum ----------------------------------------------------------------------

__global__ void __launch_bounds__(kSumCols * kSumChains) rms_bwd_scale(const float* part, float* dscale, int d,
                                                                      int blocks) {
  __shared__ float s[kSumChains][kSumCols + 1];
  const int tx = threadIdx.x % kSumCols, ty = threadIdx.x / kSumCols;
  const int j = blockIdx.x * kSumCols + tx;
  float v = 0.0f;
  if (j < d)
    for (int b = ty; b < blocks; b += kSumChains) v += part[static_cast<int64_t>(b) * d + j];
  s[ty][tx] = v;
  __syncthreads();
#pragma unroll
  for (int o = kSumChains / 2; o > 0; o >>= 1) {
    if (ty < o) s[ty][tx] += s[ty + o][tx];
    __syncthreads();
  }
  if (ty == 0 && j < d) dscale[j] = s[0][tx];
}

template <typename T>
int launch(const RmsBwdArgs& a, const rt::RowPlan& p, int blocks, cudaStream_t st) {
  if (p.route == rt::kRouteRegs) {
    if (!rt::plan_fits<T>(p, a.d) || p.threads > kThreads || a.groups * p.threads != kThreads)
      return cudaErrorInvalidValue;
    if (a.res) {
      launch_regs<T, true, rt::kMaxRowChunks>(a, p, blocks, st);
    } else {
      launch_regs<T, false, rt::kMaxRowChunks>(a, p, blocks, st);
    }
  } else {
    if (a.groups > kThreads / 32) return cudaErrorInvalidValue;
    const int smem = static_cast<int>(sizeof(float)) * a.groups * a.d;
    cudaError_t e = cudaFuncSetAttribute(rms_bwd_rows<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    rms_bwd_rows<T><<<blocks, kThreads, smem, st>>>(a);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  rms_bwd_scale<<<(a.d + kSumCols - 1) / kSumCols, kSumCols * kSumChains, 0, st>>>(a.part, a.dscale, a.d,
                                                                                   blocks);
  return cudaGetLastError();
}

}  // namespace

// x (and res, K4, else null) rows of d values with their row strides, f32
// (is_bf16 = 0) or bf16; g (and gh, K4, else null) packed rows of x's dtype;
// scale (d,) f32; dx packed rows of x's dtype; part (blocks, d) f32 scratch;
// dscale (d,) f32. The plan of kernels/rmsnorm.py:bwd_plan: the row route
// (route 1, registers: `threads` a row of `chunks` 16-byte chunks each, vec
// for 16-byte loads and stores; route 2: a warp a row), `groups` rows a
// block takes at once (256 / threads, or warps), `blocks` blocks, `iters`
// rows a group (blocks groups iters >= rows).
extern "C" int rt_rmsnorm_bwd(const void* x, int64_t x_stride, const void* res, int64_t res_stride,
                              const void* g, const void* gh, const float* scale, void* dx, float* part,
                              float* dscale, int64_t rows, int d, float eps, int route, int threads,
                              int chunks, int vec, int groups, int blocks, int iters, int is_bf16,
                              void* stream) {
  if (d < 1 || groups < 1 || blocks < 1 || static_cast<int64_t>(blocks) * groups * iters < rows)
    return cudaErrorInvalidValue;
  const RmsBwdArgs a{x, x_stride, res, res_stride, g, gh, scale, dx, part, dscale, rows, d, groups, iters, eps};
  const rt::RowPlan p{route, threads, chunks, vec};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(a, p, blocks, st) : launch<float>(a, p, blocks, st);
}
