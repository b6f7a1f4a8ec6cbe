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
//
// Three routes, chosen by the host's plan (kernels/rmsnorm.py:row_plan),
// which passes them as a RowPlan:
//   * narrow rows (d <= kNarrowD, the stream path's (B, 5) event batches):
//     one thread per row (rms_rows_narrow);
//   * rows that fit the registers of at most kMaxRowThreads threads,
//     kMaxRowChunks 16-byte chunks each (rms_rows_regs): a group of
//     `threads` threads per row (a power of two) loads the row as raw
//     16-byte chunks, chunk t + c * threads in thread t, every load issued
//     before the first is used; it sums the squares, then a fixed tree
//     across the group; the second pass recomputes the values from the
//     chunks it holds, so each element is read once and written once. Up
//     to a warp per row, several rows share a warp and nothing waits at a
//     barrier;
//   * wider rows (rms_rows_wide): one block per row, two passes.
// Which thread sums which element, and in which order, depends on (d,
// plan) alone. The plan's `vec` picks 16-byte loads and stores where the
// rows allow them, or one element at a time: the same values in the same
// order, so K3 on a caller's unaligned view is bitwise K1 on K2's packed
// output.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

constexpr int kMaxStages = 16;  // longest senml_parse chain one launch takes
constexpr int kNarrowD = 8;     // rows up to this width: one thread per row
constexpr int kRowThreads = 256;
constexpr int kMaxRowThreads = 512;  // threads per row of the register route (rmsnorm.py)
constexpr int kMaxRowChunks = 4;     // 16-byte chunks a thread of the register route holds

// (scale, offset) stages, passed by value as a kernel argument.
struct Stages {
  int n;
  float scale[kMaxStages];
  float offset[kMaxStages];
};

// The host's plan (kernels/rmsnorm.py:row_plan): route 0 narrow, 1
// registers, 2 two-pass; for route 1 the threads per row, the 16-byte
// chunks each holds, and whether rows are read and written 16 bytes at a
// time (vec) or one element at a time.
struct RowPlan {
  int route;
  int threads;
  int chunks;
  int vec;
};
constexpr int kRouteNarrow = 0, kRouteRegs = 1, kRouteTwoPass = 2;

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

// -- the register route ---------------------------------------------------------

// values of T in one 16-byte chunk
template <typename T>
struct Chunk {
  static constexpr int kN = 16 / sizeof(T);
};

__device__ __forceinline__ void unpack(const uint4& u, float (&v)[4]) {
  v[0] = __uint_as_float(u.x);
  v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z);
  v[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&v)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);              // low bf16: exact in f32
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);  // high bf16
  }
}
__device__ __forceinline__ uint4 pack(const float (&v)[4]) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                    __float_as_uint(v[3]));
}
__device__ __forceinline__ uint32_t pack2_bf16(float lo, float hi) {
  const __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);  // each rounded to nearest
  return *reinterpret_cast<const uint32_t*>(&b);
}
__device__ __forceinline__ uint4 pack(const float (&v)[8]) {
  return make_uint4(pack2_bf16(v[0], v[1]), pack2_bf16(v[2], v[3]), pack2_bf16(v[4], v[5]),
                    pack2_bf16(v[6], v[7]));
}

// The first n (<= N) values at p as the 16 bytes one vector load gives
// (zero bits past n): that load where `vec` and the chunk is whole, else
// one load per value.
template <typename T>
__device__ __forceinline__ uint4 load_raw(const T* p, int n, bool vec) {
  constexpr int N = Chunk<T>::kN;
  if (vec && n == N) return __ldg(reinterpret_cast<const uint4*>(p));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < N; ++e) {
    if (e < n) {
      if constexpr (sizeof(T) == 4) {
        w[e] = __float_as_uint(__ldg(reinterpret_cast<const float*>(p) + e));
      } else {
        const uint32_t h = __ldg(reinterpret_cast<const unsigned short*>(p) + e);
        w[e / 2] |= h << (16 * (e % 2));
      }
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename T, int N>
__device__ __forceinline__ void store_chunk(T* p, int n, bool vec, const float (&v)[N]) {
  if (vec && n == N) {
    *reinterpret_cast<uint4*>(p) = pack(v);
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e)
      if (e < n) store_f32(p + e, v[e]);
  }
}

// f32 gains of one chunk: N floats, 16 bytes at a time where `vec`
template <int N>
__device__ __forceinline__ void load_scale(const float* p, int n, bool vec, float (&g)[N]) {
  if (vec && n == N) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      float q[4];
      unpack(__ldg(reinterpret_cast<const uint4*>(p) + i), q);
#pragma unroll
      for (int e = 0; e < 4; ++e) g[4 * i + e] = q[e];
    }
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) g[e] = e < n ? __ldg(p + e) : 0.0f;
  }
}

// A chunk's values as the norm sees them, from its raw bits (and res's):
// x in f32, the stages applied (kAffine), res added in f32 (kResidual).
// Both passes run this on the same bits, so both see the same values.
template <typename T, bool kAffine, bool kResidual>
__device__ __forceinline__ void chunk_values(const uint4& xr, const uint4& rr, const Stages& st,
                                             float (&v)[Chunk<T>::kN]) {
  constexpr int N = Chunk<T>::kN;
  unpack(xr, v);
  if (kAffine) {
#pragma unroll
    for (int e = 0; e < N; ++e) v[e] = apply_stages(v[e], st);
  }
  if (kResidual) {
    float b[N];
    unpack(rr, b);
#pragma unroll
    for (int e = 0; e < N; ++e) v[e] = __fadd_rn(v[e], b[e]);
  }
}

// A group of p.threads threads per row (a power of two, at most
// kMaxRowThreads); blocks of max(kRowThreads, p.threads) threads, so a
// block holds kRowThreads / p.threads rows when that is more than one.
// Thread t of a group holds chunks t, t + threads, ..., KC (= p.chunks) of
// them, as the raw 16 bytes it loaded (x's, and res's for kResidual): all
// its loads are issued before the first is used, and the second pass
// recomputes the values from those bits. Its partial sum runs over its
// chunks in order and over each chunk's values in order; the group's
// partials go through a fixed xor tree inside each warp and, beyond a
// warp, through shared memory into the same tree over the warps' sums,
// which every warp of the row computes alike. One barrier per block for
// groups wider than a warp, none up to a warp.
template <typename T, bool kAffine, bool kResidual, int KC>
__global__ void __launch_bounds__(kMaxRowThreads) rms_rows_regs(
    const T* __restrict__ x, int64_t stride, const float* __restrict__ scale,
    T* __restrict__ y, int64_t rows, int d, float eps, Stages st, Residual rs, RowPlan p) {
  constexpr int N = Chunk<T>::kN;
  __shared__ float warp_part[kMaxRowThreads / 32];
  const int tpr = p.threads;
  const int t = threadIdx.x & (tpr - 1);
  const int64_t r = static_cast<int64_t>(blockIdx.x) * (blockDim.x / tpr) + threadIdx.x / tpr;
  const int64_t rc = r < rows ? r : 0;  // a group past the last row still joins the shuffles
  const bool live = r < rows;
  const bool vec = p.vec != 0;
  const T* xr = x + rc * stride;
  const T* rr = kResidual ? static_cast<const T*>(rs.res) + rc * rs.res_stride : nullptr;
  T* ar = kResidual ? static_cast<T*>(rs.added) + rc * d : nullptr;
  T* yr = y + rc * d;

  // up to two chunks a thread (head-dim rows, where a launch is a few
  // waves and its latency shows) the gains are read with x, not after the sum
  constexpr bool kEarlyScale = KC <= 2;
  int n[KC];
  uint4 xb[KC], rb[KC];
  float g[kEarlyScale ? KC : 1][N];
#pragma unroll
  for (int c = 0; c < KC; ++c) {
    const int j0 = (t + c * tpr) * N;
    n[c] = live ? max(0, min(N, d - j0)) : 0;
    xb[c] = rb[c] = make_uint4(0u, 0u, 0u, 0u);
    if (n[c] > 0) {
      xb[c] = load_raw(xr + j0, n[c], vec);
      if (kResidual) rb[c] = load_raw(rr + j0, n[c], vec);
      if constexpr (kEarlyScale) load_scale<N>(scale + j0, n[c], vec, g[c]);
    }
  }
  float sumsq = 0.0f;
#pragma unroll
  for (int c = 0; c < KC; ++c) {
    if (n[c] > 0) {
      float v[N];
      chunk_values<T, kAffine, kResidual>(xb[c], rb[c], st, v);
      if (kResidual) store_chunk<T, N>(ar + (t + c * tpr) * N, n[c], vec, v);
#pragma unroll
      for (int e = 0; e < N; ++e)
        if (e < n[c]) sumsq = __fadd_rn(sumsq, __fmul_rn(v[e], v[e]));
    }
  }
  for (int o = min(tpr, 32) / 2; o > 0; o >>= 1)
    sumsq = __fadd_rn(sumsq, __shfl_xor_sync(0xffffffffu, sumsq, o));
  if (tpr > 32) {  // uniform in the block
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wpr = tpr >> 5;
    if (lane == 0) warp_part[warp] = sumsq;
    __syncthreads();
    sumsq = warp_sum(lane < wpr ? warp_part[warp / wpr * wpr + lane] : 0.0f);
  }
  const float inv = rms_inv(sumsq, d, eps);

#pragma unroll
  for (int c = 0; c < KC; ++c) {
    if (n[c] > 0) {
      const int j0 = (t + c * tpr) * N;
      float v[N], gl[N], o[N];
      chunk_values<T, kAffine, kResidual>(xb[c], rb[c], st, v);
      if constexpr (kEarlyScale) {
#pragma unroll
        for (int e = 0; e < N; ++e) gl[e] = g[c][e];
      } else {
        load_scale<N>(scale + j0, n[c], vec, gl);
      }
#pragma unroll
      for (int e = 0; e < N; ++e) o[e] = __fmul_rn(__fmul_rn(v[e], inv), gl[e]);
      store_chunk<T, N>(yr + j0, n[c], vec, o);
    }
  }
}

// Rows too wide for the register route: one block of kRowThreads per row.
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

// Whether `p` is a plan the kernels can run for rows of d values of T.
template <typename T>
inline bool plan_fits(const RowPlan& p, int d) {
  constexpr int N = Chunk<T>::kN;
  switch (p.route) {
    case kRouteNarrow: return d <= kNarrowD;
    case kRouteRegs:
      return p.threads >= 1 && p.threads <= kMaxRowThreads && (p.threads & (p.threads - 1)) == 0 &&
             p.chunks >= 1 && p.chunks <= kMaxRowChunks &&
             static_cast<int64_t>(p.threads) * p.chunks * N >= d;
    case kRouteTwoPass: return true;
    default: return false;
  }
}

template <typename T, bool kAffine, bool kResidual, int KC>
void launch_regs(const T* x, int64_t stride, const float* scale, T* y, int64_t rows, int d,
                 float eps, const Stages& st, const RowPlan& p, cudaStream_t stream,
                 const Residual& rs) {
  if constexpr (KC > 1) {
    if (p.chunks < KC) {
      launch_regs<T, kAffine, kResidual, KC - 1>(x, stride, scale, y, rows, d, eps, st, p, stream, rs);
      return;
    }
  }
  const int threads = p.threads > kRowThreads ? p.threads : kRowThreads;
  const int per_block = threads / p.threads;
  const int64_t blocks = (rows + per_block - 1) / per_block;
  rms_rows_regs<T, kAffine, kResidual, KC><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      x, stride, scale, y, rows, d, eps, st, rs, p);
}

template <typename T, bool kAffine, bool kResidual = false>
cudaError_t launch_rms_rows(const T* x, int64_t stride, const float* scale, T* y,
                            int64_t rows, int d, float eps, const Stages& st, const RowPlan& p,
                            cudaStream_t stream, Residual rs = Residual{nullptr, 0, nullptr}) {
  if (!plan_fits<T>(p, d)) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  if (p.route == kRouteNarrow) {
    const int64_t blocks = (rows + kRowThreads - 1) / kRowThreads;
    rms_rows_narrow<T, kAffine, kResidual>
        <<<static_cast<unsigned>(blocks), kRowThreads, 0, stream>>>(
            x, stride, scale, y, rows, d, eps, st, rs);
  } else if (p.route == kRouteRegs) {
    launch_regs<T, kAffine, kResidual, kMaxRowChunks>(x, stride, scale, y, rows, d, eps, st, p,
                                                      stream, rs);
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
