// ssd_scan_bwd: the gradient of K7 ssd_scan (ssd.cu), for training.
//
// Replaces no Pallas kernel: the reference trains through jax.grad of its
// ssd_chunked (repro/models/ssm.py:_ssd_chunked_impl, a lax.scan over the
// chunks); the port's forward on the card is K7, so its gradient is a
// kernel too. The plain version is kernels/ref.py:ssd_scan_bwd_ref
// (autograd of ssd_scan_ref). Per (batch b, head h) and chunk c of L
// positions, with cum_i the in-chunk cumsum of dt a_h, e_i = exp(cum_i),
// to_j = exp(cum_L - cum_j) dt_j, H the state before the chunk and G the
// gradient of the state after it:
//   y_i     = sum_{j<=i} W_ij x_j + e_i C_i H,   W_ij = exp(cum_i - cum_j) (C_i.B_j) dt_j
//   h_next  = exp(cum_L) H + sum_j to_j B_j (x) x_j
// so, backwards:
//   G_{c-1} = exp(cum_L) G_c + sum_i e_i C_i (x) dy_i        (the reverse state pass)
//   dx_j    = sum_{i>=j} W_ij dy_i + to_j G^T B_j
//   dC_i    = sum_j dS_ij B_j + e_i H dy_i,   dS_ij = (dy_i.x_j) exp(cum_i - cum_j) dt_j
//   dB_j    = sum_i dS_ij C_i + to_j G x_j
//   dcum    from W (row sums minus column sums of (dy_i.x_j) W_ij), from the
//           carried term and from the state update; ddt_t and da from the
//           reverse cumsum of dcum.
// A ragged last chunk is zero-padded (dt = x = B = C = dy = 0), as the
// forward masks it. dt, a, dy, h0, dh, ddt, da and dh0 are f32.
//
// Two builds, chosen by the inputs' dtype (kernels/ssd.py:bwd_route), as
// K7's forward keeps one a dtype.
//
// f32 (the checks and the f32 training cuts): the SIMT build of the first
// port, five launches, packed inputs, every product an f32 FMA (about
// 4 L^2 (N + P) / 2 + 6 L N P per (batch, chunk, head)), no atomics:
//   1. ssd_bwd_su: a block per (chunk, head, batch) forms the chunk's own
//      state s_c = sum_j to_j B_j (x) x_j, the reverse pass's input
//      u_c = sum_i e_i C_i (x) dy_i and the chunk decay exp(cum_L).
//   2. ssd_bwd_pass: a thread per (batch, head, state element) runs the
//      forward state pass (s_c is replaced by the state before chunk c) and
//      the reverse one (u_c by the gradient of the state after chunk c),
//      and writes dh0; it loads kBatch chunks' values before it stores any,
//      so that a thread has that many loads in flight.
//   3. ssd_bwd_chunk: a block of 512 threads per (chunk, head, batch) with
//      x, dy, B and C of the chunk in shared memory. The state terms first
//      (G and H in shared memory), then W and dS in tiles of kTile rows; a
//      warp owns rows j = warp + 16 r of dx and dB in registers; dC's rows
//      go to a per-head partial in device memory. dt and a's per-chunk
//      partials come from one reverse cumsum of dcum.
//   4. ssd_bwd_heads: dB and dC, the per-head partials summed in head order.
//   5. ssd_bwd_da: da, the per-chunk partials summed in (batch, chunk) order.
//
// bf16 (the training path's): mma.sync m16n8k16 with ldmatrix fragments
// (mma.cuh), bf16 inputs as one term and every f32 operand (dy, G, H, W,
// dS, D) as hi + lo bf16 terms (split2; dy . H and W^T . dy, both operands
// f32, as hi.hi + hi.lo + lo.hi). B and C are shared by the heads, so the
// in-chunk terms of dB and dC sum over the heads before their products:
// with D = sum_h dS^h (dS^h_ij = (dy^h_i . x^h_j) exp(cum^h_i - cum^h_j)
// dt^h_j for j <= i),
//   dC_i = sum_j D_ij B_j + sum_h e^h_i (H^h dy^h_i)
//   dB_j = sum_i D_ij C_i + sum_h to^h_j (G^h x^h_j)
// so D.B and D^T.C run once per block of heads, not once per head, and the
// partials are (B, groups, S, N), summed in group order. The carried and
// state-update terms of dcum reuse those products: C_i . (H dy_i) and
// x_j . (G^T B_j). Four launches:
//   A ssd_bwd_states, a block per (chunk, head, batch): s_c = B^T (to x)
//     and u_c = C^T (e dy) on the tensor cores (N x L . L x P each), and
//     exp(cum_L); it also writes dy as hi + lo bf16 planes of the padded
//     chunk (lp x pp), which C copies 16 bytes at a time.
//   B ssd_bwd_passes, a thread per (batch, head, padded state
//     element): the forward pass (H, the state before each chunk) and the
//     reverse one (G, the gradient of the state after it) in f32, each
//     written as hi + lo bf16 planes (N x P) for C; dh0.
//   C ssd_bwd_chunk_mma, a block of 8 warps per (chunk, group of heads,
//     batch), the group chosen as the forward's output kernel's
//     (kernels/ssd.py:head_group): the fewest heads whose blocks fill one
//     wave. A warp owns one row block of 16 positions (warps w and w + 4,
//     which share a scheduler, take blocks w and 7 - w: 9 causal tiles a
//     pair). The block forms C.B^T once, over the causal tiles, each warp
//     its own row block's into shared memory in the accumulators' layout.
//     Per head: the state terms (B G, x G^T, dy H^T) into dx's, dB's and
//     dC's accumulators; then per causal tile (rows j, columns i >= j)
//     dy.x^T, W^T and dS^T built in registers from it (each head's decay
//     2^((cum_i - cum_j) log2 e) and dt_j applied to C.B^T), dS^T added to
//     D^T (shared memory, the warp's own tiles), W^T . dy into dx; the row
//     and column sums of (dy.x) W and the row sums of (dy.x) T C.B give
//     dcum and ddt, and one warp's reverse scan of dcum gives ddt and da's
//     partial. The next head's G and H are copied in with 16-byte cp.async
//     under this head's tiles, its x, dy and dt under this head's scan.
//     After the last head, D^T.C and D.B into dB's and dC's accumulators.
//   D ssd_bwd_sums: dB and dC (the group partials in group order, written
//     in B's dtype) and da (the per-chunk partials in (batch, chunk) order)
//     in one launch.
// Inputs are read through their strides (inner stride 1); dx is written in
// bf16, dB and dC in bf16, from the kernels.
//
// No atomics in either build, every sum in an order fixed by the shape:
// a repeat is bitwise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxL = 128;             // longest chunk
constexpr int kMaxNP = 64;             // largest N and P
constexpr int kRows = kMaxL / kWarps;  // rows of dx / dB a warp owns
constexpr int kCols = kMaxNP / 32;     // columns of a row a lane owns
constexpr int kTile = 32;              // rows of W and dS a tile holds
constexpr int kSlab = 32;              // rows ssd_bwd_su stages at once
constexpr int kMaxEl = kMaxNP * kMaxNP / kThreads;  // state elements a thread owns in ssd_bwd_su
constexpr int kBatch = 8;  // chunks the state pass loads at once

// element i of an input in f32 or bf16 (one build for both: the inputs are
// taken to f32 in shared memory as they are loaded)
__device__ __forceinline__ float ld(const void* p, int64_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]) : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Args {
  const void* xh;     // (B, S, nh, P)
  const float* dt;    // (B, S, nh)
  const float* a;     // (nh,)
  const void* bm;     // (B, S, N)
  const void* cm;     // (B, S, N)
  const float* dy;    // (B, S, nh, P)
  const float* dhT;   // (B, nh, N, P) or null
  const float* h0;    // (B, nh, N, P) or null
  float* dx;          // (B, S, nh, P)
  float* ddt;         // (B, S, nh)
  float* da;          // (nh,)
  float* db;          // (B, S, N)
  float* dc;          // (B, S, N)
  float* dh0;         // (B, nh, N, P) or null
  float* hs;          // (B, nh, nc, N, P): s_c, then the state before chunk c
  float* gs;          // (B, nh, nc, N, P): u_c, then the gradient of the state after chunk c
  float* el;          // (B, nh, nc) exp(cum_L)
  float* dbp;         // (B, nh, S, N) per-head partials of dB
  float* dcp;         // (B, nh, S, N) per-head partials of dC
  float* dap;         // (B, nc, nh) per-chunk partials of da
  int b, s, nh, p, n, chunk, nc, bf16;
};

// The in-chunk cumsum of dt a_h (zero past S) and its exponentials, by one thread.
__device__ void chunk_cum(const Args& a, int b, int c, int h, float* cum, float* dtv, float* ecum,
                          float* eto) {
  const int L = a.chunk, t0 = c * L;
  for (int j = threadIdx.x; j < L; j += kThreads)
    dtv[j] = t0 + j < a.s ? a.dt[((int64_t)b * a.s + t0 + j) * a.nh + h] : 0.f;
  __syncthreads();
  if (threadIdx.x == 0) {
    const float ah = a.a[h];
    float acc = 0.f;
    for (int j = 0; j < L; ++j) {
      acc += dtv[j] * ah;
      cum[j] = acc;
    }
  }
  __syncthreads();
  const float cl = cum[L - 1];
  for (int j = threadIdx.x; j < L; j += kThreads) {
    ecum[j] = expf(cum[j]);
    eto[j] = expf(cl - cum[j]);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads) ssd_bwd_su(Args a) {
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int L = a.chunk, N = a.n, P = a.p, t0 = c * L;
  const int NP = N * P, PP = P + 1, NP1 = N + 1;
  extern __shared__ float smem[];
  float* cum = smem;
  float* dtv = cum + L;
  float* ecum = dtv + L;
  float* eto = ecum + L;
  float* bs = eto + L;
  float* cs = bs + kSlab * NP1;
  float* xs = cs + kSlab * NP1;
  float* ys = xs + kSlab * PP;
  chunk_cum(a, b, c, h, cum, dtv, ecum, eto);
  float sacc[kMaxEl], uacc[kMaxEl];
#pragma unroll
  for (int k = 0; k < kMaxEl; ++k) sacc[k] = uacc[k] = 0.f;
  for (int j0 = 0; j0 < L; j0 += kSlab) {
    const int rows = min(kSlab, L - j0);
    for (int e = threadIdx.x; e < rows * P; e += kThreads) {
      const int j = e / P, q = e % P, t = t0 + j0 + j;
      const bool ok = t < a.s;
      const int64_t off = (((int64_t)b * a.s + t) * a.nh + h) * P + q;
      xs[j * PP + q] = ok ? ld(a.xh, off, a.bf16) : 0.f;
      ys[j * PP + q] = ok ? a.dy[off] : 0.f;
    }
    for (int e = threadIdx.x; e < rows * N; e += kThreads) {
      const int j = e / N, m = e % N, t = t0 + j0 + j;
      const bool ok = t < a.s;
      const int64_t off = ((int64_t)b * a.s + t) * N + m;
      bs[j * NP1 + m] = ok ? ld(a.bm, off, a.bf16) : 0.f;
      cs[j * NP1 + m] = ok ? ld(a.cm, off, a.bf16) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kMaxEl; ++k) {
      const int e = threadIdx.x + k * kThreads;
      if (e < NP) {
        const int m = e / P, q = e % P;
        float sv = sacc[k], uv = uacc[k];
        for (int j = 0; j < rows; ++j) {
          const int jj = j0 + j;
          sv += eto[jj] * dtv[jj] * bs[j * NP1 + m] * xs[j * PP + q];
          uv += ecum[jj] * cs[j * NP1 + m] * ys[j * PP + q];
        }
        sacc[k] = sv;
        uacc[k] = uv;
      }
    }
    __syncthreads();
  }
  const int64_t st = (((int64_t)b * a.nh + h) * a.nc + c) * NP;
#pragma unroll
  for (int k = 0; k < kMaxEl; ++k) {
    const int e = threadIdx.x + k * kThreads;
    if (e < NP) {
      a.hs[st + e] = sacc[k];
      a.gs[st + e] = uacc[k];
    }
  }
  if (threadIdx.x == 0) a.el[((int64_t)b * a.nh + h) * a.nc + c] = expf(cum[L - 1]);
}

__global__ void __launch_bounds__(kThreads) ssd_bwd_pass(Args a) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int NP = a.n * a.p;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= NP) return;
  const int64_t bh = (int64_t)b * a.nh + h;
  const float* el = a.el + bh * a.nc;
  // kBatch chunks' values loaded before any is stored: independent loads in flight
  float hv = a.h0 ? a.h0[bh * NP + e] : 0.f;
  for (int c0 = 0; c0 < a.nc; c0 += kBatch) {
    float s[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) s[u] = c0 + u < a.nc ? a.hs[(bh * a.nc + c0 + u) * NP + e] : 0.f;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (c0 + u < a.nc) {
        a.hs[(bh * a.nc + c0 + u) * NP + e] = hv;
        hv = el[c0 + u] * hv + s[u];
      }
    }
  }
  float g = a.dhT ? a.dhT[bh * NP + e] : 0.f;
  for (int c0 = a.nc - 1; c0 >= 0; c0 -= kBatch) {
    float u_[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) u_[u] = c0 - u >= 0 ? a.gs[(bh * a.nc + c0 - u) * NP + e] : 0.f;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (c0 - u >= 0) {
        a.gs[(bh * a.nc + c0 - u) * NP + e] = g;
        g = el[c0 - u] * g + u_[u];
      }
    }
  }
  if (a.dh0) a.dh0[bh * NP + e] = g;
}

__host__ __device__ inline int chunk_work_floats(int L, int n, int p) {
  const int tiles = 3 * kTile * (L + 1), state = 2 * n * (p + 1);
  return tiles > state ? tiles : state;
}

__host__ __device__ inline int chunk_smem_floats(int L, int n, int p) {
  return 2 * L * (p + 1) + 2 * L * (n + 1) + chunk_work_floats(L, n, p) + 7 * L + kThreads;
}

__global__ void __launch_bounds__(kThreads) ssd_bwd_chunk(Args a) {
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int L = a.chunk, N = a.n, P = a.p, S = a.s, t0 = c * L;
  const int PP = P + 1, NP1 = N + 1, LP = L + 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  extern __shared__ float smem[];
  float* xs = smem;
  float* ys = xs + L * PP;
  float* bs = ys + L * PP;
  float* cs = bs + L * NP1;
  float* work = cs + L * NP1;
  float* cum = work + chunk_work_floats(L, N, P);
  float* dtv = cum + L;
  float* ecum = dtv + L;
  float* eto = ecum + L;
  float* dcum = eto + L;
  float* ddt = dcum + L;
  float* zv = ddt + L;
  float* red = zv + L;

  for (int e = tid; e < L * P; e += kThreads) {
    const int j = e / P, q = e % P, t = t0 + j;
    const bool ok = t < S;
    const int64_t off = (((int64_t)b * S + t) * a.nh + h) * P + q;
    xs[j * PP + q] = ok ? ld(a.xh, off, a.bf16) : 0.f;
    ys[j * PP + q] = ok ? a.dy[off] : 0.f;
  }
  for (int e = tid; e < L * N; e += kThreads) {
    const int j = e / N, m = e % N, t = t0 + j;
    const bool ok = t < S;
    const int64_t off = ((int64_t)b * S + t) * N + m;
    bs[j * NP1 + m] = ok ? ld(a.bm, off, a.bf16) : 0.f;
    cs[j * NP1 + m] = ok ? ld(a.cm, off, a.bf16) : 0.f;
  }
  for (int j = tid; j < L; j += kThreads) dcum[j] = ddt[j] = 0.f;
  float* gsm = work;            // G: the gradient of the state after the chunk
  float* hsm = work + N * PP;   // H: the state before it
  const int64_t st = (((int64_t)b * a.nh + h) * a.nc + c) * N * P;
  for (int e = tid; e < N * P; e += kThreads) {
    const int m = e / P, q = e % P;
    gsm[m * PP + q] = a.gs[st + e];
    hsm[m * PP + q] = a.hs[st + e];
  }
  chunk_cum(a, b, c, h, cum, dtv, ecum, eto);  // its barriers also publish the loads above

  // <G, H> for the decay's gradient
  float gh = 0.f;
  for (int e = tid; e < N * P; e += kThreads) {
    const int m = e / P, q = e % P;
    gh += gsm[m * PP + q] * hsm[m * PP + q];
  }
  red[tid] = gh;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (tid < w) red[tid] += red[tid + w];
    __syncthreads();
  }

  float dxa[kRows][kCols], dba[kRows][kCols];
  const int64_t part = ((int64_t)b * a.nh + h) * S;  // row offset of this head's dB/dC partials
  // the state update's terms (G) and the carried term's (H), rows j = warp + 8 r
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int j = warp + kWarps * r;
#pragma unroll
    for (int k = 0; k < kCols; ++k) dxa[r][k] = dba[r][k] = 0.f;
    if (j < L) {
      const float wj = eto[j] * dtv[j];
      float w = 0.f, hy = 0.f;
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        const int q = lane + 32 * k;
        if (q < P) {
          float gb = 0.f, ch = 0.f;
          for (int m = 0; m < N; ++m) {
            gb += bs[j * NP1 + m] * gsm[m * PP + q];
            ch += cs[j * NP1 + m] * hsm[m * PP + q];
          }
          dxa[r][k] = wj * gb;
          w += xs[j * PP + q] * gb;
          hy += ys[j * PP + q] * ch;
        }
      }
      w = warp_sum(w);
      hy = warp_sum(hy);
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        const int m = lane + 32 * k;
        if (m < N) {
          float gx = 0.f, hd = 0.f;
          for (int q = 0; q < P; ++q) {
            gx += gsm[m * PP + q] * xs[j * PP + q];
            hd += hsm[m * PP + q] * ys[j * PP + q];
          }
          dba[r][k] = wj * gx;
          if (t0 + j < S) a.dcp[(part + t0 + j) * N + m] = ecum[j] * hd;
        }
      }
      if (lane == 0) {
        zv[j] = wj * w;
        ddt[j] = eto[j] * w;
        dcum[j] = ecum[j] * hy - wj * w;
      }
    }
  }
  __syncthreads();
  if (tid == 0) {
    float z = 0.f;
    for (int j = 0; j < L; ++j) z += zv[j];
    dcum[L - 1] += z + expf(cum[L - 1]) * red[0];
  }
  __syncthreads();

  // the in-chunk terms, kTile rows of W and dS at a time
  float* wt = work;                // S, then W
  float* dt_ = work + kTile * LP;  // dy.x, then dS
  float* rt = dt_ + kTile * LP;    // (dy.x) W
  for (int i0 = 0; i0 < L; i0 += kTile) {
    for (int e = tid; e < kTile * L; e += kThreads) {
      const int ii = e / L, j = e % L, i = i0 + ii;
      float sv = 0.f, dv = 0.f;
      if (i < L && j <= i) {
        for (int m = 0; m < N; ++m) sv += cs[i * NP1 + m] * bs[j * NP1 + m];
        for (int q = 0; q < P; ++q) dv += ys[i * PP + q] * xs[j * PP + q];
      }
      wt[ii * LP + j] = sv;
      dt_[ii * LP + j] = dv;
    }
    __syncthreads();
    if (tid < L) {
      const int j = tid;
      float col = 0.f, qd = 0.f;
      for (int ii = 0; ii < kTile; ++ii) {
        const int i = i0 + ii;
        float w = 0.f, ds = 0.f, rv = 0.f;
        if (i < L && j <= i) {
          const float tv = expf(cum[i] - cum[j]);
          const float sv = wt[ii * LP + j], dv = dt_[ii * LP + j];
          w = tv * sv * dtv[j];
          ds = dv * tv * dtv[j];
          rv = dv * w;
          qd += dv * tv * sv;
          col += rv;
        }
        wt[ii * LP + j] = w;
        dt_[ii * LP + j] = ds;
        rt[ii * LP + j] = rv;
      }
      ddt[j] += qd;
      dcum[j] -= col;
    }
    __syncthreads();
    for (int ii = warp; ii < kTile; ii += kWarps) {
      const int i = i0 + ii;
      if (i < L) {
        float rs = 0.f;
        for (int j = lane; j <= i; j += 32) rs += rt[ii * LP + j];
        rs = warp_sum(rs);
        if (lane == 0) dcum[i] += rs;
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
          const int m = lane + 32 * k;
          if (m < N && t0 + i < S) {
            float acc = 0.f;
            for (int j = 0; j <= i; ++j) acc += dt_[ii * LP + j] * bs[j * NP1 + m];
            a.dcp[(part + t0 + i) * N + m] += acc;
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int j = warp + kWarps * r;
      if (j < L) {
        for (int ii = 0; ii < kTile; ++ii) {
          const int i = i0 + ii;
          if (i < L && i >= j) {
            const float w = wt[ii * LP + j], ds = dt_[ii * LP + j];
#pragma unroll
            for (int k = 0; k < kCols; ++k) {
              const int q = lane + 32 * k;
              if (q < P) dxa[r][k] += w * ys[i * PP + q];
              if (q < N) dba[r][k] += ds * cs[i * NP1 + q];
            }
          }
        }
      }
    }
    __syncthreads();
  }

  // dla_t = sum_{i >= t} dcum_i: into ddt through a, and into da's partial
  if (tid == 0) {
    const float ah = a.a[h];
    float acc = 0.f, dap = 0.f;
    for (int t = L - 1; t >= 0; --t) {
      acc += dcum[t];
      ddt[t] += ah * acc;
      dap += dtv[t] * acc;
    }
    a.dap[((int64_t)b * a.nc + c) * a.nh + h] = dap;
  }
  __syncthreads();
  for (int j = tid; j < L; j += kThreads)
    if (t0 + j < S) a.ddt[((int64_t)b * S + t0 + j) * a.nh + h] = ddt[j];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int j = warp + kWarps * r;
    if (j < L && t0 + j < S) {
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        const int q = lane + 32 * k;
        if (q < P) a.dx[(((int64_t)b * S + t0 + j) * a.nh + h) * P + q] = dxa[r][k];
        if (q < N) a.dbp[(part + t0 + j) * N + q] = dba[r][k];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) ssd_bwd_heads(Args a) {
  const int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t per_b = (int64_t)a.s * a.n;
  if (e >= (int64_t)a.b * per_b) return;
  const int64_t b = e / per_b, r = e % per_b;
  float sb = 0.f, sc = 0.f;
  for (int h = 0; h < a.nh; ++h) {
    const int64_t i = (b * a.nh + h) * per_b + r;
    sb += a.dbp[i];
    sc += a.dcp[i];
  }
  a.db[e] = sb;
  a.dc[e] = sc;
}

__global__ void __launch_bounds__(kThreads) ssd_bwd_da(Args a) {
  for (int h = threadIdx.x; h < a.nh; h += kThreads) {
    float acc = 0.f;
    for (int64_t i = 0; i < (int64_t)a.b * a.nc; ++i) acc += a.dap[i * a.nh + h];
    a.da[h] = acc;
  }
}

int launch(const Args& a, cudaStream_t st) {
  const int su_bytes = 4 * (4 * a.chunk + 2 * kSlab * (a.n + 1) + 2 * kSlab * (a.p + 1));
  const int chunk_bytes = 4 * chunk_smem_floats(a.chunk, a.n, a.p);
  cudaFuncSetAttribute(ssd_bwd_su, cudaFuncAttributeMaxDynamicSharedMemorySize, su_bytes);
  cudaFuncSetAttribute(ssd_bwd_chunk, cudaFuncAttributeMaxDynamicSharedMemorySize, chunk_bytes);
  const dim3 chunks(a.nc, a.nh, a.b);
  ssd_bwd_su<<<chunks, kThreads, su_bytes, st>>>(a);
  ssd_bwd_pass<<<dim3((a.n * a.p + kThreads - 1) / kThreads, a.nh, a.b), kThreads, 0, st>>>(a);
  ssd_bwd_chunk<<<chunks, kThreads, chunk_bytes, st>>>(a);
  const int64_t el = (int64_t)a.b * a.s * a.n;
  if (el > 0) ssd_bwd_heads<<<(unsigned)((el + kThreads - 1) / kThreads), kThreads, 0, st>>>(a);
  ssd_bwd_da<<<1, kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Bytes of shared memory a block of ssd_bwd_chunk takes (the wrapper checks
// them against the card's limit).
extern "C" int rt_ssd_bwd_smem(int chunk, int n, int p) { return 4 * chunk_smem_floats(chunk, n, p); }

extern "C" int rt_ssd_scan_bwd(const void* xh, const float* dt, const float* a_, const void* bm,
                               const void* cm, const float* dy, const float* dhT, const float* h0,
                               float* dx, float* ddt, float* da, float* db, float* dc, float* dh0,
                               float* hs, float* gs, float* el, float* dbp, float* dcp, float* dap,
                               int b, int s, int nh, int p, int n, int chunk, int is_bf16,
                               void* stream) {
  if (b < 1 || s < 1 || nh < 1 || chunk < 1 || chunk > kMaxL || n < 1 || n > kMaxNP || p < 1 ||
      p > kMaxNP)
    return cudaErrorInvalidValue;
  const Args a{xh, dt, a_, bm, cm, dy, dhT, h0, dx, ddt, da, db, dc, dh0, hs, gs, el, dbp, dcp, dap,
               b, s, nh, p, n, chunk, (s + chunk - 1) / chunk, is_bf16 ? 1 : 0};
  return launch(a, static_cast<cudaStream_t>(stream));
}

// ---------------------------------------------------------------------------
// The bf16 build: tensor cores, D = sum_h dS^h (the header's launches A-D).
// ---------------------------------------------------------------------------

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMmaThreads = 256;  // 8 warps
constexpr int kMmaWarps = kMmaThreads / 32;
constexpr int kPassThreads = 256;
constexpr int kPassBatch = 4;  // chunks whose loads the passes issue together
constexpr int kVecs = 11;      // per-position f32 vectors of launch C
constexpr int kDyPieces = kMaxL * kMaxNP / 8 / kMmaThreads;  // 8-column pieces of dy a thread of A takes
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr int up16(int v) { return (v + 15) / 16 * 16; }
__host__ __device__ constexpr int align16(int bytes) { return (bytes + 15) / 16 * 16; }

// Padded shapes and the shared memory of launches A and C (kernels/ssd.py:
// bwd_smem mirrors it). Tiles are padded to multiples of 16, the padding
// zero; bf16 rows have a stride of 16k + 8 elements (ldmatrix reads 8 rows
// at distinct banks). C.B^T and D^T are kept as the causal 16 x 16 tiles of
// one row block after another, each in the accumulators' layout, a lane's
// 8 floats together (two 16-byte accesses).
struct BwdLayout {
  int lp, np, pp, nb, tiles;
  int ns, xs;  // row strides (bf16): B and C (N wide); x, dy, G and H (P wide)
  int bc_bytes, x_bytes, gh_bytes, t_bytes, vec_bytes;
  // A: B, C, x, dy hi, dy lo, dt, cum, exp(cum), end weights
  int a_c, a_x, a_dyh, a_dyl, a_dt, a_cum, a_ecum, a_wend, a_bytes;
  // C: B, C, C.B^T, D^T, x, dy hi, dy lo, (G hi, G lo, H hi, H lo), kVecs
  // vectors, the column sums of each row block, the reductions
  int c_c, c_cbt, c_dtile, c_x, c_dyh, c_dyl, c_gh, c_vec, c_colp, c_red, c_bytes;

  __host__ __device__ BwdLayout(int l, int n, int p) {
    lp = up16(l);
    np = up16(n);
    pp = up16(p);
    nb = lp / 16;
    tiles = nb * (nb + 1) / 2;
    ns = np + 8;
    xs = pp + 8;
    bc_bytes = align16(lp * ns * 2);
    x_bytes = align16(lp * xs * 2);
    gh_bytes = align16(np * xs * 2);
    t_bytes = tiles * 256 * 4;
    vec_bytes = align16(lp * 4);
    a_c = bc_bytes;
    a_x = 2 * bc_bytes;
    a_dyh = a_x + x_bytes;
    a_dyl = a_dyh + x_bytes;
    a_dt = a_dyl + x_bytes;
    a_cum = a_dt + vec_bytes;
    a_ecum = a_cum + vec_bytes;
    a_wend = a_ecum + vec_bytes;
    a_bytes = a_wend + vec_bytes;
    c_c = bc_bytes;
    c_cbt = 2 * bc_bytes;
    c_dtile = c_cbt + t_bytes;
    c_x = c_dtile + t_bytes;
    c_dyh = c_x + x_bytes;
    c_dyl = c_dyh + x_bytes;
    c_gh = c_dyl + x_bytes;
    c_vec = c_gh + 4 * gh_bytes;
    c_colp = c_vec + kVecs * vec_bytes;
    c_red = c_colp + align16(nb * lp * 4);
    c_bytes = c_red + 16 * 4;
  }
};

struct MmaBwdArgs {
  const bf16* x;     // (B, S, nh, P)
  const float* dt;   // (B, S, nh)
  const float* a;    // (nh,)
  const bf16* bm;    // (B, S, N)
  const bf16* cm;    // (B, S, N)
  const float* dy;   // (B, S, nh, P)
  const float* dhT;  // (B, nh, N, P) or null
  const float* h0;   // (B, nh, N, P) or null
  bf16* dx;          // (B, S, nh, P) packed
  float* ddt;        // (B, S, nh) packed
  float* da;         // (nh,)
  bf16* db;          // (B, S, N) packed
  bf16* dc;          // (B, S, N) packed
  float* dh0;        // (B, nh, N, P) packed, or null
  float* su;         // (B, nc, nh, 2, np, pp): s_c, u_c
  float* el;         // (B, nc, nh): exp(cum_L)
  bf16* dyp;         // (B, nc, nh, 2, lp, pp): dy as hi, lo
  bf16* ghp;         // (B, nc, nh, 4, np, pp): G hi, G lo, H hi, H lo
  float* dbp;        // (B, groups, S, N): the groups' partials of dB
  float* dcp;        // (B, groups, S, N): of dC
  float* dap;        // (B, nc, nh): the chunks' partials of da
  int64_t x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, c_sb, c_ss, dy_sb, dy_ss, dy_sh;
  int64_t h0_sb, h0_sh, h0_sn, dh_sb, dh_sh, dh_sn, a_s;  // element strides; inner stride 1
  int batch, s, nh, p, n, chunk, nc, group, groups;
  int vec;   // x, B and C copied 16 bytes at a time
  int vdy;   // dy read 16 bytes at a time
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(in ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// rows [0, prow) x columns [0, pcol) of a bf16 tile into shared memory (row
// stride ds); source rows past `rows` and columns past `cols` are zero.
// vec: 16-byte cp.async pieces (cols, the source's base and row stride are
// multiples of 8 elements); else plain loads and stores.
__device__ __forceinline__ void stage_bf16(bf16* dst, int ds, const bf16* src, int64_t ss, int rows,
                                           int cols, int prow, int pcol, bool vec) {
  if (vec) {
    const int cpr = pcol / 8;
    for (int e = threadIdx.x; e < prow * cpr; e += kMmaThreads) {
      const int r = e / cpr, c = (e % cpr) * 8;
      const bool in = r < rows && c < cols;
      cp_async16(dst + r * ds + c, in ? src + r * ss + c : src, in);
    }
  } else {
    for (int e = threadIdx.x; e < prow * pcol; e += kMmaThreads) {
      const int r = e / pcol, c = e % pcol;
      dst[r * ds + c] = r < rows && c < cols ? src[r * ss + c] : __float2bfloat16_rn(0.0f);
    }
  }
}

// `planes` packed planes of rows x cols bf16 (cols a multiple of 8) into
// shared memory, row stride ds, a plane every `dplane` elements
__device__ __forceinline__ void stage_planes(bf16* dst, int dplane, int ds, const bf16* src, int rows,
                                             int cols, int planes) {
  const int cpr = cols / 8, per = rows * cpr;
  for (int e = threadIdx.x; e < planes * per; e += kMmaThreads) {
    const int k = e / per, r = (e % per) / cpr, c = (e % cpr) * 8;
    cp_async16(dst + k * dplane + r * ds + c, src + (static_cast<int64_t>(k) * rows + r) * cols + c, true);
  }
}

// dt of one head over the chunk's positions (zero past `rows`)
__device__ __forceinline__ void stage_dt(float* dst, const float* src, int64_t ss, int rows, int lp) {
  for (int t = threadIdx.x; t < lp; t += kMmaThreads) {
    const bool in = t < rows;
    cp_async4(dst + t, in ? src + t * ss : src, in);
  }
}

// cum = inclusive cumsum of dt * a over the padded chunk, by one warp: each
// lane sums a run of consecutive positions, a warp scan gives the offsets
__device__ __forceinline__ void chunk_cum_warp(const float* dts, float decay, int lp, float* cum, int lane) {
  const int per = (lp + 31) / 32;  // at most 4: lp <= 128
  float vals[4];
  float run = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int t = lane * per + k;
    const bool in = k < per && t < lp;
    run += (in ? dts[t] : 0.0f) * decay;
    vals[k] = run;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  float off = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) off = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int t = lane * per + k;
    if (k < per && t < lp) cum[t] = off + vals[k];
  }
  __syncwarp();
}

// 2^x on the special-function unit (flushes subnormal results to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lo16(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi16(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }
__device__ __forceinline__ float2 bf2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float quad_sum(float v) {  // over the 4 lanes of a row (t4)
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// The causal tile (jb, ib), ib >= jb, of nb row blocks: row block jb's tiles
// follow those of the blocks before it
__device__ __forceinline__ int tile_index(int jb, int ib, int nb) { return jb * (2 * nb - jb + 1) / 2 + ib - jb; }
// Where element (row jj, column ii) of a tile sits among its 256 floats
__device__ __forceinline__ int tile_at(int jj, int ii) {
  return ((jj & 7) * 4 + ((ii & 7) >> 1)) * 8 + (ii >> 3) * 4 + (jj >> 3) * 2 + (ii & 1);
}
// The row block of warp w: warps w and w + 4 share a scheduler and take
// blocks w and 7 - w, 9 causal tiles between them at 8 blocks
__device__ __forceinline__ int row_block(int warp) { return warp < 4 ? warp : 11 - warp; }

// Launch A: per (chunk, head, batch), s_c[m][p] = sum_j B[j][m] wend_j x[j][p]
// and u_c[m][p] = sum_i C[i][m] e_i dy[i][p] (the padded N x P, f32) on the
// tensor cores, exp(cum_L), and dy as hi + lo bf16 planes of the padded
// chunk. A = B^T or C^T (exact); the other operand scaled in f32 and split.
__global__ void __launch_bounds__(kMmaThreads) ssd_bwd_states(MmaBwdArgs a) {
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  unsigned char* smem = bwd_smem;
  const BwdLayout lay(a.chunk, a.n, a.p);
  const int c = blockIdx.x, hd = blockIdx.y, b = blockIdx.z;
  const int c0 = c * a.chunk;
  const int rows = min(a.chunk, a.s - c0);
  const int lane = threadIdx.x & 31;
  const int warp = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) >> 5, 0);
  const int g = lane >> 2, t4 = lane & 3;
  bf16* bs = reinterpret_cast<bf16*>(smem);
  bf16* cs = reinterpret_cast<bf16*>(smem + lay.a_c);
  bf16* xs = reinterpret_cast<bf16*>(smem + lay.a_x);
  bf16* dyh = reinterpret_cast<bf16*>(smem + lay.a_dyh);
  bf16* dyl = reinterpret_cast<bf16*>(smem + lay.a_dyl);
  float* dts = reinterpret_cast<float*>(smem + lay.a_dt);
  float* cum = reinterpret_cast<float*>(smem + lay.a_cum);
  float* ecum = reinterpret_cast<float*>(smem + lay.a_ecum);
  float* wend = reinterpret_cast<float*>(smem + lay.a_wend);
  const bool vec = a.vec != 0;
  stage_bf16(bs, lay.ns, a.bm + b * a.b_sb + c0 * a.b_ss, a.b_ss, rows, a.n, lay.lp, lay.np, vec);
  stage_bf16(cs, lay.ns, a.cm + b * a.c_sb + c0 * a.c_ss, a.c_ss, rows, a.n, lay.lp, lay.np, vec);
  stage_bf16(xs, lay.xs, a.x + b * a.x_sb + c0 * a.x_ss + hd * a.x_sh, a.x_ss, rows, a.p, lay.lp, lay.pp,
             vec);
  stage_dt(dts, a.dt + b * a.dt_sb + c0 * a.dt_ss + hd * a.dt_sh, a.dt_ss, rows, lay.lp);
  cp_commit();
  // dy as hi + lo bf16 in eight-column pieces, into shared memory and the planes launch C copies
  const int64_t slot = (static_cast<int64_t>(b) * a.nc + c) * a.nh + hd;
  bf16* planes = a.dyp + slot * 2 * lay.lp * lay.pp;
  const float* dsrc = a.dy + b * a.dy_sb + c0 * a.dy_ss + hd * a.dy_sh;
  const int cpr = lay.pp / 8, pieces = lay.lp * cpr;
  for (int e0 = threadIdx.x; e0 < pieces; e0 += kDyPieces * kMmaThreads) {
    float v[kDyPieces][8];  // every piece's loads issued before the first is split
#pragma unroll
    for (int u = 0; u < kDyPieces; ++u) {
      const int e = e0 + u * kMmaThreads, r = e / cpr, col = (e % cpr) * 8;
      const float* row = dsrc + r * a.dy_ss + col;
      if (e < pieces && r < rows && a.vdy && col + 8 <= a.p) {
        const float4 v0 = ld4(row), v1 = ld4(row + 4);
        v[u][0] = v0.x; v[u][1] = v0.y; v[u][2] = v0.z; v[u][3] = v0.w;
        v[u][4] = v1.x; v[u][5] = v1.y; v[u][6] = v1.z; v[u][7] = v1.w;
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) v[u][k] = e < pieces && r < rows && col + k < a.p ? row[k] : 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < kDyPieces; ++u) {
      const int e = e0 + u * kMmaThreads, r = e / cpr, col = (e % cpr) * 8;
      if (e >= pieces) break;
      uint4 hi, lo;
      split2(v[u][0], v[u][1], hi.x, lo.x);
      split2(v[u][2], v[u][3], hi.y, lo.y);
      split2(v[u][4], v[u][5], hi.z, lo.z);
      split2(v[u][6], v[u][7], hi.w, lo.w);
      *reinterpret_cast<uint4*>(dyh + r * lay.xs + col) = hi;
      *reinterpret_cast<uint4*>(dyl + r * lay.xs + col) = lo;
      *reinterpret_cast<uint4*>(planes + r * lay.pp + col) = hi;
      *reinterpret_cast<uint4*>(planes + (lay.lp + r) * lay.pp + col) = lo;
    }
  }
  cp_wait_all();
  __syncthreads();
  if (warp == 0) {
    chunk_cum_warp(dts, a.a[hd * a.a_s], lay.lp, cum, lane);
    const float last = cum[lay.lp - 1];
    for (int t = lane; t < lay.lp; t += 32) {
      ecum[t] = expf(cum[t]);
      wend[t] = expf(last - cum[t]) * dts[t];
    }
    if (lane == 0) a.el[slot] = expf(last);
  }
  __syncthreads();

  const int mb = lay.np / 16, pt = lay.pp / 8, ngroups = (pt + 3) / 4;
  float* so = a.su + slot * 2 * lay.np * lay.pp;
  float* uo = so + lay.np * lay.pp;
  for (int task = warp; task < mb * ngroups; task += kMmaWarps) {
    const int m0 = (task / ngroups) * 16, tg = (task % ngroups) * 4;
    float sacc[4][4] = {}, uacc[4][4] = {};
    for (int kb = 0; kb < lay.lp; kb += 16) {
      uint32_t bf[4], cf[4];  // A[m][j] = B[j][m], C[j][m]: read transposed
      ldsm4t(bf, bs + (kb + row_b(lane)) * lay.ns + m0 + col_b(lane));
      ldsm4t(cf, cs + (kb + row_b(lane)) * lay.ns + m0 + col_b(lane));
      const int j0 = kb + 2 * t4;
      const float w0 = wend[j0], w1 = wend[j0 + 1], w8 = wend[j0 + 8], w9 = wend[j0 + 9];
      const float e0 = ecum[j0], e1 = ecum[j0 + 1], e8 = ecum[j0 + 8], e9 = ecum[j0 + 9];
#pragma unroll
      for (int nt = 0; nt < 4; nt += 2) {
        if (tg + nt >= pt) break;
        uint32_t xf[4], hf[4], lf[4];  // rows (j0, j0 + 1) and + 8, for two column tiles
        const int off = (kb + row_a(lane)) * lay.xs + (tg + nt) * 8 + col_a(lane);
        ldsm4t(xf, xs + off);
        ldsm4t(hf, dyh + off);
        ldsm4t(lf, dyl + off);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t hi0, lo0, hi1, lo1;
          split2(lo16(xf[2 * h]) * w0, hi16(xf[2 * h]) * w1, hi0, lo0);
          split2(lo16(xf[2 * h + 1]) * w8, hi16(xf[2 * h + 1]) * w9, hi1, lo1);
          mma(sacc[nt + h], bf, hi0, hi1);
          mma(sacc[nt + h], bf, lo0, lo1);
          const uint32_t h0 = hf[2 * h], l0 = lf[2 * h], h1 = hf[2 * h + 1], l1 = lf[2 * h + 1];
          split2((lo16(h0) + lo16(l0)) * e0, (hi16(h0) + hi16(l0)) * e1, hi0, lo0);
          split2((lo16(h1) + lo16(l1)) * e8, (hi16(h1) + hi16(l1)) * e9, hi1, lo1);
          mma(uacc[nt + h], cf, hi0, hi1);
          mma(uacc[nt + h], cf, lo0, lo1);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      if (tg + nt >= pt) break;
      const int pc = (tg + nt) * 8 + 2 * t4;
      const int r0 = (m0 + g) * lay.pp + pc, r1 = r0 + 8 * lay.pp;
      *reinterpret_cast<float2*>(so + r0) = make_float2(sacc[nt][0], sacc[nt][1]);
      *reinterpret_cast<float2*>(so + r1) = make_float2(sacc[nt][2], sacc[nt][3]);
      *reinterpret_cast<float2*>(uo + r0) = make_float2(uacc[nt][0], uacc[nt][1]);
      *reinterpret_cast<float2*>(uo + r1) = make_float2(uacc[nt][2], uacc[nt][3]);
    }
  }
}

// hi + lo bf16 of v: hi = v truncated (exact in f32), lo = the rest rounded
__device__ __forceinline__ void put_split(bf16* hi, bf16* lo, float v) {
  const uint32_t bits = __float_as_uint(v);
  *hi = __ushort_as_bfloat16(static_cast<unsigned short>(bits >> 16));
  *lo = __float2bfloat16_rn(v - __uint_as_float(bits & 0xffff0000u));
}

// Launch B, the only sequential part: per (batch, head) and padded state
// element, H_c (the state before chunk c: H_{c+1} = el_c H_c + s_c from h0)
// and G_c (the gradient of the state after chunk c: G_{c-1} = el_c G_c + u_c
// from dh), both f32 along the chunks, each written as hi + lo bf16; dh0 is
// el_0 G_0 + u_0. Padding elements stay zero.
__global__ void __launch_bounds__(kPassThreads) ssd_bwd_passes(MmaBwdArgs a, int64_t total) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kPassThreads + threadIdx.x;
  if (idx >= total) return;
  const BwdLayout lay(a.chunk, a.n, a.p);
  const int npp = lay.np * lay.pp;
  const int64_t bh = idx / npp;
  const int e = static_cast<int>(idx % npp);
  const int b = static_cast<int>(bh / a.nh), hd = static_cast<int>(bh % a.nh);
  const int m = e / lay.pp, q = e % lay.pp;
  const bool in = m < a.n && q < a.p;
  float hv = in && a.h0 ? a.h0[b * a.h0_sb + hd * a.h0_sh + m * a.h0_sn + q] : 0.0f;
  for (int c = 0; c < a.nc; c += kPassBatch) {
    float sv[kPassBatch], ev[kPassBatch];
#pragma unroll
    for (int u = 0; u < kPassBatch; ++u) {
      if (c + u < a.nc) {
        const int64_t slot = (static_cast<int64_t>(b) * a.nc + c + u) * a.nh + hd;
        sv[u] = a.su[slot * 2 * npp + e];
        ev[u] = a.el[slot];
      }
    }
#pragma unroll
    for (int u = 0; u < kPassBatch; ++u) {
      if (c + u < a.nc) {
        bf16* gh = a.ghp + ((static_cast<int64_t>(b) * a.nc + c + u) * a.nh + hd) * 4 * npp;
        put_split(gh + 2 * npp + e, gh + 3 * npp + e, hv);
        hv = __fmaf_rn(ev[u], hv, sv[u]);
      }
    }
  }
  float gv = in && a.dhT ? a.dhT[b * a.dh_sb + hd * a.dh_sh + m * a.dh_sn + q] : 0.0f;
  for (int c = a.nc - 1; c >= 0; c -= kPassBatch) {
    float uv[kPassBatch], ev[kPassBatch];
#pragma unroll
    for (int u = 0; u < kPassBatch; ++u) {
      if (c - u >= 0) {
        const int64_t slot = (static_cast<int64_t>(b) * a.nc + c - u) * a.nh + hd;
        uv[u] = a.su[(slot * 2 + 1) * npp + e];
        ev[u] = a.el[slot];
      }
    }
#pragma unroll
    for (int u = 0; u < kPassBatch; ++u) {
      if (c - u >= 0) {
        bf16* gh = a.ghp + ((static_cast<int64_t>(b) * a.nc + c - u) * a.nh + hd) * 4 * npp;
        put_split(gh + e, gh + npp + e, gv);
        gv = __fmaf_rn(ev[u], gv, uv[u]);
      }
    }
  }
  if (in && a.dh0) a.dh0[((static_cast<int64_t>(b) * a.nh + hd) * a.n + m) * a.p + q] = gv;
}

// Launch C: per (chunk, group of heads, batch); see the header.
__global__ void __launch_bounds__(kMmaThreads, 1) ssd_bwd_chunk_mma(MmaBwdArgs a) {
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  unsigned char* smem = bwd_smem;
  const BwdLayout lay(a.chunk, a.n, a.p);
  const int c = blockIdx.x, grp = blockIdx.y, b = blockIdx.z;
  const int h_lo = grp * a.group, h_hi = min(a.nh, h_lo + a.group);
  const int c0 = c * a.chunk;
  const int rows = min(a.chunk, a.s - c0);
  const int lane = threadIdx.x & 31;
  const int warp = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) >> 5, 0);
  const int g = lane >> 2, t4 = lane & 3;
  const int r = row_block(warp);
  const bool owns = r < lay.nb;
  const int nb = lay.nb, lp = lay.lp, pp = lay.pp, np = lay.np;
  const int pt = pp / 8, nt_n = np / 8;  // column tiles of 8 over P and over N
  bf16* bs = reinterpret_cast<bf16*>(smem);
  bf16* cs = reinterpret_cast<bf16*>(smem + lay.c_c);
  float* cbt = reinterpret_cast<float*>(smem + lay.c_cbt);
  float* dtile = reinterpret_cast<float*>(smem + lay.c_dtile);
  bf16* xs = reinterpret_cast<bf16*>(smem + lay.c_x);
  bf16* dyh = reinterpret_cast<bf16*>(smem + lay.c_dyh);
  bf16* dyl = reinterpret_cast<bf16*>(smem + lay.c_dyl);
  const int gplane = lay.gh_bytes / 2;
  bf16* ghi = reinterpret_cast<bf16*>(smem + lay.c_gh);
  bf16* glo = ghi + gplane;
  bf16* hhi = ghi + 2 * gplane;
  bf16* hlo = ghi + 3 * gplane;
  float* vecs = reinterpret_cast<float*>(smem + lay.c_vec);
  const int vs = lay.vec_bytes / 4;
  float* cl = vecs + 2 * vs;     // cum log2 e
  float* ecum = vecs + 3 * vs;   // exp(cum)
  float* eto = vecs + 4 * vs;    // exp(cum_L - cum)
  float* to = vecs + 5 * vs;     // eto dt
  float* stp = vecs + 6 * vs;    // dcum's carried and state-update terms
  float* sddt = vecs + 7 * vs;   // ddt's state-update term
  float* zv = vecs + 8 * vs;     // to_j w_j, summed into dcum_L
  float* rrv = vecs + 9 * vs;    // the row sums of (dy.x) W over the tiles
  float* rqd = vecs + 10 * vs;   // the row sums of (dy.x) T C.B
  float* colp = reinterpret_cast<float*>(smem + lay.c_colp);  // column sums of (dy.x) W, per row block
  float* red = reinterpret_cast<float*>(smem + lay.c_red);    // <G, H> per warp; exp(cum_L)
  const bool vec = a.vec != 0;

  auto slot_of = [&](int hd) { return (static_cast<int64_t>(b) * a.nc + c) * a.nh + hd; };
  auto stage_gh = [&](int hd) {
    stage_planes(ghi, gplane, lay.xs, a.ghp + slot_of(hd) * 4 * np * pp, np, pp, 4);
  };
  auto stage_xdy = [&](int hd, int buf) {
    stage_bf16(xs, lay.xs, a.x + b * a.x_sb + c0 * a.x_ss + hd * a.x_sh, a.x_ss, rows, a.p, lp, pp, vec);
    stage_planes(dyh, lay.x_bytes / 2, lay.xs, a.dyp + slot_of(hd) * 2 * lp * pp, lp, pp, 2);
    stage_dt(vecs + buf * vs, a.dt + b * a.dt_sb + c0 * a.dt_ss + hd * a.dt_sh, a.dt_ss, rows, lp);
  };

  stage_bf16(bs, lay.ns, a.bm + b * a.b_sb + c0 * a.b_ss, a.b_ss, rows, a.n, lp, np, vec);
  stage_bf16(cs, lay.ns, a.cm + b * a.c_sb + c0 * a.c_ss, a.c_ss, rows, a.n, lp, np, vec);
  stage_gh(h_lo);
  stage_xdy(h_lo, 0);
  cp_commit();
  cp_wait_all();
  __syncthreads();

  // C.B^T once, each warp its row block's causal tiles (rows j, columns i >= j):
  // exact products of the bf16 inputs; D^T's tiles start at zero. A warp
  // reads only its own tiles until after the last head.
  if (owns) {
    for (int ib = r; ib < nb; ++ib) {
      float acc[2][4] = {};
      for (int kb = 0; kb < np; kb += 16) {
        uint32_t af[4], bf[4];
        ldsm4(af, bs + (r * 16 + row_a(lane)) * lay.ns + kb + col_a(lane));
        ldsm4(bf, cs + (ib * 16 + row_b(lane)) * lay.ns + kb + col_b(lane));
        mma(acc[0], af, bf[0], bf[1]);
        mma(acc[1], af, bf[2], bf[3]);
      }
      const int at = (tile_index(r, ib, nb) * 32 + lane) * 8;
      st4(cbt + at, acc[0][0], acc[0][1], acc[0][2], acc[0][3]);
      st4(cbt + at + 4, acc[1][0], acc[1][1], acc[1][2], acc[1][3]);
      st4(dtile + at, 0.f, 0.f, 0.f, 0.f);
      st4(dtile + at + 4, 0.f, 0.f, 0.f, 0.f);
    }
  }

  const int j0 = r * 16 + g, j1 = j0 + 8;  // the two rows a lane holds
  float dba[8][4] = {}, dca[8][4] = {};   // dB's and dC's rows of the warp's block, over the heads
  for (int hd = h_lo; hd < h_hi; ++hd) {
    const int buf = (hd - h_lo) & 1;
    const float* dts = vecs + buf * vs;
    // <G, H> (the decay's gradient) in partials per warp; the cumsum and its exponentials
    {
      float gh = 0.f;
      for (int e = threadIdx.x; e < np * pp; e += kMmaThreads) {
        const int o = (e / pp) * lay.xs + e % pp;
        gh += (__bfloat162float(ghi[o]) + __bfloat162float(glo[o])) *
              (__bfloat162float(hhi[o]) + __bfloat162float(hlo[o]));
      }
      gh = warp_sum(gh);
      if (lane == 0) red[warp] = gh;
    }
    if (warp == 0) {
      chunk_cum_warp(dts, a.a[hd * a.a_s], lp, cl, lane);
      const float last = cl[lp - 1];
      __syncwarp();
      for (int t = lane; t < lp; t += 32) {
        const float v = cl[t], x = expf(last - v);
        ecum[t] = expf(v);
        eto[t] = x;
        to[t] = x * dts[t];
        cl[t] = v * kLog2e;
      }
      if (lane == 0) red[kMmaWarps] = expf(last);
    }
    __syncthreads();

    // The state terms: dx_j = to_j G^T B_j, dB_j += to_j G x_j, dC_i += e_i H dy_i,
    // and from the same products w_j = x_j . G^T B_j and hy_i = C_i . H dy_i
    float dxa[8][4] = {};
    if (owns) {
      const float to0 = to[j0], to1 = to[j1], e0 = ecum[j0], e1 = ecum[j1];
      float acc[8][4] = {};
      for (int kb = 0; kb < np; kb += 16) {  // B G: A = B's rows, K = N
        uint32_t af[4];
        ldsm4(af, bs + (r * 16 + row_a(lane)) * lay.ns + kb + col_a(lane));
#pragma unroll
        for (int pn = 0; pn < 4; ++pn) {
          if (2 * pn >= pt) break;
          uint32_t fh[4], fl[4];
          const int off = (kb + row_a(lane)) * lay.xs + pn * 16 + col_a(lane);
          ldsm4t(fh, ghi + off);
          ldsm4t(fl, glo + off);
          mma(acc[2 * pn], af, fh[0], fh[1]);
          mma(acc[2 * pn], af, fl[0], fl[1]);
          mma(acc[2 * pn + 1], af, fh[2], fh[3]);
          mma(acc[2 * pn + 1], af, fl[2], fl[3]);
        }
      }
      float w0 = 0.f, w1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt >= pt) break;
        const int q = nt * 8 + 2 * t4;
        const float2 x0 = bf2(xs + j0 * lay.xs + q), x1 = bf2(xs + j1 * lay.xs + q);
        w0 += x0.x * acc[nt][0] + x0.y * acc[nt][1];
        w1 += x1.x * acc[nt][2] + x1.y * acc[nt][3];
        dxa[nt][0] = to0 * acc[nt][0];
        dxa[nt][1] = to0 * acc[nt][1];
        dxa[nt][2] = to1 * acc[nt][2];
        dxa[nt][3] = to1 * acc[nt][3];
      }
      w0 = quad_sum(w0);
      w1 = quad_sum(w1);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
      for (int kb = 0; kb < pp; kb += 16) {  // x G^T: A = x's rows, K = P
        uint32_t af[4];
        ldsm4(af, xs + (r * 16 + row_a(lane)) * lay.xs + kb + col_a(lane));
#pragma unroll
        for (int mn = 0; mn < 4; ++mn) {
          if (2 * mn >= nt_n) break;
          uint32_t fh[4], fl[4];
          const int off = (mn * 16 + row_b(lane)) * lay.xs + kb + col_b(lane);
          ldsm4(fh, ghi + off);
          ldsm4(fl, glo + off);
          mma(acc[2 * mn], af, fh[0], fh[1]);
          mma(acc[2 * mn], af, fl[0], fl[1]);
          mma(acc[2 * mn + 1], af, fh[2], fh[3]);
          mma(acc[2 * mn + 1], af, fl[2], fl[3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt >= nt_n) break;
        dba[nt][0] += to0 * acc[nt][0];
        dba[nt][1] += to0 * acc[nt][1];
        dba[nt][2] += to1 * acc[nt][2];
        dba[nt][3] += to1 * acc[nt][3];
        acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
      }
      for (int kb = 0; kb < pp; kb += 16) {  // dy H^T: A = dy's rows (hi + lo), K = P
        uint32_t ah[4], al[4];
        const int aoff = (r * 16 + row_a(lane)) * lay.xs + kb + col_a(lane);
        ldsm4(ah, dyh + aoff);
        ldsm4(al, dyl + aoff);
#pragma unroll
        for (int mn = 0; mn < 4; ++mn) {
          if (2 * mn >= nt_n) break;
          uint32_t fh[4], fl[4];
          const int off = (mn * 16 + row_b(lane)) * lay.xs + kb + col_b(lane);
          ldsm4(fh, hhi + off);
          ldsm4(fl, hlo + off);
          mma(acc[2 * mn], ah, fh[0], fh[1]);
          mma(acc[2 * mn], ah, fl[0], fl[1]);
          mma(acc[2 * mn], al, fh[0], fh[1]);
          mma(acc[2 * mn + 1], ah, fh[2], fh[3]);
          mma(acc[2 * mn + 1], ah, fl[2], fl[3]);
          mma(acc[2 * mn + 1], al, fh[2], fh[3]);
        }
      }
      float y0 = 0.f, y1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt >= nt_n) break;
        const int m = nt * 8 + 2 * t4;
        const float2 ca = bf2(cs + j0 * lay.ns + m), cb = bf2(cs + j1 * lay.ns + m);
        y0 += ca.x * acc[nt][0] + ca.y * acc[nt][1];
        y1 += cb.x * acc[nt][2] + cb.y * acc[nt][3];
        dca[nt][0] += e0 * acc[nt][0];
        dca[nt][1] += e0 * acc[nt][1];
        dca[nt][2] += e1 * acc[nt][2];
        dca[nt][3] += e1 * acc[nt][3];
      }
      y0 = quad_sum(y0);
      y1 = quad_sum(y1);
      if (t4 == 0) {
        stp[j0] = e0 * y0 - to0 * w0;
        stp[j1] = e1 * y1 - to1 * w1;
        sddt[j0] = eto[j0] * w0;
        sddt[j1] = eto[j1] * w1;
        zv[j0] = to0 * w0;
        zv[j1] = to1 * w1;
      }
    }
    __syncthreads();  // G and H are read no more: the next head's come in under the tiles
    if (hd + 1 < h_hi) {
      stage_gh(hd + 1);
      cp_commit();
    }

    // The in-chunk terms over the warp's causal tiles (rows j of its block, columns i >= j)
    if (owns) {
      const float cj0 = cl[j0], cj1 = cl[j1], dj0 = dts[j0], dj1 = dts[j1];
      float rv0 = 0.f, rv1 = 0.f, qd0 = 0.f, qd1 = 0.f;
      for (int ib = r; ib < nb; ++ib) {
        float v[2][4] = {};  // (dy_i . x_j): A = x's rows, B = dy's rows (hi + lo), K = P
        for (int kb = 0; kb < pp; kb += 16) {
          uint32_t af[4], fh[4], fl[4];
          ldsm4(af, xs + (r * 16 + row_a(lane)) * lay.xs + kb + col_a(lane));
          const int off = (ib * 16 + row_b(lane)) * lay.xs + kb + col_b(lane);
          ldsm4(fh, dyh + off);
          ldsm4(fl, dyl + off);
          mma(v[0], af, fh[0], fh[1]);
          mma(v[0], af, fl[0], fl[1]);
          mma(v[1], af, fh[2], fh[3]);
          mma(v[1], af, fl[2], fl[3]);
        }
        const int at = (tile_index(r, ib, nb) * 32 + lane) * 8;
        const float4 cb0 = ld4(cbt + at), cb1 = ld4(cbt + at + 4);
        const float4 d0 = ld4(dtile + at), d1 = ld4(dtile + at + 4);
        const float cb[8] = {cb0.x, cb0.y, cb0.z, cb0.w, cb1.x, cb1.y, cb1.z, cb1.w};
        float d[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
        float w[8];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int i = ib * 16 + nt * 8 + 2 * t4;
          const float2 ci = *reinterpret_cast<const float2*>(cl + i);
          float col0 = 0.f, col1 = 0.f;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ii = i + (e & 1), jj = e < 2 ? j0 : j1;
            const float tv = ii >= jj ? ex2((e & 1 ? ci.y : ci.x) - (e < 2 ? cj0 : cj1)) : 0.f;
            const float cv = cb[nt * 4 + e], dv = v[nt][e], dj = e < 2 ? dj0 : dj1;
            const float wv = tv * cv * dj, rv = dv * wv, qd = dv * tv * cv;
            w[nt * 4 + e] = wv;
            d[nt * 4 + e] += dv * tv * dj;
            if (e < 2) {
              rv0 += rv;
              qd0 += qd;
            } else {
              rv1 += rv;
              qd1 += qd;
            }
            if (e & 1)
              col1 += rv;
            else
              col0 += rv;
          }
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) {  // over the tile's 16 rows: the lanes of equal t4
            col0 += __shfl_xor_sync(0xffffffffu, col0, o);
            col1 += __shfl_xor_sync(0xffffffffu, col1, o);
          }
          if (g == 0) *reinterpret_cast<float2*>(colp + r * lp + i) = make_float2(col0, col1);
        }
        st4(dtile + at, d[0], d[1], d[2], d[3]);
        st4(dtile + at + 4, d[4], d[5], d[6], d[7]);
        uint32_t ah[4], al[4];  // W^T as the A operand (rows j, K = i), hi + lo
        split2(w[0], w[1], ah[0], al[0]);
        split2(w[2], w[3], ah[1], al[1]);
        split2(w[4], w[5], ah[2], al[2]);
        split2(w[6], w[7], ah[3], al[3]);
#pragma unroll
        for (int pn = 0; pn < 4; ++pn) {  // dx_j += sum_i W_ij dy_i: B = dy (K = i, P columns)
          if (2 * pn >= pt) break;
          uint32_t fh[4], fl[4];
          const int off = (ib * 16 + row_a(lane)) * lay.xs + pn * 16 + col_a(lane);
          ldsm4t(fh, dyh + off);
          ldsm4t(fl, dyl + off);
          mma(dxa[2 * pn], ah, fh[0], fh[1]);
          mma(dxa[2 * pn], ah, fl[0], fl[1]);
          mma(dxa[2 * pn], al, fh[0], fh[1]);
          mma(dxa[2 * pn + 1], ah, fh[2], fh[3]);
          mma(dxa[2 * pn + 1], ah, fl[2], fl[3]);
          mma(dxa[2 * pn + 1], al, fh[2], fh[3]);
        }
      }
      rv0 = quad_sum(rv0);
      rv1 = quad_sum(rv1);
      qd0 = quad_sum(qd0);
      qd1 = quad_sum(qd1);
      if (t4 == 0) {
        rrv[j0] = rv0;
        rrv[j1] = rv1;
        rqd[j0] = qd0;
        rqd[j1] = qd1;
      }
      // dx's rows, in bf16
      bf16* dxo = a.dx + (static_cast<int64_t>(b) * a.s + c0) * a.nh * a.p + static_cast<int64_t>(hd) * a.p;
      const int64_t dss = static_cast<int64_t>(a.nh) * a.p;
      const bool pairs = a.p % 2 == 0;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt >= pt) break;
        const int q = nt * 8 + 2 * t4;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int j = rr ? j1 : j0;
          if (j >= rows || q >= a.p) continue;
          bf16* o = dxo + j * dss + q;
          if (pairs) {
            *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(dxa[nt][2 * rr], dxa[nt][2 * rr + 1]);
          } else {
            o[0] = __float2bfloat16_rn(dxa[nt][2 * rr]);
            if (q + 1 < a.p) o[1] = __float2bfloat16_rn(dxa[nt][2 * rr + 1]);
          }
        }
      }
    }
    __syncthreads();  // x, dy and the tiles' sums are in: the next head's x, dy and dt come in under the scan
    if (hd + 1 < h_hi) {
      stage_xdy(hd + 1, buf ^ 1);
      cp_commit();
    }
    if (warp == 0) {
      // dcum_t = its state terms - the row sums + the column sums (dcum_L also
      // takes sum_j to_j w_j and exp(cum_L) <G, H>); dla_t = sum_{i >= t} dcum_i
      // gives ddt_t += a dla_t and da's partial sum_t dt_t dla_t
      const int per = (lp + 31) / 32;
      float dc[4], z = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int t = lane * per + k;
        dc[k] = 0.f;
        if (k < per && t < lp) {
          float s = stp[t] - rrv[t];
          for (int rb = 0; rb <= t / 16; ++rb) s += colp[rb * lp + t];
          dc[k] = s;
          z += zv[t];
        }
      }
      z = warp_sum(z);
      float ghs = 0.f;
      for (int w = 0; w < kMmaWarps; ++w) ghs += red[w];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (k < per && lane * per + k == lp - 1) dc[k] += z + red[kMmaWarps] * ghs;
      float suf[4], run = 0.f;
#pragma unroll
      for (int k = 3; k >= 0; --k) {
        run += dc[k];
        suf[k] = run;
      }
      float incl = run;  // sum over this lane's positions and every later lane's
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_down_sync(0xffffffffu, incl, o);
        if (lane + o < 32) incl += v;
      }
      float off = __shfl_down_sync(0xffffffffu, incl, 1);
      if (lane == 31) off = 0.f;
      const float ah = a.a[hd * a.a_s];
      float dap = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int t = lane * per + k;
        if (k < per && t < lp) {
          const float dla = off + suf[k];
          if (t < rows) a.ddt[(static_cast<int64_t>(b) * a.s + c0 + t) * a.nh + hd] = sddt[t] + rqd[t] + ah * dla;
          dap += dts[t] * dla;
        }
      }
      dap = warp_sum(dap);
      if (lane == 0) a.dap[slot_of(hd)] = dap;
    }
    cp_wait_all();
    __syncthreads();
  }

  if (!owns) return;
  // dB_j += sum_i D^T_ji C_i over the warp's own tiles: A = D^T (hi + lo), B = C (K = i)
  for (int ib = r; ib < nb; ++ib) {
    const int at = (tile_index(r, ib, nb) * 32 + lane) * 8;
    const float4 d0 = ld4(dtile + at), d1 = ld4(dtile + at + 4);
    uint32_t ah[4], al[4];
    split2(d0.x, d0.y, ah[0], al[0]);
    split2(d0.z, d0.w, ah[1], al[1]);
    split2(d1.x, d1.y, ah[2], al[2]);
    split2(d1.z, d1.w, ah[3], al[3]);
#pragma unroll
    for (int mn = 0; mn < 4; ++mn) {
      if (2 * mn >= nt_n) break;
      uint32_t f[4];
      ldsm4t(f, cs + (ib * 16 + row_a(lane)) * lay.ns + mn * 16 + col_a(lane));
      mma(dba[2 * mn], ah, f[0], f[1]);
      mma(dba[2 * mn], al, f[0], f[1]);
      mma(dba[2 * mn + 1], ah, f[2], f[3]);
      mma(dba[2 * mn + 1], al, f[2], f[3]);
    }
  }
  // dC_i += sum_j D_ij B_j: D's rows i of this block from the tiles (jb, r)
  // of every block jb <= r (the last barrier made them visible)
  for (int jb = 0; jb <= r; ++jb) {
    const float* tp = dtile + tile_index(jb, r, nb) * 256;
    float dv[8];  // A[i][j] = D^T[j][i]: rows g, g + 8; columns 2 t4 (+ 1), + 8
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int ii = g + ((k >> 1) & 1) * 8, jj = 2 * t4 + (k & 1) + (k >> 2) * 8;
      dv[k] = tp[tile_at(jj, ii)];
    }
    uint32_t ah[4], al[4];
    split2(dv[0], dv[1], ah[0], al[0]);
    split2(dv[2], dv[3], ah[1], al[1]);
    split2(dv[4], dv[5], ah[2], al[2]);
    split2(dv[6], dv[7], ah[3], al[3]);
#pragma unroll
    for (int mn = 0; mn < 4; ++mn) {
      if (2 * mn >= nt_n) break;
      uint32_t f[4];
      ldsm4t(f, bs + (jb * 16 + row_a(lane)) * lay.ns + mn * 16 + col_a(lane));
      mma(dca[2 * mn], ah, f[0], f[1]);
      mma(dca[2 * mn], al, f[0], f[1]);
      mma(dca[2 * mn + 1], ah, f[2], f[3]);
      mma(dca[2 * mn + 1], al, f[2], f[3]);
    }
  }
  // the group's partials of dB and dC
  const int64_t prow = ((static_cast<int64_t>(b) * a.groups + grp) * a.s + c0) * a.n;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    if (nt >= nt_n) break;
    const int m = nt * 8 + 2 * t4;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int j = rr ? j1 : j0;
      if (j >= rows) continue;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (m + u < a.n) {
          a.dbp[prow + static_cast<int64_t>(j) * a.n + m + u] = dba[nt][2 * rr + u];
          a.dcp[prow + static_cast<int64_t>(j) * a.n + m + u] = dca[nt][2 * rr + u];
        }
      }
    }
  }
}

// Launch D: dB and dC (the groups' partials in group order, in bf16) and, in
// the last block, da (the chunks' partials in (batch, chunk) order).
__global__ void __launch_bounds__(kMmaThreads) ssd_bwd_sums(MmaBwdArgs a, int64_t elems) {
  if (blockIdx.x == gridDim.x - 1) {
    for (int h = threadIdx.x; h < a.nh; h += kMmaThreads) {
      float acc = 0.f;
      for (int64_t i = 0; i < static_cast<int64_t>(a.batch) * a.nc; ++i) acc += a.dap[i * a.nh + h];
      a.da[h] = acc;
    }
    return;
  }
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kMmaThreads + threadIdx.x;
  if (e >= elems) return;
  const int64_t per_b = static_cast<int64_t>(a.s) * a.n;
  const int64_t b = e / per_b, rest = e % per_b;
  float sb = 0.f, sc = 0.f;
  for (int k = 0; k < a.groups; ++k) {
    const int64_t i = (b * a.groups + k) * per_b + rest;
    sb += a.dbp[i];
    sc += a.dcp[i];
  }
  a.db[e] = __float2bfloat16_rn(sb);
  a.dc[e] = __float2bfloat16_rn(sc);
}

template <typename K>
cudaError_t set_smem(K* kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

cudaError_t launch_mma(const MmaBwdArgs& a, cudaStream_t st) {
  const BwdLayout lay(a.chunk, a.n, a.p);
  cudaError_t e = set_smem(ssd_bwd_states, lay.a_bytes);
  if (e != cudaSuccess) return e;
  e = set_smem(ssd_bwd_chunk_mma, lay.c_bytes);
  if (e != cudaSuccess) return e;
  ssd_bwd_states<<<dim3(a.nc, a.nh, a.batch), kMmaThreads, lay.a_bytes, st>>>(a);
  const int64_t total = static_cast<int64_t>(a.batch) * a.nh * lay.np * lay.pp;
  ssd_bwd_passes<<<static_cast<unsigned>((total + kPassThreads - 1) / kPassThreads), kPassThreads, 0, st>>>(
      a, total);
  ssd_bwd_chunk_mma<<<dim3(a.nc, a.groups, a.batch), kMmaThreads, lay.c_bytes, st>>>(a);
  const int64_t elems = static_cast<int64_t>(a.batch) * a.s * a.n;
  ssd_bwd_sums<<<static_cast<unsigned>((elems + kMmaThreads - 1) / kMmaThreads + 1), kMmaThreads, 0, st>>>(
      a, elems);
  return cudaGetLastError();
}

}  // namespace

// Bytes of shared memory a block of the bf16 build's launch A (which 0) or
// C (which 1) takes (kernels/ssd.py:bwd_smem computes the same).
extern "C" int rt_ssd_bwd_mma_smem(int which, int chunk, int n, int p) {
  const BwdLayout lay(chunk, n, p);
  return which == 0 ? lay.a_bytes : lay.c_bytes;
}

// Blocks of launch C one SM of the current device holds at once; -1 on a
// CUDA error.
extern "C" int rt_ssd_bwd_blocks_per_sm(int chunk, int n, int p) {
  if (chunk < 1 || chunk > kMaxL || n < 1 || n > kMaxNP || p < 1 || p > kMaxNP) return -1;
  const int smem = BwdLayout(chunk, n, p).c_bytes;
  int blocks = 0;
  if (set_smem(ssd_bwd_chunk_mma, smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, ssd_bwd_chunk_mma, kMmaThreads, smem) !=
          cudaSuccess)
    return -1;
  return blocks;
}

// The bf16 build. strides: 20 int64 values: x (batch, seq, head), dt (batch,
// seq, head), B (batch, seq), C (batch, seq), dy (batch, seq, head), h0
// (batch, head, N), dh (batch, head, N), a. work: the scratch of the
// header's launches at the offsets kernels/ssd.py:bwd_plan gives, in
// bytes: su, el, dyp, ghp, dbp, dcp, dap. Heads in groups of `group`.
extern "C" int rt_ssd_scan_bwd_mma(const void* xh, const float* dt, const float* a_, const void* bm,
                                   const void* cm, const float* dy, const float* dhT, const float* h0,
                                   void* dx, float* ddt, float* da, void* db, void* dc, float* dh0,
                                   void* work, const int64_t* offsets, const int64_t* strides, int b,
                                   int s, int nh, int p, int n, int chunk, int group, void* stream) {
  if (b < 1 || s < 1 || nh < 1 || chunk < 1 || chunk > kMaxL || n < 1 || n > kMaxNP || p < 1 ||
      p > kMaxNP || group < 1 || !work)
    return cudaErrorInvalidValue;
  auto at = [&](int k) { return static_cast<unsigned char*>(work) + offsets[k]; };
  auto aligned = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; };
  bool vec = p % 8 == 0 && n % 8 == 0 && aligned(xh) && aligned(bm) && aligned(cm);
  for (int i : {0, 1, 2, 6, 7, 8, 9}) vec = vec && strides[i] % 8 == 0;
  const bool vdy = p % 4 == 0 && aligned(dy) && strides[10] % 4 == 0 && strides[11] % 4 == 0 &&
                   strides[12] % 4 == 0;
  MmaBwdArgs args{static_cast<const bf16*>(xh), dt, a_, static_cast<const bf16*>(bm),
                  static_cast<const bf16*>(cm), dy, dhT, h0, static_cast<bf16*>(dx), ddt, da,
                  static_cast<bf16*>(db), static_cast<bf16*>(dc), dh0,
                  reinterpret_cast<float*>(at(0)), reinterpret_cast<float*>(at(1)),
                  reinterpret_cast<bf16*>(at(2)), reinterpret_cast<bf16*>(at(3)),
                  reinterpret_cast<float*>(at(4)), reinterpret_cast<float*>(at(5)),
                  reinterpret_cast<float*>(at(6)),
                  strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
                  strides[6], strides[7], strides[8], strides[9], strides[10], strides[11],
                  strides[12], strides[13], strides[14], strides[15], strides[16], strides[17],
                  strides[18], strides[19],
                  b, s, nh, p, n, chunk, (s + chunk - 1) / chunk, group, (nh + group - 1) / group,
                  vec ? 1 : 0, vdy ? 1 : 0};
  return launch_mma(args, static_cast<cudaStream_t>(stream));
}
