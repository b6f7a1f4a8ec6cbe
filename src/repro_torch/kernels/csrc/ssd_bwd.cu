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
// xh, B and C in f32 or bf16 (packed), dt, a, dy and every gradient in f32.
// A ragged last chunk is zero-padded (dt = x = B = C = dy = 0), as the
// forward masks it.
//
// What bounds it: operations, in f32 FMAs (no tensor cores in this first
// version): about 4 L^2 (N + P) / 2 + 6 L N P per (batch, chunk, head).
//
// Design: five launches, no atomics, every sum in an order fixed by the
// shape, so a repeat is bitwise.
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
// Both input dtypes run one build (an element's load picks its type), which
// halves the build's time.
//   4. ssd_bwd_heads: dB and dC, the per-head partials summed in head order.
//   5. ssd_bwd_da: da, the per-chunk partials summed in (batch, chunk) order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
