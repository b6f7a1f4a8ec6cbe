// mlstm_scan_bwd: the gradient of the chunked mLSTM scan (mlstm.cu,
// mlstm_general.cu), for training.
//
// Replaces no Pallas kernel: the reference trains through jax.grad of its
// mlstm_chunked (repro/models/xlstm.py:_mlstm_chunked_impl, a lax.scan over
// the chunks); the port's forward on the card is mlstm_scan, so its
// gradient is a kernel too. The plain version is
// kernels/ref.py:mlstm_scan_bwd_ref, autograd of mlstm_scan_ref, which this
// kernel follows term by term: the stabilizers m_c (a running max over the
// chunks of each chunk's max of src_j = i~_j - cumf_j) and the
// denominator's max(|den|, exp(-m_c)) are on the gradient's path as
// autograd takes them (a tie of the max splits the gradient in two; the
// chunk max splits it over its ties; the running max gives it to the
// latest of equal values). Per (batch, head) and chunk c of L positions,
// with s = P^-1/2, D_ij = exp(cumf_i + src_j - m_c) (j <= i),
// carry_i = exp(cumf_i + m_{c-1} - m_c) s, te_j = exp(cumf_L + src_j - m_c),
// decay_c = exp(cumf_L + m_{c-1} - m_c), and C, n the state before the chunk:
//   y_i = (sum_j D_ij (q_i.k_j) s v_j + carry_i C q_i) / Z_i,
//   Z_i = max(|sum_j D_ij (q_i.k_j) s + carry_i n.q_i|, exp(-m_c)),
//   C_c = decay_c C + sum_j te_j v_j k_j^T,  n_c = decay_c n + sum_j te_j k_j.
// Backwards, with G, g the gradients of C_c, n_c:
//   G_{c-1} = decay_c G + sum_i carry_i dnum_i (x) q_i,   dnum_i = dy_i / Z_i
//   g_{c-1} = decay_c g + sum_i carry_i dden_i q_i
//   dq_i += carry_i (C^T dnum_i + dden_i n),  dv_j += te_j G k_j,
//   dk_j += te_j (G^T v_j + g),
// and the in-chunk terms of D, q.k and v as autograd forms them; the gates'
// gradients come from the log-space sums of every exp above, routed
// through cumf's reverse cumsum and logsigmoid.
// q, k, v in f32 or bf16 (packed), the gates f32, every gradient f32.
// A ragged last chunk is padded as the plain version pads it (i~ = -inf,
// log f = 0, zeros elsewhere).
//
// What bounds it: operations, in f32 FMAs (no tensor cores in this first
// version): per (batch, head, chunk) about 6 L P^2 (the P x P state's
// products: C_c and G's rank-L updates, G k, G^T v, C q, C^T dnum) and
// 5 L^2 P (the in-chunk products); xlstm-1.3b (P = 1024, L = 64) is about
// 99 % the former.
//
// Design: seven launches, no atomics, every sum in an order fixed by the
// shape (a repeat is bitwise):
//   1. mlstm_bwd_gates, a block per (head, batch): log f, cumf, src, the
//      chunk maxima and stabilizers, te, carry, decay.
//   2. mlstm_bwd_nsum, a thread per (column, chunk, head, batch): each
//      chunk's own n sum.
//   3. mlstm_bwd_intra, a block per (chunk, head, batch): n before the
//      chunk (from the earlier chunks' sums), q.k and dy.v over P in tiles
//      of 64 columns, then den, Z, dnum's scale, dden and the in-chunk
//      log-space sums, then dq, dk, dv's in-chunk terms and g's rank-L
//      input, again over tiles of P.
//   4. mlstm_bwd_outer, a block per (64 x 64 tile of P x P, chunk, head x
//      batch): each chunk's own state sum_j te_j v_j k_j^T and G's input
//      sum_i carry_i dnum_i q_i^T.
//   5. mlstm_bwd_pass, a thread per (batch, head, element of C and n): the
//      forward pass (C before each chunk) and the reverse one (G and g
//      after each chunk), dC0 and dn0, kBatch chunks' loads in flight.
//   6. mlstm_bwd_state, a block per (64 columns of P, chunk, head x batch):
//      G k, G^T v, C q and C^T dy over P in tiles of 64, into dq, dk, dv,
//      and the per-column-tile partials of te's, carry's and decay's
//      gradients.
//   7. mlstm_bwd_final, a block per (head, batch): those partials summed in
//      tile order, the stabilizers' routing, cumf's reverse cumsum, di~ and
//      df~.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kT = 64;         // tile: positions of a chunk, columns of P
constexpr int kTS = kT + 1;    // a tile's row stride in shared memory
constexpr int kTile = kT * kTS;
constexpr float kNegInf = -1e30f;
constexpr int kBatch = 8;  // chunks the state pass loads at once

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float logsigmoid(float x) { return fminf(x, 0.f) - log1pf(expf(-fabsf(x))); }

struct Args {
  const void* q;      // (B, S, nh, P)
  const void* k;
  const void* v;
  const float* ig;    // (B, S, nh) i~
  const float* fg;    // (B, S, nh) f~
  const float* y;     // (B, S, nh, P) the forward's output
  const float* dy;    // (B, S, nh, P)
  const float* C0;    // (B, nh, P, P) or null (then n0, m0 are null too)
  const float* n0;    // (B, nh, P)
  const float* m0;    // (B, nh)
  const float* dC;    // gradients of the final state, each null where unused
  const float* dn;
  const float* dm;
  float* dq;          // (B, S, nh, P)
  float* dk;
  float* dv;
  float* di;          // (B, S, nh)
  float* df;
  float* dC0;         // null without a state
  float* dn0;
  float* dm0;
  float* pos;         // (B, nh, 4, nc L): cumf, src, te, carry
  float* cinf;        // (B, nh, nc, 4): m_{c-1}, m_c, decay, the chunk's max of src
  float* dnb;         // (B, nh, nc, P): the chunk's own sum_j te_j k_j
  float* nb;          // (B, nh, nc, P): n before chunk c
  float* pos2;        // (B, nh, 5, nc L): 1/Z, dden, dcumf, dsrc, n.q
  float* dmi;         // (B, nh, nc): the in-chunk terms' gradient of m_c
  float* cs;          // (B, nh, nc, P, P): each chunk's own state, then C before chunk c
  float* gs;          // (B, nh, nc, P, P): G's input, then G after chunk c
  float* un;          // (B, nh, nc, P): g's input, then g after chunk c
  float* part;        // (B, nh, nc, nT, 2, kT): te's and carry's gradient partials
  float* pdec;        // (B, nh, nc, nT): decay's gradient partials
  float* cg;          // (B, nh, nc + 1, 4): per-chunk gradients of m_c, m_{c-1}, cumf_L, the routed max
  int b, s, nh, p, chunk, nc, nt;
};

// acc[a][c] += sum_{k < K} A(ty + 16 a, k) B(k, tx + 16 c) over shared-memory
// operands given by strides, for a 64 x 64 output a block of 256 threads
// holds 4 x 4 a thread (rows and columns strided by 16).
__device__ __forceinline__ void mma_tile(float (&acc)[4][4], const float* A, int sai, int sak,
                                         const float* B, int sbk, int sbc, int K) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  for (int k = 0; k < K; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = A[(ty + 16 * i) * sai + k * sak];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = B[k * sbk + (tx + 16 * j) * sbc];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// A (rows of the chunk) x (64 columns of P from col0) tile of x (B, S, nh, P)
// into shared memory, zero past the chunk, S or P.
template <typename T>
__device__ void load_rows(float* dst, const T* x, const Args& a, int b, int h, int t0, int col0, int L) {
  for (int e = threadIdx.x; e < kT * kT; e += kThreads) {
    const int i = e / kT, pc = e % kT, t = t0 + i, col = col0 + pc;
    float v = 0.f;
    if (i < L && t < a.s && col < a.p) v = ld(x + (((int64_t)b * a.s + t) * a.nh + h) * a.p + col);
    dst[i * kTS + pc] = v;
  }
}

// A 64 x 64 tile of a P x P matrix (rows from r0, columns from c0) into shared memory.
__device__ void load_mat(float* dst, const float* m, int P, int r0, int c0) {
  for (int e = threadIdx.x; e < kT * kT; e += kThreads) {
    const int i = e / kT, j = e % kT;
    dst[i * kTS + j] = (r0 + i < P && c0 + j < P) ? m[(int64_t)(r0 + i) * P + c0 + j] : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads) mlstm_bwd_gates(Args a) {
  const int h = blockIdx.x, b = blockIdx.y, L = a.chunk, nc = a.nc, SL = nc * L;
  const int64_t bh = (int64_t)b * a.nh + h;
  float* cumf = a.pos + bh * 4 * SL;
  float* src = cumf + SL;
  float* te = src + SL;
  float* carry = te + SL;
  float* ci = a.cinf + bh * nc * 4;
  for (int t = threadIdx.x; t < SL; t += kThreads) {
    const bool ok = t < a.s;
    cumf[t] = ok ? logsigmoid(a.fg[((int64_t)b * a.s + t) * a.nh + h]) : 0.f;
    src[t] = ok ? a.ig[((int64_t)b * a.s + t) * a.nh + h] : -INFINITY;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < nc; c += kThreads) {
    float acc = 0.f, mx = -INFINITY;
    for (int j = c * L; j < (c + 1) * L; ++j) {
      acc += cumf[j];
      cumf[j] = acc;
      src[j] -= acc;
      mx = fmaxf(mx, src[j]);
    }
    ci[c * 4 + 3] = mx;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = a.m0 ? a.m0[bh] : kNegInf;
    for (int c = 0; c < nc; ++c) {
      const float mn = fmaxf(m, ci[c * 4 + 3]);
      ci[c * 4 + 0] = m;
      ci[c * 4 + 1] = mn;
      ci[c * 4 + 2] = expf(cumf[c * L + L - 1] + m - mn);
      m = mn;
    }
  }
  __syncthreads();
  const float scale = rsqrtf((float)a.p);
  for (int t = threadIdx.x; t < SL; t += kThreads) {
    const int c = t / L;
    const float mp = ci[c * 4 + 0], mn = ci[c * 4 + 1], last = cumf[c * L + L - 1];
    te[t] = expf(last + src[t] - mn);
    carry[t] = expf(cumf[t] + mp - mn) * scale;
  }
}

// Each chunk's own n sum, sum_j te_j k_j: a thread per (column, chunk, head x batch).
template <typename T>
__global__ void __launch_bounds__(kThreads) mlstm_bwd_nsum(Args a) {
  const int r = blockIdx.x * kThreads + threadIdx.x, c = blockIdx.y, L = a.chunk;
  const int64_t bhz = blockIdx.z, b = bhz / a.nh, h = bhz % a.nh;
  if (r >= a.p) return;
  const T* k = static_cast<const T*>(a.k);
  const float* te = a.pos + bhz * 4 * a.nc * L + 2 * a.nc * L + c * L;
  float dn = 0.f;
  for (int j = 0; j < L && c * L + j < a.s; ++j)
    dn += te[j] * ld(k + ((b * a.s + c * L + j) * a.nh + h) * a.p + r);
  a.dnb[(bhz * a.nc + c) * a.p + r] = dn;
}

__host__ __device__ inline int intra_smem_floats() { return 8 * kTile + 10 * kT; }

template <typename T>
__global__ void __launch_bounds__(kThreads) mlstm_bwd_intra(Args a) {
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, L = a.chunk, P = a.p, t0 = c * L;
  const int nc = a.nc, SL = nc * L, tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int64_t bh = (int64_t)b * a.nh + h;
  extern __shared__ float smem[];
  float* qk = smem;          // q.k, then dQK
  float* dyv = qk + kTile;   // dy.v, then W / Z
  float* rr = dyv + kTile;   // dW W
  float* qs = rr + kTile;
  float* ks = qs + kTile;
  float* vs = ks + kTile;
  float* ys = vs + kTile;    // dy
  float* yy = ys + kTile;    // y
  float* cumf = yy + kTile;
  float* src = cumf + kT;
  float* carry = src + kT;
  float* nbt = carry + kT;
  float* nq = nbt + kT;
  float* dyy = nq + kT;
  float* rz = dyy + kT;
  float* dden = rz + kT;
  float* dmz = dden + kT;
  float* rows = dmz + kT;
  const float* pos = a.pos + bh * 4 * SL + t0;
  for (int j = tid; j < kT; j += kThreads) {
    cumf[j] = j < L ? pos[j] : 0.f;
    src[j] = j < L ? pos[SL + j] : -INFINITY;
    carry[j] = j < L ? pos[3 * SL + j] : 0.f;
  }
  const float* ci = a.cinf + (bh * nc + c) * 4;
  const float mn = ci[1];
  const float scale = rsqrtf((float)P);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  float aqk[4][4], adv[4][4];
  zero(aqk);
  zero(adv);
  float nqp = 0.f, dyyp = 0.f;
  for (int p0 = 0; p0 < P; p0 += kT) {
    load_rows(qs, q, a, b, h, t0, p0, L);
    load_rows(ks, k, a, b, h, t0, p0, L);
    load_rows(vs, v, a, b, h, t0, p0, L);
    load_rows(ys, a.dy, a, b, h, t0, p0, L);
    load_rows(yy, a.y, a, b, h, t0, p0, L);
    // n before this chunk, from n0 and the earlier chunks' own sums; kept for mlstm_bwd_state
    for (int j = tid; j < kT; j += kThreads) {
      float nv = 0.f;
      if (p0 + j < P) {
        nv = a.n0 ? a.n0[bh * P + p0 + j] : 0.f;
        for (int cc = 0; cc < c; ++cc)
          nv = a.cinf[(bh * nc + cc) * 4 + 2] * nv + a.dnb[(bh * nc + cc) * P + p0 + j];
        a.nb[(bh * nc + c) * P + p0 + j] = nv;
      }
      nbt[j] = nv;
    }
    __syncthreads();
    mma_tile(aqk, qs, kTS, 1, ks, 1, kTS, kT);
    mma_tile(adv, ys, kTS, 1, vs, 1, kTS, kT);
    if (tid < kT) {
      for (int pc = 0; pc < kT; ++pc) {
        nqp += nbt[pc] * qs[tid * kTS + pc];
        dyyp += ys[tid * kTS + pc] * yy[tid * kTS + pc];
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      qk[(ty + 16 * i) * kTS + tx + 16 * j] = aqk[i][j];
      dyv[(ty + 16 * i) * kTS + tx + 16 * j] = adv[i][j];
    }
  if (tid < kT) {
    nq[tid] = nqp;
    dyy[tid] = dyyp;
  }
  __syncthreads();
  const float em = expf(-mn);
  if (tid < L) {
    const int i = tid;
    float den = 0.f;
    for (int j = 0; j <= i; ++j) den += expf(cumf[i] + src[j] - mn) * (qk[i * kTS + j] * scale);
    den += nq[i] * carry[i];
    const float ad = fabsf(den), z = fmaxf(ad, em);
    const float gz = -dyy[i] / z;
    const float ga = ad > em ? gz : (ad == em ? 0.5f * gz : 0.f);
    const float gb = ad < em ? gz : (ad == em ? 0.5f * gz : 0.f);
    rz[i] = 1.f / z;
    dden[i] = den > 0.f ? ga : (den < 0.f ? -ga : 0.f);
    dmz[i] = -gb * em;
  }
  __syncthreads();
  for (int e = tid; e < kT * kT; e += kThreads) {
    const int i = e / kT, j = e % kT;
    float r = 0.f, dqk = 0.f, wz = 0.f;
    if (i < L && j <= i) {
      const float d = expf(cumf[i] + src[j] - mn);
      const float w = d * (qk[i * kTS + j] * scale);
      const float dw = dyv[i * kTS + j] * rz[i] + dden[i];
      r = dw * w;
      dqk = dw * d * scale;
      wz = w * rz[i];
    }
    rr[i * kTS + j] = r;
    qk[i * kTS + j] = dqk;
    dyv[i * kTS + j] = wz;
  }
  __syncthreads();
  float* p2 = a.pos2 + bh * 5 * SL + t0;
  if (tid < L) {
    float row = 0.f, col = 0.f;
    for (int j = 0; j < L; ++j) row += rr[tid * kTS + j];
    for (int i = 0; i < L; ++i) col += rr[i * kTS + tid];
    rows[tid] = row;
    p2[tid] = rz[tid];
    p2[SL + tid] = dden[tid];
    p2[2 * SL + tid] = row;
    p2[3 * SL + tid] = col;
    p2[4 * SL + tid] = nq[tid];
  }
  __syncthreads();
  if (tid == 0) {
    float dm = 0.f;
    for (int i = 0; i < L; ++i) dm += dmz[i] - rows[i];
    a.dmi[bh * nc + c] = dm;
  }
  // dv, dq, dk's in-chunk terms and g's input, over tiles of P
  for (int p0 = 0; p0 < P; p0 += kT) {
    __syncthreads();
    load_rows(qs, q, a, b, h, t0, p0, L);
    load_rows(ks, k, a, b, h, t0, p0, L);
    load_rows(ys, a.dy, a, b, h, t0, p0, L);
    __syncthreads();
    float o_v[4][4], o_q[4][4], o_k[4][4];
    zero(o_v);
    zero(o_q);
    zero(o_k);
    mma_tile(o_v, dyv, 1, kTS, ys, kTS, 1, L);
    mma_tile(o_q, qk, kTS, 1, ks, kTS, 1, L);
    mma_tile(o_k, qk, 1, kTS, qs, kTS, 1, L);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, t = t0 + r;
      if (r < L && t < a.s) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = p0 + tx + 16 * j;
          if (col < P) {
            const int64_t o = (((int64_t)b * a.s + t) * a.nh + h) * P + col;
            a.dv[o] = o_v[i][j];
            a.dq[o] = o_q[i][j];
            a.dk[o] = o_k[i][j];
          }
        }
      }
    }
    if (tid < kT && p0 + tid < P) {
      float u = 0.f;
      for (int i = 0; i < L; ++i) u += carry[i] * dden[i] * qs[i * kTS + tid];
      a.un[(bh * nc + c) * P + p0 + tid] = u;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) mlstm_bwd_outer(Args a) {
  const int tiles = (a.p + kT - 1) / kT;
  const int p0 = (blockIdx.x / tiles) * kT, r0 = (blockIdx.x % tiles) * kT;
  const int c = blockIdx.y, L = a.chunk, t0 = c * L, P = a.p, SL = a.nc * L;
  const int64_t bhz = blockIdx.z, b = bhz / a.nh, h = bhz % a.nh;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  extern __shared__ float smem[];
  float* vs = smem;
  float* ks = vs + kTile;
  float* ys = ks + kTile;
  float* qs = ys + kTile;
  load_rows(vs, static_cast<const T*>(a.v), a, (int)b, (int)h, t0, p0, L);
  load_rows(ks, static_cast<const T*>(a.k), a, (int)b, (int)h, t0, r0, L);
  load_rows(ys, a.dy, a, (int)b, (int)h, t0, p0, L);
  load_rows(qs, static_cast<const T*>(a.q), a, (int)b, (int)h, t0, r0, L);
  __syncthreads();
  const float* pos = a.pos + bhz * 4 * SL + t0;
  const float* p2 = a.pos2 + bhz * 5 * SL + t0;
  for (int e = threadIdx.x; e < L * kT; e += kThreads) {
    const int j = e / kT, col = e % kT;
    vs[j * kTS + col] *= pos[2 * SL + j];           // te_j
    ys[j * kTS + col] *= pos[3 * SL + j] * p2[j];   // carry_j / Z_j
  }
  __syncthreads();
  float ac[4][4], ag[4][4];
  zero(ac);
  zero(ag);
  mma_tile(ac, vs, 1, kTS, ks, kTS, 1, L);
  mma_tile(ag, ys, 1, kTS, qs, kTS, 1, L);
  const int64_t base = (bhz * a.nc + c) * P * P;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = p0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + tx + 16 * j;
      if (p < P && r < P) {
        a.cs[base + (int64_t)p * P + r] = ac[i][j];
        a.gs[base + (int64_t)p * P + r] = ag[i][j];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) mlstm_bwd_pass(Args a) {
  const int h = blockIdx.y, b = blockIdx.z, P = a.p, nc = a.nc;
  const int64_t PP = (int64_t)P * P;
  const int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= PP + P) return;
  const int64_t bh = (int64_t)b * a.nh + h;
  const float* ci = a.cinf + bh * nc * 4;
  // kBatch chunks' values are loaded before any is stored: independent loads in flight
  if (e < PP) {
    float cv = a.C0 ? a.C0[bh * PP + e] : 0.f;
    for (int c0 = 0; c0 < nc; c0 += kBatch) {
      float s[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) s[u] = c0 + u < nc ? a.cs[(bh * nc + c0 + u) * PP + e] : 0.f;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (c0 + u < nc) {
          a.cs[(bh * nc + c0 + u) * PP + e] = cv;
          cv = ci[(c0 + u) * 4 + 2] * cv + s[u];
        }
      }
    }
    float g = a.dC ? a.dC[bh * PP + e] : 0.f;
    for (int c0 = nc - 1; c0 >= 0; c0 -= kBatch) {
      float s[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) s[u] = c0 - u >= 0 ? a.gs[(bh * nc + c0 - u) * PP + e] : 0.f;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (c0 - u >= 0) {
          a.gs[(bh * nc + c0 - u) * PP + e] = g;
          g = ci[(c0 - u) * 4 + 2] * g + s[u];
        }
      }
    }
    if (a.dC0) a.dC0[bh * PP + e] = g;
  } else {
    const int r = (int)(e - PP);
    float g = a.dn ? a.dn[bh * P + r] : 0.f;
    for (int c = nc - 1; c >= 0; --c) {
      const int64_t i = (bh * nc + c) * P + r;
      const float u = a.un[i];
      a.un[i] = g;
      g = ci[c * 4 + 2] * g + u;
    }
    if (a.dn0) a.dn0[bh * P + r] = g;
  }
}

__host__ __device__ inline int state_smem_floats() { return 8 * kTile + kT * 17 + kThreads + 2 * kT; }

template <typename T>
__global__ void __launch_bounds__(kThreads) mlstm_bwd_state(Args a) {
  const int tc = blockIdx.x, c0 = tc * kT, c = blockIdx.y, L = a.chunk, t0 = c * L, P = a.p;
  const int nc = a.nc, SL = nc * L, tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int64_t bhz = blockIdx.z, b = bhz / a.nh, h = bhz % a.nh;
  extern __shared__ float smem[];
  float* gr = smem;            // G[cols, kk]
  float* gc = gr + kTile;      // G[kk, cols]
  float* cr = gc + kTile;      // C[cols, kk]
  float* cc = cr + kTile;      // C[kk, cols]
  float* ks = cc + kTile;
  float* vs = ks + kTile;
  float* qs = vs + kTile;
  float* ys = qs + kTile;      // dy
  float* red = ys + kTile;     // (kT, 17) row partials
  float* red2 = red + kT * 17; // kThreads
  float* gt = red2 + kThreads; // g[cols]
  float* nt = gt + kT;         // n[cols]
  const int64_t mat = (bhz * nc + c) * (int64_t)P * P;
  const float* G = a.gs + mat;
  const float* Cm = a.cs + mat;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  float agk[4][4], agv[4][4], acq[4][4], acd[4][4];
  zero(agk);
  zero(agv);
  zero(acq);
  zero(acd);
  float fro = 0.f;
  for (int kk = 0; kk < P; kk += kT) {
    load_mat(gr, G, P, c0, kk);
    load_mat(gc, G, P, kk, c0);
    load_mat(cr, Cm, P, c0, kk);
    load_mat(cc, Cm, P, kk, c0);
    load_rows(ks, k, a, (int)b, (int)h, t0, kk, L);
    load_rows(vs, v, a, (int)b, (int)h, t0, kk, L);
    load_rows(qs, q, a, (int)b, (int)h, t0, kk, L);
    load_rows(ys, a.dy, a, (int)b, (int)h, t0, kk, L);
    __syncthreads();
    mma_tile(agk, ks, kTS, 1, gr, 1, kTS, kT);  // (G k_j)[cols]
    mma_tile(agv, vs, kTS, 1, gc, kTS, 1, kT);  // (G^T v_j)[cols]
    mma_tile(acq, qs, kTS, 1, cr, 1, kTS, kT);  // (C q_i)[cols]
    mma_tile(acd, ys, kTS, 1, cc, kTS, 1, kT);  // (C^T dy_i)[cols]
    for (int e = tid; e < kT * kT; e += kThreads) {
      const int i = e / kT, j = e % kT;
      fro += gr[i * kTS + j] * cr[i * kTS + j];
    }
    __syncthreads();
  }
  const float* pos = a.pos + bhz * 4 * SL + t0;
  const float* p2 = a.pos2 + bhz * 5 * SL + t0;
  for (int j = tid; j < kT; j += kThreads) {
    gt[j] = c0 + j < P ? a.un[(bhz * nc + c) * P + c0 + j] : 0.f;
    nt[j] = c0 + j < P ? a.nb[(bhz * nc + c) * P + c0 + j] : 0.f;
  }
  red2[tid] = fro;
  __syncthreads();
  float pte[4] = {0.f, 0.f, 0.f, 0.f}, pca[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, t = t0 + r;
    if (r < L && t < a.s) {
      const float te = pos[2 * SL + r], ca = pos[3 * SL + r], z = p2[r], dd = p2[SL + r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cl = tx + 16 * j, col = c0 + cl;
        if (col < P) {
          const int64_t o = (((int64_t)b * a.s + t) * a.nh + h) * P + col;
          const float vv = ld(v + o), kv = ld(k + o), dyv = a.dy[o];
          a.dv[o] += te * agk[i][j];
          a.dk[o] += te * (agv[i][j] + gt[cl]);
          a.dq[o] += ca * (z * acd[i][j] + dd * nt[cl]);
          pte[i] += vv * agk[i][j] + gt[cl] * kv;
          pca[i] += z * dyv * acq[i][j];
        }
      }
    }
  }
  // te's and carry's partials: rows summed over the 16 threads of a row, in tx order
  float* part = a.part + ((bhz * nc + c) * a.nt + tc) * 2 * kT;
#pragma unroll
  for (int i = 0; i < 4; ++i) red[(ty + 16 * i) * 17 + tx] = pte[i];
  __syncthreads();
  if (tid < kT) {
    float s = 0.f;
    for (int x = 0; x < 16; ++x) s += red[tid * 17 + x];
    part[tid] = s;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) red[(ty + 16 * i) * 17 + tx] = pca[i];
  __syncthreads();
  if (tid < kT) {
    float s = 0.f;
    for (int x = 0; x < 16; ++x) s += red[tid * 17 + x];
    part[kT + tid] = s;
  }
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    __syncthreads();
    if (tid < w) red2[tid] += red2[tid + w];
  }
  if (tid == 0) {
    float gn = 0.f;
    for (int j = 0; j < kT; ++j) gn += gt[j] * nt[j];
    a.pdec[(bhz * nc + c) * a.nt + tc] = red2[0] + gn;
  }
}

__global__ void __launch_bounds__(kThreads) mlstm_bwd_final(Args a) {
  const int h = blockIdx.x, b = blockIdx.y, L = a.chunk, nc = a.nc, SL = nc * L;
  const int64_t bh = (int64_t)b * a.nh + h;
  const float* cumf = a.pos + bh * 4 * SL;
  const float* src = cumf + SL;
  const float* te = src + SL;
  const float* carry = te + SL;
  float* p2 = a.pos2 + bh * 5 * SL;
  float* dcumf = p2 + 2 * SL;
  float* dsrc = p2 + 3 * SL;
  const float* ci = a.cinf + bh * nc * 4;
  float* cg = a.cg + bh * (nc + 1) * 4;
  // the positions' log-space terms of te and carry, a thread per position;
  // 1/Z and dden are read for the last time here, and their slots take them
  float* lte = p2;
  float* lca = p2 + SL;
  for (int t = threadIdx.x; t < SL; t += kThreads) {
    const int c = t / L, j = t % L;
    const float* pt = a.part + (bh * nc + c) * a.nt * 2 * kT;
    float dte = 0.f, dca = 0.f;
    for (int x = 0; x < a.nt; ++x) {
      dte += pt[x * 2 * kT + j];
      dca += pt[x * 2 * kT + kT + j];
    }
    dca += p2[SL + t] * p2[4 * SL + t];  // dden n.q
    lte[t] = dte * te[t];
    lca[t] = dca * carry[t];
    dsrc[t] += lte[t];
    dcumf[t] += lca[t];
  }
  __syncthreads();
  // per chunk: the gradients of m_c, m_{c-1} and cumf_L
  for (int c = threadIdx.x; c < nc; c += kThreads) {
    float ste = 0.f, sca = 0.f;
    for (int j = c * L; j < (c + 1) * L; ++j) {
      ste += lte[j];
      sca += lca[j];
    }
    float ddec = 0.f;
    for (int x = 0; x < a.nt; ++x) ddec += a.pdec[(bh * nc + c) * a.nt + x];
    const float ldec = ddec * ci[c * 4 + 2];
    cg[c * 4 + 0] = a.dmi[bh * nc + c] - ste - sca - ldec;  // m_c
    cg[c * 4 + 1] = sca + ldec;                              // m_{c-1}
    cg[c * 4 + 2] = ste + ldec;                              // cumf_L
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // stab = cummax([m0, M_0, ..., M_{nc-1}]); stab[c + 1] = m_c, stab[c] = m_{c-1} of chunk c
    float m = a.m0 ? a.m0[bh] : kNegInf;
    int idx = 0;
    for (int c = 0; c <= nc; ++c) cg[c * 4 + 3] = 0.f;
    for (int k = 0; k <= nc; ++k) {
      float d = k < nc ? cg[k * 4 + 1] : 0.f;             // as chunk k's m_{k-1}
      if (k > 0) d += cg[(k - 1) * 4 + 0];                // as chunk k-1's m_c
      if (k == nc && a.dm) d += a.dm[bh];                 // the final m
      if (k > 0 && ci[(k - 1) * 4 + 3] >= m) {
        m = ci[(k - 1) * 4 + 3];
        idx = k;
      }
      cg[idx * 4 + 3] += d;
    }
    if (a.dm0) a.dm0[bh] = cg[3];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < nc; c += kThreads) {
    const float mx = ci[c * 4 + 3], gm = cg[(c + 1) * 4 + 3];
    int cnt = 0;
    for (int j = c * L; j < (c + 1) * L; ++j) cnt += src[j] == mx;
    float acc = 0.f;
    for (int j = (c + 1) * L - 1; j >= c * L; --j) {
      float ds = dsrc[j];
      if (src[j] == mx) ds += gm / cnt;
      float dc = dcumf[j] - ds;
      if (j == (c + 1) * L - 1) dc += cg[c * 4 + 2];
      acc += dc;
      if (j < a.s) {
        const int64_t o = ((int64_t)b * a.s + j) * a.nh + h;
        a.di[o] = ds;
        // d logsigmoid(f~) / d f~ = sigmoid(-f~) = 1 - exp(logsigmoid(f~))
        a.df[o] = acc * (1.f - expf(logsigmoid(a.fg[o])));
      }
    }
  }
}

template <typename T>
int launch(const Args& a, cudaStream_t st) {
  const int intra = 4 * intra_smem_floats(), outer = 4 * 4 * kTile, state = 4 * state_smem_floats();
  cudaFuncSetAttribute(mlstm_bwd_intra<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, intra);
  cudaFuncSetAttribute(mlstm_bwd_outer<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, outer);
  cudaFuncSetAttribute(mlstm_bwd_state<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, state);
  const int tiles = (a.p + kT - 1) / kT;
  mlstm_bwd_gates<<<dim3(a.nh, a.b), kThreads, 0, st>>>(a);
  mlstm_bwd_nsum<T><<<dim3((a.p + kThreads - 1) / kThreads, a.nc, a.b * a.nh), kThreads, 0, st>>>(a);
  mlstm_bwd_intra<T><<<dim3(a.nc, a.nh, a.b), kThreads, intra, st>>>(a);
  mlstm_bwd_outer<T><<<dim3(tiles * tiles, a.nc, a.b * a.nh), kThreads, outer, st>>>(a);
  const int64_t el = (int64_t)a.p * a.p + a.p;
  mlstm_bwd_pass<<<dim3((unsigned)((el + kThreads - 1) / kThreads), a.nh, a.b), kThreads, 0, st>>>(a);
  mlstm_bwd_state<T><<<dim3(tiles, a.nc, a.b * a.nh), kThreads, state, st>>>(a);
  mlstm_bwd_final<<<dim3(a.nh, a.b), kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int rt_mlstm_scan_bwd(const void* q, const void* k, const void* v, const float* ig,
                                 const float* fg, const float* y, const float* dy, const float* C0,
                                 const float* n0, const float* m0, const float* dC, const float* dn,
                                 const float* dm, float* dq, float* dk, float* dv, float* di, float* df,
                                 float* dC0, float* dn0, float* dm0, float* pos, float* cinf, float* dnb, float* nb,
                                 float* pos2, float* dmi, float* cs, float* gs, float* un, float* part,
                                 float* pdec, float* cg, int b, int s, int nh, int p, int chunk,
                                 int is_bf16, void* stream) {
  if (b < 1 || s < 1 || nh < 1 || p < 1 || chunk < 1 || chunk > kT) return cudaErrorInvalidValue;
  const int nc = (s + chunk - 1) / chunk, nt = (p + kT - 1) / kT;
  const Args a{q, k, v, ig, fg, y, dy, C0, n0, m0, dC, dn, dm, dq, dk, dv, di, df, dC0, dn0, dm0,
               pos, cinf, dnb, nb, pos2, dmi, cs, gs, un, part, pdec, cg, b, s, nh, p, chunk, nc, nt};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(a, st) : launch<float>(a, st);
}
