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
// What bounds it: per (batch, head, chunk) about 6 L P^2 MACs (the P x P
// states' work: C_c's and G's rank-L updates, G k, G^T v, C q, C^T dnum)
// and 5 L^2 P (the in-chunk products); xlstm-1.3b (P = 1024, L = 64) is
// about 99 % the former, 51.5 GMAC a call, 0.1 ms at the bf16 tensor-core
// rate. No variant of the forward saves its states, so C before and G
// after every chunk are recomputed and pass through device memory once
// each as bf16 term planes (1 GB a call there in bf16 inputs' two terms:
// written by the walks, read twice by launch 5), about 0.6 ms at 3.35 TB/s.
// On an H100 (700 W) at that shape a bf16 call takes about 2.6 ms
// (scripts/torch_kernel_ablation.py --only scan_bwd): launch 3 0.38, the
// walks 0.87, launch 5 1.16; launch 5 moves about 3.4 GB from L2 a call
// (every block re-reads its chunk's q, k, v, dy and its panels' terms).
//
// Design: six launches, no atomics, every sum in an order fixed by the
// shape (a repeat is bitwise). The P x P work runs on mma.sync m16n8k16
// (bf16 operands, f32 sums); an operand the kernel holds in f32 (C, G,
// w_j v_j, dy) enters as bf16 terms (mma.cuh: splitn), two where q, k, v
// are bf16 (exact operands), three where they are f32 (which then enter as
// three terms too), each product keeping the pairs of terms whose orders
// sum below the operand's count, as the forward's mlstm_carry does.
//   1. mlstm_bwd_gates, a block per (head, batch): log f, cumf, src, the
//      chunk maxima and stabilizers, te, carry, decay.
//   2. mlstm_bwd_nsum, a thread per (column, chunk, head, batch): each
//      chunk's own n sum.
//   3. mlstm_bwd_intra, a block per (chunk, head, batch): n before the
//      chunk (from the earlier chunks' sums), q.k and dy.v over P in tiles
//      of 64 columns on the tensor cores, then den, Z, dnum's scale, dden
//      and the in-chunk log-space sums (f32), then dq, dk, dv's in-chunk
//      terms (dQK k, dQK^T q, (W / Z)^T dy, on the tensor cores) and g's
//      rank-L input, again over tiles of P. Its first pass over P writes
//      q, k, v and dy as bf16 term planes (rows the padded chunks'
//      positions, columns P padded to 64), the other launches' operands
//      and its own second pass's: 16-byte copies with no bounds to check.
//   4. mlstm_bwd_walk, a block per 64 x 64 tile of C (walking the chunks
//      forward) and of G (backward), the tile resident in the mma
//      accumulators: before each chunk's update it writes the tile as term
//      planes (C before chunk c, G after it), then forms the rank-L update
//      on the tensor cores (C: te_j v_j against k_j; G: carry_i / Z_i dy_i
//      against q_i) and takes decay_c. Its operands are 16-byte copies of
//      the chunk's rows of the input planes (v or dy, k or q) into a second
//      buffer under the chunk before; w_j v_j (w_j dy_j) is formed in shared
//      memory from v's (dy's) terms. The G walk ends in dC0. A few more
//      blocks walk n's gradient backward (a thread a column). No per-chunk
//      input is written and read back.
//   5. mlstm_bwd_state, a block per (64 columns of P, chunk, head x batch):
//      G k, G^T v, C q and C^T dy on the tensor cores over P in steps of 32
//      (bf16) or 16 (f32) columns, every operand a 16-byte cp.async copy
//      from the planes into a three-stage ring (the next two steps' copies
//      in flight under this step's products). ldmatrix reads a row panel's
//      tile (G[cols, kk]) as B directly and a column panel's (G[kk, cols])
//      transposed. Then dq, dk, dv's state terms and the per-column-tile
//      partials of te's, carry's and decay's gradients (<G_c, C_{c-1}> over
//      the row panel, from its terms).
//   6. mlstm_bwd_final, a block per (head, batch): those partials summed in
//      tile order, the stabilizers' routing, cumf's reverse cumsum, di~ and
//      df~.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kT = 64;         // tile: positions of a chunk, columns of P
constexpr int kTS = kT + 1;    // a tile's row stride in shared memory (f32)
constexpr int kTile = kT * kTS;
constexpr int kW = 64;         // a walk's tile of C and G, kW x kW; the planes' columns pad to kW
constexpr int kWS = kW + 8;    // row stride (bf16) of a staged tile kW wide
constexpr float kNegInf = -1e30f;

// bf16 terms of an input (q, k, v) and of an operand held in f32 (C, G,
// w_j v_j, dy), and the columns of P a step of launch 5 takes
template <typename T>
struct Cfg;
template <>
struct Cfg<bf16> {
  static constexpr int kIn = 1, kOp = 2, kKT = 32;
};
template <>
struct Cfg<float> {
  static constexpr int kIn = 3, kOp = 3, kKT = 16;
};

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
// launch 4: X's planes and Y's twice (X: v's kIn terms or dy's kOp), w_j X_j's
// terms, the state tile's terms, w_j twice
__host__ __device__ constexpr int walk_smem_bytes(int in_terms, int op_terms) {
  return 2 * kW * kWS * (4 * op_terms + 2 * in_terms) + 4 * 2 * kW;
}
// launch 5, one stage of the ring (bf16 elements): the inputs' planes
// [3 kIn + kOp][kW][kt + 8], the row panels of G and C [kOp][kW][kt + 8],
// the column panels [kOp][kt][kWS]
__host__ __device__ constexpr int state_stage_elems(int in_terms, int op_terms, int kt) {
  return (3 * in_terms + op_terms) * kW * (kt + 8) + 2 * op_terms * kW * (kt + 8) + 2 * op_terms * kt * kWS;
}
// kStages stages, then g and n over the block's columns, the rows'
// partials of 4 column groups twice, a block-wide sum
constexpr int kStages = 3;
__host__ __device__ constexpr int state_smem_bytes(int in_terms, int op_terms, int kt) {
  return kStages * 2 * state_stage_elems(in_terms, op_terms, kt) + 4 * (2 * kW + 2 * 4 * kW + kThreads);
}

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float logsigmoid(float x) { return fminf(x, 0.f) - log1pf(expf(-fabsf(x))); }

// a 16-byte copy into shared memory, zeros where !valid (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// (x0, x1)'s N bf16 terms into N planes `plane` elements apart (a 4-byte store each)
template <int N>
__device__ __forceinline__ void put_terms(bf16* at, int64_t plane, float x0, float x1) {
  uint32_t t[N];
  splitn<N>(x0, x1, t);
#pragma unroll
  for (int w = 0; w < N; ++w) *reinterpret_cast<uint32_t*>(at + w * plane) = t[w];
}

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
  bf16* cpl;          // (B, nh, nc, kOp, Pp, Pp): C before chunk c as bf16 term planes
  bf16* gpl;          // (B, nh, nc, kOp, Pp, Pp): G after chunk c
  bf16* inpl;         // (B, nh, 3 kIn + kOp, nc L, Pp): q, k, v (kIn terms each), dy (kOp)
  float* un;          // (B, nh, nc, P): g's input, then g after chunk c
  float* part;        // (B, nh, nc, nT, 2, kT): te's and carry's gradient partials
  float* pdec;        // (B, nh, nc, nT): decay's gradient partials
  float* cg;          // (B, nh, nc + 1, 4): per-chunk gradients of m_c, m_{c-1}, cumf_L, the routed max
  int b, s, nh, p, chunk, nc, nt, pp;  // pp: P padded to kW
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
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

// launch 3's shared memory: the f32 tiles q.k (then dQK), dy.v (then W / Z)
// and dW W, 10 vectors of a chunk, then bf16 term tiles [64][kWS]: q, k, v
// (kIn terms each) and dy (kOp) while q.k and dy.v are summed; dQK, W / Z
// (kOp each), q, k (kIn) and dy (kOp) while dq, dk, dv are formed
__host__ __device__ constexpr int intra_smem_bytes(int in_terms, int op_terms) {
  return 4 * (3 * kTile + 10 * kT) +
         2 * kW * kWS * (3 * in_terms + op_terms > 3 * op_terms + 2 * in_terms ? 3 * in_terms + op_terms
                                                                               : 3 * op_terms + 2 * in_terms);
}

// a pair of x's values at (row, col), (row, col + 1): one load where P is even
template <typename T>
__device__ __forceinline__ float2 ld2(const T* x, int64_t o, int col, int P) {
  if (P % 2 == 0 && col + 1 < P) {
    if constexpr (sizeof(T) == 2) {
      const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(x + o);
      return make_float2(__low2float(v), __high2float(v));
    } else {
      return *reinterpret_cast<const float2*>(x + o);
    }
  }
  return make_float2(col < P ? ld(x + o) : 0.f, col + 1 < P ? ld(x + o + 1) : 0.f);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) mlstm_bwd_intra(Args a) {
  using CF = Cfg<T>;
  constexpr int kIn = CF::kIn, kOp = CF::kOp, kNpl = 3 * kIn + kOp, kTw = kW * kWS;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, L = a.chunk, P = a.p, t0 = c * L;
  const int nc = a.nc, SL = nc * L, S = a.s, tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int g = lane >> 2, t4 = lane & 3, wm = warp & 3, wn = warp >> 2;
  const int64_t bh = (int64_t)b * a.nh + h;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qk = reinterpret_cast<float*>(smem_raw);  // q.k, then dQK
  float* dyv = qk + kTile;   // dy.v, then W / Z
  float* rr = dyv + kTile;   // dW W
  float* cumf = rr + kTile;
  float* src = cumf + kT;
  float* carry = src + kT;
  float* nbt = carry + kT;
  float* nq = nbt + kT;
  float* dyy = nq + kT;
  float* rz = dyy + kT;
  float* dden = rz + kT;
  float* dmz = dden + kT;
  float* rows = dmz + kT;
  bf16* tb = reinterpret_cast<bf16*>(rows + kT);
  bf16* qA = tb;               // [kIn][kW][kWS]
  bf16* kA = qA + kIn * kTw;   // [kIn]
  bf16* vA = kA + kIn * kTw;   // [kIn]
  bf16* dyA = vA + kIn * kTw;  // [kOp]
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
  const int64_t plane = (int64_t)SL * a.pp;
  bf16* pl = a.inpl + bh * kNpl * plane + (int64_t)t0 * a.pp;  // the chunk's first row
  // q.k and dy.v on the tensor cores, warp = (rows 16 wm, columns 32 wn) of
  // the 64 x 64; each tile of 64 columns summed apart, then added to these
  // in f32 (the tensor cores' f32 sums are not rounded to nearest: a sum
  // over all of P in one chain drifts)
  float aqk[4][4] = {}, adv[4][4] = {};
  // n.q and dy.y: thread pair u's row (tid / 32 + 8 u) partials over the columns
  constexpr int kPr = kW * kW / 2 / kThreads;
  float nqr[kPr] = {}, dyr[kPr] = {};
  for (int p0 = 0; p0 < P; p0 += kT) {
    // n before this chunk, from n0 and the earlier chunks' own sums (8
    // chunks' loads in flight at once); kept for mlstm_bwd_state
    for (int j = tid; j < kT; j += kThreads) {
      float nv = 0.f;
      if (p0 + j < P) {
        nv = a.n0 ? a.n0[bh * P + p0 + j] : 0.f;
        for (int cb = 0; cb < c; cb += 8) {
          float dec[8], own[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int cc = cb + u;
            dec[u] = cc < c ? a.cinf[(bh * nc + cc) * 4 + 2] : 1.f;
            own[u] = cc < c ? a.dnb[(bh * nc + cc) * P + p0 + j] : 0.f;
          }
#pragma unroll
          for (int u = 0; u < 8; ++u)
            if (cb + u < c) nv = dec[u] * nv + own[u];
        }
        a.nb[(bh * nc + c) * P + p0 + j] = nv;
      }
      nbt[j] = nv;
    }
    __syncthreads();  // nbt is whole; the term tiles are free
    // the chunk's rows of q, k, v and dy at these 64 columns as bf16 terms,
    // into shared memory and the planes (launches 4 and 5's operands)
#pragma unroll
    for (int u = 0; u < kPr; ++u) {
      const int i = (tid >> 5) + 8 * u, pc = 2 * (tid & 31), t = t0 + i, col = p0 + pc;
      float2 xq = make_float2(0.f, 0.f), xk = xq, xv = xq, xy = xq, xo = xq;
      if (i < L && t < S) {
        const int64_t o = (((int64_t)b * S + t) * a.nh + h) * P + col;
        xq = ld2(q, o, col, P);
        xk = ld2(k, o, col, P);
        xv = ld2(v, o, col, P);
        xy = ld2(a.dy, o, col, P);
        xo = ld2(a.y, o, col, P);
      }
      nqr[u] += nbt[pc] * xq.x + nbt[pc + 1] * xq.y;
      dyr[u] += xy.x * xo.x + xy.y * xo.y;
      if (i < L) {
        uint32_t tq[kIn], tk[kIn], tv[kIn], ty[kOp];
        splitn<kIn>(xq.x, xq.y, tq);
        splitn<kIn>(xk.x, xk.y, tk);
        splitn<kIn>(xv.x, xv.y, tv);
        splitn<kOp>(xy.x, xy.y, ty);
        bf16* at = pl + (int64_t)i * a.pp + col;
        const int so = i * kWS + pc;
#pragma unroll
        for (int w = 0; w < kIn; ++w) {
          *reinterpret_cast<uint32_t*>(qA + w * kTw + so) = tq[w];
          *reinterpret_cast<uint32_t*>(kA + w * kTw + so) = tk[w];
          *reinterpret_cast<uint32_t*>(vA + w * kTw + so) = tv[w];
          *reinterpret_cast<uint32_t*>(at + w * plane) = tq[w];
          *reinterpret_cast<uint32_t*>(at + (kIn + w) * plane) = tk[w];
          *reinterpret_cast<uint32_t*>(at + (2 * kIn + w) * plane) = tv[w];
        }
#pragma unroll
        for (int w = 0; w < kOp; ++w) {
          *reinterpret_cast<uint32_t*>(dyA + w * kTw + so) = ty[w];
          *reinterpret_cast<uint32_t*>(at + (3 * kIn + w) * plane) = ty[w];
        }
      } else {
        const int so = i * kWS + pc;
#pragma unroll
        for (int w = 0; w < kIn; ++w) {
          *reinterpret_cast<uint32_t*>(qA + w * kTw + so) = 0u;
          *reinterpret_cast<uint32_t*>(kA + w * kTw + so) = 0u;
          *reinterpret_cast<uint32_t*>(vA + w * kTw + so) = 0u;
        }
#pragma unroll
        for (int w = 0; w < kOp; ++w) *reinterpret_cast<uint32_t*>(dyA + w * kTw + so) = 0u;
      }
    }
    __syncthreads();
    // q.k += q k^T, dy.v += dy v^T over these columns; a pair of terms kept
    // where their orders sum below kOp
    float tqk[4][4] = {}, tdv[4][4] = {};
#pragma unroll
    for (int kb = 0; kb < kT; kb += 16) {
      uint32_t fa[kOp][4], fb[kOp][2][4];
#pragma unroll
      for (int ta = 0; ta < kIn; ++ta) ldsm4(fa[ta], qA + ta * kTw + (wm * 16 + row_a(lane)) * kWS + kb + col_a(lane));
#pragma unroll
      for (int tb2 = 0; tb2 < kIn; ++tb2)
#pragma unroll
        for (int np = 0; np < 2; ++np)
          ldsm4(fb[tb2][np], kA + tb2 * kTw + (wn * 32 + np * 16 + row_b(lane)) * kWS + kb + col_b(lane));
#pragma unroll
      for (int ta = 0; ta < kIn; ++ta)
#pragma unroll
        for (int tb2 = 0; tb2 < kIn; ++tb2) {
          if (ta + tb2 >= kOp) continue;
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            mma(tqk[2 * np], fa[ta], fb[tb2][np][0], fb[tb2][np][1]);
            mma(tqk[2 * np + 1], fa[ta], fb[tb2][np][2], fb[tb2][np][3]);
          }
        }
#pragma unroll
      for (int ta = 0; ta < kOp; ++ta) ldsm4(fa[ta], dyA + ta * kTw + (wm * 16 + row_a(lane)) * kWS + kb + col_a(lane));
#pragma unroll
      for (int tb2 = 0; tb2 < kIn; ++tb2)
#pragma unroll
        for (int np = 0; np < 2; ++np)
          ldsm4(fb[tb2][np], vA + tb2 * kTw + (wn * 32 + np * 16 + row_b(lane)) * kWS + kb + col_b(lane));
#pragma unroll
      for (int ta = 0; ta < kOp; ++ta)
#pragma unroll
        for (int tb2 = 0; tb2 < kIn; ++tb2) {
          if (ta + tb2 >= kOp) continue;
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            mma(tdv[2 * np], fa[ta], fb[tb2][np][0], fb[tb2][np][1]);
            mma(tdv[2 * np + 1], fa[ta], fb[tb2][np][2], fb[tb2][np][3]);
          }
        }
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        aqk[nt][e] += tqk[nt][e];
        adv[nt][e] += tdv[nt][e];
      }
  }
  // the sums into their f32 tiles; n.q and dy.y of each row over the warp's lanes
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = wm * 16 + g + 8 * (e >> 1), j = wn * 32 + nt * 8 + 2 * t4 + (e & 1);
      qk[i * kTS + j] = aqk[nt][e];
      dyv[i * kTS + j] = adv[nt][e];
    }
#pragma unroll
  for (int u = 0; u < kPr; ++u) {
    const float x = warp_sum(nqr[u]), y = warp_sum(dyr[u]);
    if (lane == 0) {
      nq[(tid >> 5) + 8 * u] = x;
      dyy[(tid >> 5) + 8 * u] = y;
    }
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
  // dQK and W / Z as bf16 terms for the products below
  bf16* dqkT = tb;                 // [kOp][kW][kWS], rows i, columns j
  bf16* wzT = dqkT + kOp * kTw;    // [kOp]
  bf16* qC = wzT + kOp * kTw;      // [kIn]: q, rows i, columns p
  bf16* kC = qC + kIn * kTw;       // [kIn]
  bf16* dyC = kC + kIn * kTw;      // [kOp]
  for (int e = tid; e < kT * kT / 2; e += kThreads) {
    const int i = e / (kT / 2), j = 2 * (e % (kT / 2));
    uint32_t ta[kOp], tw[kOp];
    splitn<kOp>(qk[i * kTS + j], qk[i * kTS + j + 1], ta);
    splitn<kOp>(dyv[i * kTS + j], dyv[i * kTS + j + 1], tw);
#pragma unroll
    for (int w = 0; w < kOp; ++w) {
      *reinterpret_cast<uint32_t*>(dqkT + w * kTw + i * kWS + j) = ta[w];
      *reinterpret_cast<uint32_t*>(wzT + w * kTw + i * kWS + j) = tw[w];
    }
  }
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
  // dv, dq, dk's in-chunk terms and g's input over tiles of P, on the tensor
  // cores: dv = (W / Z)^T dy, dq = dQK k, dk = dQK^T q; q, k and dy the
  // planes' tiles just written, 16-byte copies
  const int lp = cdiv(L, 16) * 16;
  for (int p0 = 0; p0 < P; p0 += kT) {
    __syncthreads();  // the last tile's products are done with qC, kC, dyC
    constexpr int kCopies = (2 * kIn + kOp) * kW * (kW / 8);
    for (int e = tid; e < kCopies; e += kThreads) {
      const int w = e / (kW * kW / 8), j = (e / (kW / 8)) % kW, ch = e % (kW / 8);
      const bool in = j < L;
      // planes q (0..kIn), k (kIn..2 kIn), dy (3 kIn..); shared tiles qC, kC, dyC in a row
      const int plane_ix = w < 2 * kIn ? w : w + kIn;
      cp_async16(qC + (w * kW + j) * kWS + ch * 8, pl + plane_ix * plane + (int64_t)(in ? j : 0) * a.pp + p0 + ch * 8,
                 in);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float ov[4][4] = {}, oq[4][4] = {}, ok[4][4] = {};
    for (int kb = 0; kb < lp; kb += 16) {
      uint32_t fa[kOp][4], fb[kOp][2][4];
      // dv: A[j][i] = (W / Z)[i][j] (stored K x M), B = dy[i][p]
#pragma unroll
      for (int ta = 0; ta < kOp; ++ta) ldsm4t(fa[ta], wzT + ta * kTw + (kb + row_b(lane)) * kWS + wm * 16 + col_b(lane));
#pragma unroll
      for (int tb2 = 0; tb2 < kOp; ++tb2)
#pragma unroll
        for (int np = 0; np < 2; ++np)
          ldsm4t(fb[tb2][np], dyC + tb2 * kTw + (kb + row_a(lane)) * kWS + wn * 32 + np * 16 + col_a(lane));
#pragma unroll
      for (int ta = 0; ta < kOp; ++ta)
#pragma unroll
        for (int tb2 = 0; tb2 < kOp; ++tb2) {
          if (ta + tb2 >= kOp) continue;
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            mma(ov[2 * np], fa[ta], fb[tb2][np][0], fb[tb2][np][1]);
            mma(ov[2 * np + 1], fa[ta], fb[tb2][np][2], fb[tb2][np][3]);
          }
        }
      // dq: A = dQK[i][j], B = k[j][p]
#pragma unroll
      for (int ta = 0; ta < kOp; ++ta) ldsm4(fa[ta], dqkT + ta * kTw + (wm * 16 + row_a(lane)) * kWS + kb + col_a(lane));
#pragma unroll
      for (int tb2 = 0; tb2 < kIn; ++tb2)
#pragma unroll
        for (int np = 0; np < 2; ++np)
          ldsm4t(fb[tb2][np], kC + tb2 * kTw + (kb + row_a(lane)) * kWS + wn * 32 + np * 16 + col_a(lane));
#pragma unroll
      for (int ta = 0; ta < kOp; ++ta)
#pragma unroll
        for (int tb2 = 0; tb2 < kIn; ++tb2) {
          if (ta + tb2 >= kOp) continue;
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            mma(oq[2 * np], fa[ta], fb[tb2][np][0], fb[tb2][np][1]);
            mma(oq[2 * np + 1], fa[ta], fb[tb2][np][2], fb[tb2][np][3]);
          }
        }
      // dk: A[j][i] = dQK[i][j] (stored K x M), B = q[i][p]
#pragma unroll
      for (int ta = 0; ta < kOp; ++ta) ldsm4t(fa[ta], dqkT + ta * kTw + (kb + row_b(lane)) * kWS + wm * 16 + col_b(lane));
#pragma unroll
      for (int tb2 = 0; tb2 < kIn; ++tb2)
#pragma unroll
        for (int np = 0; np < 2; ++np)
          ldsm4t(fb[tb2][np], qC + tb2 * kTw + (kb + row_a(lane)) * kWS + wn * 32 + np * 16 + col_a(lane));
#pragma unroll
      for (int ta = 0; ta < kOp; ++ta)
#pragma unroll
        for (int tb2 = 0; tb2 < kIn; ++tb2) {
          if (ta + tb2 >= kOp) continue;
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            mma(ok[2 * np], fa[ta], fb[tb2][np][0], fb[tb2][np][1]);
            mma(ok[2 * np + 1], fa[ta], fb[tb2][np][2], fb[tb2][np][3]);
          }
        }
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int r = wm * 16 + g + 8 * h2, t = t0 + r, col = p0 + wn * 32 + nt * 8 + 2 * t4;
        if (r < L && t < S && col < P) {
          const int64_t o = (((int64_t)b * S + t) * a.nh + h) * P + col;
          if (P % 2 == 0) {
            *reinterpret_cast<float2*>(a.dv + o) = make_float2(ov[nt][2 * h2], ov[nt][2 * h2 + 1]);
            *reinterpret_cast<float2*>(a.dq + o) = make_float2(oq[nt][2 * h2], oq[nt][2 * h2 + 1]);
            *reinterpret_cast<float2*>(a.dk + o) = make_float2(ok[nt][2 * h2], ok[nt][2 * h2 + 1]);
          } else {
            a.dv[o] = ov[nt][2 * h2], a.dq[o] = oq[nt][2 * h2], a.dk[o] = ok[nt][2 * h2];
            if (col + 1 < P) a.dv[o + 1] = ov[nt][2 * h2 + 1], a.dq[o + 1] = oq[nt][2 * h2 + 1], a.dk[o + 1] = ok[nt][2 * h2 + 1];
          }
        }
      }
    if (tid < kT && p0 + tid < P) {
      float u = 0.f;
      for (int i = 0; i < L; ++i) {
        float qv = 0.f;
#pragma unroll
        for (int w = 0; w < kIn; ++w) qv += __bfloat162float(qC[w * kTw + i * kWS + tid]);
        u += carry[i] * dden[i] * qv;
      }
      a.un[(bh * nc + c) * P + p0 + tid] = u;
    }
  }
}

// Launch 4. Blocks [0, tiles^2) walk C forward, [tiles^2, 2 tiles^2) walk G
// backward, a 64 x 64 tile each (rows p, the value index: v's or dy's;
// columns r, the key index: k's or q's); the rest walk n's gradient.
template <typename T>
__global__ void __launch_bounds__(kThreads) mlstm_bwd_walk(Args a) {
  using CF = Cfg<T>;
  constexpr int kIn = CF::kIn, kOp = CF::kOp, kNpl = 3 * kIn + kOp;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Xr = reinterpret_cast<bf16*>(smem_raw);  // [2][kOp][kW][kWS]: X_j[p]'s planes (v or dy), rows j
  bf16* Ys = Xr + 2 * kOp * kW * kWS;             // [2][kIn][kW][kWS]: k_j[r] or q_j[r], rows j
  bf16* Xs = Ys + 2 * kIn * kW * kWS;             // [kOp][kW][kWS]: w_j X_j[p] as terms, rows j
  bf16* Os = Xs + kOp * kW * kWS;                 // [kOp][kW][kWS]: the state tile's terms, rows p
  float* wsm = reinterpret_cast<float*>(Os + kOp * kW * kWS);  // [2][kW]: w_j
  const int P = a.p, Pp = a.pp, L = a.chunk, nc = a.nc, SL = nc * L, S = a.s;
  const int tiles = Pp / kW, ntile = tiles * tiles, bx = blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int64_t bh = (int64_t)b * a.nh + h;
  const float* ci = a.cinf + bh * nc * 4;
  if (bx >= 2 * ntile) {
    // n's gradient backward: g after each chunk replaces its input in un; dn0
    const int r = (bx - 2 * ntile) * kThreads + tid;
    if (r < P) {
      float g = a.dn ? a.dn[bh * P + r] : 0.f;
      for (int c = nc - 1; c >= 0; --c) {
        const int64_t i = (bh * nc + c) * P + r;
        const float u = a.un[i];
        a.un[i] = g;
        g = ci[c * 4 + 2] * g + u;
      }
      if (a.dn0) a.dn0[bh * P + r] = g;
    }
    return;
  }
  const bool gw = bx >= ntile;  // the G walk, else the C walk
  const int tix = gw ? bx - ntile : bx;
  const int p0 = (tix / tiles) * kW, r0 = (tix % tiles) * kW;
  const int g = lane >> 2, t4 = lane & 3, wm = warp & 3, wn = warp >> 2;
  const float* pos = a.pos + bh * 4 * SL;
  const float* p2 = a.pos2 + bh * 5 * SL;
  const int64_t plane = (int64_t)SL * Pp, mat = (int64_t)Pp * Pp;
  const bf16* inb = a.inpl + bh * kNpl * plane;
  const bf16* ypl = inb + (gw ? 0 : kIn) * plane;       // q's planes (G), k's (C)
  const bf16* xpl = inb + (gw ? 3 * kIn : 2 * kIn) * plane;  // dy's planes (G), v's (C)
  const int xterms = gw ? kOp : kIn;
  bf16* outp = (gw ? a.gpl : a.cpl) + bh * nc * kOp * mat;
  // the tile in the accumulators: rows p0 + 16 wm + g (+8), columns r0 + 32 wn + 8 nt + 2 t4 (+1)
  float acc[4][4];
  const float* init = gw ? a.dC : a.C0;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = p0 + wm * 16 + g + 8 * (e >> 1), col = r0 + wn * 32 + nt * 8 + 2 * t4 + (e & 1);
      acc[nt][e] = (init && row < P && col < P) ? init[(bh * P + row) * P + col] : 0.f;
    }
  const int lp = cdiv(L, 16) * 16;
  // a chunk's rows of X's and Y's planes, 16-byte copies into buffer buf
  auto fetch = [&](int c, int buf) {
    const int64_t row0 = (int64_t)c * L;
    for (int e = tid; e < (kOp + kIn) * kW * (kW / 8); e += kThreads) {
      const int w = e / (kW * kW / 8), j = (e / (kW / 8)) % kW, ch = e % (kW / 8);
      const bool in = j < L;
      const int64_t off = (row0 + (in ? j : 0)) * Pp + ch * 8;
      if (w < kOp) {
        if (w < xterms)
          cp_async16(Xr + ((buf * kOp + w) * kW + j) * kWS + ch * 8, xpl + w * plane + off + p0, in);
      } else {
        const int wy = w - kOp;
        cp_async16(Ys + ((buf * kIn + wy) * kW + j) * kWS + ch * 8, ypl + wy * plane + off + r0, in);
      }
    }
    cp_async_commit();
  };
  // w_j: te_j (C) or carry_j / Z_j (G), thread j's, loaded a chunk ahead
  auto weight = [&](int c) -> float {
    const int t = c * L + tid;
    if (tid >= L || t >= S) return 0.f;
    return gw ? pos[3 * SL + t] * p2[t] : pos[2 * SL + t];
  };
  fetch(gw ? nc - 1 : 0, 0);
  float wreg = tid < kW ? weight(gw ? nc - 1 : 0) : 0.f;
  for (int it = 0; it < nc; ++it) {
    const int c = gw ? nc - 1 - it : it, buf = it & 1;
    // the state before chunk c (C) or after it (G) as terms
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        uint32_t tt[kOp];
        splitn<kOp>(acc[nt][2 * h2], acc[nt][2 * h2 + 1], tt);
        const int row = wm * 16 + g + 8 * h2, col = wn * 32 + nt * 8 + 2 * t4;
#pragma unroll
        for (int w = 0; w < kOp; ++w) *reinterpret_cast<uint32_t*>(Os + (w * kW + row) * kWS + col) = tt[w];
      }
    if (tid < kW) wsm[buf * kW + tid] = wreg;
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < nc) {  // the next chunk's operands, in flight under this chunk's stores and products
      const int cn = gw ? c - 1 : c + 1;
      fetch(cn, buf ^ 1);
      if (tid < kW) wreg = weight(cn);
    }
    // X's planes summed, times w_j, as terms: w_j X_j
    for (int e = tid; e < kW * (kW / 2); e += kThreads) {
      const int j = e / (kW / 2), pc = 2 * (e % (kW / 2));
      float x0 = 0.f, x1 = 0.f;
#pragma unroll
      for (int w = 0; w < kOp; ++w) {
        if (w < xterms) {
          const __nv_bfloat162 v2 = *reinterpret_cast<const __nv_bfloat162*>(Xr + ((buf * kOp + w) * kW + j) * kWS + pc);
          x0 += __low2float(v2);
          x1 += __high2float(v2);
        }
      }
      const float wj = wsm[buf * kW + j];
      uint32_t tt[kOp];
      splitn<kOp>(wj * x0, wj * x1, tt);
#pragma unroll
      for (int w = 0; w < kOp; ++w) *reinterpret_cast<uint32_t*>(Xs + (w * kW + j) * kWS + pc) = tt[w];
    }
    // the tile's terms into slot c of the planes, 16 bytes a store
    for (int e = tid; e < kOp * kW * (kW / 8); e += kThreads) {
      const int w = e / (kW * kW / 8), row = (e / (kW / 8)) % kW, ch = e % (kW / 8);
      *reinterpret_cast<uint4*>(outp + ((int64_t)c * kOp + w) * mat + (int64_t)(p0 + row) * Pp + r0 + ch * 8) =
          *reinterpret_cast<const uint4*>(Os + (w * kW + row) * kWS + ch * 8);
    }
    __syncthreads();
    // state <- decay_c state + sum_j (w_j X_j) Y_j^T over the chunk's rows
    const float decay = ci[c * 4 + 2];
    const bf16* Yb = Ys + buf * kIn * kW * kWS;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] *= decay;
    for (int kb = 0; kb < lp; kb += 16) {
      uint32_t xa[kOp][4], yb[kIn][2][4];
#pragma unroll
      for (int tx = 0; tx < kOp; ++tx)
        ldsm4t(xa[tx], Xs + (tx * kW + kb + row_b(lane)) * kWS + wm * 16 + col_b(lane));
#pragma unroll
      for (int ty = 0; ty < kIn; ++ty)
#pragma unroll
        for (int np = 0; np < 2; ++np)
          ldsm4t(yb[ty][np], Yb + (ty * kW + kb + row_a(lane)) * kWS + wn * 32 + np * 16 + col_a(lane));
#pragma unroll
      for (int tx = 0; tx < kOp; ++tx)
#pragma unroll
        for (int ty = 0; ty < kIn; ++ty) {
          if (tx + ty >= kOp) continue;
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            mma(acc[2 * np], xa[tx], yb[ty][np][0], yb[ty][np][1]);
            mma(acc[2 * np + 1], xa[tx], yb[ty][np][2], yb[ty][np][3]);
          }
        }
    }
  }
  if (gw && a.dC0) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = p0 + wm * 16 + g + 8 * (e >> 1), col = r0 + wn * 32 + nt * 8 + 2 * t4 + (e & 1);
        if (row < P && col < P) a.dC0[(bh * P + row) * P + col] = acc[nt][e];
      }
  }
}

// Launch 5: G k, G^T v, C q and C^T dy for the block's 64 columns of P over
// the chunk's positions, then the gradients' state terms and the partials.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) mlstm_bwd_state(Args a) {
  using CF = Cfg<T>;
  constexpr int kIn = CF::kIn, kOp = CF::kOp, kKT = CF::kKT, kSt = kKT + 8, kNpl = 3 * kIn + kOp;
  constexpr int kStage = state_stage_elems(kIn, kOp, kKT);
  constexpr int kCh = kKT / 8;  // 16-byte copies a row of a step's columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* stg = reinterpret_cast<bf16*>(smem_raw);
  float* gt = reinterpret_cast<float*>(stg + kStages * kStage);  // [kW] g after the chunk
  float* ntc = gt + kW;                                    // [kW] n before the chunk
  float* rte = ntc + kW;                                   // [4][kW] te's row partials by column group
  float* rca = rte + 4 * kW;                               // [4][kW] carry's
  float* red = rca + 4 * kW;                               // [kThreads]
  const int tc = blockIdx.x, c0 = tc * kW, c = blockIdx.y, L = a.chunk, t0 = c * L, P = a.p, Pp = a.pp;
  const int nc = a.nc, SL = nc * L, S = a.s, tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int g = lane >> 2, t4 = lane & 3, wm = warp & 1, wn = warp >> 1;
  const int64_t bhz = blockIdx.z, b = bhz / a.nh, h = bhz % a.nh;
  const int64_t plane = (int64_t)SL * Pp, mat = (int64_t)Pp * Pp;
  const bf16* inp = a.inpl + bhz * kNpl * plane + (int64_t)t0 * Pp;  // the chunk's first row
  const bf16* Gm = a.gpl + (bhz * nc + c) * kOp * mat;
  const bf16* Cm = a.cpl + (bhz * nc + c) * kOp * mat;
  // a stage: the inputs' planes [kNpl][kW][kSt] (q, k, v, dy; rows the
  // chunk's positions, columns kk), the row panels G[c0 + i][kk] and C as
  // [kOp][kW][kSt], the column panels G[kk][c0 + j] and C as [kOp][kKT][kWS]
  auto in_of = [&](int s) { return stg + s * kStage; };
  auto grow_of = [&](int s) { return in_of(s) + kNpl * kW * kSt; };
  auto crow_of = [&](int s) { return grow_of(s) + kOp * kW * kSt; };
  auto gcol_of = [&](int s) { return crow_of(s) + kOp * kW * kSt; };
  auto ccol_of = [&](int s) { return gcol_of(s) + kOp * kKT * kWS; };
  auto load = [&](int kt, int s) {
    const int kk0 = kt * kKT;
    bf16* in = in_of(s);
    for (int e = tid; e < kNpl * kW * kCh; e += kThreads) {
      const int pl = e / (kW * kCh), j = (e / kCh) % kW, ch = e % kCh;
      const bool ok = j < L;
      cp_async16(in + (pl * kW + j) * kSt + ch * 8, inp + pl * plane + (int64_t)(ok ? j : 0) * Pp + kk0 + ch * 8, ok);
    }
    bf16* grow = grow_of(s);
    bf16* crow = crow_of(s);
    for (int e = tid; e < kOp * kW * kCh; e += kThreads) {
      const int w = e / (kW * kCh), i = (e / kCh) % kW, ch = e % kCh;
      const int64_t o = w * mat + (int64_t)(c0 + i) * Pp + kk0 + ch * 8;
      cp_async16(grow + (w * kW + i) * kSt + ch * 8, Gm + o, true);
      cp_async16(crow + (w * kW + i) * kSt + ch * 8, Cm + o, true);
    }
    bf16* gcol = gcol_of(s);
    bf16* ccol = ccol_of(s);
    for (int e = tid; e < kOp * kKT * (kW / 8); e += kThreads) {
      const int w = e / (kKT * (kW / 8)), kr = (e / (kW / 8)) % kKT, ch = e % (kW / 8);
      const int64_t o = w * mat + (int64_t)(kk0 + kr) * Pp + c0 + ch * 8;
      cp_async16(gcol + (w * kKT + kr) * kWS + ch * 8, Gm + o, true);
      cp_async16(ccol + (w * kKT + kr) * kWS + ch * 8, Cm + o, true);
    }
    cp_async_commit();
  };
  // [G k, G^T v, C q, C^T dy][row tile][column tile][fragment]: rows (the
  // chunk's positions) 32 wm + 16 mi + g (+8), columns 16 wn + 8 nt + 2 t4 (+1)
  float acc[4][2][2][4] = {};
  float fro = 0.f;
  const int nkt = Pp / kKT;
  for (int kt = 0; kt + 1 < kStages; ++kt) {
    if (kt < nkt)
      load(kt, kt);
    else
      cp_async_commit();  // an empty group: one group a step
  }
  for (int kt = 0; kt < nkt; ++kt) {
    const int s = kt % kStages, ahead = kt + kStages - 1;
    if (ahead < nkt)
      load(ahead, ahead % kStages);  // in flight under the next steps' products
    else
      cp_async_commit();
    cp_async_wait<kStages - 1>();  // step kt's copies have landed
    __syncthreads();
    const bf16* in = in_of(s);
    const bf16* grow = grow_of(s);
    const bf16* crow = crow_of(s);
    const bf16* gcol = gcol_of(s);
    const bf16* ccol = ccol_of(s);
    // <G_c, C_{c-1}> over the row panels, from their terms, two columns at a time
    for (int e = tid; e < kW * kKT / 2; e += kThreads) {
      const int i = e / (kKT / 2), kk = 2 * (e % (kKT / 2));
      float g0 = 0.f, g1 = 0.f, c0v = 0.f, c1v = 0.f;
#pragma unroll
      for (int w = 0; w < kOp; ++w) {
        const __nv_bfloat162 gp = *reinterpret_cast<const __nv_bfloat162*>(grow + (w * kW + i) * kSt + kk);
        const __nv_bfloat162 cp = *reinterpret_cast<const __nv_bfloat162*>(crow + (w * kW + i) * kSt + kk);
        g0 += __low2float(gp);
        g1 += __high2float(gp);
        c0v += __low2float(cp);
        c1v += __high2float(cp);
      }
      fro += g0 * c0v + g1 * c1v;
    }
    // the four products, each with its operands' fragments loaded just before
    // it; A the inputs' rows (m16 x k16 of [rows][kk]), B a row panel (read as
    // N x K) or a column panel (K x N, transposed); a pair of terms kept where
    // their orders sum below kOp
    auto product = [&](float (&d)[2][2][4], int a_plane, int a_terms, const bf16* bp, bool col_panel) {
      for (int kb = 0; kb < kKT; kb += 16) {
        uint32_t bfr[kOp][4];
#pragma unroll
        for (int w = 0; w < kOp; ++w) {
          if (col_panel)
            ldsm4t(bfr[w], bp + (w * kKT + kb + row_a(lane)) * kWS + wn * 16 + col_a(lane));
          else
            ldsm4(bfr[w], bp + (w * kW + wn * 16 + row_b(lane)) * kSt + kb + col_b(lane));
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          uint32_t afr[kOp][4];
#pragma unroll
          for (int ta = 0; ta < kOp; ++ta)
            if (ta < a_terms)
              ldsm4(afr[ta], in + ((a_plane + ta) * kW + wm * 32 + mi * 16 + row_a(lane)) * kSt + kb + col_a(lane));
#pragma unroll
          for (int ta = 0; ta < kOp; ++ta)
#pragma unroll
            for (int w = 0; w < kOp; ++w) {
              if (ta >= a_terms || ta + w >= kOp) continue;
              mma(d[mi][0], afr[ta], bfr[w][0], bfr[w][1]);
              mma(d[mi][1], afr[ta], bfr[w][2], bfr[w][3]);
            }
        }
      }
    };
    product(acc[0], kIn, kIn, grow, false);       // G k
    product(acc[1], 2 * kIn, kIn, gcol, true);    // G^T v
    product(acc[2], 0, kIn, crow, false);         // C q
    product(acc[3], 3 * kIn, kOp, ccol, true);    // C^T dy
    __syncthreads();  // the stage is rewritten by the copies of step kt + kStages
  }
  for (int j = tid; j < kW; j += kThreads) {
    const int col = c0 + j;
    gt[j] = col < P ? a.un[(bhz * nc + c) * P + col] : 0.f;
    ntc[j] = col < P ? a.nb[(bhz * nc + c) * P + col] : 0.f;
  }
  red[tid] = fro;
  __syncthreads();
  const float* pos = a.pos + bhz * 4 * SL + t0;
  const float* p2 = a.pos2 + bhz * 5 * SL + t0;
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  float pte[2][2] = {}, pca[2][2] = {};  // [mi][h2]: row 32 wm + 16 mi + g + 8 h2
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int i = wm * 32 + mi * 16 + g + 8 * h2, t = t0 + i;
      if (i < L && t < S) {
        const float te = pos[2 * SL + i], ca = pos[3 * SL + i], z = p2[i], dd = p2[SL + i];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          // the pair of columns col, col + 1: 8-byte accesses where P is even
          const int cl = wn * 16 + nt * 8 + 2 * t4, col = c0 + cl;
          if (col < P) {
            const int64_t o = ((b * S + t) * a.nh + h) * P + col;
            const int n2 = col + 1 < P ? 2 : 1;
            const bool pair = n2 == 2 && P % 2 == 0;
            float vv[2] = {0.f, 0.f}, kv[2] = {0.f, 0.f}, dyv[2] = {0.f, 0.f};
            float dvv[2] = {0.f, 0.f}, dkv[2] = {0.f, 0.f}, dqv[2] = {0.f, 0.f};
            if (pair) {
              const float2 y2 = *reinterpret_cast<const float2*>(a.dy + o);
              const float2 v2 = *reinterpret_cast<const float2*>(a.dv + o);
              const float2 k2 = *reinterpret_cast<const float2*>(a.dk + o);
              const float2 q2 = *reinterpret_cast<const float2*>(a.dq + o);
              dyv[0] = y2.x, dyv[1] = y2.y, dvv[0] = v2.x, dvv[1] = v2.y;
              dkv[0] = k2.x, dkv[1] = k2.y, dqv[0] = q2.x, dqv[1] = q2.y;
              vv[0] = ld(v + o), vv[1] = ld(v + o + 1), kv[0] = ld(k + o), kv[1] = ld(k + o + 1);
            } else {
              for (int e2 = 0; e2 < n2; ++e2) {
                dyv[e2] = a.dy[o + e2], dvv[e2] = a.dv[o + e2], dkv[e2] = a.dk[o + e2];
                dqv[e2] = a.dq[o + e2], vv[e2] = ld(v + o + e2), kv[e2] = ld(k + o + e2);
              }
            }
#pragma unroll
            for (int e2 = 0; e2 < 2; ++e2) {
              if (e2 < n2) {
                const int f = 2 * h2 + e2;
                const float gk = acc[0][mi][nt][f], gtv = acc[1][mi][nt][f];
                const float cq = acc[2][mi][nt][f], ctd = acc[3][mi][nt][f];
                dvv[e2] += te * gk;
                dkv[e2] += te * (gtv + gt[cl + e2]);
                dqv[e2] += ca * (z * ctd + dd * ntc[cl + e2]);
                pte[mi][h2] += vv[e2] * gk + gt[cl + e2] * kv[e2];
                pca[mi][h2] += z * dyv[e2] * cq;
              }
            }
            if (pair) {
              *reinterpret_cast<float2*>(a.dv + o) = make_float2(dvv[0], dvv[1]);
              *reinterpret_cast<float2*>(a.dk + o) = make_float2(dkv[0], dkv[1]);
              *reinterpret_cast<float2*>(a.dq + o) = make_float2(dqv[0], dqv[1]);
            } else {
              for (int e2 = 0; e2 < n2; ++e2) a.dv[o + e2] = dvv[e2], a.dk[o + e2] = dkv[e2], a.dq[o + e2] = dqv[e2];
            }
          }
        }
      }
    }
  // the rows' partials over the block's columns: the 4 lanes of a row, then
  // the 4 column groups in order
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      float x = pte[mi][h2], y = pca[mi][h2];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      y += __shfl_xor_sync(0xffffffffu, y, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      y += __shfl_xor_sync(0xffffffffu, y, 2);
      if (t4 == 0) {
        const int i = wm * 32 + mi * 16 + g + 8 * h2;
        rte[wn * kW + i] = x;
        rca[wn * kW + i] = y;
      }
    }
  __syncthreads();
  float* part = a.part + ((bhz * nc + c) * a.nt + tc) * 2 * kT;
  if (tid < kW) {
    part[tid] = ((rte[tid] + rte[kW + tid]) + rte[2 * kW + tid]) + rte[3 * kW + tid];
    part[kT + tid] = ((rca[tid] + rca[kW + tid]) + rca[2 * kW + tid]) + rca[3 * kW + tid];
  }
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    __syncthreads();
    if (tid < w) red[tid] += red[tid + w];
  }
  if (tid == 0) {
    float gn = 0.f;
    for (int j = 0; j < kW; ++j) gn += gt[j] * ntc[j];
    a.pdec[(bhz * nc + c) * a.nt + tc] = red[0] + gn;
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
  using CF = Cfg<T>;
  const int intra = intra_smem_bytes(CF::kIn, CF::kOp), walk = walk_smem_bytes(CF::kIn, CF::kOp);
  const int state = state_smem_bytes(CF::kIn, CF::kOp, CF::kKT);
  cudaError_t e = cudaFuncSetAttribute(mlstm_bwd_intra<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, intra);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(mlstm_bwd_walk<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, walk);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(mlstm_bwd_state<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, state);
  if (e != cudaSuccess) return e;
  const int tiles = a.pp / kW;
  mlstm_bwd_gates<<<dim3(a.nh, a.b), kThreads, 0, st>>>(a);
  mlstm_bwd_nsum<T><<<dim3(cdiv(a.p, kThreads), a.nc, a.b * a.nh), kThreads, 0, st>>>(a);
  mlstm_bwd_intra<T><<<dim3(a.nc, a.nh, a.b), kThreads, intra, st>>>(a);
  mlstm_bwd_walk<T><<<dim3(2 * tiles * tiles + cdiv(a.p, kThreads), a.nh, a.b), kThreads, walk, st>>>(a);
  mlstm_bwd_state<T><<<dim3(tiles, a.nc, a.b * a.nh), kThreads, state, st>>>(a);
  mlstm_bwd_final<<<dim3(a.nh, a.b), kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Bytes of shared memory a block of launch 4 (which 0), launch 5 (which 1)
// or launch 3 (which 2) takes (is_bf16: bf16 inputs, else f32).
extern "C" int rt_mlstm_bwd_smem(int is_bf16, int which) {
  using B = Cfg<bf16>;
  using F = Cfg<float>;
  if (which == 0) return is_bf16 ? walk_smem_bytes(B::kIn, B::kOp) : walk_smem_bytes(F::kIn, F::kOp);
  if (which == 2) return is_bf16 ? intra_smem_bytes(B::kIn, B::kOp) : intra_smem_bytes(F::kIn, F::kOp);
  return is_bf16 ? state_smem_bytes(B::kIn, B::kOp, B::kKT) : state_smem_bytes(F::kIn, F::kOp, F::kKT);
}

// q, k, v packed (b, s, nh, p) f32 (is_bf16 = 0) or bf16; ig, fg, y, dy
// packed f32; C0/n0/m0 null for the zero state, dC/dn/dm each null where
// unused, dC0/dn0/dm0 null without a state. Scratch (kernels/mlstm.py:
// mlstm_scan_bwd allocates it): f32 pos, cinf, dnb, nb, pos2, dmi, un,
// part, pdec, cg as the Args comments say; bf16 planes cpl, gpl (b, nh, nc,
// kOp, pp, pp) and inpl (b, nh, 3 kIn + kOp, nc chunk, pp), pp = p padded
// to 64.
extern "C" int rt_mlstm_scan_bwd(const void* q, const void* k, const void* v, const float* ig,
                                 const float* fg, const float* y, const float* dy, const float* C0,
                                 const float* n0, const float* m0, const float* dC, const float* dn,
                                 const float* dm, float* dq, float* dk, float* dv, float* di, float* df,
                                 float* dC0, float* dn0, float* dm0, float* pos, float* cinf, float* dnb,
                                 float* nb, float* pos2, float* dmi, void* cpl, void* gpl, void* inpl,
                                 float* un, float* part, float* pdec, float* cg, int b, int s, int nh, int p,
                                 int chunk, int is_bf16, void* stream) {
  if (b < 1 || s < 1 || nh < 1 || p < 1 || chunk < 1 || chunk > kT) return cudaErrorInvalidValue;
  const int nc = cdiv(s, chunk), nt = cdiv(p, kT), pp = cdiv(p, kW) * kW;
  const Args a{q, k, v, ig, fg, y, dy, C0, n0, m0, dC, dn, dm, dq, dk, dv, di, df, dC0, dn0, dm0,
               pos, cinf, dnb, nb, pos2, dmi, static_cast<bf16*>(cpl), static_cast<bf16*>(gpl),
               static_cast<bf16*>(inpl), un, part, pdec, cg, b, s, nh, p, chunk, nc, nt, pp};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<bf16>(a, st) : launch<float>(a, st);
}
