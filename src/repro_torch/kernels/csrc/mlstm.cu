// mlstm_scan: the chunked mLSTM scan (xLSTM's matrix-memory cell).
//
// Replaces no Pallas kernel: the reference computes this scan in jnp under
// jax.named_scope("kernel_mlstm_scan") (repro/models/xlstm.py:54-135,
// `mlstm_chunked`), a lax.scan over chunks that XLA lowers. The port's
// plain version is kernels/ref.py:mlstm_scan_ref. Per chunk of L positions
// of one (batch, head), with P the key/value width, log f = log sigmoid(f~),
// cumf its inclusive cumsum over the chunk, src_j = i~_j - cumf_j and the
// stabilizer m' = max(m, max_j src_j):
//   W_ij    = exp(cumf_i + src_j - m') (q_i . k_j) / sqrt(P)       (j <= i)
//   carry_i = exp(cumf_i + m - m') / sqrt(P)
//   y_i     = (sum_j W_ij v_j + carry_i C q_i)
//             / max(|sum_j W_ij + carry_i n . q_i|, exp(-m'))
//   C      <- exp(cumf_L + m - m') C + sum_j exp(cumf_L - cumf_j + i~_j - m') v_j k_j^T
//   n      <- the same with k_j in place of v_j k_j^T
// C[p][r] sums v_p k_r, so the carried state enters y as C q, as in the
// cell's decode (the reference's chunked form contracts q with C's other
// index there: ROADMAP, queue 3). Inputs q, k, v in f32 or bf16, packed
// (B, S, nh, P); the gates' pre-activations f32 packed (B, S, nh); every
// sum in f32. Outputs y (B, S, nh, P) f32 and the final C, n, m; an
// optional (C0, n0, m0) seeds the state (else 0, 0, -1e30).
//
// Ragged S: positions past S count as i~ = -inf (no input, no say in the
// stabilizer) and log f = 0 (no decay), which is a shorter last chunk.
//
// Design (a first, simple one; f32 SIMT): one block of 256 threads per
// (p-tile of TP <= 32 rows of C's value index, head, batch), walking the
// chunks in order with its C[p-tile][:] (TP x P f32: 128 KB at P = 1024)
// resident in shared memory, and n (P) beside it. Per chunk it
//   1. forms the chunk's gates with one warp (a shuffle scan for cumf);
//   2. passes over r in tiles of 32 columns of q and k, accumulating
//      q_i . k_j (64 x 64, 16 a thread), q_i . C[p][:] (64 x TP, 8 a
//      thread) and n . q_i (one a thread of the first 64);
//   3. forms W, the denominators and y for its TP columns of v;
//   4. passes over r again with k's tiles, updating C[p-tile][r] and n.
// Every block of a head recomputes the p-independent parts (the gates,
// q.k^T, n, the denominators): TP / P of the scan's C work and all of its
// q.k^T work each. What bounds it: the card needs per (batch, head,
// chunk) L(L+1)/2 P MACs for q.k^T and W.v each and L P^2 for C.q and the
// C update each; at xlstm-1.3b's 2048-token prefill (4 heads of P = 1024,
// L = 64) 35 GFLOP, 0.53 ms at the f32 rate, against 0.15 GB of inputs
// and outputs (46 us). This build runs on the f32 pipes with no tensor
// cores, repeats q.k^T in each of the P / TP blocks of a head, and reads
// its operands from shared memory one float at a time: later work.
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 64;  // L; the tiles below hold kMaxChunk rows
constexpr int kRT = 32;        // columns of q and k staged per tile
constexpr int kMaxTP = 32;     // rows of C per block (one a lane)
constexpr int kQK = kRT + 1;   // padded row of a q/k tile
constexpr int kWP = kMaxChunk + 1;

__host__ __device__ constexpr int pad_rt(int p) { return (p + kRT - 1) / kRT * kRT; }

// floats of shared memory at width p and tp rows of C
__host__ __device__ constexpr int mlstm_smem_floats(int p, int tp) {
  return tp * (p + 1)               // C tile
         + pad_rt(p)                // n
         + 2 * kMaxChunk * kQK      // q, k tiles
         + kMaxChunk * kWP          // W
         + 2 * kMaxChunk * kMaxTP   // v tile, v * to_end
         + 6 * kMaxChunk            // per-position terms
         + 4;                       // scalars
}

struct MlstmArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* ig;  // (B, S, nh) i~
  const float* fg;  // (B, S, nh) f~
  const float* C0;  // (B, nh, P, P) or null
  const float* n0;  // (B, nh, P) or null
  const float* m0;  // (B, nh) or null
  float* y;         // (B, S, nh, P)
  float* C;
  float* n;
  float* m;
  int s, nh, p, chunk, tp;
};

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.0f) - log1pf(expf(-fabsf(x)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads) mlstm_scan_kernel(MlstmArgs a) {
  extern __shared__ float smem[];
  const int P = a.p, L = a.chunk, TP = a.tp, S = a.s, nh = a.nh;
  const int CP = P + 1;
  float* Cs = smem;                       // [TP][CP]
  float* ns = Cs + TP * CP;               // [pad_rt(P)]
  float* qs = ns + pad_rt(P);             // [kMaxChunk][kQK]
  float* ks = qs + kMaxChunk * kQK;       // [kMaxChunk][kQK]
  float* ws = ks + kMaxChunk * kQK;       // [kMaxChunk][kWP]
  float* vs = ws + kMaxChunk * kWP;       // [kMaxChunk][kMaxTP]
  float* vw = vs + kMaxChunk * kMaxTP;    // [kMaxChunk][kMaxTP]: v_j * to_end_j
  float* cumf = vw + kMaxChunk * kMaxTP;  // [kMaxChunk]
  float* src = cumf + kMaxChunk;
  float* carry = src + kMaxChunk;         // exp(cumf_i + m - m') / sqrt(P)
  float* toend = carry + kMaxChunk;
  float* den = toend + kMaxChunk;
  float* nq = den + kMaxChunk;
  float* scal = nq + kMaxChunk;           // m', decay

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ti = tid >> 4, tj = tid & 15;
  const int p0 = blockIdx.x * TP, head = blockIdx.y, b = blockIdx.z;
  const int tpv = min(TP, P - p0);  // rows of C this block owns
  const int bh = b * nh + head;
  const float scale = rsqrtf(static_cast<float>(P));
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const int64_t row = static_cast<int64_t>(nh) * P;  // elements between positions
  const int64_t base = static_cast<int64_t>(b) * S * row + static_cast<int64_t>(head) * P;

  for (int e = tid; e < TP * P; e += kThreads) {
    const int pr = e / P, r = e % P;
    Cs[pr * CP + r] = (a.C0 && pr < tpv) ? a.C0[(static_cast<int64_t>(bh) * P + p0 + pr) * P + r] : 0.0f;
  }
  for (int r = tid; r < pad_rt(P); r += kThreads)
    ns[r] = (a.n0 && r < P) ? a.n0[static_cast<int64_t>(bh) * P + r] : 0.0f;
  float m = a.m0 ? a.m0[bh] : -1e30f;
  __syncthreads();

  // stage rows [s0, s0 + lc) of x, columns [r0, r0 + kRT), into dst (zeros elsewhere)
  auto stage = [&](float* dst, const T* x, int s0, int lc, int r0) {
    for (int e = tid; e < kMaxChunk * kRT; e += kThreads) {
      const int i = e / kRT, r = e % kRT;
      dst[i * kQK + r] = (i < lc && r0 + r < P)
                             ? rt::load_f32(x + base + static_cast<int64_t>(s0 + i) * row + r0 + r)
                             : 0.0f;
    }
  };

  const int chunks = (S + L - 1) / L;
  for (int c = 0; c < chunks; ++c) {
    const int s0 = c * L, lc = min(L, S - s0);

    // 1. the chunk's gates (warp 0: positions lane and lane + 32)
    if (warp == 0) {
      float iv[2], lf[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = lane + 32 * u;
        const int64_t g = (static_cast<int64_t>(b) * S + s0 + j) * nh + head;
        iv[u] = j < lc ? a.ig[g] : -CUDART_INF_F;
        lf[u] = j < lc ? log_sigmoid(a.fg[g]) : 0.0f;
      }
      float c0 = lf[0], c1 = lf[1];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t0 = __shfl_up_sync(0xffffffffu, c0, o);
        const float t1 = __shfl_up_sync(0xffffffffu, c1, o);
        if (lane >= o) {
          c0 += t0;
          c1 += t1;
        }
      }
      c1 += __shfl_sync(0xffffffffu, c0, 31);
      const float s0v = iv[0] - c0, s1v = iv[1] - c1;
      float mloc = fmaxf(s0v, s1v);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, o));
      const float mnew = fmaxf(m, mloc);
      const int jl = lc - 1;
      const float last = __shfl_sync(0xffffffffu, jl < 32 ? c0 : c1, jl & 31);
      const float cs[2] = {c0, c1}, ss[2] = {s0v, s1v};
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = lane + 32 * u;
        cumf[j] = cs[u];
        src[j] = ss[u];
        carry[j] = expf(cs[u] + m - mnew) * scale;
        toend[j] = j < lc ? expf(last - cs[u] + iv[u] - mnew) : 0.0f;
      }
      if (lane == 0) {
        scal[0] = mnew;
        scal[1] = expf(last + m - mnew);
      }
    }

    // 2. q.k^T, q.C[p-tile]^T and n.q over tiles of r
    float qk[4][4] = {}, qc[8] = {}, nqa = 0.0f;
    for (int r0 = 0; r0 < P; r0 += kRT) {
      stage(qs, q, s0, lc, r0);
      stage(ks, k, s0, lc, r0);
      __syncthreads();
#pragma unroll 4
      for (int rr = 0; rr < kRT; ++rr) {
        float qa[4], kb[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          qa[u] = qs[(ti + 16 * u) * kQK + rr];
          kb[u] = ks[(tj + 16 * u) * kQK + rr];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int w = 0; w < 4; ++w) qk[u][w] = fmaf(qa[u], kb[w], qk[u][w]);
        const float cv = (lane < tpv && r0 + rr < P) ? Cs[lane * CP + r0 + rr] : 0.0f;
#pragma unroll
        for (int u = 0; u < 8; ++u) qc[u] = fmaf(qs[(warp + 8 * u) * kQK + rr], cv, qc[u]);
        if (tid < kMaxChunk) nqa = fmaf(ns[r0 + rr], qs[tid * kQK + rr], nqa);
      }
      __syncthreads();
    }

    // 3. W, the denominators and y for this block's columns of v
    const float mnew = scal[0], decay = scal[1];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int i = ti + 16 * u, j = tj + 16 * w;
        const float wt = (j <= i && i < lc) ? expf(cumf[i] + src[j] - mnew) : 0.0f;
        ws[i * kWP + j] = wt * (qk[u][w] * scale);
      }
    if (tid < kMaxChunk) nq[tid] = nqa;
    for (int e = tid; e < kMaxChunk * kMaxTP; e += kThreads) {
      const int j = e / kMaxTP, pc = e % kMaxTP;
      vs[e] = (j < lc && pc < tpv)
                  ? rt::load_f32(v + base + static_cast<int64_t>(s0 + j) * row + p0 + pc)
                  : 0.0f;
    }
    __syncthreads();
    if (tid < kMaxChunk) {
      float sum = 0.0f;
      for (int j = 0; j <= tid; ++j) sum += ws[tid * kWP + j];
      den[tid] = fmaxf(fabsf(sum + carry[tid] * nq[tid]), expf(-mnew));
    }
    for (int e = tid; e < kMaxChunk * kMaxTP; e += kThreads) vw[e] = vs[e] * toend[e / kMaxTP];
    __syncthreads();
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = warp + 8 * u;
      if (i >= lc) break;
      float acc = 0.0f;
      for (int j = 0; j <= i; ++j) acc = fmaf(ws[i * kWP + j], vs[j * kMaxTP + lane], acc);
      if (lane < tpv)
        a.y[base + static_cast<int64_t>(s0 + i) * row + p0 + lane] =
            (acc + carry[i] * qc[u]) / den[i];
    }

    // 4. C[p-tile] and n to the chunk's end, over tiles of r
    for (int r0 = 0; r0 < P; r0 += kRT) {
      stage(ks, k, s0, lc, r0);
      __syncthreads();
      const int r = r0 + lane;
      if (r < P) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int pr = warp + 8 * u;
          if (pr < tpv) {
            float acc = 0.0f;
            for (int j = 0; j < lc; ++j) acc = fmaf(vw[j * kMaxTP + pr], ks[j * kQK + lane], acc);
            Cs[pr * CP + r] = Cs[pr * CP + r] * decay + acc;
          }
        }
        if (warp == 0) {
          float acc = 0.0f;
          for (int j = 0; j < lc; ++j) acc = fmaf(toend[j], ks[j * kQK + lane], acc);
          ns[r] = ns[r] * decay + acc;
        }
      }
      __syncthreads();
    }
    m = mnew;
  }

  for (int e = tid; e < tpv * P; e += kThreads) {
    const int pr = e / P, r = e % P;
    a.C[(static_cast<int64_t>(bh) * P + p0 + pr) * P + r] = Cs[pr * CP + r];
  }
  if (blockIdx.x == 0) {
    for (int r = tid; r < P; r += kThreads) a.n[static_cast<int64_t>(bh) * P + r] = ns[r];
    if (tid == 0) a.m[bh] = m;
  }
}

}  // namespace

// Bytes of shared memory one block takes at width p with tp rows of C.
extern "C" int rt_mlstm_scan_smem(int p, int tp) {
  return static_cast<int>(sizeof(float)) * mlstm_smem_floats(p, tp);
}

// q, k, v packed (batch, s, nh, p) f32 (is_bf16 = 0) or bf16; ig, fg
// packed (batch, s, nh) f32; C0/n0/m0 null for the zero state.
extern "C" int rt_mlstm_scan(const void* q, const void* k, const void* v, const float* ig,
                             const float* fg, const float* C0, const float* n0, const float* m0,
                             float* y, float* C, float* n, float* m, int batch, int s, int nh,
                             int p, int chunk, int tp, int is_bf16, void* stream) {
  if (batch == 0 || nh == 0) return cudaSuccess;
  if (p < 1 || s < 0 || chunk < 1 || chunk > kMaxChunk || tp < 1 || tp > kMaxTP)
    return cudaErrorInvalidValue;
  const MlstmArgs args{q, k, v, ig, fg, C0, n0, m0, y, C, n, m, s, nh, p, chunk, tp};
  const int smem = rt_mlstm_scan_smem(p, tp);
  const dim3 grid((p + tp - 1) / tp, nh, batch);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // above 48 KB only after opting in; the attribute belongs to the current
  // device, so it is set on every launch
  if (is_bf16) {
    const cudaError_t e = cudaFuncSetAttribute(mlstm_scan_kernel<__nv_bfloat16>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    mlstm_scan_kernel<__nv_bfloat16><<<grid, kThreads, smem, st>>>(args);
  } else {
    const cudaError_t e = cudaFuncSetAttribute(mlstm_scan_kernel<float>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    mlstm_scan_kernel<float><<<grid, kThreads, smem, st>>>(args);
  }
  return cudaGetLastError();
}
