// flash_attention_bwd: the gradient of K5 (flash_attention.cu) with respect
// to q, k and v, for training.
//
// Replaces no Pallas kernel: the reference trains through jnp and no Pallas
// kernel of it has a custom_vjp. The port's forward on the card is K5, so
// its gradient is a kernel too. The plain version is
// kernels/ref.py:flash_attention_bwd_ref (autograd of the forward's plain
// version). With s_ij = scale q_i.k_j, the forward's per-row log-sum-exp
// lse_i (written by K5 under autograd) and the output o:
//   P_ij  = exp(s_ij - lse_i)                    (0 where masked)
//   D_i   = sum_d dO_id o_id
//   dS_ij = P_ij (dO_i.v_j - D_i)
//   dq_i  = scale sum_j dS_ij k_j,  dk_j = scale sum_i dS_ij q_i,  dv_j = sum_i P_ij dO_i
// with the masks of the forward (causal j <= i, window j > i - window, keys
// below Sk), GQA (a KV head's dk and dv sum over its group of q heads) and
// Sq != Sk. q, k, v, o, dO in f32 or bf16 with any (batch, seq, head)
// strides and inner stride 1; every product and sum in f32; dq, dk, dv
// written in the inputs' dtype.
//
// What bounds it: per visible (q, k) pair 4 hd MACs (s, dO.v, dv, dk) and
// 2 hd more for dq's pass, which recomputes s and dO.v: at qwen3-4b's
// causal 2048-token layer (32 q heads over 8 of 128) 103 GFLOP, against
// about 50 MB read and written. Here it runs on the f32 SIMT units.
//
// Design: three launches, no atomics, every sum in an order fixed by the
// shape, so a training step repeats bit for bit.
//   1. fa_bwd_dot, a warp a row: D_i.
//   2. fa_bwd_dkdv, a block per (64 keys, KV head, batch): K and V's tiles
//      stay in shared memory in f32; the block walks the group's q heads in
//      order and, for each, the q tiles that can see its keys (from the
//      first under a causal mask, up to the window's last), loading q, dO,
//      lse and D, forming P and dS for the 64 x 64 tile, then dv += P^T dO
//      and dk += dS^T q in registers.
//   3. fa_bwd_dq, a block per (64 q rows, q head, batch): q and dO stay in
//      shared memory; the block walks the K/V tiles the rows can see,
//      forming P and dS again, and dq += dS k in registers.
// A 256-thread block holds a 64 x 64 tile of s as rows ty + 16 u and
// columns tx + 16 w (u, w < 4), and an output tile of 64 rows by hd as
// rows ty + 16 u and columns tx + 16 w (w < hd / 16). Shared rows are
// padded by one float, so a warp's reads fall on distinct banks.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kB = 64;          // q rows and keys a tile
constexpr int kThreads = 256;

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // (B, H, Sq)
  float* dsum;       // (B, H, Sq): D
  void* dq;
  void* dk;
  void* dv;
  int64_t q_sb, q_ss, q_sh;    // element strides of q (B, Sq, H, hd); inner stride 1
  int64_t k_sb, k_ss, k_sh;    // k (B, Sk, KV, hd)
  int64_t v_sb, v_ss, v_sh;    // v
  int64_t o_sb, o_ss, o_sh;    // o (B, Sq, H, hd)
  int64_t d_sb, d_ss, d_sh;    // dO
  int64_t dq_sb, dq_ss, dq_sh;  // dq, like q
  int64_t dk_sb, dk_ss, dk_sh;  // dk, like k
  int64_t dv_sb, dv_ss, dv_sh;  // dv, like v
  int batch, sq, sk, h, kv, hd;
  float scale;
  int causal, window;
};

__device__ __forceinline__ bool visible(const BwdArgs& a, int i, int j) {
  bool ok = i < a.sq && j < a.sk;
  if (a.causal) ok = ok && j <= i;
  if (a.window > 0) ok = ok && j > i - a.window;
  return ok;
}

// rows [r0, r0 + 64) of a (B, S, heads, hd) tensor at (batch b, head) into
// a shared [64][HD + 1] f32 tile, zero past `n` rows
template <typename T, int HD>
__device__ __forceinline__ void load_rows(float* dst, const void* src, int64_t sb, int64_t ss, int64_t sh,
                                          int b, int head, int r0, int n) {
  const T* base = static_cast<const T*>(src) + b * sb + head * sh;
  for (int e = threadIdx.x; e < kB * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    dst[r * (HD + 1) + d] = r0 + r < n ? rt::load_f32(base + (r0 + r) * ss + d) : 0.0f;
  }
}

// the tile's P and dS into shared [64][65] arrays: s from qs and ks, dO.v
// from dos and vs
template <int HD>
__device__ __forceinline__ void tile_p_ds(const BwdArgs& a, const float* qs, const float* ks, const float* dos,
                                          const float* vs, const float* lse, const float* dd, float* ps,
                                          float* dss, int i0, int j0) {
  constexpr int P = HD + 1;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float s[4][4] = {}, dp[4][4] = {};
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float qv[4], kv[4], ov[4], vv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      qv[u] = qs[(ty + 16 * u) * P + d];
      ov[u] = dos[(ty + 16 * u) * P + d];
      kv[u] = ks[(tx + 16 * u) * P + d];
      vv[u] = vs[(tx + 16 * u) * P + d];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        s[u][w] = fmaf(qv[u], kv[w], s[u][w]);
        dp[u][w] = fmaf(ov[u], vv[w], dp[u][w]);
      }
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int r = ty + 16 * u;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int c = tx + 16 * w;
      const float p = visible(a, i0 + r, j0 + c) ? expf(s[u][w] * a.scale - lse[r]) : 0.0f;
      ps[r * (kB + 1) + c] = p;
      dss[r * (kB + 1) + c] = p * (dp[u][w] - dd[r]);
    }
  }
}

template <typename T, int HD>
__device__ __forceinline__ void store_rows(void* dst, int64_t sb, int64_t ss, int64_t sh, int b, int head, int r0,
                                           int n, const float (&acc)[4][HD / 16], float mul) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  T* base = static_cast<T*>(dst) + b * sb + head * sh;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int r = r0 + ty + 16 * u;
    if (r >= n) continue;
#pragma unroll
    for (int w = 0; w < HD / 16; ++w) rt::store_f32(base + r * ss + tx + 16 * w, acc[u][w] * mul);
  }
}

template <int HD>
constexpr int bwd_smem_floats() {
  return 4 * kB * (HD + 1) + 2 * kB * (kB + 1) + 2 * kB;
}

// -- launch 1 ---------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) fa_bwd_dot(BwdArgs a) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= static_cast<int64_t>(a.batch) * a.h * a.sq) return;
  const int i = static_cast<int>(row % a.sq), head = static_cast<int>(row / a.sq % a.h);
  const int b = static_cast<int>(row / (static_cast<int64_t>(a.sq) * a.h));
  const T* o = static_cast<const T*>(a.o) + b * a.o_sb + i * a.o_ss + head * a.o_sh;
  const T* g = static_cast<const T*>(a.dout) + b * a.d_sb + i * a.d_ss + head * a.d_sh;
  float sum = 0.0f;
  for (int d = lane; d < a.hd; d += 32) sum = fmaf(rt::load_f32(o + d), rt::load_f32(g + d), sum);
  sum = rt::warp_sum(sum);
  if (lane == 0) a.dsum[row] = sum;  // row = (b H + head) Sq + i
}

// -- launch 2 ---------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1) fa_bwd_dkdv(BwdArgs a) {
  extern __shared__ float sm[];
  constexpr int P = HD + 1, NW = HD / 16;
  float* ks = sm;
  float* vs = ks + kB * P;
  float* qs = vs + kB * P;
  float* dos = qs + kB * P;
  float* ps = dos + kB * P;
  float* dss = ps + kB * (kB + 1);
  float* lse = dss + kB * (kB + 1);
  float* dd = lse + kB;
  const int j0 = blockIdx.x * kB, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int group = a.h / a.kv;
  load_rows<T, HD>(ks, a.k, a.k_sb, a.k_ss, a.k_sh, b, kvh, j0, a.sk);
  load_rows<T, HD>(vs, a.v, a.v_sb, a.v_ss, a.v_sh, b, kvh, j0, a.sk);
  // the q rows that can see a key of this tile
  const int q_begin = a.causal ? j0 / kB * kB : 0;
  const int q_end = a.window > 0 ? min(a.sq, j0 + kB - 1 + a.window) : a.sq;
  float dk[4][NW] = {}, dv[4][NW] = {};
  for (int hh = 0; hh < group; ++hh) {
    const int head = kvh * group + hh;
    const float* lrow = a.lse + (static_cast<int64_t>(b) * a.h + head) * a.sq;
    const float* drow = a.dsum + (static_cast<int64_t>(b) * a.h + head) * a.sq;
    for (int i0 = q_begin; i0 < q_end; i0 += kB) {
      __syncthreads();  // the previous tile's ps, dss, qs and dos are consumed
      load_rows<T, HD>(qs, a.q, a.q_sb, a.q_ss, a.q_sh, b, head, i0, a.sq);
      load_rows<T, HD>(dos, a.dout, a.d_sb, a.d_ss, a.d_sh, b, head, i0, a.sq);
      if (tid < kB) {
        lse[tid] = i0 + tid < a.sq ? lrow[i0 + tid] : 0.0f;
        dd[tid] = i0 + tid < a.sq ? drow[i0 + tid] : 0.0f;
      }
      __syncthreads();
      tile_p_ds<HD>(a, qs, ks, dos, vs, lse, dd, ps, dss, i0, j0);
      __syncthreads();
      // dv[j] += sum_i P_ij dO_i, dk[j] += sum_i dS_ij q_i over the tile's rows
#pragma unroll 2
      for (int i = 0; i < kB; ++i) {
        float pv[4], sv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          pv[u] = ps[i * (kB + 1) + ty + 16 * u];
          sv[u] = dss[i * (kB + 1) + ty + 16 * u];
        }
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          const float ov = dos[i * P + tx + 16 * w], qv = qs[i * P + tx + 16 * w];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            dv[u][w] = fmaf(pv[u], ov, dv[u][w]);
            dk[u][w] = fmaf(sv[u], qv, dk[u][w]);
          }
        }
      }
    }
  }
  store_rows<T, HD>(a.dk, a.dk_sb, a.dk_ss, a.dk_sh, b, kvh, j0, a.sk, dk, a.scale);
  store_rows<T, HD>(a.dv, a.dv_sb, a.dv_ss, a.dv_sh, b, kvh, j0, a.sk, dv, 1.0f);
}

// -- launch 3 ---------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1) fa_bwd_dq(BwdArgs a) {
  extern __shared__ float sm[];
  constexpr int P = HD + 1, NW = HD / 16;
  float* qs = sm;
  float* dos = qs + kB * P;
  float* ks = dos + kB * P;
  float* vs = ks + kB * P;
  float* ps = vs + kB * P;
  float* dss = ps + kB * (kB + 1);
  float* lse = dss + kB * (kB + 1);
  float* dd = lse + kB;
  const int i0 = blockIdx.x * kB, head = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int kvh = head / (a.h / a.kv);
  load_rows<T, HD>(qs, a.q, a.q_sb, a.q_ss, a.q_sh, b, head, i0, a.sq);
  load_rows<T, HD>(dos, a.dout, a.d_sb, a.d_ss, a.d_sh, b, head, i0, a.sq);
  if (tid < kB) {
    const int64_t r = (static_cast<int64_t>(b) * a.h + head) * a.sq + i0 + tid;
    lse[tid] = i0 + tid < a.sq ? a.lse[r] : 0.0f;
    dd[tid] = i0 + tid < a.sq ? a.dsum[r] : 0.0f;
  }
  // the keys these rows can see, as the forward's tile plan
  const int k_end = a.causal ? min(a.sk, i0 + kB) : a.sk;
  const int k_begin = a.window > 0 ? max(0, i0 - a.window + 1) / kB * kB : 0;
  float dq[4][NW] = {};
  for (int j0 = k_begin; j0 < k_end; j0 += kB) {
    __syncthreads();  // the previous tile is consumed (and qs, dos, lse, dd are written)
    load_rows<T, HD>(ks, a.k, a.k_sb, a.k_ss, a.k_sh, b, kvh, j0, a.sk);
    load_rows<T, HD>(vs, a.v, a.v_sb, a.v_ss, a.v_sh, b, kvh, j0, a.sk);
    __syncthreads();
    tile_p_ds<HD>(a, qs, ks, dos, vs, lse, dd, ps, dss, i0, j0);
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < kB; ++j) {
      float sv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) sv[u] = dss[(ty + 16 * u) * (kB + 1) + j];
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const float kv = ks[j * P + tx + 16 * w];
#pragma unroll
        for (int u = 0; u < 4; ++u) dq[u][w] = fmaf(sv[u], kv, dq[u][w]);
      }
    }
  }
  store_rows<T, HD>(a.dq, a.dq_sb, a.dq_ss, a.dq_sh, b, head, i0, a.sq, dq, a.scale);
}

template <typename T, int HD>
cudaError_t launch_hd(const BwdArgs& a, cudaStream_t st) {
  const int smem = static_cast<int>(sizeof(float)) * bwd_smem_floats<HD>();
  cudaError_t e = cudaFuncSetAttribute(fa_bwd_dkdv<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(fa_bwd_dq<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int64_t rows = static_cast<int64_t>(a.batch) * a.h * a.sq;
  fa_bwd_dot<T><<<static_cast<unsigned>((rows + kThreads / 32 - 1) / (kThreads / 32)), kThreads, 0, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (a.sk > 0) {
    fa_bwd_dkdv<T, HD><<<dim3((a.sk + kB - 1) / kB, a.kv, a.batch), kThreads, smem, st>>>(a);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  fa_bwd_dq<T, HD><<<dim3((a.sq + kB - 1) / kB, a.h, a.batch), kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const BwdArgs& a, cudaStream_t st) {
  switch (a.hd) {
    case 16: return launch_hd<T, 16>(a, st);
    case 32: return launch_hd<T, 32>(a, st);
    case 64: return launch_hd<T, 64>(a, st);
    case 80: return launch_hd<T, 80>(a, st);
    case 128: return launch_hd<T, 128>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: 24 int64 values, the (batch, seq, head) element strides of q, k,
// v, o, dout, dq, dk, dv. lse (batch, h, sq) from the forward; dsum
// (batch, h, sq) f32 scratch. hd one of 16, 32, 64, 80, 128 (the wrapper
// zero-pads any other hd up to 128).
extern "C" int rt_flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                      const void* dout, const float* lse, float* dsum, void* dq,
                                      void* dk, void* dv, const int64_t* strides, int batch, int sq,
                                      int sk, int h, int kv, int hd, float scale, int causal,
                                      int window, int is_bf16, void* stream) {
  if (batch == 0 || sq == 0 || h == 0) return cudaSuccess;
  if (kv <= 0 || h % kv != 0) return cudaErrorInvalidValue;
  const int64_t* s = strides;
  const BwdArgs a{q, k, v, o, dout, lse, dsum, dq, dk, dv,
                  s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11],
                  s[12], s[13], s[14], s[15], s[16], s[17], s[18], s[19], s[20], s[21], s[22], s[23],
                  batch, sq, sk, h, kv, hd, scale, causal, window};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<bf16>(a, st) : launch<float>(a, st);
}
